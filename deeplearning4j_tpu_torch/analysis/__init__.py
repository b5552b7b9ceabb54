"""Static analysis, the port of the JAX package's analysis/: the model
doctor, the step-program audit, the step cost model and the kernel
coverage table, unified behind structured findings (analysis/findings.py).

1. shapeflow — symbolic InputType propagation over nn/conf
   configurations (no params, no tracing): nIn/nOut wiring, missing
   preprocessors, merge conflicts, dead vertices. SF*** codes.
2. graph_audit — one trace of the optimizer step on fake tensors,
   walked for device hazards: f64, widening casts, closed-over tensors,
   host round trips, dead weights. JX*** codes (the JAX package's
   jaxpr_audit).
3. costmodel — the same trace priced per op family (FLOPs, bytes, the
   activation peak), cross-checked against FlopCounterMode (JX007) and
   the card's memory (JX008); kernelcoverage — the conv routing decision
   for every conv instance of a conf.

The DL4J lineage: the reference's config DSL validated nIn/nOut wiring
before any compute ran (InputTypeUtil) — this package is that idea
extended to the step program.
"""

from __future__ import annotations

import logging
from typing import List

from deeplearning4j_tpu_torch.analysis.findings import (  # noqa: F401
    ERROR,
    INFO,
    WARNING,
    Finding,
    error_names,
    format_findings,
    has_errors,
    sort_findings,
    summarize,
    to_json,
)

logger = logging.getLogger("deeplearning4j_tpu_torch")


def doctor_network(net, *, batch_size: int = 2, timesteps: int = 8,
                   audit: bool = True) -> List[Finding]:
    """The model doctor: shapeflow over the net's configuration, then —
    when the config is sound — one trace of the optimizer step on fake
    tensors, audited for device hazards. Returns findings; raises nothing
    on a bad model (that is the point)."""
    from deeplearning4j_tpu_torch.analysis import graph_audit, shapeflow

    findings = shapeflow.check_configuration(net.conf)
    if audit and not has_errors(findings):
        # a config with ERRORs would trace into the same wreck it
        # describes; report the config layer first. The trace can still
        # fail on warning-grade configs (SF007 no loss head -> _loss
        # raises): that failure becomes a finding, never a doctor crash
        try:
            findings = findings + graph_audit.audit_network(
                net, batch_size=batch_size, timesteps=timesteps)
        except Exception as e:
            findings = findings + [Finding(
                "JX000", WARNING, "program:train_step",
                f"could not trace the optimizer step: "
                f"{type(e).__name__}: {e}",
                "resolve the config findings above (a missing loss head "
                "or broken wiring usually explains this)")]
    return findings


def doctor_errors(conf) -> List[Finding]:
    """ERROR-severity shapeflow findings for a configuration — the cheap
    gate a benchmark consults before headlining a workload."""
    from deeplearning4j_tpu_torch.analysis import shapeflow

    return [f for f in shapeflow.check_configuration(conf)
            if f.severity == ERROR]


def preflight_report(conf, origin: str = "") -> List[Finding]:
    """Free pre-flight check on an imported model configuration (the
    Keras and DL4J import paths): run shapeflow, log what it finds,
    return the findings. Never raises — an analysis bug must not sink an
    import that would otherwise succeed."""
    from deeplearning4j_tpu_torch.analysis import shapeflow

    try:
        findings = shapeflow.check_configuration(conf)
    except Exception as e:
        logger.debug("import preflight skipped (%s): %s", origin, e)
        return []
    src = f" [{origin}]" if origin else ""
    for f in sort_findings(findings):
        level = logging.WARNING if f.severity == ERROR else (
            logging.INFO if f.severity == WARNING else logging.DEBUG)
        logger.log(level, "import preflight%s: %s", src, f.format())
    return findings

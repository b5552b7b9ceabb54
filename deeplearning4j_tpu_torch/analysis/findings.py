"""Structured analysis findings, the port of the JAX package's
analysis/findings.py (standard library only).

Every analysis pass reports the same record: a short stable code, a
severity, where it happened, what is wrong and how to fix it, so that
passes share JSON output and exit-code policy. Codes in use in the port:

divergence sentinel (train/sentinel judging each optimizer step):
  SN001  a numerically anomalous optimizer step: a non-finite loss or
         gradient norm, or a gradient norm above k x the rolling median
         (warning: the step was quarantined; error: training diverged
         past the bounded rollback budget). Collected on the sentinel
         (`DivergenceSentinel.findings`).

SLO rules (analysis/slo evaluated live by utils/runledger):
  SLO001  a rule entered `firing` (severity = the rule's own). Collected
         on the ledger (`RunLedger.findings`).

shapeflow (analysis/shapeflow: the config graph, no params, no trace):
  SF001  nIn/nOut wiring mismatch (or unset) on a parameterized layer
  SF002  input-family mismatch / missing preprocessor between layers
  SF003  merge-vertex fan-in conflict (mixed kinds, unequal h/w/timesteps)
  SF004  dead or unreachable vertex / unused graph input / cycle
  SF005  vertex shape conflict (elementwise arity, subset out of range)
  SF006  precision promotion point (bf16 compute -> f32 loss head)
  SF007  no trainable loss head (fit() would fail)

step audit (analysis/graph_audit: one trace of the step on fake tensors):
  JX000  the audit could not run (no InputType, or the trace failed)
  JX001  float64 value inside the step
  JX002  widening float cast (bf16/f16 -> f32, f32 -> f64) in the step
  JX003  large tensor closed over by the step (not a parameter, state or
         input)
  JX004  host round trip inside the step (a device value read on the
         host: the card synchronises per step)
  JX005  parameter with no gradient path to the loss (dead weight)

cost model (analysis/costmodel — static device cost of the train step):
  JX007  cost model diverges from FlopCounterMode beyond tolerance
         (MFU/roofline numbers built on it are untrustworthy)
  JX008  static residency estimate (params + updater + data +
         activation liveness peak) exceeds the card's memory — will OOM

The JAX package's JX006 (undonated step buffers) has no counterpart in
eager PyTorch (analysis/graph_audit). The concurrency codes come from
analysis/lint.py (CC001–CC007 and the lexical CN002/CN003) and
analysis/concurrency_audit.py (CN001–CN003 over the merged static and
runtime lock graphs, utils/locktrace).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Iterable, List

ERROR = "error"
WARNING = "warning"
INFO = "info"

_SEVERITY_RANK = {ERROR: 0, WARNING: 1, INFO: 2}


@dataclasses.dataclass
class Finding:
    code: str        # "SN001" ...
    severity: str    # ERROR | WARNING | INFO
    location: str    # "step:41" / "fit" / "layer[3]:dense_1"
    message: str     # what is wrong, concretely
    fix_hint: str = ""   # the shortest path to green
    name: str = ""       # stable id for baseline diffs (no line numbers)

    def __post_init__(self):
        if not self.name:
            self.name = f"{self.code}:{self.location}"

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def format(self) -> str:
        hint = f"  [fix: {self.fix_hint}]" if self.fix_hint else ""
        return (f"{self.severity.upper():<7} {self.code} {self.location}: "
                f"{self.message}{hint}")


def sort_findings(findings: Iterable[Finding]) -> List[Finding]:
    """Severity-major order (errors first), then code, then location."""
    return sorted(findings,
                  key=lambda f: (_SEVERITY_RANK.get(f.severity, 3),
                                 f.code, f.location))


def has_errors(findings: Iterable[Finding]) -> bool:
    return any(f.severity == ERROR for f in findings)


def error_names(findings: Iterable[Finding]) -> List[str]:
    return sorted({f.name for f in findings if f.severity == ERROR})


def summarize(findings: Iterable[Finding]) -> dict:
    fs = list(findings)
    by = {ERROR: 0, WARNING: 0, INFO: 0}
    for f in fs:
        by[f.severity] = by.get(f.severity, 0) + 1
    return {
        "ok": by[ERROR] == 0,
        "errors": by[ERROR],
        "warnings": by[WARNING],
        "infos": by[INFO],
        "findings": [f.to_dict() for f in sort_findings(fs)],
    }


def to_json(findings: Iterable[Finding]) -> str:
    return json.dumps(summarize(findings), indent=2)


def format_findings(findings: Iterable[Finding]) -> str:
    fs = sort_findings(findings)
    if not fs:
        return "no findings"
    return "\n".join(f.format() for f in fs)

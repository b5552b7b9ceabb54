"""Step-program audit — the port of the JAX package's analysis/jaxpr_audit.py.

Where the JAX package walks one `jax.make_jaxpr` of a network's
train-step loss, the port audits the ops one optimizer step dispatches,
from the same trace the cost model takes (analysis/costmodel
`trace_step`: the step run once on fake tensors under a TorchDispatchMode,
no kernel, no device, no mutation). It catches the hazard classes that
otherwise only show up as slow steps or out-of-memory errors on the
card:

  JX001  float64/complex128 values — an H100 runs f64 at a fraction of
         its f32 rate and has no f64 tensor-core path for these nets
  JX002  widening float casts (bf16/f16 -> f32, f32 -> f64) — each one
         is a promotion point paying bandwidth for precision
  JX003  large tensors the step closes over (neither parameter, state,
         updater state nor batch) — device memory held outside what the
         net owns and the checkpoint saves (pass them as inputs)
  JX004  host round trips inside the step (`aten._local_scalar_dense`:
         `.item()`, `float(t)`, a Python branch on a tensor; a copy to
         the host) — each one synchronises the card every step
  JX005  params with no gradient path to the loss — dead weights that
         still cost memory, init time and optimizer state

The JAX package's JX006 (step buffers not donated) has no counterpart:
the port's updater adds its deltas to the parameters in place, so the
old and new parameters are never both live, and there is nothing to
donate. Codes, severities and the findings' stable names are the JAX
package's.

Two entry points: `audit_fn` for any callable (tests and ad-hoc
investigation), `audit_network` for a MultiLayerNetwork /
ComputationGraph (`net.doctor()`).
"""

from __future__ import annotations

from typing import Dict, List

import torch

from deeplearning4j_tpu_torch.analysis.costmodel import (
    _CostMode,
    _fake_mode,
    _skey,
    _tensors,
    trace_step,
)
from deeplearning4j_tpu_torch.analysis.findings import (
    ERROR,
    INFO,
    WARNING,
    Finding,
)

LARGE_CONST_BYTES = 1 << 20  # 1 MiB: bigger than any literal that belongs

_WIDE_FLOATS = ("float64", "complex128")


def audit_trace(mode: _CostMode, resident: set, *,
                large_const_bytes: int = LARGE_CONST_BYTES,
                what: str = "program") -> List[Finding]:
    """JX001-JX004 over an already-traced program. `resident` are the
    storages of the program's own inputs (parameters, state, updater
    state, batch)."""
    findings: List[Finding] = []

    # JX001: any f64/c128 value: inputs and closed-over tensors once,
    # then every op output by the op that made it
    wide: Dict[str, int] = {}
    n_in = sum(1 for _, _, dt in mode.external.values() if dt in _WIDE_FLOATS)
    if n_in:
        wide["input/const"] = n_in
    for name, n in mode.wide.items():
        wide[name] = wide.get(name, 0) + n
    if wide:
        total = sum(wide.values())
        findings.append(Finding(
            "JX001", ERROR, f"program:{what}",
            f"{total} float64/complex128 value(s) in the program "
            f"(by source: {dict(sorted(wide.items()))}) — the card runs "
            "f64 at a fraction of its f32 rate",
            "cast the offending inputs/constants to f32 (or the net's "
            "compute dtype) before the step"))

    # JX002: widening float casts (dedup by src->dst pair)
    for (src, dst), n in sorted(mode.casts.items()):
        sev = WARNING if dst == "float64" else INFO
        findings.append(Finding(
            "JX002", sev, f"program:{what}",
            f"{n} widening cast(s) {src} -> {dst} in the program",
            "intentional at loss/accumulation boundaries; anywhere else "
            "it silently pays f32 bandwidth for bf16 math",
            name=f"JX002:program:{what}:{src}->{dst}"))

    # JX003: big tensors the step reads that it neither owns nor made
    consts = sorted(((k, v) for k, v in mode.external.items()
                     if k not in resident and v[0] >= large_const_bytes),
                    key=lambda kv: -kv[1][0])
    for i, (_, (nbytes, shape, _dt)) in enumerate(consts):
        findings.append(Finding(
            "JX003", WARNING, f"program:{what}",
            f"tensor #{i} ({nbytes / 2**20:.1f} MiB, shape {shape}) is "
            "closed over by the step — held in device memory outside the "
            "net's parameters, state and batch, and not in its checkpoint",
            "pass it as an input (or make it a parameter or state of the "
            "layer that reads it) instead of closing over it",
            name=f"JX003:program:{what}:const{i}"))

    # JX004: host round trips inside the step
    for op, n in sorted(mode.host_reads.items()):
        findings.append(Finding(
            "JX004", WARNING, f"program:{what}",
            f"{n} host round trip(s) [{op}] inside the program — each "
            "synchronises the card with the host per step",
            "keep the value on the device (torch.where instead of a Python "
            "branch, a device accumulator instead of .item())",
            name=f"JX004:program:{what}:{op}"))
    return findings


def _live_keys(ops, out_keys) -> set:
    """Storages from which the outputs can be reached, by one reverse
    pass over the recorded ops (they run in order)."""
    live = set(out_keys)
    for _, ins, outs in reversed(ops):
        if any(k in live for k, *_ in outs):
            live.update(ins)
    return live


def audit_fn(fn, *example_args,
             large_const_bytes: int = LARGE_CONST_BYTES,
             what: str = "fn") -> List[Finding]:
    """Audit any callable on example arguments (tensors, or numpy arrays
    taken as tensors): run once on fake copies of them under the cost
    mode. Dead-input analysis runs against ALL outputs."""
    import numpy as np

    fm = _fake_mode()
    args = []
    for a in example_args:
        t = torch.from_numpy(np.asarray(a)) if isinstance(a, np.ndarray) else a
        args.append(fm.from_tensor(t) if torch.is_tensor(t) else t)
    mode = _CostMode()
    with fm, mode:
        out = fn(*args)
    resident = {_skey(t) for t in _tensors(args)}
    findings = audit_trace(mode, resident, large_const_bytes=large_const_bytes,
                           what=what)
    live = _live_keys(mode.ops, {_skey(t) for t in _tensors(out)})
    for i, a in enumerate(args):
        if torch.is_tensor(a) and _skey(a) not in live:
            label = f"{what}:arg[{i}]"
            findings.append(Finding(
                "JX005", WARNING, label,
                "input has no path to the loss — it is initialized, stored, "
                "and optimizer-tracked but can never receive a gradient",
                "remove the dead layer/vertex, or wire it into an output",
                name=f"JX005:{label}"))
    return findings


def audit_network(net, *, batch_size: int = 2, timesteps: int = 8,
                  large_const_bytes: int = LARGE_CONST_BYTES) -> List[Finding]:
    """Trace `net`'s optimizer step once and audit it. Works for
    MultiLayerNetwork and ComputationGraph. Needs the conf's InputType(s)
    to shape an example batch; without them the audit is skipped with an
    INFO finding (shapeflow reports the same gap)."""
    from deeplearning4j_tpu_torch.analysis.costmodel import batch_shapes

    net._require_init()
    try:
        batch_shapes(net, batch_size=batch_size, timesteps=timesteps)
    except ValueError:
        return [Finding(
            "JX000", INFO, "network",
            "no InputType on the configuration — cannot shape an example "
            "batch, program audit skipped",
            "set an InputType (builder .set_input_type / .set_input_types)")]
    tr = trace_step(net, batch_size=batch_size, timesteps=timesteps)
    findings = audit_trace(tr.mode, tr.resident,
                           large_const_bytes=large_const_bytes,
                           what="train_step")
    for label, reached in tr.param_labels:
        if not reached:
            findings.append(Finding(
                "JX005", WARNING, label,
                "parameter has no path to the loss — it is initialized, "
                "stored, and optimizer-tracked but can never receive a "
                "gradient",
                "remove the dead layer/vertex, or wire it into an output",
                name=f"JX005:{label}"))
    return findings

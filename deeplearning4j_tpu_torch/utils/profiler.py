"""Profiling hooks: torch.profiler capture + a device-op summary by
family, the port of the JAX package's utils/profiler.py.

Where the JAX package captures a jax.profiler trace and parses the
xplane into per-op device time, the port captures `torch.profiler` with
CUDA activity (CUPTI: every kernel, copy and memset the card ran, with
its device time) around a block (`trace()`) or over a window of fit
iterations (`ProfilerListener`), and reduces the capture to
[(kernel name, device seconds)] (`op_summary`). `op_family` groups the
names: the port's own kernels K1–K8 by name, the library's conv and GEMM
kernels (cuDNN, CUTLASS, cuBLAS), and the elementwise, reduction and
copy kernels. `roofline_columns` puts each family's measured time beside
its static cost-model bound (analysis/costmodel), and
`write_profile_json` writes the whole as one JSON artifact.

Device activity only, on the card: with CPU activity on, key_averages()
also gives each aten op its kernels' time as its own, and a sum would
count those kernels twice. A capture with no device activity (the CPU)
summarises the aten ops' own CPU time instead, and says so
(`device: false` in the ops record and the JSON).
"""

from __future__ import annotations

import contextlib
import glob
import json
import logging
import os
import time
from collections import Counter
from typing import List, Optional, Tuple

import torch

from deeplearning4j_tpu_torch.train.listeners import IterationListener

logger = logging.getLogger("deeplearning4j_tpu_torch")

_OPS_FILE = "ops.{stamp}.json"


def _activities():
    from torch.profiler import ProfilerActivity

    return [ProfilerActivity.CUDA] if torch.cuda.is_available() \
        else [ProfilerActivity.CPU]


def summarize_profile(prof) -> Tuple[List[Tuple[str, float]], bool]:
    """([(name, seconds)] desc, device) of a finished torch.profiler
    capture: each kernel's device time when the capture saw any device
    activity (device=True), else each aten op's own CPU time."""
    dev: Counter = Counter()
    cpu: Counter = Counter()
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", None)
        if t is None:
            t = getattr(e, "self_cuda_time_total", 0.0)
        if t and t > 0:
            dev[e.key] += t / 1e6
        c = getattr(e, "self_cpu_time_total", 0.0)
        if c and c > 0:
            cpu[e.key] += c / 1e6
    if dev:
        return dev.most_common(), True
    return cpu.most_common(), False


def save_summary(prof, log_dir: str) -> str:
    """Write the capture's summary as `ops.<stamp>.json` in log_dir (what
    op_summary reads back) and its chrome trace beside it."""
    os.makedirs(log_dir, exist_ok=True)
    rows, device = summarize_profile(prof)
    stamp = f"{time.time():.6f}"
    path = os.path.join(log_dir, _OPS_FILE.format(stamp=stamp))
    with open(path, "w") as f:
        json.dump({"device": device, "ops": rows}, f)
    try:
        prof.export_chrome_trace(os.path.join(log_dir, f"trace.{stamp}.json"))
    except Exception as e:  # the summary is the artifact; the trace a bonus
        logger.debug("chrome trace export failed: %s", e)
    return path


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a torch.profiler trace around a block (CUDA activity on
    the card, CPU off it); the summary lands in log_dir on exit."""
    from torch.profiler import profile

    with profile(activities=_activities()) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    save_summary(prof, log_dir)


def latest_summary(log_dir: str) -> Optional[str]:
    hits = sorted(glob.glob(os.path.join(log_dir, "ops.*.json")))
    return hits[-1] if hits else None


def _read_summary(log_dir: str) -> Tuple[List[Tuple[str, float]], bool]:
    path = latest_summary(log_dir)
    if path is None:
        return [], False
    with open(path) as f:
        doc = json.load(f)
    return [(n, float(s)) for n, s in doc.get("ops", [])], bool(doc.get("device"))


def op_summary(log_dir: str, top: int = 20) -> List[Tuple[str, float]]:
    """Device time by kernel from the newest capture in log_dir:
    [(kernel name, seconds)] sorted desc; [] when there is none."""
    rows, _ = _read_summary(log_dir)
    return rows[:top]


def format_summary(rows: List[Tuple[str, float]]) -> str:
    lines = ["device op time (top):"]
    for name, sec in rows:
        lines.append(f"  {sec * 1e3:9.3f} ms  {name[:110]}")
    return "\n".join(lines)


# -- op-family aggregation --------------------------------------------------------

# the port's own kernels (csrc/), by kernel symbol; the backward LSTM's
# names first (they contain the forward's)
_PORT_KERNELS = (
    ("lstm_sequence_bwd", "K3 lstm_sequence_bwd"),
    ("drw_partial_kernel", "K3 lstm_sequence_bwd"),
    ("drw_reduce_kernel", "K3 lstm_sequence_bwd"),
    ("lstm_sequence", "K1 lstm_sequence"),
    ("lstm_step_kernel", "K2 lstm_step"),
    ("conv1x1_stats", "K4 conv1x1_stats"),
    ("conv_kxk_stats", "K5 conv_kxk_stats"),
    ("bn_apply_kernel", "K6 bn_apply"),
    ("bn_reduce_kernel", "K7 bn_backward_reduce"),
    ("bn_dx_kernel", "K8 bn_backward_apply"),
    ("column_sums", "column_sums"),
)
# library and ATen kernels, by fragments of the name (first match wins)
_LIBRARY = (
    ("conv (library)", ("fprop", "dgrad", "wgrad", "implicit_gemm",
                        "convolution", "conv2d", "cudnn", "winograd")),
    ("gemm (library)", ("gemm", "cutlass", "cublas", "xmma", "matmul",
                        "aten::mm", "aten::addmm", "aten::bmm", "gemv")),
    ("copy", ("copy", "memcpy", "memset", "cat", "pad", "transpose",
              "permute", "index", "gather", "scatter", "fill", "clone",
              "contiguous", "to_copy")),
    ("reduction", ("reduce", "sum", "norm", "softmax", "mean", "pool",
                   "welford", "batch_norm_collect")),
    ("elementwise", ("elementwise", "vectorized", "pointwise", "aten::")),
)

# the cost model's side of each family: its MXU families by name, the
# rest by the kind of op (FamilyCost.kind)
_COST_GROUP = {
    "K4 conv1x1_stats": ("family", "conv_general_dilated"),
    "K5 conv_kxk_stats": ("family", "conv_general_dilated"),
    "conv (library)": ("family", "conv_general_dilated"),
    "K1 lstm_sequence": ("family", "dot_general"),
    "K2 lstm_step": ("family", "dot_general"),
    "K3 lstm_sequence_bwd": ("family", "dot_general"),
    "gemm (library)": ("family", "dot_general"),
    "K6 bn_apply": ("kind", "elementwise"),
    "K8 bn_backward_apply": ("kind", "elementwise"),
    "elementwise": ("kind", "elementwise"),
    "K7 bn_backward_reduce": ("kind", "reduction"),
    "column_sums": ("kind", "reduction"),
    "reduction": ("kind", "reduction"),
    "copy": ("kind", "data_movement"),
}

def op_family(name: str) -> str:
    """The family of a kernel (or, in a CPU capture, an aten op) name."""
    low = name.lower()
    for frag, fam in _PORT_KERNELS:
        if frag in low:
            return fam
    for fam, frags in _LIBRARY:
        if any(f in low for f in frags):
            return fam
    return "other"


def family_summary(rows: List[Tuple[str, float]]) -> List[Tuple[str, float]]:
    """Aggregate [(op_name, seconds)] into [(family, seconds)] desc."""
    fam: Counter = Counter()
    for name, sec in rows:
        fam[op_family(name)] += sec
    return fam.most_common()


def roofline_columns(families_ms: dict, cost_model: Optional[dict],
                     steps: int = 1) -> dict:
    """Each measured family's ms beside its cost-model bound: the FLOPs
    and bytes of the cost model's side of the family (the conv or the
    product family by name; elementwise, reduction and copy by the kind
    of op), for `steps` steps, and the least time the card could take for
    them (`bound_ms`, the larger of FLOPs over the peak and bytes over
    the memory rate; the H100 SXM figures off the card). A family that
    maps to none stays time-only. `cost_model` is CostModel.to_dict()."""
    if not cost_model:
        return {name: {"ms": ms} for name, ms in families_ms.items()}
    from deeplearning4j_tpu_torch.analysis.costmodel import _peak

    peak, bw = _peak()
    fams = cost_model.get("families") or {}
    out = {}
    for name, ms in families_ms.items():
        row = {"ms": ms}
        group = _COST_GROUP.get(name)
        if group is not None:
            how, key = group
            picked = {n: fc for n, fc in fams.items()
                      if (n == key if how == "family" else fc.get("kind") == key)}
            if picked:
                flops = steps * sum(fc.get("flops", 0.0) for fc in picked.values())
                nbytes = steps * sum(fc.get("bytes", 0.0) for fc in picked.values())
                row["flops"] = flops
                row["bytes"] = nbytes
                row["cost_model_family"] = key
                row["bound_ms"] = max(flops / peak, nbytes / bw) * 1e3
        out[name] = row
    return out


def write_profile_json(log_dir: str, path: str, top_ops: int = 40,
                       meta: Optional[dict] = None,
                       cost_model: Optional[dict] = None,
                       steps: int = 1) -> dict:
    """Export the family aggregation of the newest capture in log_dir as a
    JSON artifact. With `cost_model` (CostModel.to_dict() of one step) the
    export carries each family's roofline columns for `steps` steps.
    Returns the payload (families empty when log_dir holds no capture)."""
    rows, device = _read_summary(log_dir)
    fams = family_summary(rows)
    families_ms = {name: round(sec * 1e3, 6) for name, sec in fams}
    payload = {
        "meta": meta or {},
        "log_dir": os.path.abspath(log_dir),
        "device": device,
        "total_device_sec": round(sum(s for _, s in rows), 9) if device else 0.0,
        "families_ms": families_ms,
        "top_ops_ms": [{"op": name, "ms": round(sec * 1e3, 6)}
                       for name, sec in rows[:top_ops]],
    }
    if cost_model is not None:
        payload["cost_model"] = cost_model
        payload["families"] = roofline_columns(families_ms, cost_model, steps)
    with open(path, "w") as f:
        json.dump(payload, f, indent=2)
    logger.info("profile JSON written to %s (%d families)", path, len(fams))
    return payload


class ProfilerListener(IterationListener):
    """Capture a trace of the n_iterations steps after iteration `start`
    (iterations start+1 .. start+n, as in the JAX package) and log the op
    summary once finished (the listener-SPI packaging of the
    trace/summary workflow)."""

    def __init__(self, log_dir: str, start_iteration: int = 10,
                 n_iterations: int = 3, print_fn=None):
        self.log_dir = log_dir
        self.start = int(start_iteration)
        self.n = int(n_iterations)
        self.print_fn = print_fn or (lambda s: logger.info(s))
        self._prof = None
        self._last_iteration = -1
        self.summary: List[Tuple[str, float]] = []

    @property
    def _active(self) -> bool:
        return self._prof is not None

    def iteration_done(self, model, iteration, info):
        self._last_iteration = iteration
        if iteration == self.start and not self._active:
            self._open()
        elif self._active and iteration >= self.start + self.n:
            # the last step completes before the trace closes
            float(info["score"]())
            self._finalize()

    def _open(self):
        from torch.profiler import profile

        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._prof = profile(activities=_activities())
        self._prof.__enter__()

    def on_epoch_end(self, model, epoch):
        # training may end before the window closes: never leave the
        # profiler running. A window that spans an epoch boundary is
        # finalized early, with a warning
        if self._active:
            captured = self._last_iteration - self.start + 1
            if captured < self.n:
                logger.warning(
                    "profiler window truncated at epoch end (captured "
                    "%d of n_iterations=%d steps)", captured, self.n)
            self._finalize()

    def on_fit_end(self, model):
        if self._active:
            self._finalize()

    def _finalize(self):
        prof, self._prof = self._prof, None
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.__exit__(None, None, None)
        save_summary(prof, self.log_dir)
        self.summary = op_summary(self.log_dir)
        if self.summary:
            self.print_fn(format_summary(self.summary))

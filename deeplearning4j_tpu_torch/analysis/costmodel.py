"""Static device cost model of one optimizer step, the port of the JAX
package's analysis/costmodel.py: the static half of the device
observability layer (utils/devprof.py is the runtime half; each checks
the other).

Where the JAX package walks one `jax.make_jaxpr` of the full optimizer
step, the port runs the same body every fit step runs (`_step`: loss,
autograd, gradient normalization, updater) ONCE on a copy of the net
whose parameters, updater state and batch are fake tensors
(`torch._subclasses.fake_tensor.FakeTensorMode`: shapes and dtypes on
the host, no storage and no kernel), under a TorchDispatchMode that sees
every aten op the step dispatches. No device step runs and the net is
not touched. Helpers are disabled for the trace: model FLOPs are
implementation-independent, and a hand-written kernel launched through
ctypes is opaque to the dispatcher (it would count zero, as an opaque
Pallas call does in the JAX model). Per family it produces:

* **FLOPs** under the JAX package's accounting. The MXU families keep
  the JAX names: `dot_general` (aten mm, addmm, bmm, baddbmm, dot, mv)
  at 2·M·N·K and `conv_general_dilated` (aten convolution and each
  gradient convolution_backward computes) at the *valid* (output,
  kernel-tap) pairs: taps on padding do no work. Where the port
  realizes SAME with an explicit zero `F.pad` before the conv, the pad
  is remembered on the padded tensor and its taps still count zero.
  Elementwise ops (aten's `pointwise` tag) are one FLOP per output
  element, reductions one per reduced element; data movement is zero.
  Other families are named by their aten op.
* **bytes moved**: operand + result bytes per op, the no-fusion upper
  bound on HBM traffic.
* a **liveness-based activation peak** over the storages the step
  allocates: each goes live when an op first produces it and dies after
  its last use by any op (views share their base's storage); the
  step's outputs live to the end. Parameters, updater state and the
  batch are resident, not activations, and are counted apart.

The model checks itself against `torch.utils.flop_counter.FlopCounterMode`
(`cross_check` → JX007, the port's counterpart of XLA's
`cost_analysis()`: the MXU families within 10%; no count, no finding)
and against the card (`residency_findings` → JX008 when the static
residency exceeds the card's memory). Per-instance pricing for kernel
routing (`conv_instance_cost`, `bn_instance_cost`, `instance_roofline`)
is the JAX package's arithmetic, exactly; off the card the H100 SXM
figures stand in, since routing models the card the kernels target.

Known accounting gaps, deliberate and as in the JAX model: ops that a
hand-written kernel runs count zero (the trace disables helpers, so none
runs). A Python loop (the LSTM's timesteps) is traced unrolled, so every
body counts: the JAX model's loop-bodies-once view (`flops_once`,
`xla_comparable_flops`) has no counterpart here.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import torch

from deeplearning4j_tpu_torch.analysis.findings import ERROR, Finding

# the MXU families: the "model FLOPs" numerator of the MFU accounting
# (elementwise/reduction work is bandwidth-, not FLOPs-bound, and
# excluding it keeps MFU comparable across frameworks)
MXU_FAMILIES = ("conv_general_dilated", "dot_general")

COUNTER_TOLERANCE = 0.10  # JX007 default: cost model vs FlopCounterMode

_DOT_OPS = frozenset({"mm", "addmm", "bmm", "baddbmm", "dot", "mv", "addmv",
                      "addbmm", "vdot"})
_CONV_OPS = frozenset({"convolution", "convolution_backward"})

# pure data movement: zero FLOPs, but bytes still count (a transpose is
# free compute and real traffic)
_DATA_MOVEMENT = frozenset({
    "view", "_unsafe_view", "reshape", "permute", "transpose", "t", "expand",
    "squeeze", "unsqueeze", "slice", "select", "as_strided", "alias",
    "detach", "clone", "copy", "copy_", "_to_copy", "contiguous", "cat",
    "stack", "split", "split_with_sizes", "unbind", "chunk", "narrow",
    "constant_pad_nd", "index_select", "gather", "embedding", "index",
    "repeat", "flip", "roll", "zeros", "zeros_like", "ones", "ones_like",
    "full", "full_like", "empty", "empty_like", "empty_strided", "new_zeros",
    "new_ones", "new_full", "new_empty", "new_empty_strided", "fill", "fill_",
    "zero_", "scalar_tensor", "lift_fresh", "_local_scalar_dense", "arange",
    "lift_fresh_copy", "masked_fill", "masked_fill_", "_reshape_alias",
    "select_backward", "slice_backward", "expand_copy", "permute_copy",
    "view_copy", "_unsafe_index", "diagonal", "unfold", "movedim",
    "set_", "resize_", "_efficientzerotensor", "bernoulli", "bernoulli_",
    "uniform_", "normal_", "rand", "randn", "rand_like", "randn_like",
    "randint", "randperm", "exponential_", "random_",
})

_REDUCTIONS = frozenset({
    "sum", "mean", "amax", "amin", "max", "min", "prod", "var", "std",
    "var_mean", "std_mean", "norm", "linalg_vector_norm", "logsumexp",
    "argmax", "argmin", "all", "any", "count_nonzero", "nansum", "aminmax",
})

# window reductions and their pullbacks (JAX reduce_window /
# select_and_scatter_add)
_WINDOW = frozenset({"max_pool2d_with_indices", "avg_pool2d", "max_pool1d",
                     "avg_pool1d", "max_pool2d", "_adaptive_avg_pool2d"})
_WINDOW_BWD = frozenset({"max_pool2d_with_indices_backward",
                         "avg_pool2d_backward",
                         "_adaptive_avg_pool2d_backward"})
_SCATTER = frozenset({"scatter_add", "scatter_add_", "index_add",
                      "index_add_", "index_put", "index_put_",
                      "embedding_dense_backward", "scatter", "scatter_"})


def _numel(t) -> int:
    n = 1
    for s in t.shape:
        n *= int(s)
    return n


def _nbytes(t) -> int:
    return _numel(t) * t.element_size()


def _tensors(tree):
    """Every tensor in a (nested list/tuple/dict of) op arguments."""
    if torch.is_tensor(tree):
        yield tree
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            yield from _tensors(x)
    elif isinstance(tree, dict):
        for x in tree.values():
            yield from _tensors(x)


# -- per-instance pricing (the JAX package's arithmetic, exactly) --------------

def _conv_valid_pairs(out_sz: int, k_sz: int, in_sz: int, stride: int,
                      pad_lo: int, w_dil: int, b_dil: int) -> int:
    """Valid (output position, kernel tap) pairs along ONE spatial dim:
    taps landing in padding or on base-dilation holes do no work, and
    HLO cost analysis does not count them. Separable across dims, so the
    multi-dim count is the product of the per-dim counts."""
    span = (in_sz - 1) * b_dil + 1
    n = 0
    for o in range(out_sz):
        base = o * stride - pad_lo
        for k in range(k_sz):
            pos = base + k * w_dil
            if 0 <= pos < span and pos % b_dil == 0:
                n += 1
    return n


def _same_pad_lo(in_sz: int, k_sz: int, stride: int) -> Tuple[int, int]:
    """(out_sz, pad_lo) of one spatial dim under XLA SAME padding:
    out = ceil(in/s), total pad = max((out-1)*s + k - in, 0), low half
    first (XLA puts the extra pad on the high side)."""
    out_sz = -(-in_sz // stride)
    pad_total = max((out_sz - 1) * stride + k_sz - in_sz, 0)
    return out_sz, pad_total // 2


def conv_instance_cost(*, kernel, stride, x_shape, n_out: int,
                       itemsize: int) -> dict:
    """FLOPs and minimal HBM bytes of ONE bias-free SAME NHWC conv
    instance, priced at the valid pairs (taps landing in padding do no
    work). Bytes are the streaming floor: read x and w once, write y
    once; the fused stats epilogue adds nothing. The per-instance
    analogue of the per-family `CostModel.table()` rows, for kernel
    routing decisions made per shape rather than per program."""
    n, h, w, cin = (int(d) for d in x_shape)
    kh, kw = int(kernel[0]), int(kernel[1])
    sh, sw = int(stride[0]), int(stride[1])
    ho, ph = _same_pad_lo(h, kh, sh)
    wo, pw = _same_pad_lo(w, kw, sw)
    pairs = (_conv_valid_pairs(ho, kh, h, sh, ph, 1, 1)
             * _conv_valid_pairs(wo, kw, w, sw, pw, 1, 1))
    flops = 2.0 * n * n_out * cin * pairs
    bytes_ = itemsize * (n * h * w * cin + kh * kw * cin * n_out
                         + n * ho * wo * n_out)
    return {"flops": flops, "bytes": bytes_,
            "out_shape": (n, ho, wo, int(n_out))}


def bn_instance_cost(*, x_shape, itemsize: int, n_reads: int = 1,
                     n_writes: int = 1) -> dict:
    """FLOPs and bytes of one batch-norm pass over an NHWC activation:
    a handful of elementwise ops per element (priced at 4 FLOP/elem),
    `n_reads` full reads and `n_writes` full writes of the tensor.
    Per-channel vectors are noise and not counted."""
    numel = 1
    for d in x_shape:
        numel *= int(d)
    return {"flops": 4.0 * numel,
            "bytes": float(itemsize * numel * (n_reads + n_writes))}


def _peak(peak_flops=None, hbm_bandwidth=None) -> Tuple[float, float]:
    """The figures a roofline is drawn with: the card's, and off the card
    (or on a card the tables do not know) the H100 SXM data sheet's."""
    from deeplearning4j_tpu_torch.utils import flops as _flops

    peak = (peak_flops or _flops.peak_flops_per_chip()
            or _flops.H100_BF16_DENSE_FLOP_PER_S)
    bw = (hbm_bandwidth or _flops.hbm_bandwidth_per_chip()
          or _flops.H100_HBM_BYTES_PER_S)
    return float(peak), float(bw)


def instance_roofline(flops: float, bytes_: float,
                      peak_flops: Optional[float] = None,
                      hbm_bandwidth: Optional[float] = None) -> dict:
    """Roofline verdict for a single op instance — the same ridge test
    `CostModel.table()` applies per family, exposed for per-shape kernel
    routing (`ops/fused_conv_bn.conv_decision`'s planning stage). Off the
    card the H100 SXM figures stand in: routing models the card the
    kernels target, not the host."""
    peak, bw = _peak(peak_flops, hbm_bandwidth)
    ridge = peak / bw
    intensity = flops / bytes_ if bytes_ else 0.0
    return {
        "flops": flops,
        "bytes": bytes_,
        "intensity": round(intensity, 3),
        "ridge_intensity": round(ridge, 3),
        "verdict": ("compute-bound" if intensity >= ridge
                    else "memory-bound"),
    }


# -- the per-op accounting -----------------------------------------------------

def _skey(t):
    """Identity of a tensor's storage (views share their base's)."""
    try:
        return t.untyped_storage()._cdata
    except Exception:
        return ("tensor", id(t))


def _storage_bytes(t) -> int:
    try:
        return int(t.untyped_storage().nbytes())
    except Exception:
        return _nbytes(t)


def _family(name: str) -> str:
    if name in _DOT_OPS:
        return "dot_general"
    if name in _CONV_OPS:
        return "conv_general_dilated"
    # an in-place op is its functional family (add_ -> add)
    return name[:-1] if name.endswith("_") and not name.startswith("_") else name


def _kind(name: str, func) -> str:
    if name in _DOT_OPS or name in _CONV_OPS:
        return "mxu"
    if name in _DATA_MOVEMENT:
        return "data_movement"
    if name in _REDUCTIONS or name in _WINDOW or name in _WINDOW_BWD \
            or name in ("_softmax", "_log_softmax", "cumsum", "cumprod"):
        return "reduction"
    if torch.Tag.pointwise in getattr(func, "tags", ()) \
            or name in ("_softmax_backward_data", "_log_softmax_backward_data"):
        return "elementwise"
    return "other"


def _dot_flops(name, args, out) -> float:
    if name in ("mm", "addmm"):
        a = args[1] if name == "addmm" else args[0]
        return 2.0 * _numel(out) * int(a.shape[-1])
    if name in ("bmm", "baddbmm", "addbmm"):
        a = args[1] if name != "bmm" else args[0]
        return 2.0 * int(a.shape[0]) * int(a.shape[1]) * int(a.shape[2]) \
            * int((args[2] if name != "bmm" else args[1]).shape[-1])
    if name in ("mv", "addmv"):
        a = args[1] if name == "addmv" else args[0]
        return 2.0 * int(a.shape[0]) * int(a.shape[1])
    return 2.0 * _numel(args[0])  # dot, vdot


class _ConvGeometry:
    """The pads the port applied before a conv with an explicit zero
    `F.pad` (aten.constant_pad_nd), by the padded tensor's storage."""

    def __init__(self):
        self.pads: Dict[object, Tuple[tuple, list]] = {}

    def note_pad(self, out, pad, value):
        if value in (0, 0.0) and all(int(p) >= 0 for p in pad):
            self.pads[_skey(out)] = (tuple(out.shape), [int(p) for p in pad])

    def spatial(self, x, nd: int, padding):
        """(input size, pad_lo) of each of x's last nd dims: the padded
        tensor's own size less its explicit pad, and that pad's low side
        added to the conv's."""
        sizes = [int(s) for s in x.shape[-nd:]]
        los = [int(p) for p in padding]
        rec = self.pads.get(_skey(x))
        if rec is not None and rec[0] == tuple(x.shape):
            pad = rec[1]  # last dim first: [lo, hi, lo, hi, ...]
            for i in range(nd):
                j = nd - 1 - i  # dim -(i+1) counted from the end
                if 2 * i + 1 < len(pad):
                    lo, hi = pad[2 * i], pad[2 * i + 1]
                    sizes[j] -= lo + hi
                    los[j] += lo
        return sizes, los


def _conv_pairs(geo: _ConvGeometry, x, w, out_spatial, stride, padding,
                dilation, transposed) -> int:
    nd = len(stride)
    sizes, los = geo.spatial(x, nd, padding)
    pairs = 1
    for i in range(nd):
        k = int(w.shape[2 + i])
        if transposed:
            # y = conv(x dilated by the stride, the kernel), padded
            # dil*(k-1) - p on each side: the JAX lhs_dilation form
            pairs *= _conv_valid_pairs(
                int(out_spatial[i]), k, sizes[i], 1,
                int(dilation[i]) * (k - 1) - los[i], int(dilation[i]),
                int(stride[i]))
        else:
            pairs *= _conv_valid_pairs(
                int(out_spatial[i]), k, sizes[i], int(stride[i]), los[i],
                int(dilation[i]), 1)
    return pairs


def _conv_flops(geo, name, args, out, dense: bool = False) -> float:
    """2 x the (output, tap) MACs of a conv and of each gradient a
    convolution_backward computes: at the valid pairs, or with `dense`
    at every tap, pad taps included (FlopCounterMode's count)."""
    if name == "convolution":
        x, w = args[0], args[1]
        stride, padding, dilation, transposed = args[3], args[4], args[5], args[6]
        groups = int(args[8])
        y = out
        mult = 1
    else:
        # convolution_backward(grad_out, input, weight, bias_sizes,
        # stride, padding, dilation, transposed, output_padding, groups,
        # output_mask): each gradient it computes is one conv over the
        # same (output, tap) pairs as the forward
        y, x, w = args[0], args[1], args[2]
        stride, padding, dilation, transposed = args[4], args[5], args[6], args[7]
        groups = int(args[9])
        mask = args[10]
        mult = int(bool(mask[0])) + int(bool(mask[1]))
        if not mult:
            return 0.0
    nd = len(stride)
    if transposed:
        cin, cout_g = int(w.shape[0]), int(w.shape[1])
        per = cout_g * (cin // groups)
    else:
        per = int(w.shape[0]) * int(w.shape[1])
    if dense:
        pairs = 1
        for i in range(nd):
            pairs *= int((x if transposed else y).shape[-nd + i]) * int(w.shape[2 + i])
    else:
        pairs = _conv_pairs(geo, x, w, [int(s) for s in y.shape[-nd:]], stride,
                            padding, dilation, transposed)
    return mult * 2.0 * int(x.shape[0]) * per * pairs


def _op_flops(geo, name, func, args, outs) -> float:
    out = outs[0] if outs else None
    if name in _DOT_OPS:
        return _dot_flops(name, args, out)
    if name in _CONV_OPS:
        return _conv_flops(geo, name, args, out)
    if name in _DATA_MOVEMENT:
        return 0.0
    if name in _WINDOW:
        return float(_numel(args[0]))
    if name in _WINDOW_BWD:
        return float(_numel(args[0]) + _numel(args[1]))
    if name in _SCATTER:
        ts = list(_tensors(args))
        return float(_numel(ts[-1])) if ts else 0.0
    if name in _REDUCTIONS:
        n_in = sum(_numel(t) for t in _tensors(args))
        n_out = sum(_numel(t) for t in outs)
        return float(max(n_in - n_out, 0))
    if name in ("cumsum", "cumprod", "_softmax", "_log_softmax",
                "_softmax_backward_data", "_log_softmax_backward_data"):
        return float(_numel(out)) if out is not None else 0.0
    if torch.Tag.pointwise in getattr(func, "tags", ()):
        return float(_numel(out)) if out is not None else 0.0
    return 0.0


@dataclasses.dataclass
class FamilyCost:
    """Aggregate cost of one op family across the step."""

    flops: float = 0.0        # full execution
    bytes: float = 0.0        # operand+result bytes
    count: int = 0            # ops dispatched
    # mxu | elementwise | reduction | data_movement | other: what the
    # profiler's kernel families are matched against (utils/profiler)
    kind: str = "other"

    def to_dict(self) -> dict:
        return {"flops": self.flops, "bytes": self.bytes,
                "count": self.count, "kind": self.kind}


class _CostMode(torch.utils._python_dispatch.TorchDispatchMode):
    """Sees every aten op of the traced step: per-family FLOPs and bytes,
    and the storage liveness events the activation peak is taken from.
    It also records what the graph audit reads (wide dtypes, widening
    casts, host reads, tensors the step closes over), so one trace
    serves both."""

    def __init__(self):
        super().__init__()
        self.families: Dict[str, FamilyCost] = {}
        self.geo = _ConvGeometry()
        self.ops: List[tuple] = []   # (name, [in storage keys], [outs])
        self.keep: List[torch.Tensor] = []  # storages stay unique
        self.casts: Dict[tuple, int] = {}
        self.wide: Dict[str, int] = {}
        self.host_reads: Dict[str, int] = {}
        # storages an op read before any op produced them (parameters,
        # state, the batch, and tensors the step closes over), and those
        # the step produced
        self.external: Dict[object, Tuple[int, tuple, str]] = {}
        self.produced: set = set()
        # the MXU FLOPs as FlopCounterMode counts them (every conv tap)
        self.counter_comparable = 0.0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = func.overloadpacket.__name__
        ins = list(_tensors((args, kwargs)))
        for t in ins:
            k = _skey(t)
            if k not in self.produced and k not in self.external:
                self.external[k] = (_storage_bytes(t), tuple(t.shape),
                                    str(t.dtype).replace("torch.", ""))
        if name == "_local_scalar_dense":
            # a host read of a device value (.item(), float(t), a Python
            # branch on a tensor): recorded for the audit (JX004); a fake
            # tensor has no value to read, so the trace goes on with 0
            self.host_reads[name] = self.host_reads.get(name, 0) + 1
            if _is_fake(ins[0]):
                return False if ins[0].dtype == torch.bool else (
                    0.0 if ins[0].dtype.is_floating_point else 0)
        out = func(*args, **kwargs)
        outs = list(_tensors(out))
        if name == "constant_pad_nd" and outs:
            value = args[2] if len(args) > 2 else kwargs.get("value", 0)
            self.geo.note_pad(outs[0], args[1], value)
        fam = self.families.get(_family(name))
        if fam is None:
            fam = self.families[_family(name)] = FamilyCost(kind=_kind(name, func))
        f = _op_flops(self.geo, name, func, list(args), outs)
        if name in _CONV_OPS:
            self.counter_comparable += _conv_flops(self.geo, name, list(args),
                                                   outs[0] if outs else None, True)
        elif name in _DOT_OPS:
            self.counter_comparable += f
        fam.flops += f
        fam.bytes += sum(_nbytes(t) for t in ins) + sum(_nbytes(t) for t in outs)
        fam.count += 1
        self.ops.append((name, [_skey(t) for t in ins],
                         [(_skey(t), _storage_bytes(t), tuple(t.shape),
                           str(t.dtype).replace("torch.", "")) for t in outs]))
        self.keep.extend(outs)
        for t in outs:
            self.produced.add(_skey(t))
            if t.dtype in (torch.float64, torch.complex128):
                self.wide[name] = self.wide.get(name, 0) + 1
        if name == "_to_copy" and ins and outs:
            src, dst = ins[0].dtype, outs[0].dtype
            if src.is_floating_point and dst.is_floating_point \
                    and dst.itemsize > src.itemsize:
                key = (str(src).replace("torch.", ""), str(dst).replace("torch.", ""))
                self.casts[key] = self.casts.get(key, 0) + 1
            if ins[0].device.type != "cpu" and outs[0].device.type == "cpu":
                self.host_reads["copy_to_host"] = self.host_reads.get("copy_to_host", 0) + 1
        return out


def _is_fake(t) -> bool:
    try:
        from torch._subclasses.fake_tensor import FakeTensor
    except Exception:
        return False
    return isinstance(t, FakeTensor)


def _activation_peak(ops, resident: set, live_to_end: set
                     ) -> Tuple[int, Optional[dict]]:
    """Liveness watermark over the storages the step allocates: each
    goes live when first produced and dies after its last use (the
    step's outputs live to the end). Resident storages (parameters,
    updater state, the batch) are not activations."""
    last_use: Dict[object, int] = {}
    n = len(ops)
    for i, (_, ins, outs) in enumerate(ops):
        for k in ins:
            last_use[k] = i
        for k, *_ in outs:
            last_use[k] = max(last_use.get(k, i), i)
    for k in live_to_end:
        last_use[k] = n
    produced = set(resident)
    live = peak = 0
    largest: Optional[dict] = None
    dying: Dict[int, List[Tuple[object, int]]] = {}
    for i, (_, _, outs) in enumerate(ops):
        for k, nb, shape, dtype in outs:
            if k in produced:
                continue
            produced.add(k)
            if nb:
                live += nb
                dying.setdefault(last_use.get(k, i), []).append((k, nb))
                if largest is None or nb > largest["bytes"]:
                    largest = {"shape": shape, "dtype": dtype, "bytes": nb}
        peak = max(peak, live)
        for _, nb in dying.pop(i, ()):
            live -= nb
    return peak, largest


@dataclasses.dataclass
class CostModel:
    """Per-family device cost of one traced step, plus the static memory
    picture. Field and method names are the JAX package's."""

    what: str
    families: Dict[str, FamilyCost]
    activation_peak_bytes: int
    largest_activation: Optional[dict]
    param_bytes: int = 0
    updater_bytes: int = 0
    data_bytes: int = 0
    const_bytes: int = 0
    # bytes (within param_bytes/updater_bytes) of layers declared
    # `host_resident=True` (host-sharded embedding tables pulled row-wise
    # through the parameter server): they never occupy device memory
    host_resident_param_bytes: int = 0
    host_resident_updater_bytes: int = 0
    # the traced step also holds such a table's gradient live in the
    # activation peak; the pipeline keeps it host-side, so that share of
    # the peak is exempt too (clamped to the peak)
    host_resident_activation_bytes: int = 0
    batch: Optional[int] = None
    # data-axis shard count of the net the step was traced from (1 for a
    # one-process net): the traced step is the GLOBAL step, so every
    # per-chip view divides batch-sharded quantities by this
    data_axis_shards: int = 1
    # the priced gradient all-reduce schedule (MeshPlan.collective_describe)
    # of a meshed net; priced apart from the FLOP families
    collective: Optional[dict] = None
    # the MXU FLOPs counted as FlopCounterMode counts them (every conv
    # tap, pad taps included): the figure JX007 compares
    counter_comparable_flops: float = 0.0

    @property
    def flops_total(self) -> float:
        return sum(fc.flops for fc in self.families.values())

    @property
    def bytes_total(self) -> float:
        return sum(fc.bytes for fc in self.families.values())

    @property
    def model_flops(self) -> float:
        """MXU-family FLOPs only — the MFU numerator (GLOBAL: the whole
        traced step across all data shards)."""
        return sum(fc.flops for name, fc in self.families.items()
                   if name in MXU_FAMILIES)

    @property
    def model_flops_per_chip(self) -> float:
        """model_flops divided by the data-axis size — the per-chip MFU
        numerator."""
        return self.model_flops / max(1, self.data_axis_shards)

    @property
    def resident_bytes(self) -> int:
        """Static peak-memory estimate PER CHIP: parameters, updater
        state and constants replicated (full size a card), the batch and
        the activation peak split over the data axis; host-resident
        tables subtracted."""
        n = max(1, self.data_axis_shards)
        device_param = self.param_bytes - self.host_resident_param_bytes
        device_upd = self.updater_bytes - self.host_resident_updater_bytes
        device_act = max(
            0, self.activation_peak_bytes - self.host_resident_activation_bytes)
        return (device_param + device_upd + self.const_bytes
                + (self.data_bytes + device_act) // n)

    def roofline(self, peak_flops: Optional[float] = None,
                 hbm_bandwidth: Optional[float] = None) -> dict:
        """Program-level roofline verdict: the step-time lower bound is
        max(compute, traffic) at the given peak; the MFU ceiling is what
        model FLOPs could at best achieve against that bound. Per chip."""
        peak, bw = _peak(peak_flops, hbm_bandwidth)
        n = max(1, self.data_axis_shards)
        t_compute = self.flops_total / n / peak
        t_memory = self.bytes_total / n / bw
        bound = max(t_compute, t_memory, 1e-30)
        out = {
            "peak_flops": peak,
            "hbm_bandwidth": bw,
            "ridge_intensity": peak / bw,
            "compute_seconds": t_compute,
            "memory_seconds": t_memory,
            "bound": "compute" if t_compute >= t_memory else "memory",
            "step_time_lower_bound_seconds": bound,
            "mfu_ceiling": self.model_flops_per_chip / (peak * bound),
        }
        if self.collective is not None:
            # reported beside the bound, never added to it: the bucketed
            # schedule exists to overlap the all-reduce with compute
            t_coll = self.collective.get("ring_estimate_seconds")
            out["collective_seconds"] = t_coll
            if t_coll is not None:
                out["collective_hidden_by_compute"] = bool(t_coll <= bound)
        return out

    def table(self, peak_flops: Optional[float] = None,
              hbm_bandwidth: Optional[float] = None) -> List[dict]:
        """Per-family rows, FLOPs-descending, each classified compute-
        vs memory-bound against the roofline ridge intensity."""
        peak, bw = _peak(peak_flops, hbm_bandwidth)
        ridge = peak / bw
        rows = []
        for name, fc in sorted(self.families.items(),
                               key=lambda kv: -kv[1].flops):
            intensity = fc.flops / fc.bytes if fc.bytes else 0.0
            rows.append({
                "family": name,
                "count": fc.count,
                "flops": fc.flops,
                "bytes": fc.bytes,
                "intensity": round(intensity, 3),
                "verdict": ("compute-bound" if intensity >= ridge
                            else "memory-bound"),
                "mxu": name in MXU_FAMILIES,
            })
        return rows

    def to_dict(self) -> dict:
        return {
            "what": self.what,
            "batch": self.batch,
            "flops_total": self.flops_total,
            "bytes_total": self.bytes_total,
            "model_flops": self.model_flops,
            "activation_peak_bytes": self.activation_peak_bytes,
            "largest_activation": self.largest_activation,
            "param_bytes": self.param_bytes,
            "updater_bytes": self.updater_bytes,
            "host_resident_param_bytes": self.host_resident_param_bytes,
            "host_resident_updater_bytes": self.host_resident_updater_bytes,
            "host_resident_activation_bytes":
                self.host_resident_activation_bytes,
            "data_bytes": self.data_bytes,
            "const_bytes": self.const_bytes,
            "data_axis_shards": self.data_axis_shards,
            "model_flops_per_chip": self.model_flops_per_chip,
            "resident_bytes": self.resident_bytes,
            "collective": self.collective,
            "counter_comparable_flops": self.counter_comparable_flops,
            "families": {k: v.to_dict() for k, v in self.families.items()},
        }


# -- tracing -------------------------------------------------------------------

@contextlib.contextmanager
def _helpers_disabled():
    """Every registered helper off for the trace, the caller's kill-switch
    state restored after (a fake tensor must never reach a kernel)."""
    from deeplearning4j_tpu_torch.ops import helpers as _h

    saved = {op: _h.helper_enabled(op) for op in _h.helper_names()}
    for op in saved:
        _h.set_helper_enabled(op, False)
    try:
        yield
    finally:
        for op, enabled in saved.items():
            if enabled is not None:
                _h.set_helper_enabled(op, enabled)


def _fake_mode():
    from torch._subclasses.fake_tensor import FakeTensorMode

    return FakeTensorMode(allow_non_fake_inputs=True)


def _map_tree(fn, tree):
    if torch.is_tensor(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_tree(fn, v) for v in tree]
    if isinstance(tree, tuple):
        return tuple(_map_tree(fn, v) for v in tree)
    return tree


def _tree_bytes(tree) -> int:
    return sum(_nbytes(t) for t in _tensors(tree))


def _features(it, batch: int, timesteps: int):
    """The shape of an example batch of features for an InputType."""
    from deeplearning4j_tpu_torch.nn.conf.inputs import (
        ConvolutionalFlatInput,
        ConvolutionalInput,
        FeedForwardInput,
        RecurrentInput,
    )

    if isinstance(it, ConvolutionalInput):
        return (batch, it.height, it.width, it.channels)
    if isinstance(it, ConvolutionalFlatInput):
        return (batch, it.arity())
    if isinstance(it, RecurrentInput):
        return (batch, it.timesteps or timesteps, it.size)
    if isinstance(it, FeedForwardInput):
        return (batch, it.size)
    return None


def _labels(out_type, batch: int, timesteps: int):
    from deeplearning4j_tpu_torch.nn.conf.inputs import RecurrentInput

    if isinstance(out_type, RecurrentInput):
        return (batch, out_type.timesteps or timesteps, out_type.size)
    if out_type is not None:
        return (batch, out_type.arity())
    return None


def batch_shapes(net, *, batch_size: int = 8, timesteps: int = 16):
    """(feature shapes, label shapes) of an example batch shaped from the
    conf's InputTypes via shapeflow: one of each for a MultiLayerNetwork,
    a list for a graph. Raises ValueError when the conf has no InputType
    to shape a batch."""
    from deeplearning4j_tpu_torch.analysis import shapeflow
    from deeplearning4j_tpu_torch.nn.conf.network import MultiLayerConfiguration

    conf = net.conf
    if isinstance(conf, MultiLayerConfiguration):
        x = _features(conf.input_type, batch_size, timesteps)
        out_types = shapeflow.propagate_types(conf)
        y = _labels(out_types[-1] if out_types else None, batch_size, timesteps)
        if x is None or y is None:
            raise ValueError(
                "no InputType on the configuration — cannot shape an "
                "example batch for the cost model")
        return x, y
    if conf.input_types is None:
        raise ValueError(
            "no InputTypes on the configuration — cannot shape an example "
            "batch for the cost model")
    xs = [_features(t, batch_size, timesteps) for t in conf.input_types]
    types = shapeflow.propagate_types(conf)
    ys = [_labels(types.get(name), batch_size, timesteps) for name in conf.outputs]
    if any(v is None for v in xs) or any(v is None for v in ys):
        raise ValueError(
            "could not shape example features/labels from the graph's "
            "InputTypes")
    return xs, ys


@dataclasses.dataclass
class StepTrace:
    """What one traced step left: the cost mode's records, the resident
    storages and the step's outputs, and which parameter leaves the loss
    reached (the graph audit's JX005)."""

    mode: _CostMode
    resident: set
    live_to_end: set
    param_labels: List[Tuple[str, bool]]
    counter_flops: Optional[float] = None


def _host_resident_index(net) -> frozenset:
    try:
        return frozenset(i for i, lc in enumerate(net._ordered_layer_confs())
                         if getattr(lc, "host_resident", False))
    except Exception:
        return frozenset()


def _layer_names(net) -> List[str]:
    names = getattr(net, "layer_vertex_names", None)
    if names:
        return list(names)
    return [getattr(lc, "name", None) or f"layer[{i}]"
            for i, lc in enumerate(net._ordered_layer_confs())]


def train_step_args(net, *, batch_size: int = 8, timesteps: int = 16):
    """(step, args) of the FULL optimizer step — the body every fit step
    runs (`_step`: loss, autograd, gradient normalization, updater) — on
    a copy of the net whose parameters, layer state and updater state are
    fake tensors, with a zero example batch shaped from the conf's
    InputTypes via shapeflow. `step(*args)` returns (states, score); call
    it inside `step.fake_mode` (the FakeTensorMode the args belong to)
    with helpers disabled, as `trace_step` does. Shared by the cost
    model, the step audit and the FlopCounterMode cross-check, so all
    measure the same program. Raises ValueError when the conf has no
    InputType to shape a batch."""
    from deeplearning4j_tpu_torch.nn.conf.network import MultiLayerConfiguration

    net._require_init()
    x_shape, y_shape = batch_shapes(net, batch_size=batch_size, timesteps=timesteps)
    fm = _fake_mode()
    # every fake lives on the host, whatever the net's device: the model
    # is device-independent, and the host's autograd runs the backward
    # on the calling thread, under the modes entered there
    dev = torch.device("cpu")

    def fake(t):
        with fm:
            return torch.empty_strided(tuple(t.shape), tuple(t.stride()), dtype=t.dtype,
                                       device=dev)

    clone = copy.copy(net)
    clone.device = dev
    clone.params_list = _map_tree(fake, net.params_list)
    clone.state_list = _map_tree(fake, net.state_list)
    clone.upd_state = _map_tree(fake, net.upd_state)
    clone._mesh_plan = None
    clone._sentinel = None
    clone._collect_stats = False
    clone._step_diag = None
    clone._last_stats = None
    with fm:
        dtype = torch.float32
        if isinstance(net.conf, MultiLayerConfiguration):
            data = (torch.zeros(x_shape, dtype=dtype, device=dev),
                    torch.zeros(y_shape, dtype=dtype, device=dev), None, None)
        else:
            data = ([torch.zeros(s, dtype=dtype, device=dev) for s in x_shape],
                    [torch.zeros(s, dtype=dtype, device=dev) for s in y_shape],
                    None, None)
        lr = torch.full((), 0.1, dtype=torch.float32, device=dev)
        t = torch.full((), 1.0, dtype=torch.float32, device=dev)
    builder = clone._std_loss_builder()
    rng = clone._step_rng(0)

    def step(states, data, lr, t):
        return clone._step(builder, states, data, lr, t, rng)

    step.fake_mode, step.net, step.builder, step.rng = fm, clone, builder, rng
    return step, (clone.state_list, data, lr, t)


def trace_step(net, *, batch_size: int = 8, timesteps: int = 16,
               count_flops: bool = False) -> StepTrace:
    """Run `net`'s full optimizer step (`train_step_args`) once on fake
    tensors under the cost mode (and, with `count_flops`, under
    FlopCounterMode as well). No kernel runs, nothing is allocated on the
    device, the net is not touched."""
    step, args = train_step_args(net, batch_size=batch_size, timesteps=timesteps)
    clone = step.net
    mode = _CostMode()
    counter = None
    if count_flops:
        try:
            from torch.utils.flop_counter import FlopCounterMode

            counter = FlopCounterMode(display=False)
        except Exception:
            counter = None
    leaves = [(i, k, p[k]) for i, p in enumerate(clone.params_list) for k in sorted(p)]
    with _helpers_disabled(), step.fake_mode:
        resident = {_skey(v) for v in _tensors((clone.params_list, clone.upd_state, args))}
        with contextlib.ExitStack() as stack:
            if counter is not None:
                stack.enter_context(counter)
            stack.enter_context(mode)
            states, score = step(*args)
        live_to_end = {_skey(v) for v in _tensors((states, score))}
        # which leaves the loss reaches, as autograd sees it (one more
        # loss on the fakes, outside the cost mode)
        labels = _param_labels(clone, step.builder, args[1], step.rng, leaves)
    counter_flops = None
    if counter is not None:
        try:
            counter_flops = float(counter.get_total_flops())
        except Exception:
            counter_flops = None
    return StepTrace(mode, resident, live_to_end, labels, counter_flops)


def _param_labels(clone, builder, data, rng, leaves):
    """[(\"param:<layer>/<key>\", reached)] for every trainable parameter
    leaf outside a host-resident layer: whether autograd finds a path
    from it to the step's loss."""
    names = _layer_names(clone)
    host = _host_resident_index(clone)
    trainable = clone._trainable_keys()
    want = [(i, k, v) for i, k, v in leaves
            if i not in host and k in trainable[i]]
    for _, _, v in want:
        v.requires_grad_(True)
    try:
        score, _ = builder(clone.params_list, clone.state_list, data, rng)
        grads = torch.autograd.grad(score, [v for _, _, v in want],
                                    allow_unused=True) if want else ()
    finally:
        for _, _, v in want:
            v.requires_grad_(False)
    out = []
    for (i, k, _), g in zip(want, grads):
        layer = names[i] if i < len(names) else f"layer[{i}]"
        out.append((f"param:{layer}/{k}", g is not None))
    return out


def _model_of_trace(net, tr: StepTrace, batch_size: int) -> CostModel:
    peak, largest = _activation_peak(tr.mode.ops, tr.resident, tr.live_to_end)
    cm = CostModel(what=f"{type(net).__name__}:train_step",
                   families=tr.mode.families, activation_peak_bytes=peak,
                   largest_activation=largest,
                   counter_comparable_flops=tr.mode.counter_comparable)
    cm.batch = int(batch_size)
    cm.param_bytes = _tree_bytes(net.params_list)
    cm.updater_bytes = _tree_bytes(net.upd_state)
    x_shape, y_shape = batch_shapes(net, batch_size=batch_size)
    shapes = [x_shape, y_shape] if isinstance(x_shape, tuple) else x_shape + y_shape
    cm.data_bytes = sum(4 * int(torch.Size(s).numel()) for s in shapes)
    host = _host_resident_index(net)
    for i in host:
        if i < len(net.params_list):
            cm.host_resident_param_bytes += _tree_bytes(net.params_list[i])
        if net.upd_state is not None and i < len(net.upd_state):
            cm.host_resident_updater_bytes += _tree_bytes(net.upd_state[i])
    cm.host_resident_activation_bytes = min(
        int(cm.activation_peak_bytes), 2 * cm.host_resident_param_bytes)
    plan = getattr(net, "_mesh_plan", None)
    if plan is not None:
        cm.data_axis_shards = max(1, int(plan.n_data_shards))
        try:
            cm.collective = plan.collective_describe(net)
        except Exception:
            cm.collective = None  # pricing must never sink the model
    return cm


def cost_fn(fn: Callable, *args, what: str = "fn") -> CostModel:
    """Cost-model any callable on its arguments (run once under the cost
    mode; pass fake or meta tensors to keep it free)."""
    mode = _CostMode()
    with mode:
        out = fn(*args)
    resident = {_skey(t) for t in _tensors(args)}
    peak, largest = _activation_peak(mode.ops, resident,
                                     {_skey(t) for t in _tensors(out)})
    return CostModel(what=what, families=mode.families,
                     activation_peak_bytes=peak, largest_activation=largest,
                     counter_comparable_flops=mode.counter_comparable)


def train_step_cost(net, *, batch_size: int = 8,
                    timesteps: int = 16) -> CostModel:
    """Cost-model `net`'s full optimizer step at the given batch shape.
    One trace on fake tensors — no kernel, no device step, no mutation."""
    tr = trace_step(net, batch_size=batch_size, timesteps=timesteps)
    return _model_of_trace(net, tr, batch_size)


# -- cross-checks --------------------------------------------------------------

def cross_check(cm: CostModel, counter_flops: Optional[float],
                tolerance: float = COUNTER_TOLERANCE) -> List[Finding]:
    """JX007: the model's MXU families must agree with FlopCounterMode's
    count within `tolerance`. The counter takes every conv tap, pad taps
    included, so the model's figure compared is its same-rule count
    (`counter_comparable_flops`): the check holds the op coverage and the
    product and conv shapes, and the valid-pair rule stands on its own
    tests. No count available -> no finding (skip, not fail)."""
    if not counter_flops or counter_flops <= 0:
        return []
    ours = cm.counter_comparable_flops
    rel = abs(ours - counter_flops) / counter_flops
    if rel <= tolerance:
        return []
    return [Finding(
        "JX007", ERROR, f"costmodel:{cm.what}",
        f"cost model diverges from FlopCounterMode by {rel:.1%} "
        f"(model {ours:.4g} vs counter {counter_flops:.4g} MXU flops, "
        f"tolerance {tolerance:.0%}) — MFU/roofline numbers built on this "
        "model are not trustworthy for this program",
        "an op family is mis-accounted: compare the per-family totals "
        "(CostModel.table()) against the step and fix the rule",
        name=f"JX007:costmodel:{cm.what}")]


def residency_findings(cm: CostModel,
                       hbm_bytes: Optional[float] = None) -> List[Finding]:
    """JX008: static residency (params + updater + data + consts +
    activation liveness peak) exceeding the card's memory — the step
    will run out of memory before it completes. Skipped when the card's
    memory is unknown (off the GPU)."""
    if hbm_bytes is None:
        from deeplearning4j_tpu_torch.utils import flops as _flops

        hbm_bytes = _flops.peak_hbm_bytes_per_chip()
    if not hbm_bytes:
        return []
    resident = cm.resident_bytes
    if resident <= hbm_bytes:
        return []
    exempt = cm.host_resident_param_bytes + cm.host_resident_updater_bytes
    exempt_note = (f"; {exempt / 2**30:.2f} GiB of host-resident tables "
                   "already exempted" if exempt else "")
    return [Finding(
        "JX008", ERROR, f"costmodel:{cm.what}",
        f"static peak memory estimate {resident / 2**30:.2f} GiB exceeds "
        f"device memory {hbm_bytes / 2**30:.2f} GiB (activations "
        f"{cm.activation_peak_bytes / 2**30:.2f} GiB, params "
        f"{cm.param_bytes / 2**30:.2f} GiB, updater "
        f"{cm.updater_bytes / 2**30:.2f} GiB{exempt_note}) — the step "
        "will run out of memory before it completes",
        "shrink the batch, shard the model (parallel/ tensor or pipeline "
        "parallelism), or mark embedding tables host_resident and serve "
        "them via the parameter server",
        name=f"JX008:costmodel:{cm.what}")]


def check_network(net, *, batch_size: int = 8, timesteps: int = 16,
                  tolerance: float = COUNTER_TOLERANCE,
                  count_flops: bool = True,
                  hbm_bytes: Optional[float] = None
                  ) -> Tuple[CostModel, Optional[float], List[Finding]]:
    """The full static check: cost-model the train step, cross-check its
    MXU FLOPs against FlopCounterMode in the same trace (JX007), and
    check static residency against the card's memory (JX008). Returns
    (model, the counter's FLOPs or None, findings)."""
    tr = trace_step(net, batch_size=batch_size, timesteps=timesteps,
                    count_flops=count_flops)
    cm = _model_of_trace(net, tr, batch_size)
    findings = cross_check(cm, tr.counter_flops, tolerance=tolerance)
    findings += residency_findings(cm, hbm_bytes=hbm_bytes)
    return cm, tr.counter_flops, findings

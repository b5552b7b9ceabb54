"""Conv + batch-norm-statistics fusion and the fused batch-norm passes for
Hopper, behind the helper SPI.

The port of the JAX package's ops/pallas_conv_bn.py. Five kernels:

- K4 `conv1x1_stats` (csrc/conv1x1_stats.cu) and K5 `conv_kxk_stats`
  (csrc/conv_kxk_stats.cu): a SAME bias-free convolution whose epilogue
  also returns per-channel sums of y and y^2 (of y as stored), so the BN
  that follows needs no pass of its own over y for its statistics.
- K6 `bn_normalize` (csrc/bn_apply.cu): the BN apply, with or without ReLU.
- K7 `bn_backward_reduce` and K8 `bn_backward_apply` (csrc/bn_backward.cu):
  the BN pullback's reduce and apply passes. Both take the ReLU gate
  (`gate_y2`: g where the saved output y > 0, else 0) and the bf16
  centring (`mean_b`: x - mean_b rounded to x's dtype) as a prologue on
  their loads, so neither tensor is materialised.

Around them, as in the JAX package: `conv2d_bn_stats` (K4/K5 forward, the
two transposed convolutions as its backward) and `bn_apply` (K6 forward;
K7+K8 backward through `bn_backward_pieces`) are autograd Functions — the
counterparts of the `custom_vjp`s — and three helper slots route layers to
them: "conv2d", "batch_norm" and "bn_backward". The conv hands its
statistics to the BN layer that consumes its output through a stash keyed
by tensor identity: in eager PyTorch the conv's output object is the BN
layer's input object, so a match by `is` is exact.

The ReLU after a BN is decided by the graph, not deferred: where a
BatchNormalization vertex's only consumer is a relu ActivationLayer,
ComputationGraph tells the BN layer so (`LayerContext.fuse_relu`), the BN
returns its output rectified (here, the ReLU variant of K6), and the
graph passes it straight through the relu vertex. (The JAX package
stashes a thunk and relies on XLA to drop the plain normalize as dead
code; eager PyTorch drops nothing, so that design would run K6 twice.)

Beside each kernel is its plain PyTorch version (`*_reference`): the same
function in step-by-step torch ops, math in f32 for f32 and bf16 tensors
and in f64 for f64 tensors (gradient checks); the conv statistics' sums
accumulate in f64 (`_stats_of_stored`). The wrappers take the plain
version only for tensors on the CPU; on a CUDA tensor they launch the
kernel or raise. Each launch adds one to its count in `launch_counts()`.

Layouts are the JAX package's: NHWC activations, HWIO weights, [M, C]
rows for the BN passes. Statistics are f32 (f64 for f64 tensors).
"""

from __future__ import annotations

import contextlib
import threading
from collections import deque
from typing import Dict

import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.ops import cuda_build
from deeplearning4j_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    active_data_mesh,
    all_reduce_,
    data_shards,
)

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_count_lock = threading.Lock()
_LAUNCHES: Dict[str, int] = {"conv1x1_stats": 0, "conv_kxk_stats": 0,
                             "bn_apply": 0, "bn_backward_reduce": 0,
                             "bn_backward_apply": 0}


def launch_counts() -> Dict[str, int]:
    """Kernel launches per wrapper since the last reset."""
    with _count_lock:
        return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    with _count_lock:
        for k in _LAUNCHES:
            _LAUNCHES[k] = 0


# a thread's launch tally while a CUDA graph captures, and the tallies of
# the streams being captured (see `recording_launches`)
_recording = threading.local()
_stream_tallies: Dict[int, Dict[str, int]] = {}


def _bump(name: str) -> None:
    tally = getattr(_recording, "tally", None)
    if tally is None and _stream_tallies:
        tally = _stream_tallies.get(torch.cuda.current_stream().cuda_stream)
    if tally is not None:
        tally[name] = tally.get(name, 0) + 1
        return
    with _count_lock:
        _LAUNCHES[name] += 1


@contextlib.contextmanager
def recording_launches(stream=None):
    """While a CUDA graph captures on this thread, the wrappers' launches
    go into the yielded dict (name -> launches) instead of the counts: a
    capture records its kernels and launches none. With the capture's
    `stream`, launches any thread makes on that stream are recorded too:
    a captured backward runs on the autograd engine's thread. The graph's
    owner adds the tally with `add_launches` on every replay, so
    `launch_counts()` stays a count of launches."""
    prev = getattr(_recording, "tally", None)
    _recording.tally = tally = {}
    if stream is not None:
        _stream_tallies[stream.cuda_stream] = tally
    try:
        yield tally
    finally:
        _recording.tally = prev
        if stream is not None:
            _stream_tallies.pop(stream.cuda_stream, None)


def add_launches(tally: Dict[str, int]) -> None:
    """Add a recorded tally to the counts: one replay of a captured graph."""
    with _count_lock:
        for name, n in tally.items():
            _LAUNCHES[name] += n


# -- the conv -> BN statistics stash ------------------------------------------
#
# Entries match by `is`, so they only ever connect a conv to the BN layer
# that consumes that exact tensor. A bounded deque: an entry nothing
# consumes ages out.

_STATS_STASH: deque = deque(maxlen=8)


def _stash_stats(y, s1, s2) -> None:
    _STATS_STASH.append((y, s1, s2))


def take_stats(x):
    """(sum, sum_sq) per-channel stats stashed for exactly this tensor,
    removing the entry; None when x is not a stashed conv output."""
    for i, entry in enumerate(_STATS_STASH):
        if entry[0] is x:
            del _STATS_STASH[i]
            return entry[1], entry[2]
    return None


def peek_stats(x) -> bool:
    return any(entry[0] is x for entry in _STATS_STASH)


# -- shapes ---------------------------------------------------------------------


def same_pads(in_sz: int, k: int, s: int, d: int = 1):
    """(out, pad_lo, pad_hi) of one spatial dim under XLA's SAME padding:
    the odd extra pixel goes on the HIGH side (torch's symmetric padding
    would shift the output by one pixel)."""
    out = -(-in_sz // s)
    total = max((out - 1) * s + (k - 1) * d + 1 - in_sz, 0)
    return out, total // 2, total - total // 2


def conv2d_nhwc(x, w, strides, pads, dilation=(1, 1)):
    """NHWC x HWIO convolution with explicit ((top, bottom), (left, right))
    zero padding, through F.conv2d on channels-last views (no copy of x
    unless the padding is asymmetric). Differentiable; the port's builtin
    conv and the plain version of K5."""
    (t, b), (l, r) = pads
    xn, wn = x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1)
    if t == b and l == r:
        y = F.conv2d(xn, wn, stride=tuple(strides), padding=(t, l),
                     dilation=tuple(dilation))
    else:
        y = F.conv2d(F.pad(xn, (l, r, t, b)), wn, stride=tuple(strides),
                     dilation=tuple(dilation))
    return y.permute(0, 2, 3, 1).contiguous()


def conv2d_same_grads(x, w, dy, strides, need=(True, True)):
    """(dx, dw) of the SAME conv y = conv(x, w): the two transposed
    convolutions, in one aten.convolution_backward call (cuDNN on the card),
    with no forward recomputed — the JAX package's `_conv_bwd` pair. An
    entry of `need` that is False gives None."""
    H, W = x.shape[1], x.shape[2]
    kh, kw = w.shape[0], w.shape[1]
    _, t, b = same_pads(H, kh, strides[0])
    _, l, r = same_pads(W, kw, strides[1])
    xn, wn = x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1)
    dyn = dy.to(x.dtype).permute(0, 3, 1, 2)
    sym = t == b and l == r
    xp = xn if sym else F.pad(xn, (l, r, t, b))
    pad = [t, l] if sym else [0, 0]
    dx, dw, _ = torch.ops.aten.convolution_backward(
        dyn, xp, wn, None, list(strides), pad, [1, 1], False, [0, 0], 1,
        [bool(need[0]), bool(need[1]), False])
    if dx is not None:
        if not sym:
            dx = dx[:, :, t:t + H, l:l + W]
        dx = dx.permute(0, 2, 3, 1).contiguous()
    if dw is not None:
        dw = dw.permute(2, 3, 1, 0).contiguous()
    return dx, dw


# -- plain versions -------------------------------------------------------------


def _math_dtype(dt):
    """f32 for f32 and bf16 tensors (the kernels' math), f64 for f64."""
    return torch.promote_types(dt, torch.float32)


def _stats_of_stored(y32, dtype, dims):
    """y rounded to `dtype`, and the per-channel sums of it and its
    square, accumulated in f64 and rounded once to the math dtype: the
    exact sums of the stored values, which the kernels' fixed-order f32
    sums are held to. An f32 sum in torch's order changes with the CPU's
    thread count, and the raw-moment variance s2/n - mean^2 amplifies it:
    on a small BN it moved the tiny ResNet's near-zero stem beta past its
    tolerance after three steps, up to 1.8x farther from an f64 run than
    the JAX package's (scripts/tiny_resnet_f64_witness.py)."""
    yb = y32.to(dtype)
    yd = yb.to(torch.float64)
    return yb, yd.sum(dims).to(y32.dtype), (yd * yd).sum(dims).to(y32.dtype)


def conv1x1_stats_reference(x2, w2):
    """Plain version of `conv1x1_stats`: (y2 [M, Cout] in x2's dtype, s1,
    s2 [Cout] in the math dtype)."""
    f = _math_dtype(x2.dtype)
    return _stats_of_stored(x2.to(f) @ w2.to(f), x2.dtype, 0)


def conv_kxk_stats_reference(x, w, strides):
    """Plain version of `conv_kxk_stats`: (y [N, Ho, Wo, Cout] in x's
    dtype, s1, s2 [Cout] in the math dtype)."""
    f = _math_dtype(x.dtype)
    kh, kw = w.shape[0], w.shape[1]
    pads = (same_pads(x.shape[1], kh, strides[0])[1:],
            same_pads(x.shape[2], kw, strides[1])[1:])
    return _stats_of_stored(conv2d_nhwc(x.to(f), w.to(f), strides, pads),
                            x.dtype, (0, 1, 2))


def bn_normalize_reference(x2, mean_b, scale, shift, relu):
    """Plain version of `bn_normalize`: y2 = (x2 - mean_b) * scale + shift
    [then ReLU], math in f32 (f64), y2 in x2's dtype."""
    f = _math_dtype(x2.dtype)
    y = (x2.to(f) - mean_b.to(f)) * scale.to(f) + shift.to(f)
    if relu:
        y = torch.clamp_min(y, 0.0)
    return y.to(x2.dtype)


def bn_backward_prologue(g2, x2, *, mean_b=None, gate_y2=None):
    """The pullback kernels' prologue as tensors: g2 gated by the ReLU's
    saved output (torch.where(gate_y2 > 0, g2, 0)) when `gate_y2` is
    given, and x2 centred (x2 - mean_b, rounded to x2's dtype, as the
    subtraction in that dtype rounds) when `mean_b` is given."""
    if gate_y2 is not None:
        g2 = torch.where(gate_y2 > 0, g2, torch.zeros_like(g2))
    if mean_b is not None:
        f = _math_dtype(x2.dtype)
        x2 = (x2.to(f) - mean_b.to(f)).to(x2.dtype)
    return g2, x2


def bn_backward_reduce_reference(g2, x2, *, mean_b=None, gate_y2=None):
    """Plain version of `bn_backward_reduce`: (sum g, sum g*x) per channel
    in the math dtype, of g and x after `bn_backward_prologue`."""
    g2, x2 = bn_backward_prologue(g2, x2, mean_b=mean_b, gate_y2=gate_y2)
    f = _math_dtype(g2.dtype)
    gf = g2.to(f)
    return gf.sum(0), (gf * x2.to(f)).sum(0)


def bn_backward_apply_reference(g2, x2, c1, c3, c0, *, mean_b=None, gate_y2=None):
    """Plain version of `bn_backward_apply`: dx2 = c1*g2 - c3*x2 + c0 of g
    and x after `bn_backward_prologue`, math in f32 (f64), dx2 in g2's
    dtype."""
    g2, x2 = bn_backward_prologue(g2, x2, mean_b=mean_b, gate_y2=gate_y2)
    f = _math_dtype(g2.dtype)
    dx = c1.to(f) * g2.to(f) - c3.to(f) * x2.to(f) + c0.to(f)
    return dx.to(g2.dtype)


# -- wrappers -------------------------------------------------------------------


def _check(args: Dict[str, torch.Tensor], shapes: Dict[str, tuple]) -> None:
    """One float dtype for the first group of tensors, one device,
    contiguous, and the expected shapes. CUDA takes f32 and bf16; the
    plain versions on the CPU also take f64."""
    first, x = next(iter(args.items()))
    ok = _DTYPE_CODES if x.is_cuda else (*_DTYPE_CODES, torch.float64)
    if x.dtype not in ok:
        raise TypeError(f"{first} is {x.dtype}; the kernels take float32 or "
                        f"bfloat16")
    for n, a in args.items():
        if a.device != x.device:
            raise ValueError(f"{n} is on {a.device}, {first} is on {x.device}")
        if not a.is_contiguous():
            raise ValueError(f"{n} must be contiguous")
        if n in shapes and tuple(a.shape) != tuple(shapes[n]):
            raise ValueError(f"{n} has shape {tuple(a.shape)}, expected "
                             f"{tuple(shapes[n])}")
    if x.is_cuda and x.numel() >= 2 ** 31:
        raise ValueError(f"{first} has {x.numel()} elements; the kernels "
                         f"index with 32-bit ints")


def _same_dtype(dtype, **tensors) -> None:
    for n, a in tensors.items():
        if a.dtype != dtype:
            raise TypeError(f"{n} is {a.dtype}, expected {dtype}")


def _launch(lib_name, fn_name, n_ptr, n_int, dev, ptrs, ints, what):
    lib, fn = cuda_build.entry(lib_name, fn_name, n_ptr, n_int)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        code = fn(ptrs[0], *(None if a is None else a.data_ptr() for a in ptrs[1:]),
                  *ints, stream)
    cuda_build.check(lib, code, what)
    _bump(fn_name)
    return lib


def _vec_ok(C: int, *tensors) -> int:
    """1 when the streaming kernels' 16-byte units apply: C a multiple of
    the channels in 16 bytes (8 bf16, 4 f32) and every given tensor
    16-byte aligned (None: not given)."""
    tensors = [t for t in tensors if t is not None]
    per_unit = 16 // tensors[0].element_size()
    return int(C % per_unit == 0 and all(t.data_ptr() % 16 == 0 for t in tensors))


# The conv kernels' engines (csrc/conv_bn.cuh). Every tile has TILE_M rows
# (the partial-sum scratch holds one row per tile); the tensor-core engine
# keeps at most MAX_STAGES[bn] 64-deep bf16 slices of A [TILE_M, 64] and
# B [64, bn] in its ring, sized for two resident blocks per SM.
TILE_M, SLICE_K = 128, 64
_VARIANT_CODES = {"simt": 0, "vector": 1, "gather": 2}
MAX_STAGES = {64: 4, 128: 3}
SMEM_LIMIT = 232448  # bytes of shared memory one block may use on an H100


def conv_variant(kernel, cin: int, cout: int, dtype, *tensors) -> dict:
    """Which engine and tile K4 (kernel (1, 1)) or K5 runs for a conv:

    - "simt": f32, the f32-FMA engine (TF32 tensor cores would break the
      f32 holds against the plain versions), 128 x 64 tiles;
    - "vector": bf16 with Cin % 8 == 0, Cout % 8 == 0 and every given
      tensor 16-byte aligned: tensor-core tiles fed by 16-byte cp.async;
    - "gather": any other bf16 conv (the stem's Cin = 3): the same tiles
      fed by a scalar gather.

    Returns {"producer", "bn" (tile columns: 64 where Cout <= 64, else
    128), "stages" (ring slices: min(MAX_STAGES[bn], ceil(K / 64)); 0 for
    simt), "tile_rows", "smem_bytes" (shared memory per block)}."""
    kh, kw = (int(k) for k in kernel)
    if dtype == torch.float32:
        smem = (16 * (TILE_M + 4) + 16 * 64) * 4 + (0 if (kh, kw) == (1, 1) else TILE_M * 16)
        return {"producer": "simt", "bn": 64, "stages": 0, "tile_rows": TILE_M,
                "smem_bytes": smem}
    if dtype != torch.bfloat16:
        raise TypeError(f"no conv kernel for {dtype}")
    bn = 64 if cout <= 64 else 128
    vec = (cin % 8 == 0 and cout % 8 == 0
           and all(t.data_ptr() % 16 == 0 for t in tensors))
    stages = min(MAX_STAGES[bn], -(-(kh * kw * cin) // SLICE_K))
    # the ring (+1 KB to align it) and the epilogue's per-warp column sums
    smem = stages * (TILE_M + bn) * SLICE_K * 2 + 1024 + 2 * 8 * bn * 4
    return {"producer": "vector" if vec else "gather", "bn": bn, "stages": stages,
            "tile_rows": TILE_M, "smem_bytes": smem}


def _variant_ints(v: dict) -> list:
    return [_VARIANT_CODES[v["producer"]], v["bn"], v["stages"], v["tile_rows"]]


def conv1x1_stats(x2, w2):
    """K4. x2 [M, Cin], w2 [Cin, Cout] in one dtype -> (y2 [M, Cout] in that
    dtype, s1, s2 [Cout] f32): the product and the per-channel sums of y2
    and y2^2 as stored."""
    if x2.dim() != 2 or w2.dim() != 2:
        raise ValueError(f"x2 {tuple(x2.shape)} and w2 {tuple(w2.shape)} must "
                         f"be [M, Cin] and [Cin, Cout]")
    M, K = x2.shape
    N = w2.shape[1]
    _check({"x2": x2, "w2": w2}, {"w2": (K, N)})
    _same_dtype(x2.dtype, w2=w2)
    if not x2.is_cuda:
        return conv1x1_stats_reference(x2, w2)
    cuda_build.require_hopper(x2.device)
    dev, f32 = x2.device, torch.float32
    v = conv_variant((1, 1), K, N, x2.dtype, x2, w2)
    y = torch.empty((M, N), dtype=x2.dtype, device=dev)
    s1, s2 = torch.empty(N, dtype=f32, device=dev), torch.empty(N, dtype=f32, device=dev)
    part = torch.empty((2, -(-M // v["tile_rows"]), N), dtype=f32, device=dev)
    _launch("conv1x1_stats", "conv1x1_stats", 6, 7, dev,
            [_DTYPE_CODES[x2.dtype], x2, w2, y, s1, s2, part], [M, K, N, *_variant_ints(v)],
            "conv1x1_stats launch")
    return y, s1, s2


def conv_kxk_stats(x, w, strides):
    """K5. x [N, H, W, Cin], w [kh, kw, Cin, Cout] in one dtype, SAME
    padding with XLA's high-side extra pixel -> (y [N, Ho, Wo, Cout], s1,
    s2 [Cout] f32)."""
    if x.dim() != 4 or w.dim() != 4:
        raise ValueError(f"x {tuple(x.shape)} and w {tuple(w.shape)} must be "
                         f"NHWC and HWIO")
    Nimg, H, W, Cin = x.shape
    kh, kw, _, Cout = w.shape
    sh, sw = (int(s) for s in strides)
    _check({"x": x, "w": w}, {"w": (kh, kw, Cin, Cout)})
    _same_dtype(x.dtype, w=w)
    if not x.is_cuda:
        return conv_kxk_stats_reference(x, w, (sh, sw))
    cuda_build.require_hopper(x.device)
    Ho, ph, _ = same_pads(H, kh, sh)
    Wo, pw, _ = same_pads(W, kw, sw)
    dev, f32 = x.device, torch.float32
    v = conv_variant((kh, kw), Cin, Cout, x.dtype, x, w)
    y = torch.empty((Nimg, Ho, Wo, Cout), dtype=x.dtype, device=dev)
    s1, s2 = torch.empty(Cout, dtype=f32, device=dev), torch.empty(Cout, dtype=f32, device=dev)
    part = torch.empty((2, -(-(Nimg * Ho * Wo) // v["tile_rows"]), Cout), dtype=f32,
                       device=dev)
    _launch("conv_kxk_stats", "conv_kxk_stats", 6, 17, dev,
            [_DTYPE_CODES[x.dtype], x, w, y, s1, s2, part],
            [Nimg, H, W, Cin, kh, kw, Cout, Ho, Wo, sh, sw, ph, pw, *_variant_ints(v)],
            "conv_kxk_stats launch")
    return y, s1, s2


def _per_channel_check(x2, **vecs):
    C = x2.shape[-1]
    acc = _math_dtype(x2.dtype)
    for n, v in vecs.items():
        if tuple(v.shape) != (C,) or v.dtype != acc:
            raise ValueError(f"{n} must be [{C}] {acc}, got {tuple(v.shape)} "
                             f"{v.dtype}")


def bn_normalize(x2, mean_b, scale, shift, relu: bool):
    """K6. x2 [M, C]; mean_b, scale, shift [C] f32 (f64 for f64 x2) ->
    y2 = (x2 - mean_b) * scale + shift, ReLU'd when `relu`, in x2's
    dtype."""
    if x2.dim() != 2:
        raise ValueError(f"x2 must be [M, C], got {tuple(x2.shape)}")
    _check({"x2": x2, "mean_b": mean_b, "scale": scale, "shift": shift}, {})
    _per_channel_check(x2, mean_b=mean_b, scale=scale, shift=shift)
    if not x2.is_cuda:
        return bn_normalize_reference(x2, mean_b, scale, shift, relu)
    cuda_build.require_hopper(x2.device)
    y = torch.empty_like(x2)
    M, C = x2.shape
    if y.numel() == 0:
        return y
    _launch("bn_apply", "bn_apply", 5, 4, x2.device,
            [_DTYPE_CODES[x2.dtype], x2, mean_b, scale, shift, y],
            [M, C, int(bool(relu)), _vec_ok(C, x2, y)],
            "bn_apply launch")
    return y


def _reduce_chunks(M: int) -> int:
    """Row chunks of K7's first pass: a function of M alone, so the sums
    are the same bits whatever card runs them."""
    return max(1, min(1024, -(-M // 64)))


def _check_prologue(g2, x2, mean_b, gate_y2, **vecs):
    """The pullback kernels' inputs: g2 [M, C], x2 and gate_y2 (if given)
    of the same shape and dtype, and mean_b (if given) and the other
    per-channel vectors [C] in the math dtype."""
    if g2.dim() != 2:
        raise ValueError(f"g2 must be [M, C], got {tuple(g2.shape)}")
    M, C = g2.shape
    gate = {} if gate_y2 is None else {"gate_y2": gate_y2}
    centre = {} if mean_b is None else {"mean_b": mean_b}
    _check({"g2": g2, "x2": x2, **gate, **centre, **vecs}, {"x2": (M, C), "gate_y2": (M, C)})
    _same_dtype(g2.dtype, x2=x2, **gate)
    _per_channel_check(g2, **vecs, **centre)
    return M, C


def bn_backward_reduce(g2, x2, *, mean_b=None, gate_y2=None):
    """K7. g2, x2 [M, C] in one dtype -> (sum_g, sum_gx) [C] f32, with the
    prologue of `bn_backward_prologue` on the loads: the ReLU gate when
    `gate_y2` [M, C] (the saved BN output) is given, the centring x2 -
    mean_b when `mean_b` [C] (math dtype) is given."""
    M, C = _check_prologue(g2, x2, mean_b, gate_y2)
    if not g2.is_cuda:
        return bn_backward_reduce_reference(g2, x2, mean_b=mean_b, gate_y2=gate_y2)
    cuda_build.require_hopper(g2.device)
    dev, f32 = g2.device, torch.float32
    chunks = _reduce_chunks(M)
    sg, sgx = torch.empty(C, dtype=f32, device=dev), torch.empty(C, dtype=f32, device=dev)
    part = torch.empty((2, chunks, C), dtype=f32, device=dev)
    _launch("bn_backward", "bn_backward_reduce", 7, 3, dev,
            [_DTYPE_CODES[g2.dtype], g2, x2, mean_b, gate_y2, sg, sgx, part],
            [M, C, chunks], "bn_backward_reduce launch")
    return sg, sgx


def bn_backward_apply(g2, x2, c1, c3, c0, *, mean_b=None, gate_y2=None):
    """K8. g2, x2 [M, C] in one dtype; c1, c3, c0 [C] f32 (f64 for f64) ->
    dx2 = c1*g2 - c3*x2 + c0 in g2's dtype, with the prologue of
    `bn_backward_prologue` on the loads (see `bn_backward_reduce`)."""
    M, C = _check_prologue(g2, x2, mean_b, gate_y2, c1=c1, c3=c3, c0=c0)
    if not g2.is_cuda:
        return bn_backward_apply_reference(g2, x2, c1, c3, c0, mean_b=mean_b,
                                           gate_y2=gate_y2)
    cuda_build.require_hopper(g2.device)
    dx = torch.empty_like(g2)
    if dx.numel() == 0:
        return dx
    _launch("bn_backward", "bn_backward_apply", 8, 3, g2.device,
            [_DTYPE_CODES[g2.dtype], g2, x2, mean_b, gate_y2, c1, c3, c0, dx],
            [M, C, _vec_ok(C, g2, x2, gate_y2, dx)], "bn_backward_apply launch")
    return dx


# -- conv + stats (autograd Function) -------------------------------------------


def _conv_fwd_impl(x, w, strides):
    kh, kw, cin, cout = w.shape
    if (kh, kw) == (1, 1):
        sh, sw = strides
        if (sh, sw) != (1, 1):
            # SAME 1x1/s: output pixel (i, j) reads x[i*s, j*s] exactly
            x = x[:, ::sh, ::sw, :].contiguous()
        n, h, wd, _ = x.shape
        y2, s1, s2 = conv1x1_stats(x.reshape(n * h * wd, cin), w.reshape(cin, cout))
        return y2.reshape(n, h, wd, cout), s1, s2
    return conv_kxk_stats(x, w, strides)


class Conv2dBNStats(torch.autograd.Function):
    """(y, s1, s2) = Conv2dBNStats.apply(x, w, strides): the forward on K4
    or K5, the backward the two transposed convolutions. s1 and s2 carry
    no gradient: the BN backward's dx is the total derivative, the paths
    through the statistics included."""

    @staticmethod
    def forward(ctx, x, w, strides):
        y, s1, s2 = _conv_fwd_impl(x, w, strides)
        ctx.save_for_backward(x, w)
        ctx.strides = strides
        ctx.mark_non_differentiable(s1, s2)
        return y, s1, s2

    @staticmethod
    def backward(ctx, dy, _ds1, _ds2):
        x, w = ctx.saved_tensors
        dx, dw = conv2d_same_grads(x, w, dy, ctx.strides,
                                   ctx.needs_input_grad[:2])
        return dx, dw, None


def conv2d_bn_stats(x, w, strides):
    """NHWC x HWIO SAME bias-free conv returning (y, sum, sum_sq), the
    per-channel f32 statistics of y as stored computed by the conv kernel's
    epilogue. (kh, kw)/(sh, sw) in {1x1/1, 1x1/2, 3x3/1, 3x3/2, 7x7/2}."""
    return Conv2dBNStats.apply(x, w, tuple(int(s) for s in strides))


# -- BN apply from the statistics (autograd Function) ---------------------------


def _global_count(n: int, dp) -> int:
    """Elements per channel of the global batch: every rank of a
    data-parallel step holds the same number of rows (the pad-and-mask
    rule of parallel/sharded.py), so R times this rank's."""
    return n if dp is None else n * data_shards(dp)


def _bn_fwd(x, s1, s2, gamma, beta, eps, n, relu, dp=None):
    """K6 from K4/K5's sums; with `dp` (a mesh) the sums are first summed
    over the data axis as ONE [2, C] buffer (the global batch's
    statistics)."""
    acc = _math_dtype(x.dtype)
    c = x.shape[-1]
    if dp is not None:
        s12 = all_reduce_(torch.stack([s1.to(acc), s2.to(acc)]), dp, DATA_AXIS,
                          site="bn_stats")
        s1, s2 = s12[0], s12[1]
    n_all = _global_count(n, dp)
    mean = s1.to(acc) / n_all
    var = torch.clamp_min(s2.to(acc) / n_all - mean * mean, 0.0)
    inv = torch.rsqrt(var + eps)
    scale = gamma.to(acc) * inv
    # centered application: y = (x - bf16(mean)) * scale + (beta - delta *
    # scale), delta = the mean's rounding error
    mean_b = mean.to(x.dtype).to(acc)
    shift = beta.to(acc) - (mean - mean_b) * scale
    y2 = bn_normalize(x.reshape(n, c), mean_b, scale, shift, relu)
    return y2.reshape(x.shape), mean, var, inv


class BNApply(torch.autograd.Function):
    """(y, mean, var) = BNApply.apply(x, s1, s2, gamma, beta, eps, n, relu):
    training-mode BN from the conv's raw moments, forward on K6, backward
    (K7 + K8, with the ReLU gate on their loads) through
    `bn_backward_pieces`. mean and var
    feed the running averages only and carry no gradient; s1 and s2 get a
    zero cotangent, since dx is the total derivative. Inside a
    data-parallel step the sums between K4/K5 and K6, and between K7 and
    K8, are summed over the data axis."""

    @staticmethod
    def forward(ctx, x, s1, s2, gamma, beta, eps, n, relu):
        dp = ctx.dp = active_data_mesh()
        y, mean, var, inv = _bn_fwd(x, s1, s2, gamma, beta, eps, n, relu, dp)
        ctx.save_for_backward(x, gamma, mean, inv, y)
        ctx.n, ctx.relu = n, relu
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, g, _dmean, _dvar):
        x, gamma, mean, inv, y = ctx.saved_tensors
        dx, dgamma, dbeta = bn_backward_pieces(g.to(x.dtype), x, mean, inv, gamma, ctx.n,
                                               gate_y=y if ctx.relu else None,
                                               **({} if ctx.dp is None else {"dp": ctx.dp}))
        return (dx, None, None, dgamma.to(gamma.dtype), dbeta.to(gamma.dtype),
                None, None, None)


def bn_apply(x, s1, s2, gamma, beta, eps, n, relu):
    """Training-mode batch norm from precomputed raw moments: (y, mean,
    var), y ReLU'd when `relu`. n = elements per channel (x.numel() / C)."""
    return BNApply.apply(x, s1, s2, gamma, beta, float(eps), int(n), bool(relu))


# -- the BN pullback ------------------------------------------------------------


def bn_backward_fused(g, x_for_dx, center, gamma, inv, n, *, mean_b=None, gate_y=None,
                      dp=None):
    """The fused-BN pullback in two kernels (K7 reduce, K8 apply).

    g: cotangent in the activation dtype; x_for_dx: the tensor dx is
    affine in — x - bf16(mean) for bf16, raw x for f32; center: the
    per-channel recentering constant in the math dtype — delta (the mean's
    rounding error) for bf16, the mean for f32 — so sum_gx = sum(g *
    x_for_dx) - center * sum(g); gamma, inv: scale and rsqrt(var + eps);
    n: elements per channel. The kernels form two inputs on their loads:
    with `gate_y` (the saved BN output, g's shape) g is ReLU-gated,
    where(gate_y > 0, g, 0); with `mean_b` ([C], the batch mean rounded to
    x's dtype) the second argument is raw x and x_for_dx = x - mean_b,
    rounded to x's dtype. Neither tensor is materialised.

    With `dp` (a mesh), K7's two sums are summed over the data axis as one
    [2, C] buffer before K8, and n counts the global batch.

    Returns (dx, dgamma, dbeta): dx in g's dtype, dgamma and dbeta in the
    math dtype. The coefficient algebra is the JAX package's exactly."""
    c = g.shape[-1]
    acc = _math_dtype(g.dtype)
    g2 = g.contiguous().reshape(n, c)
    x2 = x_for_dx.contiguous().reshape(n, c)
    pro = {"mean_b": None if mean_b is None else mean_b.to(acc).contiguous(),
           "gate_y2": None if gate_y is None else gate_y.contiguous().reshape(n, c)}
    sum_g, sgx_raw = bn_backward_reduce(g2, x2, **pro)
    center = center.to(acc)
    # dgamma and dbeta are this rank's shares (the step's gradient
    # reduction sums them); dx needs the global sums
    dgamma, dbeta = inv * (sgx_raw - center * sum_g), sum_g
    if dp is not None:
        sums = all_reduce_(torch.stack([sum_g, sgx_raw]), dp, DATA_AXIS, site="bn_stats")
        sum_g, sgx_raw = sums[0], sums[1]
    n_all = _global_count(n, dp)
    sum_gx = sgx_raw - center * sum_g
    gamma_f = gamma.to(acc)
    c1 = gamma_f * inv
    c3 = gamma_f * inv * inv * inv * sum_gx / n_all
    c0 = -(c1 * sum_g / n_all) + c3 * center
    dx2 = bn_backward_apply(g2, x2, c1, c3, c0, **pro)
    return dx2.reshape(g.shape), dgamma, dbeta


def bn_backward_pieces(g, x, mean, inv, gamma, n, *, gate_y=None, dp=None):
    """The BN pullback from the saved x, shared by `BNApply` and
    nn/layers/norm.py's builtin BN: g ReLU-gated by the saved output
    `gate_y` when given, the dtype's recentering (bf16: x - bf16(mean) and
    center = the mean's rounding error; f32: raw x and center = mean), then
    the fused pullback if the "bn_backward" helper engages — which forms
    the gated g and the centred x on its loads from raw x, `mean_b` and
    `gate_y` — else the builtin reductions on both materialised in plain
    torch. With `dp` (a mesh) the two per-channel sums are the global
    batch's. Returns (dx, dgamma, dbeta) in (x.dtype, math dtype, math
    dtype)."""
    from deeplearning4j_tpu_torch.ops.helpers import HelperError, get_helper

    c = x.shape[-1]
    acc = _math_dtype(x.dtype)
    mean_b = mean.to(x.dtype) if x.dtype == torch.bfloat16 else None
    # delta (the mean's rounding error) for bf16, the mean for f32
    center = mean if mean_b is None else mean - mean_b.to(acc)
    helper = get_helper("bn_backward", x_shape=tuple(x.shape), dtype=x.dtype,
                        training=True, device=x.device)
    if helper is not None:
        try:
            return helper(g, x, center, gamma, inv, n, mean_b=mean_b, gate_y=gate_y,
                          **({} if dp is None else {"dp": dp}))
        except HelperError:
            pass  # the helper disabled itself; builtin path below
    if gate_y is not None:
        g = torch.where(gate_y > 0, g, torch.zeros_like(g))
    x_for_dx = x if mean_b is None else x - mean_b
    if x.dtype == torch.bfloat16:
        # bf16 products, f32 sums: the JAX package's ones-vector dots
        g2, x2 = g.reshape(n, c), x_for_dx.reshape(n, c)
        sum_g = g2.to(acc).sum(0)
        sum_gx = (g2 * x2).to(acc).sum(0) - center * sum_g
    else:
        g2, x2 = g.to(acc).reshape(n, c), x_for_dx.to(acc).reshape(n, c)
        sum_g = g2.sum(0)
        sum_gx = (g2 * x2).sum(0) - center * sum_g
    # dgamma and dbeta are this rank's shares (the step's gradient
    # reduction sums them); dx needs the global sums
    dgamma, dbeta = inv * sum_gx, sum_g
    if dp is not None:
        sums = all_reduce_(torch.stack([sum_g, sum_gx]), dp, DATA_AXIS, site="bn_stats")
        sum_g, sum_gx = sums[0], sums[1]
    n = _global_count(n, dp)
    gamma_f = gamma.to(acc)
    c1 = gamma_f * inv
    c3 = gamma_f * inv * inv * inv * sum_gx / n
    c0 = -(c1 * sum_g / n) + c3 * center
    dx = (c1.to(x.dtype) * g - c3.to(x.dtype) * x_for_dx + c0.to(x.dtype))
    return dx, dgamma, dbeta


# -- the helper SPI ---------------------------------------------------------------

# the structural whitelist: every ResNet-50 conv is one of these
_KERNEL_STRIDES = {
    ((1, 1), (1, 1)): "conv1x1",
    ((1, 1), (2, 2)): "conv1x1s2",
    ((3, 3), (1, 1)): "conv3x3",
    ((3, 3), (2, 2)): "conv3x3s2",
    ((7, 7), (2, 2)): "conv7x7s2",
}


def conv_family(*, kernel=None, stride=None, **_):
    """Bounded kernel-family slug for the helper metrics labels: one of
    the five covered kernel/stride shapes, else "conv_other"."""
    if kernel is None or stride is None:
        return "conv_other"
    return _KERNEL_STRIDES.get((tuple(kernel), tuple(stride)), "conv_other")


def conv_decision(*, kernel, stride, dilation, same, has_bias, activation,
                  dtype, training, x_shape, n_out, planning=False, **_):
    """Routing decision for the "conv2d" slot, in the JAX package's two
    stages (its `conv_decision`):

    1. structural: the kernel must exist for the call — training,
       bias-free, SAME, identity activation, no dilation, kernel/stride
       in the five families, f32 or bf16. Failures are "unsupported".
       Any channel count and image size is taken (the stem's Cin = 3
       included): the JAX package's VMEM budget and 128-lane channel
       alignment are TPU facts with no counterpart here.
    2. economic, with `planning=True` (the coverage table,
       analysis/kernelcoverage): the per-instance roofline verdict of
       `conv_instance_cost` at the call's dtype itemsize on the H100 SXM
       figures. The stats epilogue saves one read of the conv output,
       worth nothing on a compute-bound instance, so the JAX package
       declines it ("compute_bound") and a memory-bound one is covered.

    What this process routes by (`planning=False`) is the structural
    stage: a compute-bound instance is covered too. In the port a decline
    is not free, as it is under XLA: the declined conv's BN takes the
    builtin forward (a mean pass, a centred-sums pass and the apply, two
    more reads of y than K6, and a third all-reduce under a mesh). On the
    H100 that cost ResNet-50 at b128 bf16 4.3-4.6 ms a graphed step more
    than covering all 53 convs (PERF.md, PR 16).

    Returns {"status": "covered"|"declined"|"unsupported", "reason",
    "family", "roofline"}."""
    fam = conv_family(kernel=kernel, stride=stride)

    def uns(reason):
        return {"status": "unsupported", "reason": reason, "family": fam,
                "roofline": None}

    if not training:
        return uns("inference")
    if has_bias:
        return uns("bias")
    if not same:
        return uns("padding")
    if activation not in (None, "identity"):
        return uns("fused_activation")
    if tuple(dilation) != (1, 1):
        return uns("dilation")
    k, s = tuple(kernel), tuple(stride)
    if (k, s) not in _KERNEL_STRIDES:
        return uns("kernel_shape")
    if dtype not in _DTYPE_CODES:
        return uns("dtype")
    if not planning:
        return {"status": "covered", "reason": "structural", "family": fam,
                "roofline": None}
    from deeplearning4j_tpu_torch.analysis.costmodel import (
        conv_instance_cost,
        instance_roofline,
    )
    from deeplearning4j_tpu_torch.utils import flops as _flops

    cost = conv_instance_cost(kernel=k, stride=s, x_shape=x_shape,
                              n_out=int(n_out), itemsize=dtype.itemsize)
    rf = instance_roofline(cost["flops"], cost["bytes"],
                           _flops.H100_BF16_DENSE_FLOP_PER_S,
                           _flops.H100_HBM_BYTES_PER_S)
    if rf["verdict"] == "compute-bound":
        return {"status": "declined", "reason": "compute_bound",
                "family": fam, "roofline": rf}
    return {"status": "covered", "reason": "memory_bound", "family": fam,
            "roofline": rf}


def conv_supported(*, device=None, **ctx):
    """Probe for the "conv2d" slot: structurally covered, on a CUDA device
    of compute capability >= 9.0. A structural decline is counted as
    `conv_declined_total{reason}` (the conv_decision reason: "bias",
    "padding", "inference", ...), on any device."""
    d = conv_decision(**ctx)
    if d["status"] != "covered":
        from deeplearning4j_tpu_torch.ops.helpers import _count

        _count("conv_declined_total", "conv2d", "cuda_conv_bn_stats",
               d["family"], d["reason"])
        return False
    return cuda_build.on_hopper(device)


# The BN probes consult no roofline: a BN pass is a streaming map of about
# 4 FLOP an element over at least two passes of its bytes, an intensity
# near 1 FLOP/B against the H100's ridge near 295, so it is memory-bound
# at every shape (the JAX package's consult can only say so).

def bn_supported(*, x, training, **_):
    """Probe for the "batch_norm" slot: training, a 4-D f32/bf16 input on a
    Hopper GPU that IS a stashed conv output (identity match) — otherwise
    the builtin BN, which needs its own statistics pass anyway."""
    if not training or not torch.is_tensor(x) or x.dim() != 4:
        return False
    if x.dtype not in _DTYPE_CODES or not cuda_build.on_hopper(x.device):
        return False
    return peek_stats(x)


def bn_bwd_supported(*, x_shape, dtype, training, device=None, **_):
    """Probe for the "bn_backward" slot (K7 + K8): training, f32/bf16, on a
    Hopper GPU."""
    if not training or len(x_shape) < 2 or dtype not in _DTYPE_CODES:
        return False
    return cuda_build.on_hopper(device)


def _conv2d_helper(x, w, *, strides):
    y, s1, s2 = conv2d_bn_stats(x, w, strides)
    _stash_stats(y, s1, s2)
    return y


def _bn_helper(x, gamma, beta, eps, relu=False):
    """BN apply from the stashed conv statistics; with `relu` (the graph
    found a relu ActivationLayer as this BN's only consumer) the ReLU
    variant of K6."""
    st = take_stats(x)
    if st is None:  # the probe checked peek_stats
        raise RuntimeError("bn helper called without stashed conv stats")
    n = x.numel() // x.shape[-1]
    return bn_apply(x, st[0], st[1], gamma, beta, eps, n, relu)


def register():
    from deeplearning4j_tpu_torch.ops.helpers import register_helper

    register_helper("conv2d", _conv2d_helper, conv_supported,
                    name="cuda_conv_bn_stats", family=conv_family)
    register_helper("batch_norm", _bn_helper, bn_supported,
                    name="cuda_fused_bn_apply", family=lambda **_: "bn_apply")
    register_helper("bn_backward", bn_backward_fused, bn_bwd_supported,
                    name="cuda_fused_bn_bwd", family=lambda **_: "bn_bwd")


register()

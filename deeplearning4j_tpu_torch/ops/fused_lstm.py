"""Fused peephole-LSTM kernels for Hopper, behind the helper SPI.

The port of the JAX package's ops/pallas_lstm.py kernels:

- `lstm_step` — one inference-only decode step (csrc/lstm_step.cu),
  replacing `lstm_step` -> `_step_kernel`. The decode serving engine and
  every T==1 stateful `rnn_time_step` go through it.
- `lstm_sequence_forward` — the whole-sequence forward
  (csrc/lstm_sequence.cu), replacing `_fwd_call` -> `_fwd_kernel`.
- `lstm_sequence_backward` — its reverse-time pullback
  (csrc/lstm_sequence_bwd.cu), replacing `_bwd_call` -> `_bwd_kernel`.
- `LSTMSequence` — the autograd Function over the two, the counterpart of
  the JAX package's `custom_vjp`. `lstm_sequence`, the helper-SPI entry,
  goes through it: every training step of `fit` runs both kernels;
  `output()` and multi-token `rnn_time_step` record no graph and run the
  forward kernel alone.

Each sequence kernel has two variants, both hand-written and chosen by
`lstm_variant` before a launch: "cluster" (H <= 256: the batch cut across
thread-block clusters of 8 CTAs that exchange through distributed shared
memory; csrc/lstm_cluster.cuh) and "grid" (larger H: one cooperative grid
that exchanges through global memory and a grid barrier).

Beside each kernel is its plain PyTorch version (`*_reference`), the same
function as step-by-step torch ops in f32. The wrappers take the plain
version only for tensors on the CPU; on a CUDA tensor they launch the
kernel or raise — nothing falls back. Each launch adds one to the
wrapper's count in `launch_counts()`.

Gate blocks are [i|f|g|o] as in nn/layers/recurrent.py. Tensors are f32
or bf16; math and the h/c carries are f32, as on the TPU. The plain
versions also take f64 (math in f64), for gradient checks.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from deeplearning4j_tpu_torch.ops import cuda_build
from deeplearning4j_tpu_torch.ops.launches import LaunchCounter

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_counter = LaunchCounter(("lstm_step", "lstm_sequence", "lstm_sequence_backward"))
launch_counts = _counter.launch_counts
reset_launch_counts = _counter.reset_launch_counts
recording_launches = _counter.recording_launches
add_launches = _counter.add_launches
_bump = _counter.bump


# -- plain versions -----------------------------------------------------------


def _cell(pre, c, pI, pF, pO, H):
    i = torch.sigmoid(pre[:, :H] + c * pI)
    f = torch.sigmoid(pre[:, H:2 * H] + c * pF)
    g = torch.tanh(pre[:, 2 * H:3 * H])
    c_new = f * c + i * g
    o = torch.sigmoid(pre[:, 3 * H:] + c_new * pO)
    return i, f, g, o, c_new, o * torch.tanh(c_new)


def _math_dtype(dt):
    """f32 for f32 and bf16 tensors (the kernels' math), f64 for f64."""
    return torch.promote_types(dt, torch.float32)


def lstm_step_reference(xg, rw, pI, pF, pO, h0, c0):
    """Plain version of `lstm_step`: (h1, c1) in xg's dtype."""
    f32 = _math_dtype(xg.dtype)
    H = h0.shape[-1]
    h, c = h0.to(f32), c0.to(f32)
    pre = xg.to(f32) + h @ rw.to(f32)
    *_, c_new, h_new = _cell(pre, c, pI.to(f32), pF.to(f32), pO.to(f32), H)
    return h_new.to(xg.dtype), c_new.to(xg.dtype)


def lstm_sequence_forward_reference(xg, rw, pI, pF, pO, h0, c0):
    """Plain version of `lstm_sequence_forward`: (y, acts, hprev, cprev,
    cF) in xg's dtype, with h/c carried in f32 across time."""
    f32, dt = _math_dtype(xg.dtype), xg.dtype
    H = h0.shape[-1]
    rw32, p = rw.to(f32), (pI.to(f32), pF.to(f32), pO.to(f32))
    h, c = h0.to(f32), c0.to(f32)
    ys, acts, hprev, cprev = [], [], [], []
    for t in range(xg.shape[0]):
        hprev.append(h.to(dt))
        cprev.append(c.to(dt))
        i, f, g, o, c, h = _cell(xg[t].to(f32) + h @ rw32, c, *p, H)
        acts.append(torch.cat([i, f, g, o], dim=-1).to(dt))
        ys.append(h.to(dt))
    return (torch.stack(ys), torch.stack(acts), torch.stack(hprev),
            torch.stack(cprev), c.to(dt))


def lstm_sequence_backward_reference(acts, hprev, cprev, rw, pI, pF, pO, dy,
                                     dcF):
    """Plain version of `lstm_sequence_backward`, line by line the TPU
    kernel's reverse walk: c_t recomputed from the stashes, dRW and the
    peephole sums accumulated in f32 from the f32 dpre. Returns (dxg,
    drw, dpi, dpf, dpo, dh0, dc0): dxg, dh0, dc0 in acts' dtype, the rest
    in f32."""
    f32, dt = _math_dtype(acts.dtype), acts.dtype
    T, B, H4 = acts.shape
    H = H4 // 4
    rw32 = rw.to(f32)
    pi, pf, po = pI.to(f32), pF.to(f32), pO.to(f32)
    dh = torch.zeros((B, H), dtype=f32, device=acts.device)
    dc_carry = dcF.to(f32)
    drw = torch.zeros((H, H4), dtype=f32, device=acts.device)
    dp = torch.zeros((3, H), dtype=f32, device=acts.device)
    dxg = [None] * T
    for t in range(T - 1, -1, -1):
        a = acts[t].to(f32)
        i, f, g, o = a[:, :H], a[:, H:2 * H], a[:, 2 * H:3 * H], a[:, 3 * H:]
        hp, cp = hprev[t].to(f32), cprev[t].to(f32)
        dh = dh + dy[t].to(f32)
        c_t = f * cp + i * g
        tc = torch.tanh(c_t)
        dpre_o = dh * tc * o * (1.0 - o)
        dc = dh * o * (1.0 - tc * tc) + dc_carry + dpre_o * po
        dpre_i = dc * g * i * (1.0 - i)
        dpre_f = dc * cp * f * (1.0 - f)
        dpre_g = dc * i * (1.0 - g * g)
        dpre = torch.cat([dpre_i, dpre_f, dpre_g, dpre_o], dim=-1)
        dxg[t] = dpre.to(dt)
        drw += hp.t() @ dpre
        dp[0] += (dpre_i * cp).sum(0)
        dp[1] += (dpre_f * cp).sum(0)
        dp[2] += (dpre_o * c_t).sum(0)
        dh = dpre @ rw32.t()
        dc_carry = dc * f + dpre_i * pi + dpre_f * pf
    return (torch.stack(dxg), drw, dp[0], dp[1], dp[2], dh.to(dt),
            dc_carry.to(dt))


# -- wrappers -----------------------------------------------------------------


def _check_args(args: Dict[str, torch.Tensor]) -> None:
    """One dtype (f32 or bf16), one device, contiguous."""
    first, x = next(iter(args.items()))
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"fused LSTM takes float32 or bfloat16, got {x.dtype}")
    for n, a in args.items():
        if a.dtype != x.dtype:
            raise TypeError(f"{n} is {a.dtype}, {first} is {x.dtype}")
        if a.device != x.device:
            raise ValueError(f"{n} is on {a.device}, {first} is on {x.device}")
        if not a.is_contiguous():
            raise ValueError(f"{n} must be contiguous")


def _check(xg, rw, pI, pF, pO, h0, c0, *, seq: bool) -> Tuple[int, int, int]:
    """Validate device, dtype, shape and contiguity; returns (T, B, H)."""
    args = {"xg": xg, "rw": rw, "pI": pI, "pF": pF, "pO": pO, "h0": h0, "c0": c0}
    _check_args(args)
    if xg.dim() != (3 if seq else 2):
        raise ValueError(f"xg must be {'[T, B, 4H]' if seq else '[B, 4H]'}, "
                         f"got {tuple(xg.shape)}")
    T = xg.shape[0] if seq else 1
    B, H = h0.shape if h0.dim() == 2 else (-1, -1)
    want = {"xg": ((T, B, 4 * H) if seq else (B, 4 * H)), "rw": (H, 4 * H),
            "pI": (H,), "pF": (H,), "pO": (H,), "h0": (B, H), "c0": (B, H)}
    for n, shape in want.items():
        if tuple(args[n].shape) != shape or H < 1 or B < 1 or T < 1:
            raise ValueError(
                f"{n} has shape {tuple(args[n].shape)}, expected {shape} "
                f"(from h0 {tuple(h0.shape)} and xg {tuple(xg.shape)})")
    return T, B, H


def _check_bwd(acts, hprev, cprev, rw, pI, pF, pO, dy, dcF) -> Tuple[int, int, int]:
    """`_check` for the backward's inputs; returns (T, B, H)."""
    args = {"acts": acts, "hprev": hprev, "cprev": cprev, "rw": rw, "pI": pI,
            "pF": pF, "pO": pO, "dy": dy, "dcF": dcF}
    _check_args(args)
    T, B, H = tuple(hprev.shape) if hprev.dim() == 3 else (-1, -1, -1)
    want = {"acts": (T, B, 4 * H), "hprev": (T, B, H), "cprev": (T, B, H),
            "rw": (H, 4 * H), "pI": (H,), "pF": (H,), "pO": (H,),
            "dy": (T, B, H), "dcF": (B, H)}
    for n, shape in want.items():
        if tuple(args[n].shape) != shape or min(T, B, H) < 1:
            raise ValueError(
                f"{n} has shape {tuple(args[n].shape)}, expected {shape} "
                f"(from hprev {tuple(hprev.shape)})")
    return T, B, H


def lstm_step(xg, rw, pI, pF, pO, h0, c0):
    """One decode timestep, fused. xg: [B, 4H] input projection + bias;
    rw: [H, 4H]; pI/pF/pO: [H] peepholes (zeros for plain LSTM); h0/c0:
    [B, H]. Returns (h1, c1) in xg's dtype. Inference only. The kernel
    starts staging rw before the kernel launched just before it has
    finished (programmatic dependent launch), so rw must not be that
    kernel's output; xg, h0, c0 and the peepholes may be."""
    _, B, H = _check(xg, rw, pI, pF, pO, h0, c0, seq=False)
    if not xg.is_cuda:
        return lstm_step_reference(xg, rw, pI, pF, pO, h0, c0)
    cuda_build.require_hopper(xg.device)
    if step_smem(H, xg.dtype) > SMEM_LIMIT:
        raise ValueError(f"the decode-step kernel needs {step_smem(H, xg.dtype)} bytes "
                         f"of shared memory at H={H} (limit {SMEM_LIMIT})")
    lib, fn = cuda_build.entry("lstm_step", "lstm_step", 9, 2)
    h1, c1 = torch.empty_like(h0), torch.empty_like(c0)
    stream = torch.cuda.current_stream(xg.device).cuda_stream
    with torch.cuda.device(xg.device):
        code = fn(_DTYPE_CODES[xg.dtype], *(a.data_ptr() for a in
                  (xg, rw, pI, pF, pO, h0, c0, h1, c1)), B, H, stream)
    cuda_build.check(lib, code, "lstm_step launch")
    _bump("lstm_step")
    return h1, c1


# -- variants ---------------------------------------------------------------

# the decode-step kernel (csrc/lstm_step.cu): a block owns STEP_UNITS
# hidden units (4 * STEP_UNITS gate columns) of STEP_ROWS batch rows, and
# sums each (row, column) in STEP_SPLIT chunks of k
STEP_UNITS, STEP_SPLIT, STEP_ROWS = 4, 4, 8
STEP_COLS = 4 * STEP_UNITS

# The cluster kernels (csrc/lstm_cluster.cuh): C CTAs a cluster, R batch
# rows a cluster, U = ceil(H / C) hidden units a CTA, at most 32 (one lane
# a unit). R is 4 up to B = 64 (at most 128 CTAs on the H100's 132 SMs,
# each with half the per-step product of R = 8), 8 past it, where clusters
# of 4 rows would outnumber the SMs (PERF.md: R = 4 faster at B <= 64,
# R = 8 at B >= 128).
CLUSTER_CTAS = 8
CLUSTER_ROWS = (4, 8)
CLUSTER_MAX_UNITS = 32
# rows of T*B per partial of the backward's dRW pass
DRW_CHUNK = 256
# the grid kernels: U units a block, BB batch rows a pass, and their
# static shared memory (forward pre_s + peep_s; backward part_s + dpre_s +
# pp_s + peep_s)
GRID_UNITS, GRID_ROWS = 8, 8
_GRID_STATIC = {False: 4 * (8 * 32 + 3 * 8),
                True: 4 * (8 * 32 + 8 * 32 + 8 * 3 * 8 + 3 * 8)}
# shared memory one CTA may use on an H100 (dynamic + static)
SMEM_LIMIT = 227 * 1024
VARIANTS = ("cluster", "grid")


def _cluster_rows(B: int) -> int:
    return CLUSTER_ROWS[0] if B <= 64 else CLUSTER_ROWS[1]


def _cluster_smem(H: int, R: int, backward: bool) -> int:
    C = CLUSTER_CTAS
    U = -(-H // C)
    if backward:  # RW^T slice [4U][H], dpre [4U][R], receive [2][C][R][U]
        return 4 * (4 * U * H + 4 * U * R + 2 * C * R * U)
    return 4 * (4 * U * H + 2 * R * H + 2 * R * 4 * U)  # RW slice, h [2][H][R], pre [2][R][4U]


def _grid_smem(B: int, H: int, backward: bool) -> int:
    U, BB = GRID_UNITS, GRID_ROWS
    if backward:  # RW rows, dRW slice, dpre rows, hprev rows, dc carry
        dyn = U * (4 * H + 1) + H * 4 * U + BB * 4 * H + BB * H + B * U
    else:  # RW slice, h rows, c
        dyn = H * 4 * U + BB * H + B * U
    return 4 * dyn + _GRID_STATIC[backward]


def lstm_variant(B: int, H: int, dtype, *, backward: bool = False,
                 variant: str = None) -> dict:
    """Which sequence kernel runs at batch B, hidden size H:

    - "cluster" where U = ceil(H / 8) <= 32 (H <= 256): ceil(B / R)
      clusters of C = 8 CTAs, R batch rows each (4 up to B = 64, else 8);
      CTA q owns units q*U..q*U+U-1 (the last CTAs own fewer, or none,
      where 8 does not divide H; the last cluster's rows past B are
      masked);
    - "grid" otherwise: one cooperative grid of C = ceil(H / 8) blocks of U
      = 8 units, R = 8 batch rows a pass, while its shared memory fits.

    `variant` asks for one of them. Returns {"variant", "C" (CTAs that
    exchange: a cluster, or the whole grid), "R", "U", "ctas" (CTAs
    launched), "smem_bytes" (shared memory per CTA)}. Raises ValueError
    where the variant asked for, or both, cannot take the shape: no kernel
    runs it, and nothing falls back."""
    if dtype not in _DTYPE_CODES:
        raise TypeError(f"fused LSTM takes float32 or bfloat16, got {dtype}")
    if variant not in (None, *VARIANTS):
        raise ValueError(f"variant must be one of {VARIANTS}, got {variant!r}")
    if B < 1 or H < 1:
        raise ValueError(f"B={B}, H={H}: both must be positive")
    U = -(-H // CLUSTER_CTAS)
    if variant in (None, "cluster") and U <= CLUSTER_MAX_UNITS:
        R = _cluster_rows(B)
        return {"variant": "cluster", "C": CLUSTER_CTAS, "R": R, "U": U,
                "ctas": CLUSTER_CTAS * -(-B // R),
                "smem_bytes": _cluster_smem(H, R, backward)}
    smem = _grid_smem(B, H, backward)
    if variant in (None, "grid") and smem <= SMEM_LIMIT:
        blocks = -(-H // GRID_UNITS)
        return {"variant": "grid", "C": blocks, "R": GRID_ROWS,
                "U": GRID_UNITS, "ctas": blocks, "smem_bytes": smem}
    raise ValueError(
        f"no {'backward' if backward else 'forward'} sequence kernel takes "
        f"B={B}, H={H}" + (f" as {variant!r}" if variant else "") +
        f": the cluster variant needs H <= "
        f"{CLUSTER_CTAS * CLUSTER_MAX_UNITS}, the grid variant {smem} bytes "
        f"of shared memory (limit {SMEM_LIMIT})")


def sequence_scratch(T: int, B: int, H: int, variant: str, *,
                     backward: bool = False) -> Dict[str, Tuple[int, ...]]:
    """The f32 scratch tensors (name -> shape) a sequence kernel's wrapper
    allocates. Cluster forward: none. Cluster backward: the f32 dpre of
    every step, [T, B, 4H]; the dRW pass's partials, one per DRW_CHUNK
    rows of T*B; the peephole sums by batch row, [B, 3, H]. Grid: the
    double-buffered exchange in global memory and the barrier counter
    (int32, zeroed)."""
    if variant == "cluster":
        if not backward:
            return {}
        return {"dpre": (T, B, 4 * H),
                "drw_part": (-(-T * B // DRW_CHUNK), H, 4 * H),
                "dp_part": (B, 3, H)}
    if variant == "grid":
        return {("xbuf" if backward else "hbuf"): (2, B, 4 * H if backward else H),
                "bar": (1,)}
    raise ValueError(f"variant must be one of {VARIANTS}, got {variant!r}")


def _scratch(T, B, H, variant, backward, device):
    return [torch.zeros(s, dtype=torch.int32, device=device) if n == "bar"
            else torch.empty(s, dtype=torch.float32, device=device)
            for n, s in sequence_scratch(T, B, H, variant, backward=backward).items()]


def cluster_occupancy(H: int, R: int, dtype=torch.float32, *,
                      backward: bool = False) -> int:
    """cudaOccupancyMaxActiveClusters for the cluster kernel of R batch
    rows at hidden size H on the current CUDA device: how many of its
    clusters run at once."""
    lib_name, fn_name = (("lstm_sequence_bwd", "lstm_sequence_bwd_cluster_occupancy")
                         if backward else
                         ("lstm_sequence", "lstm_sequence_cluster_occupancy"))
    lib = cuda_build.library(lib_name)
    fn = getattr(lib, fn_name)
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    out = ctypes.c_int(0)
    cuda_build.check(lib, fn(_DTYPE_CODES[dtype], H, R, ctypes.byref(out)),
                     "cluster occupancy query")
    return out.value


def lstm_sequence_forward(xg, rw, pI, pF, pO, h0, c0, *, variant=None):
    """The whole-sequence forward. xg: [T, B, 4H] time-major input
    projections + bias; rw: [H, 4H]; pI/pF/pO: [H]; h0/c0: [B, H].
    Returns (y [T,B,H], acts [T,B,4H], hprev [T,B,H], cprev [T,B,H],
    cF [B,H]) in xg's dtype — the TPU kernel's outputs plus the final
    cell state. `variant` ("cluster" or "grid") overrides
    `lstm_variant`'s choice on a CUDA tensor."""
    T, B, H = _check(xg, rw, pI, pF, pO, h0, c0, seq=True)
    if not xg.is_cuda:
        return lstm_sequence_forward_reference(xg, rw, pI, pF, pO, h0, c0)
    cuda_build.require_hopper(xg.device)
    geo = lstm_variant(B, H, xg.dtype, variant=variant)
    v = geo["variant"]
    y = torch.empty((T, B, H), dtype=xg.dtype, device=xg.device)
    acts = torch.empty_like(xg)
    hprev, cprev = torch.empty_like(y), torch.empty_like(y)
    c_final = torch.empty_like(c0)
    scratch = _scratch(T, B, H, v, False, xg.device)
    ints = [T, B, H]
    if v == "cluster":
        lib, fn = cuda_build.entry("lstm_sequence", "lstm_sequence_forward_cluster", 12, 4)
        ints.append(geo["R"])
    else:
        lib, fn = cuda_build.entry("lstm_sequence", "lstm_sequence_forward", 14, 3)
    stream = torch.cuda.current_stream(xg.device).cuda_stream
    with torch.cuda.device(xg.device):
        code = fn(_DTYPE_CODES[xg.dtype], *(a.data_ptr() for a in
                  (xg, rw, pI, pF, pO, h0, c0, y, acts, hprev, cprev,
                   c_final, *scratch)), *ints, stream)
    cuda_build.check(lib, code, f"lstm_sequence ({v}) launch")
    _bump("lstm_sequence")
    return y, acts, hprev, cprev, c_final


def lstm_sequence_backward(acts, hprev, cprev, rw, pI, pF, pO, dy, dcF, *,
                           variant=None):
    """The whole-sequence backward. acts [T,B,4H], hprev/cprev [T,B,H]:
    the forward's stashes; rw [H,4H]; pI/pF/pO [H]; dy [T,B,H]: the
    cotangent of y (with hF's folded into dy[-1]); dcF [B,H]: the
    cotangent of cF. Returns (dxg [T,B,4H], drw [H,4H], dpi, dpf, dpo
    [H], dh0, dc0 [B,H]): dxg, dh0, dc0 in acts' dtype, the rest in f32,
    as the TPU kernel's outputs. `lstm_variant(B, H, dtype,
    backward=True)` says which kernel takes the shape (the grid variant
    takes H up to ~550 at B=32) and raises where none does; `variant`
    overrides its choice on a CUDA tensor. The cluster variant's call
    runs three launches (the chain, the dRW partials, their sums) and
    counts as one."""
    T, B, H = _check_bwd(acts, hprev, cprev, rw, pI, pF, pO, dy, dcF)
    if not acts.is_cuda:
        return lstm_sequence_backward_reference(acts, hprev, cprev, rw, pI,
                                                pF, pO, dy, dcF)
    cuda_build.require_hopper(acts.device)
    geo = lstm_variant(B, H, acts.dtype, backward=True, variant=variant)
    v = geo["variant"]
    dev, f32 = acts.device, torch.float32
    dxg = torch.empty_like(acts)
    drw = torch.empty((H, 4 * H), dtype=f32, device=dev)
    dpi, dpf, dpo = (torch.empty((H,), dtype=f32, device=dev) for _ in range(3))
    dh0, dc0 = torch.empty_like(dcF), torch.empty_like(dcF)
    scratch = _scratch(T, B, H, v, True, dev)
    ints = [T, B, H]
    if v == "cluster":
        lib, fn = cuda_build.entry("lstm_sequence_bwd", "lstm_sequence_backward_cluster",
                                   19, 5)
        ints += [DRW_CHUNK, geo["R"]]
    else:
        lib, fn = cuda_build.entry("lstm_sequence_bwd", "lstm_sequence_backward", 18, 3)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        code = fn(_DTYPE_CODES[acts.dtype], *(a.data_ptr() for a in
                  (acts, hprev, cprev, rw, pI, pF, pO, dy, dcF, dxg, drw, dpi,
                   dpf, dpo, dh0, dc0, *scratch)), *ints, stream)
    cuda_build.check(lib, code, f"lstm_sequence_backward ({v}) launch")
    _bump("lstm_sequence_backward")
    return dxg, drw, dpi, dpf, dpo, dh0, dc0


class LSTMSequence(torch.autograd.Function):
    """y, cF = LSTMSequence.apply(xg, rw, pI, pF, pO, h0, c0): the forward
    on `lstm_sequence_forward`, the backward on `lstm_sequence_backward`
    (the JAX package's `custom_vjp` of `lstm_sequence`). The caller takes
    hF = y[-1] outside, so autograd folds hF's cotangent into dy[-1] and
    the Function never returns a view. An output the loss does not use
    (cF, when TBPTT carries it detached) reaches `backward` as zeros:
    autograd materializes unused gradients by default."""

    @staticmethod
    def forward(ctx, xg, rw, pI, pF, pO, h0, c0):
        y, acts, hprev, cprev, c_final = lstm_sequence_forward(
            xg, rw, pI, pF, pO, h0, c0)
        ctx.save_for_backward(acts, hprev, cprev, rw, pI, pF, pO)
        return y, c_final

    @staticmethod
    def backward(ctx, dy, dcF):
        acts, hprev, cprev, rw, pI, pF, pO = ctx.saved_tensors
        dxg, drw, dpi, dpf, dpo, dh0, dc0 = lstm_sequence_backward(
            acts, hprev, cprev, rw, pI, pF, pO, dy.contiguous(),
            dcF.contiguous())
        return (dxg, drw.to(rw.dtype), dpi.to(pI.dtype), dpf.to(pF.dtype),
                dpo.to(pO.dtype), dh0, dc0)


def lstm_sequence(xg, rw, pI, pF, pO, h0, c0):
    """Fused LSTM over a whole sequence: (y [T, B, H], hF, cF) — the
    helper-SPI signature of the JAX package's `lstm_sequence`. It runs
    through `LSTMSequence`: under autograd the backward runs on the
    backward kernel; otherwise autograd records nothing and only the
    forward kernel runs."""
    y, c_final = LSTMSequence.apply(xg, rw, pI, pF, pO, h0, c0)
    return y, y[-1], c_final


# -- probes and registration --------------------------------------------------


def _align16(n: int) -> int:
    return (n + 15) // 16 * 16


def step_h_stride(H: int) -> int:
    """K2's h row stride in shared memory (floats): H rounded up to a
    multiple of 4, and to an odd number of 16-byte units."""
    hp = -(-H // 4) * 4
    return hp if (hp // 4) % 2 else hp + 4


def step_smem(H: int, dtype=torch.float32) -> int:
    """Shared memory (bytes) one block of the decode-step kernel K2 uses at
    hidden size H, all of it dynamic: its RW column slice [H, 16] in RW's
    dtype (16-byte aligned), its h rows [8, step_h_stride(H)] in f32 and
    the f32 partial sums [4 chunks, 8, 16]. The C entry `lstm_step_smem`
    computes the same."""
    itemsize = 2 if dtype == torch.bfloat16 else 4
    return (_align16(H * STEP_COLS * itemsize) + 4 * STEP_ROWS * step_h_stride(H)
            + 4 * STEP_SPLIT * STEP_ROWS * STEP_COLS)


def _sequence_fits(B: int, H: int, backward: bool) -> bool:
    """True where a forward sequence kernel variant takes (B, H), and a
    backward one too when `backward` (`lstm_variant` raises where none
    does; its choice does not depend on the dtype)."""
    try:
        lstm_variant(B, H, torch.float32)
        if backward:
            lstm_variant(B, H, torch.float32, backward=True)
    except ValueError:
        return False
    return True


def step_supported(*, peephole, gate_act, cell_act, device=None, H=None,
                   dtype=None, **_):
    """Probe for the decode-step kernel: sigmoid gates + tanh cell,
    peepholes optional, f32 or bf16, hidden size H within K2's shared
    memory (`step_smem`), on a CUDA device of compute capability >= 9.0.
    The call site consults it only for unmasked stateful inference
    steps, and gives H and dtype (a probe without them checks neither)."""
    del peephole
    if gate_act not in ("sigmoid",) or cell_act not in ("tanh",):
        return False
    if dtype is not None and dtype not in _DTYPE_CODES:
        return False
    if H is not None and step_smem(H, dtype or torch.float32) > SMEM_LIMIT:
        return False
    return cuda_build.on_hopper(device)


def supported(*, peephole, mask, gate_act, cell_act, reverse, device=None,
              B=None, H=None, dtype=None, backward=False, **_):
    """Probe for the sequence kernels: sigmoid gates + tanh cell, forward
    direction, no time mask, on a CUDA device of compute capability
    >= 9.0, at a batch B and hidden size H that a forward kernel variant
    takes, and a backward variant too when `backward` (the call records a
    graph that a backward will run through). The call site gives B, H,
    dtype and `backward` (a probe without them checks none of them).
    Where no variant takes the shape the probe
    declines and the layer runs its builtin loop; a kernel that is chosen
    and fails still raises."""
    del peephole
    if reverse or mask is not None:
        return False
    if gate_act not in ("sigmoid",) or cell_act not in ("tanh",):
        return False
    if dtype is not None and dtype not in _DTYPE_CODES:
        return False
    if B is not None and H is not None and not _sequence_fits(B, H, backward):
        return False
    return cuda_build.on_hopper(device)


def register():
    from deeplearning4j_tpu_torch.ops.helpers import register_helper

    register_helper("lstm_sequence", lstm_sequence, supported,
                    name="cuda_fused_lstm", family=lambda **_: "lstm_seq")
    register_helper("lstm_decode_step", lstm_step, step_supported,
                    name="cuda_lstm_step", family=lambda **_: "lstm_step")


register()

"""The SSD chunked scan of a Mamba-2 layer as hand-written CUDA kernels
(csrc/ssd_scan.cu), forward and backward.

Mamba-2's state-space dual (Dao & Gu, arXiv:2405.21060, §6): per head h,
with a scalar decay a_t = dt_t A_h (A_h < 0), a state h_t [P, N] and
h_t = exp(a_t) h_{t-1} + dt_t x_t B_t^T, y_t = h_t C_t + D_h x_t. The
chunked form cuts time into chunks of Q steps; with l the cumulative sum
of a inside a chunk, a chunk's outputs are an intra-chunk product
((C B^T) o exp(l_t - l_s) o causal) (dt o x) plus exp(l_t) C S_in^T, its
state leaves as S_out = exp(l_last) S_in + (x o w)^T B with
w_s = exp(l_last - l_s) dt_s, and the chunk states are passed on in order.

Kernels (no TPU kernel of the JAX package computes this: the JAX package
has no state-space layer; the model that needs them is
models/granite_hybrid.py), launched three by the C entry `ssd_forward`
and four by `ssd_backward`:

- forward: `ssd_chunk_state_kernel` (each chunk's own state, a block a
  chunk and head), `ssd_state_pass_kernel` (the states passed on in chunk
  order, written in place as each chunk's incoming state S_in),
  `ssd_chunk_scan_kernel` (each chunk's outputs: the inter-chunk term, the
  intra-chunk products recomputed tile by tile, and the D x skip);
- backward: `ssd_bwd_dstate_kernel` (each chunk's dS_in from its outputs),
  `ssd_state_pass_bwd_kernel` (dS_out passed back in reverse chunk order,
  with the decay's gradient at each chunk end), `ssd_bwd_dx_kernel` (by
  columns s: dx, dB, ddt and the decay's gradient at s) and
  `ssd_bwd_dc_kernel` (by rows t: dC and the decay's gradient at t).

The products run on the tensor cores (WMMA, bf16 operands, f32
accumulation) over tiles staged in shared memory; every [Q, Q] score tile
is made, masked and decayed in shared memory and never written to device
memory. What the backward reads is its inputs and the chunk-boundary
states S_in (P N f32 a chunk a head, 8 KB a token at the published
widths): no [chunks, H, Q, Q] decay or score tensor is kept. The
chunk-local cumulative decay l ([B, T, H] f32) is a torch cumsum outside
the kernels, so that autograd carries its gradient to dt and A; its
chunk-end values give the passing.

The states, decays and the gradients of dt, l, B and C are f32. dB and dC
are written per head and summed over the heads of a group after the
kernels (no atomics: the sums are in a fixed order).

Beside the kernels is `ssd_chunked`, the plain PyTorch version of the same
function (the paper's chunked algorithm in f32, differentiated by
autograd), which `ssd_scan` takes for CPU tensors; on a CUDA tensor
`ssd_scan` launches the kernels or raises. `ssd_backward_plain` is the
kernels' backward decomposition in torch ops, which the tests hold to
autograd. The kernels are built at the first launch, never at import.
Each launch adds one to its count in `launch_counts()`; the spans
`ssd/scan_fwd` and `ssd/scan_bwd` cover a call's launches.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.ops import cuda_build
from deeplearning4j_tpu_torch.ops.launches import LaunchCounter
from deeplearning4j_tpu_torch.utils import tracing as _tracing

KERNELS = ("ssd_chunk_state", "ssd_state_pass", "ssd_chunk_scan", "ssd_bwd_dstate",
           "ssd_state_pass_bwd", "ssd_bwd_dx", "ssd_bwd_dc")

_counter = LaunchCounter(KERNELS)
launch_counts = _counter.launch_counts
reset_launch_counts = _counter.reset_launch_counts
recording_launches = _counter.recording_launches
add_launches = _counter.add_launches
_bump = _counter.bump

# elements of a state a block of the passing kernels takes (csrc/ssd_scan.cu
# PASS), each of its 8 warps writing one partial sum of the decay's gradient
PASS_BLOCK = 256


# -- the plain version -----------------------------------------------------------

def chunk_decay(dt, A, chunk: int):
    """l [B, T, H] f32 (f64 for f64 inputs): the cumulative sum of dt A_h
    inside each chunk of `chunk` steps (T a multiple of it)."""
    B, T, H = dt.shape
    acc = torch.promote_types(dt.dtype, torch.float32)
    a = dt.to(acc) * A.to(acc)
    return a.view(B, T // chunk, chunk, H).cumsum(2).view(B, T, H)


def _pad_time(chunk, *ts):
    """Each [B, T, ...] tensor zero-padded on time to a multiple of
    `chunk` (a padded step has dt 0: it decays nothing and adds nothing)."""
    T = ts[0].shape[1]
    pad = (-T) % chunk
    if not pad:
        return ts
    return tuple(F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad)) for t in ts)


def ssd_chunked(x, dt, A, Bm, Cm, D, chunk: int):
    """The plain chunked SSD: y [B, T, H, P] in x's dtype from x [B, T, H,
    P], dt [B, T, H] (after the softplus), A [H] (negative), Bm and Cm
    [B, T, G, N] (G groups of heads), D [H]; math in f32 (f64 for f64
    inputs)."""
    B, T, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    acc = torch.promote_types(x.dtype, torch.float32)
    x_, dt_, Bm_, Cm_ = _pad_time(chunk, x.to(acc), dt.to(acc), Bm.to(acc), Cm.to(acc))
    Tp = x_.shape[1]
    nc = Tp // chunk
    l = (dt_ * A.to(acc)).view(B, nc, chunk, H).cumsum(2)            # [B, c, Q, H]
    rep = H // G
    xc = x_.view(B, nc, chunk, H, P)
    dtc = dt_.view(B, nc, chunk, H)
    Bc = Bm_.view(B, nc, chunk, G, N).repeat_interleave(rep, dim=3)  # [B, c, Q, H, N]
    Cc = Cm_.view(B, nc, chunk, G, N).repeat_interleave(rep, dim=3)
    # intra-chunk: (C B^T) o exp(l_t - l_s) on s <= t, times dt_s x_s
    diff = l[:, :, :, None, :] - l[:, :, None, :, :]                   # [B, c, t, s, H]
    causal = torch.ones(chunk, chunk, dtype=torch.bool, device=x.device).tril()
    decay = torch.where(causal[None, None, :, :, None], torch.exp(diff.clamp_max(0)),
                        torch.zeros((), dtype=acc, device=x.device))
    cb = torch.einsum("bctHn,bcsHn->bctsH", Cc, Bc)
    y = torch.einsum("bctsH,bcsH,bcsHp->bctHp", cb * decay, dtc, xc)
    # each chunk's own state, then the states passed on in chunk order
    w = torch.exp(l[:, :, -1:, :] - l) * dtc                           # [B, c, Q, H]
    states = torch.einsum("bcsH,bcsHp,bcsHn->bcHpn", w, xc, Bc)
    s_in = [torch.zeros_like(states[:, 0])]
    for c in range(nc - 1):
        s_in.append(torch.exp(l[:, c, -1, :])[:, :, None, None] * s_in[-1] + states[:, c])
    s_in = torch.stack(s_in, dim=1)                                    # [B, c, H, P, N]
    y = y + torch.einsum("bctHn,bcHpn,bctH->bctHp", Cc, s_in, torch.exp(l))
    y = y.reshape(B, Tp, H, P)[:, :T] + D.to(acc)[:, None] * x.to(acc)
    return y.to(x.dtype)


def ssd_backward_plain(x, dt, l, Bm, Cm, D, dy, chunk: int):
    """The kernels' backward decomposition in torch ops, f32 (T a multiple
    of `chunk`): (dx, ddt, dl, dB, dC, dD) of sum(dy * y), with y the scan
    of x, dt, the chunk decay l, Bm, Cm and D, and l an input (its gradient
    goes on to dt and A by autograd). The tests hold it to autograd of
    `ssd_chunked`; the kernels compute the same terms tile by tile."""
    B, T, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    nc, Q, rep = T // chunk, chunk, H // G
    f = torch.float32 if x.dtype != torch.float64 else torch.float64
    xc = x.to(f).view(B, nc, Q, H, P)
    dyc = dy.to(f).view(B, nc, Q, H, P)
    dtc = dt.to(f).view(B, nc, Q, H)
    lc = l.to(f).view(B, nc, Q, H)
    Bc = Bm.to(f).view(B, nc, Q, G, N).repeat_interleave(rep, dim=3)
    Cc = Cm.to(f).view(B, nc, Q, G, N).repeat_interleave(rep, dim=3)
    causal = torch.ones(Q, Q, dtype=torch.bool, device=x.device).tril()
    dec = torch.where(causal[None, None, :, :, None],
                      torch.exp((lc[:, :, :, None] - lc[:, :, None]).clamp_max(0)),
                      torch.zeros((), dtype=f, device=x.device))      # [B, c, t, s, H]
    llast = lc[:, :, -1]                                                # [B, c, H]
    # forward states: S_in of each chunk
    w = torch.exp(llast[:, :, None] - lc) * dtc
    states = torch.einsum("bcsH,bcsHp,bcsHn->bcHpn", w, xc, Bc)
    s_in = [torch.zeros_like(states[:, 0])]
    for c in range(nc - 1):
        s_in.append(torch.exp(llast[:, c])[:, :, None, None] * s_in[-1] + states[:, c])
    s_in = torch.stack(s_in, 1)
    # dS_in's own part from each chunk's outputs, then dS_out passed back
    dsy = torch.einsum("bctH,bctHp,bctHn->bcHpn", torch.exp(lc), dyc, Cc)
    ds_out = [torch.zeros_like(dsy[:, 0])]
    for c in range(nc - 1, 0, -1):
        ds_out.append(torch.exp(llast[:, c])[:, :, None, None] * ds_out[-1] + dsy[:, c])
    ds_out = torch.stack(ds_out[::-1], 1)                               # [B, c, H, P, N]
    dll = torch.exp(llast) * (ds_out * s_in).sum((-1, -2))             # [B, c, H]
    # intra-chunk terms
    cb = torch.einsum("bctHn,bcsHn->bctsH", Cc, Bc)
    gl = cb * dec
    dyx = torch.einsum("bctHp,bcsHp->bctsH", dyc, xc)
    dG = dec * dtc[:, :, None] * dyx
    dx = dtc[..., None] * torch.einsum("bctsH,bctHp->bcsHp", gl, dyc)
    ddt = (gl * dyx).sum(2)
    dBh = torch.einsum("bctsH,bctHn->bcsHn", dG, Cc)
    dCh = torch.einsum("bctsH,bcsHn->bctHn", dG, Bc)
    R = cb * dG
    dl = R.sum(3) - R.sum(2)
    # the state terms
    bds = torch.einsum("bcsHn,bcHpn->bcsHp", Bc, ds_out)
    xds = torch.einsum("bcsHp,bcHpn->bcsHn", xc, ds_out)
    dw = (xc * bds).sum(-1)
    dx = dx + w[..., None] * bds + D.to(f)[:, None] * dyc
    dBh = dBh + w[..., None] * xds
    ddt = ddt + torch.exp(llast[:, :, None] - lc) * dw
    K = w * dw
    dl = dl - K
    yS = torch.einsum("bctHp,bcHpn->bctHn", dyc, s_in)
    dCh = dCh + torch.exp(lc)[..., None] * yS
    dl = dl + torch.exp(lc) * (Cc * yS).sum(-1)
    dl[:, :, -1] += K.sum(2) + dll
    dB = dBh.view(B, nc, Q, G, rep, N).sum(4).reshape(B, T, G, N)
    dC = dCh.view(B, nc, Q, G, rep, N).sum(4).reshape(B, T, G, N)
    dD = (dy.to(f) * x.to(f)).sum((0, 1, 3))
    return (dx.reshape(B, T, H, P), ddt.reshape(B, T, H), dl.reshape(B, T, H), dB, dC, dD)


# -- the kernels -----------------------------------------------------------------

_DTYPE_CODES = {torch.bfloat16: 1}


def _check(x, dt, l, Bm, Cm, D, chunk):
    if x.dtype not in _DTYPE_CODES:
        raise ValueError(f"ssd kernels take bf16 x, B, C; got {x.dtype} "
                         "(the f32 plain version runs on the CPU)")
    if Bm.dtype != x.dtype or Cm.dtype != x.dtype:
        raise ValueError("ssd kernels: x, B and C must share one dtype")
    B, T, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    if T % chunk or H % G:
        raise ValueError(f"ssd kernels: T {T} % chunk {chunk}, H {H} % G {G} must be 0")
    for n, v, top in (("P", P, 64), ("N", N, 128), ("chunk", chunk, None)):
        if v < 16 or v & (v - 1) or (top is not None and v > top):
            raise ValueError(f"ssd kernels: {n} {v} must be a power of two >= 16"
                             + (f" and <= {top}" if top else ""))
    for t in (x, dt, l, Bm, Cm, D):
        if t.device != x.device or not t.is_contiguous():
            raise ValueError("ssd kernels: every tensor contiguous on x's device")
    if dt.dtype != torch.float32 or l.dtype != torch.float32 or D.dtype != torch.float32:
        raise ValueError("ssd kernels: dt, l and D are f32")
    cuda_build.require_hopper(x.device)


def _call(fn_name, n_ptr, tensors, x, Bm, chunk):
    B, T, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    lib, fn = cuda_build.entry("ssd_scan", fn_name, n_ptr, 7)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        code = fn(_DTYPE_CODES[x.dtype], *(t.data_ptr() for t in tensors),
                  B, T, H, G, P, N, chunk, stream)
    cuda_build.check(lib, code, f"{fn_name} launch")


def scan_forward(x, dt, l, Bm, Cm, D, chunk: int):
    """(y, S_in, l_last): the forward kernels over contiguous inputs."""
    _check(x, dt, l, Bm, Cm, D, chunk)
    B, T, H, P = x.shape
    N = Bm.shape[3]
    nc = T // chunk
    l_last = l.view(B, nc, chunk, H)[:, :, -1].contiguous()
    states = torch.empty((B, nc, H, P, N), dtype=torch.float32, device=x.device)
    y = torch.empty_like(x)
    _call("ssd_forward", 9, (x, dt, l, l_last, Bm, Cm, D, states, y), x, Bm, chunk)
    for name in KERNELS[:3]:
        _bump(name)
    return y, states, l_last


def scan_backward(x, dt, l, Bm, Cm, D, states, l_last, dy, chunk: int):
    """(dx, ddt, dl, dB, dC, dD): the backward kernels, then the sums over
    heads and chunks in torch."""
    B, T, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    nc = T // chunk
    dev = x.device
    f32 = dict(dtype=torch.float32, device=dev)
    ds = torch.empty((B, nc, H, P, N), **f32)
    dll = torch.empty((B, nc, H, P * N // PASS_BLOCK * 8), **f32)
    dx = torch.empty_like(x)
    dbh, dch = (torch.empty((B, T, H, N), **f32) for _ in range(2))
    ddt, dlc, k, dlr = (torch.empty((B, T, H), **f32) for _ in range(4))
    _call("ssd_backward", 18, (x, dt, l, l_last, Bm, Cm, D, states, dy, ds, dll, dx, dbh,
                               ddt, dlc, k, dch, dlr), x, Bm, chunk)
    for name in KERNELS[3:]:
        _bump(name)
    dl = dlr - dlc
    dl.view(B, nc, chunk, H)[:, :, -1] += (k.view(B, nc, chunk, H).sum(2) + dll.sum(-1))
    rep = H // G
    dB = dbh.view(B, T, G, rep, N).sum(3)
    dC = dch.view(B, T, G, rep, N).sum(3)
    dD = (dy.float() * x.float()).sum((0, 1, 3))
    return dx, ddt, dl, dB, dC, dD


class SSDScan(torch.autograd.Function):
    """y = scan(x, dt, l, B, C, D) on the kernels; saves its inputs and the
    chunk-boundary states for the backward."""

    @staticmethod
    def forward(ctx, x, dt, l, Bm, Cm, D, chunk):
        with _tracing.span("ssd/scan_fwd"):
            y, states, l_last = scan_forward(x, dt, l, Bm, Cm, D, chunk)
        ctx.save_for_backward(x, dt, l, Bm, Cm, D, states, l_last)
        ctx.chunk = chunk
        return y

    @staticmethod
    def backward(ctx, dy):
        x, dt, l, Bm, Cm, D, states, l_last = ctx.saved_tensors
        with _tracing.span("ssd/scan_bwd"):
            dx, ddt, dl, dB, dC, dD = scan_backward(
                x, dt, l, Bm, Cm, D, states, l_last, dy.contiguous(), ctx.chunk)
        return dx, ddt, dl, dB.to(Bm.dtype), dC.to(Cm.dtype), dD, None


def ssd_scan(x, dt, A, Bm, Cm, D, chunk: int):
    """The SSD of a Mamba-2 layer: y [B, T, H, P] from x [B, T, H, P], dt
    [B, T, H] (after the softplus, f32), A [H] (negative, f32), Bm and Cm
    [B, T, G, N], D [H]. On the CPU the plain version `ssd_chunked`; on a
    CUDA tensor the kernels (time padded to a whole number of chunks), or
    a ValueError for what they do not take."""
    if x.device.type != "cuda":
        return ssd_chunked(x, dt, A, Bm, Cm, D, chunk)
    T = x.shape[1]
    x_, dt_, Bm_, Cm_ = _pad_time(chunk, x, dt.float(), Bm, Cm)
    l = chunk_decay(dt_, A, chunk)
    y = SSDScan.apply(x_.contiguous(), dt_.contiguous(), l, Bm_.contiguous(),
                      Cm_.contiguous(), D.float().contiguous(), chunk)
    return y[:, :T]

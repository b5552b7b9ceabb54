"""The optimizer tail of the training step as one multi-tensor kernel.

`apply_updater` takes every trainable f32 leaf of a network with its raw
gradient (the data loss's, without the L2 term), its updater state, its
layer's l2 and its learning-rate multiplier, and in one pass per element
folds the L2 gradient in (g' = g + l2 * w), steps the parameter and the
state by the updater (SGD, Nesterovs or RMSProp), and sums g'^2 and
0.5 * l2 * w^2 (over the pre-update w). It returns the step's diagnostic,
[loss + L2 term, sqrt(sum g'^2)]: the score DL4J reports and the raw
gradient norm the sentinel reads (nn/netbase.py `_step_diag`).

On a CUDA tensor it launches `updater_apply` (csrc/updater_apply.cu) as
many times as its table needs (`plan_launches`), then `updater_finish`
once; nothing is copied from the host and nothing synchronizes, so a
captured CUDA graph holds the launches with their tables. On the CPU it
runs `apply_updater_reference`, the per-leaf torch ops of
`UpdaterDef.step_` with the L2 term folded into the gradient. Each launch
adds one to its count in `launch_counts()`.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.ops import cuda_build
from deeplearning4j_tpu_torch.ops.launches import LaunchCounter

KINDS = {"sgd": 0, "nesterovs": 1, "rmsprop": 2}
# csrc/updater_apply.cu's table: elements a block takes, leaves and blocks
# a launch holds
CHUNK, MAX_LEAVES, MAX_BLOCKS = 8192, 36, 320

_counter = LaunchCounter(("updater_apply", "updater_finish"))
launch_counts = _counter.launch_counts
reset_launch_counts = _counter.reset_launch_counts
recording_launches = _counter.recording_launches
add_launches = _counter.add_launches
_bump = _counter.bump


class _Table(ctypes.Structure):
    _fields_ = [("p", ctypes.c_void_p * MAX_LEAVES),
                ("g", ctypes.c_void_p * MAX_LEAVES),
                ("s", ctypes.c_void_p * MAX_LEAVES),
                ("n", ctypes.c_longlong * MAX_LEAVES),
                ("l2", ctypes.c_float * MAX_LEAVES),
                ("half_l2", ctypes.c_float * MAX_LEAVES),
                ("mult", ctypes.c_float * MAX_LEAVES),
                ("leaf", ctypes.c_ubyte * MAX_BLOCKS),
                ("chunk", ctypes.c_int * MAX_BLOCKS)]


class Launch(NamedTuple):
    leaves: Tuple[int, ...]              # the table's slots: leaf indices
    blocks: Tuple[Tuple[int, int], ...]  # each block's (slot, chunk)


@functools.lru_cache(maxsize=64)
def plan_launches(numels: Tuple[int, ...]) -> Tuple[Launch, ...]:
    """The launches of one tail over leaves of these sizes, in order: each
    leaf cut into chunks of CHUNK elements, a block a chunk, and a new
    launch wherever the next block would pass MAX_BLOCKS or its leaf
    MAX_LEAVES (a leaf may go on in the next launch). Empty leaves take no
    block."""
    launches: List[Launch] = []
    leaves: List[int] = []
    blocks: List[Tuple[int, int]] = []
    for i, n in enumerate(numels):
        for c in range(-(-n // CHUNK)):
            if len(blocks) == MAX_BLOCKS or (
                    (not leaves or leaves[-1] != i) and len(leaves) == MAX_LEAVES):
                launches.append(Launch(tuple(leaves), tuple(blocks)))
                leaves, blocks = [], []
            if not leaves or leaves[-1] != i:
                leaves.append(i)
            blocks.append((len(leaves) - 1, c))
    if blocks:
        launches.append(Launch(tuple(leaves), tuple(blocks)))
    return tuple(launches)


@functools.lru_cache(maxsize=64)
def _templates(numels: Tuple[int, ...]) -> Tuple[bytes, ...]:
    """Each launch's table with its sizes and block map filled in."""
    out = []
    for launch in plan_launches(numels):
        t = _Table()
        for slot, i in enumerate(launch.leaves):
            t.n[slot] = numels[i]
        for b, (slot, c) in enumerate(launch.blocks):
            t.leaf[b], t.chunk[b] = slot, c
        out.append(bytes(t))
    return tuple(out)


def _state_tensor(state: dict) -> Optional[torch.Tensor]:
    """A leaf's one state tensor (Nesterovs' v, RMSProp's r), or None."""
    return next(iter(state.values()), None)


def _hyper(updater) -> Tuple[float, float, float]:
    """The kernel's (a, b, c): the constants of the updater's torch
    version, which torch rounds to f32 from these Python floats."""
    hp = updater.hyper
    if updater.name == "nesterovs":
        mu = hp["momentum"]
        return mu, -mu, 1.0 + mu
    if updater.name == "rmsprop":
        return hp["rms_decay"], 1 - hp["rms_decay"], hp["epsilon"]
    return 0.0, 0.0, 0.0


def _check(params, grads, states, l2, lr_mult, lr, loss) -> None:
    n = len(params)
    if not (len(grads) == len(states) == len(l2) == len(lr_mult) == n) or n == 0:
        raise ValueError("apply_updater needs one grad, state, l2 and lr multiplier a leaf")
    for p, g, s in zip(params, grads, states):
        for name, t in (("parameter", p), ("gradient", g),
                        ("state", _state_tensor(s))):
            if t is None:
                continue
            if t.dtype != torch.float32 or t.device != params[0].device:
                raise ValueError(f"apply_updater takes f32 tensors on one device; a "
                                 f"{name} is {t.dtype} on {t.device}")
            if t.shape != p.shape:
                raise ValueError(f"a {name} of shape {tuple(t.shape)} beside a "
                                 f"parameter of {tuple(p.shape)}")
        if not p.is_contiguous() or (s and not _state_tensor(s).is_contiguous()):
            raise ValueError("apply_updater steps contiguous parameters and state")
    for name, t in (("lr", lr), ("loss", loss)):
        if t.dim() != 0 or t.dtype != torch.float32 or t.device != params[0].device:
            raise ValueError(f"{name} must be a 0-d f32 tensor on the parameters' device")


def apply_updater(updater, params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor],
                  states: Sequence[dict], l2: Sequence[float], lr_mult: Sequence[float],
                  lr: torch.Tensor, t: torch.Tensor, loss: torch.Tensor,
                  negate: bool = False, l2_share: float = 1.0) -> torch.Tensor:
    """Step every leaf in place and return [loss + L2 term, gradient norm]
    (f32 [2]). `updater` is a train/updaters UpdaterDef of KINDS;
    `states[i]` the leaf's state dict (written in place); `l2[i]` its
    layer's l2 (0 for a leaf the penalty skips); `lr_mult[i]` its
    learning-rate multiplier; `lr` and `t` 0-d f32 device tensors; `loss`
    the data loss (0-d f32). `negate` maximizes: the step takes -g'.
    `l2_share` is the share of the L2 gradient the loss passes to the
    weights (g' = g + l2_share * l2 * w, the product rounded to f32 as
    autograd rounds it; the score keeps the whole term): below 1 where
    part of the loss took no gradient, as truncated TBPTT's leading
    slice."""
    if updater.name not in KINDS:
        raise ValueError(f"apply_updater runs {sorted(KINDS)}, not {updater.name!r}")
    _check(params, grads, states, l2, lr_mult, lr, loss)
    if not params[0].is_cuda:
        return apply_updater_reference(updater, params, grads, states, l2, lr_mult,
                                       lr, t, loss, negate, l2_share)
    dev = params[0].device
    cuda_build.require_hopper(dev)
    grads = [g.contiguous() for g in grads]
    numels = tuple(p.numel() for p in params)
    launches = plan_launches(numels)
    n_blocks = sum(len(launch.blocks) for launch in launches)
    partials = torch.empty((n_blocks, 2), dtype=torch.float64, device=dev)
    diag = torch.empty(2, dtype=torch.float32, device=dev)
    lib = cuda_build.library("updater_apply")
    apply_fn, finish_fn = _bind(lib)
    stream = torch.cuda.current_stream(dev).cuda_stream
    a, b, c = _hyper(updater)
    sign = -1.0 if negate else 1.0
    base = partials.data_ptr()
    with torch.cuda.device(dev):
        for launch, template in zip(launches, _templates(numels)):
            table = _Table.from_buffer_copy(template)
            for slot, i in enumerate(launch.leaves):
                st = _state_tensor(states[i])
                table.p[slot], table.g[slot] = params[i].data_ptr(), grads[i].data_ptr()
                table.s[slot] = None if st is None else st.data_ptr()
                table.l2[slot], table.half_l2[slot] = _grad_l2(l2[i], l2_share), 0.5 * l2[i]
                table.mult[slot] = lr_mult[i]
            code = apply_fn(KINDS[updater.name], ctypes.byref(table), len(launch.blocks),
                            a, b, c, lr.data_ptr(), sign, base, stream)
            cuda_build.check(lib, code, "updater_apply launch")
            _bump("updater_apply")
            base += len(launch.blocks) * 2 * partials.element_size()
        code = finish_fn(partials.data_ptr(), n_blocks, loss.data_ptr(), diag.data_ptr(),
                         stream)
        cuda_build.check(lib, code, "updater_finish launch")
        _bump("updater_finish")
    return diag


def _grad_l2(l2: float, share: float) -> float:
    """The L2 gradient's coefficient, f32(share) * f32(l2) in f32: the
    rounding autograd gives the penalty's gradient through a score that
    weighs it by `share` (exactly f32(l2) at share 1)."""
    return float(np.float32(share) * np.float32(l2))


def _bind(lib):
    """The library's two entry points, their argument types set once (with
    a check that the ctypes table is the C table's size)."""
    fn, fin = lib.updater_apply, lib.updater_finish
    if fn.argtypes is None:
        if lib.updater_table_bytes() != ctypes.sizeof(_Table):
            raise RuntimeError("csrc/updater_apply.cu's Table and ops/fused_updater.py's "
                               "_Table differ in size")
        P, F = ctypes.c_void_p, ctypes.c_float
        fn.argtypes = [ctypes.c_int, P, ctypes.c_int, F, F, F, P, F, P, P]
        fn.restype = ctypes.c_int
        fin.argtypes = [P, ctypes.c_int, P, P, P]
        fin.restype = ctypes.c_int
    return fn, fin


def apply_updater_reference(updater, params, grads, states, l2, lr_mult, lr, t, loss,
                            negate=False, l2_share=1.0) -> torch.Tensor:
    """The plain version: per leaf, the L2 term 0.5 * l2 * sum(w * w) and
    gradient g + l2_share * l2 * w (where l2 is not 0), g'^2 summed, then the
    updater's torch ops and the in-place writes of `UpdaterDef.step_`;
    the score is loss + the L2 terms summed leaf by leaf."""
    with torch.no_grad():
        reg = 0.0
        gsq = torch.zeros((), dtype=torch.float32, device=loss.device)
        scaled = {1.0: lr}  # one lr tensor per distinct multiplier, as _step
        for p, g, s, c, m in zip(params, grads, states, l2, lr_mult):
            if c:
                reg = reg + 0.5 * c * (p * p).sum()
                g = g + _grad_l2(c, l2_share) * p
            gsq = gsq + g.square().sum()
            if negate:
                g = -g
            if m not in scaled:
                scaled[m] = lr * m
            u, ns = updater.apply(g, s, scaled[m], t, updater.hyper)
            p.add_(u)
            for name, v in ns.items():
                s[name].copy_(v)
        return torch.stack([loss + reg, torch.sqrt(gsq)])

"""Pipeline parallelism: GPipe-style microbatch pipelining over a mesh axis.

The port of the JAX package's parallel/pipeline.py. Rank s of the "stage"
axis holds stage s's parameters; activations flow stage to stage with
`ppermute`, and the batch is split into microbatches so that every stage
works at once (the GPipe schedule; Huang et al.). The tick loop is the
JAX module's `lax.scan` body unrolled in Python: S + M - 1 ticks for M
microbatches over S stages (bubble (S-1)/(S+M-1) of the ticks), the last
stage's outputs summed over the axis once at the end with `psum`.
Gradients come from autograd through `ppermute` (whose backward sends the
cotangent back along the inverse permutation) and `psum` (identity
backward: every rank's loss is the same replicated value), as `jax.grad`
derives the reverse schedule in the reference.

Every rank runs the same ops in the same order: the stage input and the
output tap are selected with `torch.where` on the rank's stage index, not
with Python branches, so that every rank's autograd graph has the same
shape and the backward's point-to-point calls pair up.

Layout:
  stage params  — each rank holds its stage's leaves as [1, ...] slices of
                  the stage-stacked [S, ...] tree (`shard_stage_params`)
  inputs/outputs— replicated [B, ...]; stage 0 feeds microbatch t at tick
                  t, every rank returns the whole output
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch

from deeplearning4j_tpu_torch.parallel.mesh import Mesh, _world, ppermute, psum

STAGE_AXIS = "stage"


def pipeline_parallel_mesh(ranks: Optional[Sequence[int]] = None,
                           axis_name: str = STAGE_AXIS) -> Mesh:
    """1-D mesh over every rank (or the given order) with a single "stage"
    axis."""
    ranks = list(range(_world()[0])) if ranks is None else list(ranks)
    return Mesh(np.array(ranks), (axis_name,))


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def shard_stage_params(stacked_params, mesh: Mesh, axis_name: str = STAGE_AXIS):
    """This rank's [1, ...] slice of stage-stacked parameters (every leaf
    [S, ...]): rank s keeps stage s, the pipeline analog of tensor.py's
    `shard_params_tp`."""
    s = mesh.axis_index(axis_name)
    return _tree_map(lambda a: a[s:s + 1].detach().clone(), stacked_params)


def pipeline_apply(stage_fn: Callable, stage_params, x, *, mesh: Mesh,
                   n_microbatches: int, axis_name: str = STAGE_AXIS):
    """Run `x` through S pipelined stages of `stage_fn`.

    Args:
        stage_fn: (params_one_stage, x[mb, ...]) -> y[mb, ...], shape
            preserving (repeated blocks; embed and head layers stay outside).
        stage_params: this rank's stage, every leaf [1, ...]
            (`shard_stage_params`).
        x: the global batch [B, ...], the same on every rank; B divisible
            by n_microbatches.
        mesh: a mesh with the stage axis; its size is S.
        n_microbatches: M, which amortizes the (S-1)-tick bubble.

    Returns [B, ...] on every rank. Differentiable: autograd through it is
    the reverse schedule.
    """
    S = mesh.axis_size(axis_name)
    B = x.shape[0]
    M = int(n_microbatches)
    if B % M:
        raise ValueError(f"batch {B} not divisible by n_microbatches {M}")
    x_mb = x.reshape((M, B // M) + tuple(x.shape[1:]))
    idx = mesh.axis_index(axis_name)
    first = torch.tensor(idx == 0, device=x.device)
    last = torch.tensor(idx == S - 1, device=x.device)
    local = _tree_map(lambda a: a[0], stage_params)
    perm = [(i, i + 1) for i in range(S - 1)]  # stage i -> i+1, no wrap
    state = torch.zeros_like(x_mb[0])
    ys = []
    for t in range(S + M - 1):
        # stage 0 ingests microbatch t. Drain ticks (t >= M) re-feed
        # microbatch M-1: its re-processed results never reach the last
        # stage inside the window, so they are output-invisible, forward
        # and backward (the JAX module's trade-off: every tick the same ops)
        feed = x_mb[min(t, M - 1)]
        out = stage_fn(local, torch.where(first, feed, state))
        # the last stage's result at tick t is output microbatch t-(S-1);
        # zero elsewhere, so that the final psum broadcasts it
        if t >= S - 1:
            ys.append(torch.where(last, out, torch.zeros_like(out)))
        if t < S + M - 2:  # the last tick's permute would never be read
            state = ppermute(out, mesh, axis_name, perm) if S > 1 else out
    y = psum(torch.stack(ys), mesh, axis_name)  # only the last stage is nonzero
    return y.reshape((B,) + tuple(y.shape[2:]))


def sequential_apply(stage_fn: Callable, stacked_params, x):
    """Single-process reference: the same stages applied in order (what
    the pipeline must reproduce). `stacked_params` leaves are [S, ...]."""
    leaves = []
    _tree_map(leaves.append, stacked_params)
    for s in range(leaves[0].shape[0]):
        x = stage_fn(_tree_map(lambda a: a[s], stacked_params), x)
    return x

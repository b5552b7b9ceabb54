"""Process meshes and the collectives of the port's scale-out.

The port of the JAX package's parallel/mesh.py. Where the JAX package
names a grid of devices with a `jax.sharding.Mesh` and lets GSPMD insert
the collectives, the port runs one process per device (PyTorch's idiom)
joined by `torch.distributed`: a `Mesh` lays the ranks of the default
process group out on named axes and holds one process group per axis,
and the collectives are explicit calls on tensors — NCCL on the card,
gloo on the CPU.

Axis vocabulary, as in the JAX package:
    "data"  — data parallelism (the batch is split over it)
    "model" — tensor parallelism (feature axes are split over it)

`replicated` and `batch_sharded` are placement tags: a process holds a
tensor whole or holds its rows of it. With no process group up (one
process), a mesh has one rank and every collective is the identity.

The collectives carry autograd where the JAX package differentiates
through them (inside `shard_map`, where the loss is ONE replicated
value):

- `psum`: all-reduce forward, identity backward;
- `copy_to_axis`: identity forward, all-reduce backward (Megatron's
  column-parallel input, and the transpose of a replicated input);
- `ppermute`: point-to-point forward, the inverse permutation backward;
- `all_gather`: gather forward, this rank's rows of the cotangent
  backward.

gloo reduces and broadcasts CUDA tensors but has no point-to-point or
all-gather for them; on a gloo group those two stage a CUDA tensor
through pinned host memory (counted in `Mesh.staged_bytes`). The NCCL
path never stages.

`data_parallel_scope(mesh)` marks the running training step as one rank's
share of a global-batch step: batch normalization then reduces its
per-channel sums over the data axis, the loss divides by the global
present count, L1/L2 enter 1/R on each rank, and random draws that have a
batch axis are drawn for the global batch and cut to this rank's rows.
"""

from __future__ import annotations

import contextlib
import datetime
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"

# every group's collectives and every join give up after this long, so a
# lost rank fails the run instead of hanging it
DEFAULT_TIMEOUT_SECONDS = 300.0


def initialize_distributed(init_method: str, world_size: int, rank: int, *,
                           backend: Optional[str] = None,
                           timeout: float = DEFAULT_TIMEOUT_SECONDS) -> None:
    """Join this process into the default process group (`init_method`
    e.g. "tcp://host:port" or "file:///path"). `backend` None picks NCCL
    when this process sees a GPU, else gloo. Every collective on the
    group times out after `timeout` seconds."""
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    dist.init_process_group(backend, init_method=init_method,
                            world_size=int(world_size), rank=int(rank),
                            timeout=datetime.timedelta(seconds=timeout))


def _world() -> Tuple[int, int]:
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def n_devices() -> int:
    """The world size: one device a process (1 with no process group)."""
    return _world()[0]


class Placement:
    """A placement tag: how a tensor lies over a mesh. `axis` None is
    replicated (every process holds it whole); else dim 0 is split over
    that axis and each process holds its contiguous rows."""

    def __init__(self, mesh: "Mesh", axis: Optional[str]):
        self.mesh = mesh
        self.axis = axis

    def __eq__(self, other):
        return (isinstance(other, Placement) and other.mesh is self.mesh
                and other.axis == self.axis)

    def __repr__(self):
        return f"Placement({'replicated' if self.axis is None else self.axis})"


class CollectiveStats:
    """Calls, bytes and host seconds of a mesh's collectives, by site
    ("grads", "bn_stats", "loss_count", ...)."""

    def __init__(self):
        self._lock = threading.Lock()
        self.by_site: Dict[str, Dict[str, float]] = {}

    def add(self, site: str, nbytes: int, seconds: float) -> None:
        with self._lock:
            rec = self.by_site.setdefault(site, {"calls": 0, "bytes": 0, "seconds": 0.0})
            rec["calls"] += 1
            rec["bytes"] += int(nbytes)
            rec["seconds"] += seconds

    def snapshot(self) -> Dict[str, Dict[str, float]]:
        with self._lock:
            return {k: dict(v) for k, v in self.by_site.items()}

    def reset(self) -> None:
        with self._lock:
            self.by_site = {}


class Mesh:
    """The ranks of the default process group laid out on named axes.

    `ranks` is an array of global ranks whose shape gives the axis sizes
    (`np.array(range(world)).reshape(data, model)` for `mesh_2d`). It
    must hold every rank of the world once: every rank builds every
    axis's groups, in the same order. This rank's coordinate on each axis
    is where its rank sits in `ranks`."""

    def __init__(self, ranks, axis_names: Sequence[str]):
        world, rank = _world()
        grouped = dist.is_available() and dist.is_initialized()
        self.ranks = np.asarray(ranks, dtype=np.int64)
        self.axis_names = tuple(axis_names)
        if self.ranks.ndim != len(self.axis_names):
            raise ValueError(f"{self.ranks.ndim}-d rank array for axes {self.axis_names}")
        if sorted(self.ranks.reshape(-1).tolist()) != list(range(world)):
            raise ValueError(
                f"a mesh must hold every rank of the world ({world}) once, got "
                f"{self.ranks.reshape(-1).tolist()}")
        self.shape = {n: int(s) for n, s in zip(self.axis_names, self.ranks.shape)}
        self.rank = rank
        self.coords = {n: int(c) for n, c in
                       zip(self.axis_names, np.argwhere(self.ranks == rank)[0])}
        self.backend = dist.get_backend() if grouped else "none"
        self.staged_bytes = 0
        self.stats = CollectiveStats()
        self._axis: Dict[str, Tuple[object, List[int]]] = {}
        for i, name in enumerate(self.axis_names):
            rows = np.moveaxis(self.ranks, i, -1).reshape(-1, self.shape[name])
            mine = [r for r in rows.tolist() if rank in r][0]
            if not grouped or (self.shape[name] == 1 and world > 1):
                group = None
            elif rows.shape[0] == 1 and mine == list(range(world)):
                group = dist.group.WORLD
            else:
                group, _ = dist.new_subgroups_by_enumeration(rows.tolist())
            self._axis[name] = (group, mine)

    # -- geometry ---------------------------------------------------------------

    @property
    def size(self) -> int:
        return int(self.ranks.size)

    def axis_size(self, axis: str) -> int:
        return self.shape[axis]

    def axis_index(self, axis: str) -> int:
        return self.coords[axis]

    def axis_ranks(self, axis: str) -> List[int]:
        """The global ranks of this rank's row along `axis`, in axis order."""
        return list(self._axis[axis][1])

    def group(self, axis: str):
        """The process group of this rank's row along `axis` (None when
        the axis has one rank)."""
        return self._axis[axis][0]

    def describe(self) -> dict:
        return {"transport": self.backend, "world": self.size,
                "axes": dict(self.shape), "coords": dict(self.coords),
                "staged_bytes": self.staged_bytes}

    def _stages(self, x: torch.Tensor) -> bool:
        """Whether a point-to-point or all-gather of `x` goes through
        pinned host memory: a CUDA tensor on a gloo group."""
        return x.is_cuda and self.backend == "gloo"

    def _stage(self, x: torch.Tensor) -> torch.Tensor:
        host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        host.copy_(x)
        self.staged_bytes += x.numel() * x.element_size()
        return host


def data_parallel_mesh(ranks: Optional[Sequence[int]] = None) -> Mesh:
    """1-D mesh over every rank (or the given order of them) with a single
    "data" axis: one replica a device, the reference ParallelWrapper's
    topology."""
    world, _ = _world()
    ranks = list(range(world)) if ranks is None else list(ranks)
    return Mesh(np.array(ranks), (DATA_AXIS,))


def mesh_2d(data: int, model: int, ranks: Optional[Sequence[int]] = None) -> Mesh:
    """data x model mesh for data plus tensor parallelism; `data * model`
    must equal the world size."""
    world, _ = _world()
    ranks = list(range(world)) if ranks is None else list(ranks)
    if data * model != len(ranks):
        raise ValueError(
            f"mesh {data}x{model} needs {data * model} devices, have {len(ranks)}")
    return Mesh(np.array(ranks).reshape(data, model), (DATA_AXIS, MODEL_AXIS))


def replicated(mesh: Mesh) -> Placement:
    """Every process holds the tensor whole (parameters, updater state)."""
    return Placement(mesh, None)


def batch_sharded(mesh: Mesh, axis: str = DATA_AXIS) -> Placement:
    """Dim 0 (the batch) split over `axis`: each process holds its rows."""
    return Placement(mesh, axis)


def data_shards(mesh: Mesh) -> int:
    """Shards along the data axis (not the world size: on a data x model
    mesh only the data axis splits the batch)."""
    return int(mesh.shape[DATA_AXIS])


def placement_for_batch(mesh: Mesh, n_examples: int) -> Placement:
    """A batch of n examples is split over the data axis when divisible,
    else replicated (the single source of that rule for training and
    serving paths)."""
    if n_examples % data_shards(mesh) == 0:
        return batch_sharded(mesh)
    return replicated(mesh)


def pad_wrap(a: np.ndarray, multiple: int) -> np.ndarray:
    """Pad dim 0 up to the next multiple by cyclically repeating examples
    (np.resize wraps, correct even when the pad exceeds the batch)."""
    n = a.shape[0]
    pad = (-n) % multiple
    return np.resize(a, (n + pad,) + a.shape[1:]) if pad else a


# -- plain (autograd-free) collectives ----------------------------------------------


def all_reduce_(x: torch.Tensor, mesh: Mesh, axis: str = DATA_AXIS,
                site: str = "other") -> torch.Tensor:
    """In-place sum of `x` over `axis` (identity on a one-rank axis, or
    with no process group); booked under `site` in `mesh.stats`, and named
    `collective/<site>` for the profiler."""
    group = mesh.group(axis)
    if group is None:
        return x
    t0 = time.perf_counter()
    with torch.profiler.record_function(f"collective/{site}"):
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    mesh.stats.add(site, x.numel() * x.element_size(), time.perf_counter() - t0)
    return x


def broadcast_(x: torch.Tensor, mesh: Mesh, axis: str = DATA_AXIS) -> torch.Tensor:
    """In place: every rank of this rank's row along `axis` gets the
    tensor of the row's first rank."""
    group = mesh.group(axis)
    if group is not None:
        dist.broadcast(x, src=mesh.axis_ranks(axis)[0], group=group)
    return x


def barrier(mesh: Mesh) -> None:
    if mesh.size > 1:
        dist.barrier()


def _gather_list(x: torch.Tensor, mesh: Mesh, axis: str) -> List[torch.Tensor]:
    """Every rank's `x` along `axis`, in axis order (equal shapes)."""
    group = mesh.group(axis)
    if group is None:
        return [x]
    src = mesh._stage(x) if mesh._stages(x) else x.contiguous()
    parts = [torch.empty_like(src) for _ in range(mesh.axis_size(axis))]
    dist.all_gather(parts, src, group=group)
    # the list comes in group-rank order; the axis order is the row's
    members = mesh.axis_ranks(axis)
    order = sorted(range(len(members)), key=lambda i: members[i])
    by_axis = [None] * len(members)
    for group_rank, axis_pos in enumerate(order):
        by_axis[axis_pos] = parts[group_rank]
    if src is not x:
        by_axis = [p.to(x.device, non_blocking=True) for p in by_axis]
    return by_axis


def _ppermute_raw(x: torch.Tensor, mesh: Mesh, axis: str,
                  perm: Sequence[Tuple[int, int]]) -> torch.Tensor:
    """Send x to the axis index `perm` maps this rank to; return what the
    rank mapped here sent (zeros when none is)."""
    me = mesh.axis_index(axis)
    members = mesh.axis_ranks(axis)
    dst = [d for s, d in perm if s == me]
    src = [s for s, d in perm if d == me]
    if len(dst) > 1 or len(src) > 1:
        raise ValueError(f"perm {perm} is not a permutation")
    stage = mesh._stages(x)
    wire = mesh._stage(x) if stage else x.contiguous()
    out = torch.zeros_like(wire)
    if mesh.group(axis) is None:
        if dst and src:
            out.copy_(wire)
    else:
        ops = []
        if dst:
            ops.append(dist.P2POp(dist.isend, wire, members[dst[0]]))
        if src:
            ops.append(dist.P2POp(dist.irecv, out, members[src[0]]))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
    if stage:
        return out.to(x.device, non_blocking=True)
    return out


# -- collectives with autograd ------------------------------------------------------


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        y = x.clone()
        return all_reduce_(y, mesh, axis, site="psum")

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _CopyToAxis(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.clone(), ctx.mesh, ctx.axis, site="psum"), None, None


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, perm):
        ctx.mesh, ctx.axis, ctx.perm = mesh, axis, perm
        return _ppermute_raw(x, mesh, axis, perm)

    @staticmethod
    def backward(ctx, g):
        inverse = [(d, s) for s, d in ctx.perm]
        return _ppermute_raw(g, ctx.mesh, ctx.axis, inverse), None, None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis, ctx.rows = mesh, axis, x.shape[0]
        return torch.cat(_gather_list(x, mesh, axis), dim=0)

    @staticmethod
    def backward(ctx, g):
        i = ctx.mesh.axis_index(ctx.axis)
        return g[i * ctx.rows:(i + 1) * ctx.rows], None, None


def psum(x: torch.Tensor, mesh: Mesh, axis: str = DATA_AXIS) -> torch.Tensor:
    """Sum over `axis`: all-reduce forward, identity backward. In the JAX
    package's shard_map the loss is one replicated value, so each rank's
    cotangent is already the whole one; an all-reduce in the backward
    would multiply gradients by the axis size."""
    return _PSum.apply(x, mesh, axis)


def copy_to_axis(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """Identity forward, all-reduce backward: a replicated input whose
    uses differ by rank (a column-parallel layer's input, the weights of
    a sequence-sharded block) collects its gradient from every rank."""
    return _CopyToAxis.apply(x, mesh, axis)


def ppermute(x: torch.Tensor, mesh: Mesh, axis: str,
             perm: Sequence[Tuple[int, int]]) -> torch.Tensor:
    """Point-to-point over `axis`: axis index s sends x to d for each
    (s, d) in `perm`; a rank no pair sends to gets zeros. Backward sends
    the cotangent along the inverse permutation. Every rank must call it
    (and run its backward) in the same order."""
    return _PPermute.apply(x, mesh, axis, tuple(tuple(p) for p in perm))


def all_gather(x: torch.Tensor, mesh: Mesh, axis: str = DATA_AXIS) -> torch.Tensor:
    """Every rank's x along `axis` concatenated on dim 0, in axis order
    (equal shapes). Backward: this rank's rows of the cotangent (the loss
    is replicated)."""
    return _AllGather.apply(x, mesh, axis)


# -- the data-parallel training scope -----------------------------------------------

_scope = threading.local()


@contextlib.contextmanager
def data_parallel_scope(mesh: Optional[Mesh]):
    """Within: the running training step is this rank's share of a step
    over the global batch split on `mesh`'s data axis (no-op for None or a
    one-rank data axis)."""
    prev = getattr(_scope, "mesh", None)
    _scope.mesh = mesh if mesh is not None and data_shards(mesh) > 1 else None
    try:
        yield
    finally:
        _scope.mesh = prev


def active_data_mesh() -> Optional[Mesh]:
    """The mesh of the data-parallel step running on this thread, or None.
    Autograd Functions read it in forward and keep it for their backward,
    which may run on another thread."""
    return getattr(_scope, "mesh", None)


def data_sum(x: torch.Tensor, site: str) -> torch.Tensor:
    """x summed over the active step's data axis (the identity outside a
    data-parallel step); no gradient flows through the sum."""
    mesh = active_data_mesh()
    if mesh is None:
        return x
    return all_reduce_(x.detach().clone(), mesh, DATA_AXIS, site=site)


def draw_rows(draw: Callable[[tuple], torch.Tensor], shape: tuple) -> torch.Tensor:
    """`draw(shape)` for a batch-major shape. Inside a data-parallel step
    the draw is made for the global batch and this rank keeps its rows,
    so a world-R fit draws what the same fit in one process draws."""
    mesh = active_data_mesh()
    if mesh is None:
        return draw(tuple(shape))
    r, i = data_shards(mesh), mesh.axis_index(DATA_AXIS)
    b = shape[0]
    return draw((b * r,) + tuple(shape[1:]))[i * b:(i + 1) * b]

"""MeshPlan — the data-parallel training step of the port.

The port of the JAX package's parallel/sharded.py on `torch.distributed`,
one process a device:

* `place_net` broadcasts the first data rank's parameters, layer state
  and updater state over the data axis, so every replica starts
  bit-equal (the JAX package's replicated `device_put`); tensors a
  tensor-parallel helper split (`shard_params_tp`) are broadcast over
  the data axis only;
* `shard_batch` pads a global batch by wrapping examples to a
  shard-divisible size, gives this rank its contiguous rows, and marks
  the pad rows absent in the labels mask (the JAX package's pad-and-mask:
  the padded step computes exactly the unpadded loss);
* the optimizer step (nn/netbase.py `_step`) runs its loss as this rank's
  share of the global-batch loss (`mesh.data_parallel_scope`), takes its
  gradients by autograd, then `reduce_grads` sums them over the data
  axis **bucketed** (`CollectivePlan`): the leaves grouped in reverse
  order into ~`bucket_bytes` flat buffers, one all-reduce each. A sum of
  the same terms in the same per-element order does not depend on how
  the buffer is cut, so at two ranks the bucketed reduction is
  bit-identical to the monolithic one (`bucket_bytes=0`, one buffer);
* `grad_dtype="bf16"` casts each bucket to bf16 before the all-reduce and
  back after, halving the wire bytes (`allreduce_bytes_total`). Never the
  default.

The score a listener sees is the global loss: each rank's share is summed
in the last bucket's buffer (its own f32 all-reduce when the wire is bf16,
which would round it).

What the JAX module has and this one does not: `jit_step`,
`tree_shardings` and buffer donation. The port runs its step eagerly (a
CUDA graph on the card, nn/netbase.py `_run_fused`), so there is no
program to give in-shardings or donated arguments. The reduction does not
overlap the backward yet: it runs after `torch.autograd.grad` returns.
"""

from __future__ import annotations

import os
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.parallel import mesh as _mesh
from deeplearning4j_tpu_torch.parallel.mesh import DATA_AXIS, data_shards

# DDP-style default bucket size: a ResNet-50-class gradient splits into
# ~25 buckets, and each collective's launch latency stays amortized
DEFAULT_BUCKET_BYTES = 4 << 20

# The estimate's denominator: one device's link bandwidth each way, by
# the name nvidia-smi gives the card. H100 SXM: NVLink 4, 18 links, 900
# GB/s in both directions together (NVIDIA H100 data sheet). A figure,
# not a measurement: the sampled probe (`maybe_measure_collective`) is its
# falsifier.
LINK_BYTES_PER_S = (("H100 PCIe", None), ("H100", 450e9))


def auto_mesh_enabled() -> bool:
    """Should `fit()` attach a data-parallel mesh by itself when a process
    group of more than one rank is up? Default yes; `DL4J_AUTO_MESH=0`
    disables (read per fit)."""
    return os.environ.get("DL4J_AUTO_MESH", "1") not in ("0", "false", "no")


def default_bucket_bytes() -> int:
    """The gradient-bucket size: `DL4J_GRAD_BUCKET_BYTES` (0 = one
    monolithic buffer), else the 4 MiB default."""
    env = os.environ.get("DL4J_GRAD_BUCKET_BYTES")
    if env is not None:
        return int(env)
    return DEFAULT_BUCKET_BYTES


def default_sample_every() -> int:
    """Every how many sharded steps the collective probe is timed (0 =
    never): `DL4J_DEVPROF_SAMPLE_EVERY`, the JAX package's knob, default
    16."""
    return int(os.environ.get("DL4J_DEVPROF_SAMPLE_EVERY", "16"))


def link_bytes_per_s(device: Optional[torch.device]) -> Optional[float]:
    """One device's link bandwidth each way from LINK_BYTES_PER_S, or None
    for a device the table does not know (the CPU included)."""
    if device is None or device.type != "cuda":
        return None
    name = torch.cuda.get_device_name(device)
    for key, rate in LINK_BYTES_PER_S:
        if key in name:
            return rate
    return None


def _dtype_name(dt: torch.dtype) -> str:
    return str(dt).replace("torch.", "")


class CollectivePlan:
    """Bucketed gradient-reduction schedule over one net's gradient leaves.

    Buckets are assigned in REVERSE leaf order (the leaves are in layer
    order, so the output head's gradients come first, as the backward
    finishes them). A bucket holds consecutive same-dtype leaves up to
    ~`bucket_bytes` of wire payload and is reduced as ONE flat buffer; a
    leaf that is not replicated (split by tensor parallelism) stays out of
    the buckets and is reduced alone. `grad_dtype="bf16"` prices the wire
    at 2 bytes an element."""

    def __init__(self, buckets: List[dict], unbucketed: List[int],
                 n_leaves: int, bucket_bytes: int, grad_dtype: Optional[str]):
        self.buckets = buckets          # [{"leaves": [flat idx], "bytes", "dtype"}]
        self.unbucketed = unbucketed    # flat leaf indices reduced alone
        self.n_leaves = n_leaves
        self.bucket_bytes = bucket_bytes
        self.grad_dtype = grad_dtype or "f32"

    @classmethod
    def build(cls, leaves, replicated_flags, bucket_bytes: int,
              grad_dtype: Optional[str]) -> "CollectivePlan":
        """`leaves`: tensors (or anything with .dtype and .numel()) in the
        JAX package's tree order; `replicated_flags[i]` False for a leaf
        tensor parallelism split."""
        bf16 = grad_dtype == "bf16"
        buckets: List[dict] = []
        unbucketed: List[int] = []
        cur: List[int] = []
        cur_bytes = 0
        cur_dtype = None

        def flush():
            nonlocal cur, cur_bytes, cur_dtype
            if cur:
                buckets.append({"leaves": cur, "bytes": cur_bytes, "dtype": cur_dtype})
            cur, cur_bytes, cur_dtype = [], 0, None

        for i in reversed(range(len(leaves))):
            leaf = leaves[i]
            if not replicated_flags[i]:
                unbucketed.append(i)
                continue
            dt = _dtype_name(leaf.dtype)
            nb = int(leaf.numel()) * (2 if bf16 else leaf.element_size())
            if cur and (dt != cur_dtype or cur_bytes + nb > max(1, bucket_bytes)):
                flush()
            cur.append(i)
            cur_bytes += nb
            cur_dtype = dt
        flush()
        return cls(buckets, unbucketed, len(leaves), bucket_bytes, grad_dtype)

    def wire_bytes(self) -> int:
        return sum(b["bytes"] for b in self.buckets)

    def describe(self) -> dict:
        return {
            "bucket_bytes": self.bucket_bytes,
            "grad_dtype": self.grad_dtype,
            "n_buckets": len(self.buckets),
            "bucketed_leaves": sum(len(b["leaves"]) for b in self.buckets),
            "unbucketed_leaves": len(self.unbucketed),
            "wire_bytes_per_step": self.wire_bytes(),
            "bucket_sizes_bytes": [b["bytes"] for b in self.buckets],
        }


def _tree_tensors(tree):
    """Tensors of a list of (dicts of) tensors or nested dicts, in the JAX
    package's tree order (dict keys sorted)."""
    if torch.is_tensor(tree):
        yield tree
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _tree_tensors(tree[k])
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tree_tensors(v)


class MeshPlan:
    """Data-parallel plan of one net over one `Mesh`: placement, batch
    sharding, the bucketed gradient reduction and its books
    (`allreduce_bytes_total`, `train_step_collective_seconds`)."""

    def __init__(self, mesh: _mesh.Mesh, *, bucket_bytes: Optional[int] = None,
                 grad_dtype: Optional[str] = None, sample_every: Optional[int] = None):
        if DATA_AXIS not in mesh.axis_names:
            raise ValueError(
                f"mesh axes {mesh.axis_names} have no '{DATA_AXIS}' axis — "
                "the sharded train step needs one to split the batch over")
        if grad_dtype not in (None, "f32", "bf16"):
            raise ValueError(f"grad_dtype must be 'f32' or 'bf16', got {grad_dtype!r}")
        self.mesh = mesh
        self.n_data_shards = data_shards(mesh)
        self.data_index = mesh.axis_index(DATA_AXIS)
        self.bucket_bytes = (default_bucket_bytes() if bucket_bytes is None
                             else int(bucket_bytes))
        self.grad_dtype = "f32" if grad_dtype is None else grad_dtype
        self.sample_every = (default_sample_every() if sample_every is None
                             else int(sample_every))
        # pad-up-to target: the largest shard-divisible batch seen this fit,
        # so a short tail keeps the full batches' shapes
        self._pad_target = 0
        self._payload_bytes: Optional[int] = None
        self._cplan: Optional[CollectivePlan] = None
        self._leaf_keys: Optional[List[Tuple[int, str]]] = None
        self._probe = None
        self._probe_steps = 0

    # -- placement -----------------------------------------------------------

    def is_writer(self) -> bool:
        """Whether this rank writes the net's files (checkpoints, zips):
        global rank 0 only."""
        return self.mesh.rank == 0

    def place_net(self, net) -> "MeshPlan":
        """Broadcast the first data rank's params, layer state and updater
        state over the data axis, in place (the tensors keep their
        addresses), one flat buffer per dtype and device."""
        tensors = list(_tree_tensors([net.params_list, net.state_list, net.upd_state]))
        by_kind = {}
        for t in tensors:
            by_kind.setdefault((t.dtype, t.device), []).append(t)
        with torch.no_grad():
            for ts in by_kind.values():
                flat = torch.cat([t.reshape(-1) for t in ts])
                _mesh.broadcast_(flat, self.mesh, DATA_AXIS)
                off = 0
                for t in ts:
                    n = t.numel()
                    t.copy_(flat[off:off + n].view_as(t))
                    off += n
        self.invalidate()
        return self

    def invalidate(self) -> None:
        """Forget the cached leaf set, schedule, payload and probe (the
        step's leaves changed: a sentinel attached, params rebound)."""
        self._payload_bytes = None
        self._cplan = None
        self._leaf_keys = None
        self._probe = None

    def capturable(self) -> bool:
        """Whether the step's collectives can be captured in a CUDA graph:
        NCCL's can (once its communicator is warm), gloo's cannot; a
        one-rank data axis issues none."""
        return self.n_data_shards <= 1 or self.mesh.backend == "nccl"

    # -- batch sharding --------------------------------------------------------

    def reset_pad_target(self) -> None:
        """Per-fit state: a later fit with smaller batches must not keep
        padding to the old size."""
        self._pad_target = 0

    def shard_batch(self, ds):
        """This rank's rows of a global batch (DataSet or MultiDataSet, host
        arrays or tensors). A batch not divisible by the shard count is
        padded to the next multiple (or to the largest batch of this fit)
        by WRAPPING examples, and the pad rows get an all-zero labels-mask
        row; a labels mask of ones is supplied for full batches too, so
        that every batch of a fit has one signature. Wrapped pad rows still
        enter the batch-norm statistics, as in the JAX package.
        `reported_examples` keeps the real global count for the books."""
        from deeplearning4j_tpu_torch.data.dataset import DataSet, MultiDataSet

        if getattr(ds, "_mesh_sharded", False):
            return ds
        n = ds.num_examples()
        R = self.n_data_shards
        target = max(n + ((-n) % R), self._pad_target)
        self._pad_target = target
        b = target // R
        rows = np.arange(self.data_index * b, (self.data_index + 1) * b) % n

        def take(a):
            if a is None:
                return None
            if torch.is_tensor(a):
                return a.index_select(0, torch.as_tensor(rows, device=a.device))
            return np.asarray(a)[rows]

        present = (np.arange(self.data_index * b, (self.data_index + 1) * b) < n)

        def lmask(lm):
            if lm is None:
                return present.astype(np.float32)
            out = take(lm)
            if present.all():
                return out
            keep = present.reshape((-1,) + (1,) * (out.ndim - 1))
            if torch.is_tensor(out):
                return out * torch.as_tensor(keep, device=out.device).to(out.dtype)
            return out * keep.astype(out.dtype)

        if isinstance(ds, MultiDataSet):
            lms = ds.labels_masks if ds.labels_masks is not None else [None] * len(ds.labels)
            out = MultiDataSet(
                [take(f) for f in ds.features], [take(l) for l in ds.labels],
                None if ds.features_masks is None else [take(m) for m in ds.features_masks],
                [lmask(m) for m in lms])
        else:
            out = DataSet(take(ds.features), take(ds.labels), take(ds.features_mask),
                          lmask(ds.labels_mask))
        out.reported_examples = getattr(ds, "reported_examples", None) or n
        out._mesh_sharded = True
        return out

    # -- the bucketed reduction ----------------------------------------------

    def _leaves(self, net) -> List[Tuple[int, str]]:
        """(layer, name) of every leaf the step reduces, in the JAX
        package's tree order (layers in order, names sorted): the leaves
        autograd takes (`net._norm_keys()`; a frozen layer has none)."""
        if self._leaf_keys is None:
            self._leaf_keys = [(i, k) for i, ks in enumerate(net._norm_keys())
                               for k in sorted(ks)]
        return self._leaf_keys

    def _replicated_leaf(self, net, i: int, k: str) -> bool:
        specs = getattr(net, "_tp_specs", None)
        return not (specs and specs[i] and specs[i].get(k))

    def collective_plan(self, net) -> Optional[CollectivePlan]:
        """The bucket schedule (cached for the net's leaves). None when
        bucketing is off (`bucket_bytes=0` and an f32 wire): then one
        monolithic buffer a dtype."""
        if self.bucket_bytes <= 0 and self.grad_dtype != "bf16":
            return None
        if self._cplan is None:
            keys = self._leaves(net)
            leaves = [net.params_list[i][k] for i, k in keys]
            flags = [self._replicated_leaf(net, i, k) for i, k in keys]
            # bucket_bytes=0 with a bf16 wire: one bucket a leaf
            bb = self.bucket_bytes if self.bucket_bytes > 0 else 1
            self._cplan = CollectivePlan.build(leaves, flags, bb, self.grad_dtype)
        return self._cplan

    def _schedule(self, net) -> Tuple[List[List[int]], List[int]]:
        """(buckets as lists of leaf indices, leaves reduced alone)."""
        cplan = self.collective_plan(net)
        if cplan is not None:
            return [b["leaves"] for b in cplan.buckets], cplan.unbucketed
        keys = self._leaves(net)
        alone = [j for j, (i, k) in enumerate(keys) if not self._replicated_leaf(net, i, k)]
        by_dtype = {}
        for j in reversed(range(len(keys))):
            if j not in alone:
                i, k = keys[j]
                by_dtype.setdefault(net.params_list[i][k].dtype, []).append(j)
        return list(by_dtype.values()), alone

    def reduce_grads(self, net, grads, score: torch.Tensor):
        """Sum `grads` (a list of per-layer dicts, the step's raw gradients)
        and the step's loss share `score` over the data axis. Per bucket:
        one flat buffer, cast to bf16 if the wire is bf16, one all-reduce,
        cast back, split into the leaves; a lone contiguous f32 leaf is
        reduced in place, without the copy. The score rides in the last bucket's
        buffer when that buffer is f32. Returns (grads, global score).
        The train step calls it only when the data axis has more than one
        rank; called directly on a one-rank process group it still issues
        its all-reduces (each the identity)."""
        mesh = self.mesh
        keys = self._leaves(net)
        buckets, alone = self._schedule(net)
        bf16 = self.grad_dtype == "bf16"
        score_done = False
        with torch.no_grad():
            for bi, idxs in enumerate(buckets):
                parts = [grads[keys[j][0]][keys[j][1]] for j in idxs]
                last = bi == len(buckets) - 1
                rides = (last and not bf16 and parts[0].dtype == torch.float32
                         and score.device == parts[0].device)
                if len(parts) == 1 and not bf16 and not rides and parts[0].is_contiguous():
                    _mesh.all_reduce_(parts[0], mesh, DATA_AXIS, site="grads")
                    continue
                # else one flat buffer: a lone leaf that is not contiguous
                # (a cuDNN conv's weight gradient through the HWIO view) is
                # copied too, since collectives take contiguous tensors
                flat = [p.reshape(-1) for p in parts]
                if rides:
                    flat.append(score.float().reshape(1))
                buf = torch.cat(flat)
                acc = buf.dtype
                if bf16 and acc != torch.bfloat16:
                    buf = buf.to(torch.bfloat16)
                _mesh.all_reduce_(buf, mesh, DATA_AXIS, site="grads")
                if buf.dtype != acc:
                    buf = buf.to(acc)
                off = 0
                for j, p in zip(idxs, parts):
                    n = p.numel()
                    grads[keys[j][0]][keys[j][1]] = buf[off:off + n].view_as(p)
                    off += n
                if rides:
                    score = buf[off].to(score.dtype)
                    score_done = True
            for j in alone:
                _mesh.all_reduce_(grads[keys[j][0]][keys[j][1]], mesh, DATA_AXIS,
                                  site="grads")
            if not score_done:
                s = score.float().reshape(1).clone()
                _mesh.all_reduce_(s, mesh, DATA_AXIS, site="score")
                score = s[0].to(score.dtype)
        return grads, score

    # -- collective accounting ---------------------------------------------

    def grad_payload_bytes(self, net) -> int:
        """All-reduce wire payload of ONE optimizer step: the reduced
        gradient leaves' bytes at the wire dtype (the f32 parameter bytes;
        half under `grad_dtype="bf16"`)."""
        if self._payload_bytes is None:
            bf16 = self.grad_dtype == "bf16"
            self._payload_bytes = sum(
                net.params_list[i][k].numel()
                * (2 if bf16 else net.params_list[i][k].element_size())
                for i, k in self._leaves(net))
        return self._payload_bytes

    def collective_seconds_estimate(self, net) -> Optional[float]:
        """ESTIMATE of one step's gradient all-reduce time: a ring moves
        2(n-1)/n of the wire payload over each device's link
        (LINK_BYTES_PER_S). None for a device the table does not know —
        the CPU, or two ranks on one card, where no link is crossed."""
        n = self.n_data_shards
        if n <= 1:
            return 0.0
        rate = link_bytes_per_s(getattr(net, "device", None))
        if rate is None:
            return None
        return 2.0 * (n - 1) / n * self.grad_payload_bytes(net) / rate

    def _collective_probe(self, net):
        """Zero buffers with the live bucket schedule's sizes and wire
        dtypes, on the net's device: reducing them is the step's gradient
        reduction alone."""
        if self._probe is None:
            bufs = []
            cplan = self.collective_plan(net)
            if cplan is not None:
                for b in cplan.buckets:
                    dt = torch.bfloat16 if cplan.grad_dtype == "bf16" else getattr(
                        torch, b["dtype"])
                    bufs.append(torch.zeros(max(1, b["bytes"] // dt.itemsize),
                                            dtype=dt, device=net.device))
            else:
                bufs.append(torch.zeros(max(1, self.grad_payload_bytes(net) // 4),
                                        dtype=torch.float32, device=net.device))
            self._probe = bufs
        return self._probe

    def _sync(self, net) -> None:
        if net.device.type == "cuda":
            torch.cuda.synchronize(net.device)

    def maybe_measure_collective(self, net, n_steps: int) -> Optional[float]:
        """Sampled MEASUREMENT: every `sample_every`-th sharded step, time
        one blocking run of the probe's all-reduces and attribute it to
        every step since the last sample. None off-sample. Every rank
        samples at the same steps (the probe is itself a collective)."""
        if self.n_data_shards <= 1 or not self.sample_every:
            return None
        self._probe_steps += int(n_steps)
        if self._probe_steps < self.sample_every:
            return None
        covered, self._probe_steps = self._probe_steps, 0
        bufs = self._collective_probe(net)
        self._sync(net)
        t0 = time.perf_counter()
        for b in bufs:
            _mesh.all_reduce_(b.zero_(), self.mesh, DATA_AXIS, site="probe")
        self._sync(net)
        return (time.perf_counter() - t0) * covered

    def describe(self) -> dict:
        return {"devices": self.mesh.size, "axes": dict(self.mesh.shape),
                "data_shards": self.n_data_shards, "transport": self.mesh.backend}

    def collective_describe(self, net) -> dict:
        """The collective schedule: bucket count and sizes, wire dtype and
        bytes, the ring estimate, and the transport."""
        cplan = self.collective_plan(net)
        est = self.collective_seconds_estimate(net)
        out = {
            "mode": "monolithic" if cplan is None else "bucketed",
            "grad_dtype": self.grad_dtype,
            "wire_bytes_per_step": self.grad_payload_bytes(net),
            "ring_estimate_seconds": None if est is None else round(est, 6),
            "transport": self.mesh.backend,
        }
        if cplan is not None:
            out.update(cplan.describe())
        return out

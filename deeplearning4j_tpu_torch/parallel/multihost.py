"""Multi-host data parallelism (the reference's cluster story).

The port of the JAX package's parallel/multihost.py. Reference
transports: Spark parameter averaging and the Aeron parameter server.
Here every host runs one process a device, all join one
`torch.distributed` job over TCP, and the data-parallel step sums the
gradients every step over the job's mesh: no coordinating process, no
broadcast loop, no tree aggregation. The host-side contract is about DATA: each process
feeds its own shard of the global batch.

Run one process a device on every host:

    initialize_distributed("tcp://host0:port", world_size, rank)
    mesh = global_data_parallel_mesh()
    trainer = MultiHostDataParallel(net, mesh)
    trainer.fit_local_shards(local_iter, epochs=3)
"""

from __future__ import annotations

from deeplearning4j_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    Mesh,
    data_parallel_mesh,
    initialize_distributed,
    n_devices,
)
from deeplearning4j_tpu_torch.parallel.sharded import MeshPlan
from deeplearning4j_tpu_torch.parallel.wrapper import ParallelWrapper

__all__ = ["initialize_distributed", "global_data_parallel_mesh", "MultiHostMeshPlan",
           "MultiHostDataParallel"]


def global_data_parallel_mesh() -> Mesh:
    """1-D "data" mesh over every rank of every host."""
    return data_parallel_mesh()


class MultiHostMeshPlan(MeshPlan):
    """MeshPlan where each process feeds its LOCAL shard: the batch a rank
    pulls is already its rows of the global batch, so nothing is cut or
    padded. Every process must fit the same number of equally shaped
    local batches an epoch (the SPMD contract); the loss divides by the
    present count summed over the data axis."""

    def shard_batch(self, ds):
        if getattr(ds, "_mesh_sharded", False):
            return ds
        local_shards = self.n_data_shards // n_devices() or 1
        n_local = ds.num_examples()
        if n_local % local_shards != 0:
            raise ValueError(
                f"local batch of {n_local} examples does not divide this "
                f"process's {local_shards} shards; pad locally (multi-host "
                "pad-and-mask must be applied identically on every process)")
        ds.reported_examples = n_local * self.mesh.axis_size(DATA_AXIS)
        ds._mesh_sharded = True
        return ds


class MultiHostDataParallel(ParallelWrapper):
    """The ParallelWrapper facade over the job's mesh, NOT deprecated: it is
    the multi-host entry point; the step is the same data-parallel step
    (netbase.set_mesh with a MultiHostMeshPlan)."""

    def _make_plan(self, mesh):
        return MultiHostMeshPlan(mesh)

    def fit_local_shards(self, iterator, *, epochs: int = 1, async_prefetch: bool = False):
        """Train where `iterator` yields THIS process's shard of each global
        batch (global batch = world size x local batch)."""
        return self.fit(iterator, epochs=epochs, async_prefetch=async_prefetch)

"""ParallelWrapper — DEPRECATED facade over the data-parallel step.

The port of the JAX package's parallel/wrapper.py. Reference:
deeplearning4j-scaleout/.../parallelism/ParallelWrapper.java — N worker
threads each holding a model replica, parameter and updater-state
averaging every `averagingFrequency` iterations.

There is nothing left for a wrapper to do: `fit()` itself runs the
data-parallel step over the process mesh (nn/netbase.set_mesh +
parallel/sharded.MeshPlan), summing the gradients every step. With each
rank holding one shard of the global batch that is parameter averaging
with frequency 1:

    averaged params = mean_i (theta - lr g_i) = theta - lr mean_i(g_i)

Higher averaging frequencies are not reproduced. Construction attaches
the mesh plan to the model and `fit()` delegates to the model's own fit
loop. New code should call `net.set_mesh(mesh)` (or just `net.fit(...)`
under a process group of several ranks) and drop the wrapper.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from deeplearning4j_tpu_torch.data.iterators import DataSetIterator, StackedDataSetIterator
from deeplearning4j_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    all_gather,
    data_parallel_mesh,
    pad_wrap,
)


class ParallelWrapper:
    """Deprecated data-parallel trainer facade (see module doc).

    Args:
        model: an initialized (or initializable) MultiLayerNetwork or
            ComputationGraph.
        mesh: a `Mesh` with a "data" axis; defaults to a 1-D mesh over
            every rank.
        workers: how many iterator minibatches form one global step
            (reference: each DefaultTrainer consumed one minibatch
            between barriers). Default 1: the iterator's batches are
            already global.
        averaging_frequency: only 1 is meaningful, since the gradients
            are summed every step.
        prefetch_buffer: host prefetch depth.
    """

    def __init__(self, model, mesh=None, workers: int = 1,
                 averaging_frequency: int = 1, prefetch_buffer: int = 4):
        if averaging_frequency != 1:
            raise ValueError(
                "averaging_frequency > 1 is a CPU/PCIe-era tradeoff; the "
                "per-step gradient all-reduce used here is exact averaging "
                "with frequency=1 (see parallel/wrapper.py doc)")
        if type(self) is ParallelWrapper:  # subclasses (multihost) are not
            warnings.warn(
                "ParallelWrapper is deprecated: fit() runs the data-parallel "
                "step itself under a process group of several ranks — call "
                "net.set_mesh(mesh) (or nothing at all) instead",
                DeprecationWarning, stacklevel=2)
        self.model = model
        self.mesh = mesh if mesh is not None else data_parallel_mesh()
        self.workers = int(workers)
        self.prefetch_buffer = prefetch_buffer
        model._require_init()
        model.set_mesh(self.mesh, plan=self._make_plan(self.mesh))
        self.n_shards = model._mesh_plan.n_data_shards

    def _make_plan(self, mesh):
        """The MeshPlan to attach; None = the standard plan.
        MultiHostDataParallel overrides it."""
        return None

    def fit(self, data, labels=None, *, epochs: int = 1, batch_size: int = 128,
            async_prefetch: bool = True):
        """Train data-parallel through the model's own fit loop;
        `batch_size` is the GLOBAL batch. With workers > 1 and an
        iterator, each step consumes `workers` minibatches as one global
        batch. The model keeps its mesh plan afterwards."""
        net = self.model
        data_in = data
        if self.workers > 1:
            if not isinstance(data, DataSetIterator):
                raise ValueError("workers > 1 requires a DataSetIterator input")
            data_in = StackedDataSetIterator(data, self.workers)
        if net._mesh_plan is None or net._mesh_plan.mesh is not self.mesh:
            net.set_mesh(self.mesh, plan=self._make_plan(self.mesh))
        net.fit(data_in, labels, epochs=epochs, batch_size=batch_size,
                async_prefetch=async_prefetch, prefetch_buffer=self.prefetch_buffer)
        return net

    def output(self, x):
        """Data-parallel forward: the batch padded by wrapping to a
        multiple of the shard count, this rank's rows through the model,
        then every rank's rows gathered; every rank returns the whole
        result (the pad rows sliced off)."""
        xx = np.asarray(x)
        n = xx.shape[0]
        xx = pad_wrap(xx, self.n_shards)
        b = xx.shape[0] // self.n_shards
        i = self.mesh.axis_index(DATA_AXIS)
        out = self.model.output(xx[i * b:(i + 1) * b])
        with torch.no_grad():
            full = all_gather(out.contiguous(), self.mesh, DATA_AXIS)
        return full[:n]

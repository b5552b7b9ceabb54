"""The staged input pipeline.

The port of the JAX package's data/prefetch.py. Two stages that compose
with data/iterators.AsyncDataSetIterator into the feed a fit installs
under async_prefetch (nn/netbase._stage_input_pipeline):

  host ETL (N workers)  ->  device prefetch (1 worker)  ->  fit loop
  ParallelDataSetIterator   DevicePrefetchIterator          _fit_epochs

* `ParallelDataSetIterator`: N workers pull items from one shared base
  iterator, run the heavy `transform` (record decoding, host
  augmentation) and push into a bounded queue, reassembled in order
  (default) or in completion order.
* `DevicePrefetchIterator`: a worker thread copies each host batch to the
  device `depth` batches ahead of the step. On a CUDA device it stages
  through pinned host memory with non-blocking copies on a side stream,
  runs the on-device `transform` (data/transforms.DeviceBatchTransform)
  there, and records one event per batch; the consumer's stream waits on
  the event, and every staged tensor is `record_stream`ed on it so the
  caching allocator does not reuse its memory while the step still reads
  it. Batches come out marked `_pipeline_staged`: the fit loop applies
  no transform of its own to them.

Every stage reports batches, bytes, stalls and queue depth as
`input_pipeline_*{stage=...}` in the shared registry. Shutdown: ending,
breaking out of, or erroring out of an epoch closes that epoch's workers
(the generator's `finally`); `close()` tears down anything still live.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Callable, List, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.common.devices import resolve_device
from deeplearning4j_tpu_torch.data.dataset import DataSet, MultiDataSet
from deeplearning4j_tpu_torch.data.iterators import (
    PIPELINE_THREAD_PREFIX,
    DataSetIterator,
    _close_run,
    _get_abortable,
    _put_abortable,
)
from deeplearning4j_tpu_torch.utils import faultpoints as _faults
from deeplearning4j_tpu_torch.utils import health as _health
from deeplearning4j_tpu_torch.utils import metrics as _metrics
from deeplearning4j_tpu_torch.utils import tracing as _tracing

_DONE = object()  # one per ETL worker: "this worker's stream is finished"


def _stage_instruments(stage: str) -> dict:
    """Per-stage pipeline instruments, resolved once per iterator."""
    reg = _metrics.get_registry()
    batches = reg.counter(
        "input_pipeline_batches_total",
        "batches emitted by each input-pipeline stage", ("stage",))
    nbytes = reg.counter(
        "input_pipeline_bytes_total",
        "host bytes emitted by each input-pipeline stage", ("stage",))
    stall = reg.histogram(
        "input_pipeline_stall_seconds",
        "time an input-pipeline stage spent blocked on its queue "
        "(producer: queue full; consumer: queue empty)",
        ("stage", "side"))
    depth = reg.gauge(
        "input_pipeline_depth",
        "current fill of each input-pipeline stage's queue", ("stage",))
    return {
        "batches": batches.labels(stage),
        "bytes": nbytes.labels(stage),
        "producer_stall": stall.labels(stage, "producer"),
        "consumer_stall": stall.labels(stage, "consumer"),
        "depth": depth.labels(stage),
    }


def _ds_arrays(ds) -> list:
    if isinstance(ds, MultiDataSet):
        return list(ds.features) + list(ds.labels) \
            + list(ds.features_masks or []) + list(ds.labels_masks or [])
    if isinstance(ds, DataSet):
        return [ds.features, ds.labels, ds.features_mask, ds.labels_mask]
    return []


def _ds_nbytes(ds) -> int:
    """Byte accounting for the stage metrics; items that are not DataSets
    count 0."""
    return sum(int(getattr(a, "nbytes", 0)) for a in _ds_arrays(ds) if a is not None)


def _carry_metadata(src, dst):
    """Propagate the bookkeeping a staging step must not drop: the staged
    marker, and a mesh-sharded batch's marker and real global example
    count (parallel/sharded.MeshPlan.shard_batch). Every stage that
    rebuilds a DataSet routes through here (transforms.py too)."""
    for name in ("_pipeline_staged", "_mesh_sharded", "reported_examples"):
        v = getattr(src, name, None)
        if v:
            setattr(dst, name, v)
    return dst


def place_dataset(ds, device):
    """Every array of a DataSet/MultiDataSet as a tensor on `device`.
    Host arrays bound for a CUDA device go through pinned memory with a
    non-blocking copy on the current stream; tensors already there pass
    through."""
    device = torch.device(device)

    def put(a):
        if a is None:
            return None
        t = a if torch.is_tensor(a) else torch.from_numpy(np.ascontiguousarray(a))
        if t.device == device:
            return t
        if device.type == "cuda" and t.device.type == "cpu":
            return t.pin_memory().to(device, non_blocking=True)
        return t.to(device)

    if isinstance(ds, MultiDataSet):
        out = MultiDataSet(
            [put(f) for f in ds.features], [put(y) for y in ds.labels],
            None if ds.features_masks is None else [put(m) for m in ds.features_masks],
            None if ds.labels_masks is None else [put(m) for m in ds.labels_masks])
    else:
        out = DataSet(put(ds.features), put(ds.labels),
                      put(ds.features_mask), put(ds.labels_mask))
    return _carry_metadata(ds, out)


class ParallelDataSetIterator(DataSetIterator):
    """Multi-worker ETL over one base iterator.

    `base` yields work items: DataSets, or raw records that `transform`
    turns into DataSets. Workers share the base under a lock (the pull is
    cheap; `transform` runs unlocked, in parallel) and push into a
    bounded queue; the consumer reassembles. ordered=True (default):
    batches come out in base order (a reorder buffer holds early
    arrivals), and an item whose transform raised surfaces at its
    position. ordered=False: completion order. Exceptions reach the
    consumer."""

    def __init__(self, base, transform: Optional[Callable] = None,
                 workers: int = 2, queue_size: Optional[int] = None,
                 ordered: bool = True, stage: str = "etl",
                 health_stall_after: float = 120.0):
        self.base = base
        self.transform = transform
        self.workers = max(1, int(workers))
        self.queue_size = max(self.workers, int(queue_size)
                              if queue_size is not None else 2 * self.workers)
        self.ordered = ordered
        self.stage = stage
        self.health_stall_after = health_stall_after
        self._ins = _stage_instruments(stage)
        self._active: List[tuple] = []

    def __iter__(self):
        src = iter(self.base)
        src_lock = threading.Lock()
        seq_box = [0]
        q: "queue.Queue" = queue.Queue(maxsize=self.queue_size)
        stop = threading.Event()
        ins = self._ins
        trace_ctx = _tracing.current_context()
        # one heartbeat for all workers: each holds a busy slot while it
        # owns an item, so one wedged worker is not masked by its siblings
        hb = _health.get_health().register(
            f"pipeline_{self.stage}", stall_after=self.health_stall_after)

        def worker():
            while not stop.is_set():
                seq = None
                try:
                    with src_lock:
                        with hb.busy():
                            try:
                                item = next(src)
                            except StopIteration:
                                return
                            seq = seq_box[0]
                            seq_box[0] += 1
                    with hb.busy():
                        _faults.fault_point("etl_worker", stage=self.stage)
                        out = self.transform(item) if self.transform else item
                except BaseException as e:
                    # seq None: the BASE iterator raised; deliver at once
                    _put_abortable(q, (-1 if seq is None else seq, e, None), stop)
                    return
                t0 = time.perf_counter()
                if not _put_abortable(q, (seq, None, out), stop):
                    return
                ins["producer_stall"].observe(time.perf_counter() - t0)
                ins["batches"].inc()
                ins["bytes"].inc(_ds_nbytes(out))

        def worker_main():
            _tracing.attach(trace_ctx)
            try:
                worker()
            finally:
                _put_abortable(q, _DONE, stop)

        threads = [threading.Thread(target=worker_main, daemon=True,
                                    name=f"{PIPELINE_THREAD_PREFIX}-etl-{i}")
                   for i in range(self.workers)]
        run = (q, stop, threads)
        self._active.append(run)
        ins["depth"].set_function(q.qsize)
        for t in threads:
            t.start()
        try:
            yield from self._reassemble(q, stop, ins)
        finally:
            _close_run(q, stop, threads)
            _health.get_health().unregister(hb)
            if run in self._active:
                self._active.remove(run)

    def _reassemble(self, q, stop, ins):
        done, buf, nxt = 0, {}, 0
        while done < self.workers:
            t0 = time.perf_counter()
            item = _get_abortable(q, stop)
            ins["consumer_stall"].observe(time.perf_counter() - t0)
            if item is None:  # aborted by an external close()
                return
            if item is _DONE:
                done += 1
                continue
            seq, err, out = item
            if not self.ordered:
                if err is not None:
                    raise err
                yield out
                continue
            if seq < 0:  # the base iterator failed: no position
                raise err
            buf[seq] = (err, out)
            while nxt in buf:
                e, o = buf.pop(nxt)
                nxt += 1
                if e is not None:
                    raise e
                yield o
        # each worker put its items before its _DONE marker: what remains
        # buffered is complete
        for seq in sorted(buf):
            e, o = buf[seq]
            if e is not None:
                raise e
            yield o

    def close(self):
        for q, stop, threads in list(self._active):
            _close_run(q, stop, threads)
        self._active.clear()

    def reset(self):
        self.close()
        if hasattr(self.base, "reset"):
            self.base.reset()

    def batch_size(self):
        bs = getattr(self.base, "batch_size", None)
        return bs() if callable(bs) else None

    def total_examples(self):
        te = getattr(self.base, "total_examples", None)
        return te() if callable(te) else None

    # the resume protocol goes to the base: ETL workers hold no position
    def state(self):
        st = getattr(self.base, "state", None)
        return st() if callable(st) else None

    def restore_state(self, state):
        rs = getattr(self.base, "restore_state", None)
        if callable(rs):
            rs(state)


class DevicePrefetchIterator(DataSetIterator):
    """Device staging `depth` batches ahead of the fit loop (see the
    module docstring). `device` defaults to "cuda", as the port's entry
    points do; `transform` (ds -> ds, e.g. DeviceBatchTransform) runs on
    the staged batch in the worker. Device memory bound: depth + 1
    staged batches in flight."""

    def __init__(self, base, depth: int = 2, device=None,
                 transform: Optional[Callable] = None,
                 close_base: bool = False, stage: str = "device_prefetch",
                 health_stall_after: float = 120.0):
        self.base = base
        self.depth = max(1, int(depth))
        self.device = resolve_device(device)
        self.transform = transform
        self.close_base = close_base
        self.stage = stage
        self.health_stall_after = health_stall_after
        self._ins = _stage_instruments(stage)
        self._active: List[tuple] = []
        self._stream = None
        self._sentinel = object()

    def _stage(self, ds, stream):
        """(staged batch, its event or None)."""
        if getattr(ds, "_pipeline_staged", False):
            return ds, None  # staged upstream already
        # chaos hook: `error` is a failed host->device copy, `hang` one
        # that never returns (the heartbeat's stale busy slot)
        _faults.fault_point("device_put", stage=self.stage)
        if stream is None:
            out = place_dataset(ds, self.device)
            if self.transform is not None:
                out = _carry_metadata(out, self.transform(out))
            event = None
        else:
            with torch.cuda.stream(stream):
                out = place_dataset(ds, self.device)
                if self.transform is not None:
                    out = _carry_metadata(out, self.transform(out))
                event = torch.cuda.Event()
                event.record(stream)
        out._pipeline_staged = True
        return out, event

    def __iter__(self):
        q: "queue.Queue" = queue.Queue(maxsize=self.depth)
        stop = threading.Event()
        err: List[BaseException] = []
        ins = self._ins
        sentinel = self._sentinel
        cuda = self.device.type == "cuda"
        if cuda and self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        stream = self._stream if cuda else None
        trace_ctx = _tracing.current_context()
        hb = _health.get_health().register(
            self.stage, stall_after=self.health_stall_after)

        def worker():
            _tracing.attach(trace_ctx)
            try:
                it = iter(self.base)
                while True:
                    with hb.busy():
                        try:
                            ds = next(it)
                        except StopIteration:
                            return
                        nb = _ds_nbytes(ds)  # host bytes, before staging
                        with _tracing.span("prefetch/stage", stage=self.stage):
                            item = self._stage(ds, stream)
                    t0 = time.perf_counter()
                    if not _put_abortable(q, item, stop):
                        return
                    ins["producer_stall"].observe(time.perf_counter() - t0)
                    ins["batches"].inc()
                    ins["bytes"].inc(nb)
            except BaseException as e:
                err.append(e)
            finally:
                _put_abortable(q, sentinel, stop)

        t = threading.Thread(target=worker, daemon=True,
                             name=f"{PIPELINE_THREAD_PREFIX}-device-prefetch")
        run = (q, stop, [t])
        self._active.append(run)
        ins["depth"].set_function(q.qsize)
        t.start()
        try:
            while True:
                t0 = time.perf_counter()
                item = _get_abortable(q, stop)
                ins["consumer_stall"].observe(time.perf_counter() - t0)
                if item is None or item is sentinel:
                    if err:
                        raise err[0]
                    return
                staged, event = item
                if event is not None:
                    cur = torch.cuda.current_stream(self.device)
                    cur.wait_event(event)
                    for a in _ds_arrays(staged):
                        if torch.is_tensor(a) and a.is_cuda:
                            a.record_stream(cur)
                yield staged
        finally:
            _close_run(q, stop, [t])
            _health.get_health().unregister(hb)
            if run in self._active:
                self._active.remove(run)

    def close(self):
        for q, stop, threads in list(self._active):
            _close_run(q, stop, threads)
        self._active.clear()
        if self.close_base:
            self.base.close()

    def reset(self):
        self.base.reset()

    def batch_size(self):
        return self.base.batch_size()

    def total_examples(self):
        return self.base.total_examples()

    def state(self):
        st = getattr(self.base, "state", None)
        return st() if callable(st) else None

    def restore_state(self, state):
        rs = getattr(self.base, "restore_state", None)
        if callable(rs):
            rs(state)

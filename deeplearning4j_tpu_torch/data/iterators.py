"""DataSet iterators.

The port of the JAX package's data/iterators.py host iterators
(reference: datasets/iterator/): the DataSetIterator SPI,
ListDataSetIterator and ExistingDataSetIterator, the
MultiDataSetIterator SPI that ComputationGraph.fit also takes, and
AsyncDataSetIterator — the background-prefetch wrapper fit installs under
async_prefetch (reference: MultiLayerNetwork.java:1023-1025), the host
stage in front of data/prefetch.DevicePrefetchIterator.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator, List, Optional

import numpy as np

from deeplearning4j_tpu_torch.data.dataset import DataSet

# Every background thread the input pipeline starts carries this name
# prefix, so a test can assert that none outlives its fit.
PIPELINE_THREAD_PREFIX = "dl4j-pipeline"

# how often a blocked pipeline thread wakes to re-check its stop flag
_POLL_SECONDS = 0.05


def _put_abortable(q: "queue.Queue", item, stop: threading.Event) -> bool:
    """Bounded put that a consumer's departure cancels: re-checks `stop`
    every _POLL_SECONDS. False when the run was aborted: the producer
    must exit instead of filling a queue nobody drains."""
    while not stop.is_set():
        try:
            q.put(item, timeout=_POLL_SECONDS)
            return True
        except queue.Full:
            continue
    return False


def _get_abortable(q: "queue.Queue", stop: threading.Event):
    """The consumer's counterpart: blocks for the next item but re-checks
    `stop` while the queue is empty, so a `close()` from another thread
    ends the iteration. None on abort."""
    while True:
        try:
            return q.get(timeout=_POLL_SECONDS)
        except queue.Empty:
            if stop.is_set():
                return None


def _close_run(q: "queue.Queue", stop: threading.Event,
               threads: List[threading.Thread], timeout: float = 5.0):
    """Tear down one epoch's pipeline machinery: signal stop, drain the
    queue so that blocked producers wake at once, then join. Idempotent."""
    stop.set()
    try:
        while True:
            q.get_nowait()
    except queue.Empty:
        pass
    for t in threads:
        t.join(timeout=timeout)


_SENTINEL = object()


class DataSetIterator:
    """SPI: iterable over DataSet minibatches with reset().

    `state()`/`restore_state()` are the mid-epoch resume protocol: a
    small JSON-safe dict that reproduces an epoch from its start. The
    defaults declare the iterator stateless. `close()` releases
    background workers, if any; the plain host iterators have none."""

    def __iter__(self) -> Iterator[DataSet]:
        raise NotImplementedError

    def reset(self) -> None:
        pass

    def batch_size(self) -> Optional[int]:
        return None

    def total_examples(self) -> Optional[int]:
        return None

    def state(self) -> Optional[dict]:
        """JSON-safe epoch-reproduction state; None = stateless."""
        return None

    def restore_state(self, state: Optional[dict]) -> None:
        """Prime a fresh iterator with a `state()` capture."""

    def close(self) -> None:
        """Release background workers/queues, if any."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


class ListDataSetIterator(DataSetIterator):
    """Minibatches from in-memory arrays (reference:
    ListDataSetIterator / ExistingDataSetIterator)."""

    def __init__(self, dataset: DataSet, batch: int, shuffle: bool = False, seed: int = 0):
        self.dataset = dataset
        self.batch = batch
        self.shuffle = shuffle
        self._epoch = 0
        self.seed = seed

    def __iter__(self):
        n = self.dataset.num_examples()
        idx = np.arange(n)
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self._epoch)
            rng.shuffle(idx)
        self._epoch += 1
        for i in range(0, n, self.batch):
            yield self.dataset._rows(idx[i: i + self.batch])

    def batch_size(self):
        return self.batch

    def total_examples(self):
        return self.dataset.num_examples()

    def state(self):
        # the epoch counter seeds the shuffle permutation
        return {"epoch": int(self._epoch)}

    def restore_state(self, state):
        if state:
            self._epoch = int(state.get("epoch", 0))


class ExistingDataSetIterator(DataSetIterator):
    """Wraps any iterable of DataSets (reference: ExistingDataSetIterator)."""

    def __init__(self, datasets: Iterable[DataSet]):
        self._list: List[DataSet] = list(datasets)

    def __iter__(self):
        return iter(self._list)

    def total_examples(self):
        return sum(d.num_examples() for d in self._list)


class MultipleEpochsIterator(DataSetIterator):
    """Repeat an underlying iterator n times (reference:
    MultipleEpochsIterator.java)."""

    def __init__(self, epochs: int, base: DataSetIterator):
        self.epochs = epochs
        self.base = base

    def __iter__(self):
        for _ in range(self.epochs):
            self.base.reset()
            yield from self.base

    def batch_size(self):
        return self.base.batch_size()

    def state(self):
        return self.base.state()

    def restore_state(self, state):
        self.base.restore_state(state)


class StackedDataSetIterator(DataSetIterator):
    """Concatenate k consecutive minibatches into one global batch, as a
    data-parallel trainer turns per-worker batches into one sharded batch
    (reference: ParallelWrapper round-robin dispatch of one minibatch per
    DefaultTrainer, ParallelWrapper.java:389-404)."""

    def __init__(self, base: DataSetIterator, k: int):
        self.base = base
        self.k = max(1, int(k))

    def __iter__(self):
        pending: List[DataSet] = []
        for ds in self.base:
            pending.append(ds)
            if len(pending) == self.k:
                yield DataSet.concat(pending)
                pending = []
        if pending:
            yield DataSet.concat(pending)

    def reset(self):
        self.base.reset()

    def batch_size(self):
        b = self.base.batch_size()
        return None if b is None else b * self.k

    def total_examples(self):
        return self.base.total_examples()

    def state(self):
        return self.base.state()

    def restore_state(self, state):
        self.base.restore_state(state)


class MultiDataSetIterator:
    """SPI: iterable over MultiDataSet minibatches with reset()
    (reference: nd4j MultiDataSetIterator, consumed by
    ComputationGraph.fit)."""

    def __iter__(self):
        raise NotImplementedError

    def reset(self) -> None:
        pass

    def batch_size(self) -> Optional[int]:
        return None

    def total_examples(self) -> Optional[int]:
        return None

    def state(self) -> Optional[dict]:
        return None

    def restore_state(self, state: Optional[dict]) -> None:
        pass


class AsyncDataSetIterator(DataSetIterator):
    """Background-thread prefetch with a bounded queue (reference:
    AsyncDataSetIterator, queue capacity = the prefetch buffer): a worker
    thread pulls host batches while the device runs the previous step;
    exceptions reach the consumer. Breaking out of an epoch, or an
    exception unwinding the consumer, closes that epoch's worker (the
    generator's `finally`); `close()` tears down any still alive."""

    def __init__(self, base, queue_size: int = 4):
        self.base = base
        self.queue_size = max(1, int(queue_size))
        self._active: List[tuple] = []

    def __iter__(self):
        q: "queue.Queue" = queue.Queue(maxsize=self.queue_size)
        stop = threading.Event()
        err: List[BaseException] = []

        def worker():
            try:
                for ds in self.base:
                    if not _put_abortable(q, ds, stop):
                        return
            except BaseException as e:  # reaches the consumer
                err.append(e)
            finally:
                _put_abortable(q, _SENTINEL, stop)

        t = threading.Thread(target=worker, daemon=True,
                             name=f"{PIPELINE_THREAD_PREFIX}-async")
        run = (q, stop, t)
        self._active.append(run)
        t.start()
        try:
            while True:
                item = _get_abortable(q, stop)
                if item is None or item is _SENTINEL:
                    if err:
                        raise err[0]
                    return
                yield item
        finally:
            _close_run(q, stop, [t])
            if run in self._active:
                self._active.remove(run)

    def close(self):
        for q, stop, t in list(self._active):
            _close_run(q, stop, [t])
        self._active.clear()

    def reset(self):
        self.base.reset()

    def batch_size(self):
        return self.base.batch_size()

    def total_examples(self):
        return self.base.total_examples()

    def state(self):
        return self.base.state()

    def restore_state(self, state):
        self.base.restore_state(state)

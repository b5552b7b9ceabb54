"""Streaming ingestion (reference: deeplearning4j-scaleout/dl4j-streaming —
Kafka+Camel routes feeding NDArray batches into training), the port of
the JAX package's data/streaming.py.

Broker-agnostic: a StreamingDataSetIterator pulls
(features, labels) payloads from any source callable/iterable on a
background thread into a bounded buffer; training consumes DataSets at
device speed and blocks only when the stream lags. A Kafka/PubSub consumer
plugs in as the ``source`` — the framework sees the same iterator SPI the
rest of data/ uses."""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterable, Optional, Tuple, Union

import numpy as np

from deeplearning4j_tpu_torch.data.dataset import DataSet
from deeplearning4j_tpu_torch.data.iterators import (
    PIPELINE_THREAD_PREFIX,
    DataSetIterator,
    _close_run,
    _get_abortable,
    _put_abortable,
)

_SENTINEL = object()


class StreamingDataSetIterator(DataSetIterator):
    """Wraps a stream of (features, labels) into the DataSetIterator SPI.

    source: an iterable OR a zero-arg callable returning the next payload
            (None = end of stream). Payloads may be (x, y) tuples or
            DataSets.
    buffer_size: bounded prefetch depth — backpressure to the producer.
    """

    def __init__(self,
                 source: Union[Iterable, Callable[[], Optional[Tuple]]],
                 buffer_size: int = 16):
        self.source = source
        self.buffer_size = int(buffer_size)
        self._q: Optional[queue.Queue] = None
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._stop: Optional[threading.Event] = None

    def reset(self):
        """No-op: the fit loop resets after each epoch, which is legal at
        end-of-stream. Actually REUSING the iterator (epochs > 1, or a
        second fit) raises in __iter__ — a stream has no beginning to go
        back to (reference dl4j-streaming semantics)."""

    def _consumed_guard(self):
        if getattr(self, "_consumed", False):
            raise RuntimeError(
                "stream already consumed and cannot be reset; re-create "
                "the iterator with a new source")
        self._consumed = True

    def _pump(self):
        try:
            if callable(self.source):
                while not self._stop.is_set():
                    item = self.source()
                    if item is None:
                        break
                    if not _put_abortable(self._q, item, self._stop):
                        return
            else:
                for item in self.source:
                    if not _put_abortable(self._q, item, self._stop):
                        return
        except BaseException as e:  # surface in the consumer
            self._error = e
        finally:
            _put_abortable(self._q, _SENTINEL, self._stop)

    def __iter__(self):
        self._consumed_guard()
        self._q = queue.Queue(maxsize=self.buffer_size)
        self._error = None
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._pump, daemon=True,
            name=f"{PIPELINE_THREAD_PREFIX}-stream")
        self._thread.start()
        try:
            while True:
                item = _get_abortable(self._q, self._stop)
                if item is None or item is _SENTINEL:
                    if self._error is not None:
                        raise self._error
                    return
                if isinstance(item, DataSet):
                    yield item
                else:
                    x, y = item
                    yield DataSet(np.asarray(x), np.asarray(y))
        finally:
            # close-on-break: a consumer that stops mid-stream must not
            # leave the pump blocked on a full buffer forever
            _close_run(self._q, self._stop, [self._thread])

    def close(self):
        if self._thread is not None and self._stop is not None:
            _close_run(self._q, self._stop, [self._thread])

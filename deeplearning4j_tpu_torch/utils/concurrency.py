"""Abortable queue operations — the sanctioned shape for thread handoffs
(a stdlib copy of the JAX package's utils/concurrency.py).

The concurrency lint (analysis/lint.py, CC002) rejects bare `q.put(x)` /
`q.get()` in thread code: a blocking call with no timeout wedges forever
when the peer thread dies, which is exactly the leak class the data pipeline fixed by
hand in the data pipeline (data/iterators._put_abortable). These helpers
are the same poll-loop pattern, factored for the non-pipeline users
(serving collector/dispatcher, paramserver push client, UI remote
router): block in short timeouts and re-check an abort predicate between
polls, so a dead peer turns into a QueueAborted instead of a hung
thread.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Optional, Union

POLL_SECONDS = 0.25

AbortLike = Union[None, threading.Event, Callable[[], bool]]


class QueueAborted(RuntimeError):
    """An abortable queue op's abort predicate fired before the op
    completed — the peer is gone (or shutdown was requested)."""


def _as_predicate(abort: AbortLike) -> Optional[Callable[[], bool]]:
    if abort is None:
        return None
    if isinstance(abort, threading.Event):
        return abort.is_set
    return abort


def get_abortable(q: "queue.Queue", abort: AbortLike = None,
                  poll: float = POLL_SECONDS):
    """Blocking `q.get()` that re-checks `abort` every `poll` seconds.
    Raises QueueAborted when the predicate fires while the queue is
    empty; items already queued always win over the abort."""
    pred = _as_predicate(abort)
    while True:
        try:
            return q.get(timeout=poll)
        except queue.Empty:
            if pred is not None and pred():
                raise QueueAborted("queue get aborted")


def put_abortable(q: "queue.Queue", item, abort: AbortLike = None,
                  poll: float = POLL_SECONDS) -> None:
    """Blocking `q.put(item)` that re-checks `abort` every `poll`
    seconds. Raises QueueAborted when the predicate fires while the
    queue is still full (backpressure is preserved; only a dead/closed
    peer aborts the put)."""
    pred = _as_predicate(abort)
    while True:
        try:
            q.put(item, timeout=poll)
            return
        except queue.Full:
            if pred is not None and pred():
                raise QueueAborted("queue put aborted")

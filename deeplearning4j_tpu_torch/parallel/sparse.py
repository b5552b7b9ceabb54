"""Overlapped sparse-embedding pipeline over the sharded paramserver;
the port of the JAX package's parallel/sparse.py (numpy and threads:
`lookup` returns numpy rows, which the card sees only as the dense
tower's input).

Sparse pull/push latency is pure overhead unless it is hidden under the
dense device step — the same overlap argument as the input pipeline's
host->device staging (data/prefetch.DevicePrefetchIterator). The worker
overlaps the training thread only where the latter releases the
interpreter lock (torch's CUDA calls and blocking copies do). This
module is the client-side layer that does the hiding:

  dedup      per batch, ids collapse to uniques (`np.unique` + inverse
             gather) before touching cache or wire — repeated ids in a
             batch cost one row (`paramserver_pull_rows_coalesced_total`)
  cache      a bounded hot-id LRU (zipf traffic: a few thousand hot rows
             absorb most pulls; hits never go to the wire), write-through
             invalidated on push so cached rows track the server exactly
  prefetch   the NEXT batch's rows resolve one step ahead on a
             `dl4j-sparse-prefetch` worker, so the wire round trip for
             step k+1 overlaps the dense device step k
  coherence  pushes are coalesced (per-id delta sums) and applied
             write-through to the cache AND to every unconsumed
             prefetch op — f32 `+=` exactly mirrors the server's
             accumulate, so the training trajectory is byte-identical
             pipeline-on vs pipeline-off (pinned by test, f32 wire)

Coherence protocol (why lookups stay exact under async prefetch):
pushes originate ONLY from the training thread, so a consume (lookup)
never races a push. The resolve worker's wire pull is the one racy read;
it is fenced two ways: (1) flush-elision — before pulling, the worker
flushes the push queue ONLY when the miss set intersects the set of
rows with possibly-in-flight pushes (`_outstanding`), which zipf tail
misses almost never do, keeping the overlap win; (2) any row pushed
while its op is still resolving is marked DIRTY and invalidated from
the cache — at consume time dirty rows are re-pulled synchronously
after a flush, which is authoritative because no pushes can be in
flight while the training thread sits in lookup. Rows parked for
replay (endpoint down) are the failover path and excluded from the
exactness claim, same as the client's own staleness contract.

Books: `paramserver_pull_rows_total == paramserver_cache_hit_total +
paramserver_cache_miss_total` holds exactly (per unique row per
lookup); `sparse_pull_stall_seconds` is the wait the prefetch failed
to hide. Pull wall time books per tenant under the paramserver tier
(utils/resourcemeter.note_ps_pull). `deadline_ms` caps a lookup even
when rows come from cache — a wedged resolve (chaos `hang` on the
`paramserver_rpc` faultpoint) surfaces as TimeoutError at the caller,
not a silent stall.
"""

from __future__ import annotations

import json
import logging
import queue
import sys
import threading
import time
from collections import OrderedDict, deque
from typing import Deque, Dict, List, Optional

import numpy as np

from deeplearning4j_tpu_torch.utils import health as _health
from deeplearning4j_tpu_torch.utils import metrics as _metrics
from deeplearning4j_tpu_torch.utils import resourcemeter as _resourcemeter
from deeplearning4j_tpu_torch.utils import tracing as _tracing
from deeplearning4j_tpu_torch.utils.concurrency import (
    QueueAborted,
    get_abortable,
    put_abortable,
)

logger = logging.getLogger("deeplearning4j_tpu_torch")

# the test suite's thread-leak guard matches this prefix: a pipeline
# that leaves its worker behind fails the owning test, not a later one
SPARSE_THREAD_PREFIX = "dl4j-sparse"


class _Op:
    """One submitted batch: classification snapshot + resolution state.
    All mutable fields are guarded by the pipeline lock except `event`."""

    __slots__ = ("key", "uniq", "inv", "n_raw", "hit_vals", "miss",
                 "miss_set", "fetched", "dirty", "resolved", "error",
                 "event", "ctx")

    def __init__(self, key, uniq, inv, n_raw, hit_vals, miss):
        self.key = key
        self.uniq = uniq
        self.inv = inv
        self.n_raw = n_raw
        self.hit_vals: Dict[int, np.ndarray] = hit_vals
        self.miss: List[int] = miss
        self.miss_set = set(miss)
        self.fetched: Dict[int, np.ndarray] = {}
        self.dirty: set = set()
        self.resolved = False
        self.error: Optional[BaseException] = None
        self.event = threading.Event()
        self.ctx = _tracing.current_context()


class SparseEmbeddingPipeline:
    """Cache-fronted, prefetching pull/push front-end for ONE table on
    an EmbeddingPSClient. Single training thread assumed (the same
    contract as the client's push queue). Use as a context manager or
    call `close()` — the worker thread must not outlive the pipeline."""

    def __init__(self, client, table: str, dim: Optional[int] = None,
                 cache_rows: int = 4096, prefetch: bool = True,
                 prefetch_depth: int = 2,
                 deadline_ms: Optional[float] = None,
                 flush_timeout: float = 30.0,
                 tenant: Optional[str] = None):
        self.client = client
        self.table = table
        self.dim = dim
        self.cache_rows = max(0, int(cache_rows))
        self.prefetch_enabled = bool(prefetch)
        self.deadline_ms = deadline_ms
        self.flush_timeout = float(flush_timeout)
        self.tenant = tenant if tenant is not None else getattr(
            client, "tenant", None)
        self._lock = threading.Lock()
        self._lru: "OrderedDict[int, int]" = OrderedDict()  # id -> slot
        self._free: List[int] = list(range(self.cache_rows))
        self._slab: Optional[np.ndarray] = None  # [cache_rows, dim] f32
        self._ops: Deque[_Op] = deque()  # submitted, unconsumed (FIFO)
        # rows with a possibly not-yet-landed push: the flush-elision set
        self._outstanding: set = set()
        self._closed = False
        # wire pull wall times (resolve + sync fallback) — the bench
        # reads percentiles from here
        self.pull_seconds: Deque[float] = deque(maxlen=8192)
        # plain-int books (the metrics below mirror them): the smoke
        # gate asserts rows == hits + misses without registry scraping
        self.n_rows = 0
        self.n_hit = 0
        self.n_miss = 0
        self.n_coalesced = 0
        self.n_flush_forced = 0
        self.n_flush_elided = 0
        self.n_dirty_fixes = 0
        reg = _metrics.get_registry()
        self._m_rows = reg.counter(
            "paramserver_pull_rows_total",
            "unique rows requested through the sparse pipeline",
            ("table",)).labels(table)
        self._m_coalesced = reg.counter(
            "paramserver_pull_rows_coalesced_total",
            "duplicate ids collapsed by per-batch dedup (rows that never "
            "cost cache or wire)", ("table",)).labels(table)
        self._m_hit = reg.counter(
            "paramserver_cache_hit_total",
            "unique rows served from the hot-id cache", ("table",)
        ).labels(table)
        self._m_miss = reg.counter(
            "paramserver_cache_miss_total",
            "unique rows that went to the wire", ("table",)).labels(table)
        self._m_stall = reg.histogram(
            "sparse_pull_stall_seconds",
            "training-thread wait for rows the prefetch did not hide")
        self._wq: "queue.Queue[_Op]" = queue.Queue(
            maxsize=max(1, int(prefetch_depth)))
        self._stop = threading.Event()
        self._hb = None
        self._worker: Optional[threading.Thread] = None
        if self.prefetch_enabled:
            # liveness: a resolve wedged on a dead endpoint flips
            # component_health{component=sparse_prefetch} to degraded
            self._hb = _health.get_health().register(
                "sparse_prefetch", stall_after=60.0)
            self._worker = threading.Thread(
                target=self._worker_loop, daemon=True,
                name=f"{SPARSE_THREAD_PREFIX}-prefetch")
            self._worker.start()

    # -- cache (all _locked helpers assume self._lock held) ------------------

    def _cache_insert_locked(self, rid: int, val: np.ndarray) -> None:
        if self.cache_rows <= 0:
            return
        if self._slab is None:
            self._slab = np.zeros((self.cache_rows, val.shape[-1]),
                                  np.float32)
        slot = self._lru.get(rid)
        if slot is None:
            if self._free:
                slot = self._free.pop()
            else:  # evict least-recently-used
                _, slot = self._lru.popitem(last=False)
            self._lru[rid] = slot
        else:
            self._lru.move_to_end(rid)
        self._slab[slot] = val

    def _cache_invalidate_locked(self, rid: int) -> None:
        slot = self._lru.pop(rid, None)
        if slot is not None:
            self._free.append(slot)

    def cache_len(self) -> int:
        with self._lock:
            return len(self._lru)

    # -- submit --------------------------------------------------------------

    def _make_op_locked(self, ids: np.ndarray) -> _Op:
        uniq, inv = np.unique(ids, return_inverse=True)
        hit_vals: Dict[int, np.ndarray] = {}
        miss: List[int] = []
        for rid in uniq.tolist():
            slot = self._lru.get(rid)
            if slot is None:
                miss.append(rid)
            else:
                self._lru.move_to_end(rid)
                # snapshot NOW: eviction between submit and consume must
                # not lose the row; write-through keeps it server-exact
                hit_vals[rid] = self._slab[slot].copy()
        return _Op(ids.tobytes(), uniq, inv, int(ids.size), hit_vals, miss)

    def prefetch(self, ids) -> None:
        """Submit the NEXT batch: classification happens now (under the
        lock, on the training thread), the wire work happens on the
        worker while the caller runs the dense step. No-op with
        prefetch disabled (the synchronous arm)."""
        if not self.prefetch_enabled:
            return
        if self._closed:
            raise RuntimeError("SparseEmbeddingPipeline is closed")
        ids = np.asarray(ids, np.int64).reshape(-1)
        with self._lock:
            op = self._make_op_locked(ids)
            self._ops.append(op)
        try:
            put_abortable(self._wq, op, abort=self._stop)
        except QueueAborted:
            with self._lock:
                if op in self._ops:
                    self._ops.remove(op)
            raise RuntimeError("SparseEmbeddingPipeline is closed")

    # -- resolve (worker thread, or inline on the training thread) -----------

    def _resolve(self, op: _Op) -> None:
        try:
            with self._lock:
                miss = list(op.miss)
                need_flush = bool(op.miss_set & self._outstanding)
            with _tracing.span("sparse/resolve", table=self.table,
                               rows=len(miss), flush=need_flush):
                if need_flush and miss:
                    self.n_flush_forced += 1
                    self.client.flush(timeout=self.flush_timeout)
                elif miss:
                    self.n_flush_elided += 1
                if miss:
                    t0 = time.perf_counter()
                    got = self.client.pull(
                        self.table, np.asarray(miss, np.int64),
                        deadline_ms=self.deadline_ms)
                    dt = time.perf_counter() - t0
                    self.pull_seconds.append(dt)
                    _resourcemeter.note_ps_pull(self.tenant, dt)
                    with self._lock:
                        if self.dim is None:
                            self.dim = int(got.shape[1])
                        for j, rid in enumerate(miss):
                            op.fetched[rid] = got[j].copy()
                            # a row pushed mid-pull is indeterminate:
                            # leave it out of the cache, consume re-pulls
                            if rid not in op.dirty:
                                self._cache_insert_locked(rid, got[j])
                        op.resolved = True
                else:
                    with self._lock:
                        op.resolved = True
        except BaseException as e:
            # the training thread re-raises this from lookup(); letting
            # it kill the worker would turn a dead endpoint into a hang
            op.error = e
        finally:
            op.event.set()

    def _worker_loop(self) -> None:
        while True:
            try:
                op = get_abortable(self._wq, abort=self._stop)
            except QueueAborted:
                return
            with self._hb.busy():
                with _tracing.attached_ctx(op.ctx):
                    self._resolve(op)

    # -- consume -------------------------------------------------------------

    def lookup(self, ids, deadline_ms: Optional[float] = None
               ) -> np.ndarray:
        """Rows for `ids` (any shape; returns [n_ids, dim] in order,
        duplicates repeated). Consumes the matching prefetched op when
        one is at the head of the FIFO, else resolves inline. Raises
        TimeoutError past `deadline_ms` (default: the pipeline's) even
        when every row would come from cache — a wedged resolve must
        not stall the step unboundedly."""
        if self._closed:
            raise RuntimeError("SparseEmbeddingPipeline is closed")
        ids = np.asarray(ids, np.int64).reshape(-1)
        if deadline_ms is None:
            deadline_ms = self.deadline_ms
        deadline = (None if deadline_ms is None
                    else time.monotonic() + float(deadline_ms) / 1e3)
        key = ids.tobytes()
        with _tracing.span("sparse/lookup", table=self.table,
                           ids=int(ids.size)):
            op = None
            with self._lock:
                if self._ops and self._ops[0].key == key:
                    op = self._ops.popleft()
            if op is None:
                with self._lock:
                    op = self._make_op_locked(ids)
                t0 = time.perf_counter()
                self._resolve(op)
                self._m_stall.observe(time.perf_counter() - t0)
            else:
                t0 = time.perf_counter()
                while not op.event.is_set():
                    if deadline is not None:
                        left = deadline - time.monotonic()
                        if left <= 0:
                            raise TimeoutError(
                                f"sparse lookup missed deadline_ms="
                                f"{deadline_ms} waiting for prefetch "
                                f"of {len(op.miss)} rows")
                        op.event.wait(min(left, 0.25))
                    else:
                        op.event.wait(0.25)
                self._m_stall.observe(time.perf_counter() - t0)
            if op.error is not None:
                raise op.error
            return self._finish(op, deadline, deadline_ms)

    def _finish(self, op: _Op, deadline, deadline_ms) -> np.ndarray:
        with self._lock:
            dirty = sorted(op.dirty)
        if dirty:
            # authoritative fix-up: the training thread is HERE, so no
            # push can be in flight once the queue flushes — the re-pull
            # is exact. Booked as part of the op's misses (no re-count).
            self.n_dirty_fixes += len(dirty)
            self.client.flush(timeout=self.flush_timeout)
            left_ms = (None if deadline is None
                       else max(1.0, (deadline - time.monotonic()) * 1e3))
            t0 = time.perf_counter()
            got = self.client.pull(self.table,
                                   np.asarray(dirty, np.int64),
                                   deadline_ms=left_ms)
            dt = time.perf_counter() - t0
            self.pull_seconds.append(dt)
            _resourcemeter.note_ps_pull(self.tenant, dt)
            with self._lock:
                for j, rid in enumerate(dirty):
                    op.fetched[rid] = got[j].copy()
                    self._cache_insert_locked(rid, got[j])
        n_uniq = int(op.uniq.size)
        if n_uniq == 0:
            d = self.dim if self.dim is not None else 0
            return np.zeros((0, d), np.float32)
        first = (next(iter(op.hit_vals.values())) if op.hit_vals
                 else op.fetched[op.miss[0]])
        vals = np.empty((n_uniq, first.shape[-1]), np.float32)
        for k, rid in enumerate(op.uniq.tolist()):
            v = op.hit_vals.get(rid)
            vals[k] = v if v is not None else op.fetched[rid]
        # books — hit/miss partition the uniques exactly:
        # pull_rows == cache_hit + cache_miss, always
        self.n_rows += n_uniq
        self.n_hit += len(op.hit_vals)
        self.n_miss += len(op.miss)
        self.n_coalesced += op.n_raw - n_uniq
        self._m_rows.inc(n_uniq)
        self._m_hit.inc(len(op.hit_vals))
        self._m_miss.inc(len(op.miss))
        self._m_coalesced.inc(op.n_raw - n_uniq)
        return vals[op.inv]

    # -- push ----------------------------------------------------------------

    def push(self, ids, deltas) -> None:
        """Coalesce per-id delta sums, write them through the cache and
        every unconsumed prefetch op (f32 `+=`, exactly the server's
        accumulate), then hand ONE deduped batch to the client's async
        push queue. Runs on the training thread; returns immediately."""
        ids = np.asarray(ids, np.int64).reshape(-1)
        deltas = np.asarray(deltas, np.float32)
        deltas = deltas.reshape(ids.size, -1)
        uniq, inv = np.unique(ids, return_inverse=True)
        summed = np.zeros((uniq.size, deltas.shape[1]), np.float32)
        np.add.at(summed, inv, deltas)
        uniq_list = uniq.tolist()
        with _tracing.span("sparse/push", table=self.table,
                           rows=len(uniq_list)):
            with self._lock:
                # all prior pushes landed -> nothing is outstanding any
                # more; shrink the elision set before adding this batch
                if (self.client.queued_pushes() == 0
                        and self.client.pending_pushes() == 0):
                    self._outstanding.clear()
                ops = [o for o in self._ops]
                for j, rid in enumerate(uniq_list):
                    d = summed[j]
                    make_dirty = False
                    for op in ops:
                        if rid in op.hit_vals:
                            op.hit_vals[rid] += d
                        elif rid in op.miss_set:
                            if op.resolved and rid not in op.dirty:
                                op.fetched[rid] += d
                            else:
                                op.dirty.add(rid)
                                make_dirty = True
                    if make_dirty:
                        self._cache_invalidate_locked(rid)
                    else:
                        slot = self._lru.get(rid)
                        if slot is not None:
                            self._slab[slot] += d
                self._outstanding.update(uniq_list)
            self.client.push_async(self.table, uniq, summed)

    # -- lifecycle -----------------------------------------------------------

    def stats(self) -> dict:
        return {
            "pull_rows": self.n_rows,
            "cache_hit": self.n_hit,
            "cache_miss": self.n_miss,
            "coalesced": self.n_coalesced,
            "hit_rate": (self.n_hit / self.n_rows) if self.n_rows else 0.0,
            "flush_forced": self.n_flush_forced,
            "flush_elided": self.n_flush_elided,
            "dirty_fixes": self.n_dirty_fixes,
            "cache_len": self.cache_len(),
        }

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._stop.set()
        if self._worker is not None:
            self._worker.join(timeout=self.flush_timeout)
            if self._worker.is_alive():
                logger.warning("sparse prefetch worker did not exit in "
                               "%.1fs", self.flush_timeout)
            if self._hb is not None:
                _health.get_health().unregister(self._hb)
        with self._lock:
            pending = list(self._ops)
            self._ops.clear()
        for op in pending:
            if op.error is None and not op.resolved:
                op.error = RuntimeError("SparseEmbeddingPipeline closed "
                                        "with prefetch in flight")
            op.event.set()

    def __enter__(self) -> "SparseEmbeddingPipeline":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


# -- smoke (python -m deeplearning4j_tpu_torch.parallel.sparse) ---------------


def _smoke_arm(init: np.ndarray, batches: List[np.ndarray], *,
               prefetch: bool, cache_rows: int) -> tuple:
    """Train a few pipelined steps against 2 fresh in-process endpoints;
    returns (final table, stats). Deterministic deltas so the two arms
    are comparable bit-for-bit."""
    from deeplearning4j_tpu_torch.parallel.paramserver import (
        EmbeddingParameterServer,
        EmbeddingPSClient,
    )

    servers = [EmbeddingParameterServer({"emb": init.copy()})
               for _ in range(2)]
    ports = [s.start() for s in servers]
    client = EmbeddingPSClient([f"http://127.0.0.1:{p}" for p in ports])
    try:
        pipe = SparseEmbeddingPipeline(
            client, "emb", cache_rows=cache_rows, prefetch=prefetch)
        with pipe:
            if prefetch:
                pipe.prefetch(batches[0])
            for k, ids in enumerate(batches):
                rows = pipe.lookup(ids)
                if prefetch and k + 1 < len(batches):
                    pipe.prefetch(batches[k + 1])
                # deterministic "gradient": shrink every touched row
                pipe.push(ids, (-0.125 * rows).astype(np.float32))
            stats = pipe.stats()
        if not client.flush(timeout=30.0):
            raise RuntimeError("paramserver flush timed out in smoke")
        final = client.pull("emb", np.arange(init.shape[0]))
        return final, stats
    finally:
        client.close()
        for s in servers:
            s.stop()


def smoke() -> dict:
    """Tiny end-to-end check: 2 endpoints, zipf ids, a few pipelined
    steps. Asserts the cache books conserve (pull_rows == cache_hit +
    cache_miss), the prefetch-on trajectory is byte-identical to the
    synchronous one, and no `dl4j-sparse-*` thread survives close()."""
    from deeplearning4j_tpu_torch.data.recsys import zipf_ids

    vocab, dim, steps, batch = 64, 8, 6, 32
    rng = np.random.default_rng(7)
    init = rng.standard_normal((vocab, dim)).astype(np.float32)
    batches = [zipf_ids(batch, vocab, alpha=1.3, seed=100 + k)
               for k in range(steps)]

    on, stats_on = _smoke_arm(init, batches, prefetch=True, cache_rows=32)
    off, stats_off = _smoke_arm(init, batches, prefetch=False,
                                cache_rows=0)

    books_ok = (stats_on["pull_rows"]
                == stats_on["cache_hit"] + stats_on["cache_miss"]
                and stats_off["pull_rows"]
                == stats_off["cache_hit"] + stats_off["cache_miss"]
                and stats_on["pull_rows"] > 0)
    identical = on.tobytes() == off.tobytes()
    leaked = [t.name for t in threading.enumerate()
              if t.name.startswith(SPARSE_THREAD_PREFIX)]
    return {
        "ok": bool(books_ok and identical and not leaked),
        "books_ok": books_ok,
        "prefetch_matches_sync": identical,
        "leaked_threads": leaked,
        "pipelined": stats_on,
        "synchronous": stats_off,
    }


def main() -> int:
    report = smoke()
    sys.stdout.write(json.dumps(report, indent=1, default=str) + "\n")
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    # `python -m` runs a SECOND copy of this module as __main__; the
    # smoke must drive the canonical instance the client/metrics import
    from deeplearning4j_tpu_torch.parallel import sparse as _canonical

    sys.exit(_canonical.main())

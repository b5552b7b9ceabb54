"""Asynchronous parameter server for embedding training; the port of
the JAX package's parallel/paramserver.py (numpy and the standard
library: the tables live in host memory, and the wire and the journal
are byte-compatible with the JAX package's, so either package's client
talks to either package's server and restores its journal).

Design (the written PS/embedding-async plan; reference:
ParameterServerTrainer.java:32-66 pushNDArray over Aeron,
SparkSequenceVectors.java:292-294 VoidParameterServer):

Why a PS at all, when gradient allreduce covers dense training? Embedding
workloads touch a SPARSE, tiny slice of an enormous table each step;
allreducing a dense table-sized gradient per step is absurd, and the
hot-word rows tolerate stale updates (async SGD is the reference's own
semantics — it documents the nondeterminism, DeepWalk.java:223). So:

  server:  row-sharded tables (syn0/syn1/syn1neg, a recsys "emb") in
           host memory, one process per endpoint; applies row DELTAS in
           arrival order (Hogwild-style), serves row PULLS. HTTP here;
           the transport is the pluggable part (the reference swapped
           Aeron in the same slot).
  client:  per-batch: PULL the rows the batch touches, run the device
           step on those rows only, PUSH back the row deltas
           fire-and-forget on a bounded queue.
  sharding: row id -> shard by modulo over server endpoints; each
           endpoint owns rows i with i % n_servers == k, so pushes from
           all workers for one row serialize at one owner (no
           cross-server coordination).

Staleness bound: one in-flight push window per worker (the queue), i.e.
a worker's pulls lag its own pushes by <= queue depth; convergence for
embedding objectives is unaffected in practice (the reference ships the
same tradeoff).
"""

from __future__ import annotations

import json
import logging
import os
import queue
import random
import struct
import threading
import time
import urllib.request
from collections import deque
from typing import Dict, List, Optional

import numpy as np

from deeplearning4j_tpu_torch.utils import faultpoints as _faults
from deeplearning4j_tpu_torch.utils import health as _health
from deeplearning4j_tpu_torch.utils import metrics as _metrics
from deeplearning4j_tpu_torch.utils import resourcemeter as _resourcemeter
from deeplearning4j_tpu_torch.utils import tenancy as _tenancy
from deeplearning4j_tpu_torch.utils import tracing as _tracing
from deeplearning4j_tpu_torch.utils.concurrency import (
    QueueAborted,
    put_abortable,
)
from deeplearning4j_tpu_torch.utils.jsonhttp import (
    JsonHttpServer,
    json_response,
    traced_headers,
)

logger = logging.getLogger("deeplearning4j_tpu_torch")


# -- binary wire format -------------------------------------------------------
# A real [vocab, dim] f32 table pushed as JSON lists is ~10x the bytes and
# far more CPU than raw rows; the hot routes (/pull.bin, /push.bin) move
# raw little-endian buffers instead. JSON routes remain for debugging and
# as the "transport is the pluggable part" demonstration.
#
#   request  := u16 name_len | name utf8 | u32 n_rows | u32 dim
#               | i64 * n_rows row ids | f32 * n_rows * dim deltas
#               (dim == 0 for pulls: no payload follows the ids)
#   pull rsp := u32 n_rows | u32 dim | f32 * n_rows * dim raw rows
#
# bf16 wire payload (opt-in, EmbeddingPSClient(wire_dtype="bf16")): the
# top bit of the `dim` field tags the ROW PAYLOAD as bf16 (u16 per
# element, round-to-nearest-even truncation of the f32). A pull request
# (dim == 0, no payload) sets the tag to ask for a bf16 RESPONSE.
# Accumulation stays f32 on both ends — only the wire narrows, halving
# `paramserver_wire_bytes_total` for the row blocks. Row ids stay i64.
# An untagged request is f32, so old clients keep working unchanged.

_BF16_FLAG = 0x80000000


def _bf16_from_f32(a: np.ndarray) -> np.ndarray:
    """f32 -> bf16 (as u16), round-to-nearest-even. NaN payloads can
    carry into the exponent under RNE — pinned to the canonical quiet
    NaN instead (sign preserved)."""
    u = np.ascontiguousarray(a, "<f4").view("<u4")
    rne = ((u >> np.uint32(16)) & np.uint32(1)) + np.uint32(0x7FFF)
    out = ((u + rne) >> np.uint32(16)).astype("<u2")
    nan = ((u & np.uint32(0x7F800000)) == np.uint32(0x7F800000)) \
        & ((u & np.uint32(0x007FFFFF)) != 0)
    if nan.any():
        out = np.where(
            nan, ((u >> np.uint32(16)) & np.uint16(0x8000))
            .astype("<u2") | np.uint16(0x7FC0), out)
    return out


def _f32_from_bf16(u16: np.ndarray) -> np.ndarray:
    return (np.ascontiguousarray(u16, "<u2").astype("<u4")
            << np.uint32(16)).view("<f4")


def _pack_request(table: str, rows: np.ndarray,
                  deltas: Optional[np.ndarray] = None,
                  wire_dtype: str = "f32") -> bytes:
    name = table.encode()
    rows = np.ascontiguousarray(rows, dtype="<i8")
    flag = _BF16_FLAG if wire_dtype == "bf16" else 0
    if deltas is None:
        head = struct.pack("<H", len(name)) + name + struct.pack(
            "<II", rows.size, flag)
        return head + rows.tobytes()
    deltas = np.asarray(deltas, np.float32)
    if deltas.ndim != 2 or deltas.shape[0] != rows.size:
        raise ValueError(f"deltas must be [n_rows, dim], got {deltas.shape} "
                         f"for {rows.size} rows")
    head = struct.pack("<H", len(name)) + name + struct.pack(
        "<II", rows.size, deltas.shape[1] | flag)
    payload = (_bf16_from_f32(deltas) if flag
               else np.ascontiguousarray(deltas, "<f4"))
    return head + rows.tobytes() + payload.tobytes()


def _unpack_request(body: bytes):
    """Returns (table, rows, deltas_f32_or_None, wire_dtype) — the dtype
    tag tells a pull handler which payload encoding the CLIENT asked the
    response to use."""
    (name_len,) = struct.unpack_from("<H", body, 0)
    name = body[2:2 + name_len].decode()
    n, dim = struct.unpack_from("<II", body, 2 + name_len)
    wire_dtype = "bf16" if dim & _BF16_FLAG else "f32"
    dim &= ~_BF16_FLAG
    off = 2 + name_len + 8
    rows = np.frombuffer(body, "<i8", count=n, offset=off)
    off += 8 * n
    deltas = None
    if dim:
        if wire_dtype == "bf16":
            deltas = _f32_from_bf16(np.frombuffer(
                body, "<u2", count=n * dim, offset=off)).reshape(n, dim)
        else:
            deltas = np.frombuffer(body, "<f4", count=n * dim,
                                   offset=off).reshape(n, dim)
    return name, rows, deltas, wire_dtype


def _pack_rows(rows: np.ndarray, wire_dtype: str = "f32") -> bytes:
    rows = np.asarray(rows, np.float32)
    n, dim = rows.shape
    if wire_dtype == "bf16":
        return struct.pack("<II", n, dim | _BF16_FLAG) \
            + _bf16_from_f32(rows).tobytes()
    return struct.pack("<II", n, dim) \
        + np.ascontiguousarray(rows, "<f4").tobytes()


def _unpack_rows(body: bytes) -> np.ndarray:
    n, dim = struct.unpack_from("<II", body, 0)
    if dim & _BF16_FLAG:
        dim &= ~_BF16_FLAG
        return _f32_from_bf16(np.frombuffer(
            body, "<u2", count=n * dim, offset=8)).reshape(n, dim)
    return np.frombuffer(body, "<f4", count=n * dim, offset=8).reshape(n, dim)


class EmbeddingParameterServer:
    """One shard-owner process. Tables are {name: [rows, dim]} float32.

    `journal_dir` arms crash durability: every push is appended to a
    write-ahead journal (`journal.bin`, length-prefixed binary push
    records — the wire format, reused) BEFORE it is applied, and
    `snapshot()` persists the tables (`tables.npz`, atomic rename) and
    truncates the journal. A restarted server pointed at the same
    directory restores snapshot + replays the journal tail, so a shard
    owner dying mid-run costs nothing but the restart window — the
    client's replay buffer covers that (EmbeddingPSClient). A torn final
    journal record (killed mid-append) is detected by its length prefix
    and discarded; everything before it replays. `snapshot_every` > 0
    auto-snapshots after that many pushes, bounding replay time."""

    def __init__(self, tables: Dict[str, np.ndarray], port: int = 0,
                 journal_dir: Optional[str] = None,
                 snapshot_every: int = 0):
        self.tables = {k: np.asarray(v, np.float32) for k, v in tables.items()}
        self._locks = {k: threading.Lock() for k in self.tables}
        self._server = JsonHttpServer(post=self._post, port=port)
        self.pushes_applied = 0
        self.journal_dir = journal_dir
        self.snapshot_every = int(snapshot_every)
        self._journal = None
        self._jlock = threading.Lock()
        self._since_snapshot = 0
        # RPC counters + latency histograms in the shared registry, by
        # route — the PS hot path (pull.bin/push.bin) becomes a series an
        # operator can alert on instead of a private attribute
        reg = _metrics.get_registry()
        self._m_rpc = reg.counter(
            "paramserver_rpc_total", "parameter-server RPCs served",
            ("route",))
        self._m_rpc_sec = reg.histogram(
            "paramserver_rpc_seconds", "parameter-server RPC service time",
            ("route",))
        self._m_journal = reg.counter(
            "paramserver_journal_records_total",
            "pushes appended to the write-ahead journal").labels()
        self._m_replayed = reg.counter(
            "paramserver_journal_replayed_total",
            "journaled pushes re-applied on restart").labels()
        self._m_snapshots = reg.counter(
            "paramserver_snapshots_total",
            "table snapshots persisted (journal truncations)").labels()
        if journal_dir is not None:
            self._restore_from_dir()

    @property
    def port(self) -> int:
        return self._server.port

    # -- durability -----------------------------------------------------------

    def _snapshot_path(self) -> str:
        return os.path.join(self.journal_dir, "tables.npz")

    def _journal_path(self) -> str:
        return os.path.join(self.journal_dir, "journal.bin")

    def _restore_from_dir(self):
        os.makedirs(self.journal_dir, exist_ok=True)
        snap = self._snapshot_path()
        if os.path.exists(snap):
            with np.load(snap) as npz:
                for name in npz.files:
                    if name not in self.tables:
                        raise ValueError(
                            f"snapshot table {name!r} unknown to this "
                            f"server (have {sorted(self.tables)})")
                    if npz[name].shape != self.tables[name].shape:
                        raise ValueError(
                            f"snapshot table {name!r} shape "
                            f"{npz[name].shape} != configured "
                            f"{self.tables[name].shape}")
                    self.tables[name] = npz[name].astype(np.float32)
        replayed = 0
        jpath = self._journal_path()
        if os.path.exists(jpath):
            with open(jpath, "rb") as f:
                buf = f.read()
            off = 0
            while off + 4 <= len(buf):
                (rec_len,) = struct.unpack_from("<I", buf, off)
                if off + 4 + rec_len > len(buf):
                    logger.warning(
                        "journal ends in a torn record (%d of %d bytes) — "
                        "a writer died mid-append; discarding the tail",
                        len(buf) - off - 4, rec_len)
                    break
                name, rows, deltas, _ = _unpack_request(
                    buf[off + 4:off + 4 + rec_len])
                # same contract as the snapshot branch above: a journal
                # written by a differently-configured server fails with
                # a descriptive error, not a raw KeyError/IndexError
                if name not in self.tables:
                    raise ValueError(
                        f"journal record #{replayed} targets table "
                        f"{name!r} unknown to this server "
                        f"(have {sorted(self.tables)})")
                table = self.tables[name]
                if rows.size and (int(rows.max()) >= table.shape[0]
                                  or int(rows.min()) < 0):
                    raise ValueError(
                        f"journal record #{replayed} for table {name!r} "
                        f"addresses row {int(rows.max())} outside the "
                        f"configured shape {table.shape}")
                if deltas.shape[1:] != table.shape[1:]:
                    raise ValueError(
                        f"journal record #{replayed} for table {name!r} "
                        f"has row dim {deltas.shape[1:]} != configured "
                        f"{table.shape[1:]}")
                self._apply(name, rows.tolist(), deltas)
                replayed += 1
                off += 4 + rec_len
            if off != len(buf) and off + 4 > len(buf):
                logger.warning("journal ends mid-length-prefix; "
                               "discarding the tail")
        if replayed:
            self._m_replayed.inc(replayed)
            logger.info("paramserver restored: replayed %d journaled "
                        "push(es) from %s", replayed, jpath)
        self._journal = open(jpath, "ab")

    def snapshot(self) -> str:
        """Persist the tables and truncate the journal — the recovery
        point moves to NOW. Atomic: readers of the directory never see a
        half-written snapshot (tmp + rename), and the journal is only
        truncated after the snapshot is durable."""
        if self.journal_dir is None:
            raise ValueError("server was built without journal_dir")
        with self._jlock:
            copies = {}
            for name in sorted(self.tables):
                with self._locks[name]:
                    copies[name] = self.tables[name].copy()
            path = self._snapshot_path()
            tmp = f"{path}.{os.getpid()}.tmp"
            np.savez(tmp, **copies)
            # np.savez appends .npz when missing — normalize
            tmp_real = tmp if os.path.exists(tmp) else tmp + ".npz"
            os.replace(tmp_real, path)
            if self._journal is not None:
                self._journal.close()
            self._journal = open(self._journal_path(), "wb")
            self._since_snapshot = 0
        self._m_snapshots.inc()
        logger.info("paramserver snapshot: %s", path)
        return path

    def _journal_push(self, name: str, rows, deltas: np.ndarray) -> bool:
        """Journal the push and apply it under ONE _jlock hold, so a
        concurrent snapshot() (which also takes _jlock) can never copy
        tables missing a delta whose journal record it is about to
        truncate. Returns True when an auto-snapshot is due — taken by
        the caller AFTER the apply, so the triggering push is in the
        snapshot it causes."""
        payload = _pack_request(name, np.asarray(rows, np.int64),
                                np.asarray(deltas, np.float32))
        with self._jlock:
            if self._journal is None:  # closed (stop()): apply-only
                self._apply(name, rows, deltas)
                return False
            self._journal.write(struct.pack("<I", len(payload)) + payload)
            self._journal.flush()
            self._apply(name, rows, deltas)
            self._since_snapshot += 1
            due = (self.snapshot_every > 0
                   and self._since_snapshot >= self.snapshot_every)
        self._m_journal.inc()
        return due

    # -- core ops ------------------------------------------------------------

    def pull(self, name: str, rows: List[int]) -> np.ndarray:
        with self._locks[name]:
            return self.tables[name][rows].copy()

    def _apply(self, name: str, rows: List[int], deltas: np.ndarray) -> None:
        with self._locks[name]:
            np.add.at(self.tables[name], rows, deltas)
            self.pushes_applied += 1

    def push(self, name: str, rows: List[int], deltas: np.ndarray) -> None:
        """Apply row deltas in arrival order (async SGD). Journaled
        BEFORE application when durability is armed — a crash between
        the two re-applies the delta on restart, which async-SGD
        semantics tolerate (at-least-once beats silent loss)."""
        if self.journal_dir is not None:
            if self._journal_push(name, rows, deltas):
                self.snapshot()
            return
        self._apply(name, rows, deltas)

    # -- http transport ------------------------------------------------------

    def _post(self, path, body, headers):
        if path in ("/pull.bin", "/push.bin", "/pull", "/push"):
            route = path.lstrip("/")
            t0 = time.perf_counter()
            try:
                # nests under jsonhttp's http/server span, which already
                # joined the client's traceparent — a pull made mid-
                # request shows up inside the caller's trace with the
                # route named
                with _tracing.span("ps/server/" + route):
                    out = self._post_timed(path, body)
                # tenant wire accounting: request + response payload,
                # booked under the identity that arrived in X-Tenant
                # (jsonhttp attached it to this handler thread, next to
                # the traceparent). Charged server-side only, so an
                # in-process client+server pair never double-counts.
                resp = out[2] if len(out) > 2 else b""
                _resourcemeter.note_wire(
                    _tenancy.current_tenant(),
                    _resourcemeter.TIER_PARAMSERVER,
                    len(body) + (len(resp)
                                 if isinstance(resp, (bytes, bytearray))
                                 else 0))
                return out
            finally:
                self._m_rpc.labels(route).inc()
                self._m_rpc_sec.labels(route).observe(
                    time.perf_counter() - t0)
        if path == "/meta":
            return json_response({
                "tables": {k: list(v.shape) for k, v in self.tables.items()},
                "pushes_applied": self.pushes_applied,
            })
        return None

    def _post_timed(self, path, body):
        if path == "/pull.bin":
            # the request's dtype tag asks which encoding the response
            # payload should ride — bf16 halves the row-block bytes
            name, rows, _, wire_dtype = _unpack_request(body)
            return 200, "application/octet-stream", _pack_rows(
                self.pull(name, rows.tolist()), wire_dtype)
        if path == "/push.bin":
            # _unpack_request already widened a bf16 payload to f32 —
            # accumulation (np.add.at in _apply) is always f32
            name, rows, deltas, _ = _unpack_request(body)
            self.push(name, rows.tolist(), deltas)
            return 200, "application/octet-stream", b"ok"
        req = json.loads(body)
        name = req["table"]
        rows = req["rows"]
        if path == "/pull":
            return json_response({"data": self.pull(name, rows).tolist()})
        self.push(name, rows, np.asarray(req["deltas"], np.float32))
        return json_response({"status": "ok"})

    def start(self) -> int:
        return self._server.start()

    def stop(self):
        self._server.stop()
        with self._jlock:
            if self._journal is not None:
                self._journal.close()
                self._journal = None


class EmbeddingPSClient:
    """Worker-side pull/push. Pushes ride a bounded background queue
    (fire-and-forget, the Aeron pushNDArray analog); pulls are
    synchronous (the step needs the rows). The wire format is raw
    little-endian rows (see _pack_request) — JSON would be ~10x the bytes
    for real [vocab, dim] tables.

    Failover: every RPC retries with bounded exponential backoff
    (`max_retries`/`retry_backoff`), and a push whose endpoint stays
    down after the retries is PARKED in a per-endpoint FIFO replay
    buffer (`replay_capacity` batches) instead of dropped — the drain
    thread re-attempts parked pushes before any newer work for that
    endpoint, so a restarted server (journal-backed, see
    EmbeddingParameterServer) receives every batch in order and the run
    converges. Only replay-buffer OVERFLOW drops, and `dropped_pushes` /
    `paramserver_client_push_dropped_total` still count every loss —
    degradation stays observable, never silent. `replay_capacity=0`
    restores the old drop-immediately behavior."""

    def __init__(self, urls: List[str], queue_size: int = 64,
                 timeout: float = 10.0, max_retries: int = 2,
                 retry_backoff: float = 0.05,
                 replay_capacity: int = 128,
                 tenant: Optional[str] = None,
                 wire_dtype: str = "f32"):
        self.urls = [u.rstrip("/") for u in urls]
        # opt-in narrow wire payload (mirrors the sharded trainer's
        # grad_dtype="bf16"): row blocks ride bf16, ids stay i64,
        # accumulation stays f32 server-side. NEVER default-on — the
        # caller opts into the precision trade explicitly.
        if wire_dtype not in ("f32", "bf16"):
            raise ValueError(f"wire_dtype must be 'f32' or 'bf16', "
                             f"got {wire_dtype!r}")
        self.wire_dtype = wire_dtype
        # the identity this client's RPCs book under on the server side
        # (X-Tenant next to the traceparent). Explicit beats ambient:
        # the push drain runs on its own thread, where the fit loop's
        # thread-local tenant would otherwise be invisible.
        self.tenant = None if tenant is None else _tenancy.intern(tenant)
        self.timeout = timeout
        self.max_retries = max(0, int(max_retries))
        self.retry_backoff = float(retry_backoff)
        self.replay_capacity = max(0, int(replay_capacity))
        # per-client backoff jitter stream (de-correlates clients; needs
        # no cross-run determinism — fault injection has its own RNGs)
        self._jitter = random.Random()
        self.dropped_pushes = 0
        self._dims: Dict[str, int] = {}
        self._q: "queue.Queue" = queue.Queue(maxsize=queue_size)
        # per-endpoint parked pushes, FIFO; drain-thread-only once the
        # worker is running (close() touches it only after the join)
        self._pending: List[deque] = [deque() for _ in self.urls]
        reg = _metrics.get_registry()
        self._m_rpc = reg.counter(
            "paramserver_client_rpc_total",
            "parameter-server client RPCs issued", ("route",))
        self._m_rpc_sec = reg.histogram(
            "paramserver_client_rpc_seconds",
            "parameter-server client RPC round-trip time", ("route",))
        self._m_dropped = reg.counter(
            "paramserver_client_push_dropped_total",
            "push batches lost to dead/misbehaving endpoints").labels()
        self._m_retries = reg.counter(
            "paramserver_client_retry_total",
            "RPC attempts beyond the first (endpoint flaky/down)",
            ("route",))
        self._m_replayed = reg.counter(
            "paramserver_client_push_replayed_total",
            "parked pushes delivered after their endpoint came back"
        ).labels()
        self._m_wire = reg.counter(
            "paramserver_wire_bytes_total",
            "client-side request + response payload bytes by route — "
            "the number wire_dtype='bf16' halves for row blocks",
            ("route",))
        self._stop = threading.Event()
        # liveness: the drain holds a busy slot only while delivering a
        # push batch — a wedged endpoint (socket past its timeout, DNS
        # hang) flips `component_health{component=paramserver_push}`
        self._hb = _health.get_health().register(
            "paramserver_push", stall_after=max(60.0, 4.0 * timeout))
        self._worker = threading.Thread(target=self._drain, daemon=True,
                                        name="dl4j-paramserver-push")
        self._worker.start()

    def _owner(self, row: int) -> int:
        return row % len(self.urls)

    def _post_bin(self, url: str, route: str, payload: bytes) -> bytes:
        label = route.lstrip("/")
        t0 = time.perf_counter()
        # the client RPC span opens FIRST so the traceparent injected
        # below carries ITS context: the remote server's http/server span
        # parents to this span, and the cross-process tree reads
        # caller -> ps/client/<route> -> http/server -> ps/server/<route>
        with _tracing.span("ps/client/" + label):
            req = urllib.request.Request(
                f"{url}{route}", data=payload,
                headers=_tenancy.tenant_headers(
                    traced_headers(
                        {"Content-Type": "application/octet-stream"}),
                    tenant=self.tenant))
            try:  # count failures too (server side does the same): an
                # outage must show up in the RPC series, not just the
                # drop counter
                # chaos hook: an `error` fault is a dropped/refused RPC
                # (the retry/replay machinery absorbs it); `latency` is a
                # slow network; `hang` is the wedged-endpoint case the
                # push drain's heartbeat exists for
                _faults.fault_point("paramserver_rpc", route=label)
                with urllib.request.urlopen(req, timeout=self.timeout) as r:
                    resp = r.read()
                self._m_wire.labels(label).inc(len(payload) + len(resp))
                return resp
            finally:
                self._m_rpc.labels(label).inc()
                self._m_rpc_sec.labels(label).observe(
                    time.perf_counter() - t0)

    def _post_with_retry(self, url: str, route: str, payload: bytes,
                         deadline: Optional[float] = None) -> bytes:
        """`_post_bin` with bounded, JITTERED exponential backoff — a
        blip (server restart, transient network fault) costs latency,
        not data. The final failure propagates; push callers park the
        payload for replay, pull callers surface it (the step needs the
        rows NOW).

        Jitter (±50% per sleep, from a per-client RNG): pure exponential
        backoff synchronizes — every client that failed in the same
        server outage retries at the same instants and thundering-herds
        the recovering endpoint; the spread de-correlates them. `deadline`
        (time.monotonic seconds) caps the TOTAL retry spend: a caller
        with a latency budget stops burning it on a dead endpoint — the
        failure surfaces while the budget can still pay for a fallback."""
        label = route.lstrip("/")
        attempt = 0
        while True:
            try:
                return self._post_bin(url, route, payload)
            except Exception:
                if attempt >= self.max_retries or self._stop.is_set():
                    raise
                if deadline is not None \
                        and time.monotonic() >= deadline:
                    raise
                sleep = (self.retry_backoff * (2 ** attempt)
                         * self._jitter.uniform(0.5, 1.5))
                if deadline is not None:
                    remaining = deadline - time.monotonic()
                    if sleep >= remaining:
                        raise  # the wait alone would blow the budget
                self._m_retries.labels(label).inc()
                # stop-aware sleep: a close() mid-backoff aborts the wait
                self._stop.wait(sleep)
                attempt += 1

    def _dim(self, table: str) -> int:
        """Table dim, cached from the first shard's /meta (needed to shape
        empty pulls)."""
        if table not in self._dims:
            req = urllib.request.Request(self.urls[0] + "/meta", data=b"{}")
            with urllib.request.urlopen(req, timeout=self.timeout) as r:
                meta = json.loads(r.read())
            for k, shape in meta["tables"].items():
                self._dims[k] = int(shape[1])
        return self._dims[table]

    def _pull_shard(self, s: int, table: str, rows_sel: np.ndarray,
                    deadline: Optional[float]) -> np.ndarray:
        return _unpack_rows(self._post_with_retry(
            self.urls[s], "/pull.bin",
            _pack_request(table, rows_sel, wire_dtype=self.wire_dtype),
            deadline=deadline))

    def pull(self, table: str, rows: np.ndarray,
             deadline_ms: Optional[float] = None) -> np.ndarray:
        """Fetch rows (grouped per owning shard, order restored). Empty
        row sets return a well-formed [0, dim] array. `deadline_ms`
        caps the retry spend across every shard RPC: past it, the
        failure propagates instead of backing off further.

        The per-shard sub-pulls run CONCURRENTLY (one short-lived
        `dl4j-ps-pull-*` thread per shard with rows): an S-shard table
        costs ~max of the shard round trips, not their sum. Each thread
        keeps the full per-endpoint retry/backoff/deadline semantics
        (`_post_with_retry`), and the caller's span context is attached
        so the per-shard `ps/client/pull.bin` spans stay inside the
        calling step's trace. The threads are joined before return —
        nothing outlives the call."""
        deadline = (None if deadline_ms is None
                    else time.monotonic() + float(deadline_ms) / 1e3)
        rows = np.asarray(rows, np.int64)
        if rows.size == 0:
            return np.zeros((0, self._dim(table)), np.float32)
        sels = [(s, sel) for s, sel in
                ((s, np.nonzero(rows % len(self.urls) == s)[0])
                 for s in range(len(self.urls)))
                if sel.size]
        out: Optional[np.ndarray] = None
        if len(sels) == 1:  # one owner: no thread overhead
            s, sel = sels[0]
            got = self._pull_shard(s, table, rows[sel], deadline)
            out = np.zeros((rows.size, got.shape[1]), np.float32)
            out[sel] = got
        else:
            ctx = _tracing.current_context()
            results: List[Optional[np.ndarray]] = [None] * len(sels)
            errors: List[BaseException] = []

            def one(i: int, s: int, sel: np.ndarray) -> None:
                try:
                    with _tracing.attached_ctx(ctx):
                        results[i] = self._pull_shard(
                            s, table, rows[sel], deadline)
                except Exception as e:
                    errors.append(e)

            threads = [threading.Thread(
                target=one, args=(i, s, sel), daemon=True,
                name=f"dl4j-ps-pull-{s}")
                for i, (s, sel) in enumerate(sels)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            if errors:  # same contract as the old serial walk: the
                # first shard failure propagates to the caller
                raise errors[0]
            for (s, sel), got in zip(sels, results):
                if out is None:
                    out = np.zeros((rows.size, got.shape[1]), np.float32)
                out[sel] = got
        self._dims.setdefault(table, int(out.shape[1]))
        return out

    def push_async(self, table: str, rows: np.ndarray,
                   deltas: np.ndarray) -> None:
        deltas = np.asarray(deltas, np.float32)
        if deltas.ndim != 2 or deltas.shape[0] != np.asarray(rows).size:
            raise ValueError(  # fail at the call site, not in the drain
                f"deltas must be [n_rows, dim], got {deltas.shape}")
        # the enqueue-time span context rides the item: the drain thread
        # attaches it, so the push RPC's spans (and its traceparent to
        # the server) stay in the trace of the step that produced the
        # deltas instead of rooting fresh per-push traces
        item = (table, np.asarray(rows, np.int64),
                np.asarray(deltas, np.float32),
                _tracing.current_context())
        if self._stop.is_set() or not self._worker.is_alive():
            # the drain is gone: an enqueue would never be serviced —
            # count the drop instead of losing gradient mass silently
            self.dropped_pushes += 1
            self._m_dropped.inc()
            logger.warning("PS push dropped (%d total): drain thread gone",
                           self.dropped_pushes)
            return
        try:
            self._q.put_nowait(item)
        except queue.Full:
            # backpressure: block — dropping would lose gradient mass.
            # Abortable: if the drain thread died (or close() ran), a
            # blocked producer counts a drop instead of wedging forever
            try:
                put_abortable(self._q, item,
                              abort=lambda: (self._stop.is_set()
                                             or not self._worker.is_alive()))
            except QueueAborted:
                self.dropped_pushes += 1
                self._m_dropped.inc()
                logger.warning(
                    "PS push dropped (%d total): drain thread gone",
                    self.dropped_pushes)

    def close(self):
        """Stop accepting pushes and retire the drain thread. Pushes
        already queued are still delivered (queued items win over the
        stop flag), so close() waits up to ~10s; against a dead endpoint
        delivery can outlast the join timeout — the daemon thread then
        finishes (or dies) on its own. Parked pushes get one last
        single-shot delivery attempt; whatever still cannot land is
        accounted as dropped — a closing client must not pretend parked
        work will ever flush."""
        self._stop.set()
        self._worker.join(timeout=10)
        if not self._worker.is_alive():
            self._flush_pending()
            for s, pend in enumerate(self._pending):
                while pend:
                    pend.popleft()
                    self._count_drop(
                        f"client closed with endpoint {s} still down")
        _health.get_health().unregister(self._hb)

    def _count_drop(self, why):
        self.dropped_pushes += 1
        self._m_dropped.inc()
        logger.warning("PS push dropped (%d total): %s",
                       self.dropped_pushes, why)

    def _deliver(self, table: str, rows: np.ndarray, deltas: np.ndarray,
                 ctx=None):
        """Route one push batch: per owning shard, the payload joins that
        endpoint's FIFO (behind anything parked from an outage — arrival
        order per shard is preserved) and the FIFO is flushed head-first."""
        for s in range(len(self.urls)):
            sel = np.nonzero(rows % len(self.urls) == s)[0]
            if sel.size == 0:
                continue
            # [payload, failed_before, ctx]: the flag turns a later
            # delivery into a counted replay; the span context stays with
            # ITS payload, so a parked push replayed while a newer item
            # drains still reports under the trace that produced it
            self._pending[s].append(
                [_pack_request(table, rows[sel], deltas[sel],
                               wire_dtype=self.wire_dtype), False, ctx])
            self._flush_endpoint(s)

    def _flush_endpoint(self, s: int):
        pend = self._pending[s]
        while pend:
            rec = pend[0]
            try:
                with _tracing.attached_ctx(rec[2]):
                    self._post_with_retry(self.urls[s], "/push.bin", rec[0])
            except Exception as e:
                rec[1] = True
                if self.replay_capacity == 0:
                    # failover disabled: the old drop-and-move-on path
                    pend.popleft()
                    self._count_drop(e)
                elif len(pend) > self.replay_capacity:
                    # overflow evicts the OLDEST parked push (its loss is
                    # the least stale) — and is the ONLY way a push is
                    # lost while the client lives
                    pend.popleft()
                    self._count_drop(
                        f"replay buffer full ({self.replay_capacity}) "
                        f"while endpoint {s} is down: {e}")
                return
            pend.popleft()
            if rec[1]:
                self._m_replayed.inc()

    def _flush_pending(self):
        for s in range(len(self.urls)):
            if self._pending[s]:
                self._flush_endpoint(s)

    def _drain(self):
        while True:
            try:
                # timeout-ful get doubles as the retry tick: while the
                # producer is quiet, parked pushes get re-attempted, so
                # a recovered endpoint converges without new traffic
                item = self._q.get(timeout=0.25)
            except queue.Empty:
                if self._stop.is_set():
                    return
                if any(self._pending):
                    with self._hb.busy():
                        self._flush_pending()
                continue
            table, rows, deltas, ctx = item
            try:
                with self._hb.busy():
                    self._deliver(table, rows, deltas, ctx)
            finally:
                self._q.task_done()

    def flush(self, timeout: float = 30.0) -> bool:
        """Wait until every push queued BEFORE this call has been
        ATTEMPTED (delivered or parked), bounded by `timeout`. Returns
        True when the drain caught up, False on timeout.

        This waits on the queue's unfinished-task count, NOT emptiness:
        the last item leaves the queue before its POST lands, so an
        emptiness poll lets a caller read tables the final delta has not
        reached yet (the RemoteUIStatsStorageRouter bug class).
        And unlike a bare `Queue.join()`, the wait is bounded — a drain
        thread that died with items still queued (task_done never runs)
        or an endpoint wedged past its socket timeout makes this return
        False at the deadline instead of hanging forever past the
        advertised timeout. Parked pushes (endpoint down) are excluded —
        they wait for the endpoint, not for this call; `pending_pushes()`
        exposes them."""
        deadline = time.monotonic() + timeout
        q = self._q
        with q.all_tasks_done:
            while q.unfinished_tasks:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                q.all_tasks_done.wait(remaining)
        return True

    def queued_pushes(self) -> int:
        """Push batches enqueued but not yet fully attempted — includes
        the in-flight item the drain is currently delivering (0 means
        every accepted push has been delivered or parked)."""
        return int(self._q.unfinished_tasks)

    def pending_pushes(self) -> int:
        """Push payloads parked for replay across all endpoints."""
        return sum(len(p) for p in self._pending)

"""Stats storage SPI + implementations.

Reference contract: api/storage/StatsStorage.java (sessions -> static
info + ordered updates, with attachable listeners notified on new
records) and the StatsStorageRouter producer side. Impls here:

- InMemoryStatsStorage — dict-backed (reference: InMemoryStatsStorage)
- FileStatsStorage     — append-only log of binary records (codec.py),
  readable cold (reference: FileStatsStorage)
- SqliteStatsStorage   — indexed durable store (reference:
  MapDBStatsStorage / J7FileStatsStorage)
- RemoteUIStatsStorageRouter — HTTP POST producer for a remote UI server
  (reference: RemoteReceiverModule + remote-iterationlisteners)

The port of the JAX package's ui/storage.py: the file-storage log, the
SQLite schema and the remote routes are the same bytes, so a stats file
or a remote stream written by either package reads in the other.
"""

from __future__ import annotations

import json
import os
import queue
import struct
import threading
import urllib.request
from typing import Callable, Dict, List, Optional

from deeplearning4j_tpu_torch.ui.codec import decode_record, encode_record
from deeplearning4j_tpu_torch.utils import health as _health
from deeplearning4j_tpu_torch.utils import tracing as _tracing
from deeplearning4j_tpu_torch.utils.concurrency import QueueAborted, get_abortable
from deeplearning4j_tpu_torch.utils.jsonhttp import traced_headers


class StatsStorageRouter:
    """Producer-side SPI (reference: api/storage/StatsStorageRouter.java)."""

    def put_static_info(self, session_id: str, info: dict) -> None:
        raise NotImplementedError

    def put_update(self, session_id: str, record: dict) -> None:
        raise NotImplementedError


class StatsStorage(StatsStorageRouter):
    """Reader-side SPI (reference: api/storage/StatsStorage.java)."""

    def list_session_ids(self) -> List[str]:
        raise NotImplementedError

    def get_static_info(self, session_id: str) -> Optional[dict]:
        raise NotImplementedError

    def get_updates(self, session_id: str,
                    since_iteration: int = -1) -> List[dict]:
        raise NotImplementedError

    def latest_session_id(self) -> Optional[str]:
        """Most recently ACTIVE session — newest update timestamp, falling
        back to the static start_time for sessions that have not reported
        an update yet. The ONE definition of "current session" shared by
        the dashboard (ui/server.py) and the standalone report
        (ui/report.py); random session-id suffixes don't sort by age."""
        ids = self.list_session_ids()
        if not ids:
            return None

        def last_ts(sid):
            ups = self.get_updates(sid)
            if ups:
                return ups[-1].get("ts", 0.0)
            st = self.get_static_info(sid) or {}
            return st.get("start_time", 0.0)

        return max(ids, key=last_ts)

    # listener routing (reference: StatsStorageListener)
    def register_listener(self, fn: Callable[[str, dict], None]) -> None:
        if not hasattr(self, "_listeners"):
            self._listeners = []
        self._listeners.append(fn)

    def _notify(self, session_id: str, record: dict) -> None:
        for fn in getattr(self, "_listeners", []):
            fn(session_id, record)


class InMemoryStatsStorage(StatsStorage):
    def __init__(self):
        self._static: Dict[str, dict] = {}
        self._updates: Dict[str, List[dict]] = {}
        self._lock = threading.Lock()

    def put_static_info(self, session_id, info):
        with self._lock:
            self._static[session_id] = dict(info)
            self._updates.setdefault(session_id, [])

    def put_update(self, session_id, record):
        with self._lock:
            self._updates.setdefault(session_id, []).append(dict(record))
        self._notify(session_id, record)

    def list_session_ids(self):
        with self._lock:
            return sorted(set(self._static) | set(self._updates))

    def get_static_info(self, session_id):
        with self._lock:
            return self._static.get(session_id)

    def get_updates(self, session_id, since_iteration=-1):
        with self._lock:
            ups = list(self._updates.get(session_id, []))
        return [u for u in ups if u.get("iteration", 0) > since_iteration]


def _downsample_oldest(rows: List[dict], cap: int) -> List[dict]:
    """Retention/compaction policy shared by the durable stats stores:
    keep the NEWEST `cap // 2` rows raw and thin the older remainder by
    uniform stride so the total lands back at <= `cap` — history keeps
    its full time extent at reduced resolution while recent records stay
    exact (the rollup idea from utils/runledger, applied to the
    reference's unbounded StatsStorage). The newest row always survives
    and order is preserved, so `get_updates(since_iteration=...)`
    answers consistently on a capped store."""
    if len(rows) <= cap:
        return rows
    tail_n = max(1, cap // 2)
    head, tail = rows[:-tail_n], rows[-tail_n:]
    keep_n = max(1, cap - tail_n)
    stride = max(1, -(-len(head) // keep_n))  # ceil division
    return head[::stride] + tail


class FileStatsStorage(StatsStorage):
    """Append-only log: [u8 kind][u16 session_len][session utf8]
    [u32 payload_len][payload] where kind 0 = static JSON, 1 = binary
    update record. Cold-readable — open an existing path to browse a
    finished run (the dashboard does exactly this).

    `max_updates_per_session` bounds the per-session update rows: past
    the cap the OLDEST records are downsampled (uniform stride over the
    older half; the newest half stays raw) and the log is compacted via
    tmp + os.replace — a reference FileStatsStorage fed by a week-long
    soak grows without bound; this one converges to ~cap rows per
    session. 0/None disables (the reference behavior)."""

    _KIND_STATIC = 0
    _KIND_UPDATE = 1

    def __init__(self, path: str,
                 max_updates_per_session: Optional[int] = None):
        self.path = path
        self.max_updates_per_session = (
            int(max_updates_per_session) if max_updates_per_session
            else None)
        if self.max_updates_per_session is not None \
                and self.max_updates_per_session < 2:
            raise ValueError("max_updates_per_session must be >= 2")
        self._lock = threading.Lock()
        self._static: Dict[str, dict] = {}
        self._updates: Dict[str, List[dict]] = {}
        if os.path.exists(path):
            self._load()
            if self.max_updates_per_session is not None:
                with self._lock:
                    self._compact_locked()
        else:
            open(path, "wb").close()

    def _load(self):
        with open(self.path, "rb") as f:
            data = f.read()
        off = 0
        while off < len(data):
            kind = data[off]
            off += 1
            (slen,) = struct.unpack_from("<H", data, off)
            off += 2
            session = data[off:off + slen].decode()
            off += slen
            (plen,) = struct.unpack_from("<I", data, off)
            off += 4
            payload = data[off:off + plen]
            off += plen
            if kind == self._KIND_STATIC:
                self._static[session] = json.loads(payload)
            else:
                self._updates.setdefault(session, []).append(
                    decode_record(payload))

    def _append(self, kind: int, session_id: str, payload: bytes):
        sb = session_id.encode()
        with open(self.path, "ab") as f:
            f.write(bytes([kind]) + struct.pack("<H", len(sb)) + sb
                    + struct.pack("<I", len(payload)) + payload)

    def put_static_info(self, session_id, info):
        with self._lock:
            self._static[session_id] = dict(info)
            self._append(self._KIND_STATIC, session_id,
                         json.dumps(info).encode())

    def put_update(self, session_id, record):
        encoded = encode_record(record)
        with self._lock:
            rows = self._updates.setdefault(session_id, [])
            rows.append(decode_record(encoded))
            self._append(self._KIND_UPDATE, session_id, encoded)
            cap = self.max_updates_per_session
            if cap is not None and len(rows) > cap + cap // 2:
                # compact only past cap*1.5, so the rewrite amortizes
                # over cap/2 appends instead of running per record
                self._compact_locked()
        self._notify(session_id, record)

    def _compact_locked(self):
        cap = self.max_updates_per_session
        changed = False
        for sid, rows in self._updates.items():
            if len(rows) > cap:
                self._updates[sid] = _downsample_oldest(rows, cap)
                changed = True
        if not changed:
            return
        tmp = f"{self.path}.tmp.{os.getpid()}"
        with open(tmp, "wb") as f:
            for sid, info in self._static.items():
                payload = json.dumps(info).encode()
                sb = sid.encode()
                f.write(bytes([self._KIND_STATIC])
                        + struct.pack("<H", len(sb)) + sb
                        + struct.pack("<I", len(payload)) + payload)
            for sid, rows in self._updates.items():
                sb = sid.encode()
                for u in rows:
                    payload = encode_record(u)
                    f.write(bytes([self._KIND_UPDATE])
                            + struct.pack("<H", len(sb)) + sb
                            + struct.pack("<I", len(payload)) + payload)
        os.replace(tmp, self.path)

    def list_session_ids(self):
        with self._lock:
            return sorted(set(self._static) | set(self._updates))

    def get_static_info(self, session_id):
        with self._lock:
            return self._static.get(session_id)

    def get_updates(self, session_id, since_iteration=-1):
        with self._lock:
            ups = list(self._updates.get(session_id, []))
        return [u for u in ups if u.get("iteration", 0) > since_iteration]


class SqliteStatsStorage(StatsStorage):
    """Indexed durable storage — the MapDBStatsStorage /
    J7FileStatsStorage analog (reference:
    deeplearning4j-ui-model/.../storage/mapdb/MapDBStatsStorage.java,
    sqlite J7FileStatsStorage): unlike the append-only FileStatsStorage
    (which replays the whole log on open), records live in an indexed
    database, so `get_updates(since_iteration=...)` is a range query and
    opening a million-record run does not re-parse a million records.
    stdlib sqlite3, same binary record codec as the file store."""

    def __init__(self, path: str,
                 max_updates_per_session: Optional[int] = None):
        import sqlite3

        self.path = path
        # same retention contract as FileStatsStorage: past the cap,
        # the oldest rows per session are downsampled by uniform stride
        # (DELETE by rowid — no file rewrite needed here)
        self.max_updates_per_session = (
            int(max_updates_per_session) if max_updates_per_session
            else None)
        if self.max_updates_per_session is not None \
                and self.max_updates_per_session < 2:
            raise ValueError("max_updates_per_session must be >= 2")
        self._lock = threading.Lock()
        self._db = sqlite3.connect(path, check_same_thread=False)
        # WAL + NORMAL: per-record commits without a per-record fsync —
        # durable to application crash, and ~100x the insert rate of the
        # default rollback journal (the J7FileStatsStorage role demands
        # per-iteration inserts)
        self._db.execute("PRAGMA journal_mode=WAL")
        self._db.execute("PRAGMA synchronous=NORMAL")
        self._db.execute(
            "CREATE TABLE IF NOT EXISTS static_info ("
            " session TEXT PRIMARY KEY, info TEXT NOT NULL)")
        self._db.execute(
            "CREATE TABLE IF NOT EXISTS updates ("
            " session TEXT NOT NULL, iteration INTEGER NOT NULL,"
            " ts REAL NOT NULL, record BLOB NOT NULL)")
        self._db.execute(
            "CREATE INDEX IF NOT EXISTS idx_updates"
            " ON updates (session, iteration)")
        self._db.commit()

    def put_static_info(self, session_id, info):
        with self._lock:
            self._db.execute(
                "INSERT OR REPLACE INTO static_info VALUES (?, ?)",
                (session_id, json.dumps(info)))
            self._db.commit()

    def put_update(self, session_id, record):
        encoded = encode_record(record)
        with self._lock:
            self._db.execute(
                "INSERT INTO updates VALUES (?, ?, ?, ?)",
                (session_id, int(record.get("iteration", 0)),
                 float(record.get("ts", 0.0)), encoded))
            cap = self.max_updates_per_session
            if cap is not None:
                n = self._db.execute(
                    "SELECT COUNT(*) FROM updates WHERE session = ?",
                    (session_id,)).fetchone()[0]
                if n > cap + cap // 2:
                    self._compact_session_locked(session_id, n)
            self._db.commit()
        self._notify(session_id, record)

    def _compact_session_locked(self, session_id: str, n: int):
        """Oldest-first downsample to <= cap rows: the newest cap//2
        stay raw, the older remainder keeps every stride-th row (rowid
        order == insertion order) — same policy as FileStatsStorage's
        _downsample_oldest, expressed as a DELETE."""
        cap = self.max_updates_per_session
        rowids = [r[0] for r in self._db.execute(
            "SELECT rowid FROM updates WHERE session = ?"
            " ORDER BY iteration, rowid", (session_id,))]
        tail_n = max(1, cap // 2)
        head = rowids[:-tail_n]
        keep_n = max(1, cap - tail_n)
        stride = max(1, -(-len(head) // keep_n))
        keep = set(head[::stride])
        drop = [(rid,) for rid in head if rid not in keep]
        self._db.executemany("DELETE FROM updates WHERE rowid = ?", drop)

    def list_session_ids(self):
        with self._lock:
            rows = self._db.execute(
                "SELECT session FROM static_info UNION "
                "SELECT DISTINCT session FROM updates ORDER BY 1"
            ).fetchall()
        return [r[0] for r in rows]

    def get_static_info(self, session_id):
        with self._lock:
            row = self._db.execute(
                "SELECT info FROM static_info WHERE session = ?",
                (session_id,)).fetchone()
        return json.loads(row[0]) if row else None

    def get_updates(self, session_id, since_iteration=-1):
        with self._lock:
            rows = self._db.execute(
                "SELECT record FROM updates WHERE session = ? AND"
                " iteration > ? ORDER BY iteration",
                (session_id, since_iteration)).fetchall()
        return [decode_record(r[0]) for r in rows]

    def latest_session_id(self):
        """Indexed override of the base scan: the dashboard polls this
        per request — decoding every record of every session to find the
        newest timestamp would defeat this store's purpose."""
        with self._lock:
            row = self._db.execute(
                "SELECT session FROM updates ORDER BY ts DESC LIMIT 1"
            ).fetchone()
            if row is None:
                row = self._db.execute(
                    "SELECT session, json_extract(info, '$.start_time')"
                    " AS st FROM static_info ORDER BY st DESC LIMIT 1"
                ).fetchone()
        return row[0] if row else None

    def close(self):
        with self._lock:
            self._db.close()


class RemoteUIStatsStorageRouter(StatsStorageRouter):
    """POSTs records to a UIServer's /remote endpoint (reference:
    RemoteUIStatsStorageRouter + RemoteReceiverModule). Fire-and-forget:
    records go through a bounded queue drained by a daemon thread, so a
    slow or dead dashboard never blocks the training loop — when the
    queue is full the OLDEST record is dropped."""

    def __init__(self, url: str, timeout: float = 2.0,
                 queue_size: int = 256):
        self.url = url.rstrip("/")
        self.timeout = timeout
        self._q: "queue.Queue[tuple]" = queue.Queue(maxsize=queue_size)
        self._stop = threading.Event()
        # liveness: busy only while posting one record — a wedged
        # dashboard connection past its timeout shows up as a
        # `component_health{component=ui_remote_router}` stall
        self._hb = _health.get_health().register(
            "ui_remote_router", stall_after=max(60.0, 4.0 * timeout))
        self._worker = threading.Thread(target=self._drain, daemon=True,
                                        name="dl4j-ui-remote-router")
        self._worker.start()

    def close(self):
        """Stop accepting records and retire the drain thread. Records
        already queued are still posted (the drain empties the queue
        before honoring the stop); close() waits up to ~10s for that —
        call flush() first when delivery must be confirmed."""
        self._stop.set()
        self._worker.join(timeout=10)
        _health.get_health().unregister(self._hb)

    def _drain(self):
        while True:
            try:
                route, session_id, body, ctype, ctx = get_abortable(
                    self._q, self._stop)
            except QueueAborted:
                return
            try:
                # attach the enqueue-time span context so the POST (and
                # its traceparent header) joins the training step's trace
                # across this queue hop instead of rooting a fresh one
                with self._hb.busy(), _tracing.attached_ctx(ctx):
                    req = urllib.request.Request(
                        f"{self.url}{route}", data=body,
                        headers=traced_headers(
                            {"Content-Type": ctype,
                             "X-Session-Id": session_id}))
                    with _tracing.span("ui/remote_post", route=route):
                        urllib.request.urlopen(
                            req, timeout=self.timeout).read()
            except OSError:
                pass  # dashboard unreachable — drop the record
            finally:
                self._q.task_done()

    def _enqueue(self, item):
        while True:
            try:
                self._q.put_nowait(item)
                return
            except queue.Full:
                try:
                    self._q.get_nowait()  # shed the oldest
                    self._q.task_done()
                except queue.Empty:
                    pass

    def flush(self, timeout: float = 10.0):
        """Block until queued records are posted (tests / end of run).
        Waits on unfinished_tasks, not empty(): the final record leaves
        the queue BEFORE its POST completes, and flush returning inside
        that window hands the caller a storage missing it."""
        import time as _time

        deadline = _time.monotonic() + timeout
        while self._q.unfinished_tasks and _time.monotonic() < deadline:
            _time.sleep(0.02)

    def put_static_info(self, session_id, info):
        self._enqueue(("/remote/static", session_id,
                       json.dumps(info).encode(), "application/json",
                       _tracing.current_context()))

    def put_update(self, session_id, record):
        self._enqueue(("/remote/update", session_id,
                       encode_record(record), "application/octet-stream",
                       _tracing.current_context()))

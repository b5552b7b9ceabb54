"""Preemption-aware checkpointing — the port of the JAX package's
train/checkpoint.py.

Reference baseline: ModelSerializer zips + early-stopping savers, all
manual. Here: periodic checkpointing as a LISTENER on the existing SPI
plus a preemption signal hook, because rented GPU machines are reclaimed
with a SIGTERM grace window; a run that saves on SIGTERM and resumes
from the newest checkpoint loses at most one save interval.

    listener = CheckpointListener("ckpts/", every_n_iterations=500,
                                  keep_last=3, save_on_preemption=True,
                                  async_save=True)
    net.set_listeners(listener)
    ...
    net2, meta = CheckpointListener.restore_latest("ckpts/")  # on cuda
    # or, continuing an existing object with mid-epoch replay:
    net.fit(iterator, epochs=E, resume_from="ckpts/")

`async_save=True` splits a save into the two costs
utils.model_serializer.ModelSnapshot separates: the fit thread only
CAPTURES (device-side clones of every leaf, since the port's optimizer
updates parameters in place, plus a CUDA event — the blocking `snapshot`
phase of the `checkpoint_save_seconds{phase=...}` histogram) and a
`dl4j-ckpt-writer` daemon waits on the event and does the device-to-host
copy, serialize, compress and rename (`write` phase), so a save does not
stall the step loop. Every checkpoint also carries the net's
TrainState (iteration/epoch + iterator position) for byte-identical
mid-epoch resume; see nn/netbase.py.
"""

from __future__ import annotations

import json
import logging
import os
import queue
import threading
import time
from typing import List, Optional, Tuple

from deeplearning4j_tpu_torch.train.listeners import IterationListener
from deeplearning4j_tpu_torch.utils import blackbox as _blackbox
from deeplearning4j_tpu_torch.utils import faultpoints as _faults
from deeplearning4j_tpu_torch.utils import health as _health
from deeplearning4j_tpu_torch.utils import metrics as _metrics
from deeplearning4j_tpu_torch.utils import sigchain as _sigchain
from deeplearning4j_tpu_torch.utils import tracing as _tracing
from deeplearning4j_tpu_torch.utils.concurrency import QueueAborted, get_abortable

logger = logging.getLogger("deeplearning4j_tpu_torch")

_LATEST = "latest.json"


def scan_checkpoints(directory: str) -> List[Tuple[int, str]]:
    """(iteration, filename) for every complete checkpoint zip in
    `directory`, ascending by iteration — the metadata-independent view
    (in-flight `*.tmp` writes never appear: the atomic rename publishes
    a zip only once it is whole)."""
    out = []
    try:
        names = os.listdir(directory)
    except OSError:
        return out
    for f in names:
        if f.startswith("checkpoint_iter") and f.endswith(".zip"):
            try:
                out.append((int(f[len("checkpoint_iter"):-len(".zip")]), f))
            except ValueError:
                continue
    return sorted(out)


def checkpoint_candidates(directory: str):
    """Yield (path, meta) newest-first: the `latest.json` target leads
    when it exists, then the scanned zips (deduped, each zip's own meta)
    — the metadata file is an accelerator, never a single point of
    failure. Zips whose embedded meta cannot be read are still yielded,
    flagged `"unreadable": True`, so the VERIFIED consumers can reject
    them loudly instead of silently stepping past corruption."""
    seen = set()
    meta_path = os.path.join(directory, _LATEST)
    try:
        with open(meta_path) as f:
            meta = json.load(f)
        path = os.path.join(directory, meta["file"])
        if os.path.exists(path):
            seen.add(meta["file"])
            yield path, dict(meta)
        else:
            logger.warning("checkpoint metadata points at missing %r; "
                           "falling back to a directory scan",
                           meta["file"])
    except FileNotFoundError:
        pass
    except (OSError, ValueError, KeyError, json.JSONDecodeError):
        logger.warning("torn/unreadable %s in %r; falling back to a "
                       "directory scan", _LATEST, directory)
    import zipfile

    for it, name in reversed(scan_checkpoints(directory)):
        if name in seen:
            continue
        path = os.path.join(directory, name)
        meta = {
            "iteration": it,
            "epoch": 0,
            "reason": "scan",  # recovered without metadata
            "file": name,
        }
        try:
            meta["ts"] = os.path.getmtime(path)
            with zipfile.ZipFile(path) as zf:
                zmeta = json.loads(zf.read("meta.json").decode("utf-8"))
            meta["iteration"] = int(zmeta.get("iteration", it))
            meta["epoch"] = int(zmeta.get("epoch", 0))
        except Exception:
            meta["unreadable"] = True
        yield path, meta


def latest_checkpoint(directory: str) -> Optional[Tuple[str, dict]]:
    """(path, meta) of the newest READABLE checkpoint, or None when the
    directory holds none. Metadata-level only (unreadable zips are skipped with a warning); the restore
    paths use `verified_checkpoints` instead, which additionally checks
    each candidate's SHA-256 digest manifest."""
    for path, meta in checkpoint_candidates(directory):
        if meta.get("unreadable"):
            logger.warning("skipping unreadable checkpoint %r",
                           meta.get("file"))
            continue
        return path, meta
    return None


class NoUsableCheckpointError(RuntimeError):
    """Checkpoints EXISTED in the directory but every one was rejected
    (digest mismatch, failed load, tainted/non-finite). Deliberately
    distinct from the empty-directory fresh start: a preemptible pod
    restarting over a rotted sole checkpoint must stop for an operator,
    not silently restart from iteration 0 and then GC the evidence."""


def note_bad_checkpoint(path: str, why: str) -> None:
    """Account one rejected checkpoint — loudly: a counter (the
    fallback is observable, not silent), a flight-recorder event
    (`cli blackbox` shows the corruption in the incident timeline), and
    an ERROR log naming the file and the reason."""
    _metrics.get_registry().counter(
        "checkpoint_integrity_failures_total",
        "checkpoints rejected at restore time (digest mismatch, "
        "unreadable entries, failed load, or non-finite params) — each "
        "rejection fell back to the previous good checkpoint").labels() \
        .inc()
    _blackbox.get_recorder().record_event(
        "checkpoint_corrupt", checkpoint=str(path), why=str(why)[:300])
    logger.error("checkpoint %s rejected: %s — falling back to the "
                 "previous good checkpoint", path, why)


def verified_checkpoints(directory: str):
    """Yield (path, meta) newest-first, SKIPPING — loudly, counted via
    `note_bad_checkpoint` — every candidate whose per-entry SHA-256
    manifest fails verification (bit flip, torn entry, missing entry).
    Pre-digest legacy checkpoints carry no manifest and pass through
    unverified (`verify_checkpoint` reports them `legacy`), so old
    checkpoint directories keep restoring."""
    from deeplearning4j_tpu_torch.utils.model_serializer import verify_checkpoint

    for path, meta in checkpoint_candidates(directory):
        v = verify_checkpoint(path)
        if not v["ok"]:
            bad = [f"{name}:{entry['status']}"
                   for name, entry in v["entries"].items()
                   if entry["status"] != "ok"]
            note_bad_checkpoint(
                path, "integrity verification failed ("
                      + (", ".join(bad) or v.get("error", "unknown"))
                      + ")")
            continue
        yield path, meta


def describe_latest(directory: str) -> Optional[dict]:
    """Operator view of the newest checkpoint (cli resume): meta plus
    age and absolute path. None when the directory holds none."""
    found = latest_checkpoint(directory)
    if found is None:
        return None
    path, meta = found
    out = dict(meta)
    out["path"] = path
    ts = meta.get("ts")
    out["age_seconds"] = None if ts is None else max(0.0, time.time() - ts)
    from deeplearning4j_tpu_torch.utils.model_serializer import read_train_state

    try:
        out["train_state"] = read_train_state(path)
    except Exception:
        out["train_state"] = None
    return out


def corrupt_zip_entry(path: str, entry: Optional[str] = None) -> str:
    """Flip one byte inside a zip entry's stored data — the `corrupt`
    fault kind's damage, also used directly by the corruption-fallback
    tests. Targets the largest entry by default (the parameter payload:
    the flip that would silently train a wrong model if restored
    unverified). Returns the damaged entry's name."""
    import zipfile

    with zipfile.ZipFile(path, "r") as zf:
        infos = [i for i in zf.infolist()
                 if entry is None or i.filename == entry]
        if not infos:
            raise ValueError(f"no such entry {entry!r} in {path}")
        info = max(infos, key=lambda i: i.compress_size)
    with open(path, "r+b") as f:
        # the local file header's name/extra lengths may differ from the
        # central directory's — read them from the header itself
        f.seek(info.header_offset + 26)
        nlen = int.from_bytes(f.read(2), "little")
        elen = int.from_bytes(f.read(2), "little")
        data_off = info.header_offset + 30 + nlen + elen
        pos = data_off + min(8, max(0, info.compress_size - 1))
        f.seek(pos)
        b = f.read(1)
        f.seek(pos)
        f.write(bytes([b[0] ^ 0x55]))
    logger.warning("corrupted zip entry %r in %s (injected byte flip)",
                   info.filename, path)
    return info.filename


class CheckpointListener(IterationListener):
    """Periodic + preemption-triggered model saves with retention.

    every_n_iterations / every_n_epochs / every_n_seconds: any
    combination; a save fires when any schedule is due.
    keep_last: retain the newest N checkpoints (0 = keep all).
    save_on_preemption: register a SIGTERM action (utils/sigchain, at
    PRIORITY_SAVE — always before the flight recorder's crash dump) that
    saves synchronously before the process dies (the cloud preemption
    contract). During a fit the chain is held until the step is whole
    (utils/sigchain.deferred), so the save never holds half a step.
    async_save: the fit thread only snapshots (device-side clones); a
    `dl4j-ckpt-writer` daemon serializes and renames in the background.
    At most `queue_depth` snapshots wait; when the writer falls behind,
    the OLDEST queued snapshot is coalesced away (counted) — the newest
    state always wins."""

    def __init__(self, directory: str, *,
                 every_n_iterations: Optional[int] = None,
                 every_n_epochs: Optional[int] = 1,
                 every_n_seconds: Optional[float] = None,
                 keep_last: int = 3,
                 save_updater: bool = True,
                 save_on_preemption: bool = False,
                 async_save: bool = False,
                 queue_depth: int = 2):
        self.dir = directory
        os.makedirs(directory, exist_ok=True)
        self.every_iter = every_n_iterations
        self.every_epoch = every_n_epochs
        self.every_seconds = every_n_seconds
        self.keep_last = int(keep_last)
        self.save_updater = save_updater
        self.async_save = bool(async_save)
        self.queue_depth = max(1, int(queue_depth))
        self._last_time = time.monotonic()
        self._model = None
        self._lock = threading.Lock()    # one save() call at a time
        self._io_lock = threading.Lock()  # serializes zip/meta file IO
        self._writer_q: Optional["queue.Queue"] = None
        self._writer_t: Optional[threading.Thread] = None
        self._writer_stop = threading.Event()
        self._writer_hb: Optional[_health.Heartbeat] = None
        self._closed = False
        reg = _metrics.get_registry()
        self._m_saves = reg.counter(
            "checkpoint_saves_total", "checkpoints written", ("reason",))
        self._m_phase = reg.histogram(
            "checkpoint_save_seconds",
            "checkpoint save duration by phase: `snapshot` is the "
            "fit-thread blocking part (capture + enqueue under "
            "async_save), `write` the serialize + atomic rename",
            ("phase",))
        self._m_coalesced = reg.counter(
            "checkpoint_coalesced_total",
            "queued snapshots displaced by a newer one before the "
            "async writer got to them").labels()
        self._m_failures = reg.counter(
            "checkpoint_save_failures_total",
            "checkpoint writes that raised (save skipped, training "
            "unaffected)").labels()
        if save_on_preemption:
            self._install_preemption_hook()

    # -- listener hooks -------------------------------------------------------

    def iteration_done(self, model, iteration, info):
        self._model = model
        due = (self.every_iter is not None and iteration > 0
               and iteration % self.every_iter == 0)
        if (not due and self.every_seconds is not None
                and time.monotonic() - self._last_time >= self.every_seconds):
            due = True
        if due:
            self.save(model, reason="schedule")

    def on_epoch_end(self, model, epoch):
        self._model = model
        if self.every_epoch is not None and (epoch + 1) % self.every_epoch == 0:
            self.save(model, reason="epoch")

    def on_fit_end(self, model):
        # a fit that returns (or raises) leaves no checkpoint still in
        # flight: the resume contract starts where the fit ended
        self.flush()

    # -- saving ---------------------------------------------------------------

    def save(self, model, reason: str = "manual",
             blocking: bool = True) -> Optional[str]:
        """blocking=False (the SIGTERM handler) skips instead of waiting:
        if a save is already mid-capture on this thread, re-entering
        would corrupt it — and its result is at most one interval stale.
        Returns the checkpoint path (under async_save: the path the
        background writer will publish)."""
        from deeplearning4j_tpu_torch.utils.model_serializer import ModelSnapshot

        plan = getattr(model, "_mesh_plan", None)
        if plan is not None and not plan.is_writer():
            # under a mesh every rank holds the same state and only rank 0
            # writes; every rank restores (fit(resume_from=...) waits for
            # the writer, then the plan re-broadcasts rank 0's state)
            return None
        if not self._lock.acquire(blocking=blocking):
            logger.warning("checkpoint save already in flight; skipping "
                           "(%s)", reason)
            return None
        try:
            t0 = time.perf_counter()
            ts_fn = getattr(model, "train_state", None)
            train_state = ts_fn() if callable(ts_fn) else None
            with _tracing.span("checkpoint/snapshot", reason=reason):
                snap = ModelSnapshot.capture(model, self.save_updater,
                                             train_state=train_state)
            name = f"checkpoint_iter{snap.iteration:09d}.zip"
            path = os.path.join(self.dir, name)
            # preemption writes synchronously even under async_save: the
            # process is dying, there is no background left to defer to.
            # Same after close(): its contract is "saves synchronously
            # afterwards" — re-entering the async path would respawn a
            # writer thread + heartbeat nothing will ever retire
            if self.async_save and not self._closed and reason != "preemption":
                self._ensure_writer()
                self._enqueue(snap, reason)
                self._m_phase.labels("snapshot").observe(
                    time.perf_counter() - t0)
                self._last_time = time.monotonic()
                return path
            self._m_phase.labels("snapshot").observe(
                time.perf_counter() - t0)
            out = self._write_snapshot(snap, reason)
            self._last_time = time.monotonic()
            return out
        finally:
            self._lock.release()

    def _enqueue(self, snap, reason: str):
        q = self._writer_q
        while True:
            try:
                q.put_nowait((snap, reason))
                return
            except queue.Full:
                # the writer fell behind: displace the OLDEST pending
                # snapshot (the newest state always wins) and say so
                try:
                    q.get_nowait()
                    q.task_done()
                    self._m_coalesced.inc()
                    logger.warning(
                        "checkpoint writer behind; coalesced an older "
                        "queued snapshot (%s)", reason)
                except queue.Empty:
                    continue

    def _write_snapshot(self, snap, reason: str) -> Optional[str]:
        """Serialize one captured snapshot to its zip + metadata —
        shared by the synchronous path and the background writer (which
        is why the file IO has its own lock: a preemption save must be
        able to run while the writer owns an older snapshot)."""
        name = f"checkpoint_iter{snap.iteration:09d}.zip"
        path = os.path.join(self.dir, name)
        tmp = f"{path}.{os.getpid()}.{reason}.tmp"  # unique per writer
        t0 = time.perf_counter()
        with self._io_lock:
            with _tracing.span("checkpoint/write", reason=reason):
                # chaos hook: an `error` fault before the write is a
                # full-disk / dead-volume save failure; landing before
                # snap.write means no tmp file is ever created, and one
                # BETWEEN write and replace would be the torn-file case
                # the atomic rename makes survivable (the .tmp is
                # swept by _gc, latest.json still names the previous
                # good checkpoint). A `corrupt` fault byte-flips an
                # entry of the zip that WAS written — the silent
                # bit-rot case the digest manifest + restore fallback
                # exist for, made deterministically replayable.
                injected = _faults.fault_point("ckpt_write", reason=reason)
                snap.write(tmp)
                if injected == "corrupt":
                    corrupt_zip_entry(tmp)
                os.replace(tmp, path)  # atomic: never a torn checkpoint
            meta = {
                "iteration": snap.iteration,
                "epoch": snap.epoch,
                "ts": time.time(),
                "reason": reason,
                "file": name,
            }
            self._write_latest(meta)
            self._gc()
        self._m_saves.labels(reason).inc()
        self._m_phase.labels("write").observe(time.perf_counter() - t0)
        _blackbox.get_recorder().record_event(
            "checkpoint_saved", iteration=snap.iteration, reason=reason,
            file=name)
        logger.info("checkpoint saved: %s (%s)", path, reason)
        return path

    def _write_latest(self, meta: dict):
        """Publish `latest.json` the same way the zip is published: tmp +
        `os.replace`, so a crash mid-write can never leave torn JSON
        behind (and restore_latest scans the zips if it somehow does).
        Monotonic: an async writer finishing an OLDER snapshot after a
        preemption save must not roll the pointer back."""
        path = os.path.join(self.dir, _LATEST)
        try:
            with open(path) as f:
                cur = json.load(f)
            if int(cur.get("iteration", -1)) > int(meta["iteration"]):
                return
        except (OSError, ValueError, KeyError, json.JSONDecodeError):
            pass
        tmp = f"{path}.{os.getpid()}.tmp"
        with open(tmp, "w") as f:
            json.dump(meta, f)
        os.replace(tmp, path)

    # -- the background writer ------------------------------------------------

    def _ensure_writer(self):
        if self._writer_t is not None and self._writer_t.is_alive():
            return
        self._writer_stop = threading.Event()
        self._writer_q = queue.Queue(maxsize=self.queue_depth)
        # heartbeat-registered with the watchdog: a writer wedged inside
        # a device pull or filesystem stall flips
        # component_health{component=ckpt_writer} instead of silently
        # letting checkpoints go stale
        self._writer_hb = _health.get_health().register(
            "ckpt_writer", stall_after=300.0)
        self._writer_t = threading.Thread(
            target=self._writer_loop,
            args=(self._writer_q, self._writer_stop, self._writer_hb),
            daemon=True, name="dl4j-ckpt-writer")
        self._writer_t.start()

    def _writer_loop(self, q, stop, hb):
        while True:
            try:
                snap, reason = get_abortable(q, stop)
            except QueueAborted:
                return
            try:
                with hb.busy():
                    self._write_snapshot(snap, reason)
            except Exception:
                # a failed write loses ONE interval, not the run — and
                # never the writer thread (a dead writer would wedge
                # every later save)
                self._m_failures.inc()
                logger.exception("async checkpoint write failed")
            finally:
                q.task_done()

    def flush(self, timeout: float = 120.0):
        """Wait until every queued snapshot is on disk (no-op for the
        synchronous mode)."""
        q = self._writer_q
        if q is None:
            return
        deadline = time.monotonic() + timeout
        while q.unfinished_tasks and time.monotonic() < deadline:
            time.sleep(0.02)
        if q.unfinished_tasks:
            logger.warning("checkpoint flush timed out with %d pending "
                           "write(s)", q.unfinished_tasks)

    def close(self):
        """Flush pending writes and retire the writer thread + signal
        hook. Idempotent; the listener saves synchronously afterwards."""
        self._closed = True
        _sigchain.unregister(self._sig_name())
        self.flush()
        self._writer_stop.set()
        if self._writer_t is not None:
            self._writer_t.join(timeout=10)
            self._writer_t = None
        if self._writer_hb is not None:
            _health.get_health().unregister(self._writer_hb)
            self._writer_hb = None
        self._writer_q = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def _gc(self):
        # orphaned temp files from writers killed mid-save. A tmp file is
        # only an orphan if its embedded pid is not a live process (several
        # hosts may share the dir) AND it hasn't been touched recently —
        # deleting a peer's in-flight write would corrupt its save.
        now = time.time()
        for f in os.listdir(self.dir):
            if ".tmp" in f and f.startswith("checkpoint_iter"):
                path = os.path.join(self.dir, f)
                try:
                    pid = int(f.split(".")[-3])
                except (ValueError, IndexError):
                    pid = None
                if pid is not None and pid != os.getpid():
                    try:
                        os.kill(pid, 0)  # 0 = existence probe, no signal
                        continue  # writer is alive: leave its tmp alone
                    except ProcessLookupError:
                        pass  # dead pid: orphan
                    except OSError:
                        continue  # EPERM etc: play safe, keep the file
                try:
                    if now - os.path.getmtime(path) < 300:
                        continue  # written moments ago: grace window
                    os.remove(path)
                except OSError:
                    pass
        if self.keep_last <= 0:
            return
        ckpts = [name for _, name in scan_checkpoints(self.dir)]
        for stale in ckpts[:-self.keep_last]:
            try:
                os.remove(os.path.join(self.dir, stale))
            except OSError:
                pass

    # -- preemption -----------------------------------------------------------

    def _sig_name(self) -> str:
        return f"checkpoint-save-{id(self):x}"

    def _install_preemption_hook(self):
        def action(signum, frame):
            model = self._model
            if model is not None:
                try:
                    self.save(model, reason="preemption", blocking=False)
                except Exception:
                    logger.exception("preemption save failed")

        # PRIORITY_SAVE < PRIORITY_DUMP: the model hits disk before the
        # flight recorder dumps (the dump then even records the
        # checkpoint_saved event), regardless of which subsystem armed
        # its hook first — see utils/sigchain
        _sigchain.register(self._sig_name(), action,
                           priority=_sigchain.PRIORITY_SAVE)

    # -- resume ---------------------------------------------------------------

    @staticmethod
    def restore_latest(directory: str, load_updater: bool = True, *,
                       device="cuda") -> Tuple[object, dict]:
        """(model, meta) from the newest GOOD checkpoint in `directory`,
        on `device` ("cuda" by default; raises without a GPU unless the
        caller passes device="cpu").
        Raises FileNotFoundError when none exists (fresh start). Survives
        torn/missing `latest.json` by scanning the checkpoint zips, and
        survives a corrupted newest checkpoint: every candidate's
        per-entry SHA-256 manifest is verified (and the load itself is
        allowed to fail) before trusting it — a bit-flipped zip is
        skipped loudly (`checkpoint_integrity_failures_total`, a
        `checkpoint_corrupt` flight-recorder event) and the previous
        good checkpoint is restored instead. When checkpoints EXIST but
        every one is rejected, the error is NoUsableCheckpointError, not
        FileNotFoundError — an `except FileNotFoundError: fresh_start()`
        caller must not silently rebuild over a corrupted history."""
        from deeplearning4j_tpu_torch.common.devices import resolve_device
        from deeplearning4j_tpu_torch.utils.model_serializer import load_model

        dev = resolve_device(device)
        for path, meta in verified_checkpoints(directory):
            t0 = time.perf_counter()
            try:
                with _tracing.span("checkpoint/load", file=meta.get("file")):
                    model = load_model(path, load_updater=load_updater,
                                       device=dev)
            except Exception as e:
                note_bad_checkpoint(
                    path, f"load failed: {type(e).__name__}: {e}")
                continue
            _metrics.get_registry().histogram(
                "checkpoint_load_seconds",
                "checkpoint restore duration").observe(
                    time.perf_counter() - t0)
            return model, meta
        if any(True for _ in checkpoint_candidates(directory)):
            raise NoUsableCheckpointError(
                f"checkpoints exist in {directory!r} but every candidate "
                f"was rejected (see checkpoint_integrity_failures_total "
                f"and the checkpoint_corrupt events)")
        raise FileNotFoundError(f"no checkpoint in {directory!r}")

"""Flight recorder + crash forensics — the black-box half of the
liveness layer (utils/health.py is the watchdog half).

utils/tracing.py records spans only while tracing is ON, because spans
cost a clock read and a ring append per section; a crashed process that
never enabled tracing leaves nothing. The flight recorder borrows the
same bounded-ring design but is ALWAYS on at fixed cost: the fit loop
appends one small step record per dispatch (step index, score reference,
per-phase timings), interesting events (compiles, helper fallbacks,
health transitions) append markers, and every `metrics_every` steps a
cheap scalar delta of the metrics registry is captured. Memory bound:
three bounded deques, regardless of run length.

Forensics surfaces:

* `install_crash_hooks(path)` — SIGTERM gets a Python-level handler that
  writes the structured JSON dump (last steps + events + metrics deltas
  + health status + every thread's Python stack) before the process
  dies; `faulthandler` covers the fatal-signal set (SIGSEGV/SIGFPE/
  SIGABRT/SIGBUS) AND SIGTERM with an async-signal-safe plain-text
  all-thread traceback to `<path>.stacks.txt`, so even a process wedged
  inside a C call leaves the wedged thread's name behind; `sys.excepthook`
  and `atexit` chain in, so an unhandled exception or plain exit also
  leaves the artifact.
* `dump(path, reason)` — the same snapshot on demand (the watchdog's
  hang action calls this before raising StepHangError).
* `render_dump(doc)` — the human view `cli blackbox <dump>` prints: the
  final-steps timeline, events, the OOM forensics of the last `oom`
  event (utils/devprof: the largest live CUDA tensors beside the static
  estimate), component health, and thread stacks. The metrics deltas
  carry the `device_memory_bytes{kind}` levels of each capture, the
  memory trajectory leading into an OOM.

Score handling: the fit loop must never sync the device to feed the
recorder, so step records hold the score *tensor* (on the device) and,
for a CUDA tensor, a `torch.cuda.Event` recorded on the current stream
right after the step; at snapshot time a score is resolved to a float
only when that event's `query()` says the step has finished, else
reported as "pending" — which is itself forensic signal (the last
dispatched step never completed). The port of the JAX package's
utils/blackbox.py, OOM forensics included. Every dump carries the JAX
dump's keys: `tenants` (utils/resourcemeter's snapshot, the chip-budget
view at crash time) and `locks` (utils/locktrace's ownership and
wait-graph forensics, None unless the DL4J_LOCKCHECK sanitizer is
armed).
"""

from __future__ import annotations

import atexit
import faulthandler
import json
import logging
import math
import os
import signal
import sys
import threading
import time
import traceback
from collections import deque
from typing import Dict, List, Optional

import torch

from deeplearning4j_tpu_torch.utils import metrics as _metrics

logger = logging.getLogger("deeplearning4j_tpu_torch")


def _resolve_score(score, done=None) -> object:
    """Float value of a recorded score WITHOUT blocking: a score whose
    step event (`done`, a torch.cuda.Event recorded after the step) has
    not completed reports "pending" (the step never finished — that is
    the finding, not an error); anything unreadable reports None."""
    if score is None:
        return None
    try:
        if done is not None and not done.query():
            return "pending"
        v = float(score)
        return v if math.isfinite(v) else None
    except Exception:
        return None


def thread_stacks() -> List[dict]:
    """Python stacks of every live thread, dl4j-* threads first — the
    "which thread wedged" half of a crash dump."""
    frames = sys._current_frames()
    threads = sorted(
        threading.enumerate(),
        key=lambda t: (not t.name.startswith("dl4j-"), t.name))
    out = []
    for t in threads:
        frame = frames.get(t.ident)
        stack = ([f"{fr.filename}:{fr.lineno} {fr.name}: {fr.line or ''}"
                  .rstrip()
                  for fr in traceback.extract_stack(frame)]
                 if frame is not None else [])
        out.append({"name": t.name, "ident": t.ident,
                    "daemon": t.daemon, "alive": t.is_alive(),
                    "stack": stack})
    return out


class FlightRecorder:
    """Always-on bounded ring of step records + event markers + periodic
    metrics deltas."""

    def __init__(self, capacity: int = 256, events_capacity: int = 256,
                 metrics_every: int = 64):
        self.metrics_every = max(1, int(metrics_every))
        # RLock, deliberately: the SIGTERM dump runs as a Python signal
        # handler on the main thread, which may be interrupted INSIDE a
        # record_step() holding this lock — a plain Lock would deadlock
        # the crash path at exactly the moment it exists for
        self._lock = threading.RLock()
        self._steps: deque = deque(maxlen=int(capacity))
        self._events: deque = deque(maxlen=int(events_capacity))
        self._metrics_deltas: deque = deque(maxlen=32)
        self._step_count = 0
        self._last_scalars: Optional[Dict[str, float]] = None
        self._dump_path: Optional[str] = None  # install_crash_hooks target
        self._dumping = False
        # a signal/unhandled-exception dump was written: the atexit hook
        # must not overwrite the crash-time forensics with a shutdown-
        # time view (threads unwound, reason lost)
        self._crash_dumped = False
        self.last_degradation: Optional[dict] = None
        self.last_dump_path: Optional[str] = None

    # -- recording (hot path) ------------------------------------------------

    def record_step(self, step: int, score=None, **phases):
        """One fit dispatch: a deque append of a small dict; every
        `metrics_every`-th call also captures a registry scalar delta
        (counter/gauge values only — no histogram percentile work)."""
        rec = {"ts": round(time.time(), 3), "step": int(step),
               "score": score}
        if torch.is_tensor(score) and score.is_cuda:
            # the step's completion marker: queried (never waited on)
            # when a dump resolves the score
            done = torch.cuda.Event()
            done.record()
            rec["_done"] = done
        for k, v in phases.items():
            if v is not None:
                rec[k] = round(float(v), 6)
        with self._lock:
            self._steps.append(rec)
            self._step_count += 1
            snap_due = self._step_count % self.metrics_every == 0
        if snap_due:
            self.record_metrics_delta()

    def record_event(self, kind: str, **fields):
        ev = {"ts": round(time.time(), 3), "kind": kind}
        ev.update(fields)
        # cross-reference into the distributed-tracing layer: an event
        # recorded while a span is active carries its trace id, so a
        # crash dump names the trace of the request that was in flight
        # (one flag check when tracing is off; never fatal — the black
        # box must record even if tracing misbehaves)
        if "trace_id" not in ev:
            try:
                from deeplearning4j_tpu_torch.utils import tracing as _tracing

                tid = _tracing.current_trace_id()
                if tid is not None:
                    ev["trace_id"] = tid
            except Exception:
                pass
        with self._lock:
            self._events.append(ev)

    def record_metrics_delta(self):
        """Scalar registry delta since the previous capture — cheap
        (value reads, no histogram sorting), so counters' recent movement
        rides along in a crash dump. The `device_memory_bytes{...}`
        watermark gauges (utils/devprof) additionally ride along as
        ABSOLUTE values per capture: a delta view of a watermark hides
        the level, and the level trajectory is exactly what a post-OOM
        dump needs to show."""
        now = _metrics.get_registry().scalar_values()
        memory = {k: v for k, v in now.items()
                  if k.startswith("device_memory_bytes")}
        with self._lock:
            prev = self._last_scalars
            self._last_scalars = now
            if prev is None:
                return
            delta = {}
            for k, v in now.items():
                dv = v - prev.get(k, 0.0)
                if dv:
                    delta[k] = round(dv, 9)
            if delta or memory:
                entry = {"ts": round(time.time(), 3),
                         "step": self._step_count, "delta": delta}
                if memory:
                    entry["memory"] = memory
                self._metrics_deltas.append(entry)

    def on_degradation(self, component: str, stalled_for: float,
                       threads: List[str]):
        """The watchdog's first-stall hook: record the event and keep an
        in-memory snapshot of the moment (the state most useful for
        diagnosing what led INTO the stall); with crash hooks installed
        the snapshot is also written next to the crash artifact."""
        self.record_event("degraded", component=component,
                          stalled_for_seconds=round(stalled_for, 3),
                          threads=threads)
        snap = self.snapshot(reason=f"component {component!r} degraded")
        self.last_degradation = snap
        if self._dump_path:
            try:
                self._write(self._dump_path + ".degraded.json", snap)
            except OSError:
                logger.warning("degradation snapshot write failed",
                               exc_info=True)

    # -- readout / forensics -------------------------------------------------

    def snapshot(self, reason: str = "") -> dict:
        """JSON-safe dict of everything the black box knows right now:
        steps (scores resolved non-blockingly), events, metrics deltas,
        component health, and all thread stacks."""
        with self._lock:
            steps = [dict(r) for r in self._steps]
            events = [dict(e) for e in self._events]
            deltas = [dict(d) for d in self._metrics_deltas]
            step_count = self._step_count
        for r in steps:
            r["score"] = _resolve_score(r.get("score"), r.pop("_done", None))
        try:
            from deeplearning4j_tpu_torch.utils.health import get_health

            health = get_health().status()
        except Exception:
            health = None
        try:
            # the chip-budget view at crash time: who was spending what
            # when the process died (books always; spend when metered)
            from deeplearning4j_tpu_torch.utils import resourcemeter

            tenants = resourcemeter.snapshot()
        except Exception:
            tenants = None
        try:
            # who holds what and who waits on whom (None unless the
            # DL4J_LOCKCHECK sanitizer is armed): a watchdog-caught hang
            # dumps as a NAMED wait-graph cycle, not a stack soup
            from deeplearning4j_tpu_torch.utils import locktrace

            locks = locktrace.forensics()
        except Exception:
            locks = None
        return {
            "reason": reason,
            "ts": round(time.time(), 3),
            "pid": os.getpid(),
            "argv": list(sys.argv),
            "steps_recorded_total": step_count,
            "last_step": steps[-1]["step"] if steps else None,
            "steps": steps,
            "events": events,
            "metrics_deltas": deltas,
            "health": health,
            "tenants": tenants,
            "locks": locks,
            "threads": thread_stacks(),
        }

    @staticmethod
    def _write(path: str, doc: dict) -> str:
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(doc, f, indent=1, default=str)
        os.replace(tmp, path)  # a reader never sees a half-written dump
        return path

    def dump(self, path: Optional[str] = None, reason: str = "") \
            -> Optional[str]:
        """Write the snapshot to `path` (default: the crash-hook path,
        else dl4j_blackbox_<pid>.json in the tmp dir). Reentrancy-guarded
        — a crash during a dump must not recurse — and never raises: the
        black box is the last thing standing, an exception here would
        shadow the original failure."""
        with self._lock:
            if self._dumping:
                return self.last_dump_path
            self._dumping = True
        try:
            if path is None:
                path = self._dump_path
            if path is None:
                import tempfile

                path = os.path.join(tempfile.gettempdir(),
                                    f"dl4j_blackbox_{os.getpid()}.json")
            out = self._write(path, self.snapshot(reason=reason))
            self.last_dump_path = out
            return out
        except Exception:
            logger.exception("flight-recorder dump failed")
            return None
        finally:
            with self._lock:
                self._dumping = False


# -- the process-global recorder ---------------------------------------------

_RECORDER = FlightRecorder()


def get_recorder() -> FlightRecorder:
    return _RECORDER


# -- crash hooks --------------------------------------------------------------

_hooks_installed = False
_fault_file = None


def install_crash_hooks(path: str, recorder: Optional[FlightRecorder] = None,
                        dump_on_exit: bool = True) -> str:
    """Arm the black box: on SIGTERM, unhandled exception, or interpreter
    exit the recorder dumps to `path`; the fatal-signal set (and SIGTERM)
    additionally get faulthandler's async-signal-safe all-thread
    traceback in `<path>.stacks.txt` (the only layer that still works
    when the interpreter itself is wedged in native code). Idempotent;
    returns `path`. Signal handlers require the main thread — from a
    worker thread only the faulthandler/atexit/excepthook layers arm."""
    global _hooks_installed, _fault_file
    rec = recorder or _RECORDER
    rec._dump_path = path
    if _hooks_installed:
        return path
    _hooks_installed = True

    def _on_sigterm(signum, frame):
        rec.record_event("signal", signum=int(signum))
        rec._crash_dumped = True
        rec.dump(reason=f"signal {signum}")

    # The dump rides the shared SIGTERM chain (utils/sigchain) at
    # PRIORITY_DUMP: a checkpoint listener's preemption save (PRIORITY_
    # SAVE) always runs first and the chain's tail restores die-with-
    # SIGTERM semantics — installation order between the two subsystems
    # no longer decides anything. The chain handler must be installed
    # BEFORE faulthandler.register(chain=True) — last sigaction wins, so
    # the reverse order would displace faulthandler's async-signal-safe
    # C-level dump (the only layer that still fires when the interpreter
    # is wedged inside native code). This way SIGTERM first writes the
    # native stacks.txt, then chains into the JSON dump when the main
    # thread reaches a bytecode boundary.
    from deeplearning4j_tpu_torch.utils import sigchain

    sigchain.register("blackbox-dump", _on_sigterm,
                      priority=sigchain.PRIORITY_DUMP)

    try:
        _fault_file = open(path + ".stacks.txt", "w")
        faulthandler.enable(file=_fault_file)
        faulthandler.register(signal.SIGTERM, file=_fault_file,
                              all_threads=True, chain=True)
    except (OSError, ValueError, AttributeError):
        logger.warning("faulthandler arming failed", exc_info=True)

    prev_excepthook = sys.excepthook

    def _on_unhandled(exc_type, exc, tb):
        rec.record_event("unhandled_exception", type=exc_type.__name__,
                         message=str(exc))
        rec._crash_dumped = True
        rec.dump(reason=f"unhandled {exc_type.__name__}: {exc}")
        prev_excepthook(exc_type, exc, tb)

    sys.excepthook = _on_unhandled

    if dump_on_exit:
        def _on_exit():
            # a normal exit refreshes the artifact with the final state
            # (for a test-session artifact that IS the content wanted) —
            # but never clobbers a crash-time dump with a shutdown-time
            # view whose threads have already unwound
            if not rec._crash_dumped:
                rec.dump(reason="atexit")

        atexit.register(_on_exit)
    return path


# -- rendering (cli blackbox) -------------------------------------------------

def _fmt_ms(rec: dict, key: str) -> str:
    v = rec.get(key)
    return f"{v * 1e3:9.3f}" if isinstance(v, (int, float)) else " " * 9


def render_dump(doc: dict, max_steps: int = 32,
                max_stack_lines: int = 12) -> str:
    """Human-readable view of a dump: final-steps timeline, events,
    health, thread stacks (dl4j-* threads lead — they are the framework's
    own workers, the usual suspects in a wedge)."""
    lines = []
    lines.append(f"blackbox dump — reason: {doc.get('reason') or '?'}  "
                 f"pid {doc.get('pid')}  ts {doc.get('ts')}")
    lines.append(f"steps recorded: {doc.get('steps_recorded_total', 0)}  "
                 f"last step index: {doc.get('last_step')}")
    steps = doc.get("steps") or []
    if steps:
        lines.append("")
        lines.append(f"final {min(len(steps), max_steps)} steps "
                     "(ms; score 'pending' = dispatched, never completed):")
        lines.append("      step       score  data_wait   dispatch")
        for rec in steps[-max_steps:]:
            score = rec.get("score")
            s = (f"{score:11.6g}" if isinstance(score, (int, float))
                 else f"{score or '':>11}")
            lines.append(
                f"  {rec.get('step', '?'):>8} {s} "
                f"{_fmt_ms(rec, 'data_wait')}  {_fmt_ms(rec, 'dispatch')}")
    events = doc.get("events") or []
    if events:
        lines.append("")
        lines.append(f"events (newest last, {len(events)}):")
        for ev in events[-max_steps:]:
            # the trace id renders as its own column: it is the grep key
            # into span exports / logs, not just another payload field
            tid = ev.get("trace_id")
            trace_note = f"  [trace {tid}]" if tid else ""
            if ev.get("kind") == "oom":
                lines.append(f"  {ev.get('ts')}  oom  "
                             f"where={ev.get('where')}{trace_note} "
                             "(see OOM forensics below)")
                continue
            extra = {k: v for k, v in ev.items()
                     if k not in ("ts", "kind", "trace_id")}
            lines.append(f"  {ev.get('ts')}  {ev.get('kind')}"
                         + (f"  {extra}" if extra else "")
                         + trace_note)
    oom = next((ev for ev in reversed(events)
                if ev.get("kind") == "oom"), None)
    if oom is not None:
        lines.append("")
        lines.append(f"OOM forensics — where: {oom.get('where')}")
        lines.append(f"  error: {oom.get('error')}")
        static = oom.get("static") or {}
        for key in ("params_bytes", "updater_bytes",
                    "activation_peak_bytes", "live_bytes"):
            v = static.get(key)
            if isinstance(v, (int, float)):
                lines.append(f"  {key}: {v / 2**20:.2f} MiB")
        la = static.get("largest_activation")
        if la:
            lines.append(f"  largest static activation: shape "
                         f"{la.get('shape')} {la.get('dtype')} "
                         f"({la.get('bytes', 0) / 2**20:.2f} MiB)")
        top = oom.get("top_buffers") or []
        if top:
            lines.append(f"  largest live buffers ({len(top)}):")
            for b in top:
                lines.append(
                    f"    {b.get('nbytes', 0) / 2**20:9.2f} MiB  "
                    f"{b.get('dtype')}{list(b.get('shape') or ())}"
                    f" {b.get('device', '')}")
    # numerical-resilience trail (train/sentinel + checkpoint
    # integrity): one summary block so a dump answers "did this run
    # fight divergence / corruption, and how did that end" at a glance
    # — the individual events stay in the timeline above
    _RESIL = ("train_anomaly", "batch_quarantined",
              "quarantined_batch_skipped", "train_rollback",
              "training_diverged", "checkpoint_corrupt")
    resil = [ev for ev in events if ev.get("kind") in _RESIL]
    if resil:
        lines.append("")
        lines.append("numerical resilience:")
        counts: Dict[str, int] = {}
        for ev in resil:
            counts[ev["kind"]] = counts.get(ev["kind"], 0) + 1
        lines.append("  " + "  ".join(
            f"{k}={counts[k]}" for k in _RESIL if k in counts))
        for ev in resil:
            if ev.get("kind") == "batch_quarantined":
                lines.append(
                    f"  quarantined: epoch {ev.get('epoch')} batch "
                    f"{ev.get('batch_in_epoch')} ({ev.get('anomaly')}, "
                    f"iteration {ev.get('iteration')})")
            elif ev.get("kind") == "train_rollback":
                lines.append(
                    f"  rollback #{ev.get('attempt')} -> "
                    f"{ev.get('directory')} (lr {ev.get('lr')})")
            elif ev.get("kind") == "checkpoint_corrupt":
                lines.append(f"  corrupt checkpoint skipped: "
                             f"{ev.get('checkpoint')} — {ev.get('why')}")
            elif ev.get("kind") == "training_diverged":
                lines.append(f"  DIVERGED: {ev.get('why')} "
                             f"(dump {ev.get('dump')})")
    deltas = doc.get("metrics_deltas") or []
    if deltas:
        lines.append("")
        lines.append("last metrics delta:")
        for k, v in sorted((deltas[-1].get("delta") or {}).items()):
            lines.append(f"  {k}: {v:+g}")
    health = doc.get("health")
    if health:
        lines.append("")
        lines.append(f"component health: {health.get('status')}")
        for name, d in sorted((health.get("components") or {}).items()):
            note = ""
            if d.get("status") != "ok":
                note = (f"  stalled {d.get('stalled_for_seconds')}s"
                        f" threads={d.get('stalled_threads')}")
            lines.append(f"  {name}: {d.get('status')}{note}")
    tenants_doc = doc.get("tenants") or {}
    tenant_rows = tenants_doc.get("tenants") or {}
    if tenant_rows:
        cons = tenants_doc.get("conservation") or {}
        lines.append("")
        lines.append(f"tenant chip budget (books_ok={cons.get('books_ok')} "
                     f"spend_ok={cons.get('spend_ok')}):")
        for t in sorted(tenant_rows):
            rec = tenant_rows[t] or {}
            dev = rec.get("device_seconds") or {}
            parts = []
            if dev:
                parts.append("dev[s] " + " ".join(
                    f"{tier}={s:.4g}" for tier, s in sorted(dev.items())))
            b = rec.get("books")
            if b:
                parts.append(f"adm={b.get('admitted', 0)} "
                             f"done={b.get('completed', 0)} "
                             f"shed={b.get('shed', 0)} "
                             f"fail={b.get('failed', 0)}")
            lines.append(f"  {t}: " + ("  ".join(parts) if parts
                                       else "(idle)"))
    locks_doc = doc.get("locks") or {}
    if locks_doc.get("enabled"):
        lines.append("")
        held = locks_doc.get("held") or {}
        waiting = locks_doc.get("waiting") or []
        cycles = locks_doc.get("deadlock_cycles") or []
        lines.append(f"lock forensics (DL4J_LOCKCHECK): "
                     f"{sum(len(v) for v in held.values())} held, "
                     f"{len(waiting)} waiting, {len(cycles)} deadlock "
                     f"cycle(s)")
        for tname in sorted(held):
            locks_held = ", ".join(
                f"{h['site']}" + (f" x{h['depth']}" if h.get("depth", 1) > 1
                                  else "")
                for h in held[tname])
            lines.append(f"  {tname} holds: {locks_held}")
        for w in waiting:
            lines.append(f"  {w['thread']} waiting {w['waited_s']}s "
                         f"for {w['waits_for']}")
        for cyc in cycles:
            lines.append("  DEADLOCK CYCLE:")
            for e in cyc:
                lines.append(f"    {e['thread']} waits for "
                             f"{e['waits_for']} held by {e['held_by']}")
    threads = doc.get("threads") or []
    if threads:
        lines.append("")
        lines.append(f"threads ({len(threads)}):")
        for t in threads:
            flags = "daemon" if t.get("daemon") else "      "
            lines.append(f"  -- {t.get('name')} ({flags})")
            for fr in (t.get("stack") or [])[-max_stack_lines:]:
                lines.append(f"       {fr}")
    return "\n".join(lines)

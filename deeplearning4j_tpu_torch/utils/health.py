"""Component health + hang watchdog — the liveness half of the crash
forensics layer (utils/blackbox.py is the black-box half). A stdlib copy
of the JAX package's utils/health.py.

The metrics registry reports rates while a process is alive and making
progress; they say nothing when a step wedges, a pipeline worker blocks
on a queue nobody drains, or a serving dispatcher dies inside a device
forward. This module turns liveness into data:

* every long-running component registers a `Heartbeat` (fit loop,
  serving collector/dispatcher, device-prefetch and ETL workers, the
  paramserver push drain, the UI remote router). A thread marks itself
  *busy* while holding work (`with hb.busy(): ...`) and `beat()`s on
  progress; a thread waiting for work holds no busy slot, so an idle
  component is healthy by construction — only a thread that TOOK work
  and stopped advancing reads as a stall.
* a single `dl4j-watchdog` daemon thread scans every heartbeat: a busy
  slot older than `stall_after` flips the component to DEGRADED, older
  than `unhealthy_after` to UNHEALTHY, and recovery flips it back. Each
  transition updates the `component_health{component}` gauge (0 ok / 1
  degraded / 2 unhealthy), bumps `watchdog_stall_total{component}` on
  entry to a stall episode, appends to a bounded transition history
  (consumed by train/listeners.HealthTransitionListener and
  ui/stats.StatsListener),
  and hands the first degradation of an episode to the flight recorder
  for a forensic snapshot.
* `status()` is the aggregated health model serving's `GET /health`
  returns (503 when any component is unhealthy) — the hook load-shedding
  and replica eviction build on.

`net.fit(hang_timeout=...)` registers the fit heartbeat with an
`on_stall` action that dumps the flight recorder and raises
`StepHangError` (carrying the dump path) inside the fitting thread, so
a wedged step becomes a diagnosable exception instead of a silent hang.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional

from deeplearning4j_tpu_torch.utils import metrics as _metrics

logger = logging.getLogger("deeplearning4j_tpu_torch")

OK = "ok"
DEGRADED = "degraded"
UNHEALTHY = "unhealthy"
# status -> numeric severity: the component_health gauge value, and the
# numeric form storage codecs keep when string fields get dropped
LEVELS = {OK: 0, DEGRADED: 1, UNHEALTHY: 2}
_LEVEL = LEVELS

# watchdog scan cadence bounds: a quarter of the shortest registered
# stall interval, clamped so an idle registry costs nothing measurable
# and a millisecond-scale test interval cannot busy-spin the thread
_MIN_INTERVAL = 0.02
_MAX_INTERVAL = 5.0


class StepHangError(RuntimeError):
    """A fit step exceeded its `hang_timeout`. `dump_path` names the
    flight-recorder dump written at detection time (None when the dump
    itself failed) — the forensics, not just the fact of the hang."""

    def __init__(self, message: str = "", dump_path: Optional[str] = None):
        super().__init__(message or "fit step hang detected")
        self.dump_path = dump_path


def _async_raise(thread_ident: int, exc_type) -> bool:
    """Raise `exc_type` inside another thread at its next bytecode
    boundary (CPython PyThreadState_SetAsyncExc). A thread wedged in a
    C call only sees it when it returns to the interpreter — which is
    exactly the Python-level-wedge class (queue waits, iterator sleep
    loops) the hang_timeout contract targets. Returns False when the
    raise could not be delivered.

    The raise lands only between bytecodes: a fit thread blocked inside
    a CUDA call (a synchronising copy, `torch.cuda.synchronize()`, a
    kernel launch waiting on a full queue) receives it when that call
    returns, not while the device is still busy."""
    import ctypes

    try:
        res = ctypes.pythonapi.PyThreadState_SetAsyncExc(
            ctypes.c_ulong(thread_ident), ctypes.py_object(exc_type))
        if res > 1:  # delivered to >1 state: undo — interpreter invariant
            ctypes.pythonapi.PyThreadState_SetAsyncExc(
                ctypes.c_ulong(thread_ident), None)
            return False
        return res == 1
    except Exception:  # non-CPython or restricted ctypes: degrade gracefully
        return False


class _BusySlot:
    """Context manager marking the current thread busy on a heartbeat."""
    __slots__ = ("hb",)

    def __init__(self, hb: "Heartbeat"):
        self.hb = hb

    def __enter__(self):
        hb = self.hb
        with hb._lock:
            hb._busy[threading.get_ident()] = time.monotonic()
        return hb

    def __exit__(self, *exc):
        hb = self.hb
        with hb._lock:
            hb._busy.pop(threading.get_ident(), None)
        return False


class Heartbeat:
    """One component's liveness record. Multiple threads may share one
    heartbeat (the multi-worker ETL stage): the component stalls when
    its OLDEST busy slot goes stale, so one wedged worker is not masked
    by its siblings' progress."""

    def __init__(self, name: str, stall_after: float,
                 unhealthy_after: Optional[float] = None,
                 on_stall: Optional[Callable[["Heartbeat", float], None]]
                 = None):
        self.name = name
        self.stall_after = float(stall_after)
        self.unhealthy_after = (float(unhealthy_after)
                                if unhealthy_after is not None
                                else 4.0 * self.stall_after)
        self.on_stall = on_stall
        self.state = OK  # watchdog-owned; scans mutate it
        # RLock: the crash-dump path (a signal handler on the main
        # thread) reads health status and may interrupt a beat() that
        # holds this lock on the same thread
        self._lock = threading.RLock()
        self._busy: Dict[int, float] = {}  # thread ident -> last activity
        self._stall_fired = False  # on_stall runs once per episode

    def has_busy_slots(self) -> bool:
        with self._lock:
            return bool(self._busy)

    def busy(self) -> _BusySlot:
        """`with hb.busy(): <work>` — the thread holds work; silence now
        counts as a stall. Cost: two dict ops and two clock reads."""
        return _BusySlot(self)

    def beat(self):
        """Progress mark: refresh this thread's busy slot (no-op for a
        thread that is not inside `busy()` — an idle component has
        nothing to prove)."""
        tid = threading.get_ident()
        with self._lock:
            if tid in self._busy:
                self._busy[tid] = time.monotonic()

    def check(self, now: Optional[float] = None):
        """(state, stalled_for_seconds, stalled_thread_idents) from the
        current busy slots. Pure — no side effects; the watchdog scan
        and `status()` both call this."""
        now = time.monotonic() if now is None else now
        with self._lock:
            slots = dict(self._busy)
        if not slots:
            return OK, 0.0, []
        age = now - min(slots.values())
        if age >= self.unhealthy_after:
            state = UNHEALTHY
        elif age >= self.stall_after:
            state = DEGRADED
        else:
            return OK, 0.0, []
        stale = [tid for tid, t in slots.items()
                 if now - t >= self.stall_after]
        return state, age, stale


def _thread_names(idents: List[int]) -> List[str]:
    by_ident = {t.ident: t.name for t in threading.enumerate()}
    return [by_ident.get(tid, f"ident-{tid}") for tid in idents]


class HealthRegistry:
    """Process-global component-health map + the one watchdog thread.

    The watchdog starts lazily on the first `register()` and lives for
    the process (daemon, named `dl4j-watchdog`); with every component
    healthy a scan is a handful of dict reads. Re-registering a name
    replaces the previous heartbeat (a restarted component starts a
    fresh episode); `unregister` only removes the heartbeat it is handed
    so a stale owner cannot evict its replacement."""

    def __init__(self):
        self._lock = threading.RLock()  # see Heartbeat._lock
        self._components: Dict[str, Heartbeat] = {}
        # externally-asserted conditions (analysis/slo firing rules mark
        # their owning component DEGRADED here): name -> {state, reason,
        # since}. Merged with the heartbeat view in status() — the worst
        # of the two wins — and cleared by set_condition(name, OK).
        self._conditions: Dict[str, dict] = {}
        self._transitions: deque = deque(maxlen=256)
        self._seq = 0
        self._listeners: List[Callable] = []
        self._wake = threading.Event()
        self._thread: Optional[threading.Thread] = None
        reg = _metrics.get_registry()
        self._gauge = reg.gauge(
            "component_health",
            "watchdog view per component: 0 ok, 1 degraded, 2 unhealthy",
            ("component",))
        self._stalls = reg.counter(
            "watchdog_stall_total",
            "stall episodes the watchdog opened, per component",
            ("component",))

    # -- registration --------------------------------------------------------

    def register(self, name: str, stall_after: float = 60.0,
                 unhealthy_after: Optional[float] = None,
                 on_stall: Optional[Callable] = None) -> Heartbeat:
        with self._lock:
            # a name collision with a heartbeat whose threads are BUSY is
            # two live registrants (e.g. two concurrent fits): evicting
            # the first would silently disable its watchdog/hang_timeout,
            # so the newcomer gets a suffixed component name instead. A
            # collision with an idle heartbeat is the restart case —
            # replace, fresh episode.
            base, k = name, 1
            existing = self._components.get(name)
            while existing is not None and existing.has_busy_slots():
                k += 1
                name = f"{base}#{k}"
                existing = self._components.get(name)
            if name != base:
                logger.warning(
                    "health component %r already registered and active; "
                    "registering as %r", base, name)
            hb = Heartbeat(name, stall_after, unhealthy_after, on_stall)
            self._components[name] = hb
            started = self._thread is not None
        self._gauge.labels(name).set(0)
        if not started:
            self._start_watchdog()
        self._wake.set()  # pick up a possibly-shorter scan interval now
        return hb

    def unregister(self, hb: Heartbeat):
        with self._lock:
            if self._components.get(hb.name) is hb:
                del self._components[hb.name]
            else:
                return
        if hb.state != OK:  # leave no stuck gauge behind
            self._record_transition(hb, OK, 0.0, [])
        with self._lock:
            cond = self._conditions.get(hb.name)
        self._gauge.labels(hb.name).set(
            _LEVEL[cond["state"]] if cond else 0)

    # -- externally-asserted conditions ---------------------------------------

    def set_condition(self, component: str, state: str, reason: str = ""):
        """Assert a component's health from OUTSIDE the watchdog model —
        the hook SLO rules (analysis/slo via utils/runledger) use to mark
        an owning component DEGRADED while a rule fires, and to clear it
        on resolve (`state=OK`). Conditions merge with the busy-slot
        view: `status()` and the `component_health` gauge report the
        WORST of the heartbeat state and the asserted condition, so a
        firing latency rule degrades "serving" even while its pipeline
        threads are individually live. Each level change records a
        transition (kind="condition") through the same history/listener/
        flight-recorder path as watchdog transitions."""
        if state not in _LEVEL:
            raise ValueError(f"unknown health state {state!r}")
        with self._lock:
            prev = self._conditions.get(component)
            old = prev["state"] if prev else OK
            if state == old and prev is not None:
                prev["reason"] = reason  # refresh, no transition
                return
            if state == OK:
                self._conditions.pop(component, None)
                if prev is None:
                    return  # clearing a condition never asserted: no-op
            else:
                self._conditions[component] = {
                    "state": state, "reason": reason, "since": time.time()}
            self._seq += 1
            tr = {
                "seq": self._seq,
                "ts": time.time(),
                "component": component,
                "from": old,
                "to": state,
                "kind": "condition",
                "reason": reason,
            }
            self._transitions.append(tr)
            listeners = list(self._listeners)
            hb = self._components.get(component)
        # the gauge reports the MERGED level — a heartbeat-OK component
        # with a DEGRADED condition reads 1, and clearing the condition
        # falls back to the heartbeat's own state, not blindly to 0
        hb_level = _LEVEL[hb.state] if hb is not None else 0
        self._gauge.labels(component).set(max(hb_level, _LEVEL[state]))
        try:
            from deeplearning4j_tpu_torch.utils import blackbox

            blackbox.get_recorder().record_event(
                "health_condition", component=component, frm=old, to=state,
                reason=reason)
        except Exception:
            logger.exception("flight-recorder condition event failed")
        for fn in listeners:
            try:
                fn(tr)
            except Exception:
                logger.exception("health transition listener failed")

    def get_condition(self, component: str) -> Optional[dict]:
        with self._lock:
            c = self._conditions.get(component)
            return dict(c) if c else None

    def add_listener(self, fn: Callable[[dict], None]):
        """`fn(transition_dict)` on every health transition — the hook
        train/listeners.HealthTransitionListener and tests use. A raising
        listener is logged and dropped for that event, never fatal."""
        with self._lock:
            self._listeners.append(fn)

    def remove_listener(self, fn: Callable):
        with self._lock:
            if fn in self._listeners:
                self._listeners.remove(fn)

    # -- readout -------------------------------------------------------------

    def status(self) -> dict:
        """The aggregated health model (serving `GET /health`): overall
        status is the worst component's, computed LIVE from the busy
        slots (not the last scan), so recovery is visible immediately."""
        with self._lock:
            comps = dict(self._components)
            conds = {k: dict(v) for k, v in self._conditions.items()}
        now = time.monotonic()
        out, worst = {}, OK
        for name, hb in sorted(comps.items()):
            state, age, stale = hb.check(now)
            detail = {"status": state,
                      "stall_after_seconds": hb.stall_after}
            if state != OK:
                detail["stalled_for_seconds"] = round(age, 3)
                detail["stalled_threads"] = _thread_names(stale)
            cond = conds.pop(name, None)
            if cond is not None:
                # an asserted condition (SLO rule firing) merges with the
                # heartbeat view: worst state wins, the condition detail
                # rides along so /health names the judging rule
                detail["condition"] = cond
                if _LEVEL[cond["state"]] > _LEVEL[state]:
                    state = cond["state"]
                    detail["status"] = state
            if _LEVEL[state] > _LEVEL[worst]:
                worst = state
            out[name] = detail
        for name, cond in sorted(conds.items()):
            # condition-only components (no heartbeat): still first-class
            state = cond["state"]
            out[name] = {"status": state, "condition": cond}
            if _LEVEL[state] > _LEVEL[worst]:
                worst = state
        return {"status": worst, "components": out}

    def transitions_since(self, seq: int = 0) -> List[dict]:
        """Transition records newer than `seq` (each carries its own
        monotonically-increasing "seq") — cursor-style consumption for
        listeners that poll."""
        with self._lock:
            return [t for t in self._transitions if t["seq"] > seq]

    def last_seq(self) -> int:
        with self._lock:
            return self._seq

    # -- the watchdog --------------------------------------------------------

    def _start_watchdog(self):
        t = threading.Thread(target=self._watchdog_loop, daemon=True,
                             name="dl4j-watchdog")
        with self._lock:
            if self._thread is not None:
                return
            self._thread = t
        t.start()

    def _interval(self) -> float:
        with self._lock:
            stalls = [hb.stall_after for hb in self._components.values()]
        if not stalls:
            return _MAX_INTERVAL
        return min(_MAX_INTERVAL, max(_MIN_INTERVAL, min(stalls) / 4.0))

    def _watchdog_loop(self):
        while True:
            self._wake.wait(self._interval())
            self._wake.clear()
            try:
                self.scan()
            except Exception:  # a scan bug must not kill liveness forever
                logger.exception("watchdog scan failed")

    def scan(self, now: Optional[float] = None):
        """One watchdog pass (the thread's body, callable directly from
        tests): compute each component's state, record transitions, run
        stall actions."""
        now = time.monotonic() if now is None else now
        with self._lock:
            comps = list(self._components.values())
        for hb in comps:
            state, age, stale = hb.check(now)
            old = hb.state
            if state != old:
                hb.state = state
                self._record_transition(hb, state, age, stale, old=old)
            if state == OK:
                hb._stall_fired = False
            elif not hb._stall_fired:
                hb._stall_fired = True
                self._on_first_stall(hb, age, stale)

    def _on_first_stall(self, hb: Heartbeat, age: float, stale: List[int]):
        """Entry into a stall episode: counter, flight-recorder snapshot,
        then the component's own action (e.g. the fit hang raiser)."""
        self._stalls.labels(hb.name).inc()
        names = _thread_names(stale)
        logger.warning("watchdog: component %r stalled for %.3fs "
                       "(threads: %s)", hb.name, age, names)
        try:
            from deeplearning4j_tpu_torch.utils import blackbox

            blackbox.get_recorder().on_degradation(hb.name, age, names)
        except Exception:
            logger.exception("flight-recorder degradation snapshot failed")
        if hb.on_stall is not None:
            try:
                hb.on_stall(hb, age)
            except Exception:
                logger.exception("on_stall action for %r failed", hb.name)

    def _record_transition(self, hb: Heartbeat, state: str, age: float,
                           stale: List[int], old: Optional[str] = None):
        with self._lock:
            self._seq += 1
            tr = {
                "seq": self._seq,
                "ts": time.time(),
                "component": hb.name,
                "from": old if old is not None else hb.state,
                "to": state,
                "stalled_for_seconds": round(age, 3),
                "stalled_threads": _thread_names(stale),
            }
            self._transitions.append(tr)
            listeners = list(self._listeners)
            cond = self._conditions.get(hb.name)
        # merged with any asserted condition: a watchdog recovery must
        # not zero the gauge while an SLO rule still holds the component
        # DEGRADED (and vice versa — see set_condition)
        cond_level = _LEVEL[cond["state"]] if cond else 0
        self._gauge.labels(hb.name).set(max(_LEVEL[state], cond_level))
        try:
            from deeplearning4j_tpu_torch.utils import blackbox

            blackbox.get_recorder().record_event(
                "health_transition", component=hb.name, frm=tr["from"],
                to=state, stalled_for_seconds=tr["stalled_for_seconds"])
        except Exception:
            logger.exception("flight-recorder transition event failed")
        for fn in listeners:
            try:
                fn(tr)
            except Exception:
                logger.exception("health transition listener failed")


# -- the process-global registry ---------------------------------------------

_HEALTH = HealthRegistry()


def get_health() -> HealthRegistry:
    return _HEALTH

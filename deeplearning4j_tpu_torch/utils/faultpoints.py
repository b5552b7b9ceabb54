"""Deterministic fault injection — named points, seeded plans, replayable
chaos (a stdlib copy of the JAX package's utils/faultpoints.py: the same
`FaultPlan(seed)` fires at the same calls in both packages).

The watchdog, the flight recorder and checkpoint resume prove detection (watchdog, flight recorder) and recovery
(eviction/respawn, journal replay, resume) against *hand-thrown* faults:
a kill -9 here, a raising helper there. Those tests are real but ad-hoc
— nobody can re-run "the failure from Tuesday" because the fault
sequence lived in a shell history. This module makes faults data:

* **Fault points** are named places in the code that ask, on every
  invocation, "should I fail right now?" — `fault_point("ckpt_write")`.
  The registered points (each threaded through its real call site):

      device_put        data/prefetch device-staging put
      ckpt_write        train/checkpoint zip serialization
      paramserver_rpc   parallel/paramserver client HTTP round-trip
      etl_worker        data/prefetch multi-worker host ETL
      helper_fn         ops/helpers guarded kernel dispatch
      replica_forward   parallel/inference device forward
      http_handler      utils/jsonhttp request dispatch
      train_step        nn/netbase fit-loop dispatch

  With no plan installed a fault point is one global read and a `None`
  compare — hot-path safe by construction.

* a **FaultPlan** is a seed plus a list of rules. Each rule names a
  point, a fault kind (`error` raises FaultInjected, `oom` raises
  InjectedOOM — a FaultInjected carrying the RESOURCE_EXHAUSTED marker
  so the real OOM-forensics path fires, `latency` sleeps, `hang` blocks
  until released or `hang_seconds` passes — long enough to trip the
  watchdog, bounded so a chaos run can never wedge the harness
  itself; `nan` and `corrupt` are COOPERATIVE kinds: `fault_point`
  returns the kind instead of raising, and the call site applies the
  damage through its real data path — `train_step` taints the batch's
  features with NaN so the divergence sentinel sees a genuine
  non-finite loss, `ckpt_write` byte-flips the written zip entry so
  checkpoint integrity verification sees genuine corruption; at call
  sites that don't honor them they are recorded but inert, which a
  plan author should treat like the vacuously-green rule warning
  above), and a schedule: `every_nth=N` (every Nth invocation
  of the point), `between=(a, b)` (invocation indices a..b inclusive),
  or `p=0.1` (an independent coin per invocation, drawn from a RNG
  seeded by (plan seed, point, rule index) — NOT wall-clock, NOT a
  shared global stream). Because every decision is a pure function of
  (seed, point name, per-point invocation index), the same plan over
  the same workload produces the same fault sequence — chaos runs are
  replayable, and `tests/test_chaos.py` asserts exactly that.

* every fired fault lands in the plan's **event log** (point,
  per-point invocation index, kind, rule) plus the shared metrics
  registry (`fault_injected_total{point,kind}`) and the flight
  recorder, so a chaos run's forensics look like a real incident's.

Event-log ordering: per-point invocation counters are independent, so
two runs with identical per-point sequences may interleave points
differently across threads. `event_log()` therefore returns events
sorted by (point, invocation) — the canonical, thread-schedule-free
order replay equality is defined over.
"""

from __future__ import annotations

import json
import random
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

KINDS = ("error", "latency", "hang", "oom", "nan", "corrupt")

# the sanctioned point names — fault_point() accepts any name (a new
# call site should not need a registry edit to exist), but plans naming
# an unknown point are rejected loudly: a typo'd rule that never fires
# would make a chaos run vacuously green
KNOWN_POINTS = (
    "device_put",
    "ckpt_write",
    "paramserver_rpc",
    "etl_worker",
    "helper_fn",
    "replica_forward",
    "http_handler",
    "train_step",
    "decode_step",
)


class FaultInjected(RuntimeError):
    """An `error`-kind fault fired at a fault point. Carries the point
    name so handlers (and test assertions) can tell injected faults from
    organic ones."""

    def __init__(self, point: str, invocation: int,
                 message: Optional[str] = None):
        super().__init__(
            message
            or f"injected fault at {point!r} (invocation {invocation})")
        self.point = point
        self.invocation = invocation


class InjectedOOM(FaultInjected):
    """An `oom`-kind fault: a FaultInjected whose message carries the
    RESOURCE_EXHAUSTED marker, the port's own stand-in for a device
    allocator failure: it unwinds the fit loop (or fails a serving
    forward) as a real one would, and takes the same OOM-forensics path
    (utils/devprof.is_oom / oom_forensics)."""

    def __init__(self, point: str, invocation: int):
        super().__init__(
            point, invocation,
            f"RESOURCE_EXHAUSTED: injected oom at {point!r} "
            f"(invocation {invocation}) — out of memory rehearsal")


class FaultRule:
    """One (point, kind, schedule) entry of a plan. Exactly one schedule
    field must be set. Matching is pure in (invocation index, seeded
    coin), so rule evaluation is replay-deterministic."""

    def __init__(self, point: str, kind: str = "error",
                 every_nth: Optional[int] = None,
                 between: Optional[Sequence[int]] = None,
                 p: Optional[float] = None,
                 latency_ms: float = 50.0,
                 hang_seconds: float = 30.0,
                 max_fires: Optional[int] = None):
        if point not in KNOWN_POINTS:
            raise ValueError(
                f"unknown fault point {point!r} (known: {KNOWN_POINTS})")
        if kind not in KINDS:
            raise ValueError(f"unknown fault kind {kind!r} (known: {KINDS})")
        schedules = [every_nth is not None, between is not None,
                     p is not None]
        if sum(schedules) != 1:
            raise ValueError(
                "exactly one of every_nth / between / p must be set")
        if every_nth is not None and int(every_nth) < 1:
            raise ValueError(f"every_nth must be >= 1, got {every_nth}")
        if between is not None:
            between = (int(between[0]), int(between[1]))
            if between[0] > between[1] or between[0] < 1:
                raise ValueError(f"bad between range {between}")
        if p is not None and not (0.0 <= float(p) <= 1.0):
            raise ValueError(f"p must be in [0, 1], got {p}")
        self.point = point
        self.kind = kind
        self.every_nth = None if every_nth is None else int(every_nth)
        self.between: Optional[Tuple[int, int]] = between
        self.p = None if p is None else float(p)
        self.latency_ms = float(latency_ms)
        self.hang_seconds = float(hang_seconds)
        self.max_fires = None if max_fires is None else int(max_fires)

    def to_dict(self) -> dict:
        out = {"point": self.point, "kind": self.kind}
        if self.every_nth is not None:
            out["every_nth"] = self.every_nth
        if self.between is not None:
            out["between"] = list(self.between)
        if self.p is not None:
            out["p"] = self.p
        if self.kind == "latency":
            out["latency_ms"] = self.latency_ms
        if self.kind == "hang":
            out["hang_seconds"] = self.hang_seconds
        if self.max_fires is not None:
            out["max_fires"] = self.max_fires
        return out

    @classmethod
    def from_dict(cls, d: dict) -> "FaultRule":
        return cls(
            d["point"], d.get("kind", "error"),
            every_nth=d.get("every_nth"), between=d.get("between"),
            p=d.get("p"), latency_ms=d.get("latency_ms", 50.0),
            hang_seconds=d.get("hang_seconds", 30.0),
            max_fires=d.get("max_fires"))


class FaultPlan:
    """A seeded set of FaultRules plus the run's event log. One plan is
    installed process-wide at a time (`install`/`active`); every
    `fault_point()` call consults it under the plan's own lock, so the
    per-point invocation counters — the replay clock — never race."""

    def __init__(self, seed: int = 0,
                 rules: Optional[Sequence[FaultRule]] = None):
        self.seed = int(seed)
        self.rules: List[FaultRule] = list(rules or [])
        self._lock = threading.Lock()
        self._invocations: Dict[str, int] = {}
        self._fires: Dict[int, int] = {}  # rule index -> times fired
        self._events: List[dict] = []
        # hang faults block on this; release() frees every current and
        # future hang at once (scenario teardown / test cleanup)
        self._release = threading.Event()
        # per-(point, rule) coin streams, derived from the seed — NOT
        # shared, so adding a rule never perturbs another rule's draws
        self._rngs: Dict[Tuple[str, int], random.Random] = {}

    # -- construction / serde ------------------------------------------------

    def add(self, point: str, kind: str = "error", **kw) -> "FaultPlan":
        self.rules.append(FaultRule(point, kind, **kw))
        return self

    def to_json(self) -> str:
        return json.dumps({"seed": self.seed,
                           "rules": [r.to_dict() for r in self.rules]},
                          indent=2)

    @classmethod
    def from_json(cls, text: str) -> "FaultPlan":
        doc = json.loads(text)
        return cls(doc.get("seed", 0),
                   [FaultRule.from_dict(r) for r in doc.get("rules", [])])

    # -- the decision --------------------------------------------------------

    def _rng(self, point: str, rule_idx: int) -> random.Random:
        key = (point, rule_idx)
        rng = self._rngs.get(key)
        if rng is None:
            rng = random.Random(f"{self.seed}:{point}:{rule_idx}")
            self._rngs[key] = rng
        return rng

    def decide(self, point: str) -> Optional[Tuple[FaultRule, int]]:
        """Count one invocation of `point` and return (rule, invocation)
        if a rule fires, else None. First matching rule wins. p-rules
        draw their coin EVERY invocation (fired or not) so the stream
        stays aligned with the invocation index across replays."""
        with self._lock:
            inv = self._invocations.get(point, 0) + 1
            self._invocations[point] = inv
            fired: Optional[Tuple[FaultRule, int]] = None
            for i, rule in enumerate(self.rules):
                if rule.point != point:
                    continue
                if rule.p is not None:
                    # consume the draw unconditionally (stream alignment)
                    hit = self._rng(point, i).random() < rule.p
                elif rule.every_nth is not None:
                    hit = inv % rule.every_nth == 0
                else:
                    hit = rule.between[0] <= inv <= rule.between[1]
                if not hit or fired is not None:
                    continue
                if (rule.max_fires is not None
                        and self._fires.get(i, 0) >= rule.max_fires):
                    continue
                self._fires[i] = self._fires.get(i, 0) + 1
                self._events.append({
                    "point": point, "invocation": inv,
                    "kind": rule.kind, "rule": i,
                })
                fired = (rule, inv)
            return fired

    # -- readout / lifecycle -------------------------------------------------

    def event_log(self) -> List[dict]:
        """Fired faults in canonical (point, invocation) order — the
        thread-schedule-free sequence replay equality is defined over."""
        with self._lock:
            return sorted(self._events,
                          key=lambda e: (e["point"], e["invocation"]))

    def invocations(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._invocations)

    def release(self):
        """Free every hang fault, current and future (teardown)."""
        self._release.set()

    def reset(self):
        """Zero the counters/log/RNG streams so the SAME plan object can
        replay from scratch (the determinism tests' second run)."""
        with self._lock:
            self._invocations.clear()
            self._fires.clear()
            self._events.clear()
            self._rngs.clear()
            # free anyone still parked on the OLD event before swapping
            # it out — otherwise a hung thread from the previous run
            # outlives every future release()
            self._release.set()
            self._release = threading.Event()


# -- the process-global active plan -------------------------------------------

_PLAN: Optional[FaultPlan] = None
_PLAN_LOCK = threading.Lock()


def install(plan: FaultPlan) -> FaultPlan:
    global _PLAN
    with _PLAN_LOCK:
        _PLAN = plan
    return plan


def clear():
    global _PLAN
    with _PLAN_LOCK:
        if _PLAN is not None:
            _PLAN.release()  # never strand a hung thread behind teardown
        _PLAN = None


def get_plan() -> Optional[FaultPlan]:
    return _PLAN


class active:
    """`with faultpoints.active(plan): ...` — install for a scope,
    always clear (and release hangs) on the way out."""

    def __init__(self, plan: FaultPlan):
        self.plan = plan

    def __enter__(self) -> FaultPlan:
        return install(self.plan)

    def __exit__(self, *exc):
        clear()
        return False


def fault_point(point: str, **ctx) -> Optional[str]:
    """The call-site hook. No plan: one global read, zero cost. With a
    plan: count the invocation, fire the first matching rule — raise
    (error/oom), sleep (latency), block until release/timeout (hang),
    or RETURN the kind for the cooperative kinds (`nan`, `corrupt`) the
    call site applies through its own data path."""
    plan = _PLAN
    if plan is None:
        return None
    decision = plan.decide(point)
    if decision is None:
        return None
    rule, inv = decision
    _observe(point, rule.kind, inv, ctx)
    if rule.kind == "error":
        raise FaultInjected(point, inv)
    if rule.kind == "oom":
        raise InjectedOOM(point, inv)
    if rule.kind == "latency":
        time.sleep(rule.latency_ms / 1e3)
        return None
    if rule.kind in ("nan", "corrupt"):
        return rule.kind
    # hang: block far past any stall budget, but bounded — an injected
    # hang must be able to trip the watchdog without being able to wedge
    # the chaos harness itself
    plan._release.wait(rule.hang_seconds)
    return None


def taint_nan(ds) -> None:
    """Apply a fired `nan` fault to a batch: poison its (first) feature
    array with NaN so the divergence flows through the REAL dispatch —
    forward, loss, backward — exactly as an organic numerical failure
    would (the sentinel then sees a genuinely non-finite loss/grad
    norm, not a synthetic flag). Works on host numpy and staged device
    arrays alike (`x + nan` builds a new array; the DataSet attribute
    is re-pointed, which the fit closure reads)."""
    feats = getattr(ds, "features", None)
    if isinstance(feats, (list, tuple)):  # MultiDataSet
        if not feats:
            return
        ds.features = [feats[0] + float("nan")] + list(feats[1:])
    elif feats is not None:
        ds.features = feats + float("nan")


def _observe(point: str, kind: str, invocation: int, ctx: dict):
    """Injected faults are observable like real ones: a registry series,
    a flight-recorder event, and a span-tree marker in the active trace
    (never fatal — a metrics bug must not change the injected behavior)."""
    try:
        from deeplearning4j_tpu_torch.utils import metrics as _metrics

        _metrics.get_registry().counter(
            "fault_injected_total", "faults fired by the active FaultPlan",
            ("point", "kind")).labels(point, kind).inc()
    except Exception:
        pass
    try:
        from deeplearning4j_tpu_torch.utils import blackbox as _blackbox

        _blackbox.get_recorder().record_event(
            "fault_injected", point=point, kind=kind,
            invocation=invocation, **{k: str(v) for k, v in ctx.items()})
    except Exception:
        pass
    try:
        # with tracing on, the fault lands INSIDE the trace of the
        # request/step it hit (fault points sit inside lifecycle spans,
        # or under an attach()ed context on pipeline threads) — `cli
        # chaos --trace-out` asserts exactly this linkage
        from deeplearning4j_tpu_torch.utils import tracing as _tracing

        _tracing.instant("fault/injected", point=point, kind=kind,
                         invocation=invocation)
    except Exception:
        pass

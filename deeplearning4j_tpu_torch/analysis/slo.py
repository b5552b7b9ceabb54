"""Declarative SLO rules over metric samples, the judgment layer on
top of the run ledger (utils/runledger); the port of the JAX package's
analysis/slo.py (standard library only).

A gauge is not a verdict: an operator needs "the p99 objective is
burning error budget 4x too fast" as a machine-readable, debounced
state, not a number to eyeball. This module is that rules layer, shaped
like the Prometheus alerting model (rule + `for:` debounce +
pending/firing lifecycle) and evaluated in-process on the ledger's
recorder thread.

Rule kinds (one `SLORule` each, JSON-serializable):

* `threshold`       — series `op` value (e.g. `serving_queue_depth >
                      capacity`: queue boundedness violated).
* `rate_of_change`  — per-second delta of a series `op` value (counter
                      velocity: a shed storm, a compile storm).
* `burn_rate`       — windowed error-budget burn against an objective
                      like "99% of requests complete under
                      `default_deadline_ms`": from a histogram's
                      cumulative bucket counts, bad_fraction /
                      (1 - objective) over the window must stay under
                      `max_burn`. Single-window: the ledger's cadence
                      is the short window.
* `drift`           — series compared against a REFERENCE value times a
                      fraction (e.g. live `step_mfu` below half of a
                      modelled ceiling). Same check as threshold, but
                      the rule records where its limit came from.

Lifecycle per rule: ok -> pending (first violating sample) -> firing
(still violating after `for_seconds`) -> resolved (first clean sample)
-> ok. Transitions are returned to the caller; the LIVE side effects
(slo_alerts_total, health DEGRADED, flight-recorder events, findings)
belong to utils/runledger, so offline re-evaluation of a recorded ledger
(`evaluate_ledger`) is pure and never mutates this process's health.

Series selectors: a rule's `series` names a metric family
(`step_mfu` matches `step_mfu{source="analytic"}`), optionally with a
label subset (`device_memory_bytes{kind="live"}`). A rule whose
selector matches nothing is simply not violated: absence of data is
not an alert.

`default_rule_pack()` derives the standing rules from what is attached:
the serving config's deadline/queue knobs and the tenants' budgets. The
cost-model rules (MFU against the roofline, residency) wait for
analysis/costmodel.py, which the port does not have.

Finding code (documented in analysis/findings.py):
  SLO001  a rule entered `firing` (severity = the rule's own)
"""

from __future__ import annotations

import dataclasses
import json
import math
import re
from collections import deque
from typing import Dict, Iterable, List, Optional, Tuple

ERROR = "error"
WARNING = "warning"
INFO = "info"

OK = "ok"
PENDING = "pending"
FIRING = "firing"

_OPS = {
    ">": lambda v, t: v > t,
    ">=": lambda v, t: v >= t,
    "<": lambda v, t: v < t,
    "<=": lambda v, t: v <= t,
}

_SELECTOR_RE = re.compile(r"^([^{]+?)(\{(.*)\})?$")


def _parse_selector(sel: str) -> Tuple[str, Dict[str, str]]:
    """`name` or `name{k="v",...}` -> (family, label filter); the name
    may carry a `:count`/`:sum` facet for histogram-backed threshold
    rules. Quotes on label values are optional; a malformed selector
    raises at rule construction, not silently at evaluation."""
    m = _SELECTOR_RE.match(sel.strip())
    if not m:
        raise ValueError(f"bad series selector {sel!r}")
    name = m.group(1).strip()
    labels: Dict[str, str] = {}
    body = m.group(3)
    if body:
        for part in body.split(","):
            if not part.strip():
                continue
            k, _, v = part.partition("=")
            if not _:
                raise ValueError(f"bad label filter in selector {sel!r}")
            labels[k.strip()] = v.strip().strip('"')
    return name, labels


def _split_key(key: str) -> Tuple[str, Dict[str, str], str]:
    """A scalar_values() key -> (family, labels, suffix) where suffix is
    "", "count", "sum", or "bucket:<le>"."""
    suffix = ""
    base = key
    i = key.find("}")
    sep = key.find(":", i + 1 if i >= 0 else 0)
    if sep >= 0:
        base, suffix = key[:sep], key[sep + 1:]
    j = base.find("{")
    if j < 0:
        return base, {}, suffix
    family = base[:j]
    labels: Dict[str, str] = {}
    for part in base[j + 1:-1].split(","):
        if not part:
            continue
        k, _, v = part.partition("=")
        labels[k] = v.strip('"')
    return family, labels, suffix


def _match(values: Dict[str, float], family: str,
           label_filter: Dict[str, str],
           suffix: str = "") -> List[Tuple[str, float]]:
    """All (key, value) entries whose family matches and whose labels
    are a superset of the filter; `suffix` narrows to plain series (""),
    ":count"/"sum", or "bucket" (any le)."""
    out = []
    for key, v in values.items():
        fam, labels, sfx = _split_key(key)
        if fam != family:
            continue
        if suffix == "bucket":
            if not sfx.startswith("bucket:"):
                continue
        elif sfx != suffix:
            continue
        if all(labels.get(k) == want for k, want in label_filter.items()):
            out.append((key, v))
    return out


def _bucket_le(key: str) -> float:
    le = key.rsplit(":bucket:", 1)[1]
    return math.inf if le == "+Inf" else float(le)


@dataclasses.dataclass
class SLORule:
    """One declarative rule. `kind` selects the check; unused fields for
    a kind stay None and round-trip through JSON untouched.

    Common: `name` (stable id), `series` (selector), `severity`
    (error|warning|info — error is what `evaluate_ledger`'s `ok`
    gates on),
    `component` (the utils/health component a firing rule degrades;
    defaults to `slo:<name>`), `for_seconds` (debounce: the condition
    must hold this long before pending escalates to firing).

    threshold / rate_of_change: `op` + `value` (rate_of_change compares
    the per-second delta between consecutive samples).

    burn_rate: `objective` (e.g. 0.99), `threshold_ms` (the latency
    objective — "under the deadline"), `window_seconds` (0 = consecutive
    samples), `max_burn` (budget-burn multiple that fires; 1.0 = exactly
    on budget), `min_events` (don't judge fewer completions than this).

    drift: `op` + `reference` × `frac` is the limit; `reference_source`
    records provenance (e.g. "costmodel:mfu_ceiling")."""

    name: str
    kind: str
    series: str
    severity: str = ERROR
    component: str = ""
    for_seconds: float = 0.0
    # threshold / rate_of_change / drift
    op: str = ">"
    value: Optional[float] = None
    # burn_rate
    objective: Optional[float] = None
    threshold_ms: Optional[float] = None
    window_seconds: float = 0.0
    max_burn: float = 1.0
    min_events: int = 10
    # drift
    reference: Optional[float] = None
    frac: Optional[float] = None
    reference_source: str = ""

    def __post_init__(self):
        if self.kind not in ("threshold", "rate_of_change", "burn_rate",
                             "drift"):
            raise ValueError(f"unknown rule kind {self.kind!r}")
        if self.op not in _OPS:
            raise ValueError(f"unknown op {self.op!r}")
        if self.severity not in (ERROR, WARNING, INFO):
            raise ValueError(f"unknown severity {self.severity!r}")
        if not self.component:
            self.component = f"slo:{self.name}"
        _parse_selector(self.series)  # fail fast on a malformed selector
        if self.kind in ("threshold", "rate_of_change") \
                and self.value is None:
            raise ValueError(f"rule {self.name!r}: {self.kind} needs value")
        if self.kind == "burn_rate" and (self.objective is None
                                         or self.threshold_ms is None):
            raise ValueError(
                f"rule {self.name!r}: burn_rate needs objective and "
                f"threshold_ms")
        if self.kind == "drift" and (self.reference is None
                                     or self.frac is None):
            raise ValueError(
                f"rule {self.name!r}: drift needs reference and frac")

    # -- serde ----------------------------------------------------------------

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        return {k: v for k, v in d.items() if v is not None and v != ""}

    @classmethod
    def from_dict(cls, d: dict) -> "SLORule":
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - known
        if unknown:
            raise ValueError(f"unknown SLORule fields {sorted(unknown)}")
        return cls(**d)

    def limit(self) -> Optional[float]:
        """The effective numeric limit (threshold/drift); None for
        burn_rate (its limit is `max_burn`, a ratio)."""
        if self.kind == "drift":
            return self.reference * self.frac
        if self.kind == "burn_rate":
            return None
        return self.value

    def describe(self) -> str:
        if self.kind == "burn_rate":
            return (f"{self.series}: {self.objective:.2%} under "
                    f"{self.threshold_ms:g}ms, burn <= {self.max_burn:g} "
                    f"over {self.window_seconds:g}s")
        lim = self.limit()
        src = f" (= {self.frac:g} x {self.reference_source})" \
            if self.kind == "drift" and self.reference_source else ""
        return f"{self.series} {self.op} {lim:g}{src}"


class _RuleState:
    __slots__ = ("state", "since", "value", "fired_total", "scratch")

    def __init__(self):
        self.state = OK
        self.since: Optional[float] = None
        self.value: Optional[float] = None  # last evaluated worst value
        self.fired_total = 0
        self.scratch: dict = {}


class SLORuleSet:
    """Rules + their lifecycle state. `evaluate(ts, values)` judges one
    sample (the flat scalar_values(include_buckets=True) dict) and
    returns the transitions it caused — each {rule, from, to, ts,
    value, severity, component, detail}. Pure: no registry/health/
    recorder writes (utils/runledger applies those live;
    `evaluate_ledger` replays ledgers through this same code offline)."""

    def __init__(self, rules: Iterable[SLORule]):
        self.rules = list(rules)
        names = [r.name for r in self.rules]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate rule names in {names}")
        self._states = {r.name: _RuleState() for r in self.rules}

    # -- serde ----------------------------------------------------------------

    def to_dicts(self) -> List[dict]:
        return [r.to_dict() for r in self.rules]

    @classmethod
    def from_dicts(cls, ds: Iterable[dict]) -> "SLORuleSet":
        return cls(SLORule.from_dict(d) for d in ds)

    @classmethod
    def from_json(cls, text: str) -> "SLORuleSet":
        doc = json.loads(text)
        if isinstance(doc, dict):
            doc = doc.get("rules", [])
        return cls.from_dicts(doc)

    # -- evaluation -----------------------------------------------------------

    def evaluate(self, ts: float, values: Dict[str, float]) -> List[dict]:
        transitions = []
        for rule in self.rules:
            st = self._states[rule.name]
            try:
                violated, value = self._check(rule, st, ts, values)
            except Exception as e:  # a rule bug judges nothing, loudly
                violated, value = False, None
                st.scratch["error"] = f"{type(e).__name__}: {e}"
            st.value = value
            old = st.state
            if violated:
                if old == OK:
                    st.state, st.since = PENDING, ts
                if st.state == PENDING \
                        and ts - st.since >= rule.for_seconds:
                    st.state = FIRING
                    st.fired_total += 1
            else:
                st.state, st.since = OK, None
            if st.state != old and (st.state == FIRING
                                    or old == FIRING):
                transitions.append({
                    "rule": rule.name,
                    "from": old,
                    "to": st.state if st.state == FIRING else "resolved",
                    "ts": round(ts, 3),
                    "value": value,
                    "severity": rule.severity,
                    "component": rule.component,
                    "detail": rule.describe(),
                })
        return transitions

    def _check(self, rule: SLORule, st: _RuleState, ts: float,
               values: Dict[str, float]):
        family, labels = _parse_selector(rule.series)
        if rule.kind == "burn_rate":
            return self._check_burn(rule, st, ts, values, family, labels)
        suffix = ""
        for sfx in ("count", "sum"):
            if family.endswith(":" + sfx):  # explicit histogram facet
                family, suffix = family[:-(len(sfx) + 1)], sfx
        matches = _match(values, family, labels, suffix)
        if not matches:
            return False, None
        if rule.kind == "rate_of_change":
            prev = st.scratch.get("prev")
            st.scratch["prev"] = (ts, dict(matches))
            if prev is None or ts <= prev[0]:
                return False, None
            dt = ts - prev[0]
            rates = [(v - prev[1].get(k, v)) / dt for k, v in matches]
            worst = max(rates) if rule.op in (">", ">=") else min(rates)
            return _OPS[rule.op](worst, rule.value), worst
        limit = rule.limit()
        vals = [v for _, v in matches]
        worst = max(vals) if rule.op in (">", ">=") else min(vals)
        return _OPS[rule.op](worst, limit), worst

    def _check_burn(self, rule: SLORule, st: _RuleState, ts: float,
                    values: Dict[str, float], family: str,
                    labels: Dict[str, str]):
        buckets = _match(values, family, labels, "bucket")
        totals = _match(values, family, labels, "count")
        if not buckets or not totals:
            return False, None
        thresh = rule.threshold_ms / 1e3
        # good = cumulative count at the smallest bucket bound >= the
        # objective threshold (summed across label children) — requests
        # inside that bucket but past the exact threshold count as good,
        # which under-fires by at most one bucket's width (documented;
        # pick histogram buckets aligned with the objective to avoid it)
        by_le: Dict[float, float] = {}
        for k, v in buckets:
            le = _bucket_le(k)
            by_le[le] = by_le.get(le, 0.0) + v
        le_good = min((le for le in by_le if le >= thresh),
                      default=math.inf)
        good = by_le.get(le_good, 0.0)
        total = sum(v for _, v in totals)
        win = st.scratch.setdefault("window", deque())
        win.append((ts, good, total))
        # keep at least the previous point so window=0 means
        # consecutive-sample burn; otherwise drop points older than the
        # window
        while len(win) > 2 and win[1][0] < ts - rule.window_seconds:
            win.popleft()
        t0, g0, n0 = win[0]
        d_total = total - n0
        if d_total < rule.min_events:
            return False, st.value if st.state != OK else None
        bad_frac = max(0.0, d_total - (good - g0)) / d_total
        budget = max(1e-9, 1.0 - rule.objective)
        burn = bad_frac / budget
        return burn > rule.max_burn, round(burn, 4)

    # -- readout --------------------------------------------------------------

    def status(self) -> List[dict]:
        out = []
        for rule in self.rules:
            st = self._states[rule.name]
            out.append({
                "rule": rule.name,
                "kind": rule.kind,
                "series": rule.series,
                "severity": rule.severity,
                "component": rule.component,
                "state": st.state,
                "since": st.since,
                "value": st.value,
                "fired_total": st.fired_total,
                "detail": rule.describe(),
            })
        return out

    def firing(self) -> List[str]:
        return [r.name for r in self.rules
                if self._states[r.name].state == FIRING]

    def ever_fired(self, severity: Optional[str] = None) -> List[str]:
        return [r.name for r in self.rules
                if self._states[r.name].fired_total > 0
                and (severity is None or r.severity == severity)]


# -- the default rule pack -----------------------------------------------------

def tenant_burn_rules(tenants: Dict[str, float],
                      sample_every: float = 5.0,
                      severity: str = WARNING) -> List[SLORule]:
    """Per-tenant chip-budget burn rules over the resource meter's
    `tenant_device_seconds_total{tenant,tier}` series (utils/
    resourcemeter). `tenants` maps tenant name -> its device-seconds-
    per-wall-second allowance; the rule judges each tier's spend rate
    separately and fires on the worst one (a tenant burning device time
    in ANY tier faster than its share — 1.0/s is a whole chip). A
    tenant that never spends matches nothing and never alerts, so the
    pack is safe to attach before traffic arrives."""
    debounce = max(0.0, 2.0 * float(sample_every))
    return [SLORule(
        name=f"tenant_chip_budget_burn:{tenant}",
        kind="rate_of_change",
        series=f'tenant_device_seconds_total{{tenant="{tenant}"}}',
        op=">", value=float(budget),
        severity=severity,
        component=f"tenant:{tenant}",
        for_seconds=debounce,
    ) for tenant, budget in sorted(tenants.items())]


def default_rule_pack(cost_model=None, serving: Optional[dict] = None,
                      sample_every: float = 5.0,
                      grad_norm_rate: float = 10.0,
                      tenants: Optional[Dict[str, float]] = None
                      ) -> List[SLORule]:
    """Standing rules derived from what this process attached:

    * serving (dict with `default_deadline_ms` / `queue_capacity` /
      `component`): the p99 deadline burn-rate objective over completed
      request latency, and queue boundedness.
    * cost_model: the JAX package derives its MFU-roofline and
      residency rules from analysis/costmodel.py, which the port does
      not have; passing one raises NotImplementedError.
    * tenants (dict tenant -> device-seconds/s allowance): one
      per-tenant chip-budget burn rule each (tenant_burn_rules) —
      a tenant outspending its share of the chips turns from a number
      in GET /tenants into a debounced firing state.
    * always: any OOM reaching the forensics path is an error, and the
      sentinel's `train_grad_norm` gauge growing faster than
      `grad_norm_rate`/s is a WARNING — the divergence *precursor*: the
      run ledger records the gradient starting to climb before a loss
      ever goes non-finite, so a post-mortem (`evaluate_ledger`) shows
      when the run began to destabilize, not just when it died. The
      absolute rate is model-scale dependent; tune it per workload. The
      selector matching nothing (no sentinel attached) never alerts.

    `for_seconds` debounces to ~2 ledger samples so a single noisy
    window cannot flip a verdict."""
    if cost_model is not None:
        raise NotImplementedError(
            "default_rule_pack(cost_model=): the MFU-roofline and residency "
            "rules need analysis/costmodel.py, which the port does not have")
    debounce = max(0.0, 2.0 * float(sample_every))
    rules = [SLORule(
        name="oom",
        kind="rate_of_change",
        series="oom_total",
        op=">", value=0.0,
        severity=ERROR,
        component="device",
        for_seconds=0.0,
    ), SLORule(
        name="grad_norm_divergence_precursor",
        kind="rate_of_change",
        series="train_grad_norm",
        op=">", value=float(grad_norm_rate),
        severity=WARNING,
        component="fit",
        for_seconds=debounce,
    )]
    if serving:
        component = serving.get("component", "serving")
        deadline = serving.get("default_deadline_ms")
        if deadline:
            rules.append(SLORule(
                name="serving_p99_deadline_burn",
                kind="burn_rate",
                series="serving_output_seconds",
                objective=0.99,
                threshold_ms=float(deadline),
                window_seconds=max(60.0, 12.0 * sample_every),
                max_burn=2.0,
                min_events=20,
                severity=ERROR,
                component=component,
                for_seconds=debounce,
            ))
        cap = serving.get("queue_capacity")
        if cap:
            # the boundedness invariant, not a load signal: admission
            # keeps the request queue <= queue_capacity, and the
            # serving_queue_depth gauge ALSO counts the prepared groups
            # in the collector->dispatcher handoff — so the limit adds
            # that slack. Under healthy 2x overload this rule stays
            # silent (load shows up as sheds); it fires only when the
            # bound itself is broken.
            handoff = serving.get("handoff_capacity", 2)
            rules.append(SLORule(
                name="serving_queue_unbounded",
                kind="threshold",
                series="serving_queue_depth",
                op=">", value=float(cap) + float(handoff),
                severity=ERROR,
                component=component,
                for_seconds=0.0,
            ))
    if tenants:
        rules.extend(tenant_burn_rules(tenants, sample_every=sample_every))
    return rules


# -- offline re-evaluation ------------------------------------------------------

def evaluate_ledger(samples: Iterable[Tuple[float, Dict[str, float]]],
                    rules: Iterable[SLORule]) -> dict:
    """Replay a recorded run's absolute samples through a FRESH rule-set
    — a CI/soak gate over a recorded run. Pure (no
    health/metrics side effects). Returns {rules, transitions,
    ever_fired, ever_fired_errors, firing_at_end, ok}; `ok` is False
    when any ERROR-severity rule fired at any point during the run."""
    rs = SLORuleSet(rules)
    transitions: List[dict] = []
    n = 0
    for ts, values in samples:
        n += 1
        transitions.extend(rs.evaluate(ts, values))
    fired_err = rs.ever_fired(ERROR)
    return {
        "samples": n,
        "rules": rs.status(),
        "transitions": transitions,
        "ever_fired": rs.ever_fired(),
        "ever_fired_errors": fired_err,
        "firing_at_end": rs.firing(),
        "ok": not fired_err,
    }

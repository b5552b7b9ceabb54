"""Persistent run ledger — continuous metrics recording on a daemon,
plus the live side of the SLO rules layer (analysis/slo); the port of
the JAX package's utils/runledger.py.

Every measured signal (shed books, deadline outcomes, step phases,
device memory) lives in the process-global
MetricsRegistry — scrape-time-only, dead with the process. This module
is the DL4J persistent-StatsStorage idea rebuilt for that registry: a
`RunLedger` samples `MetricsRegistry.scalar_values()` (the same
mechanism the flight recorder's periodic deltas use, here with
histogram buckets included) every `sample_every` seconds on a
`dl4j-ledger-*` daemon and appends to a per-run JSONL artifact:

    {"kind": "manifest", run_id, ts, pid, argv, devices, sample_every,
     config_hash, flops_source, links, rules: [...]}
    {"kind": "note", ...}          — late manifest enrichment (the first
                                     fit step names the net: config
                                     hash, flops source) — append-only,
                                     readers merge notes into the
                                     manifest
    {"kind": "sample", seq, ts, values: {series: value}}   — DELTA rows:
                                     only series whose value changed
                                     since the previous sample (first
                                     row = everything); readers
                                     reconstruct absolutes by
                                     accumulating
    {"kind": "rollup", t0, t1, n, series: {name: {min, max, mean,
     last}}}                       — n folded raw samples (see
                                     retention below)
    {"kind": "alert", ts, rule, from, to, value, severity, component,
     detail}                       — SLO rule lifecycle transitions

Retention (why a days-long soak stays MBs): the ledger keeps the most
recent `raw_window` samples raw; older samples are folded
oldest-first, `rollup_chunk` at a time, into one min/mean/max/last
rollup row, and the file is compacted in place (tmp + os.replace — the
checkpoint discipline; a reader never sees a half-written artifact).
At the 5 s default a day of soak is 17 280 samples -> 720 raw +
~260 rollups ≈ a few MB regardless of run length.

Overhead contract (same pin as tracing and the flight recorder's
record_step): with no
ledger attached, the fit-loop and serving hooks (`note_fit_step`,
`note_request`) are ONE module-global read — <10 µs/call, tested.
With one attached they are a couple of integer ops; all real work
(sampling, rule evaluation, IO) happens on the ledger's own daemon,
which is heartbeat-registered with the watchdog (`component ledger`)
and abortable like every other dl4j-* worker.

Opting in is one knob: `fit(run_ledger=path_or_ledger)`,
`ParallelInference(run_ledger=...)`, `DecodeEngine(run_ledger=...)`,
`InferenceServer(run_ledger=...)` (`--ledger`), or
`attach(RunLedger(path))` directly. While attached, firing SLO rules
emit findings (SLO001), increment `slo_alerts_total{rule,severity}`,
mark the owning component DEGRADED in utils/health, and drop a
flight-recorder event.

The manifest's `devices` names what torch sees: `platform` "gpu" with
the CUDA device count and the card's name (`torch.cuda.get_device_name`)
as `device_kind`, or "cpu" without a GPU. Its `flops_source` comes from
the first fit net's `model_flops_per_example` (utils/flops).
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
import uuid
from collections import deque
from typing import Dict, Iterator, List, Optional, Tuple

from deeplearning4j_tpu_torch.utils import blackbox as _blackbox
from deeplearning4j_tpu_torch.utils import health as _health
from deeplearning4j_tpu_torch.utils import metrics as _metrics

logger = logging.getLogger("deeplearning4j_tpu_torch")

# the module-global attachment point: hooks read this ONCE per call —
# the whole off-path cost when no ledger is recording
_LEDGER: Optional["RunLedger"] = None


def attach(ledger: "RunLedger") -> "RunLedger":
    """Make `ledger` the process's recording ledger (starts it if
    needed). One ledger records at a time — attaching a second replaces
    the first (which keeps running; detach/close it explicitly)."""
    global _LEDGER
    ledger.start()
    _LEDGER = ledger
    return ledger


def detach(ledger: Optional["RunLedger"] = None):
    """Stop routing hooks to the attached ledger (the ledger itself
    stays open). With an argument, only detaches if that ledger is the
    attached one — a scope that attached its own ledger cannot evict a
    replacement installed since."""
    global _LEDGER
    if ledger is None or _LEDGER is ledger:
        _LEDGER = None


def current() -> Optional["RunLedger"]:
    return _LEDGER


def attach_scoped(run_ledger, **kw) -> Tuple[Optional["RunLedger"],
                                             Optional["RunLedger"]]:
    """The `run_ledger=` knob of fit and the serving entry points: a path
    builds a RunLedger there (`kw` to its constructor), owned by the
    scope; an instance is attached as given and stays its caller's.
    Returns (owned, attached) for `end_scope`."""
    if run_ledger is None:
        return None, None
    if isinstance(run_ledger, str):
        owned = RunLedger(run_ledger, **kw)
        return owned, attach(owned)
    return None, attach(run_ledger)


def end_scope(owned: Optional["RunLedger"],
              attached: Optional["RunLedger"]) -> None:
    """End an `attach_scoped` scope: an owned ledger takes its final
    sample and closes; a caller's is only detached (its recording thread
    lives on)."""
    if owned is not None:
        owned.close()
    elif attached is not None:
        detach(attached)


# -- the hot-path hooks (one global read when off) ----------------------------

def note_fit_step(net) -> None:
    """Fit-loop hook (netbase._timed_fit): no ledger = one global read.
    Attached: count the step and, once, hand the ledger the net so the
    manifest can be enriched (config hash, flops source) off-thread."""
    led = _LEDGER
    if led is None:
        return
    led._fit_steps += 1
    if led._net is None:
        led._net = net


def note_request() -> None:
    """Serving hook (ParallelInference.output): same contract."""
    led = _LEDGER
    if led is None:
        return
    led._requests += 1


class RunLedger:
    """One training/serving run's persistent metric history + live SLO
    judgment. Context manager; `close()` takes a final sample and
    flushes, so even a run shorter than `sample_every` leaves a
    start/end pair to diff."""

    def __init__(self, path: str, sample_every: float = 5.0,
                 raw_window: int = 720, rollup_chunk: int = 64,
                 rules=None, manifest: Optional[dict] = None,
                 links: Optional[dict] = None):
        from deeplearning4j_tpu_torch.analysis.slo import SLORule, SLORuleSet

        self.path = path
        self.sample_every = max(0.05, float(sample_every))
        self.raw_window = max(2, int(raw_window))
        self.rollup_chunk = max(2, int(rollup_chunk))
        if rules is not None and not isinstance(rules, SLORuleSet):
            rules = SLORuleSet([r if isinstance(r, SLORule)
                                else SLORule.from_dict(r) for r in rules])
        self.rules = rules
        self.run_id = (manifest or {}).get("run_id") \
            or f"{time.strftime('%Y%m%d-%H%M%S')}-{uuid.uuid4().hex[:8]}"
        self._manifest_extra = dict(manifest or {})
        self._links = dict(links or {})
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._hb = None
        self._file = None
        self._started = False
        self._closed = False
        self._seq = 0
        # reconstruction state: last written absolutes (for delta rows)
        self._current: Dict[str, float] = {}
        # retained rows, in file order (manifest/notes/alerts/rollups/
        # samples) — the compaction rewrite source of truth
        self._rows: List[dict] = []
        # absolutes per retained raw sample, aligned with the raw
        # sample rows (rollup math needs per-sample values)
        self._raw_abs: deque = deque()
        self._raw_indices: deque = deque()  # indices into _rows
        self._alerts: deque = deque(maxlen=256)  # recent transitions
        self.findings: List = []  # analysis.findings.Finding, bounded
        # firing-rule count per health component: DEGRADED while > 0
        self._component_firing: Dict[str, int] = {}
        # hook counters (GIL-atomic int adds; no lock on the hot path):
        # the run's OWN share of fit steps / serving requests — written
        # into the artifact as a closing note (the registry families
        # count the whole process lifetime)
        self._fit_steps = 0
        self._requests = 0
        self._net = None  # first fit net seen; manifest enrichment
        self._net_noted = False

    # -- lifecycle ------------------------------------------------------------

    def start(self) -> "RunLedger":
        with self._lock:
            if self._started:
                return self
            self._started = True
        if os.path.dirname(self.path):
            os.makedirs(os.path.dirname(self.path), exist_ok=True)
        self._file = open(self.path, "w")
        self._append_row(self._build_manifest())
        self.sample_now()  # t0 baseline: diffs cover the whole run
        # per-run component name: concurrent ledgers (a session-wide
        # ledger + a test's own) must not evict each other's
        # watchdog coverage by re-registering one shared name
        self._hb = _health.get_health().register(
            f"ledger-{self.run_id[-8:]}",
            stall_after=max(60.0, 8.0 * self.sample_every))
        self._thread = threading.Thread(
            target=self._loop, daemon=True,
            name=f"dl4j-ledger-{self.run_id[-8:]}")
        self._thread.start()
        return self

    def close(self):
        """Final sample, flush, retire the daemon (unregistering its
        heartbeat), detach if attached. Idempotent."""
        with self._lock:
            if self._closed or not self._started:
                self._closed = True
                return
            self._closed = True
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
        detach(self)
        try:
            self.sample_now()
        except Exception:
            logger.exception("run ledger final sample failed")
        with self._lock:
            # persist the hook-side activity tally: how many fit steps /
            # serving requests ran through the instrumented paths WHILE
            # this ledger was attached — the registry families are
            # process-lifetime, this is the run's own share (readers
            # merge the note into the manifest)
            self._append_row({
                "kind": "note", "ts": round(time.time(), 3),
                "fit_steps_hooked": self._fit_steps,
                "requests_hooked": self._requests,
            })
            if self._file is not None:
                self._file.close()
                self._file = None
        if self._hb is not None:
            _health.get_health().unregister(self._hb)
        # a closed ledger must leave no condition behind: resolve every
        # component its firing rules degraded
        for comp, n in list(self._component_firing.items()):
            if n > 0:
                _health.get_health().set_condition(
                    comp, _health.OK, reason=f"ledger {self.run_id} closed")
        self._component_firing.clear()

    def __enter__(self) -> "RunLedger":
        return self.start()

    def __exit__(self, *exc):
        self.close()
        return False

    # -- the recorder thread --------------------------------------------------

    def _loop(self):
        while not self._stop.wait(self.sample_every):
            try:
                with self._hb.busy():
                    self.sample_now()
            except Exception:  # a sampling bug must not kill recording
                logger.exception("run ledger sample failed")

    def sample_now(self, ts: Optional[float] = None):
        """Take one sample (callable from tests / the closing thread):
        registry scalars + buckets, delta row, rule evaluation with live
        side effects, rollup-based compaction when the raw window
        overflows."""
        ts = time.time() if ts is None else float(ts)
        values = _metrics.get_registry().scalar_values(include_buckets=True)
        with self._lock:
            if self._file is None and self._started:
                return  # closed under us
            if self._net is not None and not self._net_noted:
                self._net_noted = True
                note = self._net_note()
                if note:
                    self._append_row({"kind": "note",
                                      "ts": round(ts, 3), **note})
            delta = {k: v for k, v in values.items()
                     if self._current.get(k) != v}
            self._seq += 1
            row = {"kind": "sample", "seq": self._seq,
                   "ts": round(ts, 3), "values": delta}
            self._current = values
            self._raw_indices.append(len(self._rows))
            self._append_row(row)
            self._raw_abs.append(values)
            if len(self._raw_abs) > self.raw_window + self.rollup_chunk:
                self._compact_locked()
            if self._file is not None:
                self._file.flush()
        if self.rules is not None:
            try:
                transitions = self.rules.evaluate(ts, values)
            except Exception:
                logger.exception("SLO rule evaluation failed")
                transitions = []
            for tr in transitions:
                self._apply_transition(tr)

    # -- persistence ----------------------------------------------------------

    def _append_row(self, row: dict):
        self._rows.append(row)
        if self._file is not None:
            self._file.write(json.dumps(row, default=str) + "\n")

    def _compact_locked(self):
        """Fold the oldest `rollup_chunk` raw samples into one rollup
        row and rewrite the artifact. The rollup carries min/max/mean/
        last for EVERY series live at the span's end, so reconstruction
        seeds exactly (a series untouched within the span has min ==
        max == last)."""
        chunk_n = self.rollup_chunk
        abs_rows = [self._raw_abs.popleft() for _ in range(chunk_n)]
        idxs = [self._raw_indices.popleft() for _ in range(chunk_n)]
        t0 = self._rows[idxs[0]]["ts"]
        t1 = self._rows[idxs[-1]]["ts"]
        series: Dict[str, dict] = {}
        last = abs_rows[-1]
        for key, v_last in last.items():
            vs = [a[key] for a in abs_rows if key in a]
            series[key] = {
                "min": min(vs), "max": max(vs),
                "mean": round(sum(vs) / len(vs), 9), "last": v_last,
            }
        rollup = {"kind": "rollup", "t0": t0, "t1": t1,
                  "n": chunk_n, "series": series}
        # splice: replace the chunk's sample rows with the one rollup,
        # keeping interleaved notes/alerts in place
        drop = set(idxs)
        new_rows: List[dict] = []
        remap: Dict[int, int] = {}
        inserted = False
        for i, r in enumerate(self._rows):
            if i in drop:
                if not inserted:
                    new_rows.append(rollup)
                    inserted = True
                continue
            remap[i] = len(new_rows)
            new_rows.append(r)
        self._raw_indices = deque(remap[i] for i in self._raw_indices)
        self._rows = new_rows
        # the delta of the first surviving sample row is relative to the
        # rollup's `last` values — reconstruction is exact; rewrite the
        # whole artifact atomically
        tmp = f"{self.path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            for r in self._rows:
                f.write(json.dumps(r, default=str) + "\n")
        os.replace(tmp, self.path)
        if self._file is not None:
            self._file.close()
            self._file = open(self.path, "a")

    def _build_manifest(self) -> dict:
        import sys

        import torch

        if torch.cuda.is_available():
            devices = {"platform": "gpu",
                       "device_count": torch.cuda.device_count(),
                       "device_kind": torch.cuda.get_device_name(0)}
        else:
            devices = {"platform": "cpu", "device_count": 1,
                       "device_kind": "cpu"}

        man = {
            "kind": "manifest",
            "run_id": self.run_id,
            "ts": round(time.time(), 3),
            "pid": os.getpid(),
            "argv": list(sys.argv),
            "sample_every": self.sample_every,
            "raw_window": self.raw_window,
            "rollup_chunk": self.rollup_chunk,
            "devices": devices,
            "config_hash": None,
            "flops_source": None,
            "links": self._links,
            "rules": self.rules.to_dicts() if self.rules is not None
            else [],
        }
        extra = {k: v for k, v in self._manifest_extra.items()
                 if k not in ("kind", "run_id")}
        man.update(extra)
        return man

    def _net_note(self) -> dict:
        """Manifest enrichment from the first fit net the hooks saw —
        computed on the recorder thread, never on the fit hot path."""
        net = self._net
        note = {}
        try:
            conf_json = net.conf.to_json()
        except Exception:
            conf_json = repr(getattr(net, "conf", None))
        try:
            import hashlib

            note["config_hash"] = hashlib.sha256(
                conf_json.encode()).hexdigest()[:16]
        except Exception:
            pass
        try:
            _, source = net.model_flops_per_example()
            note["flops_source"] = source
        except Exception:
            pass
        note["network_type"] = type(net).__name__
        return note

    def add_link(self, name: str, target: str):
        """Link a sibling artifact (bench JSON, trace export, blackbox
        dump) into the run's record — an append-only note."""
        with self._lock:
            self._links[name] = target
            self._append_row({"kind": "note", "ts": round(time.time(), 3),
                              "links": {name: target}})
            if self._file is not None:
                self._file.flush()

    # -- live alert side effects ----------------------------------------------

    def _apply_transition(self, tr: dict):
        """One rule lifecycle transition: persist it, then the live
        surfaces — slo_alerts_total, health condition on the owning
        component, flight-recorder event, and a structured finding."""
        with self._lock:
            self._alerts.append(tr)
            self._append_row({"kind": "alert", **tr})
            if self._file is not None:
                self._file.flush()
        comp = tr["component"]
        firing = tr["to"] == "firing"
        if firing:
            _metrics.get_registry().counter(
                "slo_alerts_total",
                "SLO rule firings (analysis/slo via the run ledger)",
                ("rule", "severity")).labels(tr["rule"],
                                             tr["severity"]).inc()
            n = self._component_firing.get(comp, 0) + 1
            self._component_firing[comp] = n
            _health.get_health().set_condition(
                comp, _health.DEGRADED,
                reason=f"SLO rule {tr['rule']} firing: {tr['detail']}")
            try:
                from deeplearning4j_tpu_torch.analysis.findings import Finding

                self.findings.append(Finding(
                    "SLO001", tr["severity"], f"rule:{tr['rule']}",
                    f"SLO rule firing (value {tr['value']}): "
                    f"{tr['detail']}",
                    "inspect the ledger around this timestamp "
                    f"({self.path}; slo.evaluate_ledger replays it)"))
                del self.findings[:-64]  # bounded
            except Exception:
                logger.exception("SLO finding emission failed")
        else:
            n = max(0, self._component_firing.get(comp, 1) - 1)
            self._component_firing[comp] = n
            if n == 0:
                _health.get_health().set_condition(
                    comp, _health.OK,
                    reason=f"SLO rule {tr['rule']} resolved")
        _blackbox.get_recorder().record_event(
            "slo_alert", rule=tr["rule"], to=tr["to"],
            severity=tr["severity"], component=comp,
            value=tr["value"])
        logger.warning("SLO rule %r %s (value %s): %s", tr["rule"],
                       tr["to"], tr["value"], tr["detail"])

    # -- readout --------------------------------------------------------------

    def alert_status(self) -> dict:
        """The live /alerts payload: per-rule states + recent
        transitions."""
        with self._lock:
            recent = list(self._alerts)
        return {
            "run_id": self.run_id,
            "ledger": self.path,
            "rules": self.rules.status() if self.rules is not None else [],
            "firing": self.rules.firing() if self.rules is not None
            else [],
            "transitions": recent,
        }


# -- reading ledger artifacts ---------------------------------------------------

def read_ledger(path: str) -> dict:
    """Parse a ledger artifact into {manifest, rows}. Notes merge into
    the manifest (late enrichment is part of the run's identity); a torn
    final line (the process died mid-append) is dropped, not fatal."""
    manifest: dict = {}
    rows: List[dict] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                row = json.loads(line)
            except json.JSONDecodeError:
                logger.warning("ledger %s: dropping torn row", path)
                continue
            kind = row.get("kind")
            if kind == "manifest":
                manifest = row
            elif kind == "note":
                links = row.get("links")
                if links:
                    manifest.setdefault("links", {}).update(links)
                for k, v in row.items():
                    if k not in ("kind", "ts", "links"):
                        manifest[k] = v
            else:
                rows.append(row)
    return {"manifest": manifest, "rows": rows, "path": path}


def iter_samples(doc: dict) -> Iterator[Tuple[float, Dict[str, float]]]:
    """Reconstruct the absolute sample stream (ts, {series: value})
    from a parsed ledger: rollups seed the accumulator with their
    `last` values, delta sample rows update it."""
    acc: Dict[str, float] = {}
    for row in doc["rows"]:
        kind = row.get("kind")
        if kind == "rollup":
            for k, st in row.get("series", {}).items():
                acc[k] = st["last"]
        elif kind == "sample":
            acc.update(row.get("values", {}))
            yield float(row["ts"]), dict(acc)


def iter_alerts(doc: dict) -> Iterator[dict]:
    for row in doc["rows"]:
        if row.get("kind") == "alert":
            yield row


# -- cross-run summary & regression analysis ----------------------------------

def summarize_run(doc: dict) -> dict:
    """Per-series stats over a run — the vs_baseline idea generalized
    from bench one-shots to whole runs. Counters (and histogram
    count/sum facets) report their RATE over the run (delta/duration);
    gauges report mean/min/max/last over the samples."""
    first: Dict[str, float] = {}
    last: Dict[str, float] = {}
    agg: Dict[str, dict] = {}
    t0 = t1 = None
    n = 0
    for ts, values in iter_samples(doc):
        n += 1
        t0 = ts if t0 is None else t0
        t1 = ts
        for k, v in values.items():
            if ":bucket:" in k:
                continue
            if k not in first:
                first[k] = v
                agg[k] = {"min": v, "max": v, "sum": 0.0, "n": 0}
            a = agg[k]
            a["min"] = min(a["min"], v)
            a["max"] = max(a["max"], v)
            a["sum"] += v
            a["n"] += 1
            last[k] = v
    duration = max(1e-9, (t1 or 0.0) - (t0 or 0.0))
    series: Dict[str, dict] = {}
    for k, v_last in last.items():
        a = agg[k]
        counterish = (k.endswith(":count") or k.endswith(":sum")
                      or k.split("{")[0].endswith("_total"))
        entry = {
            "first": first[k], "last": v_last,
            "mean": round(a["sum"] / max(1, a["n"]), 9),
            "min": a["min"], "max": a["max"],
        }
        if counterish:
            entry["delta"] = round(v_last - first[k], 9)
            entry["rate_per_sec"] = round(entry["delta"] / duration, 9)
        series[k] = entry
    # derived histogram means (latency family headline): delta sum /
    # delta count per family+labels
    for k in list(series):
        if k.endswith(":count"):
            base = k[:-len(":count")]
            sk = base + ":sum"
            if sk in series:
                dc = series[k].get("delta", 0.0)
                dsum = series[sk].get("delta", 0.0)
                if dc and dc > 0:
                    series[base + ":mean"] = {
                        "mean": round(dsum / dc, 9),
                        "derived": True,
                    }
    return {
        "run_id": doc["manifest"].get("run_id"),
        "path": doc.get("path"),
        "samples": n,
        "duration_seconds": round(duration, 3),
        "series": series,
    }


def _family(key: str) -> str:
    base = key.split("{")[0]
    for sfx in (":count", ":sum", ":mean"):
        if key.endswith(sfx):
            return base + sfx
    return base


def compare_runs(reference: dict, candidate: dict,
                 threshold: float = 0.25,
                 min_magnitude: float = 1e-9) -> dict:
    """Per-metric regression deltas of `candidate` vs `reference` (two
    summarize_run outputs): for counter-ish series the RATE ratio, for
    gauges (and derived histogram means) the MEAN ratio. A series is
    flagged when |ratio - 1| > threshold — direction-agnostic (the
    ledger cannot know which way is "worse" for every series; the
    verdict names the family, the operator knows the sign). Only
    series present in BOTH runs compare; `only_in_*` lists the rest."""
    ref_s, cand_s = reference["series"], candidate["series"]
    rows: List[dict] = []
    flagged: List[dict] = []
    for k in sorted(set(ref_s) & set(cand_s)):
        r, c = ref_s[k], cand_s[k]
        if "rate_per_sec" in r and "rate_per_sec" in c:
            rv, cv, basis = r["rate_per_sec"], c["rate_per_sec"], "rate"
        else:
            rv, cv, basis = r["mean"], c["mean"], "mean"
        if abs(rv) < min_magnitude and abs(cv) < min_magnitude:
            continue
        ratio = None if abs(rv) < min_magnitude else round(cv / rv, 4)
        row = {"series": k, "family": _family(k), "basis": basis,
               "reference": rv, "candidate": cv, "ratio": ratio}
        rows.append(row)
        if ratio is None or abs(ratio - 1.0) > threshold:
            flagged.append(row)
    flagged.sort(key=lambda r: -abs((r["ratio"] or 1e9) - 1.0))
    families = sorted({r["family"] for r in flagged})
    return {
        "reference": {"run_id": reference.get("run_id"),
                      "path": reference.get("path"),
                      "duration_seconds":
                          reference.get("duration_seconds")},
        "candidate": {"run_id": candidate.get("run_id"),
                      "path": candidate.get("path"),
                      "duration_seconds":
                          candidate.get("duration_seconds")},
        "threshold": threshold,
        "series": rows,
        "regressions": flagged,
        "regression_families": families,
        "ok": not flagged,
    }


def list_ledgers(directory: str) -> List[dict]:
    """Manifest summaries of every ledger artifact in a directory. A file that does not parse as a ledger is skipped."""
    out = []
    try:
        names = sorted(os.listdir(directory))
    except OSError:
        return out
    for name in names:
        if not name.endswith((".jsonl", ".ledger")):
            continue
        path = os.path.join(directory, name)
        try:
            with open(path) as f:
                head = json.loads(f.readline())
        except (OSError, json.JSONDecodeError, ValueError):
            continue
        if head.get("kind") != "manifest":
            continue
        out.append({
            "path": path,
            "run_id": head.get("run_id"),
            "ts": head.get("ts"),
            "devices": head.get("devices"),
            "rules": len(head.get("rules") or []),
            "links": head.get("links") or {},
        })
    return out

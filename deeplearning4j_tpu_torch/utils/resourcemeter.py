"""Tenant-scoped resource metering — the cross-tier budget ledger. The
port of the JAX package's utils/resourcemeter.py.

utils/tenancy.py answers "who is this request"; this module answers
"what did each tenant spend", with one vocabulary across every tier:

* **device-seconds** — decode steps and serving forwards are wall-timed
  on their own threads (each ends in a host readback, so the window
  covers the device work), and each step/forward's duration is split
  across the tenants it served (slots / rows), so weighted-fair
  scheduling becomes auditable SPEND, not just slot order. Training
  windows come through `note_device_window`, called by the sampled
  device profiler (utils/devprof) with each measured window.
* **device-resident bytes** — per-version decode weights (and, through
  `note_device_window`, a net's params + updater), keyed by source so a
  dropped weight version releases its bytes.
* **wire bytes** — gradient all-reduce and parameter-server payloads.
* **tokens / examples** and the **outcome books** (AdmissionBooks, the
  conservation law's home, shared by the serving, decode and REST
  tiers).

Everything lands in the process metrics registry as
`tenant_device_seconds_total{tenant,tier}` /
`tenant_hbm_bytes{tenant}` / `tenant_wire_bytes_total{tenant,tier}` /
`tenant_tokens_total{tenant}` / `tenant_examples_total{tenant,tier}`,
next to `process_device_seconds_total{tier}` — the right-hand side of
the spend conservation invariant (per-tenant device-seconds sum to the
process total per tier, because both are incremented in the same hook).
`GET /tenants` (serving/inference_server.py) reads them back through
`spend_table()`, the parse of the registry's flat scalar-values view.

Off-path contract: every `note_*` hook begins with one module-global
read — an unmetered process pays a None check per call, pinned under
10 µs by test. Metering is armed process-wide with `enable()` (the
server's --meter flag does this); books registration is always-on but
init-time-only, so engines never branch on the meter in their hot loops
beyond that one read.
"""

from __future__ import annotations

import math
import re
import threading
import weakref
from typing import Dict, List, Optional, Tuple

from deeplearning4j_tpu_torch.utils import metrics as _metrics
from deeplearning4j_tpu_torch.utils import tenancy as _tenancy

TIER_TRAINING = "training"
TIER_SERVING = "serving"
TIER_DECODE = "decode"
TIER_PARAMSERVER = "paramserver"

TIERS = (TIER_TRAINING, TIER_SERVING, TIER_DECODE, TIER_PARAMSERVER)


class AdmissionBooks:
    """Exact request accounting under the conservation law

        admitted == completed + shed + failed

    with per-"stage/reason" shed breakdowns. Admission REFUSALS land in
    `rejected`, outside the law — the request never entered the system.
    Keyed by tenant (None books under the default tenant), so
    multi-tenant hosting's books stay exact per customer. The shared
    implementation every tier uses: ParallelInference, the decode
    engine, and the REST layer all book through this class. NOT
    internally locked — callers mutate under their own admission lock,
    exactly as the inline counters this class replaced were."""

    _KEYS = ("admitted", "completed", "shed", "failed", "rejected")

    def __init__(self):
        self._tenants: dict = {}

    def _t(self, tenant):
        t = self._tenants.get(tenant)
        if t is None:
            t = self._tenants[tenant] = {
                "admitted": 0, "completed": 0, "shed": 0, "failed": 0,
                "rejected": 0, "shed_by": {}}
        return t

    def admit(self, tenant=None):
        self._t(tenant)["admitted"] += 1

    def complete(self, tenant=None):
        self._t(tenant)["completed"] += 1

    def fail(self, tenant=None):
        self._t(tenant)["failed"] += 1

    def shed(self, stage: str, reason: str, tenant=None,
             admitted: bool = True):
        t = self._t(tenant)
        key = f"{stage}/{reason}"
        t["shed_by"][key] = t["shed_by"].get(key, 0) + 1
        t["shed" if admitted else "rejected"] += 1

    def totals(self) -> dict:
        agg = {k: 0 for k in self._KEYS}
        agg["shed_by"] = {}
        for t in self._tenants.values():
            for k in self._KEYS:
                agg[k] += t[k]
            for sb, v in t["shed_by"].items():
                agg["shed_by"][sb] = agg["shed_by"].get(sb, 0) + v
        return agg

    def per_tenant(self) -> dict:
        return {
            (_tenancy.DEFAULT_TENANT if t is None else t): {
                **{k: b[k] for k in self._KEYS},
                "shed_by": dict(b["shed_by"]),
                "conservation_ok":
                    b["admitted"] == b["completed"] + b["shed"] + b["failed"],
            }
            for t, b in self._tenants.items()
        }

    def conservation_ok(self) -> bool:
        """The law, per tenant AND therefore in aggregate."""
        return all(
            t["admitted"] == t["completed"] + t["shed"] + t["failed"]
            for t in self._tenants.values())


# -- always-on books registry -------------------------------------------------
#
# Engines register their AdmissionBooks at construction (init-time, not
# hot-path) so GET /tenants can aggregate outcome
# books across tiers even when spend metering was never enabled.
# Weak-valued: a shut-down engine's books disappear with it.

_books_lock = threading.Lock()
_BOOKS: "weakref.WeakValueDictionary" = weakref.WeakValueDictionary()
_books_seq = 0


def register_books(tier: str, books: AdmissionBooks) -> None:
    global _books_seq
    with _books_lock:
        _books_seq += 1
        _BOOKS[(tier, _books_seq)] = books


def books_by_tier() -> Dict[str, List[AdmissionBooks]]:
    out: Dict[str, List[AdmissionBooks]] = {}
    with _books_lock:
        items = list(_BOOKS.items())
    for (tier, _), b in items:
        out.setdefault(tier, []).append(b)
    return out


def merged_books(tier: Optional[str] = None) -> dict:
    """Per-tenant outcome books merged across every live book-keeper
    (optionally one tier): the cross-tier conservation view."""
    merged: Dict[str, dict] = {}
    for t, books in books_by_tier().items():
        if tier is not None and t != tier:
            continue
        for b in books:
            for tenant, rec in b.per_tenant().items():
                agg = merged.setdefault(tenant, {
                    "admitted": 0, "completed": 0, "shed": 0,
                    "failed": 0, "rejected": 0})
                for k in agg:
                    agg[k] += rec[k]
    for rec in merged.values():
        rec["conservation_ok"] = (
            rec["admitted"]
            == rec["completed"] + rec["shed"] + rec["failed"])
    return merged


# -- the meter ----------------------------------------------------------------

class ResourceMeter:
    """Per-tenant per-tier spend accounting on the shared metrics
    registry. One instance per process (module global, `enable()`);
    internally locked — hooks are called from fit threads, the decode
    loop, serving dispatchers, and HTTP handlers concurrently."""

    def __init__(self):
        self._lock = threading.Lock()
        reg = _metrics.get_registry()
        self._c_device = reg.counter(
            "tenant_device_seconds_total",
            "device time attributed to a tenant, by tier (training: "
            "sampled windows; decode/serving: step/forward "
            "wall time split over the tenants served)",
            ("tenant", "tier"))
        self._c_process = reg.counter(
            "process_device_seconds_total",
            "device time metered for the whole process, by tier — the "
            "right-hand side of the per-tenant spend conservation "
            "invariant", ("tier",))
        self._c_wire = reg.counter(
            "tenant_wire_bytes_total",
            "interconnect/network payload bytes attributed to a tenant, "
            "by tier (gradient all-reduce, paramserver push/pull)",
            ("tenant", "tier"))
        self._c_tokens = reg.counter(
            "tenant_tokens_total",
            "decode tokens emitted for a tenant", ("tenant",))
        self._c_examples = reg.counter(
            "tenant_examples_total",
            "examples processed for a tenant, by tier", ("tenant",))
        self._g_hbm = reg.gauge(
            "tenant_hbm_bytes",
            "HBM-resident bytes attributed to a tenant (net params + "
            "updater state, decode weight versions), summed over "
            "sources", ("tenant",))
        # source -> (tenant, bytes): a dropped source (old decode weight
        # version, a net going away) releases its bytes from the gauge
        self._hbm: Dict[str, Tuple[str, float]] = {}

    # -- charging (all tenant args are raw; interning happens here) ----------

    def charge_device_seconds(self, tenant, tier: str, seconds: float,
                              examples: int = 0) -> None:
        if seconds <= 0:
            return
        t = _tenancy.intern(tenant)
        self._c_device.labels(t, tier).inc(seconds)
        self._c_process.labels(tier).inc(seconds)
        if examples:
            self._c_examples.labels(t).inc(examples)

    def charge_device_split(self, shares: Dict[str, float], tier: str,
                            seconds: float) -> None:
        """Split one measured window across tenants proportional to
        `shares` (slots or rows served). The process total gets the
        whole window ONCE — per-tenant spend sums to it exactly."""
        if seconds <= 0 or not shares:
            return
        total = float(sum(shares.values()))
        if total <= 0:
            return
        for tenant, w in shares.items():
            self._c_device.labels(_tenancy.intern(tenant), tier).inc(
                seconds * float(w) / total)
        self._c_process.labels(tier).inc(seconds)

    def charge_wire(self, tenant, tier: str, nbytes: int) -> None:
        if nbytes > 0:
            self._c_wire.labels(_tenancy.intern(tenant), tier).inc(nbytes)

    def charge_tokens(self, tenant, n: int) -> None:
        if n > 0:
            self._c_tokens.labels(_tenancy.intern(tenant)).inc(n)

    def set_hbm(self, tenant, source: str, nbytes: float) -> None:
        """Point-in-time HBM attribution for one `source` (a net's
        params, one decode weight version). 0 releases the source."""
        t = _tenancy.intern(tenant)
        with self._lock:
            if nbytes <= 0:
                self._hbm.pop(source, None)
            else:
                self._hbm[source] = (t, float(nbytes))
            sums: Dict[str, float] = {}
            for ten, b in self._hbm.values():
                sums[ten] = sums.get(ten, 0.0) + b
            for ten in {t, *sums}:
                self._g_hbm.labels(ten).set(sums.get(ten, 0.0))

    # -- readout --------------------------------------------------------------

    def snapshot(self) -> dict:
        """The /tenants document: per-tenant spend (from the registry's
        flat scalar view), the
        merged outcome books, and the conservation verdicts."""
        values = _metrics.get_registry().scalar_values()
        table = spend_table(values)
        books = merged_books()
        tenants = sorted({*table, *books})
        return {
            "tenants": {
                t: {**table.get(t, _empty_spend()),
                    "books": books.get(t)}
                for t in tenants
            },
            "books_by_tier": {
                tier: merged_books(tier) for tier in books_by_tier()
            },
            "conservation": conservation(values, books),
            "registry_tenants": _tenancy.get_tenant_registry().tenants(),
        }


_METER: Optional[ResourceMeter] = None


def enable() -> ResourceMeter:
    """Arm process-wide metering (idempotent). Until this runs, every
    note_* hook is one module-global read returning immediately."""
    global _METER
    if _METER is None:
        _METER = ResourceMeter()
    return _METER


def disable() -> None:
    """Tests only: restore the unmetered off-path."""
    global _METER
    _METER = None


def get_meter() -> Optional[ResourceMeter]:
    return _METER


def is_enabled() -> bool:
    return _METER is not None


def snapshot() -> dict:
    """The /tenants document whether or not spend metering is armed:
    metered processes get the full spend+books view; unmetered ones
    still get the always-on outcome books and the conservation verdict
    (vacuously spend-ok), plus a note saying why spend is empty."""
    m = _METER
    if m is not None:
        return m.snapshot()
    values = _metrics.get_registry().scalar_values()
    books = merged_books()
    return {
        "tenants": {t: {**_empty_spend(), "books": b}
                    for t, b in books.items()},
        "books_by_tier": {tier: merged_books(tier)
                          for tier in books_by_tier()},
        "conservation": conservation(values, books),
        "registry_tenants": _tenancy.get_tenant_registry().tenants(),
        "note": "spend metering disabled (resourcemeter.enable()): "
                "outcome books only",
    }


# -- hot-path hooks (one module-global read when unmetered) -------------------

def note_device_window(net, dt: float, examples: int = 0) -> None:
    """A sampled training window: `dt` seconds of device time for `net`
    since the last sample, charged to the net's registered tenant
    (register_net) in the training tier. Also refreshes the net's
    device-memory attribution from the byte sums utils/devprof caches on
    the net (`_devprof_state`), when there are any."""
    m = _METER
    if m is None:
        return
    tenant = getattr(net, "_tenant", None)
    m.charge_device_seconds(tenant, TIER_TRAINING, dt, examples=examples)
    st = getattr(net, "_devprof_state", None)
    if st and st.get("params_bytes"):
        m.set_hbm(tenant, f"net_params_{id(net)}",
                  st["params_bytes"] + (st.get("updater_bytes") or 0))


def note_decode_step(dt: float, slots_by_tenant: Dict[str, int]) -> None:
    m = _METER
    if m is None:
        return
    m.charge_device_split(slots_by_tenant, TIER_DECODE, dt)


def note_serving_forward(dt: float, rows_by_tenant: Dict[str, int]) -> None:
    m = _METER
    if m is None:
        return
    m.charge_device_split(rows_by_tenant, TIER_SERVING, dt)


def note_tokens(tenant, n: int) -> None:
    m = _METER
    if m is None:
        return
    m.charge_tokens(tenant, n)


def note_wire(tenant, tier: str, nbytes: int) -> None:
    m = _METER
    if m is None:
        return
    m.charge_wire(tenant, tier, nbytes)


def note_ps_pull(tenant, seconds: float) -> None:
    """Book sparse-embedding pull wall time (the wire wait the pipeline
    could not hide) against `tenant` under the paramserver tier — the
    time axis next to the wire bytes `note_wire` already books server-
    side. No-op until a meter is enabled."""
    m = _METER
    if m is None:
        return
    m.charge_device_seconds(tenant, TIER_PARAMSERVER, seconds)


def note_hbm(tenant, source: str, nbytes: float) -> None:
    m = _METER
    if m is None:
        return
    m.set_hbm(tenant, source, nbytes)


def register_net(net, tenant) -> None:
    """Give a training net the same identity serving uses: its device
    windows and wire bytes are booked under `tenant` from here on."""
    net._tenant = _tenancy.intern(tenant)


# -- the spend-table parse ----------------------------------------------------

_SERIES_RE = re.compile(r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
                        r"(?:\{(?P<labels>.*)\})?$")
_LABEL_RE = re.compile(r'(\w+)="((?:[^"\\]|\\.)*)"')

_SPEND_SERIES = ("tenant_device_seconds_total", "tenant_wire_bytes_total",
                 "tenant_tokens_total", "tenant_examples_total",
                 "tenant_hbm_bytes", "process_device_seconds_total")


def _empty_spend() -> dict:
    return {"device_seconds": {}, "wire_bytes": {}, "tokens": 0.0,
            "examples": 0.0, "hbm_bytes": 0.0}


def spend_table(values: Dict[str, float]) -> Dict[str, dict]:
    """Per-tenant spend from a flat `scalar_values()`-vocabulary dict
    (the live registry's, or a recorded sample of it)."""
    out: Dict[str, dict] = {}
    for key, v in values.items():
        mt = _SERIES_RE.match(key)
        if mt is None or mt.group("name") not in _SPEND_SERIES:
            continue
        name = mt.group("name")
        labels = dict(_LABEL_RE.findall(mt.group("labels") or ""))
        tenant = labels.get("tenant")
        if tenant is None:
            continue
        rec = out.setdefault(tenant, _empty_spend())
        tier = labels.get("tier", "")
        if name == "tenant_device_seconds_total":
            rec["device_seconds"][tier] = \
                rec["device_seconds"].get(tier, 0.0) + v
        elif name == "tenant_wire_bytes_total":
            rec["wire_bytes"][tier] = rec["wire_bytes"].get(tier, 0.0) + v
        elif name == "tenant_tokens_total":
            rec["tokens"] += v
        elif name == "tenant_examples_total":
            rec["examples"] += v
        elif name == "tenant_hbm_bytes":
            rec["hbm_bytes"] += v
    return out


def process_device_seconds(values: Dict[str, float]) -> Dict[str, float]:
    out: Dict[str, float] = {}
    for key, v in values.items():
        mt = _SERIES_RE.match(key)
        if mt is None or mt.group("name") != "process_device_seconds_total":
            continue
        labels = dict(_LABEL_RE.findall(mt.group("labels") or ""))
        out[labels.get("tier", "")] = v
    return out


def conservation(values: Dict[str, float],
                 books: Optional[dict] = None,
                 rel_tol: float = 1e-6) -> dict:
    """The invariant the chaos tests and the overload phase hold:
    per-tenant outcome books obey the conservation law, and per-tier
    tenant device-seconds sum (within float tolerance) to the process
    total metered for that tier."""
    if books is None:
        books = merged_books()
    table = spend_table(values)
    proc = process_device_seconds(values)
    per_tier_sum: Dict[str, float] = {}
    for rec in table.values():
        for tier, s in rec["device_seconds"].items():
            per_tier_sum[tier] = per_tier_sum.get(tier, 0.0) + s
    spend_ok = all(
        math.isclose(per_tier_sum.get(tier, 0.0), total,
                     rel_tol=rel_tol, abs_tol=1e-9)
        for tier, total in proc.items())
    books_ok = all(rec["conservation_ok"] for rec in books.values())
    return {
        "books_ok": books_ok,
        "spend_ok": spend_ok,
        "ok": books_ok and spend_ok,
        "device_seconds_by_tier": proc,
        "tenant_device_seconds_by_tier": per_tier_sum,
    }

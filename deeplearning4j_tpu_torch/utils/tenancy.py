"""Process-global tenant identity — who is spending the chips (a stdlib
copy of the JAX package's utils/tenancy.py, which tracing imports).

Every tier of the stack already keeps *some* per-customer accounting
(the decode engine's weighted-fair books, ParallelInference's admission
books, the paramserver's RPC counters), but each grew its own notion of
"tenant": serving had real names, training had none, and nothing
crossed a process boundary. This module is the one shared identity
layer the resource meter (utils/resourcemeter) and every book-keeper
sit on:

* **Bounded interning** — `intern(name)` canonicalizes a raw tenant
  string (strip, length-cap, label-safe charset) and registers it in a
  process-global registry bounded at `max_tenants` (default 64, env
  `DL4J_MAX_TENANTS`). Past the cap, *new* names collapse into the
  `__other__` tenant: tenant names come from request headers, so an
  unbounded mapping would let any client explode the metrics registry
  and the run ledger one curl at a time (label-cardinality DoS — the
  same bound the kernel-family helper labels enforce).

* **Thread-local propagation** — `attach()`/`detach()`/`tenant_scope()`
  carry the active tenant across queue hops and worker threads exactly
  like utils/tracing carries the span context; `current_tenant()` is
  one thread-local read. The tenant rides NEXT TO the W3C traceparent:
  utils/jsonhttp attaches it server-side from the `X-Tenant` header and
  `tenant_headers()` injects it client-side, so a paramserver pull made
  from a metered training step carries the same identity the serving
  tier books under.

* **Header contract** — `X-Tenant` (case-insensitive, like
  `X-Deadline-Ms`); REST routes let an explicit JSON `tenant` field win
  over the header, both funnel through `intern()`.

Off-path cost: a process that never names a tenant pays one
thread-local read per hook (`current_tenant()` returns None), and the
registry holds only the default tenant. No repo imports here — the
metrics registry imports THIS module for exemplar tagging, so tenancy
stays at the bottom of the dependency stack.
"""

from __future__ import annotations

import os
import threading
from typing import Dict, List, Optional

DEFAULT_TENANT = "default"

# the collapse bucket for names arriving past the registry cap: spend
# and books stay conserved (everything is counted SOMEWHERE), only the
# per-name breakdown saturates
OVERFLOW_TENANT = "__other__"

HEADER = "X-Tenant"

DEFAULT_MAX_TENANTS = int(os.environ.get("DL4J_MAX_TENANTS", "64"))

# label-value safety: tenant names land verbatim inside Prometheus-style
# label quotes and ledger JSONL — anything outside this set is mapped
# to "_" rather than trusted
_SAFE = set("abcdefghijklmnopqrstuvwxyz"
            "ABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789-_.:/@")
_MAX_NAME_LEN = 64


def _sanitize(name: str) -> str:
    s = name.strip()[:_MAX_NAME_LEN]
    if not s:
        return DEFAULT_TENANT
    return "".join(ch if ch in _SAFE else "_" for ch in s)


class TenantRegistry:
    """Bounded process-global intern table. NOT an ACL — identity and
    accounting only; admission policy stays in the engines."""

    def __init__(self, max_tenants: int = DEFAULT_MAX_TENANTS):
        self.max_tenants = max(1, int(max_tenants))
        self._lock = threading.Lock()
        # insertion-ordered: first-come keeps its name, late arrivals
        # past the cap collapse — deterministic under replay
        self._known: Dict[str, bool] = {DEFAULT_TENANT: True}
        self.overflowed = 0

    def intern(self, name) -> str:
        """Canonical tenant label for `name`: None/empty -> the default
        tenant; a known name -> itself; a new name -> registered, or
        `__other__` once the cap is reached."""
        if name is None:
            return DEFAULT_TENANT
        s = _sanitize(str(name))
        if s in self._known or s == OVERFLOW_TENANT:
            return s
        with self._lock:
            if s in self._known:
                return s
            if len(self._known) >= self.max_tenants:
                self.overflowed += 1
                return OVERFLOW_TENANT
            self._known[s] = True
        return s

    def tenants(self) -> List[str]:
        with self._lock:
            return list(self._known)

    def reset(self, max_tenants: Optional[int] = None) -> None:
        """Tests only: drop every interned name (the process-global
        registry otherwise accumulates across a pytest session)."""
        with self._lock:
            self._known = {DEFAULT_TENANT: True}
            self.overflowed = 0
            if max_tenants is not None:
                self.max_tenants = max(1, int(max_tenants))


_REGISTRY = TenantRegistry()


def get_tenant_registry() -> TenantRegistry:
    return _REGISTRY


def intern(name) -> str:
    return _REGISTRY.intern(name)


# -- thread-local propagation -------------------------------------------------

_tls = threading.local()


def current_tenant() -> Optional[str]:
    """The tenant attached to THIS thread, or None — one thread-local
    read, the whole disabled-path cost of every metering hook."""
    return getattr(_tls, "tenant", None)


def attach(tenant: Optional[str]):
    """Make `tenant` the ambient identity on this thread (queue hops,
    HTTP handler threads). Returns the token for the paired detach().
    None attaches "no tenant" — symmetric, so handlers always pair."""
    prev = getattr(_tls, "tenant", None)
    _tls.tenant = intern(tenant) if tenant is not None else None
    return prev


def detach(token) -> None:
    _tls.tenant = token


class tenant_scope:
    """`with tenancy.tenant_scope("acme"): ...` — attach/detach pair as
    a context manager (the fit loop and benches use it)."""

    def __init__(self, tenant: Optional[str]):
        self._tenant = tenant
        self._tok = None

    def __enter__(self):
        self._tok = attach(self._tenant)
        return self

    def __exit__(self, *exc):
        detach(self._tok)
        return False


# -- header plumbing ----------------------------------------------------------

def from_headers(headers) -> Optional[str]:
    """The `X-Tenant` value from a header mapping, case-insensitively
    (HTTP/2 proxies lowercase header names), or None. Accepts both the
    email.Message-style mapping jsonhttp handlers see and a plain
    dict."""
    if headers is None:
        return None
    get = getattr(headers, "get", None)
    if get is not None:
        v = get(HEADER)
        if v is not None:
            return str(v)
    return next((str(v) for k, v in headers.items()
                 if k.lower() == "x-tenant"), None)


def tenant_headers(headers: Optional[dict] = None,
                   tenant: Optional[str] = None) -> dict:
    """Outbound header dict with the tenant injected as `X-Tenant` —
    the client half of cross-process propagation, the shape of
    jsonhttp.traced_headers. Explicit `tenant` wins over the ambient
    one; neither -> headers pass through untagged. Never mutates the
    input."""
    out = dict(headers) if headers else {}
    t = tenant if tenant is not None else current_tenant()
    if t is not None:
        out[HEADER] = intern(t)
    return out

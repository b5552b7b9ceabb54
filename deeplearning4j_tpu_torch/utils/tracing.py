"""Host-side distributed tracing — the Dapper-style request/step half of
the observability layer (counters live in utils/metrics.py).

A span is a named, timed section of host code. Every span belongs to a
**trace**: the root span of a causal chain mints a 128-bit `trace_id`
(W3C trace-context format), and children inherit it — through the
thread-local parent stack on one thread, through an explicit
`SpanContext` handed across a queue to another thread (`attach()` /
`detach()` / `attached_ctx`), or through a W3C `traceparent` header
across a process boundary (`format_traceparent` / `parse_traceparent`;
utils/jsonhttp joins incoming headers on the server side and
`traced_headers()` injects them on the client side). A shed 429 or a
p99 outlier is therefore attributable: grep one `trace_id` across span
exports, JSON logs (`configure_logging(json_lines=True)`), flight-
recorder events, and histogram exemplars (utils/metrics.py), then feed
the export to `cli trace` (analysis/tracecrit.py) for the span tree and
its critical path.

Completed spans land in a bounded ring buffer (old traffic ages out; a
serving process never grows without bound) and export two ways:

* JSONL — one span per line, newest last (`InferenceServer GET /trace`,
  `TracingListener(jsonl_path=...)`); greppable, tail-able.
* Chrome trace event JSON — load the dict from `to_chrome_trace()` into
  chrome://tracing / Perfetto.

Both exports stamp `ts` in Unix microseconds, the clock torch.profiler
(Kineto) stamps its host events on: the tracer reads the offset between
`time.time_ns()` and `time.perf_counter_ns()` once, at its epoch, and
shifts every perf_counter reading by it. So a tracer export and a
profiler export of the same run merge into one timeline.

Device correlation: when enabled, each span also enters a profiler
range of its name (`_RecordFunctionFast`, function-scoped as an op's
range is), so the SAME names show up inside a `torch.profiler.profile()`
capture — the profiler's op tables and host spans line up by name. A
user-scoped `record_function` would be mirrored onto the card's
timeline as a `gpu_user_annotation` interval over every kernel it
launched, which a reader of the capture's device events would count as
busy time; a function-scoped range stays on the host. With the tracer
off, `span()` still names its section to an active profiler capture: it
returns a bare range, which records nothing into the ring buffer and
mints no ids. So an operator's own torch.profiler run (and a
benchmark's profiled window) sees the fit loop's and the input
pipeline's phases with no switch thrown. (The port of the JAX package's
utils/tracing.py, which enters `jax.profiler.TraceAnnotation` there.)

Overhead contract: tracing is OFF by default and every propagation entry
point — `span()`, `instant()`, `attach()`/`detach()`,
`current_context()`, `current_traceparent()`, `record_complete()` —
degrades to one flag check on the disabled path (`span()`: the flag and
the profiler's module flag): no allocation, no lock, no clock read, no
id minting. The fit loop's phase timers and the serving/jsonhttp hot
paths depend on this (the <10µs-per-call guard in tests covers span
creation AND the context hooks).
"""

from __future__ import annotations

import json
import itertools
import os
import threading
import time
from collections import deque
from typing import List, Optional

import torch
import torch.autograd.profiler as _autograd_profiler

from deeplearning4j_tpu_torch.utils import tenancy as _tenancy

# span ids are ints, unique within a process and unlikely to collide
# across processes: the counter starts at a random 60-bit offset so two
# processes exporting into one trace don't both hand out 1, 2, 3...
# (traceparent masks to the W3C 64-bit field; parse restores the int)
_counter = itertools.count(
    (int.from_bytes(os.urandom(5), "big") << 20) + 1)
_tls = threading.local()

_SPAN_ID_MASK = (1 << 64) - 1

# attach() on the disabled path returns this token; detach() recognizes
# it and does nothing — the pair stays one flag check when tracing is off
_DISABLED_TOKEN = object()


def _mint_trace_id() -> str:
    """128-bit random trace id, 32 lowercase hex chars (W3C format)."""
    return os.urandom(16).hex()


class SpanContext:
    """The thread/process-portable identity of a span: which trace it
    belongs to and which span is the parent of anything recorded under
    it. Hand one across a queue (`attach()`) or a process boundary
    (`traceparent()`) and parentage survives the hop."""

    __slots__ = ("trace_id", "span_id")

    def __init__(self, trace_id: str, span_id: int):
        self.trace_id = trace_id
        self.span_id = int(span_id)

    def traceparent(self) -> str:
        """W3C trace-context header value: 00-<trace>-<span>-01."""
        return (f"00-{self.trace_id}"
                f"-{self.span_id & _SPAN_ID_MASK:016x}-01")

    def __repr__(self):  # debugging / assertion messages
        return f"SpanContext({self.trace_id!r}, {self.span_id})"


def format_traceparent(ctx: SpanContext) -> str:
    return ctx.traceparent()


_HEX_DIGITS = frozenset("0123456789abcdefABCDEF")


def _is_hex(s: str) -> bool:
    # NOT int(s, 16): that tolerates '+'/'-' signs and '_' separators, so
    # a malformed header would join the trace and be re-emitted outbound
    # as a W3C-invalid traceparent strict downstream tracers drop
    return not set(s) - _HEX_DIGITS


def parse_traceparent(value: Optional[str]) -> Optional[SpanContext]:
    """Parse a W3C traceparent header into a SpanContext, or None when
    the header is absent or malformed — a bad header must yield a fresh
    root downstream, never a half-empty context."""
    if not value:
        return None
    parts = value.strip().split("-")
    if len(parts) < 4:
        return None
    ver, tid, sid = parts[0], parts[1], parts[2]
    if len(ver) != 2 or len(tid) != 32 or len(sid) != 16:
        return None
    if not (_is_hex(ver) and _is_hex(tid) and _is_hex(sid)):
        return None
    if ver.lower() == "ff":
        return None
    if ver == "00" and len(parts) != 4:
        # version 00 is exactly 4 fields; FUTURE versions may append more
        return None
    span_id = int(sid, 16)
    if span_id == 0 or set(tid) == {"0"}:
        return None
    return SpanContext(tid.lower(), span_id)


class _NullSpan:
    """Shared disabled-path context manager: truthy checks, enter/exit
    no-ops, one instance for the whole process."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    @property
    def context(self):
        return None


NULL_SPAN = _NullSpan()


class _Span:
    __slots__ = ("tracer", "name", "args", "id", "parent", "trace",
                 "t0", "_ann")

    def __init__(self, tracer: "Tracer", name: str, args: Optional[dict]):
        self.tracer = tracer
        self.name = name
        self.args = args
        self.id = next(_counter)
        self.parent = None
        self.trace = None
        self.t0 = 0.0
        self._ann = None

    @property
    def context(self) -> SpanContext:
        """This span's identity — valid during AND after the span (the
        exemplar/latency record after a `with` block still needs it)."""
        return SpanContext(self.trace, self.id)

    def __enter__(self):
        stack = getattr(_tls, "stack", None)
        if stack is None:
            stack = _tls.stack = []
        if stack:
            top = stack[-1]
            self.parent = top.id
            self.trace = top.trace
        else:
            # thread-root span: an attach()ed context (the explicit
            # cross-thread / cross-process handoff) parents it; with
            # nothing attached this span is a trace root and mints the id
            att = getattr(_tls, "attached", None)
            if att is not None:
                self.parent = att.span_id
                self.trace = att.trace_id
            else:
                self.trace = _mint_trace_id()
        stack.append(self)
        if self.tracer.annotate_device:
            ann = _trace_annotation(self.name)
            if ann is not None:
                self._ann = ann
                ann.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        if self._ann is not None:
            self._ann.__exit__(*exc)
        stack = getattr(_tls, "stack", None)
        if stack and stack[-1] is self:
            stack.pop()
        self.tracer._record(self.name, self.t0, t1 - self.t0, self.id,
                            self.parent, self.args, trace=self.trace)
        return False


# a profiler range on the host only (see the module docstring)
_HostRange = torch._C._profiler._RecordFunctionFast


def _trace_annotation(name: str):
    """A profiler range of `name`: a no-op outside a profiler capture, a
    named host range inside one."""
    return _HostRange(name)


class Tracer:
    """Bounded ring buffer of completed spans + the enable switch."""

    def __init__(self, capacity: int = 8192, annotate_device: bool = True):
        self.enabled = False
        self.annotate_device = annotate_device
        self._lock = threading.Lock()
        self._events: deque = deque(maxlen=int(capacity))
        # the epoch on both clocks, read back to back: spans time with
        # perf_counter and export on the Unix clock the profiler uses
        self._epoch = time.perf_counter_ns() * 1e-9
        self._epoch_unix_us = time.time_ns() * 1e-3

    # -- recording -----------------------------------------------------------

    def span(self, name: str, **args):
        """Context manager timing a section. Disabled -> shared no-op.
        With a thread-ambient tenant attached (utils/tenancy — REST
        handlers attach it from X-Tenant), spans carry it as a `tenant`
        attribute; an explicit tenant= arg wins."""
        if not self.enabled:
            return NULL_SPAN
        if "tenant" not in args:
            t = _tenancy.current_tenant()
            if t is not None:
                args["tenant"] = t
        return _Span(self, name, args or None)

    def instant(self, name: str, **args):
        """Zero-duration marker event (compile-cache insertions, helper
        auto-disables, injected faults, ...). Parents to the innermost
        active span — or the attach()ed context on a worker thread — so
        markers land inside the trace that caused them."""
        if not self.enabled:
            return
        stack = getattr(_tls, "stack", None)
        if stack:
            parent, trace = stack[-1].id, stack[-1].trace
        else:
            att = getattr(_tls, "attached", None)
            if att is not None:
                parent, trace = att.span_id, att.trace_id
            else:
                parent, trace = None, _mint_trace_id()
        self._record(name, time.perf_counter(), 0.0, next(_counter),
                     parent, args or None, phase="i", trace=trace)

    def record_complete(self, name: str, t0: float, t1: float,
                        parent: Optional[SpanContext] = None,
                        **args) -> Optional[SpanContext]:
        """Record an already-finished span from explicit timestamps
        (time.perf_counter() domain) under an explicit parent context —
        the retroactive form the serving pipeline uses for per-request
        lifecycle spans measured across thread handoffs (a queued-time
        span is only known when the collector picks the request up).
        Returns the recorded span's context (chain children off it), or
        None when tracing is disabled."""
        if not self.enabled:
            return None
        sid = next(_counter)
        trace = parent.trace_id if parent is not None else _mint_trace_id()
        self._record(name, t0, t1 - t0, sid,
                     parent.span_id if parent is not None else None,
                     args or None, trace=trace)
        return SpanContext(trace, sid)

    def _record(self, name, t0, dur, span_id, parent, args, phase="X",
                trace=None):
        ev = {
            "name": name,
            "ph": phase,
            # Unix microseconds
            "ts": round((t0 - self._epoch) * 1e6 + self._epoch_unix_us, 3),
            "dur": round(dur * 1e6, 3),
            "id": span_id,
            "parent": parent,
            "trace": trace,
            "tid": threading.get_ident(),
        }
        if args:
            ev["args"] = args
        with self._lock:
            self._events.append(ev)

    # -- readout -------------------------------------------------------------

    def recent(self, n: Optional[int] = None) -> List[dict]:
        """The n newest events (all when n is None, none when n <= 0 —
        a negative slice must never invert into 'everything BUT the
        newest n')."""
        with self._lock:
            evs = list(self._events)
        if n is None:
            return evs
        n = int(n)
        return evs[-n:] if n > 0 else []

    def clear(self):
        with self._lock:
            self._events.clear()

    def to_jsonl(self, n: Optional[int] = None) -> str:
        return "\n".join(json.dumps(ev) for ev in self.recent(n)) + "\n"

    def to_chrome_trace(self) -> dict:
        """chrome://tracing / Perfetto "trace event format" document."""
        events = []
        for ev in self.recent():
            ce = {
                "name": ev["name"],
                "ph": ev["ph"],
                "ts": ev["ts"],
                "pid": 1,
                "tid": ev["tid"],
            }
            if ev["ph"] == "X":
                ce["dur"] = ev["dur"]
            else:
                ce["s"] = "t"  # instant scope: thread
            args = dict(ev.get("args") or {})
            args["span_id"] = ev["id"]
            if ev.get("parent") is not None:
                args["parent_span_id"] = ev["parent"]
            if ev.get("trace"):
                args["trace_id"] = ev["trace"]
            ce["args"] = args
            events.append(ce)
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def write_chrome_trace(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.to_chrome_trace(), f)
        return path

    def write_jsonl(self, path: str) -> str:
        with open(path, "w") as f:
            f.write(self.to_jsonl())
        return path


# -- the process-global tracer ------------------------------------------------

_TRACER = Tracer()


def get_tracer() -> Tracer:
    return _TRACER


def enable(flag: bool = True):
    """Turn span recording on/off process-wide."""
    _TRACER.enabled = bool(flag)


def is_enabled() -> bool:
    return _TRACER.enabled


def span(name: str, **args):
    """Module-level shortcut: `with tracing.span("fit/step"): ...`. With
    the tracer off and a torch.profiler capture on, a bare profiler
    range (the profiler sees the section; the ring buffer does not)."""
    if not _TRACER.enabled:
        if _autograd_profiler._is_profiler_enabled:
            return _HostRange(name)
        return NULL_SPAN
    return _TRACER.span(name, **args)


def instant(name: str, **args):
    _TRACER.instant(name, **args)


def record_complete(name: str, t0: float, t1: float,
                    parent: Optional[SpanContext] = None,
                    **args) -> Optional[SpanContext]:
    return _TRACER.record_complete(name, t0, t1, parent, **args)


# -- context propagation ------------------------------------------------------

def current_context() -> Optional[SpanContext]:
    """The active span context on this thread: the innermost open span,
    else the attach()ed handoff context, else None. Disabled -> None
    after one flag check."""
    if not _TRACER.enabled:
        return None
    stack = getattr(_tls, "stack", None)
    if stack:
        top = stack[-1]
        return SpanContext(top.trace, top.id)
    return getattr(_tls, "attached", None)


def current_trace_id() -> Optional[str]:
    """Just the active trace id (log records, flight-recorder events)."""
    if not _TRACER.enabled:
        return None
    stack = getattr(_tls, "stack", None)
    if stack:
        return stack[-1].trace
    att = getattr(_tls, "attached", None)
    return att.trace_id if att is not None else None


def current_traceparent() -> Optional[str]:
    """The active context as a W3C traceparent header value, or None —
    what an outbound HTTP client attaches so the remote server joins
    this trace."""
    ctx = current_context()
    return ctx.traceparent() if ctx is not None else None


def attach(ctx: Optional[SpanContext]):
    """Make `ctx` the ambient parent for root spans (and instants) on
    THIS thread — the explicit handoff that keeps parentage across a
    queue hop (collector -> dispatcher, prefetch workers, push drains)
    instead of silently starting new roots. Returns a token for
    detach(); always pair them (or use `attached_ctx`). attach(None)
    deliberately clears the ambient context (a worker starting an item
    that carried no context must not inherit the previous item's)."""
    if not _TRACER.enabled:
        return _DISABLED_TOKEN
    prev = getattr(_tls, "attached", None)
    _tls.attached = ctx
    return prev


def detach(token):
    """Restore the ambient context saved by the paired attach()."""
    if token is _DISABLED_TOKEN:
        return
    _tls.attached = token


class attached_ctx:
    """`with tracing.attached_ctx(ctx): ...` — scope-bound attach/detach."""

    __slots__ = ("ctx", "_tok")

    def __init__(self, ctx: Optional[SpanContext]):
        self.ctx = ctx

    def __enter__(self):
        self._tok = attach(self.ctx)
        return self.ctx

    def __exit__(self, *exc):
        detach(self._tok)
        return False

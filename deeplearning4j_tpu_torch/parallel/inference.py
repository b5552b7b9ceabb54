"""ParallelInference — multi-request serving on the model's device. The
port of the JAX package's parallel/inference.py.

Reference: deeplearning4j-scaleout/.../parallelism/ParallelInference.java
(:33-126) — a pool of model replicas fed from a queue, with
InferenceMode.SEQUENTIAL (one request per replica call) vs BATCHED (dynamic
batching via BatchedInferenceObservable, inference/observers/).

Design: one set of parameters on the model's device; dynamically-batched
request groups run as one forward. Dynamic batching (the BATCHED mode)
carries over from the reference; the serving mechanisms beyond it:

* **Shape buckets** — every forward runs at one of a small fixed set of
  batch sizes (powers of two up to `max_batch_size` by default): a fused
  group of n examples is padded up to the smallest bucket >= n by
  cyclically wrapping rows (`mesh.pad_wrap`) and the pad rows sliced off
  the result. The model's forward cache (`output()` keys its functions
  by input shape, `output_compile_count`) then holds ~log2(max_batch_size)
  entries no matter how request sizes vary. `warmup()` runs every bucket
  before traffic (building the kernels and filling the cache), and
  `metrics()` exposes per-bucket hit counts plus `output_compile_count`,
  so a new cache entry under traffic is a visible number.

* **Pipelined collect → dispatch** — the BATCHED collector is split into
  two stages joined by a bounded handoff queue: the *collect* thread
  drains the request queue, concatenates and bucket-pads on the host, and
  hands the prepared group off; the *dispatch* thread runs the device
  forward and scatters results to the waiting callers. Host batch
  assembly of group k+1 overlaps device execution of group k.

* **Deadlines + admission control + load shedding** — every request may
  carry a `deadline_ms` budget (or inherits `default_deadline_ms`), and
  expired work is SHED at every stage instead of served late: admission
  (already expired, queue at `queue_capacity`, or predicted to miss —
  estimated wait is queued-examples-in-groups × the rolling p50 batch
  latency), the collector (expired while queued), the dispatcher
  (expired before the device forward), and the ReplicaPool resubmit
  loop (expired mid-failover, or out of retry budget). Under sustained
  overload the queue depth stays bounded and excess load turns into
  fast, explicit rejections (HTTP 429 + Retry-After at the REST layer).
  Accounting is exact and scrape-able: `serving_shed_total{stage,reason}`
  plus per-endpoint admitted/completed/shed/failed counters obeying the
  conservation law `admitted == completed + shed + failed` (rejections
  happen before admission and are counted separately).

* **Request lifecycle tracing** — with tracing on (utils/tracing), every
  request is one trace: a `serve/admission` span on the caller's thread
  whose SpanContext rides the queue item and the handoff tuple, so the
  collector's retroactive `serve/queued` span, the dispatcher's
  `serve/dispatch` → `serve/forward` spans, and every `serve/shed`
  marker (tagged {stage, reason} like serving_shed_total) keep their
  parentage across the pipeline threads. Off by default; every hook is
  one flag check when disabled.

The device forward (`_forward_padded`): the padded host batch becomes a
tensor on `model.device` inside the thread that runs the forward, with
`torch.no_grad()` and that device current there; `model.output()` runs
it, and the readback to a host float32 array (bf16/f16 outputs widened)
is the sync. A mesh whose data axis has more than one rank is refused:
the port's `Mesh` joins processes, one device each, where the JAX
package's mesh shards a group over the devices of one process.
"""

from __future__ import annotations

import logging
import math
import queue
import threading
import time
import weakref
from concurrent.futures import Future
from concurrent.futures import TimeoutError as FutureTimeoutError
from contextlib import nullcontext
from typing import List, Optional, Sequence

import numpy as np
import torch

from deeplearning4j_tpu_torch.parallel.mesh import data_shards, pad_wrap
from deeplearning4j_tpu_torch.utils import blackbox as _blackbox
from deeplearning4j_tpu_torch.utils import devprof as _devprof
from deeplearning4j_tpu_torch.utils import faultpoints as _faults
from deeplearning4j_tpu_torch.utils import health as _health
from deeplearning4j_tpu_torch.utils import metrics as _metrics
from deeplearning4j_tpu_torch.utils import resourcemeter as _resourcemeter
from deeplearning4j_tpu_torch.utils import runledger as _runledger
from deeplearning4j_tpu_torch.utils import tenancy as _tenancy
from deeplearning4j_tpu_torch.utils import tracing as _tracing

# canonical home is utils/resourcemeter (the shared tenant-keyed
# implementation every tier books through); re-exported here, where
# serving callers import it from
from deeplearning4j_tpu_torch.utils.resourcemeter import AdmissionBooks
from deeplearning4j_tpu_torch.utils.concurrency import (
    QueueAborted,
    get_abortable,
    put_abortable,
)
from deeplearning4j_tpu_torch.utils.latency import LatencyTracker

logger = logging.getLogger("deeplearning4j_tpu_torch")

# the tenant a request without one books under
DEFAULT_TENANT = _tenancy.DEFAULT_TENANT

# how long a deadline-carrying caller waits PAST its deadline before
# shedding its own future (stage="wait"): long enough that a live
# collector/dispatcher always sheds first (keeping the stage-precise
# books and the device-work saving), short enough that a wedged pipeline
# cannot hold callers hostage
_WAIT_SHED_GRACE = 0.25

# the wait estimator is fed ONLY by completed forwards, and admission
# consults it before admitting — so a rolling p50 pushed past every
# caller's deadline by one bad window (GIL stall, transient device
# slowness) would starve itself of the very samples that let it
# recover: 100% shed, forever. When the pipeline is idle and no forward
# has landed within max(4 x p50, this floor), the estimate is STALE and
# admission lets one probe through to re-learn reality
_ESTIMATOR_STALE_MIN = 1.0


class InferenceMode:
    SEQUENTIAL = "sequential"
    BATCHED = "batched"


class RequestValidationError(ValueError):
    """The REQUEST was malformed (empty, or feature shape mismatching the
    endpoint's) — distinguishes client faults from server-side ValueErrors
    so REST layers can map 400 vs 500 correctly."""


class DeadlineExceeded(RuntimeError):
    """The request's deadline expired before its result could be
    produced — shed, not served late. `stage` names where it was caught
    (admission / collector / dispatch / resubmit, or `wait`: the
    caller's own bounded wait on a wedged pipeline). REST maps this to
    429: the work was never done, so the client may retry with a fresh
    budget."""

    def __init__(self, message: str, stage: str = "admission",
                 retry_after: float = 0.0):
        super().__init__(message)
        self.stage = stage
        self.retry_after = float(retry_after)


class RequestRejected(RuntimeError):
    """Admission control refused the request: the queue is at capacity,
    or the estimated wait (queue depth × rolling p50 batch latency)
    already exceeds the request's remaining deadline. `retry_after` is
    the server's wait estimate in seconds — the Retry-After hint the
    REST layer returns with the 429."""

    def __init__(self, message: str, reason: str = "queue_full",
                 retry_after: float = 0.0, stage: str = "admission"):
        super().__init__(message)
        self.reason = reason
        self.retry_after = float(retry_after)
        self.stage = stage


class ReplicaUnavailable(RuntimeError):
    """This replica could not take — or had to give back — the request
    BEFORE its device forward ran: admission after shutdown/abort, or a
    queued future failed by an eviction sweep. The request never touched
    the model, so it is safe to resubmit verbatim; ReplicaPool does
    exactly that on a healthy sibling. Contrast the plain RuntimeError an
    abort() puts on IN-FLIGHT futures (the group inside the device
    forward): those may have side effects in flight and are genuinely
    lost — the only failures the eviction contract lets callers see."""


def _queue_depth(ref) -> int:
    pi = ref()
    if pi is None:
        return 0
    return pi._q.qsize() + pi._handoff.qsize()


def _trace_shed_span(stage: str, reason: str,
                     ctx: Optional[_tracing.SpanContext] = None):
    """Record a zero-duration serve/shed span tagged {stage, reason}
    (mirroring serving_shed_total's labels) under the request's context —
    ctx when the shed happens on a pipeline thread, the current context
    when it happens on the caller's. The ONE place the shed-span shape
    lives: ParallelInference stages and ReplicaPool resubmit sheds both
    record through it. One flag check when tracing is off."""
    if not _tracing.is_enabled():
        return
    if ctx is None:
        ctx = _tracing.current_context()
    if ctx is None:
        return
    now = time.perf_counter()
    _tracing.record_complete("serve/shed", now, now, ctx,
                             stage=stage, reason=reason)


def _build_kernels(device: Optional[torch.device]) -> None:
    """Build the port's CUDA kernels (no-op where they are built already,
    or off a Hopper GPU)."""
    if device is None or device.type != "cuda":
        return
    from deeplearning4j_tpu_torch.ops import cuda_build

    if cuda_build.on_hopper(device):
        cuda_build.build_all()


def _device_scope(device: Optional[torch.device]):
    """The forward's device made current on the calling thread (a CUDA
    device's index is per-thread state)."""
    if device is not None and device.type == "cuda":
        return torch.cuda.device(device)
    return nullcontext()


def _to_host(out) -> np.ndarray:
    """A forward's output as a host array: half-precision outputs widen
    to float32, so the JSON path only ever sees f32 or wider numbers."""
    if not torch.is_tensor(out):
        return np.asarray(out)
    out = out.detach()
    if out.dtype in (torch.bfloat16, torch.float16):
        out = out.float()
    return out.cpu().numpy()


def power_of_two_buckets(max_batch_size: int) -> List[int]:
    """Default bucket set: 1, 2, 4, ... up to and including
    `max_batch_size` (appended as-is when not itself a power of two)."""
    out, b = [], 1
    while b < max_batch_size:
        out.append(b)
        b *= 2
    out.append(int(max_batch_size))
    return out


class ParallelInference:
    def __init__(
        self,
        model,
        mesh=None,
        inference_mode: str = InferenceMode.BATCHED,
        max_batch_size: int = 64,
        batch_timeout_ms: float = 2.0,
        buckets: Optional[Sequence[int]] = None,
        handoff_capacity: int = 2,
        health_stall_after: float = 30.0,
        component_prefix: str = "serving",
        queue_capacity: int = 1024,
        default_deadline_ms: Optional[float] = None,
        run_ledger=None,
    ):
        # run-ledger opt-in: a path's ledger is closed by shutdown(), a
        # given one is detached by it and left open for its owner
        self._ledgers = _runledger.attach_scoped(run_ledger)
        self.model = model
        # a one-rank mesh (or none) serves on the model's device; a data
        # axis over several processes would be one group split across
        # processes, which this single-process pipeline cannot run
        if mesh is not None and data_shards(mesh) > 1:
            raise ValueError(
                f"ParallelInference serves on one device; this mesh's data "
                f"axis has {data_shards(mesh)} ranks (sharding a group over "
                f"the GPUs of one process is not ported)")
        self.mesh = mesh
        self.mode = inference_mode
        self.max_batch_size = int(max_batch_size)
        # overload protection: the request queue is BOUNDED (capacity
        # enforced at admission, under the lock — the queue object stays
        # unbounded so the shutdown sentinel can never block) and every
        # request may carry a deadline. 0 disables the bound.
        self.queue_capacity = max(0, int(queue_capacity))
        self.default_deadline_ms = (None if default_deadline_ms is None
                                    else float(default_deadline_ms))
        if self.max_batch_size < 1:
            raise ValueError(
                f"max_batch_size must be >= 1, got {max_batch_size}")
        self.batch_timeout = batch_timeout_ms / 1e3
        if buckets is None:
            self.buckets = power_of_two_buckets(self.max_batch_size)
        else:
            self.buckets = sorted({int(b) for b in buckets})
            if not self.buckets or self.buckets[0] < 1:
                raise ValueError(f"invalid bucket set {buckets}")
            if self.buckets[-1] < self.max_batch_size:
                raise ValueError(
                    f"largest bucket {self.buckets[-1]} < max_batch_size "
                    f"{self.max_batch_size}: a full fused group would have "
                    f"no bucket to land in"
                )
        model._require_init()
        # the model's device; None for a model without one (a host stub)
        dev = getattr(model, "device", None)
        self.device = None if dev is None else torch.device(dev)
        # the kernels build before any heartbeat arms: a first forward
        # that built them inside the dispatcher's busy slot could outlast
        # `health_stall_after` and read as a wedged replica
        _build_kernels(self.device)
        # one lock guards admission (shutdown flag + expected shape) and
        # the stats counters; device work happens outside it
        self._lock = threading.Lock()
        self._q: "queue.Queue" = queue.Queue()
        self._handoff: "queue.Queue" = queue.Queue(maxsize=handoff_capacity)
        self._expected_shape = None  # set by the first request (under lock)
        # flipped by the first SUCCESSFUL forward: until then the pinned
        # shape is provisional and a failed forward unpins it, so one
        # malformed first request cannot poison the endpoint forever
        self._shape_confirmed = False
        self._shutdown = False
        # hard-stop flag (abort(), the ReplicaPool eviction path): the
        # pipeline threads exit at their next queue poll instead of
        # draining; queued + in-flight futures fail explicitly
        self._abort = threading.Event()
        # futures of the group the dispatcher currently holds (set just
        # before the device forward): the only requests abort() cannot
        # re-route — they fail, everything else is retriable upstream
        self._inflight: List[Future] = []
        # _stats is PER-INSTANCE (the JSON /metrics schema: this
        # endpoint's traffic); the registry counters below are
        # process-global aggregates across every ParallelInference in the
        # process — deriving either from the other would conflate the two
        # scopes, so both are maintained
        self._stats = {
            "requests": 0,
            "examples": 0,
            "batches": 0,
            "oversized": 0,
            "bucket_hits": {b: 0 for b in self.buckets},
        }
        # exact request accounting (the conservation law):
        #   admitted == completed + shed + failed
        # `rejected` counts admission-control refusals — those happened
        # BEFORE admission, so they sit outside the law. The shared
        # AdmissionBooks shape (utils/resourcemeter), booked per tenant
        # (requests carry one via output(tenant=) / X-Tenant; the rest
        # land under the default tenant), mutated under self._lock.
        self._books = AdmissionBooks()
        _resourcemeter.register_books(_resourcemeter.TIER_SERVING,
                                      self._books)
        # examples currently waiting in _q (admission's queue-depth
        # estimate in GROUP units: examples / max_batch_size)
        self._queued_examples = 0
        # rolling device-forward latency: the p50 here × groups-ahead is
        # the admission-control wait estimate
        self._batch_lat = LatencyTracker(window=64)
        # monotonic time the last counted forward landed (None until the
        # first): the staleness clock for the estimator-poison probe.
        # Written by the dispatcher without the lock (GIL-atomic float
        # store), read under it at admission
        self._last_forward_mono: Optional[float] = None
        # shared-registry serving instruments (same registry as training's
        # compile_total and helper_* — ONE scrape sees both). Children are
        # resolved here once; the request path only touches the cached
        # handles. The queue-depth gauge reads through a weakref so a
        # shut-down ParallelInference is not kept alive by the registry
        # (the newest instance owns the gauge).
        reg = _metrics.get_registry()
        self._m_requests = reg.counter(
            "serving_requests_total", "inference requests admitted").labels()
        self._m_examples = reg.counter(
            "serving_examples_total", "inference examples admitted").labels()
        self._m_bucket = reg.counter(
            "serving_bucket_hits_total",
            "fused groups served, by landing bucket", ("bucket",))
        self._m_oversized = reg.counter(
            "serving_oversized_total",
            "requests larger than every bucket (ran unfused)").labels()
        self._m_handoff = reg.histogram(
            "serving_handoff_stall_seconds",
            "collector time blocked handing a prepared group to the "
            "dispatcher (device a full group behind = backpressure)"
        ).labels()
        self._m_shed = reg.counter(
            "serving_shed_total",
            "requests shed instead of served late, by pipeline stage "
            "and reason", ("stage", "reason"))
        self._m_admitted = reg.counter(
            "serving_admitted_total",
            "requests past admission control (the conservation law's "
            "left-hand side)").labels()
        self._m_probe = reg.counter(
            "serving_admission_probe_total",
            "predicted-late requests admitted anyway because the wait "
            "estimate was stale (idle pipeline, no recent forward) — "
            "the self-healing path out of a poisoned rolling p50"
        ).labels()
        self._m_completed = reg.counter(
            "serving_completed_total",
            "admitted requests resolved with a result").labels()
        # completed-request latency at THIS layer (admission to result),
        # below any HTTP front-end: the histogram the SLO burn-rate
        # objective ("99% of requests under default_deadline_ms",
        # analysis/slo) judges from its bucket counts — sheds never
        # observe here, so the objective grades what was actually served
        self._m_output_latency = reg.histogram(
            "serving_output_seconds",
            "ParallelInference.output latency of completed requests "
            "(admission to result; sheds/failures excluded)").labels()
        self._m_failed = reg.counter(
            "serving_failed_total",
            "admitted requests resolved with an error "
            "(model/abort/shutdown)").labels()
        ref = weakref.ref(self)
        reg.gauge(
            "serving_queue_depth",
            "requests + prepared groups waiting for the device"
        ).set_function(lambda: _queue_depth(ref))
        self._collect_t: Optional[threading.Thread] = None
        self._dispatch_t: Optional[threading.Thread] = None
        # liveness (utils/health): each pipeline stage holds a busy slot
        # only while it OWNS work — waiting on an empty request queue is
        # idle, but a dispatcher wedged inside a device forward (or a
        # collector blocked handing off to a dead device) goes stale and
        # the watchdog flips `component_health{component=...}`. GET
        # /health on the serving layer aggregates exactly this.
        self._hb_collect: Optional[_health.Heartbeat] = None
        self._hb_dispatch: Optional[_health.Heartbeat] = None
        self.component_prefix = component_prefix
        if self.mode == InferenceMode.BATCHED:
            hreg = _health.get_health()
            self._hb_collect = hreg.register(
                f"{component_prefix}_collector",
                stall_after=health_stall_after)
            self._hb_dispatch = hreg.register(
                f"{component_prefix}_dispatcher",
                stall_after=health_stall_after)
            self._collect_t = threading.Thread(
                target=self._collector, daemon=True,
                name="dl4j-serving-collector")
            self._dispatch_t = threading.Thread(
                target=self._dispatcher, daemon=True,
                name="dl4j-serving-dispatch")
            self._collect_t.start()
            self._dispatch_t.start()

    # -- public --------------------------------------------------------------

    def output(self, x, deadline_ms: Optional[float] = None,
               tenant: Optional[str] = None):
        """Thread-safe inference. In BATCHED mode the call may be fused
        with concurrent callers' batches (reference:
        BatchedInferenceObservable). `deadline_ms` is the request's
        total latency budget from this call (falls back to
        `default_deadline_ms`; None = no deadline): a request that
        cannot make it is shed — DeadlineExceeded / RequestRejected —
        instead of served late. `tenant` names who this request books
        under (admission books + device-second spend); None falls back
        to the thread's ambient tenant (utils/tenancy), then the
        default tenant."""
        # run-ledger hook first (one global read when no ledger is
        # attached), then the end-to-end latency of COMPLETED requests
        # into serving_output_seconds — sheds raise out of _output_impl
        # and never observe, so the SLO objective judges served work
        _runledger.note_request()
        t0 = time.perf_counter()
        out = self._output_impl(x, deadline_ms, tenant)
        self._m_output_latency.observe(time.perf_counter() - t0)
        return out

    def _output_impl(self, x, deadline_ms: Optional[float] = None,
                     tenant: Optional[str] = None):
        xx = np.asarray(x)
        # one canonical label for the whole request lifecycle: explicit
        # arg wins, then the ambient thread tenant (REST handlers attach
        # it from X-Tenant), interned through the bounded registry
        tenant = _tenancy.intern(
            tenant if tenant is not None else _tenancy.current_tenant())
        if deadline_ms is None:
            deadline_ms = self.default_deadline_ms
        elif not math.isfinite(float(deadline_ms)):
            # a NaN budget makes every deadline comparison False: the
            # request would be admitted, then unconditionally shed in
            # the collector — a malformed request, not a shed
            raise RequestValidationError(
                f"deadline_ms must be finite, got {deadline_ms!r}")
        deadline = (None if deadline_ms is None
                    else time.monotonic() + float(deadline_ms) / 1e3)
        # the request's lifecycle root below the caller's span: the
        # admission decision runs inside it, and its context rides the
        # queue item so every downstream stage (queued/dispatch/forward/
        # shed) parents here even when completed on a pipeline thread.
        # Disabled path: NULL_SPAN + None ctx after one flag check each.
        adm_span = _tracing.span("serve/admission", rows=int(xx.shape[0]),
                                 tenant=tenant)
        with adm_span:
            fut, ctx = self._admit(xx, deadline, tenant)
        if fut is not None:
            if deadline is None:
                return fut.result()
            # bounded wait: the collector/dispatcher are the PRIMARY
            # shedders (they see the expiry first while the pipeline is
            # alive, and their skip saves the device work) — but when
            # the pipeline itself wedges nothing downstream will ever
            # touch the future, so after a short grace past the deadline
            # the waiter sheds it here. _fail is race-safe: a concurrent
            # resolve/shed that beat us wins and is what the caller gets
            try:
                return fut.result(
                    timeout=max(0.0, deadline - time.monotonic())
                    + _WAIT_SHED_GRACE)
            except FutureTimeoutError:
                exc = DeadlineExceeded(
                    "deadline expired waiting on a stalled pipeline",
                    stage="wait")
                if self._fail(fut, exc, outcome="shed", stage="wait",
                              reason="expired"):
                    self._trace_shed("wait", "expired", ctx)
                    raise exc from None
                return fut.result()
        # SEQUENTIAL mode, or an oversized request: run it alone instead of
        # overshooting a fused group arbitrarily (device work off-lock).
        # The unfused path honors the deadline like the fused one does:
        # expired before the forward = dispatch-stage shed (saves the
        # device work); finished past deadline + grace = wait-stage shed
        # (the fused waiter's backstop — a late result is never served)
        if deadline is not None and time.monotonic() >= deadline:
            self._count_outcome("shed", stage="dispatch", reason="expired",
                                tenant=tenant)
            self._trace_shed("dispatch", "expired", ctx)
            raise DeadlineExceeded(
                "deadline expired before the unfused forward",
                stage="dispatch")
        t_fwd0 = time.perf_counter()
        try:
            with _tracing.attached_ctx(ctx):
                out = self._run(xx)
        except BaseException:
            self._count_outcome("failed", tenant=tenant)
            raise
        # unfused forwards charge their own device window (the fused
        # path's dispatcher charges per group); no-op when unmetered
        _resourcemeter.note_serving_forward(
            time.perf_counter() - t_fwd0, {tenant: int(xx.shape[0])})
        if deadline is not None \
                and time.monotonic() >= deadline + _WAIT_SHED_GRACE:
            self._count_outcome("shed", stage="wait", reason="expired",
                                tenant=tenant)
            self._trace_shed("wait", "expired", ctx)
            raise DeadlineExceeded(
                "deadline expired during the unfused forward",
                stage="wait")
        self._count_outcome("completed", tenant=tenant)
        return out

    def _admit(self, xx: np.ndarray, deadline: Optional[float],
               tenant: str):
        """Validation + admission control + (for fusable requests) the
        enqueue, all under ONE lock hold. Returns (future, span_context):
        the future is None for requests that must run unfused on the
        caller's thread; the context is the serve/admission span's (the
        caller opens it around this call) — it rides the queue item so
        downstream lifecycle spans keep parentage across the pipeline
        threads, and is None when tracing is off. `tenant` (already
        interned) books the admission; it rides the Future itself
        (`_dl4j_tenant`) so every later outcome — resolve, fail, shed
        from any pipeline thread — lands in the right tenant's books
        without widening the queue/handoff tuples."""
        ctx = _tracing.current_context()
        with self._lock:
            # shutdown check and enqueue under ONE lock: a request admitted
            # here is visible to shutdown()'s drain, so its Future always
            # resolves (result or explicit shutdown error) — never hangs
            if self._shutdown:
                raise ReplicaUnavailable(
                    "ParallelInference has been shut down")
            if xx.shape[0] == 0:
                # 0 is a multiple of every bucket, so an empty request
                # would sail through _pad at 0 rows and add a 0-row
                # forward-cache entry — reject it at admission instead
                raise RequestValidationError("empty request (0 examples)")
            if self._expected_shape is None:
                # under the lock: two concurrent FIRST callers must not both
                # see None and admit mismatched shapes into one fused group
                self._expected_shape = xx.shape[1:]
            elif xx.shape[1:] != self._expected_shape:
                # validate HERE, not deep inside the collector where a bad
                # request would fail the whole fused group
                raise RequestValidationError(
                    f"request feature shape {xx.shape[1:]} does not match "
                    f"this ParallelInference's {self._expected_shape}"
                )
            self._stats["requests"] += 1
            self._stats["examples"] += xx.shape[0]
            self._m_requests.inc()
            self._m_examples.inc(xx.shape[0])
            fusable = (self.mode == InferenceMode.BATCHED
                       and xx.shape[0] <= self.max_batch_size)
            # -- admission control (still under the lock: the queue-depth
            # facts it reads are mutated under it) --------------------------
            now = time.monotonic()
            if deadline is not None and now >= deadline:
                self._shed_locked("admission", "expired", tenant=tenant)
                self._trace_shed("admission", "expired", ctx)
                raise DeadlineExceeded(
                    "deadline expired before admission",
                    stage="admission")
            # one percentile pass (a sort under the admission lock)
            # shared by the wait estimate, the staleness check, and the
            # Retry-After hint — and skipped entirely on the no-deadline
            # below-capacity fast path, where no decision would read it
            need_estimate = fusable and (
                deadline is not None
                or (self.queue_capacity
                    and self._q.qsize() >= self.queue_capacity))
            p50 = (self._batch_lat.percentile_seconds(50)
                   if need_estimate else None)
            est_wait = (self._estimate_wait_locked(p50)
                        if need_estimate else 0.0)
            if fusable and self.queue_capacity \
                    and self._q.qsize() >= self.queue_capacity:
                self._shed_locked("admission", "queue_full", tenant=tenant)
                self._trace_shed("admission", "queue_full", ctx)
                raise RequestRejected(
                    f"request queue at capacity "
                    f"({self.queue_capacity} requests)",
                    reason="queue_full", retry_after=est_wait)
            if fusable and deadline is not None \
                    and now + est_wait > deadline:
                if not self._estimator_stale_locked(now, p50):
                    self._shed_locked("admission", "predicted_late",
                                      tenant=tenant)
                    self._trace_shed("admission", "predicted_late", ctx)
                    raise RequestRejected(
                        f"estimated wait {est_wait * 1e3:.0f}ms exceeds "
                        f"the request's remaining deadline "
                        f"{(deadline - now) * 1e3:.0f}ms",
                        reason="predicted_late", retry_after=est_wait)
                # stale estimate + idle pipeline: admit this request as a
                # probe so the rolling p50 re-learns post-stall reality
                # (it may be served late — bounded by the wait backstop —
                # but without it a poisoned estimator sheds 100% forever).
                # The enqueue below makes the pipeline non-idle, so
                # concurrent callers go back to shedding: one probe per
                # staleness window, not a floodgate
                self._m_probe.inc()
            self._books.admit(tenant)
            self._m_admitted.inc()
            fut: Optional[Future] = None
            if fusable:
                fut = Future()
                fut._dl4j_tenant = tenant
                self._queued_examples += xx.shape[0]
                # put_nowait: the queue OBJECT is unbounded (the capacity
                # bound is the admission check above), so this is exactly
                # `put` — minus the lint-rejected blocking form. The item
                # carries the admission span's context plus the enqueue
                # timestamp: the collector turns them into the
                # serve/queued span when it picks the request up.
                self._q.put_nowait(
                    (xx, fut, deadline, ctx, time.perf_counter()))
        return fut, ctx

    # -- overload accounting --------------------------------------------------

    def _estimate_wait_locked(self, p50: Optional[float]) -> float:
        """Expected queue wait for a newly admitted request: groups
        ahead of it — queued examples at bucket granularity, plus the
        already-assembled groups parked in the handoff, plus the group
        the device holds — × `p50`, the caller-supplied rolling p50
        device-forward latency (computed once per admission: the
        percentile pass sorts the window under the admission lock).
        (The group in the collector's hands stays invisible: the
        estimate is honest to ±1 group.) Zero until the first forward
        lands — cold admission is optimistic."""
        if p50 is None:
            return 0.0
        groups_ahead = (self._queued_examples / float(self.max_batch_size)
                        + self._handoff.qsize())
        return (groups_ahead + 1.0) * p50

    def _estimator_stale_locked(self, now: float,
                                p50: Optional[float]) -> bool:
        """True when the wait estimate can no longer be trusted: the
        pipeline is idle (nothing queued, nothing handed off) yet no
        forward has landed within max(4 x p50, _ESTIMATOR_STALE_MIN).
        That shape is the post-stall poison — one contended window
        pushed the rolling p50 past every deadline, admission went to
        100% shed, and the tracker is starved of the fresh samples that
        would let it recover. (Only reached when a p50 exists: with an
        empty tracker the estimate is 0 and nothing is predicted late.)"""
        if self._queued_examples or self._handoff.qsize():
            return False
        if p50 is None:
            return False
        last = self._last_forward_mono
        return last is None \
            or now - last > max(4.0 * p50, _ESTIMATOR_STALE_MIN)

    def estimated_wait(self) -> float:
        with self._lock:
            return self._estimate_wait_locked(
                self._batch_lat.percentile_seconds(50))

    def _shed_locked(self, stage: str, reason: str,
                     admitted: bool = False,
                     tenant: Optional[str] = None):
        """Book one shed under the (already-held) lock. Post-admission
        sheds land in `shed` (the conservation law's term); admission
        refusals land in `rejected` — the request never entered the
        system. Both feed serving_shed_total{stage,reason}, keyed by
        the request's tenant in the books."""
        self._books.shed(stage, reason, tenant=tenant, admitted=admitted)
        self._m_shed.labels(stage, reason).inc()

    def _count_outcome(self, outcome: str, stage: Optional[str] = None,
                       reason: Optional[str] = None,
                       tenant: Optional[str] = None):
        with self._lock:
            if outcome == "shed":
                self._shed_locked(stage, reason, admitted=True,
                                  tenant=tenant)
                return
            if outcome == "completed":
                self._books.complete(tenant)
            else:
                self._books.fail(tenant)
        (self._m_completed if outcome == "completed"
         else self._m_failed).inc()

    def _resolve(self, fut: Future, value) -> bool:
        """Deliver a result; count `completed` only when OUR set won (an
        abort may have failed the future concurrently — whoever's set
        lands does the counting, so every future is counted once)."""
        try:
            fut.set_result(value)
        except Exception:
            return False
        self._count_outcome("completed",
                            tenant=getattr(fut, "_dl4j_tenant", None))
        return True

    def _fail(self, fut: Future, exc: Exception, outcome: str = "failed",
              stage: Optional[str] = None,
              reason: Optional[str] = None) -> bool:
        try:
            fut.set_exception(exc)
        except Exception:
            return False
        self._count_outcome(outcome, stage, reason,
                            tenant=getattr(fut, "_dl4j_tenant", None))
        return True

    def _dequeued(self, item):
        with self._lock:
            self._queued_examples -= item[0].shape[0]

    def _trace_shed(self, stage: str, reason: str,
                    ctx: Optional[_tracing.SpanContext] = None):
        _trace_shed_span(stage, reason, ctx)

    def _shed_if_expired(self, item, stage: str) -> bool:
        """Shed a queued request whose deadline passed while it waited —
        serving it would burn device time on a result nobody reads."""
        fut, deadline = item[1], item[2]
        if deadline is None or time.monotonic() < deadline:
            return False
        if self._fail(
                fut,
                DeadlineExceeded(f"deadline expired in {stage}",
                                 stage=stage),
                outcome="shed", stage=stage, reason="expired"):
            # span only when OUR fail won (and counted): a waiter that
            # already shed this future recorded ITS span — the trace must
            # mirror serving_shed_total, one shed, one stage
            self._trace_shed(stage, "expired", item[3])
        return True

    def warmup(self, feature_shape: Optional[Sequence[int]] = None,
               dtype=np.float32):
        """Run the forward at every bucket before traffic, so the first
        requests never pay a kernel build or a forward-cache insertion.
        Fixes the expected feature shape (or uses the one already fixed
        by a request)."""
        with self._lock:
            if feature_shape is not None:
                fs = tuple(feature_shape)
                if self._expected_shape is None:
                    self._expected_shape = fs
                elif fs != self._expected_shape:
                    raise ValueError(
                        f"warmup shape {fs} does not match this "
                        f"ParallelInference's {self._expected_shape}"
                    )
            fs = self._expected_shape
        if fs is None:
            raise ValueError(
                "warmup() needs a feature shape: pass feature_shape= or "
                "serve one request first"
            )
        for b in self.buckets:
            self._run(np.zeros((b,) + fs, dtype), count=False)
        return self

    def metrics(self) -> dict:
        """Point-in-time serving counters. `forward_compiles` is the
        model's forward-cache insertion count — in steady state it equals
        the number of distinct post-padding shapes (≤ len(buckets));
        growth under traffic means something is defeating the buckets."""
        with self._lock:
            m = {
                "mode": self.mode,
                "requests": self._stats["requests"],
                "examples": self._stats["examples"],
                "batches": self._stats["batches"],
                "oversized": self._stats["oversized"],
                "bucket_hits": dict(self._stats["bucket_hits"]),
                **self._books.totals(),
                "tenants": self._books.per_tenant(),
                "conservation_ok": self._books.conservation_ok(),
            }
        m["buckets"] = list(self.buckets)
        m["max_batch_size"] = self.max_batch_size
        m["batch_timeout_ms"] = self.batch_timeout * 1e3
        m["queue_depth"] = self._q.qsize() + self._handoff.qsize()
        m["queue_capacity"] = self.queue_capacity
        m["default_deadline_ms"] = self.default_deadline_ms
        m["estimated_wait_ms"] = round(self.estimated_wait() * 1e3, 3)
        m["forward_compiles"] = int(
            getattr(self.model, "output_compile_count", 0))
        return m

    def shutdown(self):
        with self._lock:
            if self._shutdown:
                return
            self._shutdown = True
        workers_exited = True
        if self._collect_t is not None:
            # the admission lock above guarantees the sentinel is the LAST
            # item: everything already queued drains normally (served),
            # then the pipeline exits stage by stage (unbounded queue:
            # put_nowait is exact)
            self._q.put_nowait(None)
            self._collect_t.join(timeout=10)
            self._dispatch_t.join(timeout=10)
            workers_exited = (not self._collect_t.is_alive()
                              and not self._dispatch_t.is_alive())
        for hb in (self._hb_collect, self._hb_dispatch):
            if hb is not None:
                _health.get_health().unregister(hb)
        # the serving ledger scope ends AFTER the drain/joins: the
        # owned ledger's final sample must see the end-of-run books
        # (in-flight futures resolved), not a mid-drain truncation
        _runledger.end_scope(*self._ledgers)
        if not workers_exited:
            # a slow in-flight forward (e.g. a kernel build) outlived the
            # join timeout: the pipeline is still draining and will resolve
            # every Future itself — sweeping now would steal its sentinel
            # and fail work it was about to serve
            return
        # post-drain sweep: if a worker died abnormally, fail any stranded
        # Future explicitly instead of hanging its caller forever
        self._sweep_futures(RuntimeError("ParallelInference shut down"))

    def abort(self, reason: str = "aborted"):
        """Hard stop — the ReplicaPool eviction path. Unlike shutdown()
        (which drains: everything queued is still served), abort() stops
        the pipeline at its next poll and FAILS queued and in-flight
        futures with a RuntimeError naming `reason`. Callers routing
        through a ReplicaPool never see those failures — the pool
        retries admission-level RuntimeErrors on a healthy replica;
        only requests already inside the device forward are lost, which
        is exactly the eviction contract (fail only in-flight)."""
        with self._lock:
            already = self._shutdown and self._abort.is_set()
            self._shutdown = True
        if already:
            return
        self._abort.set()
        for t in (self._collect_t, self._dispatch_t):
            if t is not None:
                # a healthy thread exits within one queue poll; a WEDGED
                # one (the reason for the eviction) is left behind as a
                # daemon — its heartbeat is unregistered below, so it
                # cannot re-trip the watchdog
                t.join(timeout=2.0)
        # in-flight futures (inside the device forward) are genuinely
        # lost — non-retryable; everything still QUEUED never ran and
        # fails retryable, so a pool re-routes it with zero caller-visible
        # errors
        err = RuntimeError(f"ParallelInference {reason} (in flight)")
        for fut in list(self._inflight):
            self._fail(fut, err)  # no-op if it lost to a completing forward
        self._sweep_futures(ReplicaUnavailable(f"ParallelInference {reason}"))
        for hb in (self._hb_collect, self._hb_dispatch):
            if hb is not None:
                _health.get_health().unregister(hb)

    def _sweep_futures(self, err: Exception):
        for q in (self._q, self._handoff):
            while True:
                try:
                    item = q.get_nowait()
                except queue.Empty:
                    break
                if item is None:
                    continue
                if q is self._q:
                    self._dequeued(item)
                    futs = [item[1]]
                else:
                    futs = item[3]
                for fut in futs:
                    self._fail(fut, err)

    # -- internals -----------------------------------------------------------

    def _bucket_for(self, n: int) -> Optional[int]:
        for b in self.buckets:
            if n <= b:
                return b
        return None

    def _pad(self, batch: np.ndarray):
        """Bucket-pad. Returns (padded, n, bucket). The post-padding shape
        is the forward cache's key, so the distinct entry count is
        len(buckets) at most, not the number of distinct request/group
        sizes. An oversized request (no bucket) runs at its own size."""
        n = batch.shape[0]
        b = self._bucket_for(n)
        if b is not None:
            batch = pad_wrap(batch, b)
        return batch, n, b

    def _count_batch(self, b: Optional[int]):
        with self._lock:
            self._stats["batches"] += 1
            if b is None:
                self._stats["oversized"] += 1
            else:
                self._stats["bucket_hits"][b] += 1
        if b is None:
            self._m_oversized.inc()
        else:
            self._m_bucket.labels(str(b)).inc()

    def _forward_padded(self, padded: np.ndarray, n: int,
                        b: Optional[int], count: bool = True):
        """The ONE device forward both paths (caller-thread `_run` and the
        BATCHED dispatcher) go through: the host batch onto the model's
        device, `model.output()` under `torch.no_grad()` with that device
        current on THIS thread (both are per-thread state), the readback
        to host float32 (the sync), pad rows sliced off on the host. A
        multi-output ComputationGraph returns a list; the batch slice
        applies per output, not to the list. A failed forward fails the
        group; it never reruns anywhere else."""
        t0 = time.perf_counter()
        try:
            # chaos hook: an `error` fault here is a device-forward
            # failure (the whole fused group fails; a ReplicaPool retries
            # nothing — in-flight is the one non-retryable stage); a
            # `hang` is the wedged-dispatcher scenario the watchdog and
            # eviction path exist for
            _faults.fault_point("replica_forward", bucket=b, rows=n)
            with _tracing.span("serve/forward", bucket=b, rows=n), \
                    torch.no_grad(), _device_scope(self.device):
                # float64 arrives as float32, as jnp.asarray gives it to the
                # JAX package: one forward-cache entry per bucket, whatever
                # the caller's float width
                if padded.dtype == np.float64:
                    padded = padded.astype(np.float32)
                xt = torch.from_numpy(np.ascontiguousarray(padded))
                if self.device is not None:
                    xt = xt.to(self.device)
                out = self.model.output(xt)
                if isinstance(out, (list, tuple)):
                    out = [_to_host(o)[:n] for o in out]
                else:
                    out = _to_host(out)[:n]
        except BaseException as e:
            if _devprof.is_oom(e):
                # a serving-forward allocator failure gets the same
                # forensics as a fit-loop one: the largest live tensors and
                # the static estimate into a flight-recorder dump, then the
                # group fails as usual (ReplicaPool does not retry in-flight)
                _devprof.oom_forensics("serving_forward", e, net=self.model)
            with self._lock:
                if (not self._shape_confirmed
                        and self._expected_shape == padded.shape[1:]):
                    # the shape that pinned _expected_shape never ran
                    # successfully (e.g. a feature width the model
                    # rejects): unpin, so later well-formed requests can
                    # re-pin instead of being rejected forever. The
                    # equality guard keeps a stale failing group from
                    # clobbering a NEWER pin by a different shape
                    self._expected_shape = None
            raise
        with self._lock:
            self._shape_confirmed = True
        if count:  # after the forward: a failed batch is not a served one
            # rolling batch latency (successful SERVED batches only): the
            # admission-control wait estimate reads its p50. Warmup runs
            # (count=False) are excluded — they pay kernel builds and
            # cache insertions, and a window seeded with such samples
            # would predicted-late every deadline-carrying request before
            # real traffic ever lands a steady-state sample
            self._batch_lat.record(time.perf_counter() - t0)
            self._last_forward_mono = time.monotonic()
            self._count_batch(b)
        return out

    @staticmethod
    def _rows(out, start: int, stop: int):
        if isinstance(out, list):
            return [o[start:stop] for o in out]
        return out[start:stop]

    def _run(self, xx: np.ndarray, count: bool = True):
        padded, n, b = self._pad(xx)
        return self._forward_padded(padded, n, b, count)

    def _put_handoff(self, item, futs=()) -> bool:
        """Backpressured put toward the dispatcher. Blocks while the
        device is a full group behind (that IS the backpressure), but
        aborts — failing the group's futures instead of wedging the
        collector forever — if the dispatcher thread died or the
        pipeline was abort()ed."""
        try:
            put_abortable(
                self._handoff, item,
                abort=lambda: (self._abort.is_set()
                               or (self._dispatch_t is not None
                                   and not self._dispatch_t.is_alive())))
            return True
        except QueueAborted:
            err = ReplicaUnavailable(
                "ParallelInference dispatcher unavailable "
                "(died or aborted)")
            for fut in futs:
                # never dispatched — retryable on another replica
                self._fail(fut, err)
            return False

    # BATCHED pipeline, stage 1: drain + concatenate + pad on the host
    def _collector(self):
        pending = None  # request that would overflow the current group
        hb = self._hb_collect
        while True:
            if pending is not None:
                item, pending = pending, None
            else:
                # poll-loop get (abort predicate: only the hard-stop
                # flag — the graceful-shutdown sentinel must drain the
                # queue in order, so the collector never exits ahead of
                # it). No busy slot while waiting here: an EMPTY request
                # queue is idle, not a stall.
                try:
                    item = get_abortable(self._q, abort=self._abort)
                except QueueAborted:
                    return  # abort(): sweep fails whatever is queued
                if item is not None:
                    self._dequeued(item)
            if item is None:
                self._put_handoff(None)
                return
            # shed, don't serve, a request that expired while queued
            if self._shed_if_expired(item, "collector"):
                continue
            # work in hand: from here until the handoff completes this
            # thread owes progress (a block inside _emit's handoff put
            # means the device is wedged — exactly what should degrade)
            with hb.busy():
                self._trace_queued(item)
                group = [item]
                count = item[0].shape[0]
                # drain more requests until batch limit or short timeout
                while count < self.max_batch_size:
                    try:
                        nxt = self._q.get(timeout=self.batch_timeout)
                    except queue.Empty:
                        break
                    if nxt is None:
                        self._emit(group)
                        self._put_handoff(None)
                        return
                    self._dequeued(nxt)
                    if self._shed_if_expired(nxt, "collector"):
                        continue
                    if (count + nxt[0].shape[0] > self.max_batch_size
                            or nxt[0].shape[1:] != item[0].shape[1:]):
                        # would overflow max_batch_size (and possibly fall
                        # off the bucket set) — or, during an unpin/re-pin
                        # window before the first successful forward, has
                        # a different feature shape (admission normally
                        # guarantees uniformity; this makes mixed-shape
                        # fusion structurally impossible) — start the
                        # next group
                        pending = nxt
                        break
                    self._trace_queued(nxt)
                    group.append(nxt)
                    count += nxt[0].shape[0]
                self._emit(group)

    def _trace_queued(self, item):
        """Retroactive serve/queued span for a request entering a fused
        group: enqueue time to now, parented to its admission span via
        the context carried on the queue item — the explicit-context
        handoff that keeps parentage across the collector thread."""
        if item[3] is not None and _tracing.is_enabled():
            _tracing.record_complete("serve/queued", item[4],
                                     time.perf_counter(), item[3])

    def _emit(self, group):
        """Host-side batch assembly; blocks on the bounded handoff queue
        when the device is a full group behind (backpressure)."""
        try:
            batch = (np.concatenate([g[0] for g in group], axis=0)
                     if len(group) > 1 else group[0][0])
            padded, n, b = self._pad(batch)
        except BaseException as e:  # propagate to all waiting callers
            for g in group:
                self._fail(g[1], e)
            return
        t0 = time.perf_counter()
        futs = [g[1] for g in group]
        # span contexts ride the handoff next to the futures: the second
        # explicit-context hop, so dispatch/forward spans completed on
        # the dispatcher thread still parent to each request's admission
        self._put_handoff(
            (padded, n, b, futs, [g[0].shape[0] for g in group],
             [g[2] for g in group], [g[3] for g in group]), futs)
        self._m_handoff.observe(time.perf_counter() - t0)

    # BATCHED pipeline, stage 2: device forward + scatter results
    def _dispatcher(self):
        while True:
            try:
                # exits on the collector's sentinel; the abort predicate
                # covers the hard stop and a collector that died WITHOUT
                # delivering one, so the dispatcher cannot outlive its
                # feeder
                work = get_abortable(
                    self._handoff,
                    abort=lambda: (self._abort.is_set()
                                   or (self._collect_t is not None
                                       and not self._collect_t.is_alive()
                                       and self._handoff.empty())))
            except QueueAborted:
                return
            if work is None:
                return
            padded, n, b, futs, sizes, deadlines, ctxs = work
            # shed expired members BEFORE burning device time on them;
            # when the WHOLE group expired while the device was behind,
            # skip the forward entirely (that skip is what keeps an
            # overloaded device from serving a backlog nobody is
            # waiting for). The padded batch still carries the shed
            # rows when only some expired — harmless: their results are
            # simply not delivered.
            now = time.monotonic()
            live = [fut for fut, d in zip(futs, deadlines)
                    if d is None or now < d]
            for fut, d, c in zip(futs, deadlines, ctxs):
                if d is not None and now >= d:
                    if self._fail(
                            fut,
                            DeadlineExceeded("deadline expired before the "
                                             "device forward",
                                             stage="dispatch"),
                            outcome="shed", stage="dispatch",
                            reason="expired"):
                        # span mirrors the counter: only when our fail
                        # won the race against the waiter's own shed
                        self._trace_shed("dispatch", "expired", c)
            if not live:
                continue
            live_ctxs = [c for c, d in zip(ctxs, deadlines)
                         if (d is None or now < d) and c is not None]
            # per-tenant device-second attribution for this fused group:
            # the forward's wall time splits over the LIVE rows by
            # tenant (shed members burned nothing). Built only when the
            # meter is armed — the unmetered dispatcher pays one read.
            shares = None
            if _resourcemeter.is_enabled():
                shares = {}
                for fut, k, d in zip(futs, sizes, deadlines):
                    if d is None or now < d:
                        t = (getattr(fut, "_dl4j_tenant", None)
                             or _tenancy.DEFAULT_TENANT)
                        shares[t] = shares.get(t, 0) + k
            # busy only while a group is in hand: a forward that never
            # returns (device wedge) leaves this slot stale and the
            # watchdog flips serving_dispatcher to degraded/unhealthy
            with self._hb_dispatch.busy():
                self._inflight = live
                # the dispatch span runs ATTACHED to the first live
                # request's admission context — the fused group's real
                # spans (dispatch + nested serve/forward) join that
                # request's trace; the other members get retroactive
                # copies below so every trace in the group is complete
                t_disp = time.perf_counter()
                try:
                    with _tracing.attached_ctx(
                            live_ctxs[0] if live_ctxs else None):
                        with _tracing.span("serve/dispatch",
                                           bucket=b, rows=n):
                            t_fwd0 = time.perf_counter()
                            out = self._forward_padded(padded, n, b)
                            t_fwd1 = time.perf_counter()
                    if shares:
                        _resourcemeter.note_serving_forward(
                            t_fwd1 - t_fwd0, shares)
                    off = 0
                    for fut, k in zip(futs, sizes):
                        # abort() may fail the future concurrently;
                        # _resolve counts only when our set wins
                        if not fut.done():
                            self._resolve(fut, self._rows(out, off, off + k))
                        off += k
                    self._trace_group_copies(live_ctxs[1:], t_disp,
                                             t_fwd0, t_fwd1, b, n)
                except BaseException as e:  # propagate to waiting callers
                    for fut in futs:
                        self._fail(fut, e)
                finally:
                    self._inflight = []

    def _trace_group_copies(self, ctxs, t_disp, t_fwd0, t_fwd1, b, n):
        """Retroactive dispatch+forward spans for the fused group's
        NON-primary members: the device forward ran once, but each
        member's trace must still show when its work was dispatched and
        executed — otherwise every trace but the first ends at its
        queued span."""
        if not ctxs or not _tracing.is_enabled():
            return
        t1 = time.perf_counter()
        for ctx in ctxs:
            dctx = _tracing.record_complete(
                "serve/dispatch", t_disp, t1, ctx, bucket=b, rows=n,
                fused_copy=True)
            if dctx is not None:
                _tracing.record_complete(
                    "serve/forward", t_fwd0, t_fwd1, dctx, bucket=b,
                    rows=n, fused_copy=True)


class ReplicaPool:
    """Self-healing pool of N ParallelInference replicas — the recovery
    half of the health model in utils/health (reference:
    ParallelInference.java's worker pool, grown an immune system).

    Each replica registers its collector/dispatcher heartbeats under
    `<prefix>_r<i>_*`, so the watchdog sees every replica separately. The
    pool subscribes to health transitions: when any component of replica
    i flips UNHEALTHY (a dispatcher wedged inside a device forward, a
    collector blocked against a dead handoff — the stall model), a
    supervisor thread EVICTS the replica (abort(): queued work fails
    retryable and is re-routed here; only the group already inside the
    device forward is lost) and RESPAWNS a fresh one under the same
    component names. Requests route round-robin over in-rotation
    replicas; a request that lands on a replica mid-eviction comes back
    as ReplicaUnavailable and is resubmitted on a healthy sibling, so
    callers never see an error for work that never ran.

    Observable by construction: `serving_replica_evictions_total` /
    `serving_replica_respawns_total{replica}` counters and the
    `serving_replicas_in_rotation` gauge live in the shared registry
    (one /metrics scrape shows the self-healing happening), each
    eviction/respawn lands in the flight recorder, and the
    `component_health{component=<prefix>_r<i>_*}` transition history
    shows the unhealthy→ok cycle.

    `model_factory` (optional) builds a fresh model per spawn — without
    it every replica shares `model` (one set of parameters on the device:
    what multiplies is the serving pipeline, not the weights)."""

    def __init__(
        self,
        model=None,
        n_replicas: int = 2,
        mesh=None,
        inference_mode: str = InferenceMode.BATCHED,
        max_batch_size: int = 64,
        batch_timeout_ms: float = 2.0,
        buckets: Optional[Sequence[int]] = None,
        handoff_capacity: int = 2,
        health_stall_after: float = 30.0,
        component_prefix: str = "serving",
        model_factory=None,
        auto_heal: bool = True,
        retry_window: float = 5.0,
        retry_budget: int = 4,
        queue_capacity: int = 1024,
        default_deadline_ms: Optional[float] = None,
    ):
        if model is None and model_factory is None:
            raise ValueError("ReplicaPool needs a model or a model_factory")
        if int(n_replicas) < 1:
            raise ValueError(f"n_replicas must be >= 1, got {n_replicas}")
        self.n_replicas = int(n_replicas)
        self.component_prefix = component_prefix
        self.auto_heal = bool(auto_heal)
        self.retry_window = float(retry_window)
        # resubmits-per-request cap: an eviction storm must not turn one
        # request into unbounded retry load (failover amplification)
        self.retry_budget = max(0, int(retry_budget))
        self._factory = (model_factory if model_factory is not None
                         else (lambda: model))
        self._pi_kwargs = dict(
            mesh=mesh, inference_mode=inference_mode,
            max_batch_size=int(max_batch_size),
            batch_timeout_ms=float(batch_timeout_ms), buckets=buckets,
            handoff_capacity=handoff_capacity,
            health_stall_after=health_stall_after,
            queue_capacity=queue_capacity,
            default_deadline_ms=default_deadline_ms)
        self._lock = threading.Lock()
        self._rr = 0
        self._gen = [0] * self.n_replicas
        self._warmup_shape = None
        self._shutdown = False
        # THIS pool's lifecycle counts (the registry counters below are
        # process-global across every pool the process ever built)
        self._evictions = 0
        self._respawns = 0
        reg = _metrics.get_registry()
        self._m_evict = reg.counter(
            "serving_replica_evictions_total",
            "replicas evicted from the pool (unhealthy or explicit)",
            ("replica",))
        self._m_respawn = reg.counter(
            "serving_replica_respawns_total",
            "replicas respawned into the pool after an eviction",
            ("replica",))
        self._m_rerouted = reg.counter(
            "serving_replica_rerouted_total",
            "requests retried on a sibling after a retryable replica "
            "failure (never user-visible)").labels()
        self._m_shed = reg.counter(
            "serving_shed_total",
            "requests shed instead of served late, by pipeline stage "
            "and reason", ("stage", "reason"))
        self._gauge = reg.gauge(
            "serving_replicas_in_rotation",
            "replicas currently taking traffic").labels()
        # pool-level sheds (resubmit stage) so metrics()["shed_by"]
        # mirrors serving_shed_total — the replicas never see these
        self._pool_shed_by: dict = {}
        # evicted replicas' final books, folded in at eviction time so
        # the JSON aggregate keeps agreeing with the registry counters
        # (which survive respawn via get_or_create) after an eviction
        self._retired: dict = {
            k: 0 for k in ("requests", "examples", "batches", "oversized",
                           "admitted", "completed", "shed", "failed",
                           "rejected")}
        self._retired["shed_by"] = {}
        self._retired["bucket_hits"] = {}
        # slots hold None while a replica is mid-respawn (out of rotation)
        self._replicas: List[Optional[ParallelInference]] = [None] * \
            self.n_replicas
        for i in range(self.n_replicas):
            self._replicas[i] = self._spawn(i)
        self._gauge.set(self.n_replicas)
        # eviction requests flow through a queue to the supervisor: the
        # health listener fires on the dl4j-watchdog thread, which must
        # never block on an abort()'s thread joins
        self._evict_q: "queue.Queue" = queue.Queue()
        self._stop = threading.Event()
        self._supervisor = threading.Thread(
            target=self._supervise, daemon=True,
            name=f"dl4j-replica-supervisor-{component_prefix}")
        self._supervisor.start()
        _health.get_health().add_listener(self._on_health_transition)

    # -- spawning / routing ---------------------------------------------------

    def _prefix(self, idx: int) -> str:
        return f"{self.component_prefix}_r{idx}"

    def _spawn(self, idx: int) -> ParallelInference:
        pi = ParallelInference(self._factory(),
                               component_prefix=self._prefix(idx),
                               **self._pi_kwargs)
        if self._warmup_shape is not None:
            try:
                pi.warmup(self._warmup_shape)
            except Exception:
                logger.exception("replica %d warmup failed (serving "
                                 "anyway; first requests pay the warm-up)",
                                 idx)
        return pi

    def _pick(self) -> Optional[ParallelInference]:
        with self._lock:
            if self._shutdown:
                raise RuntimeError("ReplicaPool has been shut down")
            for _ in range(self.n_replicas):
                idx = self._rr % self.n_replicas
                self._rr += 1
                pi = self._replicas[idx]
                if pi is not None:
                    return pi
        return None

    def _pool_shed(self, reason: str):
        """Book a resubmit-stage shed on the pool's own ledger AND the
        shared serving_shed_total family, so the JSON metrics() books
        agree with the Prometheus scrape and the 429 the caller gets."""
        with self._lock:
            key = f"resubmit/{reason}"
            self._pool_shed_by[key] = self._pool_shed_by.get(key, 0) + 1
        self._m_shed.labels("resubmit", reason).inc()
        _trace_shed_span("resubmit", reason)  # caller-thread shed

    def output(self, x, deadline_ms: Optional[float] = None,
               tenant: Optional[str] = None):
        """Thread-safe inference with failover: retryable replica
        failures (eviction races, mid-respawn gaps) are resubmitted on a
        healthy sibling — but each request spends a bounded
        `retry_budget` of resubmits and never retries past its own
        deadline, so a failover storm cannot multiply offered load.
        Non-retryable failures — a group already inside a device forward
        at eviction time, a genuine model error, or an admission shed
        (DeadlineExceeded / RequestRejected: retrying a load-shed
        request IS the amplification admission control exists to stop)
        — reach the caller directly."""
        req_deadline = (None if deadline_ms is None
                        else time.monotonic() + float(deadline_ms) / 1e3)
        retry_by = time.monotonic() + self.retry_window
        if req_deadline is not None:
            retry_by = min(retry_by, req_deadline)
        resubmits = 0
        last: Optional[Exception] = None
        while True:
            pi = self._pick()
            if pi is None:
                last = last or RuntimeError("no replica in rotation")
            else:
                try:
                    remaining_ms = (
                        None if req_deadline is None
                        else max(0.0, (req_deadline - time.monotonic()))
                        * 1e3)
                    return pi.output(x, deadline_ms=remaining_ms,
                                     tenant=tenant)
                except RequestValidationError:
                    raise  # the client's fault on ANY replica
                except (DeadlineExceeded, RequestRejected):
                    raise  # shed is shed — resubmitting amplifies load
                except ReplicaUnavailable as e:
                    last = e
                    resubmits += 1
                    if resubmits > self.retry_budget:
                        # booked as a shed, surfaced as one too: the
                        # REST layer must answer 429 (retry later, the
                        # work was never done), not a 500 that reads as
                        # a genuine server failure
                        self._pool_shed("retry_budget")
                        raise RequestRejected(
                            f"retry budget spent ({self.retry_budget} "
                            f"resubmits)", reason="retry_budget",
                            stage="resubmit") from last
                    self._m_rerouted.inc()
                    # the retry runs on the caller's thread, so the next
                    # replica's admission span joins this trace by stack;
                    # the marker makes the failover hop itself visible
                    _tracing.instant("serve/resubmit", resubmit=resubmits)
            now = time.monotonic()
            if req_deadline is not None and now >= req_deadline:
                self._pool_shed("expired")
                raise DeadlineExceeded(
                    "deadline expired during replica failover",
                    stage="resubmit") from last
            if now >= retry_by:
                raise RuntimeError(
                    f"no healthy replica within {self.retry_window:.1f}s"
                ) from last
            # a respawn is at most an abort-join + constructor away;
            # breathe instead of spinning the admission lock
            time.sleep(0.005)

    def warmup(self, feature_shape: Optional[Sequence[int]] = None,
               dtype=np.float32):
        """Warm every bucket on every replica; the shape is kept so
        respawned replicas warm themselves before re-entering rotation."""
        with self._lock:
            replicas = [pi for pi in self._replicas if pi is not None]
        for pi in replicas:
            pi.warmup(feature_shape, dtype)
        if feature_shape is not None:
            self._warmup_shape = tuple(feature_shape)
        elif replicas and replicas[0]._expected_shape is not None:
            self._warmup_shape = replicas[0]._expected_shape
        return self

    # -- self-healing ---------------------------------------------------------

    def _on_health_transition(self, tr: dict):
        if tr.get("to") != _health.UNHEALTHY or self._shutdown:
            return
        comp = tr.get("component", "")
        for idx in range(self.n_replicas):
            if comp.startswith(self._prefix(idx) + "_"):
                self.request_eviction(
                    idx, reason=f"{comp} unhealthy "
                    f"({tr.get('stalled_for_seconds')}s stall)")
                return

    def request_eviction(self, idx: int, reason: str):
        """Queue an eviction for the supervisor thread (safe from any
        thread, including the watchdog's transition callback). The
        replica's CURRENT generation rides along: two components of one
        wedged replica both flipping UNHEALTHY queue two requests, and
        the stale second one must not evict the healthy respawn the
        first one produced."""
        idx = int(idx)
        with self._lock:
            gen = self._gen[idx]
        self._evict_q.put_nowait((idx, gen, reason))

    def _supervise(self):
        while True:
            try:
                idx, gen, reason = get_abortable(self._evict_q, self._stop)
            except QueueAborted:
                return
            try:
                self.evict(idx, reason, if_generation=gen)
            except Exception:
                logger.exception("replica %d eviction failed", idx)

    def evict(self, idx: int, reason: str = "evicted",
              if_generation: Optional[int] = None):
        """Take replica `idx` out of rotation, abort it (queued work
        fails retryable and re-routes; only in-flight work is lost), and
        — under auto_heal — respawn a fresh replica into the slot.
        `if_generation` makes the eviction conditional: a no-op when the
        slot has already been respawned past that generation."""
        with self._lock:
            pi = self._replicas[idx]
            if pi is None or self._shutdown:
                return  # already mid-respawn, or shutting down
            if if_generation is not None and self._gen[idx] != if_generation:
                logger.info(
                    "replica %d eviction request for gen %d is stale "
                    "(slot is at gen %d) — skipping", idx, if_generation,
                    self._gen[idx])
                return
            self._replicas[idx] = None
            self._gen[idx] += 1
            gen = self._gen[idx]
        self._gauge.set(self._in_rotation())
        with self._lock:
            self._evictions += 1
        self._m_evict.labels(str(idx)).inc()
        _blackbox.get_recorder().record_event(
            "replica_evicted", replica=idx, generation=gen, reason=reason)
        logger.warning("replica %d evicted (gen %d): %s", idx, gen, reason)
        pi.abort(f"replica {idx} evicted: {reason}")
        # abort() settled the replica's books (queued futures failed);
        # fold its final counters into the retired ledger so its sheds
        # and outcomes don't vanish from metrics() with the slot
        try:
            final = pi.metrics()
        except Exception:
            logger.exception("replica %d final metrics unreadable — its "
                             "books drop from the JSON aggregate", idx)
            final = None
        if final is not None:
            with self._lock:
                r = self._retired
                for k in ("requests", "examples", "batches", "oversized",
                          "admitted", "completed", "shed", "failed",
                          "rejected"):
                    r[k] += final[k]
                for sb, v in final["shed_by"].items():
                    r["shed_by"][sb] = r["shed_by"].get(sb, 0) + v
                for b, v in final["bucket_hits"].items():
                    r["bucket_hits"][b] = r["bucket_hits"].get(b, 0) + v
        if not self.auto_heal or self._shutdown:
            return
        fresh = self._spawn(idx)
        with self._lock:
            if self._shutdown:
                fresh.abort("pool shut down during respawn")
                return
            self._replicas[idx] = fresh
        self._gauge.set(self._in_rotation())
        with self._lock:
            self._respawns += 1
        self._m_respawn.labels(str(idx)).inc()
        _blackbox.get_recorder().record_event(
            "replica_respawned", replica=idx, generation=gen)
        logger.info("replica %d respawned (gen %d)", idx, gen)

    def _in_rotation(self) -> int:
        with self._lock:
            return sum(1 for pi in self._replicas if pi is not None)

    # -- introspection / lifecycle -------------------------------------------

    @property
    def model(self):
        with self._lock:
            for pi in self._replicas:
                if pi is not None:
                    return pi.model
        return None

    @property
    def buckets(self) -> List[int]:
        with self._lock:
            for pi in self._replicas:
                if pi is not None:
                    return list(pi.buckets)
        return []

    @property
    def _expected_shape(self):
        # duck-typing for InferenceServer's /health feature_shape field
        with self._lock:
            for pi in self._replicas:
                if pi is not None and pi._expected_shape is not None:
                    return pi._expected_shape
        return self._warmup_shape

    def metrics(self) -> dict:
        """Pool-aggregated serving counters in the ParallelInference
        schema (requests/examples/batches/bucket_hits summed over live
        replicas PLUS the retired books of evicted ones, so eviction
        never erases history from the JSON aggregate), plus the pool's
        own lifecycle numbers and a per-replica breakdown. `shed_by` mirrors serving_shed_total —
        replica stages plus the pool's resubmit stage — while `shed`
        stays the per-attempt conservation term (a resubmit shed's final
        attempt is already booked `failed` on its replica)."""
        with self._lock:
            replicas = list(self._replicas)
            gens = list(self._gen)
            pool_shed_by = dict(self._pool_shed_by)
            retired = {k: (dict(v) if isinstance(v, dict) else v)
                       for k, v in self._retired.items()}
        per, agg = [], None
        for idx, pi in enumerate(replicas):
            if pi is None:
                per.append({"replica": idx, "generation": gens[idx],
                            "in_rotation": False})
                continue
            m = pi.metrics()
            per.append({"replica": idx, "generation": gens[idx],
                        "in_rotation": True, "requests": m["requests"],
                        "examples": m["examples"], "batches": m["batches"],
                        "queue_depth": m["queue_depth"]})
            if agg is None:
                agg = m
            else:
                for k in ("requests", "examples", "batches", "oversized",
                          "admitted", "completed", "shed", "failed",
                          "rejected"):
                    agg[k] += m[k]
                for sb, v in m["shed_by"].items():
                    agg["shed_by"][sb] = agg["shed_by"].get(sb, 0) + v
                for b, v in m["bucket_hits"].items():
                    agg["bucket_hits"][b] = agg["bucket_hits"].get(b, 0) + v
                agg["queue_depth"] += m["queue_depth"]
                agg["forward_compiles"] = max(agg["forward_compiles"],
                                              m["forward_compiles"])
        if agg is None:  # every slot mid-respawn: still a valid scrape
            agg = {"mode": self._pi_kwargs["inference_mode"], "requests": 0,
                   "examples": 0, "batches": 0, "oversized": 0,
                   "bucket_hits": {}, "buckets": [],
                   "admitted": 0, "completed": 0, "shed": 0, "failed": 0,
                   "rejected": 0, "shed_by": {},
                   "max_batch_size": self._pi_kwargs["max_batch_size"],
                   "batch_timeout_ms":
                       self._pi_kwargs["batch_timeout_ms"],
                   "queue_depth": 0, "forward_compiles": 0}
        for k in ("requests", "examples", "batches", "oversized",
                  "admitted", "completed", "shed", "failed", "rejected"):
            agg[k] += retired[k]
        for sb, v in retired["shed_by"].items():
            agg["shed_by"][sb] = agg["shed_by"].get(sb, 0) + v
        for b, v in retired["bucket_hits"].items():
            agg["bucket_hits"][b] = agg["bucket_hits"].get(b, 0) + v
        for sb, v in pool_shed_by.items():
            agg["shed_by"][sb] = agg["shed_by"].get(sb, 0) + v
        agg["replicas"] = per
        agg["n_replicas"] = self.n_replicas
        agg["in_rotation"] = sum(1 for pi in replicas if pi is not None)
        with self._lock:
            agg["evictions"] = self._evictions
            agg["respawns"] = self._respawns
        return agg

    def shutdown(self):
        """Graceful: drain every replica (queued work is served), stop
        the supervisor, unsubscribe from health transitions."""
        with self._lock:
            if self._shutdown:
                return
            self._shutdown = True
            replicas = list(self._replicas)
            self._replicas = [None] * self.n_replicas
        _health.get_health().remove_listener(self._on_health_transition)
        self._stop.set()
        self._supervisor.join(timeout=10)
        for pi in replicas:
            if pi is not None:
                pi.shutdown()
        self._gauge.set(0)

"""Continuous-batching autoregressive decode engine — the serving tier
for sequence/decode traffic. The port of the JAX package's
serving/decode.py.

Autoregressive decode is a LOOP per request whose state (the LSTM h/c
carry) survives between steps, and requests arrive and finish at
different times. The engine does **iteration-level scheduling**
(continuous batching):

* ONE per-step decode function advances a fixed pool of `n_slots`
  padded slots by one token per step. Per-slot recurrent carry stays
  RESIDENT ON THE DEVICE across steps (the engine never round-trips h/c
  through the host); the per-row math of the LSTM cell is independent
  across the batch dimension and the step kernel sums in a fixed order
  that does not depend on the row, so slots cannot bleed into each other
  and a slot reproduces a B=1 `rnn_time_step` loop bit for bit.
* New requests are admitted MID-FLIGHT into free slots: slot init zeroes
  that slot's h/c rows in place.
* Finished sequences (EOS / max-len / deadline) free their slot the
  same step; emitted tokens stream back per-request via `on_token`.
* **Weight swap**: the engine keeps two parameter sets, the live one
  and the one beside it. `load_version(params)` copies v+1 into the set
  that is not live on the caller's thread and waits for the copy, then
  the engine flips to that set between steps. A version still pending
  when the next one arrives is overwritten in place.
* **Fused steps**: `set_fused_steps(K)` runs K steps per engine
  iteration as one program that feeds the on-device argmax back with
  `torch.where` — no host sync inside the window.
* **Multi-tenant admission**: per-tenant deadline defaults and
  weighted-fair slot allocation (stride scheduling over per-tenant
  virtual time); per-tenant books obey
  `admitted == completed + shed + failed`.

The step program — one token (K = 1) or a fused window of K — runs on
static buffers: the h/c carry of each recurrent layer, which the program
reads and, by a `copy_` at its end, writes back; the input tokens (and
the window's force mask); the output tokens; and the two parameter sets.
On a CUDA device each (K, parameter set) program is captured once as a
CUDA graph, after one eager warm-up run on a side stream, and every step
replays it: one graph a step or a window, the counterpart of the JAX
engine's one jitted program. A weight swap selects the other set's
graph, so it never captures. On the CPU the same program runs eagerly on
the same buffers. On a Hopper GPU each LSTM layer's step inside the
program is the fused CUDA step kernel (ops/fused_lstm.lstm_step). A
capture records the kernel launches and helper-SPI hits it makes, and
each replay adds them to `fused_lstm.launch_counts()` and
`helper_hit_total`, so both count what ran.

Production integration, as in the JAX engine: slots feed the metrics
registry (`decode_slots_in_use`, `decode_tokens_total{tenant}`,
`decode_token_seconds` with trace exemplars); the engine heartbeats the
watchdog (`<prefix>_engine` — a wedged step degrades component health
like a wedged serving dispatcher; the first step's capture and kernel
build run outside the busy slot); faults inject at the `decode_step`
point; request lifecycle spans are `decode/admit` -> `decode/step` ->
`decode/emit`, with a `decode/swap` span and a flight-recorder event for
each weight flip and for the engine's start and stop; each step's wall
time is split over the tenants whose slots it advanced
(utils/resourcemeter, one flag check when unmetered), and the books
register under the decode tier. The REST layer exposes `POST /generate`
(serving/inference_server.py) behind the same deadline/429 contract as
/predict. `run_ledger=` (a path or a utils.runledger.RunLedger) records
the engine's metrics for its lifetime; each submit notes one request.
Before each step or window replay the engine calls the lock audit's
`note_dispatch("decode/step")` probe (utils/locktrace; one global read
unless DL4J_LOCKCHECK is armed).
"""

from __future__ import annotations

import argparse
import logging
import math
import threading
import time
from collections import deque
from concurrent.futures import Future
from concurrent.futures import TimeoutError as FutureTimeoutError
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.ops import fused_lstm, helpers
from deeplearning4j_tpu_torch.parallel.inference import (
    _WAIT_SHED_GRACE,
    DEFAULT_TENANT,
    AdmissionBooks,
    DeadlineExceeded,
    ReplicaUnavailable,
    RequestRejected,
    RequestValidationError,
    _trace_shed_span,
)
from deeplearning4j_tpu_torch.utils import blackbox as _blackbox
from deeplearning4j_tpu_torch.utils import faultpoints as _faults
from deeplearning4j_tpu_torch.utils import health as _health
from deeplearning4j_tpu_torch.utils import locktrace as _locktrace
from deeplearning4j_tpu_torch.utils import metrics as _metrics
from deeplearning4j_tpu_torch.utils import resourcemeter as _resourcemeter
from deeplearning4j_tpu_torch.utils import runledger as _runledger
from deeplearning4j_tpu_torch.utils import tenancy as _tenancy
from deeplearning4j_tpu_torch.utils import tracing as _tracing

logger = logging.getLogger("deeplearning4j_tpu_torch")

# how long the engine loop sleeps on its condition when it has nothing
# to do (no active slot, empty queue); a submit notifies it awake, so
# this only bounds wakeup latency for the notify-vs-wait race
_IDLE_WAIT = 0.05


class _Request:
    """One admitted generate() call. Host-side bookkeeping only — the
    recurrent state lives in the engine's device-resident carry."""

    __slots__ = ("prompt", "max_new_tokens", "tenant", "deadline", "fut",
                 "on_token", "ctx", "tokens", "t_submit", "t_decode0",
                 "last_emit")

    def __init__(self, prompt, max_new_tokens, tenant, deadline, on_token,
                 ctx):
        self.prompt = prompt                  # np.int32 [P]
        self.max_new_tokens = max_new_tokens
        self.tenant = tenant
        self.deadline = deadline              # absolute monotonic or None
        self.fut = Future()
        self.on_token = on_token
        self.ctx = ctx                        # tracing SpanContext or None
        self.tokens: List[int] = []           # emitted so far
        self.t_submit = time.perf_counter()
        self.t_decode0 = None                 # first step in a slot
        self.last_emit = None


class _Slot:
    __slots__ = ("req", "pos")

    def __init__(self, req: _Request):
        self.req = req
        self.pos = 0  # prompt tokens fed so far


class DecodeEngine:
    """Continuous-batching decode over a recurrent MultiLayerNetwork
    (charlstm is the first model). The model's input must be one-hot
    token ids and its output head a distribution over the same vocab
    (autoregressive feedback); decoding is greedy argmax, so engine
    output is deterministic and comparable to a sequential
    `rnn_time_step` reference."""

    def __init__(
        self,
        model,
        n_slots: int = 8,
        *,
        eos_token: Optional[int] = None,
        default_max_tokens: int = 64,
        default_deadline_ms: Optional[float] = None,
        tenant_weights: Optional[Dict[str, float]] = None,
        tenant_deadline_ms: Optional[Dict[str, float]] = None,
        queue_capacity: int = 256,
        health_stall_after: float = 30.0,
        component_prefix: str = "decode",
        run_ledger=None,
    ):
        if int(n_slots) < 1:
            raise ValueError(f"n_slots must be >= 1, got {n_slots}")
        self.model = model
        model._require_init()
        from deeplearning4j_tpu_torch.nn.multilayer import (
            MultiLayerNetwork,
            _is_recurrent,
        )

        if not isinstance(model, MultiLayerNetwork):
            raise ValueError(
                "DecodeEngine needs a MultiLayerNetwork (the decode step "
                "fn is exposed by nn/multilayer)")
        if not any(_is_recurrent(c) for c in model.layer_confs):
            raise ValueError(
                "DecodeEngine needs a recurrent model (LSTM/GravesLSTM "
                "layers carrying streaming state)")
        first = model.layer_confs[0]
        inner = getattr(first, "inner", first)
        self.vocab = int(inner.n_in)
        last = model.layer_confs[-1]
        if int(getattr(last, "n_out", -1)) != self.vocab:
            raise ValueError(
                f"autoregressive decode feeds the output head back as "
                f"input: head n_out={getattr(last, 'n_out', None)} must "
                f"equal input vocab {self.vocab}")
        self.device = model.device
        self.n_slots = int(n_slots)
        self.eos_token = None if eos_token is None else int(eos_token)
        self.default_max_tokens = int(default_max_tokens)
        self.default_deadline_ms = (None if default_deadline_ms is None
                                    else float(default_deadline_ms))
        self.queue_capacity = max(0, int(queue_capacity))
        self.component_prefix = component_prefix
        self._weights = dict(tenant_weights or {})
        self._tenant_deadline_ms = dict(tenant_deadline_ms or {})

        # run-ledger opt-in (same ONE-knob contract as fit/serving)
        self._ledgers = _runledger.attach_scoped(run_ledger)

        # -- device-resident state: the step program's static buffers -------
        # two parameter sets, the engine's own copies (a swap never writes
        # the model's tensors): the live one and the one a load fills
        self._sets = [_clone_params(model.params_list) for _ in range(2)]
        self._live = 0
        self._states = model.state_list
        # the static carry: the program's input and, copied back, its output
        self._carry = model.rnn_zero_carry(self.n_slots)
        self._version = 0
        self._pending_swap = None                # (version, parameter set, copy event)
        self._swaps = 0
        self._load_lock = threading.Lock()       # one load_version at a time
        # host mirror of the per-slot input token fed next step
        self._feed = np.zeros(self.n_slots, np.int32)

        # -- step programs (built lazily) ------------------------------------
        self._step_fn = None
        self._reset_fn = None
        self._fused_steps = 1
        self._step_k = 1
        self._io: Dict[int, dict] = {}           # K -> static inputs/outputs
        self._graphs: Dict[tuple, tuple] = {}    # (K, set) -> graph + tallies
        self._captures: Dict[int, int] = {}      # K -> graphs captured
        self._capture_stream = None
        self._build_lock = threading.Lock()

        # -- host scheduling state -------------------------------------------
        self._lock = threading.Lock()
        self._wake = threading.Condition(self._lock)
        self._queues: Dict[str, deque] = {}      # tenant -> waiting requests
        self._vtime: Dict[str, float] = {}       # weighted-fair virtual time
        # the scheduler's current virtual position (the vtime of the
        # last tenant served): a tenant re-arriving after an idle spell
        # is clamped UP to it, so idling never banks future share
        self._gvt = 0.0
        self._slots: List[Optional[_Slot]] = [None] * self.n_slots
        self._free: List[int] = list(range(self.n_slots))
        self._books = AdmissionBooks()
        _resourcemeter.register_books(_resourcemeter.TIER_DECODE,
                                      self._books)
        # device-memory attribution for the live weight version (keyed
        # per version so a flipped-away one releases its bytes); no-op
        # when unmetered
        self._hbm_src: Optional[str] = None
        self._note_weights_hbm(0, self._sets[self._live])
        self._requests = 0
        self._steps = 0
        self._tokens_out = 0
        self._draining = False
        self._stopped = threading.Event()

        # -- observability ----------------------------------------------------
        reg = _metrics.get_registry()
        self._m_requests = reg.counter(
            "decode_requests_total",
            "decode requests admitted, by tenant", ("tenant",))
        self._m_tokens = reg.counter(
            "decode_tokens_total",
            "tokens emitted by the decode engine, by tenant", ("tenant",))
        self._m_shed = reg.counter(
            "decode_shed_total",
            "decode requests shed instead of served late, by tenant, "
            "stage and reason", ("tenant", "stage", "reason"))
        self._m_steps = reg.histogram(
            "decode_step_seconds",
            "wall time of one continuous-batching decode step (all "
            "active slots advance one token)").labels()
        self._m_token_lat = reg.histogram(
            "decode_token_seconds",
            "per-token latency of emitted tokens (inter-emit gap; the "
            "first token's gap starts at slot admission)").labels()
        self._m_swaps = reg.counter(
            "serving_weight_swap_total",
            "model version swaps committed by the decode engine").labels()
        self._g_slots = reg.gauge(
            "decode_slots_in_use",
            "decode slots currently holding an active sequence").labels()
        self._g_slots.set(0)
        self._hb = _health.get_health().register(
            f"{component_prefix}_engine", stall_after=health_stall_after)
        self._thread = threading.Thread(
            target=self._loop, daemon=True,
            name=f"dl4j-decode-engine-{component_prefix}")
        self._thread.start()

    # -- public ----------------------------------------------------------------

    def generate(self, prompt: Sequence[int],
                 max_new_tokens: Optional[int] = None,
                 tenant: str = DEFAULT_TENANT,
                 deadline_ms: Optional[float] = None,
                 on_token=None) -> Future:
        """Submit one autoregressive request. `prompt` is a non-empty
        sequence of token ids (< vocab); the engine feeds it token by
        token (prefill shares steps with decode), then emits up to
        `max_new_tokens` greedily, stopping early at `eos_token`. Returns
        a Future resolving to the emitted token list (EOS included when
        hit); `on_token(token_id)` is called from the engine thread per
        emitted token. `deadline_ms` is the request's total budget (falls
        back to the tenant's default, then the engine's): work that
        cannot make it is SHED (DeadlineExceeded / RequestRejected),
        never served late."""
        _runledger.note_request()
        # canonicalize through the bounded registry: past the cap,
        # unknown names collapse into __other__ (books and spend stay
        # conserved; only the per-name breakdown saturates)
        tenant = _tenancy.intern(tenant)
        try:
            p = np.asarray(prompt, np.int64)
        except (TypeError, ValueError) as e:
            raise RequestValidationError(
                f"prompt must be a sequence of token ids: {e}") from None
        if p.ndim != 1 or p.size == 0:
            raise RequestValidationError(
                "prompt must be a non-empty 1-D sequence of token ids")
        if p.min() < 0 or p.max() >= self.vocab:
            raise RequestValidationError(
                f"prompt token ids must be in [0, {self.vocab}), got "
                f"range [{p.min()}, {p.max()}]")
        mx = (self.default_max_tokens if max_new_tokens is None
              else int(max_new_tokens))
        if mx < 1:
            raise RequestValidationError(
                f"max_new_tokens must be >= 1, got {max_new_tokens}")
        if deadline_ms is None:
            deadline_ms = self._tenant_deadline_ms.get(
                tenant, self.default_deadline_ms)
        elif not math.isfinite(float(deadline_ms)):
            raise RequestValidationError(
                f"deadline_ms must be finite, got {deadline_ms!r}")
        deadline = (None if deadline_ms is None
                    else time.monotonic() + float(deadline_ms) / 1e3)
        adm_span = _tracing.span("decode/admit", tenant=tenant,
                                 prompt_len=int(p.size))
        with adm_span:
            ctx = _tracing.current_context()
            with self._lock:
                if self._draining:
                    raise ReplicaUnavailable(
                        "DecodeEngine has been shut down")
                now = time.monotonic()
                if deadline is not None and now >= deadline:
                    self._shed_locked(tenant, "admission", "expired",
                                      admitted=False)
                    self._trace_shed("admission", "expired", ctx)
                    raise DeadlineExceeded(
                        "deadline expired before admission",
                        stage="admission")
                if self.queue_capacity and self._queued_locked() \
                        >= self.queue_capacity:
                    self._shed_locked(tenant, "admission", "queue_full",
                                      admitted=False)
                    self._trace_shed("admission", "queue_full", ctx)
                    raise RequestRejected(
                        f"decode queue at capacity "
                        f"({self.queue_capacity} requests)",
                        reason="queue_full",
                        retry_after=self._wait_hint_locked())
                req = _Request(p.astype(np.int32), mx, tenant, deadline,
                               on_token, ctx)
                self._requests += 1
                self._books.admit(tenant)
                self._m_requests.labels(tenant).inc()
                q = self._queues.setdefault(tenant, deque())
                if not q:
                    # idle -> busy transition: start at the scheduler's
                    # current position (stride scheduling's start-tag
                    # rule)
                    self._vtime[tenant] = max(
                        self._vtime.get(tenant, self._gvt), self._gvt)
                q.append(req)
                self._wake.notify_all()
        return req.fut

    def generate_sync(self, prompt, **kw) -> List[int]:
        """generate() + a bounded wait. A request with a deadline is
        given up `_WAIT_SHED_GRACE` past it (the engine is the primary
        shedder — this is the wedged-engine backstop)."""
        deadline_ms = kw.get("deadline_ms")
        tenant = _tenancy.intern(kw.get("tenant"))
        if deadline_ms is None:
            deadline_ms = self._tenant_deadline_ms.get(
                tenant, self.default_deadline_ms)
        fut = self.generate(prompt, **kw)
        if deadline_ms is None:
            return fut.result()
        try:
            return fut.result(
                timeout=float(deadline_ms) / 1e3 + _WAIT_SHED_GRACE)
        except FutureTimeoutError:
            exc = DeadlineExceeded(
                "deadline expired waiting on a stalled decode engine",
                stage="wait")
            if self._fail(fut, exc, tenant, outcome="shed", stage="wait",
                          reason="expired"):
                raise exc from None
            return fut.result()

    def load_version(self, params) -> int:
        """Commit a new parameter version BESIDE the live one and ask the
        engine to flip to it between steps. The copy into the parameter
        set that is not live (on the live tensors' device and dtype), and
        the wait for it, run on THIS thread — the step loop never blocks
        on the swap. Shapes are validated first: a swap must not change
        the step. Returns the new version number.

        Versions are MONOTONE but not every one serves: a version loaded
        while another was still pending is superseded (warned, never
        served) and overwritten in place. A deployer confirming a rollout
        must therefore wait for `metrics()["version"] >= returned`, not
        `==`."""
        ref = self._sets[0]  # both sets have the model's shapes
        if len(params) != len(ref):
            raise ValueError(
                f"load_version: {len(params)} layers, live model has "
                f"{len(ref)}")
        sources = []
        for new, old in zip(params, ref):
            if set(new) != set(old):
                raise ValueError(
                    f"load_version: parameters {sorted(new)} != live "
                    f"{sorted(old)}")
            src = {k: (v if torch.is_tensor(v) else torch.as_tensor(np.asarray(v)))
                   for k, v in new.items()}
            for k, a in src.items():
                if a.shape != old[k].shape:
                    raise ValueError(
                        f"load_version shape mismatch: {tuple(a.shape)} vs "
                        f"live {tuple(old[k].shape)} — a swap must not "
                        f"change the step")
            sources.append(src)
        cuda = self.device.type == "cuda"
        with self._load_lock:
            with self._lock:
                superseded = self._pending_swap
                if superseded is not None:
                    logger.warning(
                        "decode load_version: pending version %d superseded "
                        "before it was served", superseded[0])
                v = self._version + self._swaps_pending_locked() + 1
                # the engine flips only to a pending set: while this copy
                # runs, none is pending, so the target stays unread. Its
                # last reader, a step before the engine flipped away from
                # it, ended in a host sync on its output.
                self._pending_swap = None
                target = 1 - self._live
            if cuda and superseded is not None:
                # the superseded copy may still be in flight on its
                # loader's stream: this one writes the same set after it
                torch.cuda.current_stream(self.device).wait_event(superseded[2])
            for src, dst in zip(sources, self._sets[target]):
                for k, a in dst.items():
                    a.copy_(src[k])
            done = None
            if cuda:
                # the engine's stream waits on this before its first step
                # on the set; the host wait below is outside every lock
                done = torch.cuda.Event()
                done.record(torch.cuda.current_stream(self.device))
            with self._lock:
                self._pending_swap = (v, target, done)
                self._wake.notify_all()
        if done is not None:
            done.synchronize()
        return v

    def set_fused_steps(self, k: int) -> "DecodeEngine":
        """Run `k` decode steps per engine iteration: the per-slot argmax
        feeds back on the device, prompt positions stay teacher-forced
        (the host precomputes a [k, slots] force mask per window), and the
        host walks the k returned tokens per slot afterwards — admission
        and EOS/max-len checks happen every k tokens, deadline checks
        stay per engine iteration (one window). Emitted tokens are
        identical to k=1 because forcing and feedback reproduce the
        single-step feed exactly. k=1 restores the per-token step."""
        k = int(k)
        if k < 1:
            raise ValueError(f"set_fused_steps needs k >= 1, got {k}")
        with self._lock:
            if k != self._fused_steps:
                self._fused_steps = k
                self._step_fn = None  # rebuilt lazily at the next step
        return self

    def warmup(self) -> "DecodeEngine":
        """Build the step program now (on a CUDA device: run it once and
        capture its graphs) rather than at the first step that has work,
        so no request waits for it. Returns self."""
        self._ensure_programs()
        return self

    def _swaps_pending_locked(self) -> int:
        return 1 if self._pending_swap is not None else 0

    def _note_weights_hbm(self, version: int, params) -> None:
        """Attribute the live weight version's device bytes in the
        device-memory gauge (weights serve every tenant, so they book
        under the shared default tenant), keyed per version: committing
        v releases v-1's bytes. One module-global read when unmetered."""
        if not _resourcemeter.is_enabled():
            return
        src = f"decode_weights_{id(self)}_v{version}"
        nbytes = sum(int(a.numel() * a.element_size())
                     for p in params for a in p.values())
        _resourcemeter.note_hbm(DEFAULT_TENANT, src, nbytes)
        old, self._hbm_src = self._hbm_src, src
        if old is not None and old != src:
            _resourcemeter.note_hbm(DEFAULT_TENANT, old, 0)

    @property
    def version(self) -> int:
        return self._version

    def program_cache_size(self) -> int:
        """Step and slot-reset functions built behind the engine. Steady
        state is 2 after warmup: admissions, weight swaps and traffic
        never build another."""
        return sum(fn is not None for fn in (self._step_fn, self._reset_fn))

    def metrics(self) -> dict:
        with self._lock:
            active = sum(1 for s in self._slots if s is not None)
            queued = {t: len(q) for t, q in self._queues.items() if q}
            m = {
                "slots": self.n_slots,
                "slots_in_use": active,
                "queue_depth": sum(queued.values()),
                "queued_by_tenant": queued,
                "requests": self._requests,
                "steps": self._steps,
                "tokens": self._tokens_out,
                "version": self._version,
                "swaps": self._swaps,
                "tenants": self._books.per_tenant(),
                # CUDA graphs captured, by K: at most 2 each (one per
                # parameter set) for the engine's lifetime; none on the CPU
                "captures": dict(self._captures),
                "conservation_ok": self._books.conservation_ok(),
                **self._books.totals(),
            }
        m["program_cache_size"] = self.program_cache_size()
        m["vocab"] = self.vocab
        m["eos_token"] = self.eos_token
        return m

    def shutdown(self, timeout: float = 30.0):
        """Graceful: new submits are refused, everything queued or in a
        slot is served, then the engine thread exits. A wedged engine
        past `timeout` has its remaining futures failed explicitly so no
        caller hangs forever."""
        with self._lock:
            if self._draining:
                already_stopped = self._stopped.is_set()
            else:
                self._draining = True
                already_stopped = False
            self._wake.notify_all()
        if already_stopped:
            return
        self._thread.join(timeout=timeout)
        _health.get_health().unregister(self._hb)
        _runledger.end_scope(*self._ledgers)
        if self._thread.is_alive():
            err = RuntimeError("DecodeEngine shut down while wedged")
            with self._lock:
                victims = [s.req for s in self._slots if s is not None]
                victims += [r for q in self._queues.values() for r in q]
                for q in self._queues.values():
                    q.clear()
            for req in victims:
                self._fail(req.fut, err, req.tenant)

    # -- books / future plumbing ----------------------------------------------

    def _queued_locked(self) -> int:
        return sum(len(q) for q in self._queues.values())

    def _wait_hint_locked(self) -> float:
        """Retry-After hint: a rough time-to-free-slot — queued requests
        ahead × a nominal per-request budget."""
        return 0.05 * (1.0 + self._queued_locked() / max(1, self.n_slots))

    def _shed_locked(self, tenant, stage, reason, admitted=True):
        self._books.shed(stage, reason, tenant=tenant, admitted=admitted)
        self._m_shed.labels(tenant, stage, reason).inc()

    def _trace_shed(self, stage, reason, ctx):
        _trace_shed_span(stage, reason, ctx)

    def _resolve(self, req: _Request) -> bool:
        """Settle + book under ONE lock hold: whoever's set wins does
        the booking (a waiter's wait-stage shed may race this)."""
        with self._lock:
            try:
                req.fut.set_result(list(req.tokens))
            except Exception:
                return False
            self._books.complete(req.tenant)
        return True

    def _fail(self, fut: Future, exc: Exception, tenant,
              outcome: str = "failed", stage: Optional[str] = None,
              reason: Optional[str] = None) -> bool:
        with self._lock:
            try:
                fut.set_exception(exc)
            except Exception:
                return False
            if outcome == "shed":
                self._shed_locked(tenant, stage, reason)
            else:
                self._books.fail(tenant)
        return True

    # -- weighted-fair admission ----------------------------------------------

    def _pick_tenant_locked(self) -> Optional[str]:
        """Stride scheduling: among tenants with waiting requests, pick
        the smallest virtual time; admitting charges the tenant
        1/weight. A heavy tenant's vtime advances slowly, so it wins
        more slots — proportional share, never starvation."""
        waiting = [t for t, q in self._queues.items() if q]
        if not waiting:
            return None
        for t in waiting:
            self._vtime.setdefault(t, self._gvt)
        return min(waiting, key=lambda t: (self._vtime[t], t))

    def _admit_locked(self, now: float) -> List[int]:
        """Fill free slots from the tenant queues (shedding anything that
        expired while queued). Returns the slot indices admitted this
        round — their carries are reset OUTSIDE the lock."""
        admitted = []
        while self._free:
            tenant = self._pick_tenant_locked()
            if tenant is None:
                break
            req = self._queues[tenant].popleft()
            if req.fut.done():
                # already settled (a generate_sync waiter shed it at the
                # wait stage while it queued): whoever settled it booked it
                continue
            if req.deadline is not None and now >= req.deadline:
                try:
                    req.fut.set_exception(DeadlineExceeded(
                        "deadline expired while queued for a slot",
                        stage="queued"))
                except Exception:
                    continue
                self._shed_locked(tenant, "queued", "expired")
                self._trace_shed("queued", "expired", req.ctx)
                continue
            self._gvt = self._vtime.get(tenant, self._gvt)
            self._vtime[tenant] = self._gvt \
                + 1.0 / max(1e-6, float(self._weights.get(tenant, 1.0)))
            idx = self._free.pop()
            self._slots[idx] = _Slot(req)
            self._feed[idx] = req.prompt[0]
            req.t_decode0 = time.perf_counter()
            req.last_emit = req.t_decode0
            admitted.append(idx)
        return admitted

    # -- the engine loop -------------------------------------------------------

    def _ensure_programs(self):
        with self._build_lock:
            if self._step_fn is None:
                self._build_programs()

    def _build_programs(self):
        """The step program for the current K and the slot reset. On a
        CUDA device, capture the program as a graph for each parameter
        set that has none for this K yet."""
        base = self.model.rnn_decode_step_fn()
        vocab = self.vocab
        states = self._states
        K = self._fused_steps

        def one(params, carry, tokens):
            # token ids -> exact one-hot rows (the same rows a
            # rnn_time_step caller feeds), one step, greedy argmax
            x = F.one_hot(tokens.long(), vocab).to(torch.float32)
            new_carry, out = base(params, states, carry, x)
            return new_carry, torch.argmax(out, dim=-1).to(torch.int32)

        def program(params, carry, io):
            if K == 1:
                new, toks = one(params, carry, io["feed"])
            else:
                # K steps, no host sync: teacher-forced positions (prompt
                # prefill; always step 0, whose token the host staged in
                # _feed) take toks, the rest feed the previous argmax back
                # on the device — the same per-step inputs the k=1 step
                # sees, so tokens are identical
                new, prev, out = carry, io["toks"][0], []
                for t in range(K):
                    tok = torch.where(io["force"][t], io["toks"][t], prev)
                    new, prev = one(params, new, tok)
                    out.append(prev)
                toks = torch.stack(out)  # [K, slots]
            for i, st in carry.items():
                for name, a in st.items():
                    a.copy_(new[i][name])
            io["out"].copy_(toks)

        def reset(carry, idx):
            # zero ONE slot's h/c rows of the static carry, in place
            for st in carry.values():
                for a in st.values():
                    a[idx].zero_()

        if K not in self._io:
            dev, n = self.device, self.n_slots
            self._io[K] = ({"feed": torch.zeros(n, dtype=torch.int32, device=dev),
                            "out": torch.zeros(n, dtype=torch.int32, device=dev)}
                           if K == 1 else
                           {"toks": torch.zeros((K, n), dtype=torch.int32, device=dev),
                            "force": torch.zeros((K, n), dtype=torch.bool, device=dev),
                            "out": torch.zeros((K, n), dtype=torch.int32, device=dev)})
        if self.device.type == "cuda":
            for s in range(len(self._sets)):
                if (K, s) not in self._graphs:
                    self._capture(program, K, s)
        else:
            self.model._note_compile("decode_step")
        self._step_fn = program
        self._step_k = K  # the K the live step was built for
        self._reset_fn = reset
        self.model._note_compile("decode_admit")

    def _capture(self, program, K: int, s: int):
        """Capture `program` on parameter set `s` as a CUDA graph: one
        eager warm-up run on a side stream first (the kernels' build,
        their attribute calls and cuBLAS's workspace happen outside the
        capture), on copies of the carry and outputs, so the serving state
        does not move. The launches and SPI events the capture makes are
        recorded, to be counted on every replay."""
        params, io = self._sets[s], self._io[K]
        if self._capture_stream is None:
            self._capture_stream = torch.cuda.Stream(self.device)
        side = self._capture_stream
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.no_grad(), torch.cuda.stream(side):
            program(params, {i: {k: a.clone() for k, a in st.items()}
                             for i, st in self._carry.items()},
                    {k: a.clone() for k, a in io.items()})
        torch.cuda.current_stream(self.device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with fused_lstm.recording_launches() as launches, \
                helpers.recording_events() as events, torch.no_grad(), \
                torch.cuda.graph(graph, stream=side,
                                 capture_error_mode="thread_local"):
            program(params, self._carry, io)
        self._graphs[(K, s)] = (graph, launches, events)
        with self._lock:
            self._captures[K] = self._captures.get(K, 0) + 1
        self.model._note_compile("decode_step")

    def _run_program(self):
        """One step or window on the static buffers, with the live
        parameter set: a graph replay on a CUDA device, the program itself
        on the CPU. Returns the output tokens on the host."""
        io = self._io[self._step_k]
        if self.device.type == "cuda":
            graph, launches, events = self._graphs[(self._step_k, self._live)]
            graph.replay()
            fused_lstm.add_launches(launches)
            helpers.replay_events(events)
        else:
            with torch.no_grad():
                self._step_fn(self._sets[self._live], self._carry, io)
        return io["out"].to("cpu", copy=True).numpy()

    def _step_once(self):
        """One continuous-batching iteration: swap-if-pending, admit,
        advance every active slot one token (K with fused steps),
        emit/finish/shed."""
        # 1. pending weight swap: flip BETWEEN steps
        t_swap = time.perf_counter()
        with self._lock:
            pending = self._pending_swap
            self._pending_swap = None
            if pending is not None:
                self._version, self._live = pending[:2]
                self._swaps += 1
        if pending is not None:
            v = pending[0]
            if pending[2] is not None:
                # device-side order: the copies into the set, then its steps
                torch.cuda.current_stream(self.device).wait_event(pending[2])
            self._m_swaps.inc()
            self._note_weights_hbm(v, self._sets[self._live])
            _tracing.record_complete("decode/swap", t_swap,
                                     time.perf_counter(), None, version=v)
            _blackbox.get_recorder().record_event(
                "decode_weight_swap", version=v)
            logger.info("decode engine flipped to weight version %d", v)
        # 2. admission into free slots
        now = time.monotonic()
        with self._lock:
            admitted = self._admit_locked(now)
            active = [(i, s) for i, s in enumerate(self._slots)
                      if s is not None]
            n_active = len(active)
            draining = self._draining
            idle = n_active == 0 and self._queued_locked() == 0 \
                and self._pending_swap is None
        self._g_slots.set(n_active)
        if idle:
            if draining:
                return False  # drained: the loop exits
            with self._wake:
                self._wake.wait(_IDLE_WAIT)
            return True
        # 3. ONE step (or one fused window) over the whole pool. The
        # programs (and, on a CUDA device, their kernel builds and graph
        # captures) are made before the busy slot: only the step itself
        # runs on the watchdog's clock
        try:
            self._ensure_programs()
        except Exception as e:
            self._fail_active(e)
            return True
        t0 = time.perf_counter()
        K = self._step_k
        with self._hb.busy():
            # chaos hook: latency/hang here is a wedged decode step — the
            # watchdog degrades <prefix>_engine and deadline-carrying
            # slots shed on the next iteration; an `error` fails the
            # active sequences (their carry is device state mid-flight,
            # not resumable) and the engine keeps serving
            try:
                _faults.fault_point("decode_step", active=n_active)
                # CN003 probe: the engine must never enter the step or
                # window replay holding the admission lock (off = one
                # module-global read)
                _locktrace.note_dispatch("decode/step")
                with _tracing.span("decode/step", active=n_active,
                                   version=self._version):
                    io = self._io[K]
                    with torch.no_grad():
                        for idx in admitted:
                            self._reset_fn(self._carry, idx)
                        if K == 1:
                            io["feed"].copy_(torch.from_numpy(self._feed))
                        else:
                            toks, force = self._fused_feed_window(K, active)
                            io["toks"].copy_(torch.from_numpy(toks))
                            io["force"].copy_(torch.from_numpy(force))
                    nxt_host = self._run_program()
            except BaseException as e:
                self._fail_active(e)
                self._hb.beat()
                return True
        dt = time.perf_counter() - t0
        self._m_steps.observe(dt)
        if _resourcemeter.is_enabled():
            # split this step's wall time over the tenants whose slots it
            # advanced: weighted-fair scheduling becomes auditable
            # device-second SPEND. Shares are built only when metered —
            # the unmetered loop pays one module-global read per step.
            shares: Dict[str, int] = {}
            for _, sl in active:
                t = sl.req.tenant
                shares[t] = shares.get(t, 0) + 1
            _resourcemeter.note_decode_step(dt, shares)
        with self._lock:
            self._steps += 1
        # 4. host bookkeeping per active slot
        now = time.monotonic()
        t_emit = time.perf_counter()
        for idx, slot in active:
            if K == 1:
                self._advance_slot(idx, slot, int(nxt_host[idx]), now,
                                   t_emit)
            else:
                self._advance_slot_fused(idx, slot, nxt_host[:, idx], now,
                                         t_emit)
        self._hb.beat()
        return True

    def _fused_feed_window(self, K: int, active) -> tuple:
        """[K, slots] token + force matrices for one fused window: step 0
        is always forced with the staged `_feed`; later steps force the
        prompt token a slot will have reached at that step (prefill), and
        everything else feeds back the on-device argmax."""
        toks = np.zeros((K, self.n_slots), np.int32)
        force = np.zeros((K, self.n_slots), bool)
        toks[0] = self._feed
        force[0] = True
        for idx, slot in active:
            prompt = slot.req.prompt
            P = len(prompt)
            for t in range(1, K):
                if slot.pos + t < P:
                    toks[t, idx] = prompt[slot.pos + t]
                    force[t, idx] = True
        return toks, force

    def _emit(self, req: _Request, token: int) -> None:
        req.tokens.append(token)
        if req.on_token is not None:
            try:
                req.on_token(token)
            except Exception:
                logger.exception("decode on_token callback raised "
                                 "(request continues)")

    def _is_done(self, req: _Request, token: int) -> bool:
        return (len(req.tokens) >= req.max_new_tokens
                or (self.eos_token is not None and token == self.eos_token))

    def _trace_emit(self, req: _Request) -> None:
        """The finished request's retroactive decode/emit span, from its
        first step in a slot to now, under its admission context."""
        if req.ctx is not None and _tracing.is_enabled():
            _tracing.record_complete(
                "decode/emit", req.t_decode0, time.perf_counter(),
                req.ctx, tenant=req.tenant, tokens=len(req.tokens))

    def _advance_slot_fused(self, idx: int, slot: _Slot, toks, now: float,
                            t_emit: float):
        """Walk one slot through the K tokens of a fused window — the
        same per-step transitions as _advance_slot, applied K at a time.
        Tokens computed past EOS/max-len are discarded host-side (the
        slot's carry resets at its next admission). The per-token latency
        histogram spreads the window gap evenly over its emissions."""
        req = slot.req
        if req.fut.done():
            self._free_slot(idx)
            return
        P = len(req.prompt)
        emitted = []
        done = False
        for t in range(len(toks)):
            if slot.pos < P:
                slot.pos += 1
                if slot.pos < P:
                    continue  # still prefilling (teacher forcing)
            token = int(toks[t])
            emitted.append(token)
            self._emit(req, token)
            if self._is_done(req, token):
                done = True
                break
        if emitted:
            tr = req.ctx.trace_id if req.ctx is not None else None
            gap = (t_emit - req.last_emit) / len(emitted)
            for _ in emitted:
                self._m_token_lat.observe(gap, trace_id=tr,
                                          tenant=req.tenant)
            req.last_emit = t_emit
            self._m_tokens.labels(req.tenant).inc(len(emitted))
            _resourcemeter.note_tokens(req.tenant, len(emitted))
            with self._lock:
                self._tokens_out += len(emitted)
        if done:
            self._trace_emit(req)
            self._free_slot(idx)
            self._resolve(req)
            return
        # stage the next window's step-0 feed: the next prompt token
        # while prefilling, else the last emitted token (feedback)
        self._feed[idx] = (req.prompt[slot.pos] if slot.pos < P
                           else emitted[-1])
        self._check_deadline(idx, slot, now)

    def _advance_slot(self, idx: int, slot: _Slot, token: int, now: float,
                      t_emit: float):
        req = slot.req
        if req.fut.done():
            # the waiter already shed it (wait-stage backstop): free the
            # slot without touching the books — whoever failed it booked
            self._free_slot(idx)
            return
        P = len(req.prompt)
        if slot.pos < P:
            slot.pos += 1
            if slot.pos < P:
                # still prefilling: feed the next prompt token, ignore
                # the model's prediction (teacher forcing)
                self._feed[idx] = req.prompt[slot.pos]
                self._check_deadline(idx, slot, now)
                return
        # the fed token was the last prompt token or a generated one:
        # `token` is the next emitted token
        self._feed[idx] = token
        tr = req.ctx.trace_id if req.ctx is not None else None
        self._m_token_lat.observe(t_emit - req.last_emit, trace_id=tr,
                                  tenant=req.tenant)
        req.last_emit = t_emit
        self._m_tokens.labels(req.tenant).inc()
        _resourcemeter.note_tokens(req.tenant, 1)
        with self._lock:
            self._tokens_out += 1
        self._emit(req, token)
        if self._is_done(req, token):
            self._trace_emit(req)
            self._free_slot(idx)
            self._resolve(req)
            return
        self._check_deadline(idx, slot, now)

    def _check_deadline(self, idx: int, slot: _Slot, now: float):
        req = slot.req
        if req.deadline is None or now < req.deadline:
            return
        self._free_slot(idx)
        if self._fail(req.fut,
                      DeadlineExceeded(
                          "deadline expired mid-decode "
                          f"({len(req.tokens)} token(s) emitted)",
                          stage="decode"),
                      req.tenant, outcome="shed", stage="decode",
                      reason="expired"):
            self._trace_shed("decode", "expired", req.ctx)

    def _free_slot(self, idx: int):
        with self._lock:
            self._slots[idx] = None
            self._free.append(idx)
        self._feed[idx] = 0

    def _fail_active(self, exc: BaseException):
        """A failed step loses every active sequence (their carry was
        mid-flight); queued work is untouched and the engine keeps
        serving."""
        with self._lock:
            victims = [(i, s) for i, s in enumerate(self._slots)
                       if s is not None]
        for idx, slot in victims:
            self._free_slot(idx)
            self._fail(slot.req.fut,
                       RuntimeError(f"decode step failed: "
                                    f"{type(exc).__name__}: {exc}"),
                       slot.req.tenant)
        # zero the static carry in place (graphs hold its addresses); each
        # admission zeroes its own rows anyway
        try:
            with torch.no_grad():
                for st in self._carry.values():
                    for a in st.values():
                        a.zero_()
        except Exception:
            logger.exception("decode: zeroing the carry after a failed step "
                             "raised")
        logger.warning("decode step failed (%s); %d active sequence(s) "
                       "failed, engine continues", exc, len(victims))

    def _loop(self):
        _blackbox.get_recorder().record_event(
            "decode_engine_start", slots=self.n_slots)
        try:
            while True:
                if not self._step_once():
                    break
        except BaseException:
            logger.exception("decode engine loop died")
            with self._lock:
                self._draining = True
            self._fail_active(RuntimeError("decode engine died"))
            with self._lock:
                victims = [r for q in self._queues.values() for r in q]
                for q in self._queues.values():
                    q.clear()
            for req in victims:
                self._fail(req.fut, RuntimeError("decode engine died"),
                           req.tenant)
        finally:
            self._stopped.set()
            _blackbox.get_recorder().record_event("decode_engine_stop")


def _clone_params(params_list) -> list:
    return [{k: v.detach().clone() for k, v in p.items()} for p in params_list]


# -- the decode smoke ----------------------------------------------------------


def smoke(n_slots: int = 4, vocab: int = 13, hidden: int = 16,
          requests: int = 10, device=None) -> dict:
    """Tiny end-to-end proof: a charlstm decode engine with 2 tenants
    serves mixed prompts through ONE mid-run weight swap; asserts every
    request completes, the per-tenant books conserve, and no step
    function is rebuilt across admissions and the swap. Raises on any
    violation; returns the verdict dict."""
    from deeplearning4j_tpu_torch.models.charlstm import char_lstm_network

    net = char_lstm_network(vocab_size=vocab, hidden=hidden, layers=1,
                            tbptt_length=8, device=device)
    eng = DecodeEngine(net, n_slots=n_slots,
                       tenant_weights={"a": 3.0, "b": 1.0},
                       default_max_tokens=6, component_prefix="smoke_decode")
    try:
        rng = np.random.default_rng(0)
        # warmup: one request builds the step + reset functions
        eng.generate([1, 2], max_new_tokens=2, tenant="a").result(60)
        warm = eng.program_cache_size()
        futs = []
        for i in range(requests):
            prompt = rng.integers(0, vocab, size=1 + i % 4).tolist()
            futs.append(eng.generate(prompt, max_new_tokens=3 + i % 3,
                                     tenant="a" if i % 2 else "b"))
            if i == requests // 2:
                v = eng.load_version([{k: t * 1.001 for k, t in p.items()}
                                      for p in net.params_list])
        outs = [f.result(60) for f in futs]
        m = eng.metrics()
        ok_swap = m["swaps"] == 1 and m["version"] == v
        ok_books = m["conservation_ok"] and \
            m["completed"] == requests + 1 and m["shed"] == 0 \
            and m["failed"] == 0
        ok_cache = eng.program_cache_size() == warm
        verdict = {
            "requests": requests,
            "tokens": m["tokens"],
            "swap_ok": ok_swap,
            "books_ok": ok_books,
            "tenants": m["tenants"],
            "program_cache": {"warm": warm,
                              "final": eng.program_cache_size()},
            "zero_rebuilds": ok_cache,
            "ok": bool(ok_swap and ok_books and ok_cache
                       and all(len(o) >= 3 for o in outs)),
        }
        if not verdict["ok"]:
            raise AssertionError(f"decode smoke violated: {verdict}")
        return verdict
    finally:
        eng.shutdown()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="decode engine smoke")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    if not args.smoke:
        ap.error("only --smoke is supported")
    import json

    logging.basicConfig(level=logging.INFO)
    logger.info("decode smoke: %s", json.dumps(smoke(device=args.device)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

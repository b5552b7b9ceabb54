"""Always-on device performance & memory accounting, the port of the JAX
package's utils/devprof.py: the runtime half of the device observability
layer (analysis/costmodel.py is the static half; each checks the other).

The fit loop's host-side phase timers can say the host is not the
bottleneck, but every *device*-side number — step time, MFU, FLOP/s —
would otherwise exist only in benchmark runs. This module makes them
first-class, always-on series at fixed cost:

* **The dispatch timeline** (CUDA nets): each fit dispatch is bracketed
  by two timing events from a reused pool, `S` just before it is
  enqueued and `E` just after, on the stream it is launched on (a
  graph's replay launches on the current stream; a warm-up or capture
  on a side stream is joined back to it before `E`). Each staged batch
  that data/prefetch.DevicePrefetchIterator hands to the fit loop
  carries a pair of its own, `A` and `B` around the stream's wait on
  its copy (`timed_wait`). Nothing waits on an event: a record is
  resolved by `Event.query()` at a later dispatch, oldest first (and at
  the fit's exit, for what has completed), from a pending ring of
  `PENDING_LIMIT`; a dispatch that finds the ring full goes untimed
  (`fit_dispatch_untimed_total`). A resolved dispatch observes
  `fit_device_seconds` (E − S), `fit_input_stall_seconds` (Σ B − A over
  its batches) and `fit_host_gap_seconds` (S − the previous E − the
  stall: the card waiting for the host; 0 for a fit's first dispatch
  and for one after an untimed dispatch). The three add up to the
  card's period, E − the previous E. `recent_fits()` sums them per fit.
* **Sampled device time**: every `sample_every`-th resolved dispatch
  the window's period on the card's clock (the sum of its dispatches'
  periods: the elapsed time from the window's first E to its last)
  divided by the optimizer steps in it is the per-step device-visible
  time; nothing drains the launch queue. A CPU net has no queue: there
  the window is the host clock between samples, and unsampled steps
  cost two integer ops. Under the CPU tests sampling is OFF
  (`configure(sample_every=0)` in each devprof-sensitive test file) so
  their timing stays stable.
* **Live MFU**: `step_mfu{source}` and `step_flops_per_second{source}`
  gauges from the measured window × the net's model FLOPs — from the
  step cost model when one was attached (`net.attach_cost_model`), else
  from the analytic per-layer estimator (utils/flops); the `source`
  label says which. `step_mfu` needs the card's peak (utils/flops), so
  off the GPU only the FLOP/s gauge moves.
* **Memory watermarks**: `device_memory_bytes{kind=params|updater|
  activations_est|live}` gauges polled at each sample — params/updater
  from the net's tensors, `activations_est` from the attached static
  model, `live` from `torch.cuda.memory_allocated` on a CUDA net. The
  flight recorder folds these into its periodic registry captures as
  absolute levels, so a post-crash dump shows the memory trajectory
  leading into an out-of-memory error.
* **OOM forensics**: `is_oom()` recognizes `torch.cuda.OutOfMemoryError`,
  the CUDA allocator's "out of memory" text and the `oom` fault kind's
  `InjectedOOM` (utils/faultpoints) escaping the fit loop or the serving
  forward; `oom_forensics()` records the largest live tensors on the
  failing device beside the static activation estimate and dumps the
  flight recorder (rendered by `blackbox.render_dump` as an "OOM
  forensics" section).
"""

from __future__ import annotations

import gc
import itertools
import logging
import os
import threading
import time
import weakref
from collections import deque
from typing import List, Optional

import torch

from deeplearning4j_tpu_torch.utils import blackbox as _blackbox
from deeplearning4j_tpu_torch.utils import metrics as _metrics
from deeplearning4j_tpu_torch.utils import resourcemeter as _resourcemeter

logger = logging.getLogger("deeplearning4j_tpu_torch")

# the step gauges move every Nth dispatch; 0 leaves them still
DEFAULT_SAMPLE_EVERY = int(os.environ.get("DL4J_DEVPROF_SAMPLE_EVERY", "16"))

# dispatch records waiting for their events to complete, per net; a
# dispatch that finds this many goes untimed
PENDING_LIMIT = 64

# free timing events kept per device
_POOL_LIMIT = 256

# the per-fit sums `recent_fits()` keeps
_RECENT_FITS = 16

_OOM_MARKERS = ("RESOURCE_EXHAUSTED", "Out of memory", "out of memory",
                "Resource exhausted")


def is_oom(exc: BaseException) -> bool:
    """Does this exception look like a device allocator failure? The
    CUDA caching allocator raises torch.cuda.OutOfMemoryError ("CUDA out
    of memory"); a kernel's own cudaMalloc failure surfaces as a
    RuntimeError carrying "out of memory"; the injected `oom` fault
    carries the RESOURCE_EXHAUSTED marker by construction."""
    oom_type = getattr(torch.cuda, "OutOfMemoryError", None)
    if oom_type is not None and isinstance(exc, oom_type):
        return True
    msg = str(exc)
    return any(m in msg for m in _OOM_MARKERS)


def _device_type(device) -> str:
    if device is None:
        return "cuda" if torch.cuda.is_available() else "cpu"
    return torch.device(device).type


def largest_live_buffers(top: int = 12, device=None) -> List[dict]:
    """The biggest live tensors on `device`'s type (the GPU when one is
    visible and none is named) right now — the "what is actually holding
    device memory" half of an OOM dump. One garbage-collector scan,
    tensors sharing a storage counted once at the storage's size. Never
    raises (forensics must not shadow the failure being diagnosed)."""
    want = _device_type(device)
    seen = {}
    try:
        objs = gc.get_objects()
    except Exception:
        return []
    for o in objs:
        try:
            if not isinstance(o, torch.Tensor) or o.device.type != want or o.is_meta:
                continue
            st = o.untyped_storage()
            key = (st.data_ptr(), st.nbytes())
            if key in seen or not st.nbytes():
                continue
            seen[key] = {
                "shape": tuple(int(s) for s in o.shape),
                "dtype": str(o.dtype).replace("torch.", ""),
                "nbytes": int(st.nbytes()),
                "device": str(o.device),
            }
        except Exception:
            continue
    rows = sorted(seen.values(), key=lambda d: -d["nbytes"])
    return rows[:top]


def device_bytes_in_use(device=None) -> Optional[int]:
    """Allocator bytes in use on a CUDA device (`torch.cuda.memory_allocated`);
    None off the GPU (a host's RAM is not the device watermark)."""
    try:
        if _device_type(device) != "cuda" or not torch.cuda.is_available():
            return None
        dev = torch.device("cuda") if device is None else torch.device(device)
        return int(torch.cuda.memory_allocated(dev))
    except Exception:
        return None


def _tree_bytes(tree) -> int:
    """Byte sum of the tensors of a (nested list/dict of) parameters or
    updater state: this process's tensors, so a tensor-parallel shard
    counts its own size — `device_memory_bytes{kind}` is one card's
    watermark, not the global footprint."""
    if torch.is_tensor(tree):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        return sum(_tree_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_tree_bytes(v) for v in tree)
    return 0


def _data_shards_of(net) -> int:
    """Data-axis shard count of a mesh-attached net (1 otherwise) — the
    divisor that keeps every per-chip number per-chip."""
    plan = getattr(net, "_mesh_plan", None)
    n = getattr(plan, "n_data_shards", 1) if plan is not None else 1
    return max(1, int(n))


def _net_device(net):
    return getattr(net, "device", None)


class _Dispatch:
    """One timed dispatch: its events, its batches' input pairs, the E of
    the dispatch before it in the same fit (None: the first, or after an
    untimed one), and what it trained."""

    __slots__ = ("start", "end", "prev_end", "inputs", "stream", "it0",
                 "examples", "steps", "fit")

    def __init__(self, start, stream, inputs, prev_end, it0, fit):
        self.start, self.stream, self.inputs = start, stream, inputs
        self.prev_end, self.it0, self.fit = prev_end, it0, fit
        self.end = None
        self.examples = self.steps = 0


class _Timeline:
    """A CUDA net's dispatch records (`net._dispatch_timeline`): the
    pending ring, the last E of the fit in progress and that fit's sums."""

    def __init__(self, net):
        self.net = weakref.ref(net)
        self.device = net.device
        self.pending: deque = deque()
        self.last_end = None
        self.fit: Optional[dict] = None
        self.lock = threading.Lock()  # recent_fits() resolves from any thread


class DeviceProfiler:
    """Process-global step accounting. One instance (`get_profiler()`);
    per-net sampling state lives on the net (`net._devprof_state`, and a
    CUDA net's `net._dispatch_timeline`) so concurrent fits never share
    a window."""

    def __init__(self, sample_every: Optional[int] = None):
        self.sample_every = (DEFAULT_SAMPLE_EVERY if sample_every is None
                             else int(sample_every))
        self._ins = None
        self._lock = threading.Lock()
        self._free: dict = {}  # device index -> free timing events
        self._timelines = weakref.WeakSet()
        self._fits: deque = deque(maxlen=_RECENT_FITS)
        self._fit_ids = itertools.count(1)

    def configure(self, sample_every: int) -> "DeviceProfiler":
        """0 disables the sampled gauges (the repo's 0-disables
        convention); the memory/MFU gauges then only move when a sample
        is forced (`sample_now`). The dispatch timeline's histograms
        move either way."""
        self.sample_every = int(sample_every)
        return self

    def _instruments(self):
        ins = self._ins
        if ins is None:
            reg = _metrics.get_registry()
            with self._lock:
                ins = self._ins
                if ins is None:
                    ins = self._ins = {
                        "mfu": reg.gauge(
                            "step_mfu",
                            "measured model-FLOPs utilization over the "
                            "last devprof sample window", ("source",)),
                        "fps": reg.gauge(
                            "step_flops_per_second",
                            "model FLOP/s over the last devprof sample "
                            "window", ("source",)),
                        "step_seconds": reg.gauge(
                            "step_device_seconds",
                            "per-step device-visible time over the last "
                            "devprof sample window"),
                        "samples": reg.counter(
                            "devprof_samples_total",
                            "sampled device-time windows").labels(),
                        "device": reg.histogram(
                            "fit_device_seconds",
                            "the card's time on a fit dispatch (E - S "
                            "of its timing events)").labels(),
                        "input_stall": reg.histogram(
                            "fit_input_stall_seconds",
                            "time the card's stream waited on a "
                            "dispatch's staged batch copies").labels(),
                        "host_gap": reg.histogram(
                            "fit_host_gap_seconds",
                            "time the card waited for the host to "
                            "enqueue a fit dispatch").labels(),
                        "untimed": reg.counter(
                            "fit_dispatch_untimed_total",
                            "fit dispatches left untimed: the pending "
                            "ring of timing records was full").labels(),
                        "memory": reg.gauge(
                            "device_memory_bytes",
                            "device memory watermarks polled at devprof "
                            "samples", ("kind",)),
                        "oom": reg.counter(
                            "oom_total",
                            "device out-of-memory failures that reached "
                            "the OOM forensics path", ("where",)),
                    }
        return ins

    # -- timing events ---------------------------------------------------------

    def take_event(self, device):
        """A timing event from the pool of `device`'s (a new one when the
        pool is empty)."""
        free = self._free.get(torch.device(device).index or 0)
        if free:
            try:
                return free.pop()
            except IndexError:  # another thread took the last one
                pass
        return torch.cuda.Event(enable_timing=True)

    def give_events(self, device, events) -> None:
        """Return events whose last reader is done with them."""
        free = self._free.setdefault(torch.device(device).index or 0, [])
        for ev in events:
            if len(free) < _POOL_LIMIT:
                free.append(ev)

    def timed_wait(self, stream, event, device) -> tuple:
        """`stream.wait_event(event)` between two timing events (A, B):
        B − A is the time the stream waited for `event`."""
        a, b = self.take_event(device), self.take_event(device)
        a.record(stream)
        stream.wait_event(event)
        b.record(stream)
        return a, b

    # -- the fit-loop hooks ----------------------------------------------------

    def begin_dispatch(self, net, batches=None):
        """Called by the fit loop just before a dispatch is enqueued. On a
        CUDA net: records S on the current stream and takes the batches'
        input pairs (`_input_events`), returning the open record; None
        elsewhere, and for a dispatch the full pending ring leaves
        untimed."""
        if net.device.type != "cuda":
            return None
        tl = getattr(net, "_dispatch_timeline", None)
        if tl is None:
            tl = net._dispatch_timeline = _Timeline(net)
            self._timelines.add(tl)
        if tl.fit is None:
            tl.fit = {"fit": next(self._fit_ids), "dispatches": 0, "resolved": 0,
                      "device_seconds": 0.0, "input_stall_seconds": 0.0,
                      "host_gap_seconds": 0.0}
            self._fits.append(tl.fit)
        tl.fit["dispatches"] += 1
        inputs = []
        for b in batches or ():
            pair = getattr(b, "_input_events", None)
            if pair is not None:
                inputs.append(pair)
                b._input_events = None  # one dispatch reads it
        if len(tl.pending) >= PENDING_LIMIT:
            self._resolve(tl)
        if len(tl.pending) >= PENDING_LIMIT:
            self._instruments()["untimed"].inc()
            tl.last_end = None  # the next dispatch has no period
            return None
        stream = torch.cuda.current_stream(tl.device)
        start = self.take_event(tl.device)
        start.record(stream)
        return _Dispatch(start, stream, inputs, tl.last_end,
                         int(getattr(net, "iteration", 0)), tl.fit)

    def end_dispatch(self, net, rec, n_examples: int) -> None:
        """Called just after the dispatch was enqueued: records E and
        queues the record."""
        if rec is None:
            return
        rec.end = self.take_event(net.device)
        rec.end.record(rec.stream)
        rec.examples = n_examples
        rec.steps = max(1, int(getattr(net, "iteration", 0)) - rec.it0)
        tl = net._dispatch_timeline
        tl.pending.append(rec)
        tl.last_end = rec.end

    def on_step(self, net, n_examples: int, score) -> None:
        """Called by the fit loop (netbase._timed_fit) after every
        dispatch. A CUDA net resolves its completed dispatch records; on
        the CPU, unsampled steps are two integer adds and a modulo."""
        tl = getattr(net, "_dispatch_timeline", None)
        if tl is not None:
            self._resolve(tl)
            return
        se = self.sample_every
        if se <= 0:
            return
        st = self._state(net)
        st["dispatches"] += 1
        st["examples"] += n_examples
        if st["dispatches"] % se:
            return
        self._sample(net, st, score)

    def end_fit(self, net) -> None:
        """The fit's exit: resolve what has completed, keep the rest for
        later (nothing waits), and start the next fit's chain afresh."""
        tl = getattr(net, "_dispatch_timeline", None)
        if tl is not None:
            self._resolve(tl)
            tl.last_end = None
            tl.fit = None

    def recent_fits(self) -> List[dict]:
        """The dispatch timeline's sums for the last fits of CUDA nets,
        oldest first: the fit's number, its dispatches, those resolved,
        and their device time, input stall and host gap in seconds. Each
        live net's completed records are resolved first."""
        for tl in list(self._timelines):
            self._resolve(tl)
        return [dict(f) for f in self._fits]

    def _resolve(self, tl: _Timeline) -> None:
        """Observe the completed records, oldest first, and return their
        events to the pool."""
        with tl.lock:
            self._resolve_locked(tl)

    def _resolve_locked(self, tl: _Timeline) -> None:
        ins = None
        while tl.pending and tl.pending[0].end.query():
            rec = tl.pending.popleft()
            if ins is None:
                ins = self._instruments()
            device_s, stall_s, gap_s, period_s = self.dispatch_times(rec)
            ins["device"].observe(device_s)
            ins["input_stall"].observe(stall_s)
            ins["host_gap"].observe(gap_s)
            f = rec.fit
            f["resolved"] += 1
            f["device_seconds"] += device_s
            f["input_stall_seconds"] += stall_s
            f["host_gap_seconds"] += gap_s
            net = tl.net()
            if period_s is not None and net is not None:
                self._window(net, rec, period_s)
            used = [rec.start]
            for pair in rec.inputs:
                used.extend(pair)
            if rec.prev_end is not None:
                used.append(rec.prev_end)  # this record was its last reader
            self.give_events(tl.device, used)

    @staticmethod
    def dispatch_times(rec: _Dispatch) -> tuple:
        """A completed record's (device, input stall, host gap, period) in
        seconds; the period (E − the previous E) is None where there is
        no previous E, and the host gap then 0."""
        device_s = rec.start.elapsed_time(rec.end) * 1e-3
        stall_s = sum(a.elapsed_time(b) for a, b in rec.inputs) * 1e-3
        if rec.prev_end is None:
            return device_s, stall_s, 0.0, None
        gap_s = max(0.0, rec.prev_end.elapsed_time(rec.start) * 1e-3 - stall_s)
        return device_s, stall_s, gap_s, rec.prev_end.elapsed_time(rec.end) * 1e-3

    def _window(self, net, rec: _Dispatch, period_s: float) -> None:
        """Add a resolved dispatch's period to the net's sample window (a
        window holds one fit's dispatches) and publish every
        `sample_every`-th."""
        st = self._state(net)
        if st.get("fit") is not rec.fit:
            st.update(fit=rec.fit, window_s=0.0, examples=0, steps=0, dispatches=0)
        st["window_s"] += period_s
        st["examples"] += rec.examples
        st["steps"] += rec.steps
        st["dispatches"] += 1
        se = self.sample_every
        if se > 0 and st["dispatches"] >= se:
            self._publish_window(net, st)

    def _publish_window(self, net, st: dict) -> None:
        if st.get("window_s", 0.0) > 0:
            self._publish(net, st, st["window_s"], st["steps"], st["examples"])
        st.update(window_s=0.0, examples=0, steps=0, dispatches=0)

    def sample_now(self, net, score=None) -> None:
        """Force one sample outside the cadence (tests; end-of-fit). A
        CUDA net publishes its window so far, from its completed
        dispatches."""
        tl = getattr(net, "_dispatch_timeline", None)
        if tl is not None:
            self._resolve(tl)
            self._publish_window(net, self._state(net))
            return
        self._sample(net, self._state(net), score)

    @staticmethod
    def _state(net) -> dict:
        st = getattr(net, "_devprof_state", None)
        if st is None:
            st = net._devprof_state = {
                "dispatches": 0, "examples": 0, "last_t": None,
                "iter_at_last": None,
                "params_bytes": None, "updater_bytes": None,
            }
        return st

    def _sample(self, net, st: dict, score) -> None:
        """A CPU net's sample: the host clock since the last one."""
        now = time.perf_counter()
        last = st["last_t"]
        iteration = int(getattr(net, "iteration", 0))
        window_examples = st["examples"]
        dt, steps = 0.0, 0
        if last is not None and now > last and window_examples > 0:
            dt = now - last
            # optimizer steps, NOT dispatches: one fused/TBPTT dispatch
            # advances the iteration counter by its whole segment count,
            # and per-step device time must divide by that
            prev_iter = st.get("iter_at_last")
            steps = max(1, iteration - prev_iter) if prev_iter is not None \
                else max(1, st["dispatches"])
        st["last_t"] = now
        st["iter_at_last"] = iteration
        st["examples"] = 0
        self._publish(net, st, dt, steps, window_examples)

    def _publish(self, net, st: dict, dt: float, steps: int, examples: int) -> None:
        """The step gauges from a window of `dt` seconds, `steps`
        optimizer steps and `examples` examples (none when dt is 0), then
        the memory watermarks and the tenant's charge."""
        ins = self._instruments()
        if dt > 0:
            per_example, source = net.model_flops_per_example()
            ins["step_seconds"].labels().set(dt / steps)
            if per_example:
                # per chip: a mesh-attached net consumes the global batch
                # across n data shards
                fps = per_example * examples / dt / _data_shards_of(net)
                ins["fps"].labels(source).set(fps)
                from deeplearning4j_tpu_torch.utils.flops import peak_flops_per_chip

                peak = peak_flops_per_chip(_net_device(net))
                if peak:
                    ins["mfu"].labels(source).set(fps / peak)
            ins["samples"].inc()
        self.poll_memory(net, st)
        if dt > 0:
            # tenant chip-budget attribution rides the same measured
            # window, after poll_memory so the cached params/updater byte
            # sums exist
            _resourcemeter.note_device_window(net, dt, examples=examples)

    # -- memory watermarks ---------------------------------------------------

    def poll_memory(self, net=None, st: Optional[dict] = None) -> dict:
        """Refresh the `device_memory_bytes{kind}` gauges. Cheap:
        params/updater byte sums are cached per net (their shapes are
        static for a fit); `live` reads the CUDA allocator."""
        ins = self._instruments()
        out = {}
        if net is not None:
            if st is None:
                st = getattr(net, "_devprof_state", None) or {}
            pb = st.get("params_bytes")
            if pb is None:
                pb = st["params_bytes"] = _tree_bytes(net.params_list)
                st["updater_bytes"] = _tree_bytes(net.upd_state)
            out["params"] = pb
            out["updater"] = st.get("updater_bytes", 0)
            attached = getattr(net, "_cost_model_meta", None)
            if attached and attached.get("activation_peak_bytes"):
                # activations are batch-sharded on a mesh-attached net
                out["activations_est"] = (attached["activation_peak_bytes"]
                                          // _data_shards_of(net))
        live = device_bytes_in_use(_net_device(net) if net is not None else None)
        if live is not None:
            out["live"] = live
        for kind, v in out.items():
            ins["memory"].labels(kind).set(float(v))
        return out

    # -- OOM forensics -------------------------------------------------------

    def oom_forensics(self, where: str, exc: BaseException,
                      net=None) -> Optional[str]:
        """A device out-of-memory error escaped a hot path: record the
        largest live tensors and the static memory picture, then dump
        the flight recorder. Returns the dump path (None when the dump
        itself failed — never raises; the OOM is the story)."""
        try:
            ins = self._instruments()
            ins["oom"].labels(where).inc()
            device = _net_device(net) if net is not None else None
            top = largest_live_buffers(device=device)
            static = {}
            if net is not None:
                try:
                    static["params_bytes"] = _tree_bytes(net.params_list)
                    static["updater_bytes"] = _tree_bytes(net.upd_state)
                except Exception:
                    pass
                meta = getattr(net, "_cost_model_meta", None)
                if meta is None:
                    # no model attached: one trace on fake tensors now (no
                    # device memory), CACHED on the net — a serving-path
                    # OOM (the process survives, clients retry) must not
                    # re-trace per failing request. Failures cache too.
                    try:
                        from deeplearning4j_tpu_torch.analysis.costmodel import (
                            train_step_cost,
                        )

                        cm = train_step_cost(net, batch_size=2)
                        meta = {
                            "activation_peak_bytes": cm.activation_peak_bytes,
                            "resident_bytes": cm.resident_bytes,
                            "largest_activation": cm.largest_activation,
                            "source": "costmodel(post-hoc, batch=2)",
                        }
                    except Exception:
                        meta = {"source": "unavailable"}
                    try:
                        net._cost_model_meta = meta
                    except Exception:
                        pass
                if meta and meta.get("source") != "unavailable":
                    static["activation_peak_bytes"] = meta.get(
                        "activation_peak_bytes")
                    static["largest_activation"] = meta.get(
                        "largest_activation")
                    static["flops_source"] = meta.get("source")
            live = device_bytes_in_use(device)
            if live is not None:
                static["live_bytes"] = live
            rec = _blackbox.get_recorder()
            rec.record_event("oom", where=where,
                             error=str(exc)[:400],
                             top_buffers=top, static=static)
            return rec.dump(reason=f"out of memory in {where}: "
                                   f"{str(exc)[:200]}")
        except Exception:
            logger.exception("OOM forensics failed")
            return None


# -- the process-global profiler ----------------------------------------------

_PROFILER = DeviceProfiler()


def get_profiler() -> DeviceProfiler:
    return _PROFILER


def configure(sample_every: int) -> DeviceProfiler:
    return _PROFILER.configure(sample_every)


def oom_forensics(where: str, exc: BaseException, net=None) -> Optional[str]:
    return _PROFILER.oom_forensics(where, exc, net=net)


def recent_fits() -> List[dict]:
    return _PROFILER.recent_fits()

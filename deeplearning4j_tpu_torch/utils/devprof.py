"""Always-on device performance & memory accounting, the port of the JAX
package's utils/devprof.py: the runtime half of the device observability
layer (analysis/costmodel.py is the static half; each checks the other).

The fit loop's host-side phase timers can say the host is not the
bottleneck, but every *device*-side number — step time, MFU, FLOP/s —
would otherwise exist only in benchmark runs. This module makes them
first-class, always-on series at fixed cost:

* **Sampled device time**: every `sample_every`-th dispatch the profiler
  runs ONE `torch.cuda.synchronize` on the device of that step's score;
  wall time between consecutive samples divided by the optimizer steps
  in between is the per-step device-visible time. Unsampled steps cost
  two integer ops — the asynchronous launch queue never drains between
  samples. Under the CPU tests sampling is OFF (`configure(sample_every=0)`
  in each devprof-sensitive test file) so their timing stays stable.
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
import logging
import os
import threading
import time
from typing import List, Optional

import torch

from deeplearning4j_tpu_torch.utils import blackbox as _blackbox
from deeplearning4j_tpu_torch.utils import metrics as _metrics
from deeplearning4j_tpu_torch.utils import resourcemeter as _resourcemeter

logger = logging.getLogger("deeplearning4j_tpu_torch")

# every Nth fit dispatch pays one device synchronize; 0 disables the
# sampled sync entirely
DEFAULT_SAMPLE_EVERY = int(os.environ.get("DL4J_DEVPROF_SAMPLE_EVERY", "16"))

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


class DeviceProfiler:
    """Process-global step accounting. One instance (`get_profiler()`);
    per-net sampling state lives on the net (`net._devprof_state`) so
    concurrent fits never share a window."""

    def __init__(self, sample_every: Optional[int] = None):
        self.sample_every = (DEFAULT_SAMPLE_EVERY if sample_every is None
                             else int(sample_every))
        self._ins = None
        self._lock = threading.Lock()

    def configure(self, sample_every: int) -> "DeviceProfiler":
        """0 disables the sampled device sync (the repo's 0-disables
        convention); the memory/MFU gauges then only move when a sample
        is forced (`sample_now`)."""
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
                            "sampled device-synchronize device-time "
                            "measurements").labels(),
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

    # -- the fit-loop hook ---------------------------------------------------

    def on_step(self, net, n_examples: int, score) -> None:
        """Called by the fit loop (netbase._timed_fit) after every
        dispatch. Unsampled steps: two integer adds and a modulo."""
        se = self.sample_every
        if se <= 0:
            return
        st = self._state(net)
        st["dispatches"] += 1
        st["examples"] += n_examples
        if st["dispatches"] % se:
            return
        self._sample(net, st, score)

    def sample_now(self, net, score=None) -> None:
        """Force one sample outside the cadence (tests; end-of-fit)."""
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
        ins = self._instruments()
        try:
            if torch.is_tensor(score) and score.is_cuda:
                # the whole device: a fused group's graph replays on a
                # side stream
                torch.cuda.synchronize(score.device)
        except Exception:
            pass  # a failed sync is the step's problem, not the sampler's
        now = time.perf_counter()
        last = st["last_t"]
        iteration = int(getattr(net, "iteration", 0))
        dt = 0.0
        window_examples = st["examples"]
        if last is not None and now > last and st["examples"] > 0:
            dt = now - last
            per_example, source = net.model_flops_per_example()
            # optimizer steps, NOT dispatches: one fused/TBPTT dispatch
            # advances the iteration counter by its whole segment count,
            # and per-step device time must divide by that
            prev_iter = st.get("iter_at_last")
            steps = max(1, iteration - prev_iter) if prev_iter is not None \
                else max(1, st["dispatches"])
            ins["step_seconds"].labels().set(dt / steps)
            if per_example:
                # per chip: a mesh-attached net consumes the global batch
                # across n data shards
                fps = per_example * st["examples"] / dt / _data_shards_of(net)
                ins["fps"].labels(source).set(fps)
                from deeplearning4j_tpu_torch.utils.flops import peak_flops_per_chip

                peak = peak_flops_per_chip(_net_device(net))
                if peak:
                    ins["mfu"].labels(source).set(fps / peak)
            ins["samples"].inc()
        st["last_t"] = now
        st["iter_at_last"] = iteration
        st["examples"] = 0
        self.poll_memory(net, st)
        if dt > 0:
            # tenant chip-budget attribution rides the same measured
            # window (no extra sync), after poll_memory so the cached
            # params/updater byte sums exist
            _resourcemeter.note_device_window(net, dt, examples=window_examples)

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

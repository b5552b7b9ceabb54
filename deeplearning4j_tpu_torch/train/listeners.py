"""Training listeners.

The port of the JAX package's train/listeners.py (reference:
IterationListener/TrainingListener SPI, optimize/api/,
optimize/listeners/): ScoreIterationListener, PerformanceListener
(samples/sec + ETL time), CollectScoresIterationListener,
EvaluativeListener, TracingListener, HealthTransitionListener and
ComposableIterationListener. The listener callback receives a small info
dict; the score is read to the host only when a listener asks for it, so
listeners do not force a device sync on every step. PerformanceListener's
MFU column divides the net's model FLOPs (utils/flops, the analytic
per-layer count) by the card's dense bf16 peak, whatever the net's
precision: an f32 net's MFU is stated against the bf16 peak, as in the
JAX package.
"""

from __future__ import annotations

import logging
import time
from typing import Callable, List, Optional

logger = logging.getLogger("deeplearning4j_tpu_torch")


class IterationListener:
    """SPI (reference: optimize/api/IterationListener.java)."""

    def iteration_done(self, model, iteration: int, info: dict) -> None:
        raise NotImplementedError

    def on_epoch_start(self, model, epoch: int) -> None:
        pass

    def on_epoch_end(self, model, epoch: int) -> None:
        pass

    def on_fit_end(self, model) -> None:
        """Called when the fit loop exits — INCLUDING on an exception
        (netbase runs it in a finally). The hook for restoring any
        process-global state a listener flipped for the run."""
        pass


class ScoreIterationListener(IterationListener):
    """Log the score every `frequency` iterations (reference:
    optimize/listeners/ScoreIterationListener.java)."""

    def __init__(self, frequency: int = 10, print_fn: Optional[Callable] = None):
        self.frequency = max(1, frequency)
        self.print_fn = print_fn or (lambda s: logger.info(s))

    def iteration_done(self, model, iteration, info):
        if iteration % self.frequency == 0:
            score = float(info["score"]())
            self.print_fn(f"Score at iteration {iteration} is {score}")


class PerformanceListener(IterationListener):
    """Throughput listener (reference: PerformanceListener.java — iterations
    /sec, samples/sec, ETL time), plus the window's MFU on the card."""

    def __init__(self, frequency: int = 10, print_fn: Optional[Callable] = None):
        self.frequency = max(1, frequency)
        self.print_fn = print_fn or (lambda s: logger.info(s))
        self._last_time = None
        self._samples = 0
        self._iters = 0
        self._etl_ms = 0.0
        self._fit_examples = None  # registry child, resolved lazily
        self._win_examples0 = None  # counter value at window start

    def iteration_done(self, model, iteration, info):
        now = time.perf_counter()
        self._samples += info.get("batch_size", 0)
        self._iters += 1
        # accumulate the fit loop's per-batch data-wait measurement so the
        # printed ETL is the window's average, not whatever the last batch
        # happened to block for (reference: PerformanceListener.java
        # reports real ETL time per window)
        self._etl_ms += info.get("etl_ms", 0.0)
        if self._last_time is None:
            self._last_time = now
            self._win_examples0 = self._fit_examples_total()
            return
        if self._iters % self.frequency == 0:
            dt = now - self._last_time
            if dt > 0:
                msg = (
                    f"iter {iteration}: {self._iters / dt:.1f} it/s, "
                    f"{self._samples / dt:.1f} samples/s, "
                    f"etl {self._etl_ms / self._iters:.1f} ms/iter"
                )
                mfu = self._window_mfu(model, dt)
                if mfu is not None:
                    # the FLOP source labelled as devprof's step_mfu{source}
                    msg += f", mfu {mfu[0]:.4g} ({mfu[1]})"
                self.print_fn(msg)
            self._last_time = now
            self._samples = 0
            self._iters = 0
            self._etl_ms = 0.0
            self._win_examples0 = self._fit_examples_total()

    def _fit_examples_total(self):
        """The fit loop's own once-per-batch example counter — NOT the
        per-callback tally: TBPTT fires iteration_done once per segment
        with the full batch size, so `self._samples` over-counts by the
        segment count and must never feed the MFU arithmetic. (The
        counter is process-global: a second net fitting concurrently in
        the same process would inflate this window's MFU.)"""
        from deeplearning4j_tpu_torch.utils.metrics import get_registry

        child = self._fit_examples
        if child is None:
            child = self._fit_examples = get_registry().counter(
                "fit_examples_total").labels()
        return child.value

    def _window_mfu(self, model, dt: float):
        """(window-averaged MFU, FLOP source) from the net's model FLOPs
        over the card's dense bf16 peak; the source is "costmodel" once a
        step cost model is attached (`attach_cost_model`), else
        "analytic", as devprof labels `step_mfu{source}`. None on the CPU
        (a peak MFU against a host is noise), for a net with no FLOP
        count, or on a card the peak table does not know."""
        per_example = getattr(model, "model_flops_per_example", None)
        device = getattr(model, "device", None)
        if per_example is None or self._win_examples0 is None \
                or device is None or device.type == "cpu":
            return None
        flops, source = per_example()
        if not flops:
            return None
        from deeplearning4j_tpu_torch.utils.flops import peak_flops_per_chip

        peak = peak_flops_per_chip(device)
        if not peak:
            return None
        return ((self._fit_examples_total() - self._win_examples0) * flops
                / dt / peak, source)


class CollectScoresIterationListener(IterationListener):
    """Accumulate (iteration, score) pairs (reference:
    CollectScoresIterationListener.java)."""

    def __init__(self, frequency: int = 1):
        self.frequency = max(1, frequency)
        self.scores: List[tuple] = []

    def iteration_done(self, model, iteration, info):
        if iteration % self.frequency == 0:
            self.scores.append((iteration, float(info["score"]())))


class EvaluativeListener(IterationListener):
    """Periodically evaluate on a held-out set (reference:
    EvaluativeListener.java)."""

    def __init__(self, data_iterator, frequency: int = 100, print_fn=None):
        self.iterator = data_iterator
        self.frequency = max(1, frequency)
        self.print_fn = print_fn or (lambda s: logger.info(s))
        self.last_evaluation = None

    def iteration_done(self, model, iteration, info):
        if iteration > 0 and iteration % self.frequency == 0:
            ev = model.evaluate(self.iterator)
            self.last_evaluation = ev
            self.print_fn(f"iter {iteration}: accuracy={ev.accuracy():.4f}")


class TracingListener(IterationListener):
    """Turn on the host-side span tracer for a training run and export
    the buffer at epoch ends — training jobs get the same span
    visibility as serving (`InferenceServer GET /trace`), through the
    listener SPI instead of an HTTP route.

    With tracing enabled, the fit loop itself emits the `fit/step` /
    `fit/dispatch` / `fit/device_sync` spans (nn/netbase.py, each also a
    `torch.profiler.record_function` range); this
    listener adds an `iteration` instant per step (iteration number +
    batch size) and writes `jsonl_path` / `chrome_path` after each epoch
    so a killed run still leaves a trace artifact behind.

    Tracing is enabled at each epoch start and restored to its prior
    state at each epoch end (pass restore_on_epoch_end=False to leave it
    on between/after epochs). Construction alone changes nothing — the
    tracing flag is process-global and flipping it permanently would
    impose the per-step device sync on every OTHER net in the process."""

    def __init__(self, jsonl_path: Optional[str] = None,
                 chrome_path: Optional[str] = None,
                 restore_on_epoch_end: bool = True):
        from deeplearning4j_tpu_torch.utils import tracing

        self._tracing = tracing
        self.jsonl_path = jsonl_path
        self.chrome_path = chrome_path
        self._restore = restore_on_epoch_end
        self._was_enabled: Optional[bool] = None

    def iteration_done(self, model, iteration, info):
        self._tracing.instant("iteration", iteration=iteration,
                              batch_size=info.get("batch_size"))

    def on_epoch_start(self, model, epoch):
        if self._was_enabled is None:  # prior state, captured at run start
            self._was_enabled = self._tracing.is_enabled()
        self._tracing.enable(True)

    def on_epoch_end(self, model, epoch):
        tracer = self._tracing.get_tracer()
        if self.jsonl_path:
            tracer.write_jsonl(self.jsonl_path)
        if self.chrome_path:
            tracer.write_chrome_trace(self.chrome_path)
        if self._restore:
            self._tracing.enable(bool(self._was_enabled))

    def on_fit_end(self, model):
        # runs in the fit loop's finally: a fit that raises mid-epoch
        # must still restore the process-global flag (and leave the
        # artifacts covering what WAS captured) — otherwise every other
        # net in the process inherits per-step device syncs forever
        if self._was_enabled is None:
            return  # fit never started an epoch
        if self.jsonl_path:
            self._tracing.get_tracer().write_jsonl(self.jsonl_path)
        if self.chrome_path:
            self._tracing.get_tracer().write_chrome_trace(self.chrome_path)
        if self._restore:
            self._tracing.enable(bool(self._was_enabled))


class HealthTransitionListener(IterationListener):
    """Forward watchdog health transitions (utils/health — component
    degraded/recovered events) into the stats-storage path, so the UI
    layer sees degradation HISTORY, not just the current
    `component_health` gauge value.

    Cursor-based: each `iteration_done` drains transitions newer than
    the last seen sequence number and routes them as one update record
    (`{"health_transitions": [...]}`) through the same
    `ui/storage.StatsStorageRouter` that `ui/stats.StatsListener` uses;
    `on_fit_end` drains once more so a transition during the final
    partial window still lands. With no
    router it degrades to the package logger — degradations are never
    silent."""

    def __init__(self, router=None, session_id: Optional[str] = None):
        import uuid

        from deeplearning4j_tpu_torch.utils.health import get_health

        self._health = get_health()
        self.router = router
        self.session_id = session_id or f"session-{uuid.uuid4().hex[:8]}"
        # start the cursor NOW: transitions from before this run belong
        # to whatever run recorded them
        self._seq = self._health.last_seq()

    def _drain(self, iteration: int):
        new = self._health.transitions_since(self._seq)
        if not new:
            return
        self._seq = max(t["seq"] for t in new)
        if self.router is not None:
            from deeplearning4j_tpu_torch.utils.health import LEVELS

            # health_level carries the numeric end-state per component:
            # the binary stats codec (ui/codec) drops string leaves, so
            # the component-keyed numeric map is what survives
            # FileStatsStorage/remote routing; the raw transition dicts
            # ride along for in-memory/dashboard consumers
            self.router.put_update(self.session_id, {
                "iteration": int(iteration),
                "ts": time.time(),
                "health_transitions": new,
                "health_level": {t["component"]: LEVELS[t["to"]]
                                 for t in new},
            })
        for t in new:
            # condition transitions (set_condition) carry no stall age;
            # the JAX package's listener raises KeyError on them
            logger.info("health: %s %s -> %s (stalled %.3fs)",
                        t["component"], t["from"], t["to"],
                        t.get("stalled_for_seconds", 0.0))

    def iteration_done(self, model, iteration, info):
        self._drain(iteration)

    def on_fit_end(self, model):
        self._drain(getattr(model, "iteration", 0))


class ComposableIterationListener(IterationListener):
    def __init__(self, *listeners):
        self.listeners = list(listeners)

    def iteration_done(self, model, iteration, info):
        for listener in self.listeners:
            listener.iteration_done(model, iteration, info)

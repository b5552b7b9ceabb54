"""Shared network machinery, the port of the JAX package's nn/netbase.py:
lazy init, the shape-keyed forward cache with its counter, the flattened
parameter view (params()/setParams(), reference:
MultiLayerNetwork.java:102-104 flattenedParams), listeners, and the fit
loop (`_run_fit` -> `_fit_epochs` -> `_timed_fit` -> the subclass's
`_fit_dataset`) with its four registry instruments. Resume, the
divergence sentinel, mesh, fused multi-batch steps, health, run ledger
and the staged prefetch pipeline are not ported yet.
"""

from __future__ import annotations

import threading
import time
from typing import List

from deeplearning4j_tpu_torch.nn.params import (
    flat_to_params,
    num_params,
    param_table,
    params_to_flat,
)
from deeplearning4j_tpu_torch.utils import metrics as _metrics


class NetworkBase:
    """Common network state and loops. Subclasses implement `init()`,
    `_fit_dataset(ds)` (one optimizer step or a TBPTT segment loop) and
    `_ordered_layer_confs()` (layer configs aligned with params_list)."""

    def __init__(self):
        self.listeners = []
        self.iteration = 0
        self.epoch = 0
        self.params_list = None
        self.state_list = None
        self.upd_state = None
        self._score = None  # last minibatch score (device tensor, lazy read)
        # [loss, raw global gradient norm] of the last optimizer step
        self._step_diag = None
        # the fit instruments, resolved from the registry once per network
        self._fit_instruments = None
        # forward functions built by `output()` / `rnn_time_step` so far,
        # one per (kind, input shape, dtype) key. PyTorch runs eagerly, so
        # an entry is a closure, not a compiled program; the count keeps
        # the JAX package's meaning — growth under traffic means shape
        # churn — so serving layers can read the same number.
        self._output_fn = None
        self._output_compiles = 0
        self._output_cache_lock = threading.Lock()

    # -- to be provided by subclasses ----------------------------------------

    def init(self):
        raise NotImplementedError

    def _ordered_layer_confs(self) -> List:
        """Layer configs in flattening order, aligned with params_list."""
        raise NotImplementedError

    def _require_init(self):
        if self.params_list is None:
            self.init()

    def _fit_dataset(self, ds):
        raise NotImplementedError

    # -- listeners -----------------------------------------------------------

    def set_listeners(self, *listeners):
        self.listeners = list(listeners)
        return self

    def add_listener(self, listener):
        self.listeners.append(listener)
        return self

    def _notify(self, batch_size):
        if not self.listeners:
            return
        info = {"score": lambda: self._score, "batch_size": batch_size}
        for lst in self.listeners:
            lst.iteration_done(self, self.iteration - 1, info)

    # -- the fit loop --------------------------------------------------------

    def _fit_obs(self):
        """The fit-loop instruments from the shared registry, resolved once
        per network, so the per-step path touches no registry lookup."""
        ins = self._fit_instruments
        if ins is None:
            reg = _metrics.get_registry()
            ins = self._fit_instruments = {
                "steps": reg.counter(
                    "fit_step_total", "optimizer steps run").labels(),
                "examples": reg.counter(
                    "fit_examples_total",
                    "training examples consumed").labels(),
                "data_wait": reg.histogram(
                    "fit_data_wait_seconds",
                    "time blocked on the data iterator (ETL) before a "
                    "dispatch").labels(),
                "dispatch": reg.histogram(
                    "fit_dispatch_seconds",
                    "host time in the train-step call (launches; "
                    "excludes device sync)").labels(),
            }
        return ins

    def _timed_fit(self, fit_fn, data_wait: float, n_examples: int):
        """Run one `_fit_dataset` under the step-phase timers: data wait
        and dispatch, each a histogram in the shared registry, plus the
        step and example counters. PyTorch returns before the device
        finishes, so the dispatch time is host time, as in the JAX
        package."""
        ins = self._fit_obs()
        it0 = self.iteration
        t0 = time.perf_counter()
        fit_fn()
        dispatch = time.perf_counter() - t0
        ins["steps"].inc(max(1, self.iteration - it0))
        ins["examples"].inc(n_examples)
        ins["data_wait"].observe(data_wait)
        ins["dispatch"].observe(dispatch)

    def _run_fit(self, iterator, epochs: int):
        try:
            self._fit_epochs(iterator, epochs)
        finally:
            # fires even when an epoch raises: listeners that flipped
            # process-global state for the run restore it here
            for lst in self.listeners:
                hook = getattr(lst, "on_fit_end", None)
                if hook is not None:
                    hook(self)
        return self

    def _fit_epochs(self, iterator, epochs: int):
        for _ in range(epochs):
            for lst in self.listeners:
                lst.on_epoch_start(self, self.epoch)
            t_etl = time.perf_counter()
            for ds in iterator:
                wait = time.perf_counter() - t_etl
                self._timed_fit(lambda: self._fit_dataset(ds), wait,
                                ds.num_examples())
                t_etl = time.perf_counter()
            for lst in self.listeners:
                lst.on_epoch_end(self, self.epoch)
            self.epoch += 1
            iterator.reset()

    @property
    def output_compile_count(self) -> int:
        """Forward functions built by `output()`/`rnn_time_step` so far —
        one per distinct (kind, input shape/dtype) key."""
        return self._output_compiles

    def _cached_output_fn(self, key, make_fn):
        """Shape-keyed get-or-insert into the forward cache, bumping
        `output_compile_count` on insert. Under a lock so concurrent misses
        on one key produce ONE entry."""
        with self._output_cache_lock:
            if not isinstance(self._output_fn, dict):
                self._output_fn = {}
            fn = self._output_fn.get(key)
            if fn is None:
                fn = self._output_fn[key] = make_fn()
                self._output_compiles += 1
                self._note_compile("output", key)
            return fn

    def _note_compile(self, kind: str, key=None):
        """Record a forward-cache insertion as `compile_total{kind}` in the
        shared registry."""
        _metrics.get_registry().counter(
            "compile_total", "forward-cache insertions (new shapes)",
            ("kind",)).labels(kind).inc()

    # -- flattened params API ------------------------------------------------

    def params(self):
        """Flattened parameter vector (reference: Model.params())."""
        self._require_init()
        return params_to_flat(self._ordered_layer_confs(), self.params_list)

    def set_params(self, flat):
        self._require_init()
        self.params_list = flat_to_params(
            self._ordered_layer_confs(), self.params_list, flat
        )

    def num_params(self) -> int:
        self._require_init()
        return num_params(self._ordered_layer_confs(), self.params_list)

    def param_table(self):
        self._require_init()
        return param_table(self._ordered_layer_confs(), self.params_list)

    def summary(self) -> str:
        self._require_init()
        lines = ["=" * 70]
        total = 0
        for i, (conf, p) in enumerate(
            zip(self._ordered_layer_confs(), self.params_list)
        ):
            n = sum(v.numel() for v in p.values())
            total += n
            lines.append(f"{i:>3}  {type(conf).__name__:<28} params: {n}")
        lines.append(f"total params: {total}")
        lines.append("=" * 70)
        return "\n".join(lines)

"""Shared network machinery, the port of the JAX package's nn/netbase.py:
lazy init, the shape-keyed forward cache with its counter, the flattened
parameter view (params()/setParams(), reference:
MultiLayerNetwork.java:102-104 flattenedParams), listeners, and the fit
loop (`_run_fit` -> `_fit_epochs` -> `_timed_fit` -> the subclass's
`_fit_dataset`) with its four registry instruments, and the eager
optimizer step both networks share (`_run_step` -> `_step`: autograd, the
gradient tail and the updater). Resume, the divergence sentinel, mesh,
fused multi-batch steps, health, run ledger and the staged prefetch
pipeline are not ported yet.
"""

from __future__ import annotations

import threading
import time
from typing import List

import numpy as np
import torch

from deeplearning4j_tpu_torch.nn.conf import layers as L
from deeplearning4j_tpu_torch.nn.params import (
    flat_to_params,
    num_params,
    param_table,
    params_to_flat,
)
from deeplearning4j_tpu_torch.train.updaters import normalize_gradients, schedule_lr
from deeplearning4j_tpu_torch.utils import metrics as _metrics


def _regularizable(name: str) -> bool:
    """Weight-style params get l1/l2; biases and batchnorm affine params do
    not (reference: each ParamInitializer flags regularizable params)."""
    if name in ("gamma", "beta"):
        return False
    return name.rsplit("_", 1)[-1] in ("W", "RW", "pI", "pF", "pO")


def _detached(states):
    return [None if st is None else {k: v.detach() for k, v in st.items()}
            for st in states]


def _layer_seed(seed: int, i: int) -> int:
    """Per-layer generator seed: layer i's draws do not depend on how many
    numbers earlier layers drew (the role jax.random.fold_in plays in the
    JAX package)."""
    return (int(seed) * 1_000_003 + i) % (2 ** 63)


class NetworkBase:
    """Common network state and loops. Subclasses implement `init()`,
    `_fit_dataset(ds)` (one optimizer step or a TBPTT segment loop),
    `_ordered_layer_confs()` (layer configs aligned with params_list) and
    `_merge_states`, and set `device`, `net_conf` and `updater_def`."""

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

    def _as_input(self, x) -> torch.Tensor:
        if torch.is_tensor(x):
            return x.to(self.device)
        return torch.as_tensor(np.asarray(x), device=self.device)

    def _as_data(self, a):
        """A batch array on the device; float64 arrives as float32, as
        jnp.asarray gives it to the JAX package."""
        if a is None:
            return None
        t = self._as_input(a)
        return t.float() if t.dtype == torch.float64 else t

    # -- the optimizer step --------------------------------------------------

    def _reg_penalty(self, params):
        """L1/L2 penalties (reference: BaseLayer.calcL1/calcL2 added to the
        score; their gradients come from differentiating this expression)."""
        reg = 0.0
        for conf, p in zip(self._ordered_layer_confs(), params):
            inner = conf.inner if isinstance(conf, L.FrozenLayer) else conf
            l1 = getattr(inner, "l1", 0.0) or 0.0
            l2 = getattr(inner, "l2", 0.0) or 0.0
            if l1 == 0.0 and l2 == 0.0:
                continue
            for name, w in p.items():
                if _regularizable(name):
                    if l1:
                        reg = reg + l1 * w.abs().sum()
                    if l2:
                        reg = reg + 0.5 * l2 * (w * w).sum()
        return reg

    def _lr_mult_tree(self):
        """Per-leaf learning-rate multiplier (per-layer learning_rate and
        bias_learning_rate overrides, reference: layer conf learningRate)."""
        base = self.net_conf.learning_rate
        out = []
        for conf, p in zip(self._ordered_layer_confs(), self.params_list):
            inner = conf.inner if isinstance(conf, L.FrozenLayer) else conf
            layer_lr = getattr(inner, "learning_rate", None)
            bias_lr = getattr(inner, "bias_learning_rate", None)
            mult = {}
            for name in p:
                if name == "b" and bias_lr is not None:
                    mult[name] = bias_lr / base
                elif layer_lr is not None:
                    mult[name] = layer_lr / base
                else:
                    mult[name] = 1.0
            out.append(mult)
        return out

    def _trainable_mask(self):
        return [{k: (0.0 if isinstance(conf, L.FrozenLayer) else 1.0) for k in p}
                for conf, p in zip(self._ordered_layer_confs(), self.params_list)]

    def _step(self, loss_builder, states, data, lr: float, t: float, rng):
        """One optimizer step, eagerly: the loss and its gradients by
        autograd, then the shared tail — the diagnostic, trainable mask,
        gradient normalization, per-leaf lr and the updater, which adds its
        deltas to the parameters in place. Returns (merged states, score).
        `self._step_diag` holds [loss, raw global gradient norm] (before
        masking or clipping, in f32), as the JAX step's `diag`."""
        params = self.params_list
        leaves = [v for p in params for v in p.values()]
        for v in leaves:
            v.requires_grad_(True)
        try:
            score, new_states = loss_builder(params, states, data, rng)
            flat = iter(torch.autograd.grad(score, leaves))
        finally:
            for v in leaves:
                v.requires_grad_(False)
        score = score.detach()
        grads = [{k: next(flat) for k in p} for p in params]
        with torch.no_grad():
            # leaves in sorted-key order per layer, as jax.tree_util walks
            gsq = sum(g[k].float().square().sum() for g in grads for k in sorted(g))
            self._step_diag = torch.stack([score.float(), torch.sqrt(gsq)])
            if not self.net_conf.minimize:
                grads = [{k: -v for k, v in g.items()} for g in grads]
            grads = [{k: g[k] * m[k] for k in g}
                     for g, m in zip(grads, self._trainable_mask())]
            grads = normalize_gradients(
                grads, self.net_conf.gradient_normalization,
                self.net_conf.gradient_normalization_threshold)
            lr_tree = [{k: lr * m[k] for k in g}
                       for g, m in zip(grads, self._lr_mult_tree())]
            self.updater_def.step_(params, grads, self.upd_state, lr_tree, t)
        return _detached(self._merge_states(states, new_states)), score

    def _run_step(self, loss_builder, data, stateful_states=None):
        lr = schedule_lr(self.net_conf, self.iteration)
        # the step's generator: seed ^ 0x5EED with the iteration folded in
        rng = torch.Generator(device=self.device).manual_seed(
            ((self.net_conf.seed ^ 0x5EED) * 1_000_003 + self.iteration) % (2 ** 63))
        states = stateful_states if stateful_states is not None else self.state_list
        states, score = self._step(loss_builder, states, data, lr,
                                   float(self.iteration), rng)
        self._score = score
        self.iteration += 1
        return states, score

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

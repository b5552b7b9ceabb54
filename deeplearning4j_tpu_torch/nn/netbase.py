"""Shared network machinery, the port of the JAX package's nn/netbase.py:
lazy init, the shape-keyed forward cache with its counter, the flattened
parameter view (params()/setParams(), reference:
MultiLayerNetwork.java:102-104 flattenedParams), listeners, and the fit
loop (`_run_fit` -> `_fit_epochs` -> `_timed_fit` -> the subclass's
`_fit_dataset`) with its registry instruments, heartbeat, spans, fault
point and flight-recorder step record, mid-epoch resume from a checkpoint
directory (`train_state`, `_restore_for_resume`, the skip-replay in
`_fit_epochs`), the optimizer step both networks share (`_run_step` ->
`_step`: autograd, the gradient tail and the updater), and the fused
dispatch: `set_fused_steps(k)` groups up to k same-shape batches, and a
fused group (k batches, or one TBPTT batch's segments) runs as one
program (`_run_fused`): a plain loop of `_step`s on the CPU, one CUDA
graph on the card, captured from the second group of a signature on and
replayed after it. The staged input pipeline (`_stage_input_pipeline`:
a host prefetch thread, then data/prefetch.DevicePrefetchIterator) feeds
the loop under `fit(async_prefetch=True)`. The divergence sentinel
(train/sentinel.py, `set_sentinel`) judges each dispatch after it ran:
an anomalous step is undone in place and its batch quarantined, and a
streak of them rolls the fit back to the last good checkpoint
(`_rollback_restore`). `set_collect_stats` computes per-layer mean
magnitudes inside the step. `set_mesh` makes the step data-parallel over
a process mesh (parallel/sharded.py): each rank's batch is its rows of
the global batch (sharded in the host prefetch stage, before grouping),
its loss is its share of the global-batch loss, and its gradients and
score are summed over the data axis right after autograd. `fit(run_ledger=)`
attaches a run ledger (utils/runledger) for the fit's duration, and each
dispatch notes its step to it (one module-global read with none
attached). Each dispatch also reaches the device profiler
(utils/devprof): on a CUDA net it is bracketed by two timing events and
its batches carry the input pipeline's, which later dispatches resolve
without waiting into the card's time, input stall and host gap a
dispatch; the fit loop synchronizes nothing, with the tracer off or on,
but where a fused program's graph is captured (once a program).
A device out-of-memory error escaping the fit gets its forensics (the
largest live tensors beside the static estimate, in a flight-recorder
dump) before it propagates. The loop's phases are spans (utils/tracing,
named to any active torch.profiler capture even with the tracer off):
`fit/data_wait` (a batch's pull), then `fit/step` over `fit/dispatch`
(`fit/stage_inputs`, `fit/launch` with its `mode`, `fit/collect`) and
`fit/books` (everything the loop records after the dispatch).
`attach_cost_model` adopts a step cost model (analysis/costmodel) as the
net's FLOP and memory accounting, and `doctor()` runs the static
analysis (analysis/shapeflow and the step audit).
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.nn.conf import layers as L
from deeplearning4j_tpu_torch.data.iterators import AsyncDataSetIterator
from deeplearning4j_tpu_torch.nn.params import (
    flat_to_params,
    num_params,
    param_table,
    params_to_flat,
)
from deeplearning4j_tpu_torch.ops import fused_conv_bn as _fused_conv_bn
from deeplearning4j_tpu_torch.ops import fused_lstm as _fused_lstm
from deeplearning4j_tpu_torch.ops import fused_ssd as _fused_ssd
from deeplearning4j_tpu_torch.ops import fused_updater as _fused_updater
from deeplearning4j_tpu_torch.ops import helpers as _helpers
from deeplearning4j_tpu_torch.ops.activations import sign_abs
from deeplearning4j_tpu_torch.parallel import mesh as _pmesh
from deeplearning4j_tpu_torch.train import sentinel as _sentinel
from deeplearning4j_tpu_torch.train.updaters import normalize_gradients, schedule_lr
from deeplearning4j_tpu_torch.utils import blackbox as _blackbox
from deeplearning4j_tpu_torch.utils import devprof as _devprof
from deeplearning4j_tpu_torch.utils import faultpoints as _faults
from deeplearning4j_tpu_torch.utils import health as _health
from deeplearning4j_tpu_torch.utils import locktrace as _locktrace
from deeplearning4j_tpu_torch.utils import metrics as _metrics
from deeplearning4j_tpu_torch.utils import resourcemeter as _resourcemeter
from deeplearning4j_tpu_torch.utils import runledger as _runledger
from deeplearning4j_tpu_torch.utils import sigchain as _sigchain
from deeplearning4j_tpu_torch.utils import tracing as _tracing

logger = logging.getLogger("deeplearning4j_tpu_torch")

_END = object()  # an exhausted iterator's pull


# why a CUDA step ran the per-leaf updater tail (`NetworkBase._tail_decline`)
UPDATER_DECLINE_REASONS = ("updater", "normalization", "l1", "stats", "mesh",
                           "frozen_norm", "dtype")


def _regularizable(name: str) -> bool:
    """Weight-style params get l1/l2; biases and batchnorm affine params do
    not (reference: each ParamInitializer flags regularizable params)."""
    if name in ("gamma", "beta"):
        return False
    return name.rsplit("_", 1)[-1] in ("W", "RW", "pI", "pF", "pO")


def _slice_b_weight(n_a: int, n_b: int) -> float:
    """The weight by which a truncated TBPTT score, (lossA * nA + lossB *
    nB) / (nA + nB) with slice A under no_grad, passes the gradient of a
    term that both losses hold (the L2 penalty) to the weights: in f32,
    as autograd rounds it (1 / (nA + nB), then times nB)."""
    return float(np.float32(1.0) / np.float32(n_a + n_b) * np.float32(n_b))


def _l2_grad_share(loss_builder, data) -> float:
    """How much of the L2 term's gradient `loss_builder`'s score passes to
    the weights: its `l2_grad_share(data)` where it has one, else all."""
    share = getattr(loss_builder, "l2_grad_share", None)
    return 1.0 if share is None else share(data)


def _detached(states):
    return [None if st is None else {k: v.detach() for k, v in st.items()}
            for st in states]


def _zero_if_none(g, like):
    return torch.zeros_like(like) if g is None else g


def _is_recurrent(conf) -> bool:
    """A layer whose state is a recurrent carry (h, c): per batch under
    TBPTT, never persisted."""
    inner = conf.inner if isinstance(conf, L.FrozenLayer) else conf
    return isinstance(inner, (L.LSTM, L.GravesLSTM))


def _tensor_leaves(tree):
    """Every tensor of a nest of lists, tuples and dicts, in order."""
    if torch.is_tensor(tree):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensor_leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensor_leaves(v)


def _map_arrays(fn, data):
    """`fn` over every array of a batch's (features, labels, features
    mask, labels mask): each part an array, a list of arrays and Nones (a
    MultiDataSet's), or None."""
    def part(x):
        if x is None:
            return None
        if isinstance(x, list):
            return [None if a is None else fn(a) for a in x]
        return fn(x)

    return tuple(part(x) for x in data)


def _cut_time(data, sl):
    """The time slice `sl` of a batch: 3-d features and labels and 2-d
    masks are cut on axis 1; 2-d labels and 1-d (per-example) masks pass
    whole."""
    def cut(ndim):
        return lambda a: a[:, sl] if a.ndim == ndim else a

    feats, labels, fms, lms = data
    arrays = _map_arrays(cut(3), (feats, labels, None, None))
    masks = _map_arrays(cut(2), (None, None, fms, lms))
    return arrays[:2] + masks[2:]


def _time_steps(data) -> int:
    feats = data[0] if isinstance(data[0], list) else [data[0]]
    return max(f.shape[1] for f in feats if f.ndim == 3)


def _uniform_time(data, T: int) -> bool:
    """Every 3-d feature and label array and every 2-d mask spans T steps."""
    ok = [True]

    def check(ndim):
        def f(a):
            if a.ndim == ndim and a.shape[1] != T:
                ok[0] = False
            return a
        return f

    _map_arrays(check(3), (data[0], data[1], None, None))
    _map_arrays(check(2), (None, None, data[2], data[3]))
    return ok[0]


def _mean_magnitudes(params, grads, updates) -> dict:
    """Per-layer mean |x| of the step's gradients (after normalization,
    as the updater saw them), updates and new parameters (reference:
    BaseStatsListener's mean magnitudes). A frozen layer's gradient and
    update are 0, as in the JAX package's masked step."""
    def mm(tree):
        return [{k: (t[k].abs().mean() if k in t else
                     torch.zeros((), dtype=v.dtype, device=v.device))
                 for k, v in p.items()} for p, t in zip(params, tree)]

    return {"grad_mm": mm(grads), "update_mm": mm(updates),
            "param_mm": mm(params)}


class _Program:
    """One fused group's program on a network, under its key (kind,
    shapes, batches, segments): on a CUDA device its static inputs
    (`io`), whether its eager warm-up ran, its captured graph with the
    launches and helper events the capture recorded (added back on every
    replay), the tensor addresses it was captured on, and what the
    capture cost."""

    def __init__(self, key, io):
        self.key = key
        self.io = io
        self.warm = False
        self.graph = None
        self.lstm_launches: Dict[str, int] = {}
        self.conv_launches: Dict[str, int] = {}
        self.updater_launches: Dict[str, int] = {}
        self.ssd_launches: Dict[str, int] = {}
        self.tail_declines: Dict[str, int] = {}
        self.events: list = []
        self.addresses = None
        self.capture_seconds = None
        self.pool_bytes = None
        self.replays = 0


def _examples_of(ds) -> int:
    """A batch's real example count: under a mesh, the global batch's
    (`reported_examples`), not this rank's padded rows."""
    return int(getattr(ds, "reported_examples", None) or ds.num_examples())


class _ShardingIterator:
    """A host stage of the input pipeline: each batch of `base` cut to this
    rank's rows by the mesh plan (`MeshPlan.shard_batch`), in the thread
    that pulls it."""

    def __init__(self, base, plan):
        self.base = base
        self.plan = plan

    def __iter__(self):
        for ds in self.base:
            yield self.plan.shard_batch(ds)

    def reset(self):
        self.base.reset()

    def __getattr__(self, name):
        return getattr(self.base, name)


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
        self._last_etl_ms = 0.0
        # resume coordinates of the running fit (train_state()); None
        # outside a fit
        self._train_state = None
        # the fit loop's liveness heartbeat and the hang dump it left
        self._fit_heartbeat = None
        self._hang_dump_path = None
        # [loss, raw global gradient norm] of the last optimizer step
        self._step_diag = None
        # per reason, the steps that declined the fused tail while a graph
        # captured (added back on every replay); None outside a capture
        self._tail_declines = None
        # the fit instruments, resolved from the registry once per network
        self._fit_instruments = None
        # a CUDA net's dispatch timing records (utils/devprof)
        self._dispatch_timeline = None
        # forward functions built by `output()` / `rnn_time_step` so far,
        # one per (kind, input shape, dtype) key. PyTorch runs eagerly, so
        # an entry is a closure, not a compiled program; the count keeps
        # the JAX package's meaning — growth under traffic means shape
        # churn — so serving layers can read the same number.
        self._output_fn = None
        self._output_compiles = 0
        self._output_cache_lock = threading.Lock()
        # set_fused_steps: up to this many same-shape batches per dispatch
        self._fused_k = 1
        # set_input_transform: an on-device batch transform
        # (data/transforms.DeviceBatchTransform) run on each batch before
        # the step, in the prefetch worker or inline
        self._input_transform = None
        # set_prefetch_depth: staged batches held ahead of the step
        self._prefetch_depth = 2
        # the fused groups' programs by key (_run_fused); dropped whenever
        # the tensors a captured graph reads may have been rebound
        self._programs: Dict[tuple, _Program] = {}
        self._graph_stream = None
        self._draws = None  # whether a step draws random numbers (cached)
        self._fused_scores = None  # every step's score of the last fused group
        # set_sentinel: the divergence sentinel judging every dispatch
        self._sentinel = None
        # set_collect_stats: per-layer mean |grad|, |update| and |param|
        # of the last step, computed inside it
        self._collect_stats = False
        self._last_stats = None
        # set_mesh: the data-parallel plan (parallel/sharded.MeshPlan), and
        # the tensor-parallel split shard_params_tp left (per-layer specs)
        self._mesh_plan = None
        self._tp_specs = None
        self._tp_mesh = None

    # -- model FLOPs (the MFU numerator) -------------------------------------

    def model_flops_per_example(self):
        """(per-example optimizer-step FLOPs, source) for MFU accounting
        (PerformanceListener, the run ledger's manifest): lazily the
        analytic per-layer estimate (utils/flops), or what
        `set_model_flops_per_example` set. (None, "analytic") when the
        conf carries no InputType to estimate from."""
        v = getattr(self, "_flops_per_example", None)
        if v is None:
            from deeplearning4j_tpu_torch.utils import flops as _flops

            v = self._flops_per_example = \
                _flops.analytic_step_flops_per_example(self.conf)
        return v

    def set_model_flops_per_example(self, flops, source: str = "costmodel"):
        self._flops_per_example = (float(flops), str(source))
        return self

    def attach_cost_model(self, cm, batch: Optional[int] = None):
        """Adopt an analysis/costmodel.CostModel as this net's FLOP and
        static-memory accounting: the live MFU gauges switch to its model
        FLOPs (source "costmodel") and the `device_memory_bytes{kind=
        activations_est}` watermark and OOM forensics use its
        liveness-based activation peak."""
        b = batch or cm.batch or 1
        self.set_model_flops_per_example(cm.model_flops / max(1, b))
        self._cost_model_meta = {
            "activation_peak_bytes": cm.activation_peak_bytes,
            "resident_bytes": cm.resident_bytes,
            "largest_activation": cm.largest_activation,
            "model_flops": cm.model_flops,
            "batch": b,
            "source": "costmodel",
        }
        return self

    def set_tenant(self, tenant):
        """Register this net under a tenant identity — the SAME identity
        the serving tier books under (utils/tenancy). When process-wide
        metering is enabled (utils/resourcemeter), the net's devprof
        device-time windows, device-memory residency and all-reduce wire
        bytes are attributed to that tenant; unmetered, this is just an
        interned attribute."""
        _resourcemeter.register_net(self, tenant)
        return self

    # -- static analysis -----------------------------------------------------

    def doctor(self, *, batch_size: int = 2, timesteps: int = 8,
               audit: bool = True):
        """Pre-flight static analysis of this network: shape flow over the
        configuration (analysis/shapeflow — nIn/nOut wiring, missing
        preprocessors, merge conflicts, dead vertices) and, when the
        config is sound and `audit` is True, one trace of the optimizer
        step on fake tensors audited for device hazards
        (analysis/graph_audit — f64, widening casts, closed-over tensors,
        host round trips, dead weights). No kernel, no device step, no
        mutation. Returns a list of analysis.Finding."""
        from deeplearning4j_tpu_torch.analysis import doctor_network

        return doctor_network(self, batch_size=batch_size,
                              timesteps=timesteps, audit=audit)

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

    def _ds_arrays(self, ds):
        """A batch's (features, labels, features mask, labels mask) as the
        loss builders take them (arrays, or lists for a graph)."""
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

    def _reg_penalty(self, params, l2_in_tail=False):
        """L1/L2 penalties (reference: BaseLayer.calcL1/calcL2 added to the
        score; their gradients come from differentiating this expression).
        `l2_in_tail`: the step's fused tail adds the trainable layers' L2
        terms and gradients, so only the frozen layers' terms are here."""
        reg = 0.0
        for conf, p in zip(self._ordered_layer_confs(), params):
            if l2_in_tail and not isinstance(conf, L.FrozenLayer):
                continue
            inner = conf.inner if isinstance(conf, L.FrozenLayer) else conf
            l1 = getattr(inner, "l1", 0.0) or 0.0
            l2 = getattr(inner, "l2", 0.0) or 0.0
            if l1 == 0.0 and l2 == 0.0:
                continue
            for name, w in p.items():
                if _regularizable(name):
                    if l1:
                        reg = reg + l1 * sign_abs(w).sum()
                    if l2:
                        reg = reg + 0.5 * l2 * (w * w).sum()
        dp = _pmesh.active_data_mesh()
        if dp is not None and not isinstance(reg, float):
            # the penalty enters the global loss once: 1/R on each rank,
            # whose shares the gradient reduction sums
            reg = reg / _pmesh.data_shards(dp)
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

    def _trainable_keys(self) -> List[List[str]]:
        """Each layer's trainable parameter names: none for a FrozenLayer
        (the JAX package's trainable mask)."""
        return [[] if isinstance(conf, L.FrozenLayer) else list(p)
                for conf, p in zip(self._ordered_layer_confs(), self.params_list)]

    def _norm_keys(self) -> List[List[str]]:
        """The parameter names whose raw gradients the step's diagnostic
        norm covers: every leaf while a sentinel is attached (the JAX
        step's diag[1] covers frozen leaves too, and the sentinel is what
        reads it), else the trainable ones, so that a step with no
        sentinel takes no frozen gradient."""
        if self._sentinel is None:
            return self._trainable_keys()
        return [list(p) for p in self.params_list]

    def _tail_decline(self, keys, norm_keys) -> Optional[str]:
        """Why this step's optimizer tail cannot run as ops/fused_updater's
        kernel, as a `fit_updater_declined_total` reason, or None: an
        updater it does not run, gradient normalization, an l1 penalty,
        `set_collect_stats`, a data-parallel or tensor-parallel split, a
        sentinel's norm over frozen leaves the step must not update, or a
        trainable leaf or state that is not contiguous f32."""
        if self.updater_def.name not in _fused_updater.KINDS:
            return "updater"
        if self.net_conf.gradient_normalization not in (None, "none"):
            return "normalization"
        for conf in self._ordered_layer_confs():
            inner = conf.inner if isinstance(conf, L.FrozenLayer) else conf
            if getattr(inner, "l1", 0.0):
                return "l1"
        if self._collect_stats:
            return "stats"
        plan = self._mesh_plan
        if (plan is not None and plan.n_data_shards > 1) or self._tp_specs is not None:
            return "mesh"
        if norm_keys != keys:
            return "frozen_norm"
        for p, s, ks in zip(self.params_list, self.upd_state, keys):
            for k in ks:
                for v in (p[k], *s[k].values()):
                    if v.dtype != torch.float32 or not v.is_contiguous():
                        return "dtype"
        return None

    def _tail_coefficients(self, keys):
        """The fused tail's leaves in order, as (layer index, name), with
        each one's L2 coefficient as `_reg_penalty` applies it and its
        learning-rate multiplier."""
        at = [(i, k) for i, ks in enumerate(keys) for k in ks]
        confs, mult = self._ordered_layer_confs(), self._lr_mult_tree()
        l2 = [(getattr(confs[i], "l2", 0.0) or 0.0) if _regularizable(k) else 0.0
              for i, k in at]
        return at, l2, [mult[i][k] for i, k in at]

    def _fused_tail(self, keys, norm_keys) -> bool:
        """Whether this step's tail runs as the fused kernel: on a CUDA net
        wherever `_tail_decline` finds no reason; a CUDA step that declines
        is counted under its reason (into the capture's tally while a graph
        captures). A CPU net always takes the per-leaf tail."""
        if self.device.type != "cuda":
            return False
        reason = self._tail_decline(keys, norm_keys)
        if reason is None:
            return True
        if self._tail_declines is not None:
            self._tail_declines[reason] = self._tail_declines.get(reason, 0) + 1
        else:
            self._fit_obs()["updater_declined"][reason].inc()
        return False

    def _step(self, loss_builder, states, data, lr, t, rng):
        """One optimizer step: the loss and its gradients by autograd, then
        the shared tail — the diagnostic, gradient normalization, per-leaf
        lr and the updater, which adds its deltas to the parameters in
        place. `lr` and `t` are 0-d f32 tensors on the net's device (a
        column of `_host_clock`), so that a captured graph reads them;
        `rng` is the step's generator, or None when no layer draws random
        numbers. Returns (merged states, score).

        A frozen layer's parameters (FrozenLayer) are left out of the
        step: autograd takes no gradient for them and the updater neither
        moves them nor touches their state, so they stay bit-unchanged.
        The JAX package multiplies their gradients by 0 instead; its
        zero-gradient update of a zero updater state is the same no-op,
        and zeros change no normalization. `self._step_diag` holds [loss,
        raw global gradient norm] (before clipping, in f32), as the JAX
        step's `diag`: over the trainable leaves, and over every leaf
        while a sentinel is attached (`_norm_keys`), when autograd also
        takes the frozen leaves' gradients, for the norm only. With
        `set_collect_stats` the step also leaves `self._last_stats`.

        On the card the tail runs as ops/fused_updater's kernel wherever
        `_fused_tail` allows: the loss is built without the trainable
        layers' L2 terms (the builder's `l2_in_tail`), and the kernel folds
        each L2 gradient in, as much of it as the builder's score passes
        to the weights (`l2_grad_share`), steps every leaf and writes the
        diagnostic with the L2 terms added to the score; elsewhere the
        per-leaf tail below."""
        params = self.params_list
        keys = self._trainable_keys()
        norm_keys = self._norm_keys()
        leaves = [p[k] for p, ks in zip(params, norm_keys) for k in ks]
        plan = self._mesh_plan
        fused = bool(leaves) and self._fused_tail(keys, norm_keys)
        for v in leaves:
            v.requires_grad_(True)
        try:
            with _pmesh.data_parallel_scope(None if plan is None else plan.mesh):
                score, new_states = loss_builder(params, states, data, rng,
                                                 l2_in_tail=fused)
            flat = iter(torch.autograd.grad(score, leaves, allow_unused=True)
                        if leaves else ())
        finally:
            for v in leaves:
                v.requires_grad_(False)
        score = score.detach()
        # a parameter the loss does not reach (an AutoEncoder's visible
        # bias, a VAE's decoder, outside pretraining) has a zero gradient
        raw = [{k: _zero_if_none(next(flat), p[k]) for k in ks}
               for p, ks in zip(params, norm_keys)]
        if fused:
            at, l2, mult = self._tail_coefficients(keys)
            self._step_diag = _fused_updater.apply_updater(
                self.updater_def, [params[i][k] for i, k in at],
                [raw[i][k] for i, k in at], [self.upd_state[i][k] for i, k in at],
                l2, mult, lr, t, score.float(), negate=not self.net_conf.minimize,
                l2_share=_l2_grad_share(loss_builder, data))
            return _detached(self._merge_states(states, new_states)), self._step_diag[0]
        if plan is not None and plan.n_data_shards > 1:
            # the data-parallel reduction, before the diagnostic: the
            # sentinel, the clipping and the updater see the global
            # gradient, and every rank takes the same decisions
            raw, score = plan.reduce_grads(self, raw, score)
        grads = raw if self._sentinel is None else [
            {k: g[k] for k in ks} for g, ks in zip(raw, keys)]
        with torch.no_grad():
            # leaves in sorted-key order per layer, as jax.tree_util walks
            gsq = sum((g[k].float().square().sum() for g in raw for k in sorted(g)),
                      torch.zeros((), device=score.device))
            self._step_diag = torch.stack([score.float(), torch.sqrt(gsq)])
            if not self.net_conf.minimize:
                grads = [{k: -v for k, v in g.items()} for g in grads]
            grads = normalize_gradients(
                grads, self.net_conf.gradient_normalization,
                self.net_conf.gradient_normalization_threshold)
            # one lr tensor per distinct multiplier: f32(lr) * f32(m), as
            # the JAX package multiplies its traced lr
            scaled = {1.0: lr}
            lr_tree = []
            for g, m in zip(grads, self._lr_mult_tree()):
                for k in g:
                    if m[k] not in scaled:
                        scaled[m[k]] = lr * m[k]
                lr_tree.append({k: scaled[m[k]] for k in g})
            updates = self.updater_def.step_(params, grads, self.upd_state,
                                             lr_tree, t)
            if self._collect_stats:
                self._last_stats = _mean_magnitudes(params, grads, updates)
        return _detached(self._merge_states(states, new_states)), score

    def _run_step(self, loss_builder, data, stateful_states=None):
        """One eager optimizer step at `self.iteration`."""
        with _tracing.span("fit/stage_inputs"):
            clock = self._host_clock(1).to(self.device, non_blocking=True)
        states = stateful_states if stateful_states is not None else self.state_list
        with _tracing.span("fit/launch", mode="eager"):
            states, score = self._step(loss_builder, states, data, clock[0, 0],
                                       clock[1, 0], self._step_rng(self.iteration))
        self._score = score
        self.iteration += 1
        return states, score

    def _host_clock(self, n: int) -> torch.Tensor:
        """[2, n] f32 on the host (pinned for a CUDA net): the learning
        rates of the next n steps (the host schedule) and their iteration
        counters t."""
        clock = np.empty((2, n), np.float32)
        for i in range(n):
            clock[0, i] = schedule_lr(self.net_conf, self.iteration + i)
            clock[1, i] = self.iteration + i
        host = torch.from_numpy(clock)
        return host.pin_memory() if self.device.type == "cuda" else host

    def _draws_random(self) -> bool:
        """Whether a training step draws random numbers: dropout on some
        layer's input (a DropoutLayer's too) or an rrelu activation. A
        frozen layer runs in inference mode and draws none."""
        if self._draws is None:
            self._draws = False
            for conf in self._ordered_layer_confs():
                if isinstance(conf, L.FrozenLayer):
                    continue
                p = getattr(conf, "dropout", None)
                if (p is not None and 0.0 < p < 1.0) or \
                        getattr(conf, "activation", None) == "rrelu":
                    self._draws = True
        return self._draws

    def _step_rng(self, iteration: int):
        """The step's generator, seed ^ 0x5EED with the iteration folded
        in; None when no layer draws random numbers."""
        if not self._draws_random():
            return None
        return torch.Generator(device=self.device).manual_seed(
            ((self.net_conf.seed ^ 0x5EED) * 1_000_003 + iteration) % (2 ** 63))

    def _recurrent_layers(self) -> List[bool]:
        return [_is_recurrent(c) for c in self._ordered_layer_confs()]

    def _seeded_states(self):
        """state_list with {} for each recurrent layer that holds no carry:
        the zero carry a TBPTT batch starts from."""
        return [({} if rec and st is None else st)
                for st, rec in zip(self.state_list, self._recurrent_layers())]

    def _commit_states(self, states) -> None:
        """Write a step's layer states into the state_list's own tensors
        (None entries skipped), instead of rebinding them: the tensors
        keep their addresses, which a captured graph reads and writes."""
        with torch.no_grad():
            for new, old in zip(states, self.state_list):
                if new is None:
                    continue
                for k, v in new.items():
                    if v is not old[k]:
                        old[k].copy_(v)

    # -- truncated BPTT --------------------------------------------------------

    def _tbptt_batch(self, data, states, step):
        """One batch's truncated BPTT (reference:
        MultiLayerNetwork.doTruncatedBPTT :1333): time in segments of
        tbptt_fwd_length, the recurrent state carried across them and cut
        from the autograd graph at each segment's start; with
        tbptt_bwd_length shorter, each segment's gradient reaches back only
        its last bwd_length steps (the truncated loss builder).
        `step(loss_builder, states, segment data)` runs one optimizer step
        and returns the states it leaves. Returns the last segment's."""
        T = _time_steps(data)
        seg = int(self.conf.tbptt_fwd_length)
        bwd = int(self.conf.tbptt_bwd_length)
        for start in range(0, T, seg):
            end = min(start + seg, T)
            if bwd < end - start:
                boundary = end - bwd
                states = step(self._trunc_loss_builder(), states,
                              _cut_time(data, slice(start, boundary))
                              + _cut_time(data, slice(boundary, end)))
            else:
                states = step(self._std_loss_builder(), states,
                              _cut_time(data, slice(start, end)))
        return states

    def _tbptt_fusable(self, data) -> Optional[int]:
        """The segment count when one batch's TBPTT can run as one fused
        program: every temporal array spans the same T, a whole number of
        segments (a ragged tail takes the loop); else None."""
        T = _time_steps(data)
        seg = int(self.conf.tbptt_fwd_length)
        if T % seg or not _uniform_time(data, T):
            return None
        return T // seg

    def _fit_tbptt_loop(self, ds, data):
        """The TBPTT segment loop: one eager step per segment, each
        notified to the listeners; only non-recurrent state persists."""
        def step(builder, states, seg_data):
            states, _ = self._run_step(builder, seg_data, states)
            self._notify(_examples_of(ds), ds)
            return states

        states = self._tbptt_batch(data, self._seeded_states(), step)
        self._commit_states([None if rec else st for st, rec
                             in zip(states, self._recurrent_layers())])

    def _fit_tbptt(self, ds, data):
        """Truncated BPTT for one batch: with no listeners, no stats
        collection and no ragged tail, all its segments run as one fused
        program (one CUDA graph on the card); listeners keep the loop, so
        that each callback sees its iteration's parameters (the JAX
        package's rule). A sentinel judges the fused batch once, on
        [last loss, largest norm]; under the loop it judges the last
        segment's diagnostic, as the JAX package does."""
        n_seg = (None if self._step_listeners() or self._collect_stats
                 else self._tbptt_fusable(data))
        if n_seg is None:
            self._fit_tbptt_loop(ds, data)
        else:
            self._run_fused(("tbptt", self._ds_signature(ds), 1), [data], n_seg,
                            self._tbptt_group_batch)

    def _tbptt_group_batch(self, states, data, step):
        """One batch of a fused TBPTT program: the recurrent carry reset to
        the batch's zero seed, the non-recurrent state carried through."""
        seed = self._seeded_states()
        states = [s0 if rec else st for st, s0, rec
                  in zip(states, seed, self._recurrent_layers())]
        return self._tbptt_batch(data, states, step)

    def _std_group_batch(self, states, data, step):
        return step(self._std_loss_builder(), states, data)

    # -- the fused dispatch --------------------------------------------------

    def _run_fused(self, key, batches, n_steps: int, per_batch):
        """Run `batches` (each one batch's arrays) as ONE dispatch of
        `n_steps` optimizer steps: `per_batch(states, data, step)` walks a
        batch's steps. The same code runs as a plain loop on the CPU and,
        on a CUDA device, as one CUDA graph per `key`: the key's first
        group runs eagerly on the card (every kernel builds and loads),
        the second is captured and every group from then on replays it.
        A step that draws random numbers cannot replay (its generator is
        seeded per step on the host), so such groups run eagerly on the
        card, counted in `fit_graph_declined_total{reason="rng"}`; so do
        groups of a step whose collectives cannot be captured (a gloo mesh:
        `{reason="collective"}`; NCCL's are captured once its communicator
        is warm, after the eager warm-up). A capture or a replay that fails
        raises. Spans: `fit/stage_inputs`, `fit/launch` (`mode` eager,
        capture or replay), `fit/collect`."""
        cuda = self.device.type == "cuda"
        prog = self._programs.get(key)
        if prog is None:
            io = {"clock": torch.empty((2, n_steps), dtype=torch.float32,
                                       device=self.device),
                  "out": torch.empty(n_steps + 2, dtype=torch.float32,
                                     device=self.device),
                  # static batch buffers, one set per batch (each its own
                  # allocation, aligned as an eager batch is)
                  "data": [_map_arrays(self._static_like, b) for b in batches]
                  if cuda else None}
            prog = self._programs[key] = _Program(key, io)
        io = prog.io
        with _tracing.span("fit/stage_inputs"):
            io["clock"].copy_(self._host_clock(n_steps), non_blocking=True)
            if cuda:
                for static, b in zip(io["data"], batches):
                    for dst, src in zip(_tensor_leaves(static),
                                        _tensor_leaves(_map_arrays(self._as_data, b))):
                        dst.copy_(src)
                dev_batches = io["data"]
            else:
                dev_batches = [_map_arrays(self._as_data, b) for b in batches]
        rngs = [self._step_rng(self.iteration + j) for j in range(n_steps)]

        def run():
            self._program_body(io, dev_batches, rngs, per_batch)

        graphed, mode = False, "eager"
        if cuda:
            if rngs[0] is not None:
                self._fit_obs()["graph_declined_rng"].inc()
            elif self._mesh_plan is not None and not self._mesh_plan.capturable():
                # gloo collectives cannot be captured in a CUDA graph
                self._fit_obs()["graph_declined_collective"].inc()
            else:
                graphed, mode = True, self._graph_mode(prog)
        with _tracing.span("fit/launch", mode=mode):
            if graphed:
                self._graph_dispatch(prog, run)
            else:
                run()
        with _tracing.span("fit/collect"):
            if mode != "eager":
                self._graph_tally(prog)
            # cloned out before the next replay overwrites the buffer (the
            # black box keeps `_score` as a device tensor)
            out = io["out"].clone()
            self._fused_scores = out[:n_steps]
            self._score = out[n_steps - 1]
            self._step_diag = out[n_steps:]
            self.iteration += n_steps

    def _static_like(self, a) -> torch.Tensor:
        t = a if torch.is_tensor(a) else torch.as_tensor(np.asarray(a))
        dt = torch.float32 if t.dtype == torch.float64 else t.dtype
        return torch.empty(t.shape, dtype=dt, device=self.device)

    def _program_body(self, io, batches, rngs, per_batch):
        """The fused group's steps, reading lr and t from io["clock"] and
        writing the scores and the group's diagnostic ([last loss, largest
        raw gradient norm]) into io["out"]; the layer states are committed
        into the state_list's tensors (the recurrent carry is per batch)."""
        clock = io["clock"]
        scores, gnorms = [], []

        def step(builder, states, data):
            j = len(scores)
            states, score = self._step(builder, states, data, clock[0, j],
                                       clock[1, j], rngs[j])
            scores.append(score)
            gnorms.append(self._step_diag[1])
            return states

        states = list(self.state_list)
        for data in batches:
            states = per_batch(states, data, step)
        self._commit_states([None if rec else st for st, rec
                             in zip(states, self._recurrent_layers())])
        with torch.no_grad():
            n = len(scores)
            out = io["out"]
            out[:n].copy_(torch.stack(scores))
            out[n:].copy_(torch.stack([scores[-1].float(),
                                       torch.stack(gnorms).max()]))

    def _side_stream(self):
        if self._graph_stream is None:
            self._graph_stream = torch.cuda.Stream(self.device)
        return self._graph_stream

    def _state_addresses(self) -> tuple:
        return tuple(t.data_ptr() for t in _tensor_leaves(
            (self.params_list, self.upd_state, self.state_list)))

    def _graph_mode(self, prog: _Program) -> str:
        """What `_graph_dispatch` will do with `prog` now: "eager" (the
        warm-up), "capture" (capture, then replay) or "replay". A graph
        whose network's tensors were rebound since its capture is
        dropped first."""
        if prog.graph is not None and prog.addresses != self._state_addresses():
            # parameters, updater state or layer state were rebound since
            # the capture: the graph would read the old tensors
            logger.info("fused program %s: the network's tensors moved since "
                        "its capture; capturing again", prog.key)
            prog.graph, prog.warm = None, False
        if prog.graph is not None:
            return "replay"
        return "capture" if prog.warm else "eager"

    def _graph_dispatch(self, prog: _Program, run) -> None:
        """Warm up, capture or replay `prog` on the card, as `_graph_mode`
        said (see _run_fused). Everything it launches ends on the current
        stream: the replay launches there, and a warm-up or a capture on
        the side stream is joined back to it."""
        ins = self._fit_obs()
        cur = torch.cuda.current_stream(self.device)
        side = self._side_stream()
        if prog.graph is None and not prog.warm:
            # warm-up on the capture's stream: the same math, eagerly
            side.wait_stream(cur)
            with torch.cuda.stream(side):
                run()
            cur.wait_stream(side)
            prog.warm = True
            return
        if prog.graph is None:
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()
            reserved = torch.cuda.memory_reserved(self.device)
            t0 = time.perf_counter()
            graph = torch.cuda.CUDAGraph()
            side.wait_stream(cur)
            self._tail_declines = declines = {}
            try:
                with _fused_lstm.recording_launches(side) as lstm_tally, \
                        _fused_conv_bn.recording_launches(side) as conv_tally, \
                        _fused_updater.recording_launches(side) as upd_tally, \
                        _fused_ssd.recording_launches(side) as ssd_tally, \
                        _helpers.recording_events(side) as events, \
                        torch.cuda.graph(graph, stream=side,
                                         capture_error_mode="thread_local"):
                    run()
            finally:
                self._tail_declines = None
            cur.wait_stream(side)
            prog.graph = graph
            prog.lstm_launches, prog.conv_launches = lstm_tally, conv_tally
            prog.updater_launches, prog.tail_declines = upd_tally, declines
            prog.ssd_launches = ssd_tally
            prog.events = events
            prog.addresses = self._state_addresses()
            prog.capture_seconds = time.perf_counter() - t0
            prog.pool_bytes = torch.cuda.memory_reserved(self.device) - reserved
            ins["graph_captures"].inc()
            self._note_compile("fit_graph", prog.key)
        prog.graph.replay()

    def _graph_tally(self, prog: _Program) -> None:
        """A replay's books: the kernel launches and helper events its
        graph holds, and the replay counters."""
        _fused_lstm.add_launches(prog.lstm_launches)
        _fused_conv_bn.add_launches(prog.conv_launches)
        _fused_updater.add_launches(prog.updater_launches)
        _fused_ssd.add_launches(prog.ssd_launches)
        _helpers.replay_events(prog.events)
        declined = self._fit_obs()["updater_declined"]
        for reason, n in prog.tail_declines.items():
            declined[reason].inc(n)
        prog.replays += 1
        self._fit_obs()["graph_replays"].inc()

    def _reset_step_programs(self) -> None:
        """Drop every fused program and its captured graph: the tensors
        they read may have been rebound (set_params, a zip loaded or
        restored, clone)."""
        self._programs = {}

    def fit_graphs(self) -> List[dict]:
        """The captured fused programs: key, replays, capture seconds and
        the graph pool's bytes (the reserved memory the capture added)."""
        return [{"key": p.key, "replays": p.replays,
                 "capture_seconds": p.capture_seconds,
                 "pool_bytes": p.pool_bytes}
                for p in self._programs.values() if p.graph is not None]

    # -- the process mesh ------------------------------------------------------

    def set_mesh(self, mesh=None, *, plan=None, bucket_bytes=None, grad_dtype=None):
        """Attach a process mesh: the data-parallel training path. The
        first data rank's params, layer state and updater state are
        broadcast over the data axis, each fit batch is cut to this rank's
        rows by the input pipeline, and the step sums its gradients and
        score over the data axis, bucketed per the plan's CollectivePlan
        (parallel/sharded.py). `mesh=None` builds a 1-D "data" mesh over
        every rank; `plan` overrides the MeshPlan (the multi-host plan
        does). `bucket_bytes` sets the gradient-bucket size (0 = one
        monolithic buffer; default DL4J_GRAD_BUCKET_BYTES or 4 MiB);
        `grad_dtype="bf16"` puts the all-reduce's payload in bf16 (never
        the default). `fit()` calls this itself when a process group of
        more than one rank is up (DL4J_AUTO_MESH=0 disables)."""
        from deeplearning4j_tpu_torch.parallel.mesh import data_parallel_mesh
        from deeplearning4j_tpu_torch.parallel.sharded import MeshPlan

        self._require_init()
        if mesh is None:
            mesh = data_parallel_mesh()
        if plan is None:
            plan = MeshPlan(mesh, bucket_bytes=bucket_bytes, grad_dtype=grad_dtype)
        elif bucket_bytes is not None or grad_dtype is not None:
            raise ValueError(
                "bucket_bytes/grad_dtype are MeshPlan knobs — pass them to the "
                "plan's constructor, not alongside plan=")
        plan.place_net(self)
        self._mesh_plan = plan
        self._reset_step_programs()
        return self

    def unset_mesh(self):
        """Detach the mesh plan: single-process semantics again (the
        tensors stay where they are: every rank already holds them whole)."""
        if self._mesh_plan is not None:
            self._mesh_plan = None
            self._reset_step_programs()
        return self

    def _maybe_auto_mesh(self):
        """The fit-loop default: with a process group of more than one rank
        up and no mesh attached, engage the data-parallel step over every
        rank. DL4J_AUTO_MESH=0 opts a process out (tests/conftest.py does);
        a tensor-parallel split (shard_params_tp) is a deliberate
        parallelism decision the auto mesh leaves alone."""
        from deeplearning4j_tpu_torch.parallel.mesh import n_devices
        from deeplearning4j_tpu_torch.parallel.sharded import auto_mesh_enabled

        if self._mesh_plan is not None or self._tp_specs is not None:
            return
        if not auto_mesh_enabled() or n_devices() < 2:
            return
        logger.info("process group of %d ranks: engaging the data-parallel "
                    "train step (net.set_mesh; DL4J_AUTO_MESH=0 disables)",
                    n_devices())
        self.set_mesh()

    def _global_params(self):
        """(params_list, upd_state) with tensor-parallel slices gathered
        into the global tensors (the live lists when nothing is split), as
        the JAX package's global arrays read."""
        if self._tp_specs is None:
            return self.params_list, self.upd_state
        from deeplearning4j_tpu_torch.parallel.tensor import gather_tp

        return gather_tp(self, self.params_list), (
            None if self.upd_state is None else gather_tp(self, self.upd_state))

    # -- fusion API ------------------------------------------------------------

    def set_fused_steps(self, k: int):
        """Run up to `k` consecutive same-shape minibatches as ONE
        dispatch: a plain loop of the same steps on the CPU, one CUDA
        graph on the card — same math, same per-step lr, t and iteration
        bookkeeping. Fusion engages only when it is observationally
        equivalent to the per-step loop: no listeners that read each
        step (each callback must see its iteration's parameters; one
        marked `fusion_safe`, as TracingListener is, hears of whole
        dispatches) and the subclass supports it
        (`_fused_fit_supported`); a smaller group (a signature change or
        the epoch's end) runs batch by batch."""
        self._fused_k = max(1, int(k))
        return self

    def set_sentinel(self, sentinel):
        """Attach a train/sentinel.DivergenceSentinel: every dispatch is
        judged on the step's [loss, grad norm] diagnostic; an anomalous
        step is undone (quarantine), persistent anomalies restore the last
        good checkpoint (rollback) and bounded failures raise
        TrainingDivergedError. None detaches it. A judged step waits for
        its own diagnostic, and `set_fused_steps` groups run batch by
        batch (each step must be judged alone); a TBPTT batch's segments
        still run as one program. While attached, the step also takes the
        frozen leaves' gradients for the norm (`_norm_keys`)."""
        if (sentinel is None) != (self._sentinel is None) and \
                self.params_list is not None and any(
                    isinstance(c, L.FrozenLayer) for c in self._ordered_layer_confs()):
            # the step's leaves change: captured programs would replay
            # the other set, and the reduction's schedule covers the other
            self._reset_step_programs()
            if self._mesh_plan is not None:
                self._mesh_plan.invalidate()
        self._sentinel = sentinel
        return self

    def set_collect_stats(self, flag: bool = True):
        """Compute the per-layer mean |grad|, |update| and |param| inside
        every step (`self._last_stats`, handed to listeners as
        info["stats"]). Collecting turns fusion off and sends TBPTT down
        its per-segment loop, as in the JAX package."""
        flag = bool(flag)
        if flag != self._collect_stats:
            self._collect_stats = flag
            self._last_stats = None
            self._reset_step_programs()
        return self

    def set_input_transform(self, transform):
        """Install an on-device batch transform (e.g.
        data.transforms.DeviceBatchTransform): under async_prefetch it
        runs on the staged device batch in the prefetch worker; with
        prefetch off it runs inline before the step — the same ops and
        per-batch step either way. None removes it."""
        self._input_transform = transform
        return self

    def set_prefetch_depth(self, depth: int):
        """How many device-staged batches the input pipeline holds ahead
        of the step (data.prefetch.DevicePrefetchIterator)."""
        self._prefetch_depth = max(1, int(depth))
        return self

    def _fused_fit_supported(self) -> bool:
        """Whether this network can run `_fit_datasets_fused`."""
        return False

    def _fit_datasets_fused(self, ds_list):
        raise NotImplementedError

    def _ds_signature(self, ds):
        """Shape and mask signature: only identically shaped consecutive
        batches form one fused group."""
        sh = lambda a: None if a is None else tuple(a.shape)
        return tuple(None if part is None else
                     (tuple(sh(a) for a in part) if isinstance(part, list) else sh(part))
                     for part in self._ds_arrays(ds))

    # -- listeners -----------------------------------------------------------

    def set_listeners(self, *listeners):
        self.listeners = list(listeners)
        return self

    def add_listener(self, listener):
        self.listeners.append(listener)
        return self

    def _step_listeners(self) -> list:
        """The listeners that read each optimizer step, and so keep a fit
        off the fused path: all but those marked `fusion_safe`."""
        return [lst for lst in self.listeners
                if not getattr(lst, "fusion_safe", False)]

    def _notify(self, batch_size, ds=None):
        # a consistent point: the whole optimizer step is committed, so a
        # held SIGTERM (the preemption save) may run here
        _sigchain.safe_point()
        if not self.listeners:
            return
        info = {
            "score": lambda: self._score,
            "batch_size": batch_size,
            "etl_ms": self._last_etl_ms,
            "stats": lambda: self._last_stats,
            # the batch that produced this iteration (lazy)
            "batch": lambda: ds,
        }
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
                    "host time in the train-step call (launches)").labels(),
                "graph_captures": reg.counter(
                    "fit_graph_captures_total",
                    "fused fit programs captured as CUDA graphs").labels(),
                "graph_replays": reg.counter(
                    "fit_graph_replays_total",
                    "fused fit groups replayed from a CUDA graph").labels(),
                "graph_declined_rng": reg.counter(
                    "fit_graph_declined_total",
                    "fused fit groups run eagerly on the card instead of "
                    "from a CUDA graph", ("reason",)).labels("rng"),
                "graph_declined_collective": reg.counter(
                    "fit_graph_declined_total",
                    "fused fit groups run eagerly on the card instead of "
                    "from a CUDA graph", ("reason",)).labels("collective"),
                "updater_declined": {
                    r: reg.counter(
                        "fit_updater_declined_total",
                        "optimizer steps on the card that ran the per-leaf "
                        "updater tail instead of the fused kernel",
                        ("reason",)).labels(r)
                    for r in UPDATER_DECLINE_REASONS},
                "allreduce_bytes": reg.counter(
                    "allreduce_bytes_total",
                    "gradient bytes all-reduced by the data-parallel train "
                    "step (logical payload: summed gradient leaf bytes at "
                    "the wire dtype per optimizer step)").labels(),
                "collective_seconds": reg.counter(
                    "train_step_collective_seconds",
                    "time attributed to the train step's gradient "
                    "all-reduce, by accounting source (estimate = ring wire "
                    "bytes / the card's link bandwidth, a cost model; "
                    "measured = a sampled blocking run of the bucket "
                    "schedule's all-reduces)", ("source",)).labels("estimate"),
                "collective_seconds_measured": reg.counter(
                    "train_step_collective_seconds",
                    "time attributed to the train step's gradient "
                    "all-reduce, by accounting source",
                    ("source",)).labels("measured"),
                "recorder": _blackbox.get_recorder(),
                "devprof": _devprof.get_profiler(),
            }
        return ins

    def _timed_fit(self, fit_fn, data_wait: float, n_examples: int,
                   n_batches: int = 1, batches=None):
        """Run one dispatch (a `_fit_dataset` or a fused group of
        `n_batches`) under the step-phase timers: the data wait and the
        dispatch's host time, each a histogram in the shared registry,
        the `fit/step` span over `fit/dispatch` and `fit/books`, the
        step and example counters, a flight-recorder step record and the
        fit heartbeat. PyTorch returns before the device finishes, so the
        dispatch time is host time, as in the JAX package; on a CUDA net
        the device profiler brackets the dispatch with timing events
        (utils/devprof), resolved at later dispatches. Nothing here waits
        on the device. `batches` names the DataSet(s) behind this
        dispatch for the `nan` fault kind and their input timing."""
        ins = self._fit_obs()
        prof = ins["devprof"]
        it0 = self.iteration
        # resume bookkeeping BEFORE the dispatch: a checkpoint listener
        # firing inside it (post-step _notify) must record this batch as
        # consumed — the snapshot's params already include its update.
        # Under TBPTT a save between two segments of one batch therefore
        # resumes at the NEXT batch (the JAX package's rule).
        ts = self._train_state
        if ts is not None:
            ts["batch_in_epoch"] += n_batches
        # beat on entry AND exit: each phase (data wait, dispatch) must
        # individually exceed hang_timeout to read as a stall
        hb0 = self._fit_heartbeat
        if hb0 is not None:
            hb0.beat()
        # sentinel pre-capture: one attribute read with no sentinel
        # attached (the <10 us off-path contract); with one, device clones
        # that make an anomalous step's update undoable
        pre = _sentinel.pre_step(self)
        t0 = time.perf_counter()
        with _tracing.span("fit/step"):
            with _tracing.span("fit/dispatch"):
                # chaos hook: an `oom` fault here unwinds the fit as a
                # device allocator failure would; a `nan` fault taints
                # this batch's features so the divergence goes through
                # the real step
                injected = _faults.fault_point("train_step")
                if injected == "nan" and batches:
                    _faults.taint_nan(batches[0])
                # CN003 probe (DL4J_LOCKCHECK): a step or graph replay
                # entered with a traced lock held; one global read when off
                _locktrace.note_dispatch("fit/dispatch")
                timing = prof.begin_dispatch(self, batches)
                fit_fn()
                prof.end_dispatch(self, timing, n_examples)
            dispatch = time.perf_counter() - t0
            with _tracing.span("fit/books"):
                self._books(ins, it0, data_wait, dispatch, n_examples, pre, batches)

    def _books(self, ins, it0, data_wait, dispatch, n_examples, pre, batches):
        """What the fit loop records after a dispatch."""
        n_steps = max(1, self.iteration - it0)
        ins["steps"].inc(n_steps)
        ins["examples"].inc(n_examples)
        ins["data_wait"].observe(data_wait)
        ins["dispatch"].observe(dispatch)
        # collective books: each sharded optimizer step all-reduced one
        # gradient payload
        plan = self._mesh_plan
        if plan is not None and plan.n_data_shards > 1:
            ins["allreduce_bytes"].inc(plan.grad_payload_bytes(self) * n_steps)
            est = plan.collective_seconds_estimate(self)
            if est is not None:
                ins["collective_seconds"].inc(est * n_steps)
            measured = plan.maybe_measure_collective(self, n_steps)
            if measured is not None:
                ins["collective_seconds_measured"].inc(measured)
        # black box: one ring append, the score kept as a device tensor
        # (resolved only at dump time, never synced here)
        ins["recorder"].record_step(self.iteration - 1, score=self._score,
                                    data_wait=data_wait, dispatch=dispatch)
        # device-side accounting: the dispatch timeline's completed
        # records (CUDA), the sampled host clock (CPU)
        ins["devprof"].on_step(self, n_examples, self._score)
        # listeners that hear of whole dispatches (TracingListener)
        for lst in self.listeners:
            hook = getattr(lst, "dispatch_done", None)
            if hook is not None:
                hook(self, it0, n_steps)
        # run-ledger hook: ONE module-global read with no ledger attached
        # (the off-by-default overhead contract); on the host, after the
        # dispatch, so never inside a captured graph
        _runledger.note_fit_step(self)
        # the judgment comes after the step's own records, so that an
        # anomalous step stays visible in the flight recorder; it may
        # raise RollbackSignal (answered by _run_fit) or
        # TrainingDivergedError
        if pre is not None:
            _sentinel.post_step(self, pre, batches)
        hb = self._fit_heartbeat
        if hb is not None:
            hb.beat()

    def _run_fit(self, iterator, epochs: int, async_prefetch: bool = True,
                 prefetch_buffer: int = 4,
                 hang_timeout: Optional[float] = None,
                 resume_from: Optional[str] = None, run_ledger=None):
        # run-ledger opt-in: a path's ledger is the fit's own (closed
        # when the fit ends), a given one is attached for the fit
        ledgers = _runledger.attach_scoped(run_ledger)
        try:
            return self._run_fit_attached(iterator, epochs, async_prefetch,
                                          prefetch_buffer, hang_timeout,
                                          resume_from)
        finally:
            _runledger.end_scope(*ledgers)

    def _run_fit_attached(self, iterator, epochs, async_prefetch,
                          prefetch_buffer, hang_timeout, resume_from):
        # SIGTERM actions (the preemption save) read this net, and the
        # loop below changes its parameters, updater state, iteration,
        # epoch and resume coordinates in separate statements: a SIGTERM
        # is held for the whole fit and runs only where they agree (after
        # a batch is pulled, at each listener notification, at an epoch's
        # end, or when the fit ends)
        with _sigchain.deferred():
            # with a process group of several ranks up: the data-parallel
            # step, BEFORE restore and staging, so that the restored state
            # is broadcast and the pipeline shards the batches
            self._maybe_auto_mesh()
            plan = self._mesh_plan
            if plan is not None:
                plan.reset_pad_target()
            skip_batches = 0
            if resume_from is not None:
                if plan is not None:
                    # every rank reads what the writer (rank 0) finished
                    _pmesh.barrier(plan.mesh)
                # restore BEFORE staging: the iterator state lands on the
                # caller's iterator, not the pipeline wrapped around it
                skip_batches, epochs, _ = self._restore_for_resume(
                    resume_from, iterator, epochs)
                if plan is not None:
                    plan.place_net(self)
            owned = None
            if async_prefetch:
                staged = self._stage_input_pipeline(iterator, prefetch_buffer)
                if staged is not iterator:
                    iterator = owned = staged
            # fusion engages only where it is observationally equivalent to
            # the per-step loop: no listeners that read each step, no stats
            # collection, no sentinel (quarantine discards ONE step's
            # update, not a group's), and the subclass supports it. The
            # mesh's batch sharding and the input transform run on each
            # batch before grouping, so they leave fusion on.
            fuse_k = self._fused_k if (
                self._fused_k > 1 and not self._step_listeners()
                and not self._collect_stats and self._sentinel is None
                and self._fused_fit_supported()) else 1
            if self._sentinel is not None:
                self._sentinel.bind(self, resume_dir=resume_from)
            # the epoch the rollback loop restores toward: `epochs` is
            # already "remaining" here
            total_epoch_target = int(self.epoch) + int(epochs)
            # liveness: the fit thread holds a busy slot on the "fit"
            # heartbeat for the whole run and beats once per dispatch.
            # With hang_timeout the watchdog's stall action dumps the
            # flight recorder and raises StepHangError here.
            hb = _health.get_health().register(
                "fit",
                stall_after=hang_timeout if hang_timeout else 600.0,
                on_stall=self._hang_action() if hang_timeout else None)
            self._fit_heartbeat = hb
            try:
                with hb.busy():
                    while True:
                        try:
                            self._fit_epochs(iterator, epochs, fuse_k,
                                             skip_batches)
                            break
                        except _sentinel.RollbackSignal:
                            # restore the last good checkpoint and replay;
                            # note_rollback bounds the attempts
                            skip_batches, epochs = self._rollback_restore(
                                iterator, total_epoch_target)
            except _health.StepHangError as e:
                if e.dump_path is not None:
                    raise  # already carries its forensics
                raise _health.StepHangError(
                    f"fit step exceeded hang_timeout={hang_timeout}s without "
                    f"progress (see flight-recorder dump)",
                    dump_path=self._hang_dump_path) from None
            except Exception as e:
                # device allocator failure: record the largest live tensors
                # and the static activation estimate BEFORE unwinding (the
                # tensors are gone once the frames release them), then let
                # the original exception carry on
                if _devprof.is_oom(e):
                    path = _devprof.oom_forensics("fit", e, net=self)
                    logger.error("device out of memory in fit; OOM forensics "
                                 "dump at %s", path)
                raise
            finally:
                self._fit_heartbeat = None
                # the devprof sampling window dies with the fit: a stale
                # last-sample time would make the NEXT fit's first window
                # span the idle gap between fits; the dispatch timeline
                # resolves what has completed and keeps the rest
                self._devprof_state = None
                _devprof.get_profiler().end_fit(self)
                # resume coordinates die with the fit: a preemption save
                # AFTER a completed fit must record a clean epoch boundary
                self._train_state = None
                _health.get_health().unregister(hb)
                # the pipeline workers this fit started die with it
                if owned is not None:
                    owned.close()
                # fires even when an epoch raises: listeners that flipped
                # process-global state for the run restore it here
                for lst in self.listeners:
                    hook = getattr(lst, "on_fit_end", None)
                    if hook is not None:
                        hook(self)
        return self

    def _hang_action(self):
        """The watchdog-side stall action for fit(hang_timeout=...): runs
        on the dl4j-watchdog thread — dump the black box first, then
        async-raise StepHangError into the fitting thread (delivered at
        its next bytecode boundary: a thread blocked inside a CUDA call
        receives it when the call returns)."""
        fit_tid = threading.get_ident()

        def on_stall(hb, stalled_for):
            self._hang_dump_path = _blackbox.get_recorder().dump(
                reason=f"fit step hang: no progress for "
                       f"{stalled_for:.3f}s (hang_timeout={hb.stall_after}s)")
            # the dump takes real time: re-check the fit is still OURS
            # and still stalled before the irrevocable async raise
            if self._fit_heartbeat is not hb:
                return
            state, _, _ = hb.check()
            if state == _health.OK:
                return
            if not _health._async_raise(fit_tid, _health.StepHangError):
                logger.error(
                    "fit hang detected but StepHangError could not be "
                    "delivered; dump at %s", self._hang_dump_path)

        return on_stall

    # -- resume ----------------------------------------------------------------

    def _capture_iterator_state(self, iterator) -> Optional[dict]:
        """The iterator's epoch-start state (the data/iterators `state()`
        protocol), JSON-safe, for checkpoints. None when the iterator is
        stateless or its capture fails — resume then replays
        positionally only."""
        state_fn = getattr(iterator, "state", None)
        if not callable(state_fn):
            return None
        try:
            return state_fn()
        except Exception:
            logger.warning("iterator state capture failed; checkpoints "
                           "will resume positionally only", exc_info=True)
            return None

    def train_state(self) -> Optional[dict]:
        """Point-in-time resume coordinates of the CURRENT fit: epoch,
        batches consumed within it, and the iterator's epoch-start state.
        Embedded into checkpoints (utils/model_serializer trainState.json)
        and replayed by fit(resume_from=...). None outside a fit."""
        ts = self._train_state
        return None if ts is None else dict(ts)

    def _restore_for_resume(self, directory: str, iterator, epochs: int,
                            require_finite: bool = False,
                            lr_drift_ok: bool = False,
                            reject_iterations=()):
        """Load the newest GOOD checkpoint in `directory` into this net
        and prime the mid-epoch replay: restores the iterator's
        epoch-start state and returns (batches to skip in the first
        epoch, epochs remaining out of the requested total, the restored
        path or None). An empty or missing directory is a fresh start.
        Each candidate's SHA-256 manifest is verified before the load; a
        damaged or unloadable candidate is skipped (counted) and the
        previous one used; a changed configuration raises. The sentinel's
        rollback also rejects a checkpoint whose parameters are
        non-finite (`require_finite`) or whose iteration fell inside a
        quarantined step (`reject_iterations`: a listener can save during
        the anomalous dispatch, before the judgment), and exempts the
        learning rate from the configuration check (`lr_drift_ok`: a
        backoff changed it)."""
        from deeplearning4j_tpu_torch.train.checkpoint import (
            NoUsableCheckpointError,
            checkpoint_candidates,
            note_bad_checkpoint,
            verified_checkpoints,
        )
        from deeplearning4j_tpu_torch.utils.model_serializer import (
            ConfigMismatchError,
            restore_fit_state,
        )

        meta = path = None
        for cand_path, cand_meta in verified_checkpoints(directory):
            if reject_iterations and int(
                    cand_meta.get("iteration", -1)) in reject_iterations:
                # finite and digest-clean, and still holding the update
                # the sentinel discarded
                note_bad_checkpoint(
                    cand_path, "captured from a quarantined step")
                continue
            try:
                meta = restore_fit_state(self, cand_path,
                                         ignore_lr=lr_drift_ok)
            except ConfigMismatchError:
                # a changed architecture is a USER error every candidate
                # repeats — raise it, don't discard the history
                raise
            except Exception as e:
                note_bad_checkpoint(
                    cand_path, f"restore failed: {type(e).__name__}: {e}")
                meta = None
                continue
            if require_finite and not self._params_finite():
                note_bad_checkpoint(
                    cand_path, "restored parameters are non-finite")
                meta = None
                continue
            path = cand_path
            break
        if meta is None:
            if any(True for _ in checkpoint_candidates(directory)):
                raise NoUsableCheckpointError(
                    f"resume_from={directory!r}: checkpoints exist but "
                    f"every candidate was rejected (see "
                    f"checkpoint_integrity_failures_total and the "
                    f"checkpoint_corrupt events) — not starting fresh "
                    f"over a corrupted history")
            logger.info("resume_from=%r: no checkpoint found — starting "
                        "fresh", directory)
            return 0, epochs, None
        ts = meta.get("train_state") or {}
        skip = int(ts.get("batch_in_epoch", 0))
        it_state = ts.get("iterator_state")
        if it_state is not None:
            restore = getattr(iterator, "restore_state", None)
            if callable(restore):
                restore(it_state)
            else:
                logger.warning(
                    "checkpoint carries iterator state but the iterator "
                    "has no restore_state(); mid-epoch replay may not be "
                    "deterministic")
        remaining = max(0, int(epochs) - int(self.epoch))
        if remaining == 0 and skip > 0:
            remaining = 1  # died inside the final epoch: finish it
        logger.info(
            "resumed from %s: iteration=%d epoch=%d, replaying %d "
            "batch(es), %d epoch(s) remaining", path, self.iteration,
            self.epoch, skip, remaining)
        _blackbox.get_recorder().record_event(
            "resume", checkpoint=path, iteration=int(self.iteration),
            epoch=int(self.epoch), skip_batches=skip)
        return skip, remaining, path

    def _params_finite(self) -> bool:
        """Whether every parameter is finite: one device reduction, one
        host read (the rollback's guard against a checkpoint saved after
        the divergence reached the parameters)."""
        flags = [torch.isfinite(v).all()
                 for p in self.params_list for v in p.values()]
        return bool(torch.stack(flags).all()) if flags else True

    def _rollback_restore(self, iterator, total_epoch_target: int):
        """Answer a sentinel RollbackSignal: account the attempt (bounded;
        optional lr backoff), end the abandoned epoch's pipeline run and
        rewind the iterator, then restore the newest checkpoint that
        verifies, loads, is finite and was not saved during a quarantined
        step. Returns the (skip_batches, epochs_remaining) of the
        replay."""
        from deeplearning4j_tpu_torch.train.checkpoint import (
            NoUsableCheckpointError,
        )

        sent = self._sentinel
        directory = sent.note_rollback(self)
        hb = self._fit_heartbeat
        if hb is not None:
            hb.beat()
        # the RollbackSignal left `for ds in iterator` mid-run: close the
        # run (a staged pipeline's workers and in-flight copies end here)
        # and rewind; restore_state below sets the position when the
        # iterator keeps the resume protocol
        close = getattr(iterator, "close", None)
        if callable(close):
            close()
        iterator.reset()
        try:
            skip, remaining, path = self._restore_for_resume(
                directory, iterator, total_epoch_target,
                require_finite=True, lr_drift_ok=True,
                reject_iterations=sent.tainted_iterations)
        except NoUsableCheckpointError as e:
            sent.diverged(str(e))
        if path is None:
            sent.diverged(
                f"rollback found no usable checkpoint in {directory!r}")
        if self._mesh_plan is not None:
            self._mesh_plan.place_net(self)
        self._step_diag = None
        if hb is not None:
            hb.beat()
        return skip, remaining

    def _stage_input_pipeline(self, iterator, prefetch_buffer: int):
        """The staged input pipeline around a fit's iterator:

            [caller's host ETL] -> AsyncDataSetIterator -> device prefetch

        A caller-built DevicePrefetchIterator is the pipeline as it is (it
        must apply the net's input transform); a caller's host stage
        (AsyncDataSetIterator or ParallelDataSetIterator) is kept, else a
        host prefetch thread is added. The device stage copies each batch
        to the net's device and runs the input transform in its worker,
        `_prefetch_depth` batches ahead of the step."""
        from deeplearning4j_tpu_torch.data.prefetch import (
            DevicePrefetchIterator,
            ParallelDataSetIterator,
        )

        if isinstance(iterator, DevicePrefetchIterator):
            if self._input_transform is not None and \
                    iterator.transform is not self._input_transform:
                raise ValueError(
                    "a DevicePrefetchIterator was passed to fit() but the "
                    "network has an input transform the iterator does not "
                    "apply: build the iterator with transform=, or pass the "
                    "base iterator and let fit compose the pipeline")
            return iterator
        host, wrapped = iterator, False
        if not isinstance(host, (AsyncDataSetIterator, ParallelDataSetIterator)):
            host, wrapped = AsyncDataSetIterator(host, prefetch_buffer), True
        if self._mesh_plan is not None:
            # this rank's rows are cut in the device stage's worker, before
            # its copy
            host = _ShardingIterator(host, self._mesh_plan)
        return DevicePrefetchIterator(
            host, depth=self._prefetch_depth, device=self.device,
            transform=self._input_transform, close_base=wrapped)

    def _fit_epochs(self, iterator, epochs: int, fuse_k: int = 1,
                    skip_batches: int = 0):
        skip = int(skip_batches)
        for _ in range(epochs):
            for lst in self.listeners:
                lst.on_epoch_start(self, self.epoch)
            # resume coordinates for this epoch: captured BEFORE the
            # first batch is pulled, so a checkpoint taken anywhere in
            # the epoch can restore the iterator to the same epoch start
            # (the shuffle permutation) and skip forward
            self._train_state = {
                "epoch": int(self.epoch),
                "batch_in_epoch": 0,
                "iterator_state": self._capture_iterator_state(iterator),
            }
            t_etl = time.perf_counter()
            # a fused group in the making; its data wait accumulates so
            # the group's dispatch carries all the blocking it amortizes
            buf, sig, wait_accum = [], None, 0.0

            def flush():
                group, n = list(buf), sum(_examples_of(d) for d in buf)
                self._timed_fit(lambda: self._flush_fused(group, fuse_k),
                                wait_accum, n, n_batches=len(group),
                                batches=group)
                buf.clear()

            # the pulls are spans of their own (`fit/data_wait`, with a
            # prefetch-off batch's inline staging); the generator is
            # closed on the way out, so an epoch that raises closes its
            # pipeline workers at once
            pulls = iter(iterator)
            try:
                while True:
                    with _tracing.span("fit/data_wait"):
                        ds = next(pulls, _END)
                        if ds is _END:
                            break
                        wait = time.perf_counter() - t_etl
                        self._last_etl_ms = wait * 1e3
                        if self._mesh_plan is not None:
                            # prefetch off: this rank's rows, inline (a
                            # no-op on a batch the pipeline already sharded)
                            ds = self._mesh_plan.shard_batch(ds)
                        if not getattr(ds, "_pipeline_staged", False) and \
                                self._input_transform is not None:
                            # prefetch off: the staging work runs inline
                            # (the same ops in the same order as the
                            # pipeline's worker)
                            ds = self._input_transform(ds)
                    if skip > 0:
                        # mid-epoch replay: this batch was trained before
                        # the checkpoint — consumed from the iterator (and
                        # transformed, so every stage's step counter
                        # advances as in the original run), not dispatched
                        # (its update is in the restored params)
                        skip -= 1
                        self._train_state["batch_in_epoch"] += 1
                        t_etl = time.perf_counter()
                        continue
                    if (self._sentinel is not None
                            and self._sentinel.should_skip_batch(self, ds)):
                        # a quarantined batch met again (the replay after
                        # a rollback, or the next epoch's pass): consumed,
                        # not dispatched, since it would diverge again
                        self._train_state["batch_in_epoch"] += 1
                        t_etl = time.perf_counter()
                        continue
                    # every batch counted so far is trained: a
                    # consistent point
                    _sigchain.safe_point()
                    if fuse_k > 1:
                        s = self._ds_signature(ds)
                        if buf and s != sig:
                            # flush BEFORE charging this batch's wait: it
                            # belongs to the group this batch starts
                            flush()
                            wait_accum = 0.0
                        wait_accum += wait
                        sig = s
                        buf.append(ds)
                        if len(buf) == fuse_k:
                            flush()
                            wait_accum = 0.0
                    else:
                        self._timed_fit(lambda: self._fit_dataset(ds), wait,
                                        _examples_of(ds), batches=[ds])
                    t_etl = time.perf_counter()
            finally:
                close = getattr(pulls, "close", None)
                if close is not None:
                    close()
            if buf:
                flush()
            if skip > 0:
                # the resumed epoch ended with replay batches still owed
                # (the iterator is shorter than at checkpoint time):
                # continue from the next epoch start, loudly
                logger.warning(
                    "resume fast-forward ran out of batches with %d still "
                    "to skip (iterator shorter than at checkpoint time); "
                    "continuing from the next epoch start", skip)
                skip = 0
            _sigchain.safe_point()  # the epoch's batches are all trained
            for lst in self.listeners:
                lst.on_epoch_end(self, self.epoch)
            self.epoch += 1
            iterator.reset()

    def _flush_fused(self, group, fuse_k: int) -> None:
        """A full group runs fused; a smaller one batch by batch (a program
        per group size would defeat the cache)."""
        if len(group) == fuse_k:
            self._fit_datasets_fused(group)
        else:
            for ds in group:
                self._fit_dataset(ds)

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
        """Flattened parameter vector (reference: Model.params()); a
        tensor-parallel net's global values."""
        self._require_init()
        return params_to_flat(self._ordered_layer_confs(), self._global_params()[0])

    def set_params(self, flat):
        self._require_init()
        self.params_list = flat_to_params(
            self._ordered_layer_confs(), self.params_list, flat
        )
        self._reset_step_programs()

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

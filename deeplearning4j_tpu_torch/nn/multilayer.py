"""MultiLayerNetwork — the sequential network.

Analog of the reference's nn/multilayer/MultiLayerNetwork.java and the
port of the JAX package's nn/multilayer.py: init, the forward pass,
`output`, `feed_forward`, streaming `rnn_time_step`, the pure decode step
the serving engine drives, and training: the loss, `fit` with truncated
BPTT, and `score`; the optimizer step and the L1/L2 terms are
nn/netbase.py's, shared with ComputationGraph.

Where the JAX package compiles forward + loss + backward + updater into
one jitted program, the port runs a step eagerly: autograd gives the
gradients (through the fused LSTM kernels' autograd Function on a Hopper
GPU), and the updater adds its deltas to the parameters in place. The
JAX package's single-dispatch programs are ported as fused programs
(nn/netbase.py `_run_fused`): a listener-free TBPTT batch runs all its
segments as one program, and `set_fused_steps(k)` runs k same-shape
batches (standard or TBPTT) as one; each is one CUDA graph on the card
and the same loop of steps on the CPU. Layerwise pretraining
(`pretrain`, `pretrain_layer`: AutoEncoder, VAE and RBM layers) runs its
steps eagerly, and so do the line-search solvers (train/solvers.py, an
`optimization_algo` other than sgd: `_fit_line_search`).

Parameters are a list of per-layer dicts of tensors on the network's
device; the flattened view comes from nn/params.py. Mutable
non-trainable state (LSTM h/c during TBPTT and rnnTimeStep streaming) is
a parallel list threaded functionally through the forward.
"""

from __future__ import annotations

import copy
import logging
from typing import List, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.common.devices import resolve_device
from deeplearning4j_tpu_torch.common.dtypes import policy_from_name
from deeplearning4j_tpu_torch.data.dataset import DataSet
from deeplearning4j_tpu_torch.data.iterators import (
    DataSetIterator,
    ListDataSetIterator,
)
from deeplearning4j_tpu_torch.nn.conf import layers as L
from deeplearning4j_tpu_torch.nn.conf.network import (
    BackpropType,
    MultiLayerConfiguration,
)
from deeplearning4j_tpu_torch.nn.layers.core import (
    affine,
    apply_dropout,
    autoencoder_keep,
    autoencoder_reconstruct,
    center_loss_term,
)
from deeplearning4j_tpu_torch.nn.layers.rbm import rbm_cd_stats, rbm_noise
from deeplearning4j_tpu_torch.nn.layers.special import vae_elbo, vae_eps
from deeplearning4j_tpu_torch.nn.layers.registry import (
    LayerContext,
    forward_layer,
    init_layer_params,
    init_layer_state,
)
from deeplearning4j_tpu_torch.nn.netbase import (
    NetworkBase,
    _examples_of,
    _is_recurrent,
    _layer_seed,
)
from deeplearning4j_tpu_torch.ops.losses import loss_value, masked_example_mean
from deeplearning4j_tpu_torch.train.evaluation import (
    Evaluation,
    RegressionEvaluation,
)
from deeplearning4j_tpu_torch.train.updaters import schedule_lr, updater_from_conf

logger = logging.getLogger("deeplearning4j_tpu_torch")

_OUTPUT_LAYER_TYPES = (L.OutputLayer, L.RnnOutputLayer, L.LossLayer,
                       L.CenterLossOutputLayer)
_PRETRAINABLE = (L.AutoEncoder, L.VariationalAutoencoder, L.RBM)


def _preout_of_output_layer(conf, params, x):
    """Pre-activation of the final (output) layer — the quantity losses
    consume (reference: BaseOutputLayer.preOutput2d)."""
    if isinstance(conf, L.LossLayer):
        return x
    return affine(x, params["W"], params["b"])


class MultiLayerNetwork(NetworkBase):
    """Sequential network. API mirrors the reference: init, fit, output,
    score, params/set_params, rnn_time_step. Runs on `device` ("cuda"
    when None; pass device="cpu" for the CPU)."""

    def __init__(self, conf: MultiLayerConfiguration, device=None):
        super().__init__()
        self.conf = conf
        self.device = resolve_device(device)
        self.layer_confs: List[L.LayerConf] = list(conf.layers)
        self.net_conf = conf.net_conf
        self.policy = policy_from_name(self.net_conf.precision)
        self.policy.apply()
        self.updater_def = updater_from_conf(self.net_conf)
        self._rnn_states = None  # streaming inference state (rnn_time_step)

    def _ordered_layer_confs(self):
        return self.layer_confs

    # -- init ----------------------------------------------------------------

    def init(self) -> "MultiLayerNetwork":
        dtype = self.policy.param_dtype
        self.params_list = []
        self.state_list = []
        for i, conf in enumerate(self.layer_confs):
            gen = torch.Generator().manual_seed(_layer_seed(self.net_conf.seed, i))
            p = init_layer_params(gen, conf, dtype)
            self.params_list.append({k: v.to(self.device) for k, v in p.items()})
            st = init_layer_state(conf, dtype)
            self.state_list.append(
                None if st is None else {k: v.to(self.device) for k, v in st.items()})
        self.upd_state = self.updater_def.init_tree(self.params_list)
        return self

    # -- forward -------------------------------------------------------------

    def _forward(self, params, states, x, *, training, rng, f_mask=None,
                 stateful=False, preout_last=False, to_layer=None):
        """Pure forward. Returns (out, new_states). With `preout_last` the
        output layer returns its pre-activation, for the loss; with
        `to_layer` the walk stops before that layer (its input is the
        output)."""
        confs = self.layer_confs
        pps = self.conf.preprocessors
        new_states: List[Optional[dict]] = [None] * len(confs)
        timesteps = x.shape[1] if x.dim() == 3 else None
        for i, conf in enumerate(confs[:to_layer]):
            pp = pps.get(str(i))
            if pp is not None:
                x = pp(x, {"timesteps": timesteps})
            if x.dim() == 3:
                timesteps = x.shape[1]
            st = states[i]
            if stateful and _is_recurrent(conf) and st is None:
                st = {}  # empty dict triggers zero-state seed + state return
            ctx = LayerContext(training=training, rng=rng,
                               mask=f_mask if x.dim() == 3 else None,
                               timesteps=timesteps, state=st, tp=self._tp_context(i))
            if (preout_last and i == len(confs) - 1
                    and isinstance(conf, _OUTPUT_LAYER_TYPES)):
                # input dropout applies to the output layer too (reference:
                # BaseOutputLayer preOutput applies Dropout to its input)
                x = _preout_of_output_layer(
                    conf, params[i], apply_dropout(x, conf.dropout, ctx))
            else:
                x, new_states[i] = forward_layer(conf, params[i], x, ctx)
        return x, new_states

    def _merge_states(self, old, new):
        return [n if n is not None else o for o, n in zip(old, new)]

    def _tp_context(self, i: int):
        """Layer i's tensor-parallel (role, mesh, axis), or None."""
        if self._tp_specs is None or self._tp_specs[i] is None:
            return None
        from deeplearning4j_tpu_torch.parallel.tensor import tp_role

        return (tp_role(self._tp_specs[i], self._tp_axis), self._tp_mesh, self._tp_axis)

    # -- loss ----------------------------------------------------------------

    def _loss(self, params, states, x, y, f_mask, l_mask, rng, training=True):
        last = self.layer_confs[-1]
        if not isinstance(last, _OUTPUT_LAYER_TYPES):
            raise ValueError(
                "the final layer must be an OutputLayer/RnnOutputLayer/"
                "LossLayer to compute a training loss")
        x = self.policy.cast_input(x)
        if isinstance(last, L.CenterLossOutputLayer):
            score, new_states = self._center_loss(
                params, states, x, y, f_mask, l_mask, rng, training)
        else:
            preout, new_states = self._forward(
                params, states, x, training=training, rng=rng, f_mask=f_mask,
                preout_last=True)
            preout = self.policy.cast_output(preout)
            per_ex = loss_value(last.loss, y, preout, last.activation, l_mask)
            score = masked_example_mean(per_ex, l_mask)
        return score + self._reg_penalty(params), new_states

    def _center_loss(self, params, states, x, y, f_mask, l_mask, rng, training):
        """Center loss (reference: CenterLossOutputLayer.java): the base
        loss plus the center term on the output layer's input features,
        with the class centers EMA-updated as non-trainable state
        (nn/layers/core.center_loss_term)."""
        last = self.layer_confs[-1]
        n = len(self.layer_confs)
        feats, new_states = self._forward(
            params, states, x, training=training, rng=rng, f_mask=f_mask,
            to_layer=n - 1)
        feats = apply_dropout(feats, last.dropout,
                              LayerContext(training=training, rng=rng))
        preout = self.policy.cast_output(
            _preout_of_output_layer(last, params[-1], feats))
        per_ex = loss_value(last.loss, y, preout, last.activation, l_mask)
        term, new_state = center_loss_term(last, states[-1], feats, y, per_ex,
                                           l_mask, training)
        if new_state is not None:
            new_states[-1] = new_state
        return masked_example_mean(per_ex, l_mask) + term, new_states

    # -- train step ----------------------------------------------------------

    def _std_loss_builder(self):
        def loss_builder(p, states, data, rng):
            x, y, f_mask, l_mask = data
            return self._loss(p, states, x, y, f_mask, l_mask, rng)

        return loss_builder

    def _trunc_loss_builder(self):
        """TBPTT loss with tbptt_bwd_length < tbptt_fwd_length: the
        segment's leading (fwd - bwd) timesteps run under torch.no_grad()
        (the JAX package's stop_gradient): the state advances and their
        loss counts in the score, but no gradient flows back through them
        (reference: tBPTTBackwardLength, MultiLayerNetwork.java:1333)."""

        def loss_builder(p, states, data, rng):
            xA, yA, fmA, lmA, xB, yB, fmB, lmB = data
            with torch.no_grad():
                lossA, statesA = self._loss(p, states, xA, yA, fmA, lmA, rng)
            carried = self._merge_states(states, statesA)
            lossB, statesB = self._loss(p, carried, xB, yB, fmB, lmB, rng)
            nA, nB = xA.shape[1], xB.shape[1]
            score = (lossA * nA + lossB * nB) / (nA + nB)
            return score, self._merge_states(carried, statesB)

        return loss_builder

    def _fit_step(self, x, y, f_mask, l_mask, stateful_states=None):
        """One optimizer step. Returns (states, device score)."""
        return self._run_step(self._std_loss_builder(),
                              (x, y, f_mask, l_mask), stateful_states)

    # -- pretraining ---------------------------------------------------------

    def pretrain(self, data, *, epochs: int = 1, batch_size: int = 32,
                 noise=None):
        """Layerwise unsupervised pretraining: each pretrainable layer
        (AutoEncoder / VAE / RBM), in order, trains on the activations of
        the stack below it (reference: MultiLayerNetwork.pretrain
        :210-287). `noise` as in `pretrain_layer`."""
        self._require_init()
        for i, conf in enumerate(self.layer_confs):
            if isinstance(conf, _PRETRAINABLE):
                self.pretrain_layer(i, data, epochs=epochs,
                                    batch_size=batch_size, noise=noise)
        return self

    def pretrain_layer(self, idx: int, data, *, epochs: int = 1,
                       batch_size: int = 32, noise=None):
        """Unsupervised fit of layer `idx` with the network's updater (a
        fresh state) and `schedule_lr`. Objectives: AutoEncoder = its
        conf.loss between the input and the tied-weight reconstruction of
        the corrupted input; VAE = the negative ELBO; RBM = CD-k
        statistics. The input is the inference-mode forward of the layers
        below. `data` is a DataSetIterator, a DataSet or a features array
        (labels are not used).

        Each step runs eagerly on the card (no fused program and no CUDA
        graph), one optimizer step per batch. Its noise — the
        AutoEncoder's keep mask, the VAE's eps, the RBM chain's uniforms or
        normals, in the shapes of `pretrain_noise` — comes from
        `noise(idx, iteration, x_in)` when given, else from
        `_pretrain_noise`."""
        self._require_init()
        conf = self.layer_confs[idx]
        if not isinstance(conf, _PRETRAINABLE):
            raise ValueError(
                f"layer {idx} ({type(conf).__name__}) is not pretrainable")
        if isinstance(data, DataSetIterator):
            iterator = data
        elif isinstance(data, DataSet):
            iterator = ListDataSetIterator(data, batch_size)
        else:  # raw features; labels are unused in unsupervised fit
            x = np.asarray(data)
            iterator = ListDataSetIterator(DataSet(x, x), batch_size)
        params = self.params_list[idx]
        upd_state = self.updater_def.init_tree([params])
        it = 0
        for _ in range(epochs):
            for ds in iterator:
                with torch.no_grad():
                    x_in = self._forward(
                        self.params_list, self.state_list,
                        self.policy.cast_input(self._as_data(ds.features)),
                        training=False, rng=None, to_layer=idx)[0]
                eps = (noise or self._pretrain_noise)(idx, it, x_in)
                lr = torch.tensor(schedule_lr(self.net_conf, it), dtype=torch.float32,
                                  device=self.device)
                t = torch.tensor(float(it), dtype=torch.float32, device=self.device)
                self._score = self._pretrain_step(conf, params, upd_state, x_in,
                                                  lr, t, eps)
                it += 1
            iterator.reset()
        return self

    def _pretrain_noise(self, idx: int, it: int, x_in):
        """Pretraining step `it`'s noise for layer `idx`, from a generator
        seeded by the network's seed, the layer and the iteration."""
        gen = torch.Generator(device=self.device).manual_seed(
            ((self.net_conf.seed ^ (0xBEEF + idx)) * 1_000_003 + it) % (2 ** 63))
        return pretrain_noise(self.layer_confs[idx], x_in, gen)

    def _pretrain_step(self, conf, params, upd_state, x_in, lr, t, eps):
        """One pretraining step of one layer, in place; returns the score."""
        if isinstance(conf, L.RBM):
            grads, per_ex = rbm_cd_stats(conf, params, x_in, noise=eps)
            score = per_ex.mean()
        else:
            leaves = list(params.values())
            for v in leaves:
                v.requires_grad_(True)
            try:
                if isinstance(conf, L.VariationalAutoencoder):
                    score = vae_elbo(conf, params, x_in, eps=eps).mean()
                else:
                    recon = autoencoder_reconstruct(
                        conf, params, x_in, LayerContext(training=True), keep=eps)
                    score = loss_value(conf.loss, x_in, recon, "identity", None).mean()
                grads = dict(zip(params, torch.autograd.grad(score, leaves)))
            finally:
                for v in leaves:
                    v.requires_grad_(False)
        self.updater_def.step_([params], [grads], upd_state, lr, t)
        return score.detach()

    # -- fit -----------------------------------------------------------------

    def fit(self, data, labels=None, *, epochs: int = 1, batch_size: int = 32,
            async_prefetch: bool = True, prefetch_buffer: int = 4,
            hang_timeout: float = None, resume_from: str = None,
            run_ledger=None):
        """Train. Accepts (features, labels) arrays, a DataSet, or a
        DataSetIterator (reference: MultiLayerNetwork.fit overloads :1019).
        With `async_prefetch` the staged input pipeline (a host prefetch
        thread with a `prefetch_buffer`-deep queue, then the device stage,
        nn/netbase._stage_input_pipeline) feeds the loop; without it each
        batch is read and moved to the device inline, to the same bits.
        `hang_timeout`
        (seconds) arms the hang watchdog: a step making no progress for
        that long raises utils.health.StepHangError carrying a
        flight-recorder dump path. `resume_from` names a checkpoint
        directory (train/checkpoint.CheckpointListener): the newest good
        checkpoint is loaded into this net, the iterator is fast-forwarded
        to the saved mid-epoch position, and training continues to the
        loss curve of an uninterrupted run; an empty directory starts
        fresh. `epochs` stays the TOTAL target. If the configuration sets
        pretrain, layerwise pretraining (`pretrain`) runs once, before the
        first backprop epoch (reference: fit() pretrain dispatch :210).
        `run_ledger` (a path or a utils.runledger.RunLedger) records the
        fit's metrics: a path's ledger is closed when the fit ends, a
        given ledger is attached for the fit and left open."""
        self._require_init()
        if self.upd_state is None:
            self.upd_state = self.updater_def.init_tree(self.params_list)
        if self.conf.pretrain and not getattr(self, "_pretrained", False):
            self.pretrain(data, batch_size=batch_size)
            self._pretrained = True
        return self._run_fit(self._as_iterator(data, labels, batch_size),
                             epochs, async_prefetch, prefetch_buffer,
                             hang_timeout=hang_timeout,
                             resume_from=resume_from, run_ledger=run_ledger)

    def _as_iterator(self, data, labels, batch_size) -> DataSetIterator:
        if isinstance(data, DataSetIterator):
            return data
        if isinstance(data, DataSet):
            return ListDataSetIterator(data, batch_size)
        return ListDataSetIterator(DataSet(np.asarray(data), np.asarray(labels)),
                                   batch_size)

    def _ds_arrays(self, ds):
        return (ds.features, ds.labels, ds.features_mask, ds.labels_mask)

    def _fit_dataset(self, ds: DataSet):
        algo = self.net_conf.optimization_algo
        if algo != "sgd":
            self._fit_line_search(ds, algo)
            return
        data = tuple(self._as_data(a) for a in self._ds_arrays(ds))
        if (self.conf.backprop_type == BackpropType.TRUNCATED_BPTT
                and data[0].dim() == 3):
            self._fit_tbptt(ds, data)
        else:
            states, _ = self._fit_step(*data)
            self._commit_states(states)
            self._notify(_examples_of(ds), ds)

    def _fit_line_search(self, ds: DataSet, algo: str):
        """One batch through a line-search optimizer (LBFGS, CG, line
        gradient descent; reference: BaseOptimizer.optimize :182-230): a
        host search loop around the loss and its gradient on the flat
        parameter vector, which stays on the net's device. The result is
        copied into the parameter tensors in place. The step's random
        numbers come from the SGD step's generator (`_step_rng`). No
        diagnostic is left (`_step_diag` None): a sentinel judges the
        score alone, as in the JAX package. Under a data mesh each rank
        binds its rows of the global batch, and the loss and gradient the
        search reads are summed over the data axis (train/solvers
        `_FlatProblem`), so every rank takes the same search decisions."""
        from deeplearning4j_tpu_torch.nn.params import flat_to_params, params_to_flat
        from deeplearning4j_tpu_torch.train.solvers import (
            _FlatProblem,
            make_line_search_optimizer,
        )

        if getattr(self, "_solver", None) is None or self._solver.name != algo:
            self._solver = make_line_search_optimizer(algo)
            self._flat_problem = _FlatProblem(self)
        x, y, fm, lm = (self._as_data(a) for a in self._ds_arrays(ds))
        problem = self._flat_problem.bind(self.state_list, x, y, fm, lm,
                                          self._step_rng(self.iteration))
        flat = params_to_flat(self.layer_confs, self.params_list)
        step0 = schedule_lr(self.net_conf, self.iteration)
        new_flat, f_new = self._solver.optimize(problem, flat, step0)
        with torch.no_grad():
            for live, new in zip(self.params_list, flat_to_params(
                    self.layer_confs, self.params_list, new_flat)):
                for k, v in live.items():
                    v.copy_(new[k])
        self._score = torch.tensor(f_new, dtype=torch.float32, device=self.device)
        self._step_diag = None
        self.iteration += 1
        self._notify(_examples_of(ds), ds)

    # -- multi-batch fused fit (set_fused_steps) -----------------------------

    def _fused_fit_supported(self) -> bool:
        return self.net_conf.optimization_algo == "sgd"

    def _fit_datasets_fused(self, ds_list):
        """k same-shape batches as one fused program (see
        NetworkBase.set_fused_steps): the cross-batch TBPTT program for
        3-d TBPTT batches (a ragged tail goes batch by batch), the
        standard one otherwise. The recurrent carry restarts from zero at
        each batch; only non-recurrent state runs through the group."""
        data = [self._ds_arrays(ds) for ds in ds_list]
        sig = self._ds_signature(ds_list[0])
        k = len(ds_list)
        if (self.conf.backprop_type == BackpropType.TRUNCATED_BPTT
                and len(sig[0]) == 3):
            n_seg = self._tbptt_fusable(data[0])
            if n_seg is None:
                for ds in ds_list:
                    self._fit_dataset(ds)
                return
            self._run_fused(("tbptt", sig, k), data, k * n_seg,
                            self._tbptt_group_batch)
            return
        self._run_fused(("std", sig, k), data, k, self._std_group_batch)

    def score(self, data, labels=None) -> float:
        """Loss on a dataset without updating (reference:
        MultiLayerNetwork.score(DataSet))."""
        self._require_init()
        ds = data if isinstance(data, DataSet) else DataSet(
            np.asarray(data), np.asarray(labels))
        with torch.no_grad():
            s, _ = self._loss(
                self.params_list, self.state_list,
                *(self._as_data(a) for a in (ds.features, ds.labels,
                                             ds.features_mask, ds.labels_mask)),
                rng=None, training=False)
        return float(s)

    def evaluate(self, data, labels=None, batch_size: int = 256) -> Evaluation:
        """Classification evaluation (reference: evaluate/doEvaluation
        :2605-2646). Each batch's output moves to the host once."""
        ev = Evaluation()
        for ds in self._eval_batches(data, labels, batch_size):
            out = self.output(ds.features)
            ev.eval_batch(ds.labels, out, ds.labels_mask)
        return ev

    def evaluate_regression(self, data, labels=None,
                            batch_size: int = 256) -> RegressionEvaluation:
        ev = RegressionEvaluation()
        for ds in self._eval_batches(data, labels, batch_size):
            out = self.output(ds.features)
            ev.eval_batch(ds.labels, out, ds.labels_mask)
        return ev

    def _eval_batches(self, data, labels, batch_size):
        if isinstance(data, DataSetIterator):
            yield from data
        elif isinstance(data, DataSet):
            yield from data.split_batches(batch_size)
        else:
            yield from DataSet(np.asarray(data),
                               np.asarray(labels)).split_batches(batch_size)

    # -- inference -----------------------------------------------------------

    def output(self, x, training: bool = False):
        """Full forward pass (reference: MultiLayerNetwork.output).
        training=True gives train-mode activations (dropout active) with a
        deterministic per-call generator. Returns a tensor on the
        network's device."""
        self._require_init()
        xx = self._as_input(x)

        def make_fn():
            def fwd(params, states, xx, rng):
                xx = self.policy.cast_input(xx)
                out, _ = self._forward(params, states, xx,
                                       training=training, rng=rng)
                return self.policy.cast_output(out)

            return fwd

        fn = self._cached_output_fn(
            (training, tuple(xx.shape), str(xx.dtype)), make_fn)
        rng = None
        if training:
            rng = torch.Generator(device=self.device).manual_seed(
                self.net_conf.seed ^ 0xD0)
        with torch.no_grad():
            return fn(self.params_list, self.state_list, xx, rng)

    def feed_forward(self, x):
        """Per-layer activations list (reference: feedForward family)."""
        self._require_init()
        acts = []
        xx = self._as_input(x)
        timesteps = xx.shape[1] if xx.dim() == 3 else None
        with torch.no_grad():
            for i, conf in enumerate(self.layer_confs):
                pp = self.conf.preprocessors.get(str(i))
                if pp is not None:
                    xx = pp(xx, {"timesteps": timesteps})
                if xx.dim() == 3:
                    timesteps = xx.shape[1]
                ctx = LayerContext(training=False, state=self.state_list[i],
                                   timesteps=timesteps)
                xx, _ = forward_layer(conf, self.params_list[i], xx, ctx)
                acts.append(xx)
        return acts

    # -- rnn streaming inference ---------------------------------------------

    def _rnn_layer_size(self, i: int) -> int:
        conf = self.layer_confs[i]
        inner = conf.inner if isinstance(conf, L.FrozenLayer) else conf
        return int(inner.n_out)

    def _zero_hc(self, i: int, batch: int) -> dict:
        H = self._rnn_layer_size(i)
        dt = self.policy.compute_dtype
        return {"h": torch.zeros((batch, H), dtype=dt, device=self.device),
                "c": torch.zeros((batch, H), dtype=dt, device=self.device)}

    def rnn_zero_carry(self, batch: int) -> dict:
        """Zero recurrent carry for a `batch`-wide stream: {layer index
        -> {"h", "c"} [batch, H]} for every recurrent layer — the state
        a fresh rnn_time_step stream (or a freshly admitted decode slot)
        starts from, in the compute dtype."""
        self._require_init()
        return {i: self._zero_hc(i, batch)
                for i, c in enumerate(self.layer_confs) if _is_recurrent(c)}

    def _rnn_seed_states(self, carry: dict, batch: int):
        """Full state list for a streaming step: recurrent layers from
        `carry` (zero-seeded when absent), everything else from
        state_list."""
        states = []
        for i, c in enumerate(self.layer_confs):
            if _is_recurrent(c):
                st = carry.get(i)
                states.append(self._zero_hc(i, batch) if st is None else st)
            else:
                states.append(self.state_list[i])
        return states

    def rnn_time_step(self, x):
        """Stateful streaming inference (reference:
        MultiLayerNetwork.rnnTimeStep). x: [batch, time, nIn] (or
        [batch, nIn] for a single step). A call whose batch size differs
        from the carried state starts a NEW stream: the stale carry is
        dropped (loudly) instead of leaking a previous caller's hidden
        state into this one."""
        self._require_init()
        xx = self._as_input(x)
        single = xx.dim() == 2
        if single:
            xx = xx[:, None, :]
        bsz = xx.shape[0]
        # only the recurrent carry persists between calls
        carry = self._rnn_states or {}
        if carry and any(v.shape[0] != bsz
                         for st in carry.values() for v in st.values()):
            logger.warning(
                "rnn_time_step batch size changed (carried %d, got %d): "
                "dropping the previous stream's state — call "
                "clear_rnn_state() between streams to silence this",
                next(iter(carry.values()))["h"].shape[0], bsz)
            carry = {}
            self._rnn_states = None
        states = self._rnn_seed_states(carry, bsz)

        def make_fn():
            def fwd(params, states, xx):
                out, new_states = self._forward(
                    params, states, self.policy.cast_input(xx),
                    training=False, rng=None, stateful=True,
                )
                return self.policy.cast_output(out), new_states

            return fwd

        fn = self._cached_output_fn(
            ("rnn_step", tuple(xx.shape), str(xx.dtype)), make_fn)
        with torch.no_grad():
            out, new_states = fn(self.params_list, states, xx)
        merged = self._merge_states(states, new_states)
        self._rnn_states = {
            i: merged[i]
            for i, c in enumerate(self.layer_confs) if _is_recurrent(c)
        }
        return out[:, 0] if single else out

    def rnn_clear_previous_state(self):
        self._rnn_states = None

    def clear_rnn_state(self):
        """Reset the streaming-inference state — the next rnn_time_step
        call starts a fresh stream (alias of rnn_clear_previous_state)."""
        self.rnn_clear_previous_state()

    def rnn_decode_step_fn(self):
        """Pure single-step decode function for the continuous-batching
        serving tier (serving/decode.py):

            (params, states, carry, x) -> (new_carry, out)

        `x` is ONE timestep [batch, nIn]; `carry` maps recurrent layer
        index -> {"h", "c"} [batch, H] (see `rnn_zero_carry`); `states`
        is the net's state_list (recurrent entries ignored in favor of
        `carry`); `out` is the post-activation output row [batch, nOut].
        Closed over the configuration only — params/states/carry are
        ARGUMENTS, which is what makes the decode engine's weight swap a
        reference flip. Call it under torch.no_grad()."""
        self._require_init()
        rec = frozenset(
            i for i, c in enumerate(self.layer_confs) if _is_recurrent(c))

        def step(params, states, carry, x):
            xx = self.policy.cast_input(x)[:, None, :]
            st = [carry[i] if i in rec else states[i]
                  for i in range(len(self.layer_confs))]
            out, new_states = self._forward(
                params, st, xx, training=False, rng=None, stateful=True,
            )
            new_carry = {
                i: (new_states[i] if new_states[i] is not None else st[i])
                for i in rec
            }
            return new_carry, self.policy.cast_output(out[:, 0])

        return step

    def clone(self) -> "MultiLayerNetwork":
        other = MultiLayerNetwork(copy.deepcopy(self.conf), device=self.device)
        if self.params_list is not None:
            other.params_list = [{k: v.clone() for k, v in p.items()}
                                 for p in self.params_list]
            other.state_list = [
                None if s is None else {k: v.clone() for k, v in s.items()}
                for s in self.state_list
            ]
            if self.upd_state is not None:
                other.upd_state = [{k: {n: v.clone() for n, v in s.items()}
                                    for k, s in p.items()} for p in self.upd_state]
        return other


def pretrain_noise(conf, x_in, gen):
    """One pretraining step's noise for layer `conf` on input `x_in`,
    drawn from `gen`: the AutoEncoder's keep mask [batch, nIn] (bool), the
    VAE's eps [samples, batch, nOut], the RBM chain's [k + 1, batch, nOut]."""
    B = x_in.shape[0]
    if isinstance(conf, L.AutoEncoder):
        return autoencoder_keep(conf, x_in.shape, gen, x_in.device)
    if isinstance(conf, L.VariationalAutoencoder):
        return vae_eps(conf, (B, int(conf.n_out)), gen, x_in.device, x_in.dtype)
    return rbm_noise(conf, B, gen, x_in.device, x_in.dtype)

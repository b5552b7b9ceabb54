"""ComputationGraph — the DAG network.

The port of the JAX package's nn/compgraph.py (reference:
nn/graph/ComputationGraph.java): the topological order is computed once
(:340,1055), the forward walks it calling each vertex (:1291-1292), and
the backward is autograd, so fan-out accumulation (:1480-1502) comes for
free. Training is the eager step shared with MultiLayerNetwork
(nn/netbase.py): autograd through the layers — the conv/BN kernels'
autograd Functions on a Hopper GPU — then the updater in place.

Parameters are a list of per-layer-vertex dicts in topological order, the
same flattening convention as MultiLayerNetwork, so params()/set_params()
and the carry-across from the JAX package (nn/params.py) work alike;
`state_list` holds the BatchNormalization running statistics.

One design decision is the port's own: the graph marks, at construction,
every BatchNormalization vertex whose only consumer is a relu
ActivationLayer. In training those BN layers return their output
rectified (the ReLU variant of the fused BN kernel, ops/fused_conv_bn.py,
on the kernel path) and the relu vertex passes it through. The JAX
package reaches the same kernel count through XLA's dead-code
elimination, which eager PyTorch does not have.

Truncated BPTT runs the segment loop of nn/netbase.py (`_tbptt_batch`)
over every temporal input, label and mask; a listener-free batch with no
ragged tail runs its segments as one fused program, and
`set_fused_steps(k)` runs k same-shape standard batches as one (one CUDA
graph on the card, the same loop of steps on the CPU); TBPTT batches
under it fuse per batch, as in the JAX package.

A FrozenLayer vertex runs its layer in inference mode and takes no
gradient or update (nn/netbase.py `_step`), so a frozen conv or BN never
reaches the training kernels, and a frozen BN is never marked for the
fused ReLU (it is not a BatchNormalization vertex). A
CenterLossOutputLayer head adds its center term to the score and keeps
its class centers as layer state.

Streaming inference (`rnn_time_step`) carries each recurrent layer's
(h, c) between calls, as MultiLayerNetwork's does. Any
`optimization_algo` trains by SGD: the JAX package's graph never reads
it (the line-search solvers are the sequential network's).

`set_block_scan` is the JAX package's scan over runs of
identically-configured, chain-connected units (ResNet-50's identity
blocks: 4 runs of 2, 3, 5 and 2), detected by the same configuration
analysis. PyTorch runs eagerly, so a scanned run walks its units one by
one as the unrolled graph does, and outputs, gradients and states are
bit-identical. What the scan changes is what it changes outside the
JAX package's compiled program: `feed_forward` reports only each run's
exit activation (the interior ones leave the walk's dict as the run
ends), and `compile_total{kind="graph_block"}` counts one body per run
whose units keep the carried shape against one per unit unrolled, at
each new forward-cache entry or step signature. A unit that changes the
carried shape, which the JAX scan refuses, counts and reports as
unrolled.
"""

from __future__ import annotations

import copy
import json
import os
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from deeplearning4j_tpu_torch.common.devices import resolve_device
from deeplearning4j_tpu_torch.common.dtypes import policy_from_name
from deeplearning4j_tpu_torch.data.dataset import DataSet, MultiDataSet
from deeplearning4j_tpu_torch.data.iterators import (
    DataSetIterator,
    ListDataSetIterator,
    MultiDataSetIterator,
)
from deeplearning4j_tpu_torch.nn.conf import layers as L
from deeplearning4j_tpu_torch.nn.conf.graph import (
    ComputationGraphConfiguration,
    ElementWiseVertex,
    LayerVertex,
    MergeVertex,
    ScaleVertex,
    ShiftVertex,
)
from deeplearning4j_tpu_torch.nn.conf.serde import config_to_dict
from deeplearning4j_tpu_torch.nn.layers.core import apply_dropout, center_loss_term
from deeplearning4j_tpu_torch.nn.layers.registry import (
    LayerContext,
    forward_layer,
    init_layer_params,
    init_layer_state,
)
from deeplearning4j_tpu_torch.nn.multilayer import (
    _OUTPUT_LAYER_TYPES,
    _preout_of_output_layer,
)
from deeplearning4j_tpu_torch.nn.netbase import (
    NetworkBase,
    _examples_of,
    _is_recurrent,
    _layer_seed,
    _slice_b_weight,
)
from deeplearning4j_tpu_torch.ops.losses import (
    loss_value,
    masked_example_mean,
    tied_sparse_mcxent,
)
from deeplearning4j_tpu_torch.train.evaluation import (
    Evaluation,
    RegressionEvaluation,
)
from deeplearning4j_tpu_torch.train.updaters import updater_from_conf


# -- runs of identical blocks ---------------------------------------------------


def _vertex_signature(v):
    """Structural identity of a vertex conf: (type, canonical-JSON config),
    or None when the vertex cannot join a run (a preprocessor, a
    recurrent or output layer, a vertex type outside the pointwise set)."""
    if isinstance(v, LayerVertex):
        lc = v.layer
        if v.preprocessor is not None:
            return None
        if _is_recurrent(lc) or isinstance(lc, _OUTPUT_LAYER_TYPES):
            return None
        body = lc
    elif isinstance(v, (ElementWiseVertex, MergeVertex, ScaleVertex,
                        ShiftVertex)):
        body = v
    else:
        return None
    try:
        return (type(v).__name__,
                json.dumps(config_to_dict(body), sort_keys=True))
    except Exception:
        return None


def _detect_block_runs(conf, topo, pidx_map):
    """Maximal runs of >= 2 consecutive identical units in the topo order.
    A unit of period p starting at topo index s repeats at s+p, s+2p, ...
    when each repeated vertex has the same signature and the same
    *relative* input offsets, every offset d at local position q is
    internal (d <= q) or the previous unit's exit (d == q+1), no vertex
    but the run's exit is consumed outside the run, and each unit holds
    at least one layer. Returns the run records `_forward` walks."""
    index = {n: i for i, n in enumerate(topo)}
    n = len(topo)
    sigs = [None] * n
    offsets = [None] * n
    for i, name in enumerate(topo):
        v = conf.vertices.get(name)
        if v is None:  # a graph input
            continue
        sigs[i] = _vertex_signature(v)
        offsets[i] = tuple(i - index[src] for src in conf.vertex_inputs[name])

    consumers: Dict[str, List[str]] = {}
    for name, ins in conf.vertex_inputs.items():
        for src in ins:
            consumers.setdefault(src, []).append(name)

    def unit_ok(s, p):
        """Template unit [s, s+p): signable, chain-connected."""
        for q in range(p):
            i = s + q
            if sigs[i] is None or offsets[i] is None:
                return False
            for d in offsets[i]:
                if not (1 <= d <= q + 1):
                    return False
        return any(isinstance(conf.vertices[topo[s + q]], LayerVertex)
                   for q in range(p))

    def repeats(s, p):
        k = 1
        while s + (k + 1) * p <= n:
            base = s + k * p
            if all(sigs[base + q] == sigs[s + q]
                   and offsets[base + q] == offsets[s + q] for q in range(p)):
                k += 1
            else:
                break
        return k

    def run_ok(s, p, k):
        lo, hi = s, s + p * k
        for i in range(lo, hi - 1):
            name = topo[i]
            if name in conf.outputs:
                return False
            for c in consumers.get(name, ()):
                if not (lo <= index[c] < hi):
                    return False
        return True

    runs = []
    i = len(conf.inputs)
    while i < n:
        found = None
        for p in range(1, (n - i) // 2 + 1):
            if not unit_ok(i, p):
                continue
            k = repeats(i, p)
            if k >= 2 and run_ok(i, p, k):
                found = (p, k)
                break  # smallest period = most units collapsed
        if found is None:
            i += 1
            continue
        p, k = found
        unit_names = topo[i:i + p]
        layer_slots = [q for q in range(p)
                       if isinstance(conf.vertices[unit_names[q]], LayerVertex)]
        runs.append({
            "start": i,
            "period": p,
            "count": k,
            "entry": topo[i - 1],
            "exit": topo[i + p * k - 1],
            "unit_names": unit_names,
            "offsets": [offsets[i + q] for q in range(p)],
            "layer_slots": layer_slots,
            "pidx_rows": [[pidx_map[topo[i + u * p + q]] for q in layer_slots]
                          for u in range(k)],
        })
        i += p * k
    return runs


def _signature(xs) -> tuple:
    return tuple((tuple(x.shape), str(x.dtype)) for x in xs)


def _as_multidataset(ds) -> MultiDataSet:
    if isinstance(ds, MultiDataSet):
        return ds
    if isinstance(ds, DataSet):
        return MultiDataSet(
            [ds.features], [ds.labels],
            None if ds.features_mask is None else [ds.features_mask],
            None if ds.labels_mask is None else [ds.labels_mask],
        )
    raise TypeError(f"expected DataSet or MultiDataSet, got {type(ds)}")


def relu_fused_bn_vertices(conf: ComputationGraphConfiguration) -> Dict[str, str]:
    """{BN vertex: its relu vertex} for every BatchNormalization vertex
    whose only consumer is a relu ActivationLayer vertex (and that is not
    a graph output): the BNs that apply the ReLU themselves in training.
    In ResNet-50: the stem's BN and each block's `_a` and `_b` BNs (33),
    but not `_c` and `_sc`, which feed the residual add."""
    consumers: Dict[str, List[str]] = {}
    for name, ins in conf.vertex_inputs.items():
        for src in ins:
            consumers.setdefault(src, []).append(name)
    out = {}
    for name, v in conf.vertices.items():
        if not (isinstance(v, LayerVertex)
                and isinstance(v.layer, L.BatchNormalization)):
            continue
        cs = consumers.get(name, [])
        if len(cs) != 1 or name in conf.outputs:
            continue
        c = conf.vertices[cs[0]]
        if (isinstance(c, LayerVertex) and isinstance(c.layer, L.ActivationLayer)
                and c.layer.activation == "relu" and c.preprocessor is None):
            out[name] = cs[0]
    return out


def tied_tables(conf: ComputationGraphConfiguration) -> Dict[str, str]:
    """{TiedOutputLayer vertex: the SequenceEmbeddingLayer vertex whose W it
    reads}, each checked: the table's rows are the head's outputs and its
    width the head's input, so that one leaf serves both uses."""
    out = {}
    for name, v in conf.vertices.items():
        if not (isinstance(v, LayerVertex) and isinstance(v.layer, L.TiedOutputLayer)):
            continue
        src = conf.vertices.get(v.layer.tied_to)
        if not (isinstance(src, LayerVertex)
                and isinstance(src.layer, L.SequenceEmbeddingLayer)):
            raise ValueError(f"{name}: tied_to {v.layer.tied_to!r} is not a "
                             "SequenceEmbeddingLayer vertex")
        e, h = src.layer, v.layer
        if h.n_out is not None and (h.n_out, h.n_in) != (e.n_in, e.n_out):
            raise ValueError(f"{name}: [{h.n_in} -> {h.n_out}] does not fit the table "
                             f"[{e.n_in}, {e.n_out}] of {v.layer.tied_to!r}")
        out[name] = v.layer.tied_to
    return out


class ComputationGraph(NetworkBase):
    """DAG network. API mirrors the reference: init, fit, output, score,
    params/set_params. Runs on `device` ("cuda" when None; pass
    device="cpu" for the CPU)."""

    def __init__(self, conf: ComputationGraphConfiguration, device=None):
        super().__init__()
        self.conf = conf
        self.device = resolve_device(device)
        self.net_conf = conf.net_conf
        self.policy = policy_from_name(self.net_conf.precision)
        self.policy.apply()
        self.updater_def = updater_from_conf(self.net_conf)
        self.topo: List[str] = conf.topological_order()
        self.layer_vertex_names: List[str] = [
            n for n in self.topo if isinstance(conf.vertices.get(n), LayerVertex)]
        self._pidx: Dict[str, int] = {
            n: i for i, n in enumerate(self.layer_vertex_names)}
        self._layer_confs: List[L.LayerConf] = [
            conf.vertices[n].layer for n in self.layer_vertex_names]
        self._tied = tied_tables(conf)
        # graph inputs of token ids: an integer batch there stays integer
        self._id_inputs = frozenset(
            n for n in conf.inputs
            if any(isinstance(conf.vertices[c], LayerVertex)
                   and isinstance(conf.vertices[c].layer, L.SequenceEmbeddingLayer)
                   for c, ins in conf.vertex_inputs.items() if n in ins))
        self.relu_fused_bn = relu_fused_bn_vertices(conf)
        self._relu_passed = frozenset(self.relu_fused_bn.values())
        self._block_scan = None  # None = DL4J_BLOCK_SCAN decides
        self._block_runs_cache = None
        # the forward signatures whose runs were counted in graph_block
        self._block_noted = frozenset()

    def _ordered_layer_confs(self):
        return self._layer_confs

    # -- runs of identical blocks ----------------------------------------------

    def set_block_scan(self, mode=True) -> "ComputationGraph":
        """Treat each run of identically-configured blocks as ONE scanned
        unit body instead of one body per block (True/"scan" on,
        False/"unroll" off, None = the DL4J_BLOCK_SCAN environment
        variable). Outputs and training are bit-identical;
        `compile_total{kind="graph_block"}` counts one body per run
        instead of one per block, and feed_forward() reports only each
        run's exit activation, as in the JAX package. Drops the forward
        cache and the fused steps' programs (a CUDA graph is captured
        again, so the counter is noted anew)."""
        if mode not in (True, False, None, "scan", "unroll"):
            raise ValueError(
                f"set_block_scan: expected True/'scan', False/'unroll' or "
                f"None, got {mode!r}")
        self._block_scan = mode
        self._block_runs_cache = None
        self._block_noted = frozenset()
        with self._output_cache_lock:
            self._output_fn = None
        self._reset_step_programs()
        return self

    def _block_scan_enabled(self) -> bool:
        mode = self._block_scan
        if mode is None:
            mode = os.environ.get("DL4J_BLOCK_SCAN", "0")
        return mode in (True, "1", "scan", "on")

    def _block_runs(self):
        """The detected identical-unit runs (cached; pure configuration
        analysis, so computed with the scan off too: the unrolled walk
        counts its `graph_block` bodies by them)."""
        if self._block_runs_cache is None:
            self._block_runs_cache = _detect_block_runs(
                self.conf, self.topo, self._pidx)
        return self._block_runs_cache

    # -- init ----------------------------------------------------------------

    def init(self) -> "ComputationGraph":
        dtype = self.policy.param_dtype
        self.params_list = []
        self.state_list = []
        for i, lc in enumerate(self._layer_confs):
            gen = torch.Generator().manual_seed(_layer_seed(self.net_conf.seed, i))
            p = init_layer_params(gen, lc, dtype)
            self.params_list.append({k: v.to(self.device) for k, v in p.items()})
            st = init_layer_state(lc, dtype)
            self.state_list.append(
                None if st is None else {k: v.to(self.device) for k, v in st.items()})
        self.upd_state = self.updater_def.init_tree(self.params_list)
        return self

    # -- forward -------------------------------------------------------------

    def _forward(self, params, states, inputs: Sequence, *, training, rng,
                 input_masks: Optional[Sequence] = None, preout_outputs=False,
                 note_key=None):
        """Forward over the cached topo order. Returns (activations dict,
        new_states list). With `preout_outputs` the loss-head vertices
        return their pre-activation, for the loss, and record their
        post-dropout input features under "<name>__features" (the center
        loss reads them). With the block scan on, a run of identical
        blocks whose units keep the carried shape leaves only its exit
        activation in the dict once it ends, as the JAX scan does.
        `note_key` names the forward-cache entry or step signature this
        walk serves: the first walk under a key counts its run bodies in
        `compile_total{kind="graph_block"}`."""
        conf = self.conf
        acts: Dict[str, torch.Tensor] = dict(zip(conf.inputs, inputs))
        masks: Dict[str, torch.Tensor] = {}
        if input_masks is not None:
            masks = {n: m for n, m in zip(conf.inputs, input_masks) if m is not None}
        # single-mask convenience: an rnn layer deeper in the graph uses the
        # sole input mask
        sole_mask = next(iter(masks.values())) if len(masks) == 1 else None
        new_states: List[Optional[dict]] = [None] * len(self.layer_vertex_names)
        env = {"activations": acts, "input_masks": masks}
        scan_on = self._block_scan_enabled()
        runs = self._block_runs()
        first_unit_ends = {r["start"] + r["period"] - 1: r for r in runs}
        run_ends = {r["start"] + r["period"] * r["count"] - 1: r for r in runs}
        scanned = set()  # starts of the runs whose units keep the carry
        note = False
        if note_key is not None and runs:
            note_key = (note_key, scan_on)
            note = note_key not in self._block_noted
            # rebound, not mutated: a shallow copy of the net (the cost
            # model's fake-tensor clone) keeps its own set
            self._block_noted = self._block_noted | {note_key}
        for pos, name in enumerate(self.topo):
            if name in acts:
                continue
            v = conf.vertices[name]
            xs = [acts[i] for i in conf.vertex_inputs[name]]
            if training and name in self._relu_passed:
                acts[name] = xs[0]  # its BN applied the ReLU
            elif not isinstance(v, LayerVertex):
                acts[name] = v.forward(xs, env)
            else:
                x = xs[0]
                timesteps = x.shape[1] if x.dim() == 3 else None
                if v.preprocessor is not None:
                    x = v.preprocessor(x, {"timesteps": timesteps})
                    if x.dim() == 3:
                        timesteps = x.shape[1]
                pidx = self._pidx[name]
                lc = v.layer
                ctx = LayerContext(
                    training=training, rng=rng,
                    mask=sole_mask if x.dim() == 3 else None,
                    timesteps=timesteps, state=states[pidx],
                    fuse_relu=training and name in self.relu_fused_bn,
                    dtype=self.policy.compute_dtype)
                # a tied head reads its embedding's parameters: one leaf
                p = params[self._pidx[self._tied[name]]] if name in self._tied else params[pidx]
                if (preout_outputs and name in conf.outputs
                        and isinstance(lc, _OUTPUT_LAYER_TYPES)):
                    x = apply_dropout(x, lc.dropout, ctx)
                    acts[name + "__features"] = x
                    # a tied head's loss forms its logits itself, in chunks
                    x = None if name in self._tied else _preout_of_output_layer(lc, p, x)
                    ns = None
                else:
                    x, ns = forward_layer(lc, p, x, ctx)
                new_states[pidx] = ns
                acts[name] = x
            r = first_unit_ends.get(pos)
            if scan_on and r is not None:
                # the scan's carry contract: a unit keeps the entry
                # activation's shape and dtype (a strided unit does not)
                entry = acts[r["entry"]]
                if (acts[name].shape == entry.shape
                        and acts[name].dtype == entry.dtype):
                    scanned.add(r["start"])
            r = run_ends.get(pos)
            if r is not None:
                if r["start"] in scanned:
                    for inner in self.topo[r["start"]:pos]:
                        del acts[inner]
                if note:
                    # one body per unit unrolled, one per run scanned
                    bodies = 1 if r["start"] in scanned else r["count"]
                    for _ in range(bodies):
                        self._note_compile("graph_block", r["exit"])
        return acts, new_states

    def _merge_states(self, old, new):
        return [n if n is not None else o for o, n in zip(old, new)]

    def _cast_inputs(self, xs):
        """The inputs in the policy's compute dtype, except integer token
        ids for a SequenceEmbeddingLayer (a bf16 id is not exact past 256)."""
        return [x if name in self._id_inputs and not x.is_floating_point()
                else self.policy.cast_input(x) for name, x in zip(self.conf.inputs, xs)]

    # -- loss ----------------------------------------------------------------

    def _loss(self, params, states, xs, ys, f_masks, l_masks, rng, training=True,
              note_key=None, l2_in_tail=False):
        conf = self.conf
        xs = self._cast_inputs(xs)
        acts, new_states = self._forward(
            params, states, xs, training=training, rng=rng,
            input_masks=f_masks, preout_outputs=True, note_key=note_key)
        score = 0.0
        n_heads = 0
        for i, name in enumerate(conf.outputs):
            v = conf.vertices[name]
            if not (isinstance(v, LayerVertex)
                    and isinstance(v.layer, _OUTPUT_LAYER_TYPES)):
                continue
            lc = v.layer
            lm = l_masks[i] if l_masks is not None else None
            if name in self._tied:
                if lc.loss != "sparse_mcxent" or lc.activation != "softmax":
                    raise ValueError(f"{name}: a tied head trains by sparse_mcxent on "
                                     f"softmax, not {lc.loss!r} on {lc.activation!r}")
                per_ex = tied_sparse_mcxent(
                    acts[name + "__features"], params[self._pidx[self._tied[name]]]["W"],
                    ys[i], 1.0 / lc.logits_scaling, lm)
            else:
                per_ex = loss_value(lc.loss, ys[i], self.policy.cast_output(acts[name]),
                                    lc.activation, lm)
            score = score + masked_example_mean(per_ex, lm)
            if isinstance(lc, L.CenterLossOutputLayer):
                pidx = self._pidx[name]
                term, new_state = center_loss_term(
                    lc, states[pidx], acts[name + "__features"], ys[i], per_ex,
                    lm, training)
                score = score + term
                if new_state is not None:
                    new_states[pidx] = new_state
            n_heads += 1
        if n_heads == 0:
            raise ValueError(
                "no output vertex is a loss head (OutputLayer/RnnOutputLayer/"
                "LossLayer) — cannot compute a training loss")
        return score + self._reg_penalty(params, l2_in_tail), new_states

    # -- train step ----------------------------------------------------------

    def _std_loss_builder(self):
        def loss_builder(p, states, data, rng, l2_in_tail=False):
            xs, ys, fms, lms = data
            return self._loss(p, states, xs, ys, fms, lms, rng,
                              note_key=("step", _signature(xs)), l2_in_tail=l2_in_tail)

        return loss_builder

    def _data_list(self, arrs):
        if arrs is None:
            return None
        return [self._as_data(a) for a in arrs]

    def _trunc_loss_builder(self):
        """TBPTT loss with tbptt_bwd_length < tbptt_fwd_length, as
        MultiLayerNetwork's: slice A advances the state under
        torch.no_grad() (its loss counts in the score, no gradient), slice
        B backpropagates; over input and label lists. The L2 term's
        gradient enters by slice B's weight (`l2_grad_share`)."""

        def lengths(data):
            return (max(x.shape[1] for x in data[0] if x.dim() == 3),
                    max(x.shape[1] for x in data[4] if x.dim() == 3))

        def loss_builder(p, states, data, rng, l2_in_tail=False):
            xsA, ysA, fmsA, lmsA, xsB, ysB, fmsB, lmsB = data
            with torch.no_grad():
                lossA, statesA = self._loss(p, states, xsA, ysA, fmsA, lmsA, rng,
                                            note_key=("step_a", _signature(xsA)),
                                            l2_in_tail=l2_in_tail)
            carried = self._merge_states(states, statesA)
            lossB, statesB = self._loss(p, carried, xsB, ysB, fmsB, lmsB, rng,
                                        note_key=("step_b", _signature(xsB)),
                                        l2_in_tail=l2_in_tail)
            nA, nB = lengths(data)
            score = (lossA * nA + lossB * nB) / (nA + nB)
            return score, self._merge_states(carried, statesB)

        loss_builder.l2_grad_share = lambda data: _slice_b_weight(*lengths(data))
        return loss_builder

    def _fit_step(self, xs, ys, f_masks, l_masks):
        """One optimizer step on device lists. Returns (states, device
        score)."""
        return self._run_step(self._std_loss_builder(), (xs, ys, f_masks, l_masks))

    # -- fit -----------------------------------------------------------------

    def fit(self, data, labels=None, *, epochs: int = 1, batch_size: int = 32,
            async_prefetch: bool = True, prefetch_buffer: int = 4,
            hang_timeout: float = None, resume_from: str = None,
            run_ledger=None):
        """Train. Accepts (features, labels) arrays, a DataSet/MultiDataSet,
        or a DataSetIterator/MultiDataSetIterator (reference:
        ComputationGraph.fit overloads :857-867). `async_prefetch`,
        `prefetch_buffer`, `hang_timeout`, `resume_from` and `run_ledger`
        as in MultiLayerNetwork.fit."""
        self._require_init()
        if self.upd_state is None:
            self.upd_state = self.updater_def.init_tree(self.params_list)
        if isinstance(data, (DataSetIterator, MultiDataSetIterator)):
            iterator = data
        elif isinstance(data, MultiDataSet):
            iterator = _ListMultiIterator(data, batch_size)
        elif isinstance(data, DataSet):
            iterator = ListDataSetIterator(data, batch_size)
        else:
            iterator = ListDataSetIterator(
                DataSet(np.asarray(data), np.asarray(labels)), batch_size)
        return self._run_fit(iterator, epochs, async_prefetch, prefetch_buffer,
                             hang_timeout=hang_timeout,
                             resume_from=resume_from, run_ledger=run_ledger)

    def _ds_arrays(self, ds):
        mds = _as_multidataset(ds)
        return (mds.features, mds.labels, mds.features_masks, mds.labels_masks)

    def _is_tbptt(self, ds) -> bool:
        return self.conf.backprop_type == "tbptt" and any(
            f.ndim == 3 for f in _as_multidataset(ds).features)

    def _fit_dataset(self, ds):
        # trains by SGD whatever `optimization_algo` says: the line-search
        # solvers are the sequential network's only, as in the JAX package
        data = tuple(self._data_list(a) for a in self._ds_arrays(ds))
        if self._is_tbptt(ds):
            self._fit_tbptt(ds, data)
            return
        states, _ = self._fit_step(*data)
        self._commit_states(states)
        self._notify(_examples_of(ds), ds)

    # -- multi-batch fused fit (set_fused_steps) -----------------------------

    def _fused_fit_supported(self) -> bool:
        return True

    def _fit_datasets_fused(self, ds_list):
        """k same-shape batches as one fused program (see
        NetworkBase.set_fused_steps). TBPTT batches run one by one, each
        with all its segments fused; the cross-batch stacking is the
        sequential network's (the JAX package's rule)."""
        if self._is_tbptt(ds_list[0]):
            for ds in ds_list:
                self._fit_dataset(ds)
            return
        k = len(ds_list)
        self._run_fused(("std", self._ds_signature(ds_list[0]), k),
                        [self._ds_arrays(ds) for ds in ds_list], k,
                        self._std_group_batch)

    def score(self, data, labels=None) -> float:
        """Loss on a dataset without updating (inference-mode forward)."""
        self._require_init()
        if isinstance(data, (DataSet, MultiDataSet)):
            mds = _as_multidataset(data)
        else:
            mds = _as_multidataset(DataSet(np.asarray(data), np.asarray(labels)))
        with torch.no_grad():
            s, _ = self._loss(
                self.params_list, self.state_list, self._data_list(mds.features),
                self._data_list(mds.labels), self._data_list(mds.features_masks),
                self._data_list(mds.labels_masks), rng=None, training=False)
        return float(s)

    def evaluate(self, data, labels=None, batch_size: int = 256,
                 output_index: int = 0) -> Evaluation:
        """Classification evaluation; multi-input graphs evaluate on all
        features, multi-output graphs on the head selected by
        output_index (reference: ComputationGraph.evaluate)."""
        ev = Evaluation()
        for out, y, lm in self._eval_outputs(data, labels, batch_size,
                                             output_index):
            ev.eval_batch(y, out, lm)
        return ev

    def evaluate_regression(self, data, labels=None, batch_size: int = 256,
                            output_index: int = 0) -> RegressionEvaluation:
        ev = RegressionEvaluation()
        for out, y, lm in self._eval_outputs(data, labels, batch_size,
                                             output_index):
            ev.eval_batch(y, out, lm)
        return ev

    def _eval_outputs(self, data, labels, batch_size, output_index):
        """(output, labels, labels mask) of the selected head per batch."""
        if isinstance(data, (DataSetIterator, MultiDataSetIterator)):
            batches = data
        elif isinstance(data, (DataSet, MultiDataSet)):
            batches = [data]
        else:
            batches = DataSet(np.asarray(data),
                              np.asarray(labels)).split_batches(batch_size)
        for b in batches:
            mds = _as_multidataset(b)
            out = self.output(*mds.features, input_masks=mds.features_masks)
            if isinstance(out, list):
                out = out[output_index]
            lm = (None if mds.labels_masks is None
                  else mds.labels_masks[output_index])
            yield out, mds.labels[output_index], lm

    # -- inference -----------------------------------------------------------

    def output(self, *inputs, input_masks: Optional[Sequence] = None):
        """Inference forward; one tensor for a single-output graph, else a
        list in set_outputs order (reference: ComputationGraph.output)."""
        self._require_init()
        xs = [self._as_input(x) for x in inputs]
        masks = None
        if input_masks is not None:
            if len(input_masks) != len(self.conf.inputs):
                raise ValueError(
                    f"input_masks has {len(input_masks)} entries but the "
                    f"graph has {len(self.conf.inputs)} inputs "
                    f"({self.conf.inputs}); pass one mask (or None) per input")
            masks = [None if m is None else self._as_input(m) for m in input_masks]
        fn = self._output_program(xs, masks)
        with torch.no_grad():
            outs = fn(self.params_list, self.state_list, xs, masks)
        return outs[0] if len(outs) == 1 else outs

    def _output_program(self, xs, masks=None):
        """output()'s forward-cache entry for these inputs' and masks'
        shapes and dtypes: fn(params, states, xs, masks) -> output list."""
        key = (tuple((tuple(x.shape), str(x.dtype)) for x in xs),
               None if masks is None else tuple(
                   None if m is None else (tuple(m.shape), str(m.dtype)) for m in masks))

        def make_fn():
            def fwd(params, states, xs, masks):
                xs = self._cast_inputs(xs)
                acts, _ = self._forward(params, states, xs, training=False,
                                        rng=None, input_masks=masks,
                                        note_key=("output",) + key)
                return [self.policy.cast_output(acts[n]) for n in self.conf.outputs]

            return fwd

        return self._cached_output_fn(key, make_fn)

    def _output_fn_for(self, xx):
        """The inference forward of output() for a one-input batch shaped
        like `xx`, as fn(params, states, x) on any rows of it (one tensor,
        or a list for several outputs): the sharded serving path
        (parallel/inference.py) runs it per block, one cache entry per
        whole batch shape."""
        fn = self._output_program([xx])

        def run(params, states, x):
            outs = fn(params, states, [x], None)
            return outs[0] if len(outs) == 1 else outs

        return run

    def feed_forward(self, *inputs):
        """All vertex activations as a dict — the inspection path."""
        self._require_init()
        with torch.no_grad():
            acts, _ = self._forward(
                self.params_list, self.state_list,
                self._cast_inputs([self._as_input(x) for x in inputs]),
                training=False, rng=None)
        return acts

    # -- rnn streaming inference ---------------------------------------------

    def rnn_time_step(self, *inputs):
        """Stateful streaming inference over the graph (reference:
        ComputationGraph.rnnTimeStep). Each input: [batch, time, nIn] (or
        [batch, nIn] for a single step). Returns outputs in set_outputs
        order (one tensor for a single-output graph). Only the recurrent
        carry is held between calls; other layer state (BN running
        statistics) is read from state_list on every call. A batch-size
        change starts a new stream."""
        self._require_init()
        xs = [self._as_input(x) for x in inputs]
        single = all(x.dim() == 2 for x in xs)
        if single:
            xs = [x[:, None, :] for x in xs]
        carry = getattr(self, "_rnn_carry", None) or {}
        bsz = xs[0].shape[0]
        if carry and any(v.shape[0] != bsz
                         for st in carry.values() for v in st.values()):
            carry = {}
            self._rnn_carry = None
        # an empty dict seeds a recurrent layer's zero carry and makes it
        # return its state
        states = [carry.get(i, {}) if _is_recurrent(lc) else self.state_list[i]
                  for i, lc in enumerate(self._layer_confs)]
        with torch.no_grad():
            acts, new_states = self._forward(
                self.params_list, states,
                self._cast_inputs(xs),
                training=False, rng=None)
        merged = self._merge_states(states, new_states)
        self._rnn_carry = {i: merged[i] for i, lc in enumerate(self._layer_confs)
                           if _is_recurrent(lc)}
        outs = [self.policy.cast_output(acts[n]) for n in self.conf.outputs]
        if single:
            outs = [o[:, 0] if o.dim() == 3 else o for o in outs]
        return outs[0] if len(outs) == 1 else outs

    def rnn_clear_previous_state(self):
        self._rnn_carry = None

    def clear_rnn_state(self):
        """Alias of rnn_clear_previous_state (the MultiLayerNetwork
        streaming API carries the same name)."""
        self.rnn_clear_previous_state()

    def clone(self) -> "ComputationGraph":
        other = ComputationGraph(copy.deepcopy(self.conf), device=self.device)
        if self.params_list is not None:
            other.params_list = [{k: v.clone() for k, v in p.items()}
                                 for p in self.params_list]
            other.state_list = [None if s is None else {k: v.clone() for k, v in s.items()}
                                for s in self.state_list]
            if self.upd_state is not None:
                other.upd_state = [{k: {n: v.clone() for n, v in s.items()}
                                    for k, s in p.items()} for p in self.upd_state]
            other.iteration = self.iteration
            other.epoch = self.epoch
        return other


class _ListMultiIterator(MultiDataSetIterator):
    """Minibatches from one in-memory MultiDataSet."""

    def __init__(self, mds: MultiDataSet, batch: int):
        self.mds = mds
        self.batch = batch

    def __iter__(self):
        n = self.mds.num_examples()
        for i in range(0, n, self.batch):
            sl = slice(i, min(i + self.batch, n))

            def cut(arrs):
                return None if arrs is None else [None if a is None else a[sl]
                                                  for a in arrs]

            yield MultiDataSet(cut(self.mds.features), cut(self.mds.labels),
                               cut(self.mds.features_masks),
                               cut(self.mds.labels_masks))

    def batch_size(self):
        return self.batch

    def total_examples(self):
        return self.mds.num_examples()

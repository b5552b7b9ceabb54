"""Transfer learning: builders and the featurizing helper.

The port of the JAX package's nn/transferlearning.py (reference:
nn/transferlearning/TransferLearning.java — fineTuneConfiguration
(hyperparameter overrides), setFeatureExtractor (freeze up to a boundary
via FrozenLayer), nOutReplace (swap a layer's width and reinitialize it
and its consumer), removeOutputLayer/addLayer; and
TransferLearningHelper (featurize a dataset through the frozen front once,
so repeated fine-tune epochs skip recomputing it)).

The builders never mutate the source network: they produce a NEW network
on the source's device whose configs are deep copies and whose kept
parameters and layer state are copies of the source's tensors (the port's
updater writes parameters in place, so sharing would let the new net's
fit move the source's weights); replaced and added layers are freshly
initialized, and the updater state starts from zero.
"""

from __future__ import annotations

import copy
from typing import Dict, List, Optional

import torch

from deeplearning4j_tpu_torch.data.dataset import DataSet
from deeplearning4j_tpu_torch.nn.conf import layers as L
from deeplearning4j_tpu_torch.nn.conf.network import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.layers.registry import init_layer_params, init_layer_state
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork


def _copy_tree(tree, device):
    """A layer's parameter or state dict (or None) copied onto `device`."""
    if tree is None:
        return None
    return {k: v.detach().to(device, copy=True) for k, v in tree.items()}


class TransferLearning:
    class Builder:
        def __init__(self, net: MultiLayerNetwork):
            net._require_init()
            self._src = net
            self._fine_tune: Dict = {}
            self._freeze_until: Optional[int] = None
            self._replacements: Dict[int, dict] = {}
            self._removed_from_output = 0
            self._added: List[L.LayerConf] = []

        def fine_tune_configuration(self, **overrides) -> "TransferLearning.Builder":
            """Override global hyperparameters (learning_rate, updater,
            momentum, ... — reference: FineTuneConfiguration)."""
            self._fine_tune.update(overrides)
            return self

        def set_feature_extractor(self, layer_idx: int) -> "TransferLearning.Builder":
            """Freeze layers 0..layer_idx inclusive (reference:
            setFeatureExtractor — wraps in FrozenLayer)."""
            self._freeze_until = int(layer_idx)
            return self

        def n_out_replace(self, layer_idx: int, n_out: int,
                          weight_init: Optional[str] = None) -> "TransferLearning.Builder":
            """Change layer_idx's n_out and reinitialize it + the next
            parameterized layer's n_in (reference: nOutReplace)."""
            self._replacements[int(layer_idx)] = {
                "n_out": int(n_out), "weight_init": weight_init,
            }
            return self

        def remove_output_layer(self) -> "TransferLearning.Builder":
            return self.remove_layers_from_output(1)

        def remove_layers_from_output(self, n: int) -> "TransferLearning.Builder":
            self._removed_from_output += int(n)
            return self

        def add_layer(self, layer_conf: L.LayerConf) -> "TransferLearning.Builder":
            self._added.append(layer_conf)
            return self

        def build(self) -> MultiLayerNetwork:
            src = self._src
            confs = [copy.deepcopy(c) for c in src.layer_confs]
            keep = len(confs) - self._removed_from_output
            if keep < 0:
                raise ValueError("removed more layers than the network has")
            confs = confs[:keep]
            reinit = set()

            # nOutReplace: new width + downstream n_in rewiring
            for idx, spec in sorted(self._replacements.items()):
                if idx >= len(confs):
                    raise ValueError(f"n_out_replace index {idx} out of range")
                inner = confs[idx].inner if isinstance(confs[idx], L.FrozenLayer) else confs[idx]
                inner.n_out = spec["n_out"]
                if spec["weight_init"]:
                    inner.weight_init = spec["weight_init"]
                reinit.add(idx)
                for j in range(idx + 1, len(confs)):
                    nxt = confs[j].inner if isinstance(confs[j], L.FrozenLayer) else confs[j]
                    if isinstance(nxt, L.BatchNormalization):
                        nxt.n_in = spec["n_out"]
                        reinit.add(j)
                        continue
                    if isinstance(nxt, L.FeedForwardLayerConf):
                        nxt.n_in = spec["n_out"]
                        reinit.add(j)
                        break
                    if nxt.has_params():
                        break

            # added layers: wire n_in from the previous feed-forward width
            prev_out = None
            for c in reversed(confs):
                inner = c.inner if isinstance(c, L.FrozenLayer) else c
                if isinstance(inner, L.FeedForwardLayerConf):
                    prev_out = inner.n_out
                    break
            for lc in self._added:
                inner = lc.inner if isinstance(lc, L.FrozenLayer) else lc
                if isinstance(inner, L.FeedForwardLayerConf) and inner.n_in is None:
                    inner.n_in = prev_out
                if isinstance(inner, L.FeedForwardLayerConf):
                    prev_out = inner.n_out
                reinit.add(len(confs))
                confs.append(lc)

            # freeze the feature extractor
            if self._freeze_until is not None:
                for i in range(min(self._freeze_until + 1, len(confs))):
                    if not isinstance(confs[i], L.FrozenLayer):
                        confs[i] = L.FrozenLayer(inner=confs[i])

            net_conf = copy.deepcopy(src.net_conf)
            for k, v in self._fine_tune.items():
                if not hasattr(net_conf, k):
                    raise ValueError(f"unknown fine-tune hyperparameter {k!r}")
                setattr(net_conf, k, v)

            # added layers inherit network defaults exactly as the
            # ListBuilder does for an original build
            from deeplearning4j_tpu_torch.nn.conf.network import _apply_defaults

            for lc in self._added:
                _apply_defaults(lc, net_conf)

            new_conf = MultiLayerConfiguration(
                net_conf=net_conf,
                layers=confs,
                preprocessors=copy.deepcopy(src.conf.preprocessors),
                backprop_type=src.conf.backprop_type,
                tbptt_fwd_length=src.conf.tbptt_fwd_length,
                tbptt_bwd_length=src.conf.tbptt_bwd_length,
                input_type=copy.deepcopy(src.conf.input_type),
            )
            new_net = MultiLayerNetwork(new_conf, device=src.device).init()
            # parameter transfer: COPY surviving layers' tensors
            dev = new_net.device
            for i in range(len(confs)):
                if i < len(src.params_list) and i not in reinit:
                    new_net.params_list[i] = _copy_tree(src.params_list[i], dev)
                    new_net.state_list[i] = _copy_tree(src.state_list[i], dev)
            new_net.upd_state = new_net.updater_def.init_tree(new_net.params_list)
            return new_net


class GraphTransferLearning:
    """Transfer learning for ComputationGraph (reference:
    TransferLearning.GraphBuilder in nn/transferlearning/
    TransferLearning.java): fineTune, setFeatureExtractor (freeze every
    ancestor of the named vertices, inclusive), removeVertexAndConnections,
    addLayer/addVertex, nOutReplace, setOutputs. Exposed as
    TransferLearning.GraphBuilder for API parity."""

    def __init__(self, net):
        net._require_init()
        self._src = net
        self._fine_tune: Dict = {}
        self._freeze_at: List[str] = []
        self._removed: List[str] = []
        self._added_layers: List[tuple] = []  # (name, conf, inputs, pp)
        self._added_vertices: List[tuple] = []  # (name, vertex, inputs)
        self._replacements: Dict[str, dict] = {}
        self._new_outputs: Optional[List[str]] = None

    def fine_tune_configuration(self, **overrides) -> "GraphTransferLearning":
        self._fine_tune.update(overrides)
        return self

    def set_feature_extractor(self, *vertex_names: str) -> "GraphTransferLearning":
        """Freeze the named vertices and all their ancestors (reference:
        GraphBuilder.setFeatureExtractor)."""
        self._freeze_at.extend(vertex_names)
        return self

    def remove_vertex_and_connections(self, name: str) -> "GraphTransferLearning":
        self._removed.append(name)
        return self

    def n_out_replace(self, layer_name: str, n_out: int,
                      weight_init: Optional[str] = None) -> "GraphTransferLearning":
        self._replacements[layer_name] = {
            "n_out": int(n_out), "weight_init": weight_init,
        }
        return self

    def add_layer(self, name: str, layer_conf, *inputs: str,
                  preprocessor=None) -> "GraphTransferLearning":
        self._added_layers.append((name, layer_conf, list(inputs), preprocessor))
        return self

    def add_vertex(self, name: str, vertex, *inputs: str) -> "GraphTransferLearning":
        self._added_vertices.append((name, vertex, list(inputs)))
        return self

    def set_outputs(self, *names: str) -> "GraphTransferLearning":
        self._new_outputs = list(names)
        return self

    def build(self):
        from deeplearning4j_tpu_torch.nn.compgraph import ComputationGraph
        from deeplearning4j_tpu_torch.nn.conf.graph import (
            ComputationGraphConfiguration,
            LayerVertex,
        )
        from deeplearning4j_tpu_torch.nn.conf.network import _apply_defaults

        src = self._src
        conf = src.conf
        vertices = {k: copy.deepcopy(v) for k, v in conf.vertices.items()}
        vertex_inputs = {k: list(v) for k, v in conf.vertex_inputs.items()}
        outputs = list(self._new_outputs or conf.outputs)

        # removals: vertex + every edge pointing at it
        for name in self._removed:
            if name not in vertices:
                raise ValueError(f"cannot remove unknown vertex {name!r}")
            del vertices[name]
            del vertex_inputs[name]
            for k, ins in vertex_inputs.items():
                if name in ins:
                    raise ValueError(
                        f"vertex {k!r} still consumes removed vertex "
                        f"{name!r}; remove or rewire it first"
                    )
            outputs = [o for o in outputs if o != name]

        reinit = set()

        # nOutReplace: change width + rewire direct consumers' n_in
        for lname, spec in self._replacements.items():
            v = vertices.get(lname)
            if not isinstance(v, LayerVertex):
                raise ValueError(f"{lname!r} is not a layer vertex")
            inner = v.layer.inner if isinstance(v.layer, L.FrozenLayer) else v.layer
            inner.n_out = spec["n_out"]
            if spec["weight_init"]:
                inner.weight_init = spec["weight_init"]
            reinit.add(lname)
            for cname, ins in vertex_inputs.items():
                if lname not in ins:
                    continue
                cv_obj = vertices.get(cname)
                if isinstance(cv_obj, LayerVertex):
                    cv = cv_obj.layer
                    c_inner = cv.inner if isinstance(cv, L.FrozenLayer) else cv
                    if hasattr(c_inner, "n_in"):
                        c_inner.n_in = spec["n_out"]
                        reinit.add(cname)
                else:
                    # a non-layer consumer (Merge/ElementWise/...) changes
                    # how the new width propagates — refuse loudly instead
                    # of leaving stale n_in deeper in the graph (the
                    # reference's GraphBuilder errors here too)
                    raise ValueError(
                        f"n_out_replace({lname!r}) feeds non-layer vertex "
                        f"{cname!r}; rewire downstream widths explicitly "
                        "(remove_vertex_and_connections + add_layer)"
                    )

        # additions
        net_conf = copy.deepcopy(src.net_conf)
        for k, val in self._fine_tune.items():
            if not hasattr(net_conf, k):
                raise ValueError(f"unknown fine-tune hyperparameter {k!r}")
            setattr(net_conf, k, val)
        for name, vertex, ins in self._added_vertices:
            if name in vertices:
                raise ValueError(f"duplicate vertex name {name!r}")
            vertices[name] = copy.deepcopy(vertex)
            vertex_inputs[name] = list(ins)
        for name, lc, ins, pp in self._added_layers:
            if name in vertices:
                raise ValueError(f"duplicate vertex name {name!r}")
            lc = copy.deepcopy(lc)
            _apply_defaults(lc, net_conf)
            vertices[name] = LayerVertex(layer=lc, preprocessor=pp)
            vertex_inputs[name] = list(ins)
            reinit.add(name)

        # freeze: named vertices + all ancestors
        if self._freeze_at:
            frozen = set()
            stack = list(self._freeze_at)
            while stack:
                n = stack.pop()
                if n in frozen or n in conf.inputs:
                    continue
                frozen.add(n)
                stack.extend(vertex_inputs.get(n, []))
            for n in frozen:
                v = vertices.get(n)
                if isinstance(v, LayerVertex) and not isinstance(
                    v.layer, L.FrozenLayer
                ):
                    v.layer = L.FrozenLayer(inner=v.layer)

        new_conf = ComputationGraphConfiguration(
            net_conf=net_conf,
            inputs=list(conf.inputs),
            outputs=outputs,
            vertices=vertices,
            vertex_inputs=vertex_inputs,
            backprop_type=conf.backprop_type,
            tbptt_fwd_length=conf.tbptt_fwd_length,
            tbptt_bwd_length=conf.tbptt_bwd_length,
            input_types=copy.deepcopy(conf.input_types),
        )
        new_net = ComputationGraph(new_conf, device=src.device).init()
        # parameter transfer by vertex name (topo order may have changed),
        # as copies
        dev = new_net.device
        for name, new_idx in new_net._pidx.items():
            if name in src._pidx and name not in reinit:
                old_idx = src._pidx[name]
                new_net.params_list[new_idx] = _copy_tree(src.params_list[old_idx], dev)
                new_net.state_list[new_idx] = _copy_tree(src.state_list[old_idx], dev)
        new_net.upd_state = new_net.updater_def.init_tree(new_net.params_list)
        return new_net


TransferLearning.GraphBuilder = GraphTransferLearning


class TransferLearningHelper:
    """Featurize through the frozen front once, then fine-tune the
    unfrozen tail on cached features (reference:
    nn/transferlearning/TransferLearningHelper.java)."""

    def __init__(self, net: MultiLayerNetwork):
        net._require_init()
        self.net = net
        self.boundary = 0
        for i, c in enumerate(net.layer_confs):
            if isinstance(c, L.FrozenLayer):
                self.boundary = i + 1
        if self.boundary == 0:
            raise ValueError("network has no frozen layers to featurize through")
        # the unfrozen tail as its own network, on copies of the parameters
        tail_confs = [copy.deepcopy(c) for c in net.layer_confs[self.boundary:]]
        tail_conf = MultiLayerConfiguration(
            net_conf=copy.deepcopy(net.net_conf),
            layers=tail_confs,
            preprocessors={
                str(int(k) - self.boundary): v
                for k, v in net.conf.preprocessors.items()
                if int(k) >= self.boundary
            },
        )
        self.tail = MultiLayerNetwork(tail_conf, device=net.device).init()
        dev = net.device
        self.tail.params_list = [_copy_tree(p, dev)
                                 for p in net.params_list[self.boundary:]]
        self.tail.state_list = [_copy_tree(s, dev)
                                for s in net.state_list[self.boundary:]]
        self.tail.upd_state = self.tail.updater_def.init_tree(self.tail.params_list)

    def featurize(self, ds: DataSet) -> DataSet:
        """`ds` with its features replaced by the frozen front's output (an
        inference-mode forward through the frozen layers), a tensor on the
        network's device."""
        net = self.net
        with torch.no_grad():
            feats = net._forward(
                net.params_list, net.state_list,
                net.policy.cast_input(net._as_data(ds.features)),
                training=False, rng=None, to_layer=self.boundary)[0]
        return DataSet(feats, ds.labels, None, ds.labels_mask)

    def fit_featurized(self, data, labels=None, *, epochs: int = 1,
                       batch_size: int = 32):
        """Train the unfrozen tail on featurized data, then copy its
        parameters and layer state into the full network."""
        self.tail.fit(data, labels, epochs=epochs, batch_size=batch_size,
                      async_prefetch=False)
        with torch.no_grad():
            for i, (p, s) in enumerate(zip(self.tail.params_list, self.tail.state_list)):
                for k, v in p.items():
                    self.net.params_list[self.boundary + i][k].copy_(v)
                for k, v in (s or {}).items():
                    self.net.state_list[self.boundary + i][k].copy_(v)
        return self.net

    def unfrozen_network(self) -> MultiLayerNetwork:
        return self.tail

"""ComputationGraph configuration: vertex configs + GraphBuilder.

The port of the JAX package's nn/conf/graph.py (reference:
ComputationGraphConfiguration, nn/conf/ComputationGraphConfiguration.java,
and the vertex config set in nn/conf/graph/ — MergeVertex,
ElementWiseVertex, SubsetVertex, ... — plus the RNN vertices in
nn/conf/graph/rnn/). Same classes, fields and JSON: a configuration the
JAX package wrote round-trips here byte for byte.

A graph is: named inputs, a dict of named vertices (each with its list of
input names), and named outputs. Vertices are pure-data dataclasses; each
carries both its shape-inference rule (`output_type`) and its functional
forward (`forward(xs, env)`) — the runtime walk is a fold over the cached
topological order (reference: ComputationGraph.java:340,1055 topo cache;
:1291-1292 forward walk). Backward is autograd; fan-out epsilon
accumulation (reference :1480-1502) falls out of it.

`env` carries per-minibatch context a vertex may need beyond its direct
inputs: the LayerContext, per-input-name masks (LastTimeStepVertex), and
the activation dict built so far (DuplicateToTimeSeriesVertex reads the
time length of another vertex's activation).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Optional, Sequence

import torch

from deeplearning4j_tpu_torch.nn.conf import layers as L
from deeplearning4j_tpu_torch.nn.conf.inputs import (
    ConvolutionalInput,
    FeedForwardInput,
    RecurrentInput,
)
from deeplearning4j_tpu_torch.nn.conf.serde import (
    config_from_dict,
    config_to_dict,
    register_config,
)


@dataclasses.dataclass(kw_only=True)
class GraphVertexConf:
    """Base for non-layer vertices (parameterless transforms)."""

    def output_type(self, its: List):
        raise NotImplementedError

    def forward(self, xs: List, env: dict):
        raise NotImplementedError


@register_config("vertex.layer")
@dataclasses.dataclass(kw_only=True)
class LayerVertex(GraphVertexConf):
    """A layer as a DAG node, with an optional input preprocessor
    (reference: nn/graph/vertex/impl/LayerVertex.java)."""

    layer: Optional[L.LayerConf] = None
    preprocessor: Optional[object] = None

    def output_type(self, its: List):
        it = its[0]
        if self.preprocessor is not None and it is not None:
            it = self.preprocessor.output_type(it)
        return self.layer.output_type(it) if it is not None else None

    # forward is special-cased by the runtime (params + state threading)


@register_config("vertex.merge")
@dataclasses.dataclass(kw_only=True)
class MergeVertex(GraphVertexConf):
    """Concatenate along the feature/channel axis (reference:
    MergeVertex.java concatenates along dim 1 of NCHW — here NHWC, so the
    last axis for ff/cnn/rnn alike)."""

    def output_type(self, its: List):
        first = its[0]
        if isinstance(first, ConvolutionalInput):
            return ConvolutionalInput(first.height, first.width,
                                      sum(i.channels for i in its))
        if isinstance(first, RecurrentInput):
            return RecurrentInput(sum(i.size for i in its), first.timesteps)
        return FeedForwardInput(sum(i.arity() for i in its))

    def forward(self, xs, env):
        return torch.cat(xs, dim=-1)


@register_config("vertex.elementwise")
@dataclasses.dataclass(kw_only=True)
class ElementWiseVertex(GraphVertexConf):
    """Pointwise combine: add/subtract/product/average/max (reference:
    ElementWiseVertex.java — subtract requires exactly 2 inputs)."""

    op: str = "add"

    def output_type(self, its: List):
        return its[0]

    def forward(self, xs, env):
        op = self.op
        if op == "subtract":
            if len(xs) != 2:
                raise ValueError("ElementWiseVertex(subtract) needs 2 inputs")
            return xs[0] - xs[1]
        acc = xs[0]
        for x in xs[1:]:
            if op == "add" or op == "average":
                acc = acc + x
            elif op == "product":
                acc = acc * x
            elif op == "max":
                acc = torch.maximum(acc, x)
            else:
                raise ValueError(f"unknown elementwise op {op!r}")
        if op == "average":
            acc = acc / len(xs)
        return acc


@register_config("vertex.subset")
@dataclasses.dataclass(kw_only=True)
class SubsetVertex(GraphVertexConf):
    """Feature-range slice, inclusive bounds (reference: SubsetVertex.java
    [from, to] on the feature axis)."""

    from_: int = 0
    to: int = 0

    def output_type(self, its: List):
        n = self.to - self.from_ + 1
        it = its[0]
        if isinstance(it, ConvolutionalInput):
            return ConvolutionalInput(it.height, it.width, n)
        if isinstance(it, RecurrentInput):
            return RecurrentInput(n, it.timesteps)
        return FeedForwardInput(n)

    def forward(self, xs, env):
        return xs[0][..., self.from_ : self.to + 1]


@register_config("vertex.stack")
@dataclasses.dataclass(kw_only=True)
class StackVertex(GraphVertexConf):
    """Concatenate along the batch axis (reference: StackVertex.java —
    used to push several inputs through shared layers)."""

    def output_type(self, its: List):
        return its[0]

    def forward(self, xs, env):
        return torch.cat(xs, dim=0)


@register_config("vertex.unstack")
@dataclasses.dataclass(kw_only=True)
class UnstackVertex(GraphVertexConf):
    """Take slice `from_` of `stack_size` equal batch-axis parts
    (reference: UnstackVertex.java)."""

    from_: int = 0
    stack_size: int = 1

    def output_type(self, its: List):
        return its[0]

    def forward(self, xs, env):
        x = xs[0]
        step = x.shape[0] // self.stack_size
        return x[self.from_ * step : (self.from_ + 1) * step]


@register_config("vertex.scale")
@dataclasses.dataclass(kw_only=True)
class ScaleVertex(GraphVertexConf):
    """x * scale (reference: ScaleVertex.java)."""

    scale: float = 1.0

    def output_type(self, its: List):
        return its[0]

    def forward(self, xs, env):
        return xs[0] * self.scale


@register_config("vertex.shift")
@dataclasses.dataclass(kw_only=True)
class ShiftVertex(GraphVertexConf):
    """x + shift (reference: ShiftVertex.java)."""

    shift: float = 0.0

    def output_type(self, its: List):
        return its[0]

    def forward(self, xs, env):
        return xs[0] + self.shift


@register_config("vertex.reshape")
@dataclasses.dataclass(kw_only=True)
class ReshapeVertex(GraphVertexConf):
    """Reshape the per-example trailing dims; batch dim is preserved
    (reference: ReshapeVertex.java)."""

    new_shape: Sequence[int] = ()

    def output_type(self, its: List):
        s = tuple(self.new_shape)
        if len(s) == 1:
            return FeedForwardInput(s[0])
        if len(s) == 2:
            return RecurrentInput(s[1], s[0])
        if len(s) == 3:
            return ConvolutionalInput(s[0], s[1], s[2])
        return None

    def forward(self, xs, env):
        return xs[0].reshape((xs[0].shape[0],) + tuple(self.new_shape))


@register_config("vertex.preprocessor")
@dataclasses.dataclass(kw_only=True)
class PreprocessorVertex(GraphVertexConf):
    """Standalone InputPreProcessor as a vertex (reference:
    PreprocessorVertex.java)."""

    preprocessor: Optional[object] = None

    def output_type(self, its: List):
        return self.preprocessor.output_type(its[0])

    def forward(self, xs, env):
        return self.preprocessor(xs[0], {"timesteps": env.get("timesteps")})


@register_config("vertex.l2")
@dataclasses.dataclass(kw_only=True)
class L2Vertex(GraphVertexConf):
    """Pairwise L2 distance between two inputs -> [batch, 1] (reference:
    L2Vertex.java — siamese distance)."""

    eps: float = 1e-8

    def output_type(self, its: List):
        return FeedForwardInput(1)

    def forward(self, xs, env):
        a = xs[0].reshape(xs[0].shape[0], -1)
        b = xs[1].reshape(xs[1].shape[0], -1)
        d = a - b
        return torch.sqrt((d * d).sum(dim=-1, keepdim=True) + self.eps)


@register_config("vertex.l2_normalize")
@dataclasses.dataclass(kw_only=True)
class L2NormalizeVertex(GraphVertexConf):
    """x / max(||x||2, eps) per example (reference: L2NormalizeVertex.java)."""

    eps: float = 1e-8

    def output_type(self, its: List):
        return its[0]

    def forward(self, xs, env):
        x = xs[0]
        flat = x.reshape(x.shape[0], -1)
        n = torch.sqrt((flat * flat).sum(dim=-1) + self.eps)
        return x / n.reshape((-1,) + (1,) * (x.ndim - 1))


@register_config("vertex.last_time_step")
@dataclasses.dataclass(kw_only=True)
class LastTimeStepVertex(GraphVertexConf):
    """[b,t,f] -> [b,f]: the last time step, or — when the named network
    input has a mask — the last *unmasked* step per example (reference:
    nn/conf/graph/rnn/LastTimeStepVertex.java)."""

    mask_input: Optional[str] = None

    def output_type(self, its: List):
        return FeedForwardInput(its[0].size)

    def forward(self, xs, env):
        x = xs[0]
        mask = None
        if self.mask_input is not None:
            mask = env.get("input_masks", {}).get(self.mask_input)
        if mask is None:
            return x[:, -1]
        idx = (mask > 0).sum(dim=1).long() - 1
        idx = idx.clamp(0, x.shape[1] - 1)
        return x[torch.arange(x.shape[0], device=x.device), idx]


@register_config("vertex.duplicate_to_time_series")
@dataclasses.dataclass(kw_only=True)
class DuplicateToTimeSeriesVertex(GraphVertexConf):
    """[b,f] -> [b,t,f], t taken from the named input's time axis
    (reference: nn/conf/graph/rnn/DuplicateToTimeSeriesVertex.java)."""

    ref_input: Optional[str] = None

    def output_type(self, its: List):
        return RecurrentInput(its[0].arity())

    def forward(self, xs, env):
        ref = env["activations"][self.ref_input]
        t = ref.shape[1]
        return xs[0][:, None, :].expand(xs[0].shape[0], t, xs[0].shape[-1])


# -- configuration -----------------------------------------------------------


@register_config("compgraph_conf")
@dataclasses.dataclass(kw_only=True)
class ComputationGraphConfiguration:
    """DAG network configuration (reference:
    nn/conf/ComputationGraphConfiguration.java)."""

    net_conf: object = None
    inputs: List[str] = dataclasses.field(default_factory=list)
    outputs: List[str] = dataclasses.field(default_factory=list)
    vertices: Dict[str, object] = dataclasses.field(default_factory=dict)
    vertex_inputs: Dict[str, List[str]] = dataclasses.field(default_factory=dict)
    backprop_type: str = "standard"
    tbptt_fwd_length: int = 20
    tbptt_bwd_length: int = 20
    input_types: Optional[List[object]] = None

    def to_json(self) -> str:
        return json.dumps(config_to_dict(self), indent=2)

    @staticmethod
    def from_json(s: str) -> "ComputationGraphConfiguration":
        obj = config_from_dict(json.loads(s))
        if not isinstance(obj, ComputationGraphConfiguration):
            raise ValueError("JSON does not describe a ComputationGraphConfiguration")
        return obj

    # -- topology ------------------------------------------------------------

    def topological_order(self) -> List[str]:
        """Deterministic Kahn topo sort over input + vertex names
        (reference: ComputationGraph.java:340 cached topologicalOrder)."""
        indeg = {name: len(ins) for name, ins in self.vertex_inputs.items()}
        consumers: Dict[str, List[str]] = {}
        for name, ins in self.vertex_inputs.items():
            for src in ins:
                consumers.setdefault(src, []).append(name)
        order: List[str] = []
        ready = list(self.inputs)
        seen = set(self.inputs)
        while ready:
            v = ready.pop(0)
            order.append(v)
            for c in consumers.get(v, []):
                indeg[c] -= 1
                if indeg[c] == 0 and c not in seen:
                    seen.add(c)
                    ready.append(c)
        unreached = set(self.vertices) - set(order)
        if unreached:
            raise ValueError(
                f"graph has unreachable or cyclic vertices: {sorted(unreached)}"
            )
        return order


class GraphBuilder:
    """Fluent DAG builder (reference:
    ComputationGraphConfiguration.GraphBuilder)."""

    def __init__(self, net_conf):
        self._net_conf = net_conf
        self._inputs: List[str] = []
        self._outputs: List[str] = []
        self._vertices: Dict[str, object] = {}
        self._vertex_inputs: Dict[str, List[str]] = {}
        self._input_types: Optional[List[object]] = None
        self._backprop_type = "standard"
        self._tbptt_fwd = 20
        self._tbptt_bwd = 20

    def add_inputs(self, *names: str) -> "GraphBuilder":
        self._inputs.extend(names)
        return self

    def set_input_types(self, *types) -> "GraphBuilder":
        self._input_types = list(types)
        return self

    def add_layer(self, name: str, layer: L.LayerConf, *inputs: str,
                  preprocessor=None) -> "GraphBuilder":
        if not inputs:
            raise ValueError(f"layer {name!r} needs at least one input")
        self._check_new(name, inputs)
        if len(inputs) > 1:
            # a layer consumes exactly one activation: auto-insert a
            # MergeVertex over multiple inputs, as the reference does
            # (ComputationGraphConfiguration.java:580-584)
            merge_name = f"{name}-merge"
            if merge_name in self._vertices or merge_name in self._inputs:
                raise ValueError(
                    f"cannot auto-insert merge vertex {merge_name!r}: name "
                    "already taken"
                )
            self._vertices[merge_name] = MergeVertex()
            self._vertex_inputs[merge_name] = list(inputs)
            inputs = (merge_name,)
        self._vertices[name] = LayerVertex(layer=layer, preprocessor=preprocessor)
        self._vertex_inputs[name] = list(inputs)
        return self

    def add_vertex(self, name: str, vertex: GraphVertexConf, *inputs: str) -> "GraphBuilder":
        if not inputs:
            raise ValueError(f"vertex {name!r} needs at least one input")
        self._check_new(name, inputs)
        self._vertices[name] = vertex
        self._vertex_inputs[name] = list(inputs)
        return self

    def set_outputs(self, *names: str) -> "GraphBuilder":
        self._outputs = list(names)
        return self

    def backprop_type(self, t: str) -> "GraphBuilder":
        self._backprop_type = t
        return self

    def t_bptt_lengths(self, fwd: int, bwd: Optional[int] = None) -> "GraphBuilder":
        self._tbptt_fwd = fwd
        self._tbptt_bwd = bwd if bwd is not None else fwd
        return self

    def _check_new(self, name, inputs):
        if name in self._vertices or name in self._inputs:
            raise ValueError(f"duplicate vertex name {name!r}")
        known = set(self._inputs) | set(self._vertices)
        for i in inputs:
            if i not in known:
                raise ValueError(
                    f"vertex {name!r} references unknown input {i!r} "
                    "(vertices must be added after their inputs)"
                )

    def build(self) -> ComputationGraphConfiguration:
        from deeplearning4j_tpu_torch.nn.conf.network import (
            _apply_defaults,
            auto_preprocessor,
        )

        if not self._outputs:
            raise ValueError("set_outputs(...) is required")
        for name in self._outputs:
            if name not in self._vertices:
                raise ValueError(f"output {name!r} is not a vertex")
        conf = ComputationGraphConfiguration(
            net_conf=self._net_conf,
            inputs=self._inputs,
            outputs=self._outputs,
            vertices=self._vertices,
            vertex_inputs=self._vertex_inputs,
            backprop_type=self._backprop_type,
            tbptt_fwd_length=self._tbptt_fwd,
            tbptt_bwd_length=self._tbptt_bwd,
            input_types=self._input_types,
        )
        # hyperparameter inheritance into every layer conf
        for v in self._vertices.values():
            if isinstance(v, LayerVertex):
                _apply_defaults(v.layer, self._net_conf)
        # shape inference + auto preprocessor insertion along topo order
        if self._input_types is not None:
            if len(self._input_types) != len(self._inputs):
                raise ValueError("set_input_types arity != add_inputs arity")
            types: Dict[str, object] = dict(zip(self._inputs, self._input_types))
            for name in conf.topological_order():
                if name in types:
                    continue
                v = self._vertices[name]
                its = [types.get(i) for i in self._vertex_inputs[name]]
                if any(i is None for i in its):
                    types[name] = None
                    continue
                if isinstance(v, LayerVertex):
                    it = its[0]
                    if v.preprocessor is None:
                        v.preprocessor = auto_preprocessor(it, v.layer)
                    if v.preprocessor is not None:
                        it = v.preprocessor.output_type(it)
                    v.layer.infer_n_in(it)
                    types[name] = v.layer.output_type(it)
                else:
                    types[name] = v.output_type(its)
        return conf

"""Shape/dtype flow checker over nn/conf configurations, the port of the
JAX package's analysis/shapeflow.py.

Symbolic propagation of InputTypes through a MultiLayerConfiguration or
ComputationGraphConfiguration — no params built, no tracing, no device —
the analog of the reference's config-time validation (InputTypeUtil +
MultiLayerConfiguration.Builder.setInputType nIn inference), turned into
a reporting pass instead of scattered exceptions: every defect becomes a
Finding mapped to the layer/vertex NAME that caused it, so a
misconfigured graph is diagnosed before the first step instead of
surfacing as a shape error from a kernel five layers downstream.

The walk mirrors what the runtime will do
(MultiLayerConfiguration.input_types_per_layer / GraphBuilder.build's
topo propagation) but never mutates the conf and never raises: a layer
whose output_type throws produces an SF002 finding and propagation
continues with an unknown type. Codes, severities, locations and
messages are the JAX package's, so both packages report a conf alike.
"""

from __future__ import annotations

import copy
from typing import Dict, List, Optional, Tuple

from deeplearning4j_tpu_torch.analysis.findings import (
    ERROR,
    INFO,
    WARNING,
    Finding,
)
from deeplearning4j_tpu_torch.nn.conf import layers as L
from deeplearning4j_tpu_torch.nn.conf.graph import (
    ComputationGraphConfiguration,
    ElementWiseVertex,
    GraphVertexConf,
    LayerVertex,
    MergeVertex,
    SubsetVertex,
)
from deeplearning4j_tpu_torch.nn.conf.inputs import (
    ConvolutionalInput,
    RecurrentInput,
)
from deeplearning4j_tpu_torch.nn.conf.network import (
    MultiLayerConfiguration,
    _needs,
)

_OUTPUT_LAYER_TYPES = (L.OutputLayer, L.RnnOutputLayer, L.LossLayer,
                       L.CenterLossOutputLayer)

# which InputType kinds each layer family consumes directly (the "ff"
# family eats flattened image rows without a preprocessor — see
# nn/conf/network.auto_preprocessor)
_ACCEPTS = {"cnn": ("cnn",), "rnn": ("rnn",), "ff": ("ff", "cnn_flat")}

_BF16_NAMES = ("bf16", "bfloat16", "mixed")


def _inner(layer: L.LayerConf) -> L.LayerConf:
    return layer.inner if isinstance(layer, L.FrozenLayer) and layer.inner \
        else layer


def _layer_label(layer: L.LayerConf, fallback: str) -> str:
    name = getattr(_inner(layer), "name", None)
    return name or fallback


def _dense_chain_member(inner: L.LayerConf) -> bool:
    """Layers whose n_out IS the flat feature count the next dense layer
    consumes — the only producers/consumers the no-InputType fallback
    n_in check may compare against (conv n_out is channels, recurrent
    n_out is hidden size; comparing those is a false positive)."""
    if not isinstance(inner, L.FeedForwardLayerConf):
        return False
    return not isinstance(inner, (L.EmbeddingLayer, L.ConvolutionLayer,
                                  L.Convolution1DLayer,
                                  L.BaseRecurrentLayerConf,
                                  L.RnnOutputLayer))


def _expected_n_in(layer: L.LayerConf, it) -> Optional[int]:
    """What infer_n_in would wire for this input — computed on a throwaway
    copy so the check never mutates the configuration."""
    probe = copy.deepcopy(_inner(layer))
    try:
        probe.n_in = None
        probe.infer_n_in(it)
        return probe.n_in
    except Exception:
        return None


def _check_layer(layer: L.LayerConf, it, loc: str,
                 has_preprocessor: bool) -> Tuple[Optional[object], List[Finding]]:
    """Validate one layer against its (post-preprocessor) input type and
    return (output type or None, findings)."""
    out: List[Finding] = []
    inner = _inner(layer)

    if isinstance(inner, L.FeedForwardLayerConf) and inner.has_params() \
            and inner.n_out <= 0:
        out.append(Finding(
            "SF001", ERROR, loc,
            f"{type(inner).__name__} has n_out={inner.n_out} (unset)",
            "set n_out on the layer config"))

    if it is None:
        return None, out

    # input-family compatibility (would the runtime forward even make
    # sense?) — the builder auto-inserts preprocessors, but confs built
    # by hand / deserialized / imported may lack them
    need = _needs(layer)
    accepts = _ACCEPTS.get(need)
    if accepts is not None and it.kind not in accepts:
        out.append(Finding(
            "SF002", ERROR, loc,
            f"{type(inner).__name__} consumes {need!r} input but receives "
            f"{it.kind!r} ({type(it).__name__})"
            + ("" if has_preprocessor else " and no preprocessor is set"),
            f"insert the {it.kind}->{need} preprocessor "
            "(nn/conf/preprocessors) or rebuild via the builder with an "
            "InputType set"))
        return None, out

    # nIn wiring: what the layer declares vs what actually flows in
    # (EmbeddingLayer excluded: its nIn is the vocabulary size, while its
    # input is index columns — arity says nothing about it)
    if (isinstance(inner, (L.FeedForwardLayerConf, L.BatchNormalization))
            and not isinstance(inner, L.EmbeddingLayer)
            and getattr(inner, "n_in", None) is not None):
        expected = _expected_n_in(layer, it)
        if expected is not None and inner.n_in != expected:
            out.append(Finding(
                "SF001", ERROR, loc,
                f"{type(inner).__name__} declares n_in={inner.n_in} but the "
                f"incoming {type(it).__name__} supplies {expected}",
                f"set n_in={expected}, or let the builder infer it from "
                "the InputType"))

    try:
        return layer.output_type(it), out
    except Exception as e:
        out.append(Finding(
            "SF002", ERROR, loc,
            f"output_type failed for {type(inner).__name__}: {e}",
            "fix the layer's input wiring"))
        return None, out


def _promotion_findings(net_conf, head_locs: List[str]) -> List[Finding]:
    """bf16 compute policy promotes loss-head outputs to f32
    (PrecisionPolicy.cast_output) — flag each promotion point so the
    boundary is explicit, not silent."""
    precision = str(getattr(net_conf, "precision", "f32") or "f32").lower()
    if precision not in _BF16_NAMES:
        return []
    return [Finding(
        "SF006", INFO, loc,
        "bf16 compute promotes to f32 at this loss head "
        "(PrecisionPolicy.cast_output) — intentional for loss numerics",
        "no action needed unless the promotion shows up hot in a profile")
        for loc in head_locs]


# -- MultiLayerConfiguration --------------------------------------------------


def check_multilayer(conf: MultiLayerConfiguration) -> List[Finding]:
    findings: List[Finding] = []
    it = conf.input_type
    if it is None:
        findings.append(Finding(
            "SF002", INFO, "network",
            "no InputType set — shape flow starts unknown; only declared "
            "nIn/nOut can be checked",
            "build with .set_input_type(InputType...) for full checking"))
    prev_n_out = None
    for i, layer in enumerate(conf.layers):
        loc = f"layer[{i}]:{_layer_label(layer, type(_inner(layer)).__name__)}"
        pp = conf.preprocessors.get(str(i))
        if pp is not None and it is not None:
            try:
                it = pp.output_type(it)
            except Exception as e:
                findings.append(Finding(
                    "SF002", ERROR, loc,
                    f"preprocessor {type(pp).__name__} rejected the "
                    f"incoming {type(it).__name__}: {e}",
                    "fix or remove the preprocessor for this layer"))
                it = None
        # no InputType: the builder wires n_in from the previous n_out —
        # check declared wiring the same way. Only valid along a pure
        # dense chain: a conv/recurrent producer's n_out is channels/
        # hidden size, not the flattened arity a dense consumer sees, and
        # a preprocessor legitimately reshapes in between
        if it is None and prev_n_out is not None and pp is None:
            inner = _inner(layer)
            if (_dense_chain_member(inner)
                    and inner.n_in is not None
                    and inner.n_in != prev_n_out):
                findings.append(Finding(
                    "SF001", ERROR, loc,
                    f"{type(inner).__name__} declares n_in={inner.n_in} but "
                    f"the previous layer outputs n_out={prev_n_out}",
                    f"set n_in={prev_n_out}"))
        it, fs = _check_layer(layer, it, loc, pp is not None)
        findings.extend(fs)
        inner = _inner(layer)
        if _dense_chain_member(inner):
            prev_n_out = inner.n_out
        elif not isinstance(inner, (L.ActivationLayer, L.DropoutLayer,
                                    L.BatchNormalization, L.LossLayer)):
            # anything shape-transforming (conv/pool/rnn/...) breaks the
            # dense chain — stop comparing rather than compare wrongly
            prev_n_out = None

    last = conf.layers[-1] if conf.layers else None
    if last is None or not isinstance(_inner(last), _OUTPUT_LAYER_TYPES):
        findings.append(Finding(
            "SF007", WARNING, "network",
            "final layer is not an OutputLayer/RnnOutputLayer/LossLayer — "
            "fit() has no loss to train against",
            "end the network with a loss head (inference-only nets can "
            "ignore this)"))
    else:
        n = len(conf.layers) - 1
        findings.extend(_promotion_findings(
            conf.net_conf,
            [f"layer[{n}]:{_layer_label(last, type(_inner(last)).__name__)}"]))
    return findings


# -- ComputationGraphConfiguration -------------------------------------------


def _check_merge(v: MergeVertex, its: List, loc: str) -> List[Finding]:
    kinds = {i.kind for i in its}
    if len(kinds) > 1:
        return [Finding(
            "SF003", ERROR, loc,
            f"merge inputs mix kinds {sorted(kinds)} — concatenation along "
            "the feature axis is undefined across families",
            "insert preprocessors so all merge inputs share a family")]
    first = its[0]
    if isinstance(first, ConvolutionalInput):
        hw = {(i.height, i.width) for i in its}
        if len(hw) > 1:
            return [Finding(
                "SF003", ERROR, loc,
                f"merge inputs disagree on spatial size: {sorted(hw)} — "
                "channel-axis concat needs equal height/width",
                "align strides/padding of the merged branches")]
    if isinstance(first, RecurrentInput):
        ts = {i.timesteps for i in its if i.timesteps is not None}
        if len(ts) > 1:
            return [Finding(
                "SF003", ERROR, loc,
                f"merge inputs disagree on timesteps: {sorted(ts)}",
                "align the merged branches' time axes")]
    return []


def _type_sig(it):
    if isinstance(it, ConvolutionalInput):
        return ("cnn", it.height, it.width, it.channels)
    if isinstance(it, RecurrentInput):
        return ("rnn", it.size, it.timesteps)
    return (it.kind, it.arity())


def _check_vertex(v: GraphVertexConf, its: List, loc: str) -> List[Finding]:
    if isinstance(v, MergeVertex):
        return _check_merge(v, its, loc)
    if isinstance(v, ElementWiseVertex):
        out: List[Finding] = []
        if v.op == "subtract" and len(its) != 2:
            out.append(Finding(
                "SF005", ERROR, loc,
                f"ElementWiseVertex(subtract) needs exactly 2 inputs, "
                f"has {len(its)}", "wire exactly two inputs"))
        sigs = {_type_sig(i) for i in its}
        if len(sigs) > 1:
            out.append(Finding(
                "SF005", ERROR, loc,
                f"elementwise {v.op!r} over mismatched input shapes: "
                f"{sorted(sigs)}",
                "make all branches produce the same shape (projection "
                "shortcut, preprocessor, ...)"))
        return out
    if isinstance(v, SubsetVertex):
        # the runtime slices the LAST axis: channels for cnn, size for
        # rnn/ff — arity() (h*w*c) would let out-of-range subsets pass
        it0 = its[0]
        if isinstance(it0, ConvolutionalInput):
            n = it0.channels
        elif isinstance(it0, RecurrentInput):
            n = it0.size
        else:
            n = it0.arity()
        if v.from_ > v.to or v.to >= n or v.from_ < 0:
            return [Finding(
                "SF005", ERROR, loc,
                f"subset [{v.from_}, {v.to}] out of range for feature "
                f"size {n} (inclusive bounds)",
                "fix the subset bounds")]
    return []


def check_compgraph(conf: ComputationGraphConfiguration) -> List[Finding]:
    findings: List[Finding] = []

    for name in conf.outputs:
        if name not in conf.vertices:
            findings.append(Finding(
                "SF004", ERROR, f"vertex:{name}",
                f"declared output {name!r} is not a vertex",
                "set_outputs must name existing vertices"))

    try:
        order = conf.topological_order()
    except ValueError as e:
        findings.append(Finding(
            "SF004", ERROR, "graph",
            f"graph is not a DAG over its inputs: {e}",
            "every vertex must be reachable from add_inputs() and the "
            "edges must be acyclic"))
        return findings

    # dead vertices: computed every forward pass, feeding no output
    live = set(n for n in conf.outputs if n in conf.vertices)
    stack = list(live)
    while stack:
        n = stack.pop()
        for src in conf.vertex_inputs.get(n, []):
            if src not in live:
                live.add(src)
                stack.append(src)
    for name in sorted(set(conf.vertices) - live):
        findings.append(Finding(
            "SF004", WARNING, f"vertex:{name}",
            f"dead vertex {name!r}: computed but feeds no output "
            "(its work and its params are wasted every step)",
            "remove it, or add it to set_outputs"))
    for name in sorted(set(conf.inputs) - live):
        findings.append(Finding(
            "SF004", WARNING, f"input:{name}",
            f"graph input {name!r} feeds no output",
            "drop the input or wire it in"))

    # type propagation along topo order (non-mutating mirror of
    # GraphBuilder.build)
    types: Dict[str, Optional[object]] = {}
    if conf.input_types is not None:
        if len(conf.input_types) != len(conf.inputs):
            findings.append(Finding(
                "SF002", ERROR, "graph",
                f"{len(conf.input_types)} input_types for "
                f"{len(conf.inputs)} inputs", "match arities"))
        types.update(zip(conf.inputs, conf.input_types))
    head_locs: List[str] = []
    n_heads = 0
    for name in order:
        if name in types or name in conf.inputs:
            continue
        v = conf.vertices[name]
        loc = f"vertex:{name}"
        its = [types.get(i) for i in conf.vertex_inputs.get(name, [])]
        if isinstance(v, LayerVertex):
            if len(its) > 1:
                findings.append(Finding(
                    "SF002", ERROR, loc,
                    "a LayerVertex consumes exactly one activation but has "
                    f"{len(its)} inputs",
                    "merge the inputs explicitly (MergeVertex) — the "
                    "builder does this automatically"))
                types[name] = None
                continue
            it = its[0] if its else None
            if it is not None and v.preprocessor is not None:
                try:
                    it = v.preprocessor.output_type(it)
                except Exception as e:
                    findings.append(Finding(
                        "SF002", ERROR, loc,
                        f"preprocessor {type(v.preprocessor).__name__} "
                        f"rejected the incoming type: {e}",
                        "fix or remove the vertex preprocessor"))
                    it = None
            t, fs = _check_layer(v.layer, it, loc,
                                 v.preprocessor is not None)
            findings.extend(fs)
            types[name] = t
            if (name in conf.outputs
                    and isinstance(_inner(v.layer), _OUTPUT_LAYER_TYPES)):
                n_heads += 1
                head_locs.append(loc)
        else:
            if any(i is None for i in its):
                types[name] = None
                continue
            findings.extend(_check_vertex(v, its, loc))
            try:
                types[name] = v.output_type(its)
            except Exception as e:
                findings.append(Finding(
                    "SF005", ERROR, loc,
                    f"output_type failed for {type(v).__name__}: {e}",
                    "fix the vertex wiring"))
                types[name] = None

    if n_heads == 0:
        findings.append(Finding(
            "SF007", WARNING, "graph",
            "no output vertex is a loss head (OutputLayer/RnnOutputLayer/"
            "LossLayer) — fit() has no loss to train against",
            "make at least one output a loss head (inference-only graphs "
            "can ignore this)"))
    else:
        findings.extend(_promotion_findings(conf.net_conf, head_locs))
    return findings


def propagate_types(conf):
    """Public propagation helper: the InputType each vertex/layer OUTPUTS.

    MultiLayer -> list aligned with conf.layers (entry i = layer i's
    output type); graph -> dict vertex/input name -> type. Unknown types
    are None. Used by the graph audit and the cost model to shape example batches."""
    if isinstance(conf, MultiLayerConfiguration):
        it = conf.input_type
        out = []
        for i, layer in enumerate(conf.layers):
            pp = conf.preprocessors.get(str(i))
            if pp is not None and it is not None:
                try:
                    it = pp.output_type(it)
                except Exception:
                    it = None
            if it is not None:
                try:
                    it = layer.output_type(it)
                except Exception:
                    it = None
            out.append(it)
        return out
    types: Dict[str, Optional[object]] = {}
    if conf.input_types is not None:
        types.update(zip(conf.inputs, conf.input_types))
    try:
        order = conf.topological_order()
    except ValueError:
        return types
    for name in order:
        if name in types:
            continue
        v = conf.vertices.get(name)
        if v is None:
            continue
        its = [types.get(i) for i in conf.vertex_inputs.get(name, [])]
        if any(i is None for i in its) or not its:
            types[name] = None
            continue
        try:
            if isinstance(v, LayerVertex):
                it = its[0]
                if v.preprocessor is not None:
                    it = v.preprocessor.output_type(it)
                types[name] = v.layer.output_type(it)
            else:
                types[name] = v.output_type(its)
        except Exception:
            types[name] = None
    return types


def check_configuration(conf) -> List[Finding]:
    """Entry point: dispatch on configuration type."""
    if isinstance(conf, MultiLayerConfiguration):
        return check_multilayer(conf)
    if isinstance(conf, ComputationGraphConfiguration):
        return check_compgraph(conf)
    raise TypeError(
        f"check_configuration wants a MultiLayerConfiguration or "
        f"ComputationGraphConfiguration, got {type(conf).__name__}")

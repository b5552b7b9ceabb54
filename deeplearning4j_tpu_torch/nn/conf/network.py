"""Network-level configuration: global hyperparameters + the fluent builder.

Analog of the reference's NeuralNetConfiguration.Builder (1,189 LoC fluent
DSL — nn/conf/NeuralNetConfiguration.java:517-735) and
MultiLayerConfiguration (549 LoC — backprop/pretrain flags, TBPTT, input
type, preprocessor map). Global hyperparameters set on the builder are
inherited by every layer whose own field is None, exactly the reference's
clone-defaults-into-layer behavior.

Workspace modes (NONE/SINGLE/SEPARATE) have no analog here: PyTorch's
caching allocator owns the intermediate buffers. `graph_builder()` starts
the DAG builder of nn/conf/graph.py.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Optional

from deeplearning4j_tpu_torch.nn.conf import layers as L
from deeplearning4j_tpu_torch.nn.conf.inputs import (
    ConvolutionalFlatInput,
    ConvolutionalInput,
    FeedForwardInput,
    RecurrentInput,
)
from deeplearning4j_tpu_torch.nn.conf.preprocessors import (
    CnnToFeedForwardPreProcessor,
    CnnToRnnPreProcessor,
    FeedForwardToRnnPreProcessor,
    FlatToCnnPreProcessor,
    RnnToFeedForwardPreProcessor,
)
from deeplearning4j_tpu_torch.nn.conf.serde import (
    config_from_dict,
    config_to_dict,
    register_config,
)


class Updater:
    """Mirrors nn/conf/Updater.java:11-14."""

    SGD = "sgd"
    ADAM = "adam"
    ADAMAX = "adamax"
    ADADELTA = "adadelta"
    NESTEROVS = "nesterovs"
    ADAGRAD = "adagrad"
    RMSPROP = "rmsprop"
    NONE = "none"


class GradientNormalization:
    """Mirrors nn/conf/GradientNormalization.java."""

    NONE = "none"
    RENORMALIZE_L2_PER_LAYER = "renormalize_l2_per_layer"
    RENORMALIZE_L2_PER_PARAM_TYPE = "renormalize_l2_per_param_type"
    CLIP_ELEMENTWISE_ABSOLUTE_VALUE = "clip_elementwise_absolute_value"
    CLIP_L2_PER_LAYER = "clip_l2_per_layer"
    CLIP_L2_PER_PARAM_TYPE = "clip_l2_per_param_type"


class BackpropType:
    STANDARD = "standard"
    TRUNCATED_BPTT = "tbptt"


class OptimizationAlgorithm:
    """Mirrors nn/api/OptimizationAlgorithm (the names the JSON carries)."""

    STOCHASTIC_GRADIENT_DESCENT = "sgd"
    LINE_GRADIENT_DESCENT = "line_gradient_descent"
    CONJUGATE_GRADIENT = "conjugate_gradient"
    LBFGS = "lbfgs"


class LearningRatePolicy:
    """Mirrors nn/conf/LearningRatePolicy (None/Exponential/Inverse/Poly/
    Sigmoid/Step/Schedule/Score-based decay)."""

    NONE = "none"
    EXPONENTIAL = "exponential"
    INVERSE = "inverse"
    POLY = "poly"
    SIGMOID = "sigmoid"
    STEP = "step"
    SCHEDULE = "schedule"


@register_config("net_conf")
@dataclasses.dataclass(kw_only=True)
class NeuralNetConfiguration:
    """Global (network-default) hyperparameters."""

    seed: int = 123
    optimization_algo: str = OptimizationAlgorithm.STOCHASTIC_GRADIENT_DESCENT
    activation: str = "sigmoid"
    weight_init: str = "xavier"
    dist: Optional[dict] = None
    bias_init: float = 0.0
    learning_rate: float = 1e-1
    bias_learning_rate: Optional[float] = None
    lr_policy: str = LearningRatePolicy.NONE
    lr_policy_decay_rate: float = 0.0
    lr_policy_steps: float = 1.0
    lr_policy_power: float = 1.0
    lr_schedule: Optional[Dict[str, float]] = None  # iteration -> lr
    updater: str = Updater.SGD
    momentum: float = 0.9
    rho: float = 0.95
    rms_decay: float = 0.95
    adam_mean_decay: float = 0.9
    adam_var_decay: float = 0.999
    epsilon: float = 1e-8
    l1: float = 0.0
    l2: float = 0.0
    dropout: float = 0.0
    gradient_normalization: str = GradientNormalization.NONE
    gradient_normalization_threshold: float = 1.0
    minimize: bool = True
    mini_batch: bool = True
    precision: str = "f32"

    @staticmethod
    def builder() -> "Builder":
        return Builder()


_INHERITED_FIELDS = ("activation", "weight_init", "dist", "bias_init", "l1", "l2")


def _apply_defaults(layer: L.LayerConf, conf: NeuralNetConfiguration) -> None:
    if isinstance(layer, L.FrozenLayer) and layer.inner is not None:
        _apply_defaults(layer.inner, conf)
        return
    if isinstance(layer, L.BaseLayerConf):
        for f in _INHERITED_FIELDS:
            if getattr(layer, f, None) is None:
                setattr(layer, f, getattr(conf, f))
    if layer.dropout is None:
        layer.dropout = conf.dropout


def _needs(layer: L.LayerConf) -> str:
    """Which input family a layer consumes: 'cnn', 'rnn', 'ff' or 'any'."""
    inner = layer.inner if isinstance(layer, L.FrozenLayer) else layer
    if isinstance(inner, (L.ConvolutionLayer, L.SubsamplingLayer, L.ZeroPaddingLayer,
                          L.LocalResponseNormalization)):
        return "cnn"
    if isinstance(inner, (L.LSTM, L.GravesLSTM, L.GravesBidirectionalLSTM,
                          L.RnnOutputLayer, L.Convolution1DLayer, L.Subsampling1DLayer)):
        return "rnn"
    if isinstance(inner, (L.DenseLayer, L.OutputLayer, L.CenterLossOutputLayer,
                          L.EmbeddingLayer, L.AutoEncoder,
                          L.VariationalAutoencoder)):
        return "ff"
    return "any"


def auto_preprocessor(it, layer: L.LayerConf):
    """Insert the shape adapter the reference's InputType.getPreProcessorForInputType
    would (MultiLayerConfiguration.Builder.setInputType)."""
    need = _needs(layer)
    if isinstance(it, ConvolutionalFlatInput):
        if need == "cnn":
            return FlatToCnnPreProcessor(height=it.height, width=it.width, channels=it.channels)
        return None  # dense layers eat the flat rows directly
    if isinstance(it, ConvolutionalInput):
        if need == "ff":
            return CnnToFeedForwardPreProcessor(height=it.height, width=it.width, channels=it.channels)
        if need == "rnn":
            return CnnToRnnPreProcessor()
    if isinstance(it, RecurrentInput):
        if need == "ff":
            return RnnToFeedForwardPreProcessor()
    if isinstance(it, FeedForwardInput):
        if need == "rnn":
            return FeedForwardToRnnPreProcessor()
        if need == "cnn":
            raise ValueError(
                "feed-forward input into a convolutional layer: set an "
                "InputType.convolutional(...) or add an explicit preprocessor"
            )
    return None


@register_config("multilayer_conf")
@dataclasses.dataclass(kw_only=True)
class MultiLayerConfiguration:
    """Sequential network configuration (reference:
    nn/conf/MultiLayerConfiguration.java)."""

    net_conf: NeuralNetConfiguration = dataclasses.field(default_factory=NeuralNetConfiguration)
    layers: List[L.LayerConf] = dataclasses.field(default_factory=list)
    # str(layer_index) -> preprocessor applied to that layer's input
    # (string keys so the JSON round trip is loss-free)
    preprocessors: Dict[str, object] = dataclasses.field(default_factory=dict)
    backprop_type: str = BackpropType.STANDARD
    tbptt_fwd_length: int = 20
    tbptt_bwd_length: int = 20
    pretrain: bool = False
    input_type: Optional[object] = None

    # -- serde ---------------------------------------------------------------
    def to_json(self) -> str:
        return json.dumps(config_to_dict(self), indent=2)

    @staticmethod
    def from_json(s: str) -> "MultiLayerConfiguration":
        obj = config_from_dict(json.loads(s))
        if not isinstance(obj, MultiLayerConfiguration):
            raise ValueError("JSON does not describe a MultiLayerConfiguration")
        return obj

    def to_yaml(self) -> str:
        """reference: MultiLayerConfiguration.toYaml()."""
        from deeplearning4j_tpu_torch.nn.conf.serde import config_to_yaml

        return config_to_yaml(self)

    @staticmethod
    def from_yaml(s: str) -> "MultiLayerConfiguration":
        from deeplearning4j_tpu_torch.nn.conf.serde import config_from_yaml

        return config_from_yaml(s)

    # -- shape inference -----------------------------------------------------
    def input_types_per_layer(self):
        """List of the InputType flowing *into* each layer (after its
        preprocessor)."""
        it = self.input_type
        out = []
        for i, layer in enumerate(self.layers):
            pp = self.preprocessors.get(str(i))
            if pp is not None and it is not None:
                it = pp.output_type(it)
            out.append(it)
            if it is not None:
                it = layer.output_type(it)
        return out


class ListBuilder:
    """Builder for the layer list (reference:
    NeuralNetConfiguration.ListBuilder)."""

    def __init__(self, net_conf: NeuralNetConfiguration):
        self._conf = net_conf
        self._layers: List[L.LayerConf] = []
        self._preprocessors: Dict[str, object] = {}
        self._backprop_type = BackpropType.STANDARD
        self._tbptt_fwd = 20
        self._tbptt_bwd = 20
        self._pretrain = False
        self._input_type = None

    def layer(self, layer_conf: L.LayerConf) -> "ListBuilder":
        self._layers.append(layer_conf)
        return self

    def input_pre_processor(self, index: int, pp) -> "ListBuilder":
        self._preprocessors[str(index)] = pp
        return self

    def backprop_type(self, t: str) -> "ListBuilder":
        self._backprop_type = t
        return self

    def t_bptt_lengths(self, fwd: int, bwd: Optional[int] = None) -> "ListBuilder":
        self._tbptt_fwd = fwd
        self._tbptt_bwd = bwd if bwd is not None else fwd
        return self

    def pretrain(self, flag: bool) -> "ListBuilder":
        self._pretrain = flag
        return self

    def set_input_type(self, it) -> "ListBuilder":
        self._input_type = it
        return self

    def build(self) -> MultiLayerConfiguration:
        for lc in self._layers:
            _apply_defaults(lc, self._conf)
        # Shape inference + automatic preprocessor insertion
        it = self._input_type
        if it is not None:
            for i, layer in enumerate(self._layers):
                if str(i) not in self._preprocessors:
                    pp = auto_preprocessor(it, layer)
                    if pp is not None:
                        self._preprocessors[str(i)] = pp
                if str(i) in self._preprocessors:
                    it = self._preprocessors[str(i)].output_type(it)
                layer.infer_n_in(it)
                it = layer.output_type(it)
        else:
            # without an InputType, wire n_in from the previous layer's n_out
            prev = None
            for layer in self._layers:
                inner = layer.inner if isinstance(layer, L.FrozenLayer) else layer
                if isinstance(inner, L.FeedForwardLayerConf) and inner.n_in is None and prev is not None:
                    inner.n_in = prev
                if isinstance(inner, L.FeedForwardLayerConf):
                    prev = inner.n_out
        return MultiLayerConfiguration(
            net_conf=self._conf,
            layers=self._layers,
            preprocessors=self._preprocessors,
            backprop_type=self._backprop_type,
            tbptt_fwd_length=self._tbptt_fwd,
            tbptt_bwd_length=self._tbptt_bwd,
            pretrain=self._pretrain,
            input_type=self._input_type,
        )


class Builder:
    """Fluent global-hyperparameter builder (reference:
    NeuralNetConfiguration.Builder). Each setter mirrors a reference method;
    snake_case but same vocabulary."""

    def __init__(self):
        self._kw = {}

    def _set(self, **kw) -> "Builder":
        self._kw.update(kw)
        return self

    def seed(self, s: int) -> "Builder":
        return self._set(seed=int(s))

    def optimization_algo(self, algo: str) -> "Builder":
        return self._set(optimization_algo=algo)

    def activation(self, a: str) -> "Builder":
        return self._set(activation=a)

    def weight_init(self, w: str) -> "Builder":
        return self._set(weight_init=w)

    def dist(self, d: dict) -> "Builder":
        return self._set(dist=d, weight_init="distribution")

    def bias_init(self, b: float) -> "Builder":
        return self._set(bias_init=b)

    def learning_rate(self, lr: float) -> "Builder":
        return self._set(learning_rate=lr)

    def bias_learning_rate(self, lr: float) -> "Builder":
        return self._set(bias_learning_rate=lr)

    def learning_rate_policy(self, p: str) -> "Builder":
        return self._set(lr_policy=p)

    def lr_policy_decay_rate(self, r: float) -> "Builder":
        return self._set(lr_policy_decay_rate=r)

    def lr_policy_steps(self, s: float) -> "Builder":
        return self._set(lr_policy_steps=s)

    def lr_policy_power(self, p: float) -> "Builder":
        return self._set(lr_policy_power=p)

    def learning_rate_schedule(self, sched: Dict[int, float]) -> "Builder":
        return self._set(
            lr_schedule={str(k): float(v) for k, v in sched.items()},
            lr_policy=LearningRatePolicy.SCHEDULE,
        )

    def updater(self, u: str) -> "Builder":
        return self._set(updater=u)

    def momentum(self, m: float) -> "Builder":
        return self._set(momentum=m)

    def rho(self, r: float) -> "Builder":
        return self._set(rho=r)

    def rms_decay(self, r: float) -> "Builder":
        return self._set(rms_decay=r)

    def adam_mean_decay(self, b1: float) -> "Builder":
        return self._set(adam_mean_decay=b1)

    def adam_var_decay(self, b2: float) -> "Builder":
        return self._set(adam_var_decay=b2)

    def epsilon(self, e: float) -> "Builder":
        return self._set(epsilon=e)

    def l1(self, v: float) -> "Builder":
        return self._set(l1=v)

    def l2(self, v: float) -> "Builder":
        return self._set(l2=v)

    def dropout(self, d: float) -> "Builder":
        return self._set(dropout=d)

    def gradient_normalization(self, g: str) -> "Builder":
        return self._set(gradient_normalization=g)

    def gradient_normalization_threshold(self, t: float) -> "Builder":
        return self._set(gradient_normalization_threshold=t)

    def minimize(self, m: bool) -> "Builder":
        return self._set(minimize=m)

    def mini_batch(self, m: bool) -> "Builder":
        return self._set(mini_batch=m)

    def precision(self, p: str) -> "Builder":
        return self._set(precision=p)

    def build(self) -> NeuralNetConfiguration:
        return NeuralNetConfiguration(**self._kw)

    def list(self) -> ListBuilder:
        return ListBuilder(self.build())

    def graph_builder(self):
        """DAG configuration builder (reference:
        NeuralNetConfiguration.Builder.graphBuilder())."""
        from deeplearning4j_tpu_torch.nn.conf.graph import GraphBuilder

        return GraphBuilder(self.build())

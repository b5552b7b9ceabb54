"""Configuration DSL.

Analog of the reference's nn/conf package: a declarative, JSON-serializable
description of a network (NeuralNetConfiguration.java, 1,189 LoC;
MultiLayerConfiguration.java; layer configs in nn/conf/layers/). The JSON
form is the persistence/compat surface and is byte-compatible with the JAX
package's: `MultiLayerConfiguration.from_json(jax_conf.to_json())` and
`ComputationGraphConfiguration.from_json(...)` work here.
"""

from deeplearning4j_tpu_torch.nn.conf.graph import (
    ComputationGraphConfiguration,
    DuplicateToTimeSeriesVertex,
    ElementWiseVertex,
    GraphBuilder,
    L2NormalizeVertex,
    L2Vertex,
    LastTimeStepVertex,
    LayerVertex,
    MergeVertex,
    PreprocessorVertex,
    ReshapeVertex,
    ScaleVertex,
    ShiftVertex,
    StackVertex,
    SubsetVertex,
    UnstackVertex,
)
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.layers import (
    ActivationLayer,
    AutoEncoder,
    BatchNormalization,
    CenterLossOutputLayer,
    Convolution1DLayer,
    ConvolutionLayer,
    DenseLayer,
    DropoutLayer,
    EmbeddingLayer,
    GlobalPoolingLayer,
    GravesBidirectionalLSTM,
    GravesLSTM,
    LocalResponseNormalization,
    LossLayer,
    LSTM,
    OutputLayer,
    RnnOutputLayer,
    Subsampling1DLayer,
    SubsamplingLayer,
    VariationalAutoencoder,
    ZeroPaddingLayer,
)
from deeplearning4j_tpu_torch.nn.conf.network import (
    BackpropType,
    GradientNormalization,
    MultiLayerConfiguration,
    NeuralNetConfiguration,
    Updater,
)
from deeplearning4j_tpu_torch.nn.conf.serde import config_from_dict, config_to_dict

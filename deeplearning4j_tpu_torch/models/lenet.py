"""LeNet for MNIST (BASELINE.md "LeNet MNIST MultiLayerNetwork", the
dl4j-examples LenetMnistExample architecture: conv5x5x20 - maxpool2 -
conv5x5x50 - maxpool2 - dense500 relu - softmax10, Nesterovs lr 0.01
momentum 0.9). The port of the JAX package's models/lenet.py: the same
configuration JSON.

Its convolutions carry a bias and are truncate-mode, which the conv/BN
kernel declines (ops/fused_conv_bn.conv_decision: "bias", as the JAX
package's Pallas kernel does): LeNet runs the builtin conv."""

from __future__ import annotations

from deeplearning4j_tpu_torch.nn.conf import (
    ConvolutionLayer,
    DenseLayer,
    InputType,
    MultiLayerConfiguration,
    NeuralNetConfiguration,
    OutputLayer,
    SubsamplingLayer,
    Updater,
)
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork


def lenet_conf(seed: int = 123, learning_rate: float = 0.01,
               precision: str = "f32") -> MultiLayerConfiguration:
    return (
        NeuralNetConfiguration.builder()
        .seed(seed)
        .updater(Updater.NESTEROVS)
        .learning_rate(learning_rate)
        .momentum(0.9)
        .weight_init("xavier")
        .precision(precision)
        .list()
        .layer(ConvolutionLayer(kernel_size=(5, 5), stride=(1, 1), n_out=20,
                                activation="identity"))
        .layer(SubsamplingLayer(pooling_type="max", kernel_size=(2, 2), stride=(2, 2)))
        .layer(ConvolutionLayer(kernel_size=(5, 5), stride=(1, 1), n_out=50,
                                activation="identity"))
        .layer(SubsamplingLayer(pooling_type="max", kernel_size=(2, 2), stride=(2, 2)))
        .layer(DenseLayer(n_out=500, activation="relu"))
        .layer(OutputLayer(n_out=10, activation="softmax", loss="mcxent"))
        .set_input_type(InputType.convolutional_flat(28, 28, 1))
        .build()
    )


def lenet_network(seed: int = 123, learning_rate: float = 0.01,
                  precision: str = "f32", device=None) -> MultiLayerNetwork:
    """LeNet on `device` ("cuda" when None; device="cpu" for the CPU)."""
    return MultiLayerNetwork(lenet_conf(seed, learning_rate, precision),
                             device=device).init()

"""ResNet — bottleneck residual networks as ComputationGraphs.

The port of the JAX package's models/resnet.py, with the same
configurations (reference workload: the ComputationGraph engine,
nn/graph/ComputationGraph.java:1291, with cuDNN conv helpers,
deeplearning4j-cuda/CudnnConvolutionHelper.java:345). In training on a
Hopper GPU every conv runs the conv + BN-statistics kernel and every BN
the fused apply and pullback kernels (ops/fused_conv_bn.py).

He et al. (2015) v1 bottleneck topology: stem conv7x7/2 + maxpool3x3/2,
stages of [1x1 w, 3x3 w, 1x1 4w] blocks with identity (or 1x1-projection)
shortcuts, global average pool, softmax head. ResNet-50 = blocks (3,4,6,3),
widths (64,128,256,512).
"""

from __future__ import annotations

from typing import Sequence

from deeplearning4j_tpu_torch.nn.conf import (
    ActivationLayer,
    BatchNormalization,
    ConvolutionLayer,
    ElementWiseVertex,
    GlobalPoolingLayer,
    InputType,
    NeuralNetConfiguration,
    OutputLayer,
    SubsamplingLayer,
    Updater,
)
from deeplearning4j_tpu_torch.nn.compgraph import ComputationGraph


def _conv_bn(gb, name, inp, n_out, k, stride, act="relu"):
    """conv(no bias, SAME) -> BN -> optional relu; returns output vertex
    name. Bias-free convs + BN is the standard ResNet recipe (and what BN
    makes redundant anyway)."""
    gb.add_layer(
        f"{name}_conv",
        ConvolutionLayer(
            kernel_size=(k, k), stride=(stride, stride), n_out=n_out,
            convolution_mode="same", has_bias=False, activation="identity",
        ),
        inp,
    )
    gb.add_layer(f"{name}_bn", BatchNormalization(), f"{name}_conv")
    if act is None:
        return f"{name}_bn"
    gb.add_layer(f"{name}_act", ActivationLayer(activation=act), f"{name}_bn")
    return f"{name}_act"


def _bottleneck(gb, name, inp, width, stride, project):
    """[1x1 w, 3x3 w (stride), 1x1 4w] + shortcut -> relu."""
    out_ch = 4 * width
    c = _conv_bn(gb, f"{name}_a", inp, width, 1, 1)
    c = _conv_bn(gb, f"{name}_b", c, width, 3, stride)
    c = _conv_bn(gb, f"{name}_c", c, out_ch, 1, 1, act=None)
    if project:
        sc = _conv_bn(gb, f"{name}_sc", inp, out_ch, 1, stride, act=None)
    else:
        sc = inp
    gb.add_vertex(f"{name}_add", ElementWiseVertex(op="add"), c, sc)
    gb.add_layer(f"{name}_relu", ActivationLayer(activation="relu"), f"{name}_add")
    return f"{name}_relu"


def resnet_conf(
    blocks: Sequence[int] = (3, 4, 6, 3),
    widths: Sequence[int] = (64, 128, 256, 512),
    num_classes: int = 1000,
    image_size: int = 224,
    channels: int = 3,
    stem_width: int = 64,
    seed: int = 123,
    learning_rate: float = 0.1,
    updater: str = Updater.NESTEROVS,
    precision: str = "f32",
):
    """Parametric bottleneck ResNet as a ComputationGraphConfiguration."""
    gb = (
        NeuralNetConfiguration.builder()
        .seed(seed)
        .updater(updater)
        .learning_rate(learning_rate)
        .momentum(0.9)
        .weight_init("relu")  # He init — the ResNet paper's choice
        .precision(precision)
        .graph_builder()
        .add_inputs("input")
        .set_input_types(InputType.convolutional(image_size, image_size, channels))
    )
    stem = _conv_bn(gb, "stem", "input", stem_width, 7, 2)
    gb.add_layer(
        "stem_pool",
        SubsamplingLayer(pooling_type="max", kernel_size=(3, 3), stride=(2, 2),
                         convolution_mode="same"),
        stem,
    )
    prev = "stem_pool"
    prev_ch = stem_width
    for si, (n_blocks, width) in enumerate(zip(blocks, widths)):
        for bi in range(n_blocks):
            stride = 2 if (si > 0 and bi == 0) else 1
            project = bi == 0  # channel change (or stride) on stage entry
            prev = _bottleneck(gb, f"s{si}b{bi}", prev, width, stride, project)
        prev_ch = 4 * width
    gb.add_layer("avgpool", GlobalPoolingLayer(pooling_type="avg"), prev)
    gb.add_layer(
        "out",
        OutputLayer(n_out=num_classes, activation="softmax", loss="mcxent"),
        "avgpool",
    )
    gb.set_outputs("out")
    return gb.build()


def resnet50_conf(num_classes: int = 1000, image_size: int = 224,
                  precision: str = "f32", **kw):
    return resnet_conf((3, 4, 6, 3), (64, 128, 256, 512),
                       num_classes=num_classes, image_size=image_size,
                       precision=precision, **kw)


def resnet50_network(num_classes: int = 1000, image_size: int = 224,
                     precision: str = "f32", device=None, **kw) -> ComputationGraph:
    """ResNet-50 on `device` ("cuda" when None; device="cpu" for the CPU)."""
    return ComputationGraph(
        resnet50_conf(num_classes, image_size, precision, **kw), device=device
    ).init()


def tiny_resnet_conf(num_classes: int = 3, image_size: int = 8,
                     precision: str = "f32", seed: int = 7):
    """Two-stage, one-block-per-stage, narrow ResNet for gradient checks
    and CI (the reference's pattern of tiny nets in
    gradientcheck/CNNGradientCheckTest.java)."""
    return resnet_conf(
        blocks=(1, 1), widths=(2, 4), num_classes=num_classes,
        image_size=image_size, channels=3, stem_width=4, seed=seed,
        precision=precision,
    )

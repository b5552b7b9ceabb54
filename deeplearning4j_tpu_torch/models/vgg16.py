"""VGG16 via the Keras importer (BASELINE.md workload 5).

The reference ships VGG16 as a Keras-1.x import target
(trainedmodels/TrainedModels.java VGG16 + KerasModelImport); here the same
architecture is emitted as a Keras 1.x ``model_config`` JSON and routed
through the native importer (deeplearning4j_tpu/modelimport/keras.py), so
the benchmark exercises the real import path end to end.

Simonyan & Zisserman configuration D: 13 conv3x3 (64,64 / 128,128 /
256x3 / 512x3 / 512x3) with 2x2 maxpool between blocks, then
4096-4096-1000 dense.
"""

from __future__ import annotations

import json


def vgg16_keras_config(num_classes: int = 1000, image_size: int = 224) -> str:
    """Keras 1.x Sequential model_config JSON for VGG16 (tf dim ordering)."""
    layers = []
    widths = [(64, 2), (128, 2), (256, 3), (512, 3), (512, 3)]
    conv_idx = pool_idx = 0
    first = True
    for block_width, n_convs in widths:
        for _ in range(n_convs):
            conv_idx += 1
            cfg = {
                "name": f"convolution2d_{conv_idx}",
                "nb_filter": block_width,
                "nb_row": 3,
                "nb_col": 3,
                "border_mode": "same",
                "subsample": [1, 1],
                "dim_ordering": "tf",
                "activation": "relu",
                "init": "glorot_uniform",
            }
            if first:
                cfg["batch_input_shape"] = [None, image_size, image_size, 3]
                first = False
            layers.append({"class_name": "Convolution2D", "config": cfg})
        pool_idx += 1
        layers.append({
            "class_name": "MaxPooling2D",
            "config": {
                "name": f"maxpooling2d_{pool_idx}",
                "pool_size": [2, 2],
                "strides": [2, 2],
                "border_mode": "valid",
                "dim_ordering": "tf",
            },
        })
    layers.append({"class_name": "Flatten", "config": {"name": "flatten_1"}})
    for i, width in enumerate((4096, 4096), start=1):
        layers.append({
            "class_name": "Dense",
            "config": {
                "name": f"dense_{i}",
                "output_dim": width,
                "activation": "relu",
                "init": "glorot_uniform",
            },
        })
    layers.append({
        "class_name": "Dense",
        "config": {
            "name": "dense_3",
            "output_dim": num_classes,
            "activation": "softmax",
            "init": "glorot_uniform",
        },
    })
    return json.dumps({"class_name": "Sequential", "config": layers})


def vgg16_conf(num_classes: int = 1000, image_size: int = 224,
               precision: str = "bf16"):
    """MultiLayerConfiguration for VGG16, built THROUGH the Keras importer
    (the import path is the workload, matching the baseline's
    'VGG16-via-Keras-import')."""
    from deeplearning4j_tpu_torch.modelimport.keras import import_keras_sequential_config

    tc = json.dumps({"loss": "categorical_crossentropy",
                     "optimizer": {"name": "sgd"}})
    conf, _ = import_keras_sequential_config(
        vgg16_keras_config(num_classes, image_size), tc, precision=precision,
    )
    return conf


def vgg16_network(num_classes: int = 1000, image_size: int = 224,
                  precision: str = "bf16", seed: int = None, device=None):
    """VGG16 on `device` ("cuda" when None; device="cpu" for the CPU),
    weights drawn from `seed` (the configuration's default seed when
    None)."""
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    conf = vgg16_conf(num_classes, image_size, precision)
    if seed is not None:
        conf.net_conf.seed = int(seed)
    return MultiLayerNetwork(conf, device=device).init()

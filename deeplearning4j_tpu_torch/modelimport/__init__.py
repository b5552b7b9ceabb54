"""Keras model import (reference: deeplearning4j-modelimport, SURVEY §2.5),
the port of the JAX package's modelimport/ (the Keras importer; the DL4J
zip importer is not ported yet).

Reads Keras-1.x HDF5 archives (``model_config``/``training_config`` JSON
attributes + ``model_weights`` groups — KerasModel.java:73-75,550-556) and
emits networks built through the config DSL, copying weights with the
dim-ordering transposes the NHWC/HWIO layout requires.
"""

from deeplearning4j_tpu_torch.modelimport.keras import (
    KerasImportError,
    import_keras_model_and_weights,
    import_keras_model_config,
    import_keras_sequential_config,
    import_keras_sequential_model_and_weights,
)

__all__ = [
    "KerasImportError",
    "import_keras_model_and_weights",
    "import_keras_model_config",
    "import_keras_sequential_config",
    "import_keras_sequential_model_and_weights",
]

"""Model import (reference: deeplearning4j-modelimport, SURVEY §2.5), the
port of the JAX package's modelimport/: the Keras importer (`keras.py`)
and the DL4J-format zip importer and exporter (`dl4j.py`).

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

from deeplearning4j_tpu_torch.modelimport.dl4j import (
    export_dl4j_graph,
    export_dl4j_zip,
    import_dl4j_computation_graph,
    import_dl4j_multilayer,
)

__all__ = [
    "export_dl4j_graph",
    "export_dl4j_zip",
    "import_dl4j_computation_graph",
    "import_dl4j_multilayer",
    "KerasImportError",
    "import_keras_model_and_weights",
    "import_keras_model_config",
    "import_keras_sequential_config",
    "import_keras_sequential_model_and_weights",
]

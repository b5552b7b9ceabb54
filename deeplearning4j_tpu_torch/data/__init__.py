"""Data: the DataSet container and the host iterators (the port of the
JAX package's data/)."""

from deeplearning4j_tpu_torch.data.dataset import DataSet, MultiDataSet
from deeplearning4j_tpu_torch.data.iterators import (
    DataSetIterator,
    ExistingDataSetIterator,
    ListDataSetIterator,
    MultiDataSetIterator,
)

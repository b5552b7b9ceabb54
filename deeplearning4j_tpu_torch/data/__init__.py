"""Data: the DataSet container, the host iterators and the staged input
pipeline (the port of the JAX package's data/)."""

from deeplearning4j_tpu_torch.data.dataset import DataSet, MultiDataSet
from deeplearning4j_tpu_torch.data.iterators import (
    AsyncDataSetIterator,
    DataSetIterator,
    ExistingDataSetIterator,
    ListDataSetIterator,
    MultiDataSetIterator,
    MultipleEpochsIterator,
    StackedDataSetIterator,
)
from deeplearning4j_tpu_torch.data.prefetch import (
    DevicePrefetchIterator,
    ParallelDataSetIterator,
    place_dataset,
)
from deeplearning4j_tpu_torch.data.transforms import DeviceBatchTransform

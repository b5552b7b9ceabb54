"""Record-reader ETL bridge (the DataVec analog).

Reference: RecordReader SPI + CSVRecordReader (datavec-api, consumed via
deeplearning4j-core's RecordReaderDataSetIterator, datasets/datavec/) —
rows of typed fields streamed from storage, converted to DataSets with a
label column and one-hot encoding. The port of the JAX package's
data/records.py: host numpy batches, as every port iterator yields.
"""

from __future__ import annotations

import csv
import io
from typing import Iterable, Iterator, List, Optional, Sequence, Union

import numpy as np

from deeplearning4j_tpu_torch.data.dataset import DataSet
from deeplearning4j_tpu_torch.data.iterators import DataSetIterator


class RecordReader:
    """SPI: iterable of records (lists of field values)."""

    def __iter__(self) -> Iterator[List[str]]:
        raise NotImplementedError

    def reset(self) -> None:
        pass


class CollectionRecordReader(RecordReader):
    """In-memory records (reference: CollectionRecordReader)."""

    def __init__(self, records: Sequence[Sequence]):
        self.records = [list(r) for r in records]

    def __iter__(self):
        return iter(self.records)


class CSVRecordReader(RecordReader):
    """CSV rows from a path or file-like (reference: CSVRecordReader with
    skipNumLines + delimiter)."""

    def __init__(self, source: Union[str, io.IOBase], skip_lines: int = 0,
                 delimiter: str = ","):
        self.source = source
        self.skip_lines = int(skip_lines)
        self.delimiter = delimiter

    def __iter__(self):
        if isinstance(self.source, str):
            fh = open(self.source, newline="")
            close = True
        else:
            self.source.seek(0)
            fh = self.source
            close = False
        try:
            reader = csv.reader(fh, delimiter=self.delimiter)
            for i, row in enumerate(reader):
                if i < self.skip_lines or not row:
                    continue
                yield row
        finally:
            if close:
                fh.close()


class RecordReaderDataSetIterator(DataSetIterator):
    """records -> DataSet batches (reference:
    RecordReaderDataSetIterator(reader, batchSize, labelIndex, numClasses)
    for classification; labelIndexFrom/To for regression)."""

    def __init__(self, reader: RecordReader, batch_size: int,
                 label_index: Optional[int] = None,
                 num_classes: Optional[int] = None,
                 label_index_from: Optional[int] = None,
                 label_index_to: Optional[int] = None):
        self.reader = reader
        self.batch_size = int(batch_size)
        self.label_index = label_index
        self.num_classes = num_classes
        self.label_from = label_index_from
        self.label_to = label_index_to
        if (label_index is None) == (label_index_from is None):
            raise ValueError(
                "exactly one of label_index (classification) or "
                "label_index_from/to (regression) is required")
        self._it: Optional[Iterator] = None

    def reset(self):
        self.reader.reset()
        self._it = None

    def __iter__(self):
        self._it = iter(self.reader)
        while True:
            rows = []
            for rec in self._it:
                rows.append(rec)
                if len(rows) == self.batch_size:
                    break
            if not rows:
                return
            yield self._to_dataset(rows)

    def _to_dataset(self, rows: List[List[str]]) -> DataSet:
        a = np.asarray(rows, dtype=object)
        if self.label_index is not None:
            li = self.label_index
            feat_cols = [c for c in range(a.shape[1]) if c != li]
            x = a[:, feat_cols].astype(np.float32)
            labels = a[:, li].astype(np.int64)
            y = np.zeros((len(rows), self.num_classes), np.float32)
            y[np.arange(len(rows)), labels] = 1.0
        else:
            lo, hi = self.label_from, self.label_to
            feat_cols = [c for c in range(a.shape[1])
                         if not (lo <= c <= hi)]
            x = a[:, feat_cols].astype(np.float32)
            y = a[:, lo:hi + 1].astype(np.float32)
        return DataSet(x, y)

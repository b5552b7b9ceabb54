"""DataSet containers.

The port of the JAX package's data/dataset.py: `DataSet` (ND4J's DataSet:
features, labels, optional masks) — the unit every iterator yields and
fit() consumes — and `MultiDataSet`, its multi-input/multi-output form for
ComputationGraph. Arrays are host numpy until the train step moves them to
the network's device.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np


@dataclasses.dataclass
class DataSet:
    features: np.ndarray
    labels: np.ndarray
    features_mask: Optional[np.ndarray] = None
    labels_mask: Optional[np.ndarray] = None

    def num_examples(self) -> int:
        return int(self.features.shape[0])

    @staticmethod
    def concat(batches: List["DataSet"]) -> "DataSet":
        """Concatenate along the example axis (masks must be uniformly
        present or absent)."""
        if len(batches) == 1:
            return batches[0]

        def _cat(attr):
            vals = [getattr(b, attr) for b in batches]
            if all(v is None for v in vals):
                return None
            if any(v is None for v in vals):
                raise ValueError(f"mixed None/{attr} across concatenated batches")
            return np.concatenate(vals, axis=0)

        return DataSet(
            np.concatenate([b.features for b in batches], axis=0),
            np.concatenate([b.labels for b in batches], axis=0),
            _cat("features_mask"),
            _cat("labels_mask"),
        )

    def split_batches(self, batch_size: int) -> List["DataSet"]:
        n = self.num_examples()
        return [self._rows(slice(i, min(i + batch_size, n)))
                for i in range(0, n, batch_size)]

    def _rows(self, sl) -> "DataSet":
        return DataSet(
            self.features[sl],
            self.labels[sl],
            None if self.features_mask is None else self.features_mask[sl],
            None if self.labels_mask is None else self.labels_mask[sl],
        )


@dataclasses.dataclass
class MultiDataSet:
    """Multiple inputs / multiple outputs (reference: ND4J MultiDataSet,
    consumed by ComputationGraph.fit)."""

    features: List[np.ndarray]
    labels: List[np.ndarray]
    features_masks: Optional[List[Optional[np.ndarray]]] = None
    labels_masks: Optional[List[Optional[np.ndarray]]] = None

    def num_examples(self) -> int:
        return int(self.features[0].shape[0])

"""DataSet iterators.

The port of the JAX package's data/iterators.py host iterators
(reference: datasets/iterator/): the DataSetIterator SPI,
ListDataSetIterator and ExistingDataSetIterator, and the
MultiDataSetIterator SPI that ComputationGraph.fit also takes. The background-prefetch
wrappers (AsyncDataSetIterator and the staged device pipeline) are not
ported yet.
"""

from __future__ import annotations

from typing import Iterable, Iterator, List, Optional

import numpy as np

from deeplearning4j_tpu_torch.data.dataset import DataSet


class DataSetIterator:
    """SPI: iterable over DataSet minibatches with reset().

    `state()`/`restore_state()` are the mid-epoch resume protocol: a
    small JSON-safe dict that reproduces an epoch from its start. The
    defaults declare the iterator stateless. `close()` releases
    background workers, if any; the plain host iterators have none."""

    def __iter__(self) -> Iterator[DataSet]:
        raise NotImplementedError

    def reset(self) -> None:
        pass

    def batch_size(self) -> Optional[int]:
        return None

    def total_examples(self) -> Optional[int]:
        return None

    def state(self) -> Optional[dict]:
        """JSON-safe epoch-reproduction state; None = stateless."""
        return None

    def restore_state(self, state: Optional[dict]) -> None:
        """Prime a fresh iterator with a `state()` capture."""

    def close(self) -> None:
        """Release background workers/queues, if any."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


class ListDataSetIterator(DataSetIterator):
    """Minibatches from in-memory arrays (reference:
    ListDataSetIterator / ExistingDataSetIterator)."""

    def __init__(self, dataset: DataSet, batch: int, shuffle: bool = False, seed: int = 0):
        self.dataset = dataset
        self.batch = batch
        self.shuffle = shuffle
        self._epoch = 0
        self.seed = seed

    def __iter__(self):
        n = self.dataset.num_examples()
        idx = np.arange(n)
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self._epoch)
            rng.shuffle(idx)
        self._epoch += 1
        for i in range(0, n, self.batch):
            yield self.dataset._rows(idx[i: i + self.batch])

    def batch_size(self):
        return self.batch

    def total_examples(self):
        return self.dataset.num_examples()

    def state(self):
        # the epoch counter seeds the shuffle permutation
        return {"epoch": int(self._epoch)}

    def restore_state(self, state):
        if state:
            self._epoch = int(state.get("epoch", 0))


class ExistingDataSetIterator(DataSetIterator):
    """Wraps any iterable of DataSets (reference: ExistingDataSetIterator)."""

    def __init__(self, datasets: Iterable[DataSet]):
        self._list: List[DataSet] = list(datasets)

    def __iter__(self):
        return iter(self._list)

    def total_examples(self):
        return sum(d.num_examples() for d in self._list)


class MultiDataSetIterator:
    """SPI: iterable over MultiDataSet minibatches with reset()
    (reference: nd4j MultiDataSetIterator, consumed by
    ComputationGraph.fit)."""

    def __iter__(self):
        raise NotImplementedError

    def reset(self) -> None:
        pass

    def batch_size(self) -> Optional[int]:
        return None

    def total_examples(self) -> Optional[int]:
        return None

    def state(self) -> Optional[dict]:
        return None

    def restore_state(self, state: Optional[dict]) -> None:
        pass

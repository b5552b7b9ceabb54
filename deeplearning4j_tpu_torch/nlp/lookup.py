"""Embedding lookup table — the device-side buffers.

Analog of the reference's InMemoryLookupTable
(models/embeddings/inmemory/InMemoryLookupTable.java:55-97): syn0 (word
vectors), syn1 (hierarchical-softmax inner-node weights), syn1neg
(negative-sampling output weights), and the unigram sampling table. The
port keeps syn* as tensors on the model's device, updated in place by the
training steps (nlp/learning.py); sigmoid is computed on the fly rather
than read from a precomputed table. Queries return numpy arrays and
Python floats, as the JAX package's do.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.common.devices import resolve_device
from deeplearning4j_tpu_torch.nlp.vocab import VocabCache


def uniform_init(seed: int, rows: int, dim: int, device, dtype=torch.float32):
    """word2vec init, U(-0.5/dim, 0.5/dim), drawn on the CPU from a
    torch.Generator seeded with `seed` (the same values on every device),
    then moved to `device`."""
    gen = torch.Generator().manual_seed(int(seed))
    t = (torch.rand((rows, dim), generator=gen, dtype=dtype) - 0.5) / dim
    return t.to(device)


def as_table(arr, device, dtype=torch.float32) -> torch.Tensor:
    """A numpy array (or tensor) as a contiguous table on `device`."""
    return torch.tensor(np.asarray(arr), dtype=dtype).to(device).contiguous()


class InMemoryLookupTable:
    def __init__(self, vocab: VocabCache, vector_length: int, *, seed: int = 12345,
                 use_hs: bool = True, negative: int = 0, dtype=torch.float32,
                 device=None):
        self.vocab = vocab
        self.vector_length = int(vector_length)
        self.use_hs = bool(use_hs)
        self.negative = int(negative)
        self.device = resolve_device(device)
        V, D = vocab.num_words(), self.vector_length
        # word2vec init: syn0 ~ U(-0.5/D, 0.5/D), outputs zero
        self.syn0 = uniform_init(seed, max(V, 1), D, self.device, dtype)
        self.syn1 = (torch.zeros((max(V - 1, 1), D), dtype=dtype, device=self.device)
                     if use_hs else None)
        self.syn1neg = (torch.zeros((max(V, 1), D), dtype=dtype, device=self.device)
                        if negative > 0 else None)
        self._unigram: Optional[np.ndarray] = None

    @classmethod
    def from_numpy(cls, vocab: VocabCache, syn0, syn1=None, syn1neg=None, *,
                   device=None) -> "InMemoryLookupTable":
        """A table holding the given arrays (e.g. the JAX package's tables,
        carried across), on `device`. use_hs and negative follow which
        output tables are given."""
        syn0 = np.asarray(syn0)
        table = cls.__new__(cls)
        table.vocab = vocab
        table.vector_length = int(syn0.shape[1])
        table.use_hs = syn1 is not None
        table.negative = 1 if syn1neg is not None else 0
        table.device = resolve_device(device)
        table.syn0 = as_table(syn0, table.device)
        table.syn1 = None if syn1 is None else as_table(syn1, table.device)
        table.syn1neg = None if syn1neg is None else as_table(syn1neg, table.device)
        table._unigram = None
        return table

    # -- unigram table for negative sampling ---------------------------------

    def unigram_table(self, table_size: int = 1_000_000, power: float = 0.75) -> np.ndarray:
        """Sampling table: word index repeated proportionally to
        count^0.75 (reference: InMemoryLookupTable.makeTable)."""
        if self._unigram is None or self._unigram.size != table_size:
            counts = self.vocab.counts().astype(np.float64)
            if counts.size == 0:
                raise ValueError("empty vocab")
            p = counts**power
            p /= p.sum()
            bounds = np.cumsum(p)
            self._unigram = np.searchsorted(
                bounds, (np.arange(table_size) + 0.5) / table_size
            ).astype(np.int64)
        return self._unigram

    # -- vector access -------------------------------------------------------

    def vector(self, word: str) -> Optional[np.ndarray]:
        idx = self.vocab.index_of(word)
        if idx < 0:
            return None
        return self.syn0[idx].cpu().numpy()

    def vectors(self) -> np.ndarray:
        return self.syn0[: self.vocab.num_words()].cpu().numpy()

    def set_vectors(self, arr):
        self.syn0 = as_table(arr, self.device)

    def similarity(self, a: str, b: str) -> float:
        va, vb = self.vector(a), self.vector(b)
        if va is None or vb is None:
            return float("nan")
        denom = np.linalg.norm(va) * np.linalg.norm(vb)
        return float(va @ vb / denom) if denom else 0.0

    def words_nearest(self, word_or_vec, top_n: int = 10):
        """Cosine-nearest words over the whole table (reference:
        WordVectors.wordsNearest). Computed on the host in numpy, as the
        JAX package does, so both rank ties alike."""
        if isinstance(word_or_vec, str):
            v = self.vector(word_or_vec)
            if v is None:
                return []
            exclude = {word_or_vec}
        else:
            v = np.asarray(word_or_vec)
            exclude = set()
        table = self.vectors()
        norms = np.linalg.norm(table, axis=1) * (np.linalg.norm(v) + 1e-12)
        sims = (table @ v) / np.maximum(norms, 1e-12)
        order = np.argsort(-sims)
        out = []
        for i in order:
            w = self.vocab.word_at_index(int(i))
            if w in exclude:
                continue
            out.append((w, float(sims[i])))
            if len(out) >= top_n:
                break
        return out

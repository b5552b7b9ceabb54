"""GloVe — global-vectors embedding learning.

Reference parity: models/embeddings/learning/impl/elements/GloVe.java
(AdaGrad weighted-least-squares over co-occurrence pairs; one shared
syn0 table plus per-word biases — iterateSample computes
``w_i·w_j + b_i + b_j − log X_ij``, weights the squared error by
``min((X/x_max)^alpha, 1)`` and applies AdaGrad per row) and
models/glove/AbstractCoOccurrences.java:322-374 (forward-window
co-occurrence scan, 1/distance weights, mirrored when symmetric; the
count machinery under models/glove/count/ shards this to disk).

The co-occurrence table is accumulated once (the port's native/corpus.cpp
corpus_cooc_build when the C++ pipeline is available, a Python pass
otherwise) and training runs as a fixed-shape batch step on the model's
device — gather both row sets, weighted-lsq gradient, AdaGrad scale,
scatter-add back — with the tables updated in place. The losses stay on
the device and are read once an epoch.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.nlp.learning import scalar, to_device
from deeplearning4j_tpu_torch.nlp.lookup import as_table
from deeplearning4j_tpu_torch.nlp.sequencevectors import (
    SequenceVectors,
    VectorsConfiguration,
)
from deeplearning4j_tpu_torch.nlp.vocab import VocabCache

logger = logging.getLogger("deeplearning4j_tpu_torch.nlp")

_EPS = 1e-8


def cooccurrences_indexed(indexed: Sequence[np.ndarray], window: int = 5,
                          symmetric: bool = True
                          ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Numpy co-occurrence accumulation over vocab-indexed sentences —
    same semantics as the native corpus_cooc_build (forward window,
    1/distance weights, optional mirroring). Returns COO arrays
    (rows, cols, weights)."""
    acc: Dict[Tuple[int, int], float] = {}
    for sent in indexed:
        n = sent.size
        for x in range(n):
            stop = min(x + window + 1, n)
            for j in range(x + 1, stop):
                w = 1.0 / (j - x)
                a, b = int(sent[x]), int(sent[j])
                acc[(a, b)] = acc.get((a, b), 0.0) + w
                if symmetric:
                    acc[(b, a)] = acc.get((b, a), 0.0) + w
    if not acc:
        return (np.zeros(0, np.int32), np.zeros(0, np.int32),
                np.zeros(0, np.float32))
    keys = np.asarray(list(acc.keys()), np.int32)
    vals = np.asarray(list(acc.values()), np.float32)
    return keys[:, 0], keys[:, 1], vals


def _glove_step(syn0, bias, hist0, histb, i, j, logx, f, lr):
    """One AdaGrad weighted-least-squares batch, the tables updated in
    place; returns the batch's loss (a 0-d device tensor).

    i/j: [B] row indices (padding points at row 0 with f == 0, which
    contributes zero gradient AND zero AdaGrad history). f is the
    precomputed weighting min((X/x_max)^alpha, 1). The order of reads is
    the JAX package's: gi and gj from the rows as they were before the
    update, and both i's and j's squared gradients in hist0/histb before
    either row reads its history."""
    wi, wj = syn0[i], syn0[j]
    diff = torch.sum(wi * wj, dim=-1) + bias[i] + bias[j] - logx
    fdiff = f * diff                      # [B]
    loss = 0.5 * torch.sum(fdiff * diff)
    gi = fdiff[:, None] * wj
    gj = fdiff[:, None] * wi
    hist0.index_add_(0, i, gi * gi).index_add_(0, j, gj * gj)
    histb.index_add_(0, i, fdiff * fdiff).index_add_(0, j, fdiff * fdiff)
    di = -lr * gi * torch.rsqrt(hist0[i] + _EPS)
    dj = -lr * gj * torch.rsqrt(hist0[j] + _EPS)
    dbi = -lr * fdiff * torch.rsqrt(histb[i] + _EPS)
    dbj = -lr * fdiff * torch.rsqrt(histb[j] + _EPS)
    syn0.index_add_(0, i, di).index_add_(0, j, dj)
    bias.index_add_(0, i, dbi).index_add_(0, j, dbj)
    return loss


class Glove(SequenceVectors):
    """GloVe model with the SequenceVectors API surface (fit, fit_file,
    word_vector, similarity, words_nearest, WordVectorSerializer).

    Glove-specific hyperparameters live on VectorsConfiguration:
    x_max, glove_alpha, glove_symmetric, glove_shuffle."""

    def __init__(self, conf: Optional[VectorsConfiguration] = None,
                 sequences: Optional[Iterable[Sequence[str]]] = None,
                 vocab: Optional[VocabCache] = None, *, device=None):
        conf = (dataclasses.replace(  # never mutate the caller's conf
            conf, use_hierarchic_softmax=False, negative=0)
            if conf is not None else VectorsConfiguration(
                learning_rate=0.05, use_hierarchic_softmax=False,
                negative=0))  # no output tables: one shared syn0 + biases
        super().__init__(conf, sequences, vocab, device=device)
        self.bias: Optional[torch.Tensor] = None
        self.adagrad_state = None

    def set_state(self, bias, adagrad_state=None) -> "Glove":
        """Carry the biases and, optionally, the AdaGrad histories
        (hist0 [V, D], histb [V]) in from numpy, e.g. the JAX package's;
        the next train_cooccurrences continues from them."""
        self.bias = as_table(bias, self.device)
        self.adagrad_state = (None if adagrad_state is None else
                              tuple(as_table(a, self.device) for a in adagrad_state))
        return self

    # -- training -------------------------------------------------------------

    def train_indexed(self, indexed: List[np.ndarray]):
        rows, cols, vals = cooccurrences_indexed(
            indexed, self.conf.window, self.conf.glove_symmetric)
        self.train_cooccurrences(rows, cols, vals)

    def fit_file(self, path: str, lowercase: bool = False):
        """Native path: vocab AND co-occurrence accumulation both run in
        C++ (corpus.cpp); only the COO arrays cross into Python."""
        from deeplearning4j_tpu_torch import native as native_mod

        if not native_mod.native_available():
            return super().fit_file(path, lowercase=lowercase)
        with native_mod.NativeCorpus(path, lowercase=lowercase) as corpus:
            self._vocab_from_native(corpus)
            rows, cols, vals = corpus.cooccurrences(
                self.conf.min_word_frequency, self.conf.window,
                self.conf.glove_symmetric)
        self.train_cooccurrences(rows, cols, vals)
        return self

    def train_cooccurrences(self, rows: np.ndarray, cols: np.ndarray,
                            vals: np.ndarray):
        """AdaGrad weighted-lsq over the co-occurrence COO table."""
        conf = self.conf
        if self.lookup is None:
            self.build_vocab()
        n = int(rows.size)
        if n == 0:
            logger.warning("GloVe: empty co-occurrence table; nothing to do")
            self.last_loss = float("nan")
            return
        V, D = self.lookup.syn0.shape
        logx = np.log(np.maximum(vals, 1e-12)).astype(np.float32)
        f = np.minimum(
            (vals / conf.x_max) ** conf.glove_alpha, 1.0).astype(np.float32)

        dev = self.device
        syn0 = self.lookup.syn0
        bias = (self.bias if self.bias is not None
                else torch.zeros((V,), dtype=torch.float32, device=dev))
        if self.adagrad_state is not None:
            hist0, histb = self.adagrad_state
        else:
            hist0 = torch.zeros((V, D), dtype=torch.float32, device=dev)
            histb = torch.zeros((V,), dtype=torch.float32, device=dev)
        lr = scalar(conf.learning_rate, dev)

        B = min(conf.batch_size, max(n, 1))
        n_batches = -(-n // B)
        self.last_loss = float("nan")
        for epoch in range(conf.epochs):
            order = (self._rng.permutation(n) if conf.glove_shuffle
                     else np.arange(n))
            losses = []  # device tensors; read back once an epoch, so the
            for b in range(n_batches):  # host never waits on the device
                sel = order[b * B:(b + 1) * B]
                pad = B - sel.size
                bi = np.concatenate([rows[sel], np.zeros(pad, np.int32)])
                bj = np.concatenate([cols[sel], np.zeros(pad, np.int32)])
                bx = np.concatenate([logx[sel], np.zeros(pad, np.float32)])
                bf = np.concatenate([f[sel], np.zeros(pad, np.float32)])
                loss = _glove_step(
                    syn0, bias, hist0, histb,
                    to_device(bi, dev).long(), to_device(bj, dev).long(),
                    to_device(bx, dev), to_device(bf, dev), lr)
                losses.append(loss)
            self.last_loss = float(np.sum(torch.stack(losses).cpu().numpy())) / n
            logger.info("GloVe epoch %d: loss/pair %.5f", epoch,
                        self.last_loss)
        self.lookup.syn0 = syn0
        self.bias = bias
        self.adagrad_state = (hist0, histb)

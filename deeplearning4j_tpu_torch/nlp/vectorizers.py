"""Bag-of-words / TF-IDF text vectorizers.

Analog of the reference's bagofwords/vectorizer/ (BaseTextVectorizer +
BagOfWordsVectorizer + TfidfVectorizer): build a vocabulary (with
document frequencies) over a corpus, then turn any text into a
[1, vocab] feature row — counts for bag-of-words, tf*idf for TF-IDF —
and (text, label) pairs into DataSets for the training stack.

Formulas pinned to the reference: tf = count / documentLength
(TfidfVectorizer.java tfForWord), idf = log10(totalDocs / docsWithWord)
(util/MathUtils.java:258 idf, 0 when no documents), score = tf * idf.
One deliberate deviation: the reference's BagOfWordsVectorizer.transform
writes the CORPUS-level frequency at each index
(BagOfWordsVectorizer.java:77 wordFrequency), which makes every document
containing a word score it identically; here bag-of-words is the
standard per-document count, which is what every consumer of a BoW
vector expects.
"""

from __future__ import annotations

import math
from collections import Counter
from typing import Iterable, List, Optional, Sequence

import numpy as np

from deeplearning4j_tpu_torch.data.dataset import DataSet
from deeplearning4j_tpu_torch.nlp.tokenization import (
    DefaultTokenizerFactory,
    TokenizerFactory,
)
from deeplearning4j_tpu_torch.nlp.vocab import VocabCache


class LabelsSource:
    """Stable label -> index mapping (reference: text/documentiterator/
    LabelsSource.java)."""

    def __init__(self, labels: Optional[Sequence[str]] = None):
        self._labels: List[str] = []
        self._index = {}
        for l in labels or []:
            self.store(l)

    def store(self, label: str) -> int:
        if label not in self._index:
            self._index[label] = len(self._labels)
            self._labels.append(label)
        return self._index[label]

    def index_of(self, label: str) -> int:
        return self._index.get(label, -1)

    def labels(self) -> List[str]:
        return list(self._labels)

    def size(self) -> int:
        return len(self._labels)


class BaseTextVectorizer:
    """Shared vocab construction: tokenize every document, count corpus
    and document frequencies, keep words with count >= min_word_frequency
    in (count desc, word asc) order — the VocabConstructor contract."""

    def __init__(self, *, min_word_frequency: int = 1,
                 tokenizer_factory: Optional[TokenizerFactory] = None,
                 stop_words: Iterable[str] = ()):
        self.min_word_frequency = int(min_word_frequency)
        self.tokenizer_factory = tokenizer_factory or DefaultTokenizerFactory()
        self.stop_words = set(stop_words)
        self.vocab: Optional[VocabCache] = None
        self.doc_frequencies: Optional[np.ndarray] = None  # [V] int64
        self.total_docs = 0
        self.labels_source = LabelsSource()

    def tokenize(self, text: str) -> List[str]:
        toks = self.tokenizer_factory.create(text).get_tokens()
        return [t for t in toks if t and t not in self.stop_words]

    def fit(self, documents: Iterable[str],
            labels: Optional[Iterable[str]] = None) -> "BaseTextVectorizer":
        counts: Counter = Counter()
        doc_counts: Counter = Counter()
        n_docs = 0
        for doc in documents:
            toks = self.tokenize(doc)
            counts.update(toks)
            doc_counts.update(set(toks))
            n_docs += 1
        vocab = VocabCache()
        kept = sorted(
            (w for w, c in counts.items() if c >= self.min_word_frequency),
            key=lambda w: (-counts[w], w))
        for w in kept:
            vocab.add(w, counts[w])
        self.vocab = vocab
        self.total_docs = n_docs
        self.doc_frequencies = np.asarray(
            [doc_counts[w] for w in kept], np.int64)
        for l in labels or []:
            self.labels_source.store(l)
        return self

    # -- per-document weights (subclass hook) --------------------------------

    def _weight(self, count: int, doc_len: int, word_index: int) -> float:
        raise NotImplementedError

    def transform(self, text_or_tokens) -> np.ndarray:
        """One document -> [1, vocab] row."""
        if self.vocab is None:
            raise ValueError("vectorizer not fitted")
        toks = (self.tokenize(text_or_tokens)
                if isinstance(text_or_tokens, str) else list(text_or_tokens))
        out = np.zeros((1, self.vocab.num_words()), np.float32)
        counts = Counter(toks)
        for w, c in counts.items():
            idx = self.vocab.index_of(w)
            if idx >= 0:
                out[0, idx] = self._weight(c, len(toks), idx)
        return out

    def vectorize(self, text: str, label: str) -> DataSet:
        """(text, label) -> DataSet with a one-hot label row (reference:
        TfidfVectorizer.vectorize). The label space is FIXED by fit(...,
        labels=...): every DataSet gets the same label width, so batches
        stack; an unknown label is an error, not a silent widening."""
        x = self.transform(text)
        if self.labels_source.size() == 0:
            raise ValueError(
                "no label space — pass labels=[...] to fit() before "
                "vectorize()")
        li = self.labels_source.index_of(label)
        if li < 0:
            raise ValueError(
                f"unknown label {label!r}; known: "
                f"{self.labels_source.labels()}")
        y = np.zeros((1, self.labels_source.size()), np.float32)
        y[0, li] = 1.0
        return DataSet(x, y)

    def fit_transform(self, documents: Sequence[str]) -> np.ndarray:
        self.fit(documents)
        return np.concatenate([self.transform(d) for d in documents], axis=0)


class BagOfWordsVectorizer(BaseTextVectorizer):
    """Per-document term counts (see module docstring for the deliberate
    deviation from the reference's corpus-frequency quirk)."""

    def _weight(self, count, doc_len, word_index):
        return float(count)


class TfidfVectorizer(BaseTextVectorizer):
    """tf * idf with the reference's exact formulas."""

    def tf(self, count: int, doc_len: int) -> float:
        return count / doc_len if doc_len else 0.0

    def idf(self, word_index: int) -> float:
        if self.total_docs == 0:
            return 0.0
        df = int(self.doc_frequencies[word_index])
        if df == 0:
            return 0.0
        return math.log10(self.total_docs / df)

    def _weight(self, count, doc_len, word_index):
        return self.tf(count, doc_len) * self.idf(word_index)

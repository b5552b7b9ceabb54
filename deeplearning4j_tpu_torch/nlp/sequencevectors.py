"""SequenceVectors — the generic embedding trainer.

Analog of the reference's models/sequencevectors/SequenceVectors.java
(1,218 LoC): build vocab over a sequence stream, Huffman-code it, then
train a lookup table with a pluggable learning algorithm. The reference
spawns VectorCalculationsThread workers that push batched updates into
native aggregate ops (:285-289); here the host streams fixed-shape
batches (batching.py) into the device step (learning.py), a group of
batches at a time.

Learning algorithms (reference: models/embeddings/learning/impl/):
elements = "skipgram" | "cbow"; sequence (documents) = "dm" | "dbow" are
driven by ParagraphVectors on top of this trainer.

The tables live on the model's device (`device=None` means "cuda"; the
CPU only when asked). Inside an epoch the learning rate, the pair
counter and the losses stay on the device; the loss is read once an
epoch.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Iterable, List, Optional, Sequence

import numpy as np
import torch

from deeplearning4j_tpu_torch.common.devices import resolve_device
from deeplearning4j_tpu_torch.common.dtypes import default_policy
from deeplearning4j_tpu_torch.nlp.batching import (
    BatchPlan,
    generate_batches,
    group_batches,
    keep_probabilities,
    subsample,
)
from deeplearning4j_tpu_torch.nlp.learning import (
    batch_to_device,
    make_embedding_scan_step,
    to_device,
)
from deeplearning4j_tpu_torch.nlp.lookup import InMemoryLookupTable
from deeplearning4j_tpu_torch.nlp.vocab import Huffman, VocabCache, VocabConstructor

logger = logging.getLogger("deeplearning4j_tpu_torch.nlp")


@dataclasses.dataclass
class VectorsConfiguration:
    """Hyperparameters (reference: models/embeddings/loader/
    VectorsConfiguration.java + SequenceVectors.Builder defaults). The
    same fields as the JAX package's, so a full-model zip's config.json
    loads in either package."""

    layer_size: int = 100
    window: int = 5
    min_word_frequency: int = 5
    iterations: int = 1          # passes per batch stream (reference: iterations)
    epochs: int = 1
    learning_rate: float = 0.025
    min_learning_rate: float = 1e-4
    negative: int = 0
    use_hierarchic_softmax: bool = True
    sampling: float = 0.0        # subsampling threshold t (0 = off)
    batch_size: int = 2048
    scan_size: int = 16          # batches per group (one upload)
    seed: int = 12345
    elements_learning_algorithm: str = "skipgram"  # or "cbow"
    # GloVe-specific (reference: GloVe.java builder defaults)
    x_max: float = 100.0
    glove_alpha: float = 0.75
    glove_symmetric: bool = True
    glove_shuffle: bool = True


def _placeholder(conf, device):
    """A [1, D] stand-in for an output table the configuration lacks."""
    return torch.zeros((1, conf.layer_size), dtype=torch.float32, device=device)


class SequenceVectors:
    """Generic trainer over sequences of string elements."""

    def __init__(self, conf: VectorsConfiguration,
                 sequences: Optional[Iterable[Sequence[str]]] = None,
                 vocab: Optional[VocabCache] = None, *, device=None):
        self.device = resolve_device(device)
        default_policy().apply()  # f32 einsums: TF32 off
        self.conf = conf
        self._sequences = sequences
        self.vocab = vocab
        self.lookup: Optional[InMemoryLookupTable] = None
        self.huffman: Optional[Huffman] = None
        self._rng = np.random.default_rng(conf.seed)
        self._gen: Optional[torch.Generator] = None  # device draws, made lazily
        self._scan_step = None
        self._corpus_step = None

    def _generator(self) -> torch.Generator:
        """The device generator for negatives and window draws."""
        if self._gen is None:
            self._gen = torch.Generator(device=self.device).manual_seed(
                self.conf.seed ^ 0x5EED)
        return self._gen

    # -- vocab + table construction ------------------------------------------

    def build_vocab(self):
        if self.vocab is None:
            if self._sequences is None:
                raise ValueError("no sequences to build a vocab from")
            self.vocab = VocabConstructor(
                self.conf.min_word_frequency
            ).build(self._sequences)
        if self.vocab.num_words() == 0:
            raise ValueError(
                "empty vocabulary — lower min_word_frequency or supply "
                "more data"
            )
        if self.conf.use_hierarchic_softmax:
            self.huffman = Huffman(self.vocab)
        self.lookup = InMemoryLookupTable(
            self.vocab, self.conf.layer_size, seed=self.conf.seed,
            use_hs=self.conf.use_hierarchic_softmax,
            negative=self.conf.negative, device=self.device,
        )
        return self

    # -- training ------------------------------------------------------------

    def _index_sentences(self, sequences) -> List[np.ndarray]:
        """Token sequences -> vocab-index arrays (unknown words dropped,
        exactly as the reference skips non-vocab elements)."""
        by_word = self.vocab._by_word
        out = []
        for seq in sequences:
            idx = [by_word[t].index for t in seq if t in by_word]
            out.append(np.asarray(idx, np.int64))
        return out

    def fit_file(self, path: str, lowercase: bool = False):
        """Train straight from a text file (newline = sentence) through
        the NATIVE corpus pipeline (native/corpus.cpp — the C++
        VocabConstructor/text-pipeline analog): tokenize, count, sort and
        index entirely outside Python, then stream the indexed sentences
        into the device step. Falls back to the Python tokenizer/vocab
        when no C++ toolchain is available."""
        from deeplearning4j_tpu_torch import native as native_mod

        if not native_mod.native_available():
            logger.warning("native corpus pipeline unavailable; "
                           "falling back to Python tokenization")
            import re

            # match corpus.cpp exactly: ASCII whitespace split and A-Z
            # lowercasing only — the same file must produce the same
            # vocab with or without a C++ toolchain
            ascii_lower = str.maketrans(
                "ABCDEFGHIJKLMNOPQRSTUVWXYZ",
                "abcdefghijklmnopqrstuvwxyz")
            split = re.compile("[ \t\r\n\x0b\x0c]+").split
            with open(path) as f:
                seqs = []
                for line in f:
                    if lowercase:
                        line = line.translate(ascii_lower)
                    seqs.append([t for t in split(line) if t])
            return self.fit(seqs)
        with native_mod.NativeCorpus(path, lowercase=lowercase) as corpus:
            self._vocab_from_native(corpus)  # huffman + lookup over it
            indexed = corpus.indexed_sentences(self.conf.min_word_frequency)
        self.train_indexed(indexed)
        return self

    def _vocab_from_native(self, corpus):
        """Adopt a NativeCorpus vocabulary and build the lookup table."""
        words, counts = corpus.vocab(self.conf.min_word_frequency)
        vocab = VocabCache()
        for w, c in zip(words, counts):
            vocab.add(w, int(c))
        self.vocab = vocab
        self.build_vocab()

    def fit(self, sequences: Optional[Iterable[Sequence[str]]] = None):
        """Build vocab (if needed) and train (reference:
        SequenceVectors.fit :187)."""
        seqs = sequences if sequences is not None else self._sequences
        if self.vocab is None or self.lookup is None:
            if self.vocab is None:
                self._sequences = list(seqs)
                seqs = self._sequences
            self.build_vocab()
        indexed = self._index_sentences(seqs)
        self.train_indexed(indexed)
        return self

    def train_indexed(self, indexed: List[np.ndarray]):
        conf = self.conf
        mode = conf.elements_learning_algorithm
        if mode not in ("skipgram", "cbow"):
            raise ValueError(
                f"unknown elements learning algorithm {mode!r} "
                "(skipgram | cbow)"
            )
        if (mode == "skipgram" and conf.negative > 0
                and not conf.use_hierarchic_softmax):
            # corpus-resident path: upload 4 bytes/word and generate the
            # pairs on the device (nlp/devicegen.py)
            return self._train_corpus_device(indexed)
        return self._train_batched(indexed)

    def _unigram_dev(self):
        """Device-resident negative-sampling table, uploaded ONCE per
        lookup table. Keyed on the lookup instance: build_vocab creates a
        fresh lookup, so a vocab rebuild invalidates the cache rather
        than sampling stale indices."""
        cached = getattr(self, "_unigram_dev_cache", None)
        if cached is None or cached[0] is not self.lookup:
            table = torch.from_numpy(self.lookup.unigram_table()).to(self.device)
            self._unigram_dev_cache = (self.lookup, table)
        return self._unigram_dev_cache[1]

    def _train_corpus_device(self, indexed: List[np.ndarray]):
        from deeplearning4j_tpu_torch.nlp.devicegen import (
            live_length,
            make_corpus_skipgram_step,
            pack_corpus,
        )

        conf = self.conf
        if self._corpus_step is None:
            self._corpus_step = make_corpus_skipgram_step(
                negative=conf.negative, window=conf.window,
                pairs_per_batch=conf.batch_size)
        step = self._corpus_step
        unigram_dev = self._unigram_dev()
        keep = keep_probabilities(self.vocab.counts(), conf.sampling)
        per_word = conf.window + 1  # E[pairs/word] under the dynamic window
        total_pairs = float(max(
            sum(int(s.size) for s in indexed) * conf.epochs
            * conf.iterations * per_word, 1))
        syn0 = self.lookup.syn0
        syn1neg = self.lookup.syn1neg
        seen = torch.zeros((), dtype=torch.float32, device=self.device)
        loss = None
        self.last_loss = float("nan")
        for epoch in range(conf.epochs):
            sents = [subsample(s, keep, self._rng) for s in indexed]
            flat = pack_corpus(sents, conf.window)
            corpus = to_device(flat, self.device).long()
            for _ in range(conf.iterations):
                syn0, syn1neg, loss, seen = step(
                    syn0, syn1neg, unigram_dev, corpus,
                    conf.learning_rate, conf.min_learning_rate, total_pairs, seen,
                    live=live_length(flat), generator=self._generator())
            if loss is not None:
                self.last_loss = float(loss)
            logger.info("epoch %d done, loss %.4f", epoch, self.last_loss)
        self.lookup.syn0 = syn0
        self.lookup.syn1neg = syn1neg
        return None

    def _train_batched(self, indexed: List[np.ndarray]):
        conf = self.conf
        mode = conf.elements_learning_algorithm
        plan = BatchPlan(
            batch_size=conf.batch_size,
            context_size=1 if mode == "skipgram" else 2 * conf.window,
            hs_arrays=self.huffman.arrays() if self.huffman else None,
            negative=conf.negative,
            device_negatives=conf.negative > 0,
            skip_h_mask=mode == "skipgram",
        )
        unigram_dev = self._unigram_dev() if conf.negative > 0 else None
        # one step per model
        if self._scan_step is None:
            self._scan_step = make_embedding_scan_step(
                use_hs=conf.use_hierarchic_softmax, negative=conf.negative,
                with_doc=False,
            )
        step = self._scan_step
        keep = keep_probabilities(self.vocab.counts(), conf.sampling)
        syn0 = self.lookup.syn0
        syn1 = (self.lookup.syn1 if self.lookup.syn1 is not None
                else _placeholder(conf, self.device))
        syn1neg = (self.lookup.syn1neg if self.lookup.syn1neg is not None
                   else _placeholder(conf, self.device))
        doc = _placeholder(conf, self.device)

        # LR decays linearly over expected EXAMPLES: skip-gram emits about
        # (window+1) pairs per word (dynamic window E[w]=(window+1)/2,
        # two sides), cbow one example per word
        per_word = (conf.window + 1) if mode == "skipgram" else 1
        total_examples = max(
            sum(int(s.size) for s in indexed) * conf.epochs
            * conf.iterations * per_word, 1,
        )
        seen = 0
        loss = None
        self.last_loss = float("nan")
        for epoch in range(conf.epochs):
            sents = [
                subsample(s, keep, self._rng) for s in indexed
            ]
            for _ in range(conf.iterations):
                for group, lrs, n_rows in group_batches(
                    generate_batches(
                        iter(sents), plan, window=conf.window, mode=mode,
                        rng=self._rng,
                    ),
                    plan, conf.scan_size,
                    lambda s: max(
                        conf.learning_rate * (1.0 - (seen + s) / total_examples),
                        conf.min_learning_rate,
                    ),
                ):
                    syn0, syn1, syn1neg, doc, loss = step(
                        syn0, syn1, syn1neg, doc, unigram_dev,
                        batch_to_device(group, self.device), lrs,
                        self._generator() if conf.negative > 0 else None,
                    )
                    seen += n_rows
            if loss is not None:
                self.last_loss = float(loss)
            logger.info("epoch %d done, loss %.4f", epoch, self.last_loss)
        self.lookup.syn0 = syn0
        if self.lookup.syn1 is not None:
            self.lookup.syn1 = syn1
        if self.lookup.syn1neg is not None:
            self.lookup.syn1neg = syn1neg

    # -- query API (reference: WordVectors interface) ------------------------

    def word_vector(self, word: str):
        return self.lookup.vector(word)

    def has_word(self, word: str) -> bool:
        return self.vocab is not None and self.vocab.contains_word(word)

    def similarity(self, a: str, b: str) -> float:
        return self.lookup.similarity(a, b)

    def words_nearest(self, word_or_vec, top_n: int = 10):
        return self.lookup.words_nearest(word_or_vec, top_n)

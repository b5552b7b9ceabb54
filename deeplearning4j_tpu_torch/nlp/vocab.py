"""Vocabulary construction + Huffman coding.

Analog of the reference's models/word2vec/wordstore/ (VocabCache,
AbstractCache, VocabConstructor — 612 LoC — and Huffman/HuffmanNode):
frequency-thresholded vocab built from a sequence stream, and the Huffman
tree that gives every word its hierarchical-softmax code (bit string) and
points (inner-node indices along the root path).
"""

from __future__ import annotations

import heapq
from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np


class VocabWord:
    __slots__ = ("word", "count", "index", "code", "points")

    def __init__(self, word: str, count: int = 0, index: int = -1):
        self.word = word
        self.count = count
        self.index = index
        self.code: Optional[List[int]] = None     # Huffman bits (0/1)
        self.points: Optional[List[int]] = None   # inner-node indices

    def __repr__(self):
        return f"VocabWord({self.word!r}, count={self.count}, index={self.index})"


class VocabCache:
    """Word <-> index store with counts (reference: VocabCache SPI +
    AbstractCache impl)."""

    def __init__(self):
        self._words: List[VocabWord] = []
        self._by_word: Dict[str, VocabWord] = {}
        self.total_word_count = 0

    def add(self, word: str, count: int = 1):
        vw = self._by_word.get(word)
        if vw is None:
            vw = VocabWord(word, 0, len(self._words))
            self._words.append(vw)
            self._by_word[word] = vw
        vw.count += count
        self.total_word_count += count
        return vw

    def contains_word(self, word: str) -> bool:
        return word in self._by_word

    def word_for(self, word: str) -> Optional[VocabWord]:
        return self._by_word.get(word)

    def index_of(self, word: str) -> int:
        vw = self._by_word.get(word)
        return -1 if vw is None else vw.index

    def word_at_index(self, index: int) -> str:
        return self._words[index].word

    def word_frequency(self, word: str) -> int:
        vw = self._by_word.get(word)
        return 0 if vw is None else vw.count

    def num_words(self) -> int:
        return len(self._words)

    def words(self) -> List[str]:
        return [w.word for w in self._words]

    def vocab_words(self) -> List[VocabWord]:
        return list(self._words)

    def counts(self) -> np.ndarray:
        return np.asarray([w.count for w in self._words], np.int64)


class VocabConstructor:
    """Build a frequency-filtered vocab from token sequences (reference:
    models/word2vec/wordstore/VocabConstructor.java — parallel counting +
    min-frequency truncation; counting here is a single pass, the
    parallelism the reference needs for JVM-speed counting is unnecessary)."""

    def __init__(self, min_word_frequency: int = 1, limit: Optional[int] = None):
        self.min_word_frequency = int(min_word_frequency)
        self.limit = limit

    def build(self, sequences: Iterable[Sequence[str]]) -> VocabCache:
        counts: Dict[str, int] = {}
        for seq in sequences:
            for tok in seq:
                counts[tok] = counts.get(tok, 0) + 1
        # deterministic ordering: by descending count then word — gives
        # stable indices (the reference sorts by frequency for the Huffman
        # build and index assignment)
        items = sorted(counts.items(), key=lambda kv: (-kv[1], kv[0]))
        if self.limit is not None:
            items = items[: self.limit]
        vocab = VocabCache()
        for word, c in items:
            if c >= self.min_word_frequency:
                vocab.add(word, c)
        return vocab


class Huffman:
    """Huffman-code a vocab for hierarchical softmax (reference:
    models/word2vec/Huffman.java): assigns each VocabWord its `code`
    (bits, root->leaf) and `points` (inner-node ids along the path). Inner
    nodes are numbered 0..V-2 and index rows of syn1."""

    MAX_CODE_LENGTH = 40

    def __init__(self, vocab: VocabCache):
        self.vocab = vocab
        self._build()

    def _build(self):
        words = self.vocab.vocab_words()
        V = len(words)
        if V == 0:
            self.max_code_length = 0
            return
        # heap of (count, tie, node_id); leaves are 0..V-1, inner V..2V-2
        heap = [(w.count, i, i) for i, w in enumerate(words)]
        heapq.heapify(heap)
        parent = np.zeros(2 * V - 1, np.int64)
        binary = np.zeros(2 * V - 1, np.int8)
        next_id = V
        tie = V
        while len(heap) > 1:
            c1, _, n1 = heapq.heappop(heap)
            c2, _, n2 = heapq.heappop(heap)
            parent[n1] = next_id
            parent[n2] = next_id
            binary[n2] = 1
            heapq.heappush(heap, (c1 + c2, tie, next_id))
            next_id += 1
            tie += 1
        root = heap[0][2]
        max_len = 0
        for i, w in enumerate(words):
            if V == 1:
                # degenerate single-word vocab: no inner nodes
                w.code, w.points = [], []
                continue
            # chain: leaf -> ... -> root
            chain = [i]
            while chain[-1] != root:
                chain.append(int(parent[chain[-1]]))
            # every node except the root carries the bit that selects it
            # from its parent; root->leaf order is the stored code
            code = [int(binary[n]) for n in chain[:-1]][::-1]
            # the inner nodes visited root->down (excluding the leaf) are
            # the syn1 rows scored at each bit; inner node k maps to row
            # k - V (word2vec.c point[] convention)
            points = [n - V for n in chain[1:][::-1]]
            w.code = code[: self.MAX_CODE_LENGTH]
            w.points = points[: len(w.code)]
            max_len = max(max_len, len(w.code))
        self.max_code_length = max_len

    def arrays(self):
        """(codes [V, L], points [V, L], lengths [V]) padded to the max
        code length — the static-shape form the batched HS step consumes."""
        words = self.vocab.vocab_words()
        V = len(words)
        L = max(1, self.max_code_length)
        codes = np.zeros((V, L), np.int8)
        points = np.zeros((V, L), np.int64)
        lengths = np.zeros((V,), np.int32)
        for i, w in enumerate(words):
            n = len(w.code)
            codes[i, :n] = w.code
            points[i, :n] = w.points
            lengths[i] = n
        return codes, points, lengths

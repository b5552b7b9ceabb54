"""Word2Vec facade.

Analog of the reference's models/word2vec/Word2Vec.java:32 (extends
SequenceVectors) + Word2Vec.Builder: tokenize a sentence stream with a
TokenizerFactory and train word embeddings. Defaults follow the
reference: hierarchical softmax on, negative sampling off, skip-gram.
The model's tables live on `device` (None: "cuda").
"""

from __future__ import annotations

from typing import Iterable, Optional

from deeplearning4j_tpu_torch.nlp.sequencevectors import (
    SequenceVectors,
    VectorsConfiguration,
)
from deeplearning4j_tpu_torch.nlp.tokenization import (
    DefaultTokenizerFactory,
    TokenizerFactory,
)


class Word2Vec(SequenceVectors):
    def __init__(self, conf: VectorsConfiguration,
                 sentences: Optional[Iterable[str]] = None,
                 tokenizer: Optional[TokenizerFactory] = None, *, device=None):
        self.tokenizer = tokenizer or DefaultTokenizerFactory()
        seqs = None
        if sentences is not None:
            seqs = [self.tokenizer.create(s).get_tokens() for s in sentences]
        super().__init__(conf, seqs, device=device)

    class Builder:
        """Fluent builder (reference: Word2Vec.Builder)."""

        def __init__(self):
            self._conf = VectorsConfiguration()
            self._sentences = None
            self._tokenizer = None
            self._device = None

        def min_word_frequency(self, n: int):
            self._conf.min_word_frequency = int(n)
            return self

        def layer_size(self, n: int):
            self._conf.layer_size = int(n)
            return self

        def window_size(self, n: int):
            self._conf.window = int(n)
            return self

        def iterations(self, n: int):
            self._conf.iterations = int(n)
            return self

        def epochs(self, n: int):
            self._conf.epochs = int(n)
            return self

        def learning_rate(self, lr: float):
            self._conf.learning_rate = float(lr)
            return self

        def min_learning_rate(self, lr: float):
            self._conf.min_learning_rate = float(lr)
            return self

        def negative_sample(self, k: int):
            self._conf.negative = int(k)
            return self

        def use_hierarchic_softmax(self, flag: bool):
            self._conf.use_hierarchic_softmax = bool(flag)
            return self

        def sampling(self, t: float):
            self._conf.sampling = float(t)
            return self

        def batch_size(self, n: int):
            self._conf.batch_size = int(n)
            return self

        def seed(self, s: int):
            self._conf.seed = int(s)
            return self

        def elements_learning_algorithm(self, name: str):
            self._conf.elements_learning_algorithm = name
            return self

        def iterate(self, sentences: Iterable[str]):
            self._sentences = sentences
            return self

        def tokenizer_factory(self, tf: TokenizerFactory):
            self._tokenizer = tf
            return self

        def device(self, device):
            """Where the tables live: "cuda" (the default) or "cpu"."""
            self._device = device
            return self

        def build(self) -> "Word2Vec":
            return Word2Vec(self._conf, self._sentences, self._tokenizer,
                            device=self._device)

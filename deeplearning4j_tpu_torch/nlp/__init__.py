"""NLP / embeddings stack.

Analog of the reference's deeplearning4j-nlp-parent (~46k LoC, SURVEY.md
§2.7): a generic SequenceVectors trainer over sequence elements with
pluggable learning algorithms (SkipGram, CBOW, DM, DBOW), Word2Vec /
ParagraphVectors facades, vocab construction + Huffman coding for
hierarchical softmax, tokenization SPI, and WordVectorSerializer interop.

The port's copy: the same modules, classes and public methods as the
JAX package's nlp/, with the tables as tensors on the model's device
(`device=None` means "cuda"; the CPU only when asked). The reference
batches skip-gram updates into native AggregateSkipGram ops executed by
libnd4j (models/embeddings/learning/impl/elements/SkipGram.java:271);
here the same batching feeds a device step that gathers embedding rows,
computes the sigmoid losses for hierarchical-softmax nodes and/or
negative samples, and scatter-adds the updates in place (nlp/learning.py).
No hand-written kernel: the JAX package computes this path with XLA ops,
and PyTorch ops port them.
"""

from deeplearning4j_tpu_torch.nlp.tokenization import (
    CJKTokenizerFactory,
    CommonPreprocessor,
    DefaultTokenizerFactory,
    NGramTokenizerFactory,
    TokenizerFactory,
)
from deeplearning4j_tpu_torch.nlp.vocab import Huffman, VocabCache, VocabConstructor
from deeplearning4j_tpu_torch.nlp.lookup import InMemoryLookupTable
from deeplearning4j_tpu_torch.nlp.sequencevectors import (
    SequenceVectors,
    VectorsConfiguration,
)
from deeplearning4j_tpu_torch.nlp.word2vec import Word2Vec
from deeplearning4j_tpu_torch.nlp.paragraphvectors import ParagraphVectors
from deeplearning4j_tpu_torch.nlp.glove import Glove
from deeplearning4j_tpu_torch.nlp.serializer import WordVectorSerializer
from deeplearning4j_tpu_torch.nlp.vectorizers import (
    BagOfWordsVectorizer,
    LabelsSource,
    TfidfVectorizer,
)

__all__ = [
    "BagOfWordsVectorizer",
    "CJKTokenizerFactory",
    "Glove",
    "LabelsSource",
    "TfidfVectorizer",
    "CommonPreprocessor",
    "DefaultTokenizerFactory",
    "NGramTokenizerFactory",
    "TokenizerFactory",
    "Huffman",
    "VocabCache",
    "VocabConstructor",
    "InMemoryLookupTable",
    "SequenceVectors",
    "VectorsConfiguration",
    "Word2Vec",
    "ParagraphVectors",
    "WordVectorSerializer",
]

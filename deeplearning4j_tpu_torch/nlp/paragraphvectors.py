"""ParagraphVectors (doc2vec).

Analog of the reference's models/paragraphvectors/ParagraphVectors.java
with the sequence learning algorithms DM (distributed memory: window mean
+ doc vector predicts the center word) and DBOW (doc vector alone
predicts each word) from models/embeddings/learning/impl/sequence/.

Doc vectors live in their own table on the model's device; infer_vector
trains a FRESH doc row with the word tables frozen (reference:
ParagraphVectors.inferVector). Negatives are drawn on the host (numpy),
so the same seed gives the same batches as the JAX package.
"""

from __future__ import annotations

from typing import Iterable, Optional, Sequence

import numpy as np

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
    make_embedding_step,
)
from deeplearning4j_tpu_torch.nlp.lookup import as_table, uniform_init
from deeplearning4j_tpu_torch.nlp.sequencevectors import (
    SequenceVectors,
    VectorsConfiguration,
    _placeholder,
)
from deeplearning4j_tpu_torch.nlp.tokenization import (
    DefaultTokenizerFactory,
    TokenizerFactory,
)


class ParagraphVectors(SequenceVectors):
    def __init__(self, conf: VectorsConfiguration,
                 documents: Iterable[str], labels: Sequence[str],
                 tokenizer: Optional[TokenizerFactory] = None,
                 sequence_learning_algorithm: str = "dm", *, device=None):
        self.tokenizer = tokenizer or DefaultTokenizerFactory()
        seqs = [self.tokenizer.create(d).get_tokens() for d in documents]
        super().__init__(conf, seqs, device=device)
        self.labels = list(labels)
        if len(self.labels) != len(seqs):
            raise ValueError("labels must align with documents")
        self.sequence_algo = sequence_learning_algorithm
        if self.sequence_algo not in ("dm", "dbow"):
            raise ValueError("sequence_learning_algorithm must be dm|dbow")
        self._label_index = {l: i for i, l in enumerate(self.labels)}
        if len(self._label_index) != len(self.labels):
            raise ValueError("duplicate document labels")
        self.doc_vectors = None  # [num_docs, D] on the device
        self._carried = False

    def set_doc_vectors(self, doc_vectors) -> "ParagraphVectors":
        """Carry tables in (e.g. the JAX package's, from numpy): the next
        fit() starts from these doc vectors and from the lookup table as
        it stands (set `self.lookup`, e.g. InMemoryLookupTable.from_numpy
        after build_vocab()), instead of initialising both afresh."""
        if self.lookup is None:
            self.build_vocab()
        self.doc_vectors = as_table(doc_vectors, self.device)
        self._carried = True
        return self

    def fit(self, sequences=None):
        conf = self.conf
        if self._carried:
            self._carried = False  # one fit starts from carried tables
        else:
            self.build_vocab()
            self.doc_vectors = uniform_init(conf.seed ^ 0xD0C, len(self.labels),
                                            conf.layer_size, self.device)
        indexed = self._index_sentences(self._sequences)

        plan = BatchPlan(
            batch_size=conf.batch_size,
            context_size=1 if self.sequence_algo == "dbow" else 2 * conf.window,
            hs_arrays=self.huffman.arrays() if self.huffman else None,
            negative=conf.negative,
            unigram=(
                self.lookup.unigram_table() if conf.negative > 0 else None
            ),
            with_doc=True,
        )
        step = make_embedding_scan_step(
            use_hs=conf.use_hierarchic_softmax, negative=conf.negative,
            with_doc=True,
        )
        keep = keep_probabilities(self.vocab.counts(), conf.sampling)
        syn0 = self.lookup.syn0
        syn1 = (self.lookup.syn1 if self.lookup.syn1 is not None
                else _placeholder(conf, self.device))
        syn1neg = (self.lookup.syn1neg if self.lookup.syn1neg is not None
                   else _placeholder(conf, self.device))
        doc = self.doc_vectors

        # dm/dbow emit ~one example per word position
        total_examples = max(
            sum(int(s.size) for s in indexed) * conf.epochs * conf.iterations,
            1,
        )
        seen = 0
        for _ in range(conf.epochs):
            sents = [subsample(s, keep, self._rng) for s in indexed]
            for _ in range(conf.iterations):
                for group, lrs, n_rows in group_batches(
                    generate_batches(
                        iter(sents), plan, window=conf.window,
                        mode=self.sequence_algo, rng=self._rng,
                        doc_ids=range(len(sents)),
                    ),
                    plan, conf.scan_size,
                    lambda s: max(
                        conf.learning_rate * (1.0 - (seen + s) / total_examples),
                        conf.min_learning_rate,
                    ),
                ):
                    # negatives are in the batch (host draws): the unigram
                    # table is not needed on the device
                    syn0, syn1, syn1neg, doc, loss = step(
                        syn0, syn1, syn1neg, doc, None,
                        batch_to_device(group, self.device), lrs,
                    )
                    seen += n_rows
        self.lookup.syn0 = syn0
        if self.lookup.syn1 is not None:
            self.lookup.syn1 = syn1
        if self.lookup.syn1neg is not None:
            self.lookup.syn1neg = syn1neg
        self.doc_vectors = doc
        return self

    # -- doc vector access ---------------------------------------------------

    def doc_vector(self, label: str) -> np.ndarray:
        return self.doc_vectors[self._label_index[label]].cpu().numpy()

    def similarity_to_label(self, text: str, label: str) -> float:
        v = self.infer_vector(text)
        d = self.doc_vector(label)
        denom = np.linalg.norm(v) * np.linalg.norm(d)
        return float(v @ d / denom) if denom else 0.0

    def nearest_labels(self, text_or_vec, top_n: int = 5):
        v = (
            self.infer_vector(text_or_vec)
            if isinstance(text_or_vec, str) else np.asarray(text_or_vec)
        )
        table = self.doc_vectors.cpu().numpy()
        sims = (table @ v) / np.maximum(
            np.linalg.norm(table, axis=1) * (np.linalg.norm(v) + 1e-12), 1e-12
        )
        order = np.argsort(-sims)[:top_n]
        return [(self.labels[i], float(sims[i])) for i in order]

    def infer_vector(self, text: str, steps: int = 5,
                     learning_rate: Optional[float] = None) -> np.ndarray:
        """Train a fresh doc vector against FROZEN word tables
        (reference: ParagraphVectors.inferVector). The start vector and
        the window draws come from numpy seeded by hash(text), as in the
        JAX package; Python salts str hashes per process, so two
        processes infer different vectors for the same text."""
        conf = self.conf
        lr0 = learning_rate if learning_rate is not None else conf.learning_rate
        tokens = self.tokenizer.create(text).get_tokens()
        sent = self._index_sentences([tokens])[0]
        D = conf.layer_size
        rng = np.random.default_rng(abs(hash(text)) % (2**31))
        start = (rng.random((1, D), np.float32) - 0.5) / D
        if sent.size == 0:
            return start[0]
        vec = as_table(start, self.device)
        plan = BatchPlan(
            batch_size=max(int(sent.size), 1),
            context_size=1 if self.sequence_algo == "dbow" else 2 * conf.window,
            hs_arrays=self.huffman.arrays() if self.huffman else None,
            negative=conf.negative,
            unigram=(
                self.lookup.unigram_table() if conf.negative > 0 else None
            ),
            with_doc=True,
        )
        if getattr(self, "_infer_step", None) is None:
            self._infer_step = make_embedding_step(
                use_hs=conf.use_hierarchic_softmax, negative=conf.negative,
                with_doc=True, train_words=False,
            )
        step = self._infer_step
        syn1 = (self.lookup.syn1 if self.lookup.syn1 is not None
                else _placeholder(conf, self.device))
        syn1neg = (self.lookup.syn1neg if self.lookup.syn1neg is not None
                   else _placeholder(conf, self.device))
        for it in range(steps):
            lr = lr0 * (1.0 - it / steps)
            for batch in generate_batches(
                iter([sent]), plan, window=conf.window,
                mode=self.sequence_algo, rng=rng, doc_ids=iter([0]),
            ):
                step(self.lookup.syn0, syn1, syn1neg, vec,
                     batch_to_device(batch, self.device), lr)
        return vec[0].cpu().numpy()

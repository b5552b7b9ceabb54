"""The port's host side of the embeddings stack against the JAX package's,
exactly: tokenizers (default, n-gram, CJK, the Japanese lattice), vocab
construction, Huffman codes and `arrays()`, batches from the same
np.random.Generator, groups, the unigram table, GloVe co-occurrences
(the Python pass and the native corpus pipeline), the vectorizers, and
random and node2vec walks from the same seed. Equality, no tolerance:
this code is numpy and Python in both packages."""

import os
import sys

import numpy as np
import pytest

from deeplearning4j_tpu import native as jnative
from deeplearning4j_tpu.graph import walkers as jwalk
from deeplearning4j_tpu.graph.graph import Graph as JGraph
from deeplearning4j_tpu.nlp import batching as jb
from deeplearning4j_tpu.nlp import glove as jglove
from deeplearning4j_tpu.nlp import japanese as jjp
from deeplearning4j_tpu.nlp import lookup as jlookup
from deeplearning4j_tpu.nlp import tokenization as jtok
from deeplearning4j_tpu.nlp import vectorizers as jvec
from deeplearning4j_tpu.nlp import vocab as jvocab
from deeplearning4j_tpu_torch import native as tnative
from deeplearning4j_tpu_torch.graph import walkers as twalk
from deeplearning4j_tpu_torch.graph.graph import Graph as TGraph
from deeplearning4j_tpu_torch.nlp import batching as tb
from deeplearning4j_tpu_torch.nlp import glove as tglove
from deeplearning4j_tpu_torch.nlp import japanese as tjp
from deeplearning4j_tpu_torch.nlp import lookup as tlookup
from deeplearning4j_tpu_torch.nlp import tokenization as ttok
from deeplearning4j_tpu_torch.nlp import vectorizers as tvec
from deeplearning4j_tpu_torch.nlp import vocab as tvocab

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from torch_parity import one_torch_thread  # noqa: E402,F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


TEXTS = [
    "Hello, World! 123 the quick (brown) fox's tail",
    "東京都に住むGPUユーザー 서울특별시 abc_1 DEF",
    "私は東京に行きます。猫が水を飲んだ、量子力学の本は難しい",
    "カタカナとAlphabetと漢字 ぬるぽが好き 東京大学の学生",
    "",
]


def _zipf_corpus(seed, n=60, vocab=30, length=(3, 12)):
    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, vocab + 1)
    p /= p.sum()
    return [[f"w{i}" for i in rng.choice(vocab, size=rng.integers(*length), p=p)]
            for _ in range(n)]


FACTORIES = {
    "default": lambda m: m.DefaultTokenizerFactory(),
    "default+pre": lambda m: m.DefaultTokenizerFactory().set_token_pre_processor(
        m.CommonPreprocessor()),
    "ngram": lambda m: m.NGramTokenizerFactory(1, 3),
    "cjk": lambda m: m.CJKTokenizerFactory(),
    "cjk-runs": lambda m: m.CJKTokenizerFactory(bigrams=False),
    "japanese": lambda m: (jjp if m is jtok else tjp).JapaneseTokenizerFactory(
        lexicon={"量子力学": 3.0}),
}


@pytest.mark.parametrize("factory", list(FACTORIES))
def test_tokenizers_are_exact(factory):
    jf, tf = FACTORIES[factory](jtok), FACTORIES[factory](ttok)
    for text in TEXTS:
        assert tf.create(text).get_tokens() == jf.create(text).get_tokens(), text
    assert tjp.segment(TEXTS[2]) == jjp.segment(TEXTS[2])


def test_sentence_iterators_are_exact():
    sents, labels = ["a b", "c d"], ["x", "y"]
    assert list(ttok.SentenceIterator(sents)) == list(jtok.SentenceIterator(sents))
    t = ttok.LabelAwareSentenceIterator(sents, labels)
    assert list(t.labeled()) == list(jtok.LabelAwareSentenceIterator(sents, labels).labeled())
    with pytest.raises(ValueError):
        ttok.LabelAwareSentenceIterator(sents, ["x"])


def _vocabs(min_freq, seed=0, limit=None):
    seqs = _zipf_corpus(seed)
    return (jvocab.VocabConstructor(min_freq, limit).build(seqs),
            tvocab.VocabConstructor(min_freq, limit).build(seqs))


@pytest.mark.parametrize("min_freq,limit", [(1, None), (3, None), (1, 12)])
def test_vocab_and_huffman_are_exact(min_freq, limit):
    jv, tv = _vocabs(min_freq, limit=limit)
    assert tv.words() == jv.words()
    assert np.array_equal(tv.counts(), jv.counts())
    assert tv.total_word_count == jv.total_word_count
    jh, th = jvocab.Huffman(jv), tvocab.Huffman(tv)
    assert th.max_code_length == jh.max_code_length
    for a, b in zip(th.arrays(), jh.arrays()):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert [w.code for w in tv.vocab_words()] == [w.code for w in jv.vocab_words()]
    assert [w.points for w in tv.vocab_words()] == [w.points for w in jv.vocab_words()]


@pytest.mark.parametrize("table_size,power", [(10_000, 0.75), (1_000_000, 0.75), (5_000, 1.0)])
def test_unigram_table_is_exact(table_size, power):
    jv, tv = _vocabs(1)
    jt = jlookup.InMemoryLookupTable(jv, 4, negative=1)
    tt = tlookup.InMemoryLookupTable(tv, 4, negative=1, device="cpu")
    assert np.array_equal(tt.unigram_table(table_size, power),
                          jt.unigram_table(table_size, power))


def _plan(m, mode, hs, negative, with_doc, unigram, device_negatives=False):
    return m.BatchPlan(batch_size=32,
                       context_size=1 if mode in ("skipgram", "dbow") else 6,
                       hs_arrays=hs, negative=negative, unigram=unigram,
                       with_doc=with_doc, device_negatives=device_negatives,
                       skip_h_mask=mode == "skipgram")


BATCH_CASES = [("skipgram", True, 0), ("skipgram", False, 3), ("cbow", True, 2),
               ("dm", True, 0), ("dm", False, 4), ("dbow", True, 2)]


@pytest.mark.parametrize("mode,hs,negative", BATCH_CASES,
                         ids=[f"{m}-{'hs' if h else 'nohs'}-neg{n}" for m, h, n in BATCH_CASES])
def test_batches_and_groups_are_exact(mode, hs, negative):
    """The same generator gives the same batches, subsampling and groups,
    bit for bit (host negatives included)."""
    jv, tv = _vocabs(1, seed=1)
    seqs = _zipf_corpus(1)
    by = {w: i for i, w in enumerate(tv.words())}
    indexed = [np.asarray([by[w] for w in s], np.int64) for s in seqs]
    hs_arrays = tvocab.Huffman(tv).arrays() if hs else None
    unigram = tlookup.InMemoryLookupTable(tv, 4, negative=1, device="cpu").unigram_table(1000)
    with_doc = mode in ("dm", "dbow")
    out = {}
    for name, m in (("jax", jb), ("port", tb)):
        rng = np.random.default_rng(5)
        keep = m.keep_probabilities(tv.counts(), 0.05)
        sents = [m.subsample(s, keep, rng) for s in indexed]
        plan = _plan(m, mode, hs_arrays, negative, with_doc, unigram)
        batches = list(m.generate_batches(iter(sents), plan, window=3, mode=mode, rng=rng,
                                          doc_ids=range(len(sents)) if with_doc else None))
        groups = list(m.group_batches(iter(batches), plan, 3, lambda s: 0.025 - s * 1e-5))
        out[name] = (sents, batches, groups)
    (js, jbat, jgrp), (ts, tbat, tgrp) = out["jax"], out["port"]
    assert all(np.array_equal(a, b) for a, b in zip(ts, js))
    assert len(tbat) == len(jbat) > 2
    for a, b in zip(tbat, jbat):
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
    assert len(tgrp) == len(jgrp)
    for (ga, la, na), (gb, lb, nb) in zip(tgrp, jgrp):
        assert na == nb and np.array_equal(la, np.asarray(lb))
        assert isinstance(la, np.ndarray) and la.dtype == np.float32
        for k in ga:
            assert isinstance(ga[k], np.ndarray) and np.array_equal(ga[k], np.asarray(gb[k])), k


@pytest.mark.parametrize("window,symmetric", [(2, True), (4, True), (3, False)])
def test_python_cooccurrences_are_exact(window, symmetric):
    indexed = [np.random.default_rng(s).integers(0, 20, 15) for s in range(12)]
    got = tglove.cooccurrences_indexed(indexed, window, symmetric)
    want = jglove.cooccurrences_indexed(indexed, window, symmetric)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.fixture
def corpus_file(tmp_path):
    path = tmp_path / "corpus.txt"
    lines = [" ".join(s) for s in _zipf_corpus(2, n=80)]
    lines[3] = lines[3].upper()
    path.write_text("\n".join(lines) + "\n\n")
    return str(path)


@pytest.mark.parametrize("lowercase", [False, True])
def test_native_corpus_is_exact(corpus_file, lowercase):
    """The port's own corpus.cpp build against the JAX package's: vocab,
    indexed sentences and co-occurrences."""
    if not (tnative.native_available() and jnative.native_available()):
        pytest.skip("no C++ toolchain")
    with tnative.NativeCorpus(corpus_file, lowercase) as t, \
            jnative.NativeCorpus(corpus_file, lowercase) as j:
        assert (t.total_tokens, t.num_sentences) == (j.total_tokens, j.num_sentences)
        for mc in (1, 3):
            tw, tc = t.vocab(mc)
            jw, jc = j.vocab(mc)
            assert tw == jw and np.array_equal(tc, jc)
            ts, js = t.indexed_sentences(mc), j.indexed_sentences(mc)
            assert len(ts) == len(js) and all(np.array_equal(a, b) for a, b in zip(ts, js))
            for a, b in zip(t.cooccurrences(mc, 3, True), j.cooccurrences(mc, 3, True)):
                assert a.dtype == b.dtype and np.array_equal(a, b)


def test_native_library_is_built_from_the_ports_own_source():
    if not tnative.native_available():
        pytest.skip("no C++ toolchain")
    path = tnative._lib_path()
    assert path.startswith(tnative.BUILD_DIR) and "deeplearning4j_tpu_torch" in path
    assert tnative._SRC.startswith(tnative._HERE)


DOCS = ["the cat sat on the mat", "the dog sat on the log",
        "cats and dogs and cats", "a cat and a dog"]


@pytest.mark.parametrize("cls", ["BagOfWordsVectorizer", "TfidfVectorizer"])
@pytest.mark.parametrize("min_freq", [1, 2])
def test_vectorizers_are_exact(cls, min_freq):
    j = getattr(jvec, cls)(min_word_frequency=min_freq, stop_words=["on"]).fit(
        DOCS, labels=["pets", "other"])
    t = getattr(tvec, cls)(min_word_frequency=min_freq, stop_words=["on"]).fit(
        DOCS, labels=["pets", "other"])
    assert t.vocab.words() == j.vocab.words()
    assert np.array_equal(t.doc_frequencies, j.doc_frequencies)
    for text in DOCS + ["cat cat dog zebra", ""]:
        assert np.array_equal(t.transform(text), j.transform(text))
    tds, jds = t.vectorize("the cat sat", "pets"), j.vectorize("the cat sat", "pets")
    assert type(tds).__module__.startswith("deeplearning4j_tpu_torch")
    assert np.array_equal(tds.features, jds.features)
    assert np.array_equal(tds.labels, jds.labels)
    assert np.array_equal(t.fit_transform(DOCS), j.fit_transform(DOCS))


def _barbell(G, directed=False, weighted=False):
    g = G(12, directed=directed)
    for base in (0, 6):
        for i in range(6):
            for j in range(i + 1, 6):
                g.add_edge(base + i, base + j, 1.0 + (i * j) % 3 if weighted else 1.0)
    g.add_edge(5, 6)
    return g


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("walker", ["random", "node2vec"])
def test_walks_are_exact(walker, weighted):
    def walks(m, G):
        g = _barbell(G, weighted=weighted)
        if walker == "random":
            it = m.RandomWalkIterator(g, 15, weighted=weighted, seed=4)
        else:
            it = m.Node2VecWalkIterator(g, 15, p=0.5, q=2.0, weighted=weighted, seed=4)
        return [list(w) for w in it] + [list(it.walk_from(0))]

    assert walks(twalk, TGraph) == walks(jwalk, JGraph)


@pytest.mark.parametrize("policy", ["self_loop", "cutoff"])
def test_dead_end_walks_are_exact(policy):
    def walk(m, G):
        g = G(3, directed=True)
        g.add_edge(0, 1)
        g.add_edge(1, 2)
        return m.RandomWalkIterator(g, 5, seed=0, no_edge_handling=policy).walk_from(0)

    assert walk(twalk, TGraph) == walk(jwalk, JGraph)

"""The port's embeddings slice as a whole (deeplearning4j_tpu_torch/nlp/,
graph/, native/) on the CPU.

Parity with the JAX package, each fit from the JAX package's initial
tables carried across (InMemoryLookupTable.from_numpy,
ParagraphVectors.set_doc_vectors, Glove.set_state): Word2Vec skip-gram
and CBOW with hierarchical softmax, ParagraphVectors DM and DBOW with HS
and with host negatives plus infer_vector, GloVe's train_cooccurrences
over 2 epochs, and the serializer's three formats read across packages
both ways. Tolerance: a whole fit of at most 20 device calls (JAX
groups), rtol 1e-4 / atol 1e-6; losses rtol 1e-5; serialized tables
exactly (the text format to its 6 decimals).

Then the behaviour tests of the JAX package's test_word2vec.py,
test_nlp_vocab.py, test_glove.py, test_devicegen.py, test_japanese.py,
test_graph_deepwalk.py, test_native_corpus.py and the non-LFW cases of
test_vectorizers_node2vec.py, run on the port; the init's statistics;
and the device default: every entry point raises without a GPU unless
it is given device="cpu".
"""

import math
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu import nlp as jnlp
from deeplearning4j_tpu.nlp import glove as jglove
from deeplearning4j_tpu_torch import native as tnative
from deeplearning4j_tpu_torch import nlp as tnlp
from deeplearning4j_tpu_torch.graph import DeepWalk, Graph, Node2Vec, RandomWalkIterator
from deeplearning4j_tpu_torch.graph.walkers import NoEdgeHandling, Node2VecWalkIterator
from deeplearning4j_tpu_torch.nlp import (
    BagOfWordsVectorizer,
    CJKTokenizerFactory,
    CommonPreprocessor,
    DefaultTokenizerFactory,
    Glove,
    Huffman,
    InMemoryLookupTable,
    LabelsSource,
    NGramTokenizerFactory,
    ParagraphVectors,
    SequenceVectors,
    TfidfVectorizer,
    VectorsConfiguration,
    VocabConstructor,
    Word2Vec,
    WordVectorSerializer,
)
from deeplearning4j_tpu_torch.nlp import learning as tlearning
from deeplearning4j_tpu_torch.nlp.devicegen import SENTINEL, corpus_pairs_debug, pack_corpus
from deeplearning4j_tpu_torch.nlp.glove import cooccurrences_indexed
from deeplearning4j_tpu_torch.nlp.japanese import JapaneseTokenizerFactory, segment

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from torch_parity import one_torch_thread  # noqa: E402,F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

FIT_TOL = dict(rtol=1e-4, atol=1e-6)
LOSS_RTOL = 1e-5
MAX_DEVICE_CALLS = 20

ANIMALS = ["cat", "dog", "horse", "cow", "sheep"]
TECH = ["cpu", "gpu", "ram", "disk", "cache"]



def _corpus(n=400, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        group = ANIMALS if rng.random() < 0.5 else TECH
        out.append(" ".join(rng.choice(group, size=8)))
    return out


def _host(t):
    return t.cpu().numpy() if torch.is_tensor(t) else np.asarray(t)


def _close(got, want, tol=FIT_TOL, what=""):
    np.testing.assert_allclose(_host(got), _host(want), err_msg=what, **tol)


def _counted(step, calls):
    def run(*a, **k):
        calls.append(1)
        return step(*a, **k)
    return run


# -- whole fits against the JAX package ---------------------------------------

W2V_CASES = {"skipgram-hs": ("skipgram", 0.0), "cbow-hs": ("cbow", 1e-2)}


@pytest.mark.parametrize("case", list(W2V_CASES))
def test_word2vec_fit_matches_jax_from_carried_tables(case):
    mode, sampling = W2V_CASES[case]
    kw = dict(layer_size=16, window=3, min_word_frequency=1, epochs=3,
              learning_rate=0.05, batch_size=256, scan_size=4, seed=7,
              elements_learning_algorithm=mode, sampling=sampling,
              use_hierarchic_softmax=True, negative=0)
    corpus = _corpus(60)
    jw = jnlp.Word2Vec(jnlp.VectorsConfiguration(**kw), corpus)
    jw.build_vocab()
    tw = Word2Vec(VectorsConfiguration(**kw), corpus, device="cpu")
    tw.build_vocab()
    assert tw.vocab.words() == jw.vocab.words()
    tw.lookup = InMemoryLookupTable.from_numpy(
        tw.vocab, np.asarray(jw.lookup.syn0), np.asarray(jw.lookup.syn1), device="cpu")
    calls = []
    tw._scan_step = _counted(tlearning.make_embedding_scan_step(
        use_hs=True, negative=0, with_doc=False), calls)
    jw.fit()
    tw.fit()
    assert 3 <= len(calls) <= MAX_DEVICE_CALLS
    _close(tw.lookup.syn0, jw.lookup.syn0, what="syn0")
    _close(tw.lookup.syn1, jw.lookup.syn1, what="syn1")
    np.testing.assert_allclose(tw.last_loss, jw.last_loss, rtol=LOSS_RTOL)
    assert [w for w, _ in tw.words_nearest("cat", 4)] == \
        [w for w, _ in jw.words_nearest("cat", 4)]


def _docs(seed=3):
    rng = np.random.default_rng(seed)
    docs = [" ".join(rng.choice(ANIMALS, 10)) for _ in range(20)] + [
        " ".join(rng.choice(TECH, 10)) for _ in range(20)
    ]
    return docs, [f"doc_{i}" for i in range(40)]


def _jax_pv_start(jpv, kw):
    """The tables the JAX package's ParagraphVectors.fit starts from:
    its lookup as build_vocab makes it, and its doc init key."""
    jpv.build_vocab()
    D = kw["layer_size"]
    doc = (jax.random.uniform(jax.random.PRNGKey(kw["seed"] ^ 0xD0C), (40, D),
                              jnp.float32) - 0.5) / D
    lk = jpv.lookup
    return [None if t is None else np.asarray(t)
            for t in (lk.syn0, lk.syn1, lk.syn1neg, doc)]


@pytest.mark.parametrize("objective", ["hs", "neg"])
@pytest.mark.parametrize("algo", ["dm", "dbow"])
def test_paragraph_vectors_fit_and_infer_match_jax(algo, objective):
    kw = dict(layer_size=16, min_word_frequency=1, epochs=5, learning_rate=0.05,
              window=3, batch_size=128, scan_size=4, seed=11,
              use_hierarchic_softmax=objective == "hs",
              negative=0 if objective == "hs" else 3)
    docs, labels = _docs()
    jpv = jnlp.ParagraphVectors(jnlp.VectorsConfiguration(**kw), docs, labels,
                                sequence_learning_algorithm=algo)
    syn0, syn1, syn1neg, doc = _jax_pv_start(jpv, kw)
    tpv = ParagraphVectors(VectorsConfiguration(**kw), docs, labels,
                           sequence_learning_algorithm=algo, device="cpu")
    tpv.build_vocab()
    tpv.lookup = InMemoryLookupTable.from_numpy(tpv.vocab, syn0, syn1, syn1neg,
                                                device="cpu")
    tpv.set_doc_vectors(doc)
    jpv.fit()
    tpv.fit()
    _close(tpv.lookup.syn0, jpv.lookup.syn0, what="syn0")
    _close(tpv.doc_vectors, jpv.doc_vectors, what="doc")
    out = "syn1" if objective == "hs" else "syn1neg"
    _close(getattr(tpv.lookup, out), getattr(jpv.lookup, out), what=out)
    text = " ".join(["cat", "dog", "cow"] * 3)
    _close(tpv.infer_vector(text, steps=6), jpv.infer_vector(text, steps=6),
           what="infer_vector")
    assert [l for l, _ in tpv.nearest_labels(text, 5)] == \
        [l for l, _ in jpv.nearest_labels(text, 5)]


def test_glove_train_cooccurrences_matches_jax_over_two_epochs():
    kw = dict(layer_size=12, window=3, min_word_frequency=1, epochs=2,
              learning_rate=0.05, batch_size=32, seed=3, x_max=10.0)
    corpus = [s.split() for s in _corpus(60)]
    jg = jnlp.Glove(jnlp.VectorsConfiguration(**kw), corpus)
    jg.build_vocab()
    rows, cols, vals = jglove.cooccurrences_indexed(
        jg._index_sentences(corpus), kw["window"], True)
    tg = Glove(VectorsConfiguration(**kw), corpus, device="cpu")
    tg.build_vocab()
    tg.lookup = InMemoryLookupTable.from_numpy(tg.vocab, np.asarray(jg.lookup.syn0),
                                               device="cpu")
    assert 2 * -(-rows.size // kw["batch_size"]) <= MAX_DEVICE_CALLS
    jg.train_cooccurrences(rows, cols, vals)
    tg.train_cooccurrences(rows, cols, vals)
    _close(tg.lookup.syn0, jg.lookup.syn0, what="syn0")
    _close(tg.bias, jg.bias, what="bias")
    for name, a, b in zip(("hist0", "histb"), tg.adagrad_state, jg.adagrad_state):
        _close(a, b, what=name)
    np.testing.assert_allclose(tg.last_loss, jg.last_loss, rtol=LOSS_RTOL)
    # carried state: a fresh port model continues from the JAX package's
    tg2 = Glove(VectorsConfiguration(**{**kw, "epochs": 1}), corpus, device="cpu")
    tg2.build_vocab()
    tg2.lookup = InMemoryLookupTable.from_numpy(tg2.vocab, np.asarray(jg.lookup.syn0),
                                                device="cpu")
    tg2.set_state(np.asarray(jg.bias), [np.asarray(a) for a in jg.adagrad_state])
    tg2._rng = np.random.default_rng(99)
    jg.conf.epochs = 1
    jg._rng = np.random.default_rng(99)
    jg.train_cooccurrences(rows, cols, vals)
    tg2.train_cooccurrences(rows, cols, vals)
    _close(tg2.lookup.syn0, jg.lookup.syn0, what="syn0 after a carried epoch")
    _close(tg2.bias, jg.bias, what="bias after a carried epoch")


def _tables_model(pkg, device=None):
    """A model of `pkg` holding fixed random tables (HS and negatives)."""
    kw = dict(layer_size=8, min_word_frequency=1, negative=2,
              use_hierarchic_softmax=True, seed=5)
    seqs = [s.split() for s in _corpus(30, seed=9)] + [["naïve", "über", "東京"]]
    extra = {} if pkg is jnlp else {"device": device}
    m = pkg.SequenceVectors(pkg.VectorsConfiguration(**kw), seqs, **extra)
    m.build_vocab()
    rng = np.random.default_rng(4)
    V = m.vocab.num_words()
    tabs = [rng.standard_normal((n, 8)).astype(np.float32) for n in (V, V - 1, V)]
    if pkg is jnlp:
        m.lookup.syn0, m.lookup.syn1, m.lookup.syn1neg = (jnp.asarray(t) for t in tabs)
    else:
        m.lookup = InMemoryLookupTable.from_numpy(m.vocab, *tabs, device=device)
    return m, tabs


SER = {
    "text": ("write_word_vectors", "read_word_vectors"),
    "binary": ("write_google_binary", "read_google_binary"),
    "full": ("write_full_model", "read_full_model"),
}


@pytest.mark.parametrize("direction", ["jax->port", "port->jax"])
@pytest.mark.parametrize("fmt", list(SER))
def test_serializer_formats_load_across_packages(fmt, direction, tmp_path):
    write, read = SER[fmt]
    path = str(tmp_path / f"model.{fmt}")
    if direction == "jax->port":
        src, tabs = _tables_model(jnlp)
        getattr(jnlp.WordVectorSerializer, write)(src, path)
        back = getattr(WordVectorSerializer, read)(path, device="cpu")
        assert back.device.type == "cpu"
    else:
        src, tabs = _tables_model(tnlp, device="cpu")
        getattr(WordVectorSerializer, write)(src, path)
        back = getattr(jnlp.WordVectorSerializer, read)(path)
    assert back.vocab.words() == src.vocab.words()
    exact = dict(rtol=0, atol=5e-7 if fmt == "text" else 0)
    _close(back.lookup.vectors(), tabs[0], exact, "syn0")
    if fmt == "full":
        assert np.array_equal(back.vocab.counts(), src.vocab.counts())
        assert back.conf == type(back.conf)(**vars(src.conf))
        _close(back.lookup.syn1, tabs[1], exact, "syn1")
        _close(back.lookup.syn1neg, tabs[2], exact, "syn1neg")


# -- device default -------------------------------------------------------------


def test_every_entry_point_raises_without_a_gpu_unless_given_the_cpu(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    conf = VectorsConfiguration(layer_size=4, min_word_frequency=1)
    vocab = VocabConstructor(1).build([["a", "b"]])
    src, _ = _tables_model(tnlp, device="cpu")
    path = str(tmp_path / "v.txt")
    WordVectorSerializer.write_word_vectors(src, path)
    makers = {
        "Word2Vec": lambda **d: Word2Vec(conf, ["a b"], **d),
        "Word2Vec.Builder": lambda **d: (Word2Vec.Builder().device(d["device"]) if d
                                         else Word2Vec.Builder()).build(),
        "SequenceVectors": lambda **d: SequenceVectors(conf, [["a"]], **d),
        "ParagraphVectors": lambda **d: ParagraphVectors(conf, ["a b"], ["x"], **d),
        "Glove": lambda **d: Glove(conf, [["a"]], **d),
        "DeepWalk": lambda **d: DeepWalk(**d),
        "Node2Vec": lambda **d: Node2Vec(**d),
        "InMemoryLookupTable": lambda **d: InMemoryLookupTable(vocab, 4, **d),
        "from_numpy": lambda **d: InMemoryLookupTable.from_numpy(
            vocab, np.zeros((2, 4), np.float32), **d),
        "read_word_vectors": lambda **d: WordVectorSerializer.read_word_vectors(path, **d),
    }
    for name, make in makers.items():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
        obj = make(device="cpu")
        assert getattr(obj, "device", torch.device("cpu")).type == "cpu", name
    w2v = Word2Vec(conf, ["a b a b"], device="cpu")
    w2v.build_vocab()
    assert all(t.device.type == "cpu" for t in (w2v.lookup.syn0, w2v.lookup.syn1))


@pytest.mark.parametrize("D", [4, 32, 100])
def test_init_is_uniform_in_half_over_d(D):
    vocab = VocabConstructor(1).build([[f"w{i}" for i in range(2000)]])
    syn0 = InMemoryLookupTable(vocab, D, seed=3, device="cpu").syn0.numpy().ravel()
    half = 0.5 / D
    assert syn0.min() >= -half and syn0.max() < half
    n = syn0.size
    # mean 0 and variance (1/D)^2 / 12 of U(-0.5/D, 0.5/D), within 5 sigma
    assert abs(syn0.mean()) < 5 * half / math.sqrt(3 * n)
    var = (2 * half) ** 2 / 12
    assert abs(syn0.var() - var) < 5 * var * math.sqrt(0.8 / n)
    again = InMemoryLookupTable(vocab, D, seed=3, device="cpu").syn0
    assert np.array_equal(again.numpy().ravel(), syn0)
    other = InMemoryLookupTable(vocab, D, seed=4, device="cpu").syn0
    assert not np.array_equal(other.numpy().ravel(), syn0)


# -- behaviour: test_word2vec.py ------------------------------------------------


def _cluster_check(model):
    near = [w for w, _ in model.words_nearest("cat", 4)]
    assert set(near) == set(ANIMALS) - {"cat"}, near
    assert model.similarity("cat", "dog") > model.similarity("cat", "gpu")


def _build(corpus, **kw):
    b = (
        Word2Vec.Builder().min_word_frequency(1).layer_size(24)
        .window_size(4).epochs(10).learning_rate(0.05).seed(7)
        .batch_size(1024).iterate(corpus).device("cpu")
    )
    for k, v in kw.items():
        getattr(b, k)(v)
    return b.build()


LEARN_CASES = {
    "skipgram-hs": dict(use_hierarchic_softmax=True, negative_sample=0),
    "skipgram-neg": dict(use_hierarchic_softmax=False, negative_sample=5),
    "cbow": dict(use_hierarchic_softmax=True, negative_sample=5,
                 elements_learning_algorithm="cbow"),
}


@pytest.mark.parametrize("case", list(LEARN_CASES))
def test_word2vec_learns_clusters(case):
    w2v = _build(_corpus(), **LEARN_CASES[case])
    w2v.fit()
    _cluster_check(w2v)


def test_unknown_word_and_has_word():
    w2v = _build(_corpus(100), negative_sample=5)
    w2v.fit()
    assert w2v.has_word("cat") and not w2v.has_word("zebra")
    assert w2v.word_vector("zebra") is None
    assert np.isnan(w2v.similarity("cat", "zebra"))


def test_serializer_round_trips(tmp_path):
    w2v = _build(_corpus(100))
    w2v.fit()
    p = str(tmp_path / "vecs.txt")
    WordVectorSerializer.write_word_vectors(w2v, p)
    back = WordVectorSerializer.read_word_vectors(p, device="cpu")
    np.testing.assert_allclose(back.word_vector("cat"), w2v.word_vector("cat"), atol=1e-5)
    p = str(tmp_path / "vecs.bin")
    WordVectorSerializer.write_google_binary(w2v, p)
    back = WordVectorSerializer.read_google_binary(p, device="cpu")
    assert back.vocab.words() == w2v.vocab.words()
    np.testing.assert_allclose(back.word_vector("dog"), w2v.word_vector("dog"), atol=1e-6)
    p = str(tmp_path / "full.zip")
    WordVectorSerializer.write_full_model(w2v, p)
    full = WordVectorSerializer.read_full_model(p, device="cpu")
    assert full.vocab.word_frequency("cat") == w2v.vocab.word_frequency("cat")
    np.testing.assert_allclose(full.lookup.syn1.numpy(), w2v.lookup.syn1.numpy(), atol=1e-6)
    _cluster_check(full)


def _pv_conf():
    return VectorsConfiguration(
        layer_size=24, min_word_frequency=1, epochs=12, learning_rate=0.05,
        negative=5, use_hierarchic_softmax=False, window=4, batch_size=256,
        seed=11,
    )


@pytest.mark.parametrize("algo", ["dm", "dbow"])
def test_paragraph_vectors(algo):
    docs, labels = _docs()
    pv = ParagraphVectors(_pv_conf(), docs, labels,
                          sequence_learning_algorithm=algo, device="cpu")
    pv.fit()
    dv = pv.doc_vectors.numpy()
    dvn = dv / np.linalg.norm(dv, axis=1, keepdims=True)
    sims = dvn @ dvn.T
    within = (sims[:20, :20].mean() + sims[20:, 20:].mean()) / 2
    across = sims[:20, 20:].mean()
    assert within > across + 0.1, (within, across)
    v = pv.infer_vector(" ".join(["cat", "dog", "cow"] * 3), steps=10)
    near = pv.nearest_labels(v, top_n=5)
    hits = sum(1 for l, _ in near if int(l.split("_")[1]) < 20)
    assert hits >= 4, near
    assert isinstance(pv.similarity_to_label("cat dog", "doc_0"), float)
    assert pv.doc_vector("doc_0").shape == (24,)


# -- behaviour: test_nlp_vocab.py -----------------------------------------------


def test_tokenizer_and_preprocessor():
    tf = DefaultTokenizerFactory()
    assert tf.create("Hello  world").get_tokens() == ["Hello", "world"]
    tf.set_token_pre_processor(CommonPreprocessor())
    assert tf.create("Hello, World! 123").get_tokens() == ["hello", "world"]
    toks = NGramTokenizerFactory(1, 2).create("a b c").get_tokens()
    assert "a b" in toks and "b c" in toks and "a" in toks


def test_vocab_construction_min_frequency():
    vocab = VocabConstructor(min_word_frequency=2).build([["a", "a", "a", "b", "b", "c"]])
    assert vocab.contains_word("a") and vocab.contains_word("b")
    assert not vocab.contains_word("c")
    assert vocab.index_of("a") == 0
    assert vocab.word_frequency("a") == 3
    assert vocab.total_word_count == 5


def _zipf(n):
    w = 1.0 / np.arange(1, n + 1)
    return w / w.sum()


def test_huffman_invariants():
    rng = np.random.default_rng(0)
    words = [f"w{i}" for i in range(50)]
    seqs = [list(rng.choice(words, p=_zipf(50), size=200)) for _ in range(20)]
    vocab = VocabConstructor(1).build(seqs)
    h = Huffman(vocab)
    vws = vocab.vocab_words()
    V = len(vws)
    codes = {"".join(map(str, w.code)) for w in vws}
    assert len(codes) == V
    for c1 in codes:
        for c2 in codes:
            if c1 != c2:
                assert not c2.startswith(c1)
    for w in vws:
        assert len(w.code) == len(w.points)
        assert all(0 <= p <= V - 2 for p in w.points)
    most = max(vws, key=lambda w: w.count)
    least = min(vws, key=lambda w: w.count)
    assert len(most.code) <= len(least.code)
    counts = vocab.counts().astype(float)
    p = counts / counts.sum()
    entropy = -(p * np.log2(p)).sum()
    avg_len = sum(len(w.code) * w.count for w in vws) / counts.sum()
    assert entropy <= avg_len <= entropy + 1.0
    codes_a, points_a, lengths = h.arrays()
    for i, w in enumerate(vws):
        n = lengths[i]
        assert list(codes_a[i, :n]) == w.code
        assert list(points_a[i, :n]) == w.points


def test_unigram_table_distribution():
    vocab = VocabConstructor(1).build([["a"] * 75 + ["b"] * 25])
    table = InMemoryLookupTable(vocab, 4, negative=1, device="cpu").unigram_table(10_000)
    frac_a = np.mean(table == vocab.index_of("a"))
    expected = 75**0.75 / (75**0.75 + 25**0.75)
    assert abs(frac_a - expected) < 0.02


def test_cjk_tokenizer_factory():
    tf = CJKTokenizerFactory()
    toks = tf.create("東京都に住むGPUユーザー").get_tokens()
    assert "東京" in toks and "京都" in toks
    assert "に" in toks and "ユーザー" in toks and "GPU" in toks
    toks_ko = tf.create("서울특별시").get_tokens()
    assert "서울" in toks_ko and "울특" in toks_ko
    assert toks.index("東京") < toks.index("に") < toks.index("GPU")
    assert "東京都" in CJKTokenizerFactory(bigrams=False).create("東京都に住む").get_tokens()
    sents = [tf.create(s).get_tokens() for s in ("東京の天気", "東京の電車", "大阪の天気")]
    assert all(len(s) >= 2 for s in sents)


# -- behaviour: test_glove.py ----------------------------------------------------


def _token_corpus(n=400, seed=0):
    return [s.split() for s in _corpus(n, seed)]


def _to_dense(rows, cols, vals, V):
    X = np.zeros((V, V), np.float64)
    for r, c, v in zip(rows, cols, vals):
        X[r, c] += v
    return X


def test_cooccurrence_hand_computed():
    rows, cols, vals = cooccurrences_indexed([np.array([0, 1, 2])], window=2, symmetric=True)
    expect = np.array([[0, 1.0, 0.5], [1.0, 0, 1.0], [0.5, 1.0, 0]])
    np.testing.assert_allclose(_to_dense(rows, cols, vals, 3), expect)
    rows, cols, vals = cooccurrences_indexed([np.array([0, 1, 2])], window=2, symmetric=False)
    np.testing.assert_allclose(_to_dense(rows, cols, vals, 3), np.triu(expect))
    rows, cols, vals = cooccurrences_indexed([np.array([0, 1, 0, 1])], window=1, symmetric=False)
    np.testing.assert_allclose(_to_dense(rows, cols, vals, 2), [[0, 2.0], [1.0, 0]])


def test_native_matches_python_accumulation(tmp_path):
    if not tnative.native_available():
        pytest.skip("no C++ toolchain")
    path = tmp_path / "corpus.txt"
    path.write_text("\n".join(" ".join(s) for s in _token_corpus(60)) + "\n")
    with tnative.NativeCorpus(str(path)) as nc:
        words, _ = nc.vocab(1)
        n_rows, n_cols, n_vals = nc.cooccurrences(1, window=4, symmetric=True)
        indexed = nc.indexed_sentences(1)
    rows, cols, vals = cooccurrences_indexed(indexed, window=4, symmetric=True)
    V = len(words)
    np.testing.assert_allclose(_to_dense(n_rows, n_cols, n_vals, V),
                               _to_dense(rows, cols, vals, V), rtol=1e-6)


def test_glove_learns_clusters():
    conf = VectorsConfiguration(layer_size=24, window=4, min_word_frequency=1, epochs=25,
                                learning_rate=0.05, batch_size=1024, seed=7, x_max=10.0)
    glove = Glove(conf, _token_corpus(), device="cpu")
    glove.fit()
    near = [w for w, _ in glove.words_nearest("cat", 4)]
    assert set(near) == set(ANIMALS) - {"cat"}, near
    assert glove.similarity("cat", "dog") > glove.similarity("cat", "gpu")
    assert np.isfinite(glove.last_loss)


@pytest.mark.parametrize("toolchain", [True, False], ids=["native", "python"])
def test_glove_fit_file(tmp_path, monkeypatch, caplog, toolchain):
    """The native path, and the Python fallback that a box without g++
    takes (with a warning): the same vocab either way."""
    if toolchain and not tnative.native_available():
        pytest.skip("no C++ toolchain")
    if not toolchain:
        monkeypatch.setattr(tnative, "native_available", lambda: False)
    path = tmp_path / "corpus.txt"
    path.write_text("\n".join(" ".join(s) for s in _token_corpus(200)) + "\n")
    conf = VectorsConfiguration(layer_size=16, window=4, min_word_frequency=1, epochs=20,
                                learning_rate=0.05, batch_size=1024, seed=3, x_max=10.0)
    with caplog.at_level("WARNING", logger="deeplearning4j_tpu_torch.nlp"):
        glove = Glove(conf, device="cpu").fit_file(str(path))
    assert ("falling back" in caplog.text) != toolchain
    assert glove.vocab.words() == VocabConstructor(1).build(_token_corpus(200)).words()
    assert glove.similarity("cat", "dog") > glove.similarity("cat", "gpu")


def test_glove_serializer_round_trip(tmp_path):
    conf = VectorsConfiguration(layer_size=12, window=4, min_word_frequency=1, epochs=5,
                                learning_rate=0.05, batch_size=512, seed=1, x_max=10.0)
    glove = Glove(conf, _token_corpus(80), device="cpu")
    glove.fit()
    txt = tmp_path / "glove.txt"
    WordVectorSerializer.write_word_vectors(glove, str(txt))
    back = WordVectorSerializer.read_word_vectors(str(txt), device="cpu")
    for w in ("cat", "gpu"):
        np.testing.assert_allclose(back.word_vector(w), glove.word_vector(w), atol=1e-5)
    binp = tmp_path / "glove.bin"
    WordVectorSerializer.write_google_binary(glove, str(binp))
    back2 = WordVectorSerializer.read_google_binary(str(binp), device="cpu")
    np.testing.assert_allclose(back2.word_vector("dog"), glove.word_vector("dog"), atol=1e-6)


# -- behaviour: test_devicegen.py ------------------------------------------------


def test_pack_corpus_gaps_and_padding():
    sents = [np.array([1, 2, 3]), np.array([], np.int64), np.array([4, 5])]
    out = pack_corpus(sents, window=3, bucket=16)
    assert out.size == 16
    np.testing.assert_array_equal(
        out[:11], [1, 2, 3, SENTINEL, SENTINEL, SENTINEL, 4, 5, SENTINEL, SENTINEL, SENTINEL])
    assert (out[11:] == SENTINEL).all()


def _brute_pairs(corpus, window):
    pairs = set()
    n = corpus.size
    for i in range(n):
        if corpus[i] < 0:
            continue
        for d in range(1, window + 1):
            for j in (i - d, i + d):
                if 0 <= j < n and corpus[j] >= 0:
                    pairs.add((int(corpus[j]), int(corpus[i]), d))
    return pairs


def test_device_pairs_subset_of_oracle_and_d1_complete():
    rng = np.random.default_rng(0)
    sents = [rng.integers(1, 50, rng.integers(2, 12)).astype(np.int64) for _ in range(8)]
    window = 4
    corpus = pack_corpus(sents, window, bucket=64)
    ins, tgt, valid = corpus_pairs_debug(corpus, window, torch.Generator().manual_seed(7))
    oracle = _brute_pairs(corpus, window)
    oracle_it = {(a, b) for a, b, _ in oracle}
    offsets = np.concatenate([np.arange(-window, 0), np.arange(1, window + 1)])
    dist = np.abs(np.tile(offsets, corpus.size))
    got = list(zip(ins[valid], tgt[valid]))
    assert got
    for pair in got:
        assert (int(pair[0]), int(pair[1])) in oracle_it
    d1_oracle = {(a, b) for a, b, d in oracle if d == 1}
    d1_got_valid = {(int(a), int(b)) for (a, b), d, v in
                    zip(zip(ins, tgt), dist, valid) if d == 1 and v}
    assert d1_oracle <= d1_got_valid


def test_no_pairs_cross_sentence_boundaries():
    corpus = pack_corpus([np.arange(1, 8), np.arange(100, 108)], 5, bucket=64)
    ins, tgt, valid = corpus_pairs_debug(corpus, 5, torch.Generator().manual_seed(3))
    for a, b in zip(ins[valid], tgt[valid]):
        assert (a < 50) == (b < 50), f"cross-sentence pair {a}->{b}"


def _cluster_corpus(n=300, seed=5):
    rng = np.random.default_rng(seed)
    a = ["apple", "banana", "cherry", "grape"]
    b = ["cpu", "gpu", "ram", "disk"]
    sents = []
    for _ in range(n):
        pool = a if rng.random() < 0.5 else b
        sents.append([pool[i] for i in rng.integers(0, len(pool), 6)])
    return sents, a, b


def test_corpus_device_path_learns_clusters():
    sents, a, b = _cluster_corpus()
    conf = VectorsConfiguration(layer_size=24, window=3, min_word_frequency=1, epochs=12,
                                negative=5, use_hierarchic_softmax=False, batch_size=1024,
                                learning_rate=0.05, seed=11)
    sv = SequenceVectors(conf, sents, device="cpu")
    sv.fit()
    assert np.isfinite(sv.last_loss)
    assert sv.similarity(a[0], a[1]) > sv.similarity(a[0], b[0])


@pytest.mark.parametrize("hs,negative,path", [(False, 3, "corpus"), (True, 0, "batched")])
def test_training_path_selection(monkeypatch, hs, negative, path):
    """skip-gram + negatives alone takes the corpus-resident path, HS the
    batched one."""
    sents, _, _ = _cluster_corpus(50)
    conf = VectorsConfiguration(layer_size=8, window=2, min_word_frequency=1, epochs=1,
                                negative=negative, use_hierarchic_softmax=hs, batch_size=256)
    sv = SequenceVectors(conf, sents, device="cpu")
    taken = []
    for name in ("_train_corpus_device", "_train_batched"):
        orig = getattr(sv, name)
        monkeypatch.setattr(sv, name, lambda idx, n=name, f=orig: taken.append(n) or f(idx))
    sv.fit()
    assert taken == ["_train_corpus_device" if path == "corpus" else "_train_batched"]
    assert np.isfinite(sv.last_loss)


# -- behaviour: test_japanese.py ---------------------------------------------------


SEGMENTS = {
    "私は東京に行きます": ["私", "は", "東京", "に", "行き", "ます"],
    "猫が水を飲んだ": ["猫", "が", "水", "を", "飲んだ"],
    "今日はとても暑いですね": ["今日", "は", "とても", "暑い", "です", "ね"],
    "明日、学校で勉強します。": ["明日", "学校", "で", "勉強", "します"],
    "": [],
    "hello world": ["hello", "world"],
}


@pytest.mark.parametrize("text", list(SEGMENTS))
def test_segmentation(text):
    assert segment(text) == SEGMENTS[text]


def test_unknown_runs_stay_whole_and_do_not_swallow_particles():
    toks = segment("カタカナとAlphabetと漢字")
    assert "カタカナ" in toks and "Alphabet" in toks and "漢字" in toks
    toks = segment("量子力学の本は難しい")
    assert "の" in toks and "は" in toks and "難しい" in toks and "量子力学" in toks
    toks = segment("ぬるぽが好き")
    assert toks[:2] == ["ぬるぽ", "が"] and "好き" in toks


def test_factory_spi_custom_lexicon_and_bigram_comparison():
    f = JapaneseTokenizerFactory(lexicon={"量子力学": 3.0})
    assert f.create("量子力学は難しい").get_tokens() == ["量子力学", "は", "難しい"]
    text = "東京大学の学生"
    lattice = segment(text)
    bigrams = CJKTokenizerFactory().create(text).get_tokens()
    assert "東京" in lattice and "学生" in lattice
    assert "京大" in bigrams and "京大" not in lattice


# -- behaviour: test_graph_deepwalk.py ------------------------------------------------


def _two_cliques(k=6, bridge=True):
    g = Graph(2 * k)
    for base in (0, k):
        for i in range(k):
            for j in range(i + 1, k):
                g.add_edge(base + i, base + j)
    if bridge:
        g.add_edge(k - 1, k)
    return g


def test_graph_and_walks():
    g = _two_cliques()
    assert g.degree(0) == 5
    walks = list(RandomWalkIterator(g, walk_length=10, seed=1))
    assert len(walks) == 12
    for w in walks:
        assert len(w) == 11
        for a, b in zip(w, w[1:]):
            assert b in g.neighbors(a), f"invalid hop {a}->{b}"


def test_dead_end_handling():
    g = Graph(2, directed=True)
    g.add_edge(0, 1)
    w = RandomWalkIterator(g, 4, seed=0, no_edge_handling=NoEdgeHandling.SELF_LOOP).walk_from(0)
    assert len(w) == 5 and w[-1] == 1
    it = RandomWalkIterator(g, 4, seed=0, no_edge_handling=NoEdgeHandling.CUTOFF)
    assert it.walk_from(0) == [0, 1]
    it = RandomWalkIterator(g, 4, seed=0, no_edge_handling=NoEdgeHandling.EXCEPTION)
    with pytest.raises(RuntimeError):
        it.walk_from(0)


def test_deepwalk_separates_cliques():
    dw = DeepWalk(vector_size=16, window_size=4, walks_per_vertex=8,
                  learning_rate=0.05, seed=3, batch_size=512, device="cpu")
    vectors = dw.fit(_two_cliques(k=6), walk_length=20)
    intra, inter = [], []
    for a in range(0, 4):
        for b in range(1, 4):
            if a != b:
                intra.append(vectors.similarity(a, b))
        for b in range(6, 10):
            inter.append(vectors.similarity(a, b))
    assert np.mean(intra) > np.mean(inter) + 0.2, (np.mean(intra), np.mean(inter))
    assert all(v < 6 for v in vectors.verts_nearest(1, top_n=3))
    assert vectors.vertex_vector(0).shape == (16,)


# -- behaviour: test_vectorizers_node2vec.py (not LFW) -------------------------------

DOCS = ["the cat sat on the mat", "the dog sat on the log", "cats and dogs and cats"]


def test_bow_per_document_counts():
    v = BagOfWordsVectorizer().fit(DOCS)
    row = v.transform("the cat and the cat")
    assert row.shape == (1, v.vocab.num_words())
    assert row[0, v.vocab.index_of("the")] == 2.0
    assert row[0, v.vocab.index_of("cat")] == 2.0
    assert row[0, v.vocab.index_of("and")] == 1.0
    assert row[0, v.vocab.index_of("dog")] == 0.0
    assert v.vocab.index_of("zebra") == -1


def test_tfidf_reference_formulas():
    v = TfidfVectorizer().fit(DOCS)
    row = v.transform("cat cat dog mat")
    np.testing.assert_allclose(row[0, v.vocab.index_of("cat")],
                               (2 / 4) * math.log10(3 / 1), rtol=1e-6)
    assert row[0, v.vocab.index_of("the")] == 0.0
    np.testing.assert_allclose(row[0, v.vocab.index_of("dog")],
                               (1 / 4) * math.log10(3 / 1), rtol=1e-6)


def test_tfidf_vectorize_dataset_and_labels():
    v = TfidfVectorizer().fit(DOCS, labels=["pets", "other"])
    ds = v.vectorize("the cat sat", "pets")
    assert ds.features.shape == (1, v.vocab.num_words())
    assert ds.labels.shape[1] == 2 and ds.labels[0, 0] == 1.0
    assert v.vectorize("the dog", "other").labels.shape == (1, 2)
    with pytest.raises(ValueError, match="unknown label"):
        v.vectorize("the dog", "vehicles")
    with pytest.raises(ValueError, match="no label space"):
        BagOfWordsVectorizer().fit(DOCS).vectorize("the cat", "pets")
    ls = LabelsSource(["a", "b"])
    assert ls.index_of("b") == 1 and ls.index_of("missing") == -1


def test_min_word_frequency_filters():
    v = BagOfWordsVectorizer(min_word_frequency=2).fit(DOCS)
    assert v.vocab.index_of("the") >= 0
    assert v.vocab.index_of("log") == -1


def test_tfidf_trains_classifier():
    """tf-idf features feed the port's training stack."""
    from deeplearning4j_tpu_torch.nn.conf.layers import OutputLayer
    from deeplearning4j_tpu_torch.nn.conf.network import NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    rng = np.random.default_rng(0)
    docs, labels = [], []
    for _ in range(60):
        grp = ANIMALS if rng.random() < 0.5 else TECH
        docs.append(" ".join(rng.choice(grp, 6)))
        labels.append("animal" if grp is ANIMALS else "tech")
    v = TfidfVectorizer().fit(docs, labels=["animal", "tech"])
    X = np.concatenate([v.transform(d) for d in docs])
    y = np.zeros((len(docs), 2), np.float32)
    for i, l in enumerate(labels):
        y[i, v.labels_source.index_of(l)] = 1.0
    conf = (NeuralNetConfiguration.builder().seed(1).updater("adam")
            .learning_rate(0.05).weight_init("xavier").list()
            .layer(OutputLayer(n_in=X.shape[1], n_out=2, activation="softmax", loss="mcxent"))
            .build())
    net = MultiLayerNetwork(conf, device="cpu").init()
    for _ in range(60):
        net.fit(X, y, batch_size=32, epochs=1, async_prefetch=False)
    pred = np.argmax(np.asarray(net.output(X).cpu()), -1)
    assert float(np.mean(pred == np.argmax(y, -1))) > 0.95


def _barbell():
    g = Graph(12)
    for base in (0, 6):
        for i in range(6):
            for j in range(i + 1, 6):
                g.add_edge(base + i, base + j)
    g.add_edge(5, 6)
    return g


def test_node2vec_walk_bias():
    g = _barbell()
    counts = []
    for q in (8.0, 1.0):
        it = Node2VecWalkIterator(g, walk_length=20, p=1.0, q=q, seed=0)
        counts.append(sum(sum(1 for v in it.walk_from(0) if v > 6) for _ in range(50)))
    assert counts[0] < counts[1], counts


def test_node2vec_learns_communities():
    vecs = Node2Vec(vector_size=16, window_size=4, walks_per_vertex=8, p=1.0, q=2.0,
                    seed=3, device="cpu").fit(_barbell(), walk_length=12)
    same = np.mean([vecs.similarity(0, j) for j in range(1, 5)])
    cross = np.mean([vecs.similarity(0, j) for j in range(7, 11)])
    assert same > cross, (same, cross)
    assert all(v <= 6 for v in vecs.verts_nearest(1, 4))


# -- behaviour: test_native_corpus.py ------------------------------------------------

_TEXT = """the quick brown fox jumps over the lazy dog
the dog barks at the fox
a quick fox and a lazy dog
the end
"""


@pytest.fixture
def corpus_file(tmp_path):
    if not tnative.native_available():
        pytest.skip("no C++ toolchain")
    p = tmp_path / "corpus.txt"
    p.write_text(_TEXT)
    return str(p)


def test_native_vocab_matches_python_constructor(corpus_file):
    with tnative.NativeCorpus(corpus_file) as c:
        assert c.num_sentences == 4
        assert c.total_tokens == len(_TEXT.split())
        words, counts = c.vocab(min_count=1)
    py = VocabConstructor(1).build([line.split() for line in _TEXT.strip().split("\n")])
    assert words == py.words()
    np.testing.assert_array_equal(counts, py.counts())


def test_native_min_count_filter_and_indexing(corpus_file):
    with tnative.NativeCorpus(corpus_file) as c:
        words, counts = c.vocab(min_count=2)
        assert all(cc >= 2 for cc in counts)
        sents = c.indexed_sentences(min_count=2)
        words1, _ = c.vocab(min_count=1)
        sents1 = c.indexed_sentences(min_count=1)
    assert [words1[i] for i in sents1[0]] == "the quick brown fox jumps over the lazy dog".split()
    assert all(int(s.max()) < len(words) for s in sents if s.size)
    flat = [words[i] for s in sents for i in s]
    assert "barks" not in flat and "the" in flat


def test_word2vec_fit_file(corpus_file, tmp_path):
    rng = np.random.default_rng(0)
    words_a = [f"a{i}" for i in range(10)]
    words_b = [f"b{i}" for i in range(10)]
    lines = [" ".join(rng.choice(words_a if rng.random() < 0.5 else words_b, size=8))
             for _ in range(300)]
    big = tmp_path / "big.txt"
    big.write_text("\n".join(lines) + "\n")
    conf = VectorsConfiguration(layer_size=24, window=3, min_word_frequency=1, epochs=3,
                                negative=4, use_hierarchic_softmax=False,
                                batch_size=512, seed=1)
    sv = SequenceVectors(conf, device="cpu").fit_file(str(big))
    assert sv.vocab.num_words() == 20
    assert sv.similarity("a1", "a2") > sv.similarity("a1", "b2")

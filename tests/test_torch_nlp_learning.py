"""The port's embedding update steps (deeplearning4j_tpu_torch/nlp/
learning.py, devicegen.py) against the JAX package's on the same inputs,
on the CPU.

One step of `make_embedding_step` per objective (HS, negatives, both) x
doc row on/off x word tables training on/off, plus hot-row batches where
the trust-region clip binds; a group of `make_embedding_scan_step` whose
device negatives are redrawn from the JAX keys; `pack_corpus` exactly;
`_chunk_pairs` against the JAX `corpus_pairs_debug` with the same window
draws; and a whole `make_corpus_skipgram_step` epoch with every chunk's
draws regenerated from the JAX keys, walked to the end of the padded
corpus and stopped after its last real token.

Tolerances: one step in f32, rtol 1e-5 / atol 1e-7 (the same f32
expressions, summed in another order); a group or an epoch (one JAX
device call, up to a dozen updates), rtol 1e-4 / atol 1e-6; losses rtol
1e-5.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nlp import devicegen as jdg
from deeplearning4j_tpu.nlp import learning as jl
from deeplearning4j_tpu_torch.nlp import devicegen as tdg
from deeplearning4j_tpu_torch.nlp import learning as tl

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from torch_parity import one_torch_thread  # noqa: E402,F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

STEP_TOL = dict(rtol=1e-5, atol=1e-7)
FIT_TOL = dict(rtol=1e-4, atol=1e-6)
LOSS_RTOL = 1e-5

V, D, B, L, K = 40, 16, 24, 6, 3
CAP = 0.25  # the steps' default max_row_update



def _tables(seed, v=V):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((n, D)) * scale).astype(np.float32)
            for n, scale in ((v, 0.3), (v - 1, 0.3), (v, 0.3), (7, 0.3))]


def _batch(seed, *, use_hs, negative, with_doc, context, v=V, b=B):
    """A batch in the JAX package's layout (int32 indices, int8 masks),
    with three padded tail rows."""
    rng = np.random.default_rng(seed)
    batch = {"h_idx": rng.integers(0, v, (b, context)).astype(np.int32),
             "row_mask": np.ones(b, np.int8)}
    batch["row_mask"][-3:] = 0
    if context > 1:
        batch["h_mask"] = (rng.random((b, context)) < 0.7).astype(np.int8)
        batch["h_mask"][0] = 0  # a row with no context: only the doc row
    if use_hs:
        lengths = rng.integers(1, L + 1, b)
        batch["points"] = rng.integers(0, v - 1, (b, L)).astype(np.int32)
        batch["codes"] = rng.integers(0, 2, (b, L)).astype(np.int8)
        batch["hs_mask"] = (np.arange(L)[None, :] < lengths[:, None]).astype(np.int8)
    if negative:
        batch["pos"] = rng.integers(0, v, b).astype(np.int32)
        batch["neg"] = rng.integers(0, v, (b, negative)).astype(np.int32)
        batch["neg"][1, 0] = batch["pos"][1]  # a collision: skipped
    if with_doc:
        batch["doc_idx"] = rng.integers(0, 7, b).astype(np.int32)
    return batch


def _jax_step(kind, tables, batch, lr, **flags):
    maker = jl.make_embedding_step if kind == "step" else jl.make_embedding_scan_step
    step = maker(**flags)
    args = [jnp.asarray(t.copy()) for t in tables]
    if kind == "step":
        out = step(*args, {k: jnp.asarray(v) for k, v in batch.items()},
                   jnp.float32(lr))
    else:
        out = step(*args, *lr)
    return [np.asarray(o) for o in out]


def _port_tables(tables):
    return [torch.from_numpy(t.copy()) for t in tables]


def _assert_tables(got, want, tol):
    for name, g, w in zip(("syn0", "syn1", "syn1neg", "doc"), got, want):
        np.testing.assert_allclose(g.numpy(), w, err_msg=name, **tol)


OBJECTIVES = {"hs": (True, 0), "neg": (False, K), "hs+neg": (True, K)}


@pytest.mark.parametrize("train_words", [True, False], ids=["train", "frozen"])
@pytest.mark.parametrize("with_doc", [False, True], ids=["nodoc", "doc"])
@pytest.mark.parametrize("objective", list(OBJECTIVES))
def test_one_step_matches_jax(objective, with_doc, train_words):
    """Skip-gram's layout (one input row, no h_mask) without a doc row,
    the window layout (mask-padded context) with one."""
    use_hs, negative = OBJECTIVES[objective]
    flags = dict(use_hs=use_hs, negative=negative, with_doc=with_doc,
                 train_words=train_words)
    tables = _tables(1)
    batch = _batch(2, use_hs=use_hs, negative=negative, with_doc=with_doc,
                   context=4 if with_doc else 1)
    want = _jax_step("step", tables, batch, 0.05, **flags)
    port = _port_tables(tables)
    got = tl.make_embedding_step(**flags)(*port, tl.batch_to_device(batch, "cpu"), 0.05)
    _assert_tables(got[:4], want[:4], STEP_TOL)
    np.testing.assert_allclose(float(got[4]), want[4], rtol=LOSS_RTOL)
    if not train_words:
        for name, t, t0 in zip(("syn0", "syn1", "syn1neg"), got[:3], tables):
            assert np.array_equal(t.numpy(), t0), f"{name} moved with train_words=False"


@pytest.mark.parametrize("objective", list(OBJECTIVES))
def test_hot_rows_are_clipped_like_jax(objective):
    """A 3-word vocab under a 64-row batch at lr 1: every row is hit ~20
    times and its summed update is clipped to the cap, in both packages."""
    use_hs, negative = OBJECTIVES[objective]
    flags = dict(use_hs=use_hs, negative=negative, with_doc=False)
    tables = _tables(3, v=3)
    batch = _batch(4, use_hs=use_hs, negative=negative, with_doc=False,
                   context=1, v=3, b=64)
    want = _jax_step("step", tables, batch, 1.0, **flags)
    got = tl.make_embedding_step(**flags)(*_port_tables(tables),
                                          tl.batch_to_device(batch, "cpu"), 1.0)
    _assert_tables(got[:4], want[:4], STEP_TOL)
    np.testing.assert_allclose(float(got[4]), want[4], rtol=LOSS_RTOL)
    # the clip binds: every syn0 row moved by exactly the cap ...
    moved = np.linalg.norm(got[0].numpy() - tables[0], axis=1)
    np.testing.assert_allclose(moved, CAP, rtol=1e-5)
    # ... and without it the same step moves rows further
    free = tl.make_embedding_step(max_row_update=float("inf"), **flags)(
        *_port_tables(tables), tl.batch_to_device(batch, "cpu"), 1.0)
    assert (np.linalg.norm(free[0].numpy() - tables[0], axis=1) > CAP).all()


def _jax_negatives(key, S, b, negative, unigram):
    """The negatives the JAX scan step draws on the device: one key per
    batch, split from the group's key, then randint into the table."""
    keys = jax.random.split(key, S)
    return np.stack([np.asarray(unigram)[np.asarray(
        jax.random.randint(k, (b, negative), 0, unigram.shape[0]))] for k in keys])


@pytest.mark.parametrize("objective", ["neg", "hs+neg"])
def test_scan_group_with_device_negatives_redrawn_from_the_jax_keys(objective):
    use_hs, negative = OBJECTIVES[objective]
    S = 3
    flags = dict(use_hs=use_hs, negative=negative, with_doc=False)
    tables = _tables(5)
    batches = [_batch(10 + s, use_hs=use_hs, negative=negative, with_doc=False,
                      context=1) for s in range(S)]
    for b in batches:
        del b["neg"]  # drawn on the device
    group = {k: np.stack([b[k] for b in batches]) for k in batches[0]}
    lrs = np.asarray([0.05, 0.04, 0.03], np.float32)
    unigram = np.random.default_rng(6).integers(0, V, 500).astype(np.int32)
    key = jax.random.fold_in(jax.random.PRNGKey(12345 ^ 0x5EED), 96)
    want = _jax_step("scan", tables,
                     None, (jnp.asarray(unigram), {k: jnp.asarray(v) for k, v in group.items()},
                            jnp.asarray(lrs), key), **flags)
    group["neg"] = _jax_negatives(key, S, B, negative, unigram)
    got = tl.make_embedding_scan_step(**flags)(
        *_port_tables(tables), torch.from_numpy(unigram).long(),
        tl.batch_to_device(group, "cpu"), lrs)
    _assert_tables(got[:4], want[:4], FIT_TOL)
    np.testing.assert_allclose(float(got[4]), want[4], rtol=LOSS_RTOL)


def test_device_negatives_come_from_the_generator():
    """Without "neg" in the batch the port draws from the unigram table
    with the generator it is given: the same seed, the same step."""
    flags = dict(use_hs=False, negative=K, with_doc=False)
    batch = _batch(7, use_hs=False, negative=K, with_doc=False, context=1)
    del batch["neg"]
    unigram = torch.arange(V).repeat(3)
    outs = []
    for _ in range(2):
        tabs = _port_tables(_tables(8))
        gen = torch.Generator().manual_seed(99)
        outs.append(tl.make_embedding_step(**flags)(
            *tabs, tl.batch_to_device(batch, "cpu"), 0.05, unigram, gen))
    for a, b in zip(outs[0], outs[1]):
        assert torch.equal(a, b)


# -- devicegen ------------------------------------------------------------------


def _sentences(seed, n=9, v=V):
    rng = np.random.default_rng(seed)
    out = [rng.integers(0, v, rng.integers(2, 12)).astype(np.int64) for _ in range(n)]
    out.insert(3, np.zeros(0, np.int64))  # an empty sentence leaves no gap
    return out


@pytest.mark.parametrize("window,bucket", [(3, 16), (2, 64), (5, 8)])
def test_pack_corpus_is_exact(window, bucket):
    sents = _sentences(window)
    got = tdg.pack_corpus(sents, window, bucket)
    want = jdg.pack_corpus(sents, window, bucket)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert tdg.live_length(got) == int(np.flatnonzero(want >= 0)[-1]) + 1


@pytest.mark.parametrize("window", [1, 3, 5])
def test_chunk_pairs_match_jax_with_the_same_window_draws(window):
    corpus = jdg.pack_corpus(_sentences(20 + window), window, 32)
    key = jax.random.PRNGKey(window)
    n = corpus.size
    want = jdg.corpus_pairs_debug(corpus, window, key)
    b = np.asarray(jax.random.randint(key, (n,), 0, window))
    got = tdg.corpus_pairs_debug(corpus, window, b)
    for g, w in zip(got, want):
        assert np.array_equal(g, w)


def _jax_chunk_draws(key, n_chunks, n_centers, window, negative, unigram_size):
    """Chunk i's (b, r) as the JAX corpus step draws them: split the
    epoch key into one key a chunk, split that into k_win and k_neg."""
    keys = jax.random.split(key, n_chunks)

    def draws(i):
        k_win, k_neg = jax.random.split(keys[i])
        b = jax.random.randint(k_win, (n_centers,), 0, window)
        r = jax.random.randint(k_neg, (n_centers * 2 * window, negative), 0, unigram_size)
        return torch.from_numpy(np.array(b)), torch.from_numpy(np.array(r))

    return draws


@pytest.mark.parametrize("stop_early", [False, True], ids=["padded", "live"])
def test_corpus_epoch_matches_jax_with_regenerated_draws(stop_early):
    window, negative, ppb = 3, 4, 60
    n_centers = ppb // (2 * window)
    corpus = jdg.pack_corpus(_sentences(30), window, 64)
    corpus = np.concatenate([corpus, np.full(64, -1, np.int32)])  # more dead chunks
    unigram = np.random.default_rng(31).integers(0, V, 300).astype(np.int32)
    syn0, _, syn1neg, _ = _tables(32)
    syn1neg *= 0.1
    epoch_key = jax.random.fold_in(jax.random.PRNGKey(7 ^ 0x5EED), 1 * 7919 + 0)
    args = (0.05, 0.0001, 400.0, 120.0)  # lr0, min_lr, total_pairs, seen0
    jstep = jdg.make_corpus_skipgram_step(negative=negative, window=window,
                                          pairs_per_batch=ppb)
    w0, w1, wloss, wseen = jstep(jnp.asarray(syn0), jnp.asarray(syn1neg),
                                 jnp.asarray(unigram), jnp.asarray(corpus),
                                 *(jnp.float32(a) for a in args), epoch_key)
    n_chunks = -(-corpus.size // n_centers)
    live = tdg.live_length(corpus) if stop_early else None
    assert tdg.live_length(corpus) < corpus.size - n_centers  # some chunks are dead
    tstep = tdg.make_corpus_skipgram_step(negative=negative, window=window,
                                          pairs_per_batch=ppb)
    called = []
    draws = _jax_chunk_draws(epoch_key, n_chunks, n_centers, window, negative, unigram.size)
    g0, g1, gloss, gseen = tstep(
        torch.from_numpy(syn0.copy()), torch.from_numpy(syn1neg.copy()),
        torch.from_numpy(unigram).long(), torch.from_numpy(corpus).long(),
        *args[:3], torch.tensor(args[3]), live=live,
        draws=lambda i: called.append(i) or draws(i))
    assert len(called) == (-(-live // n_centers) if stop_early else n_chunks)
    np.testing.assert_allclose(g0.numpy(), np.asarray(w0), **FIT_TOL)
    np.testing.assert_allclose(g1.numpy(), np.asarray(w1), **FIT_TOL)
    np.testing.assert_allclose(float(gloss), float(wloss), rtol=LOSS_RTOL)
    assert float(gseen) == float(wseen)  # counted pairs: exact in f32


def test_corpus_step_draws_from_the_generator_when_none_are_given():
    window = 2
    corpus = torch.from_numpy(jdg.pack_corpus(_sentences(40), window, 32)).long()
    outs = []
    for _ in range(2):
        syn0, _, syn1neg, _ = (torch.from_numpy(t) for t in _tables(41))
        step = tdg.make_corpus_skipgram_step(negative=2, window=window, pairs_per_batch=40)
        outs.append(step(syn0, syn1neg, torch.arange(V), corpus, 0.05, 1e-4, 500.0,
                         torch.zeros(()), generator=torch.Generator().manual_seed(3)))
    for a, b in zip(outs[0], outs[1]):
        assert torch.equal(a, b)
    assert float(outs[0][3]) > 0 and np.isfinite(float(outs[0][2]))

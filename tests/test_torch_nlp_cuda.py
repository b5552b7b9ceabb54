"""The port's embeddings steps on a Hopper GPU (`cuda` marker; each test
skips itself without one). The CPU parity with the JAX package is in
tests/test_torch_nlp_learning.py and tests/test_torch_word2vec.py.

The card against the CPU from the same tables and the same draws: one
step of each objective at rtol 1e-5 / atol 1e-7 (index_add_ sums
duplicate rows in another order on the card), a corpus epoch at rtol
1e-4 / atol 1e-6; and neither a group of the batched path nor a corpus
epoch synchronises with the host (torch.cuda sync debug mode "error").

This file imports nothing of JAX, so it runs where JAX is not installed:
`python -m pytest --noconftest tests/test_torch_nlp_cuda.py`.
"""

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.nlp import Word2Vec
from deeplearning4j_tpu_torch.nlp import devicegen as dg
from deeplearning4j_tpu_torch.nlp import learning as ln

STEP_TOL = dict(rtol=1e-5, atol=1e-7)
FIT_TOL = dict(rtol=1e-4, atol=1e-6)
V, D, B, L, K = 500, 64, 1024, 12, 5


@pytest.fixture(autouse=True)
def _require_hopper():
    if not (torch.cuda.is_available()
            and torch.cuda.get_device_capability() >= (9, 0)):
        pytest.skip("needs an NVIDIA GPU of compute capability >= 9.0")
    torch.backends.cuda.matmul.allow_tf32 = False


def _tables(seed):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(n, D, generator=g) * 0.3 for n in (V, V - 1, V, 40)]


def _batch(seed, use_hs, negative, with_doc):
    rng = np.random.default_rng(seed)
    b = {"h_idx": rng.integers(0, V, (B, 6)).astype(np.int32),
         "h_mask": (rng.random((B, 6)) < 0.7).astype(np.int8),
         "row_mask": np.ones(B, np.int8)}
    if use_hs:
        b["points"] = rng.integers(0, V - 1, (B, L)).astype(np.int32)
        b["codes"] = rng.integers(0, 2, (B, L)).astype(np.int8)
        b["hs_mask"] = (np.arange(L)[None] < rng.integers(1, L + 1, B)[:, None]).astype(np.int8)
    if negative:
        b["pos"] = rng.integers(0, V, B).astype(np.int32)
        b["neg"] = rng.integers(0, V, (B, negative)).astype(np.int32)
    if with_doc:
        b["doc_idx"] = rng.integers(0, 40, B).astype(np.int32)
    return b


@pytest.mark.cuda
@pytest.mark.parametrize("use_hs,negative,with_doc",
                         [(True, 0, False), (False, K, False), (True, K, True)])
def test_one_step_on_the_card_matches_the_cpu(use_hs, negative, with_doc):
    flags = dict(use_hs=use_hs, negative=negative, with_doc=with_doc)
    batch = _batch(1, use_hs, negative, with_doc)
    out = {}
    for dev in ("cuda", "cpu"):
        tabs = [t.to(dev) for t in _tables(2)]
        out[dev] = ln.make_embedding_step(**flags)(*tabs, ln.batch_to_device(batch, dev), 0.05)
    for a, b in zip(out["cuda"], out["cpu"]):
        torch.testing.assert_close(a.cpu(), b, **STEP_TOL)


@pytest.mark.cuda
def test_corpus_epoch_on_the_card_matches_the_cpu_without_a_sync():
    window, negative, ppb = 5, K, 8192
    rng = np.random.default_rng(3)
    sents = [rng.integers(0, V, 40) for _ in range(300)]
    flat = dg.pack_corpus(sents, window)
    live = dg.live_length(flat)
    n_centers = ppb // (2 * window)
    g = torch.Generator().manual_seed(4)
    draws = [(torch.randint(0, window, (n_centers,), generator=g),
              torch.randint(0, 1000, (n_centers * 2 * window, negative), generator=g))
             for _ in range(-(-live // n_centers))]
    unigram = torch.from_numpy(rng.integers(0, V, 1000))
    step = dg.make_corpus_skipgram_step(negative=negative, window=window, pairs_per_batch=ppb)
    out = {}
    for dev in ("cuda", "cpu"):
        syn0, _, syn1neg, _ = (t.to(dev) for t in _tables(5))
        args = (syn0, syn1neg * 0.1, unigram.to(dev), torch.from_numpy(flat).to(dev).long(),
                0.025, 1e-4, float(live * 6), torch.zeros((), device=dev))
        if dev == "cuda":
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
        try:
            out[dev] = step(*args, live=live, draws=lambda i: draws[i])
        finally:
            torch.cuda.set_sync_debug_mode("default")
    for k in (0, 1):
        torch.testing.assert_close(out["cuda"][k].cpu(), out["cpu"][k], **FIT_TOL)
    torch.testing.assert_close(out["cuda"][2].cpu(), out["cpu"][2], rtol=1e-5, atol=0)
    assert float(out["cuda"][3]) == float(out["cpu"][3])


@pytest.mark.cuda
def test_a_group_of_the_batched_path_does_not_sync():
    S = 4
    group = {k: np.stack([_batch(10 + s, True, K, False)[k] for s in range(S)])
             for k in _batch(10, True, K, False)}
    del group["neg"]  # drawn on the card
    tabs = [t.cuda() for t in _tables(6)]
    step = ln.make_embedding_scan_step(use_hs=True, negative=K, with_doc=False)
    gen = torch.Generator(device="cuda").manual_seed(1)
    unigram = torch.arange(V, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        *_, loss = step(*tabs, unigram, ln.batch_to_device(group, "cuda"),
                        np.full(S, 0.025, np.float32), gen)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert np.isfinite(float(loss))


@pytest.mark.cuda
def test_word2vec_defaults_to_the_card():
    rng = np.random.default_rng(0)
    sents = [" ".join(rng.choice(["a", "b", "c", "d", "e", "f"], 8)) for _ in range(200)]
    w2v = Word2Vec.Builder().min_word_frequency(1).layer_size(16).epochs(3) \
        .iterate(sents).build()
    w2v.fit()
    assert w2v.device.type == "cuda" and w2v.lookup.syn0.is_cuda
    assert np.isfinite(w2v.last_loss) and len(w2v.words_nearest("a", 3)) == 3

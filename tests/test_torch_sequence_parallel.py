"""Sequence parallelism of the port (parallel/sequence.py): ring attention
on 4 gloo processes on the CPU, the key/value blocks passed round the ring
by point-to-point `ppermute`, against the JAX package's `full_attention`
(and its ring on 4 virtual CPU devices): values and the gradients of
sum(out^2) with respect to each rank's q, k and v blocks, causal and not,
f32 (rtol 2e-5 / atol 2e-6 on values, 5e-5 / 5e-6 on gradients, the JAX
tests' tolerances) and bf16 accumulating in f32 (the JAX test's
0.05 / 0.02 against f32 truth); and `ring_self_attention` with its
projections, values and input and weight gradients.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from deeplearning4j_tpu.parallel.sequence import full_attention

from tests import torch_parallel_workers as W
from tests.torch_dist import once, run_ranks

R = 4
B, T, H, D = 2, 16, 4, 8


def _qkv(seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((B, T, H, D)) * 0.5).astype(np.float32) for _ in range(3)]


def _proj(seed=1):
    rng = np.random.default_rng(seed)
    E, heads = 16, 4
    x = rng.standard_normal((B, T, E)).astype(np.float32)
    ws = [(rng.standard_normal((E, E)) * 0.2).astype(np.float32) for _ in range(4)]
    return x, ws, heads


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return once(tmp_path_factory, "ring", _runs)


def _runs():
    q, k, v = _qkv()
    x, ws, heads = _proj()
    ref = {}
    for causal in (False, True):
        def loss(q, k, v):
            return jnp.sum(jnp.square(full_attention(q, k, v, causal=causal)))

        ref[causal] = (np.asarray(full_attention(*map(jnp.asarray, (q, k, v)), causal=causal)),
                       [np.asarray(g) for g in jax.grad(loss, argnums=(0, 1, 2))(
                           *map(jnp.asarray, (q, k, v)))])

    def proj_loss(x, *ws):
        E = x.shape[-1]
        qq, kk, vv = ((x @ w).reshape(B, T, heads, E // heads) for w in ws[:3])
        out = full_attention(qq, kk, vv, causal=True).reshape(B, T, E) @ ws[3]
        return jnp.sum(jnp.square(out)), out

    (_, pout), pgrads = jax.value_and_grad(proj_loss, argnums=(0, 1, 2, 3, 4), has_aux=True)(
        jnp.asarray(x), *map(jnp.asarray, ws))
    ref["self"] = (np.asarray(pout), [np.asarray(g) for g in pgrads])
    return ref, run_ranks(W.ring_cases, R, q, k, v, (x, ws, heads))


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_ring_equals_full_attention(runs, causal):
    ref, ranks = runs
    key = f"{'causal' if causal else 'full'}_float32"
    for rec in ranks:
        np.testing.assert_allclose(rec[key]["out"], ref[causal][0], rtol=2e-5, atol=2e-6)


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_ring_gradients_equal_full_attention(runs, causal):
    """The gradients of each rank's q, k and v blocks: its own queries'
    terms, and its keys' and values' cotangents sent back round the ring
    by ppermute's backward."""
    ref, ranks = runs
    key = f"{'causal' if causal else 'full'}_float32"
    Tl = T // R
    for r, rec in enumerate(ranks):
        for got, want, name in zip(rec[key]["grads"], ref[causal][1], "qkv"):
            np.testing.assert_allclose(got, want[:, r * Tl:(r + 1) * Tl], rtol=5e-5,
                                       atol=5e-6, err_msg=f"d{name}")


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_ring_bf16_accumulates_f32(runs, causal):
    """bf16 blocks: the softmax statistics and sums accumulate in f32, so
    the ring stays within one bf16 rounding of the f32 truth."""
    ref, ranks = runs
    key = f"{'causal' if causal else 'full'}_bfloat16"
    for rec in ranks:
        np.testing.assert_allclose(rec[key]["out"], ref[causal][0], rtol=0.05, atol=0.02)
        assert all(np.isfinite(g).all() for g in rec[key]["grads"])


def test_ring_self_attention_projections(runs):
    ref, ranks = runs
    for rec in ranks:
        np.testing.assert_allclose(rec["self"]["out"], ref["self"][0], rtol=2e-5, atol=2e-6)


def test_ring_self_attention_gradients(runs):
    """x and the weights enter through copy_to_axis: their gradients are
    collected from every rank, whole on each."""
    ref, ranks = runs
    for rec in ranks:
        for got, want, name in zip(rec["self"]["grads"], ref["self"][1],
                                   ["x", "wq", "wk", "wv", "wo"]):
            np.testing.assert_allclose(got, want, rtol=5e-5, atol=5e-6, err_msg=f"d{name}")


def test_cpu_tensors_are_not_staged(runs):
    """Point-to-point on CPU tensors goes straight to gloo: nothing is
    staged through host memory (only CUDA tensors on gloo are)."""
    _, ranks = runs
    assert all(rec["staged_bytes"] == 0 for rec in ranks)

"""Pipeline parallelism of the port (parallel/pipeline.py): the GPipe tick
loop on gloo processes on the CPU (ppermute through point-to-point, psum
at the end) against the JAX package's `pipeline_apply` on as many virtual
CPU devices and its `sequential_apply`: values at (S, M) = (4, 4), (4, 2)
and (2, 8) to the JAX test's tolerance (rtol 1e-5, atol 1e-6), and each
stage's gradients of a squared loss (rtol 2e-5, atol 1e-6).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from deeplearning4j_tpu.parallel.pipeline import (
    pipeline_apply,
    pipeline_parallel_mesh,
    sequential_apply,
    shard_stage_params,
)

from tests import torch_parallel_workers as W
from tests.torch_dist import once, run_ranks


def _stage(params, x):
    return jnp.tanh(x @ params["W"] + params["b"])


def _stacked(S, D, seed):
    rng = np.random.default_rng(seed)
    return ((rng.standard_normal((S, D, D)) / np.sqrt(D)).astype(np.float32),
            (rng.standard_normal((S, D)) * 0.1).astype(np.float32))


# (S, M, D, B, seed, with gradients)
CASES = [(4, 4, 16, 32, 0, True), (4, 2, 16, 32, 1, False), (2, 8, 8, 16, 2, True)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return once(tmp_path_factory, "pipeline", _runs)


def _runs():
    out = {}
    for S in sorted({c[0] for c in CASES}):
        cases, refs = [], []
        for S_, M, D, B, seed, grads in CASES:
            if S_ != S:
                continue
            Wt, bt = _stacked(S, D, seed)
            rng = np.random.default_rng(seed + 10)
            x = rng.standard_normal((B, D)).astype(np.float32)
            y = rng.standard_normal((B, D)).astype(np.float32) if grads else None
            mesh = pipeline_parallel_mesh(jax.devices()[:S])
            params = shard_stage_params({"W": jnp.asarray(Wt), "b": jnp.asarray(bt)}, mesh)
            ref = {"pipe": np.asarray(pipeline_apply(_stage, params, jnp.asarray(x), mesh=mesh,
                                                     n_microbatches=M)),
                   "seq": np.asarray(sequential_apply(_stage, params, jnp.asarray(x)))}
            if grads:
                def loss(p):
                    out = pipeline_apply(_stage, p, jnp.asarray(x), mesh=mesh, n_microbatches=M)
                    return jnp.mean((out - jnp.asarray(y)) ** 2)

                g = jax.grad(loss)(params)
                ref["gW"], ref["gb"] = np.asarray(g["W"]), np.asarray(g["b"])
            cases.append((Wt, bt, x, y, M))
            refs.append(ref)
        out[S] = (refs, run_ranks(W.pipeline_cases, S, cases))
    return out


def _each():
    seen = {}
    for S, M, D, B, seed, grads in CASES:
        i = seen.get(S, 0)
        seen[S] = i + 1
        yield pytest.param(S, i, grads, id=f"S{S}-M{M}")


@pytest.mark.parametrize("S,i,grads", list(_each()))
def test_pipeline_matches_jax_and_sequential(runs, S, i, grads):
    refs, ranks = runs[S]
    for rec in ranks:
        got = rec["cases"][i]["out"]
        np.testing.assert_allclose(got, refs[i]["pipe"], rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got, refs[i]["seq"], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("S,i,grads", [p for p in _each() if p.values[2]])
def test_pipeline_gradients_match_jax(runs, S, i, grads):
    """Each rank's gradients are its stage's slice of the JAX package's
    stage-stacked gradients."""
    refs, ranks = runs[S]
    for s, rec in enumerate(ranks):
        got = rec["cases"][i]
        np.testing.assert_allclose(got["gW"], refs[i]["gW"][s:s + 1], rtol=2e-5, atol=1e-6)
        np.testing.assert_allclose(got["gb"], refs[i]["gb"][s:s + 1], rtol=2e-5, atol=1e-6)


def test_pipeline_batch_not_divisible_raises(runs):
    for S in runs:
        for rec in runs[S][1]:
            assert rec["indivisible"] and "not divisible" in rec["indivisible"]

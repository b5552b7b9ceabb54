"""The port's clustering stack (deeplearning4j_tpu_torch/clustering/) held
against the JAX package's on the CPU: the same points, made with numpy
from a seed, through both.

Tolerances:
  f32 blocks      rtol 1e-5, atol 1e-5 (euclidean: sqrt of the matmul
                  form's cancellation, ~sqrt(eps * ||x||^2), near 0)
  k-means centres rtol 1e-5 (the one-hot product, summed in another order)
  t-SNE P         1e-6 abs from the same d2; 1e-5 abs from the points (the
                  two matmuls part by an ulp of d2 ~ 1e3, which moves the
                  logits by ~1e-4)
  t-SNE loop      one step rtol 1e-5 with atol 1e-5 * max |Y| (the
                  gradient is a difference of two sums); 100 steps without exaggeration at
                  lr 1: Y 1e-4 abs (|Y| ~ 7), kl_ rtol 1e-5. With the 12x
                  exaggeration at lr 200 the loop is chaotic: the two
                  packages part by step 20 from the same P and y0, as
                  the JAX package does from itself under a change of
                  summation order; that case is held by its blob property.
"""

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.clustering import KDTree, KMeansClustering, Tsne, VPTree
from deeplearning4j_tpu_torch.clustering import distances as tdist
from deeplearning4j_tpu_torch.clustering import tsne as ttsne
from deeplearning4j_tpu_torch.clustering.distances import brute_force_knn

CPU = "cpu"


def _blobs(n_per=60, centers=((0, 0, 0), (8, 8, 8), (-8, 8, -8)), seed=0):
    rng = np.random.default_rng(seed)
    xs, ys = [], []
    for ci, c in enumerate(centers):
        xs.append(rng.normal(loc=c, scale=1.0, size=(n_per, len(c))))
        ys.append(np.full(n_per, ci))
    return np.concatenate(xs).astype(np.float32), np.concatenate(ys)


def _mixture(n=600, k=6, d=8, seed=0):
    rng = np.random.default_rng(seed)
    c = rng.normal(0, 5, (k, d))
    return (c[rng.integers(0, k, n)] + rng.normal(0, 1, (n, d))).astype(np.float32)


# -- distances ---------------------------------------------------------------

@pytest.mark.parametrize("distance", tdist.SUPPORTED)
def test_pairwise_matches_jax(distance):
    import jax.numpy as jnp

    from deeplearning4j_tpu.clustering.distances import pairwise

    rng = np.random.default_rng(1)
    x = rng.normal(size=(50, 8)).astype(np.float32)
    y = rng.normal(size=(30, 8)).astype(np.float32)
    want = np.asarray(pairwise(jnp.asarray(x), jnp.asarray(y), distance))
    got = tdist.pairwise(torch.as_tensor(x), torch.as_tensor(y), distance).numpy()
    assert got.shape == (50, 30)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert tdist.is_similarity(distance) == (distance in ("cosinesimilarity", "dot"))


def test_pairwise_rejects_unknown_distance():
    with pytest.raises(ValueError, match="unknown distance"):
        tdist.pairwise(torch.zeros(2, 2), torch.zeros(2, 2), "nope")


@pytest.mark.parametrize("distance", ["euclidean", "cosinesimilarity", "manhattan"])
def test_brute_force_knn_ties_rank_by_ascending_index(distance):
    """Duplicated points tie exactly; both packages put the lower index
    first, and a query against its own stored index ranks it first."""
    from deeplearning4j_tpu.clustering.distances import brute_force_knn as jknn

    x = _mixture(n=100)
    pts = np.concatenate([x, x])  # point i and i + 100 coincide
    q = pts[:20]
    ji, jd = jknn(pts, q, 7, distance)
    ti, td = brute_force_knn(pts, q, 7, distance, device=CPU)
    np.testing.assert_array_equal(ti, ji)
    assert ti.dtype == ji.dtype
    np.testing.assert_allclose(td, jd, rtol=1e-5, atol=1e-5)
    # the duplicate pair sits side by side, the lower index first
    assert (ti[:, 0] == np.arange(20)).all() and (ti[:, 1] == np.arange(20) + 100).all()


# -- k-means -----------------------------------------------------------------

@pytest.mark.parametrize("distance", ["euclidean", "cosinesimilarity", "manhattan",
                                      "sqeuclidean"])
def test_kmeans_matches_jax(distance):
    from deeplearning4j_tpu.clustering import KMeansClustering as JK

    x = _mixture()
    a = JK.setup(6, 50, distance, seed=2).apply_to(x)
    b = KMeansClustering.setup(6, 50, distance, seed=2, device=CPU).apply_to(x)
    assert b.iterations == a.iterations
    np.testing.assert_array_equal(b.assignments, a.assignments)
    np.testing.assert_allclose(b.centers, a.centers, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(b.distances, a.distances, rtol=1e-5, atol=1e-4)
    assert b.distance_function == distance


def test_kmeans_random_init_matches_jax():
    from deeplearning4j_tpu.clustering import KMeansClustering as JK

    x = _mixture(seed=4)
    a = JK(6, 30, seed=5, init="random").apply_to(x)
    b = KMeansClustering(6, 30, seed=5, init="random", device=CPU).apply_to(x)
    assert b.iterations == a.iterations
    np.testing.assert_array_equal(b.assignments, a.assignments)
    np.testing.assert_allclose(b.centers, a.centers, rtol=1e-5, atol=1e-6)


def test_kmeans_two_runs_bit_equal():
    x = _mixture(seed=6)
    a = KMeansClustering.setup(6, 20, seed=1, device=CPU).apply_to(x)
    b = KMeansClustering.setup(6, 20, seed=1, device=CPU).apply_to(x)
    assert np.array_equal(a.centers, b.centers) and np.array_equal(a.assignments, b.assignments)


def test_kmeans_recovers_blobs():
    x, y = _blobs()
    cs = KMeansClustering.setup(3, 50, "euclidean", seed=3, device=CPU).apply_to(x)
    mapping = {}
    for ci in range(3):
        assigned = cs.assignments[y == ci]
        top = np.bincount(assigned, minlength=3).argmax()
        assert np.mean(assigned == top) > 0.95
        mapping[ci] = top
    assert len(set(mapping.values())) == 3
    assert cs.iterations <= 50
    assert len(cs.clusters) == 3
    assert sum(c.count for c in cs.clusters) == x.shape[0]


def test_kmeans_cosine_spherical():
    rng = np.random.default_rng(7)
    dirs = np.array([[1.0, 0.0], [0.0, 1.0], [-1.0, 0.0]])
    x = np.concatenate([
        d[None, :] * rng.uniform(0.5, 5.0, (40, 1)) + 0.02 * rng.standard_normal((40, 2))
        for d in dirs
    ]).astype(np.float32)
    cs = KMeansClustering.setup(3, 50, "cosinesimilarity", seed=1, device=CPU).apply_to(x)
    labels = np.repeat(np.arange(3), 40)
    for ci in range(3):
        assigned = cs.assignments[labels == ci]
        assert np.mean(assigned == np.bincount(assigned, minlength=3).argmax()) > 0.95
    np.testing.assert_allclose(np.linalg.norm(cs.centers, axis=1), 1.0, atol=1e-5)


def test_kmeans_nearest_cluster_and_validation():
    from deeplearning4j_tpu.clustering import KMeansClustering as JK

    x, _ = _blobs(n_per=20)
    cs = KMeansClustering.setup(3, 30, device=CPU).apply_to(x)
    jcs = JK.setup(3, 30).apply_to(x)
    for i in (0, 25, 59):
        assert cs.nearest_cluster(x[i]) == cs.assignments[i] == jcs.nearest_cluster(x[i])
    with pytest.raises(ValueError):
        KMeansClustering.setup(99, 5, device=CPU).apply_to(x[:10])
    with pytest.raises(ValueError):
        KMeansClustering(3, distance_function="nope", device=CPU)
    with pytest.raises(ValueError):
        KMeansClustering(3, distance_function="dot", device=CPU)


# -- trees -------------------------------------------------------------------

@pytest.mark.parametrize("distance,invert", [("euclidean", False), ("manhattan", False),
                                             ("cosinesimilarity", False), ("dot", False),
                                             ("euclidean", True)])
def test_vptree_matches_jax(distance, invert):
    """The tree path (euclidean, manhattan: built from the same seed, the
    same search) and the flat device path (cosine, dot, invert)."""
    from deeplearning4j_tpu.clustering import VPTree as JV

    rng = np.random.default_rng(1)
    pts = rng.standard_normal((2500, 16)).astype(np.float32)
    jt = JV(pts, distance, invert=invert, brute_force_threshold=100, seed=3)
    tt = VPTree(pts, distance, invert=invert, brute_force_threshold=100, seed=3, device=CPU)
    assert (tt.root is None) == (jt.root is None)
    for qi in (0, 57, 2499):
        ji, jd = jt.search(pts[qi], 10)
        ti, td = tt.search(pts[qi], 10)
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_allclose(td, jd, rtol=1e-5, atol=1e-5)


def test_vptree_matches_brute_force_and_inverts():
    rng = np.random.default_rng(8)
    pts = rng.standard_normal((3000, 16)).astype(np.float32)
    tree = VPTree(pts, "euclidean", brute_force_threshold=100, device=CPU)
    for qi in (0, 57, 2999):
        idx, dist = tree.search(pts[qi], 10)
        _, bdist = brute_force_knn(pts, pts[qi][None, :], 10, "euclidean", device=CPU)
        np.testing.assert_allclose(np.sort(dist), np.sort(bdist[0]), rtol=2e-4, atol=5e-3)
        assert idx[0] == qi
    small = pts[:200, :4]
    near = VPTree(small, "euclidean", device=CPU).search(small[0], 200)[0]
    far = VPTree(small, "euclidean", invert=True, device=CPU).search(small[0], 200)[0]
    assert near[0] == 0 and far[-1] == 0
    assert list(near) == list(far[::-1])


def test_vptree_flat_path_keeps_points_resident():
    rng = np.random.default_rng(2)
    pts = rng.standard_normal((100, 8)).astype(np.float32)
    tree = VPTree(pts, "euclidean", device=CPU)
    assert tree.brute and torch.is_tensor(tree._points_dev)
    assert tree._points_dev.device.type == "cpu"
    idx, _ = tree.search(pts[5], 4)
    bidx, _ = brute_force_knn(pts, pts[5][None, :], 4, "euclidean", device=CPU)
    np.testing.assert_array_equal(idx, bidx[0])


def test_kdtree_matches_jax():
    from deeplearning4j_tpu.clustering import KDTree as JKD

    rng = np.random.default_rng(3)
    pts = rng.standard_normal((2000, 3)).astype(np.float32)
    a, b = JKD(pts), KDTree(pts)
    for qi in (1, 500, 1999):
        ji, jd = a.knn(pts[qi], 8)
        ti, td = b.knn(pts[qi], 8)
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_array_equal(td, jd)
        _, bdist = brute_force_knn(pts, pts[qi][None, :], 8, "euclidean", device=CPU)
        np.testing.assert_allclose(np.sort(td), np.sort(bdist[0]), rtol=1e-4, atol=1e-3)


# -- t-SNE -------------------------------------------------------------------

def _tsne_points():
    rng = np.random.default_rng(0)
    return np.concatenate([rng.normal(c, 1.0, (20, 5)) for c in (0, 6, -6)]).astype(np.float32)


def test_tsne_perplexity_search_matches_jax():
    import jax.numpy as jnp

    from deeplearning4j_tpu.clustering import tsne as jt

    x = _tsne_points()
    n = x.shape[0]
    d2 = jt._pairwise_sq(jnp.asarray(x))
    target = np.log2(10.0)
    pj = np.asarray(jt._binary_search_beta(d2, jnp.full((n,), target)))
    pt = ttsne._binary_search_beta(torch.tensor(np.asarray(d2)),
                                  torch.full((n,), float(target))).numpy()
    np.testing.assert_allclose(pt, pj, rtol=0, atol=1e-6)
    np.testing.assert_allclose(pt.sum(axis=1), 1.0, rtol=1e-5)
    # from the points: d2's matmul parts by an ulp at |d2| ~ 1e3
    psym_t = ttsne._joint_probabilities(torch.as_tensor(x), 10.0).numpy()
    psym_j = (pj + pj.T) / (2.0 * n)
    np.testing.assert_allclose(psym_t, psym_j, rtol=0, atol=1e-5)


def test_tsne_one_step_matches_jax():
    import jax
    import jax.numpy as jnp

    from deeplearning4j_tpu.clustering import tsne as jt

    x = _tsne_points()
    n = x.shape[0]
    d2 = jt._pairwise_sq(jnp.asarray(x))
    p = jt._binary_search_beta(d2, jnp.full((n,), np.log2(10.0)))
    ps = np.asarray((p + p.T) / (2.0 * n))
    y0 = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (n, 2)))
    for stop in (0, 250):
        yj = np.asarray(jt._tsne_run(jnp.asarray(ps), jnp.asarray(y0), 1, stop, stop, 200.0))
        yt = ttsne._tsne_run(torch.as_tensor(ps), torch.as_tensor(y0), 1, stop, stop,
                             200.0).numpy()
        # the gradient is a difference of two sums (rowsum * y - PQ @ y):
        # its rounding is relative to the step's scale, not to each entry
        np.testing.assert_allclose(yt, yj, rtol=1e-5, atol=1e-5 * np.abs(yj).max())


def test_tsne_100_steps_match_jax_from_the_jax_draw():
    import jax
    import jax.numpy as jnp

    from deeplearning4j_tpu.clustering import tsne as jt

    x = _tsne_points()
    n = x.shape[0]
    y0 = np.asarray(1e-4 * jax.random.normal(jax.random.PRNGKey(3), (n, 2)))
    ref = jt.Tsne(perplexity=10.0, learning_rate=1.0, n_iter=100, stop_lying_iteration=0,
                  momentum_switch_iteration=0, seed=3)
    yj = ref.fit_transform(x)
    port = Tsne(perplexity=10.0, learning_rate=1.0, n_iter=100, stop_lying_iteration=0,
                momentum_switch_iteration=0, seed=3, device=CPU)
    yt = port.fit_transform(x, y0=y0)
    assert np.abs(yj).max() > 1.0  # the embedding moved
    np.testing.assert_allclose(yt, yj, rtol=0, atol=1e-4)
    np.testing.assert_allclose(port.kl_, ref.kl_, rtol=1e-5)


def test_tsne_initial_draw_is_seeded():
    x = _tsne_points()
    a = Tsne(perplexity=10.0, n_iter=5, seed=7, device=CPU).fit_transform(x)
    b = Tsne(perplexity=10.0, n_iter=5, seed=7, device=CPU).fit_transform(x)
    c = Tsne(perplexity=10.0, n_iter=5, seed=8, device=CPU).fit_transform(x)
    assert np.array_equal(a, b) and not np.array_equal(a, c)
    with pytest.raises(ValueError, match="perplexity"):
        Tsne(perplexity=60.0, device=CPU).fit_transform(x)


def test_tsne_separates_blobs():
    """The JAX test's case, from the JAX test's own initial embedding (the
    draw of PRNGKey(4)): the separation is a property of where the chaotic
    exaggeration phase lands, marginal in both packages (the JAX package
    itself reaches 1.7x the spread, not 2x, from PRNGKey(1))."""
    import jax

    x, y = _blobs(n_per=40)
    y0 = np.asarray(1e-4 * jax.random.normal(jax.random.PRNGKey(4), (x.shape[0], 2)))
    ts = Tsne(perplexity=15, n_iter=500, stop_lying_iteration=100,
              momentum_switch_iteration=100, seed=4, device=CPU)
    emb = ts.fit_transform(x, y0=y0)
    assert emb.shape == (x.shape[0], 2)
    assert np.isfinite(emb).all() and np.isfinite(ts.kl_)
    cents = np.stack([emb[y == c].mean(axis=0) for c in range(3)])
    spread = max(float(emb[y == c].std()) for c in range(3))
    min_sep = min(float(np.linalg.norm(cents[i] - cents[j]))
                  for i in range(3) for j in range(i + 1, 3))
    assert min_sep > 2.0 * spread


# -- device default ------------------------------------------------------------

def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    from deeplearning4j_tpu_torch.serving import NearestNeighborsServer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pts = _mixture(n=50)
    for make in (lambda: Tsne(), lambda: KMeansClustering(3), lambda: VPTree(pts),
                 lambda: brute_force_knn(pts, pts[:2], 3),
                 lambda: NearestNeighborsServer(pts, port=0)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
    # KDTree is host numpy: no device to choose
    assert KDTree(pts).knn(pts[0], 1)[0][0] == 0

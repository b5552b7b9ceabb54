"""The port's REST k-NN server (serving/knnserver.py) against the JAX
package's on the same points: every route's JSON is the JAX server's
(indices equal, distances rtol 1e-5; atol 2e-3 covers the flat path's
matmul form at distance 0, where ||x||^2 + ||y||^2 - 2 x.y cancels to
~eps * ||x||^2 and its sqrt to ~1e-3 — 9.8e-4 in the JAX package and 0 in
the port for a point against itself), on the tree path and the flat device path,
and the 400s and 404s are the same."""

import json
import urllib.error
import urllib.request

import numpy as np
import pytest

from deeplearning4j_tpu_torch.clustering.distances import brute_force_knn
from deeplearning4j_tpu_torch.serving import NearestNeighborsServer
from deeplearning4j_tpu_torch.serving import knnserver


def _post(port, route, payload):
    """(status, JSON) of a POST; a 4xx answers with its JSON too."""
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{route}",
        data=payload if isinstance(payload, bytes) else json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _get(port, route):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{route}") as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


@pytest.fixture(params=[("euclidean", False, 300), ("euclidean", False, 3000),
                        ("cosinesimilarity", False, 3000), ("euclidean", True, 300)],
                ids=["flat", "tree", "cosine-flat", "invert"])
def pair(request):
    """A JAX server and a port server over the same points."""
    from deeplearning4j_tpu.serving.knnserver import NearestNeighborsServer as JServer

    distance, invert, n = request.param
    pts = np.random.default_rng(5).standard_normal((n, 8)).astype(np.float32)
    js = JServer(pts, distance, invert, port=0)
    ts = NearestNeighborsServer(pts, distance, invert, port=0, device="cpu")
    jp, tp = js.start(), ts.start()
    try:
        yield pts, jp, tp, ts
    finally:
        js.stop()
        ts.stop()


def _same_results(got, want):
    assert [r["index"] for r in got["results"]] == [r["index"] for r in want["results"]]
    np.testing.assert_allclose([r["distance"] for r in got["results"]],
                               [r["distance"] for r in want["results"]], rtol=1e-5, atol=2e-3)
    assert set(got) == set(want) and all(set(r) == {"index", "distance"}
                                         for r in got["results"])


@pytest.mark.parametrize("index", [0, 17, 299])
def test_knn_by_index_matches_jax(pair, index):
    pts, jp, tp, ts = pair
    want = _post(jp, "/knn", {"k": 5, "inputIndex": index})
    got = _post(tp, "/knn", {"k": 5, "inputIndex": index})
    assert got[0] == want[0] == 200
    _same_results(got[1], want[1])
    if not ts.tree.descending:
        assert got[1]["results"][0]["index"] == index


def test_knnvector_matches_jax(pair):
    pts, jp, tp, _ = pair
    rng = np.random.default_rng(9)
    for v in (pts[42], rng.standard_normal(8).astype(np.float32)):
        want = _post(jp, "/knnvector", {"k": 3, "vector": v.tolist()})
        got = _post(tp, "/knnvector", {"k": 3, "vector": v.tolist()})
        assert got[0] == want[0] == 200
        _same_results(got[1], want[1])


def test_health_matches_jax(pair):
    pts, jp, tp, _ = pair
    assert _get(tp, "/health") == _get(jp, "/health") == (200, {"status": "ok",
                                                              "points": pts.shape[0]})


@pytest.mark.parametrize("route,payload", [
    ("/knn", {"k": 3, "inputIndex": 10**6}),
    ("/knn", {"k": 3, "inputIndex": -1}),
    ("/knnvector", {"k": 3, "vector": [1.0, 2.0]}),
    ("/knn", {"inputIndex": 1}),
    ("/knn", b"{not json"),
])
def test_bad_requests_answer_400_as_jax(pair, route, payload):
    _, jp, tp, _ = pair
    want = _post(jp, route, payload)
    got = _post(tp, route, payload)
    assert got[0] == want[0] == 400
    assert set(got[1]) == set(want[1]) == {"error"}


def test_unknown_routes_answer_404_as_jax(pair):
    _, jp, tp, _ = pair
    assert _post(tp, "/nope", {}) == _post(jp, "/nope", {})
    assert _get(tp, "/nope") == _get(jp, "/nope")
    assert _get(tp, "/nope")[0] == 404


def test_answers_equal_brute_force(pair):
    pts, _, tp, ts = pair
    if ts.tree.descending:
        return  # invert ranks the farthest first: brute force ranks nearest
    for qi in (3, 150):
        got = _post(tp, "/knn", {"k": 10, "inputIndex": qi})[1]
        bidx, bdist = brute_force_knn(pts, pts[qi][None, :], 10, ts.tree.distance, device="cpu")
        assert [r["index"] for r in got["results"]] == bidx[0].tolist()
        np.testing.assert_allclose([r["distance"] for r in got["results"]], bdist[0],
                                   rtol=1e-5, atol=2e-3)


def test_main_builds_on_the_requested_device(tmp_path, monkeypatch):
    """The CLI takes the reference's flags and --device; without a GPU and
    without --device it raises rather than run on the CPU."""
    import torch

    path = str(tmp_path / "pts.npy")
    np.save(path, np.random.default_rng(1).standard_normal((20, 4)).astype(np.float32))
    started = {}

    class Stop(Exception):
        pass

    def fake_start(self):
        started["device"] = self.tree.device.type
        raise Stop

    monkeypatch.setattr(knnserver.NearestNeighborsServer, "start", fake_start)
    with pytest.raises(Stop):
        knnserver.main(["--ndarrayPath", path, "--nearestNeighborsPort", "0",
                        "--device", "cpu"])
    assert started["device"] == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        knnserver.main(["--ndarrayPath", path, "--nearestNeighborsPort", "0"])

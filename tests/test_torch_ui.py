"""The port's training UI (deeplearning4j_tpu_torch/ui/) against the JAX
package's on the CPU: the codec's bytes, the file and SQLite stores (each
package reads the other's), StatsListener and the conv-activation
listener on LeNet with the JAX parameters carried across, every dashboard
route's JSON for the same storage, the remote router across packages, and
the health history on the port's listeners.

Tolerances: the mean magnitudes and score rtol 1e-5 (f32 reductions of
one step's tensors, summed in another order); histogram counts equal and
edges rtol 1e-6 of the range (an edge near 0 held to 1e-6 of the largest
edge); the activation grid 1e-3 abs (its values are rounded to
3 places, so a rounding edge can move one step).
"""

import json
import struct
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.ui import (
    ConvolutionalIterationListener,
    FileStatsStorage,
    InMemoryStatsStorage,
    RemoteUIStatsStorageRouter,
    SqliteStatsStorage,
    StatsListener,
    UIServer,
)
from deeplearning4j_tpu_torch.ui import stats as tstats
from deeplearning4j_tpu_torch.ui.codec import decode_record, encode_record

from torch_parity import port_twin

RECORD = {
    "iteration": 42, "ts": 123.5, "score": 0.75, "etl_ms": 1.5,
    "samples_per_sec": 1000.0, "epoch": 3,
    "grad_mm": {"0_W": 0.5, "0_b": 0.25},
    "hist": [1.0, 2.0, 3.0],
    "hists": {"0_W": {"edges": [0.0, 0.5, 1.0], "counts": [3, 7]}},
    "memory": {"device0": {"bytes_in_use": 1024, "bytes_limit": 4096}},
    "name": "dropped",
}


def _record(i):
    return {"iteration": i, "ts": float(i), "score": float(i) * 0.5,
            "samples_per_sec": 10.0, "etl_ms": 1.0}


def _xy(n, seed):
    rng = np.random.default_rng(seed)
    x = rng.random((n, 784), np.float32)
    y = np.zeros((n, 10), np.float32)
    y[np.arange(n), rng.integers(0, 10, n)] = 1.0
    return x, y


# -- codec -------------------------------------------------------------------

def test_codec_bytes_equal_jax_and_cross_decode():
    from deeplearning4j_tpu.ui import codec as jcodec

    ours, theirs = encode_record(RECORD), jcodec.encode_record(RECORD)
    assert ours == theirs
    assert decode_record(theirs) == jcodec.decode_record(ours) == decode_record(ours)
    out = decode_record(ours)
    assert out["iteration"] == 42 and out["epoch"] == 3.0
    assert out["grad_mm"]["0_W"] == 0.5 and out["hist"] == [1.0, 2.0, 3.0]
    assert "name" not in out


def test_codec_rejects_bad_magic_and_version():
    data = bytearray(encode_record(RECORD))
    with pytest.raises(ValueError, match="magic"):
        decode_record(b"\x00\x00" + bytes(data[2:]))
    struct.pack_into("<H", data, 2, 9)
    with pytest.raises(ValueError, match="version"):
        decode_record(bytes(data))


# -- storages ----------------------------------------------------------------

def _fill(store, n=12):
    store.put_static_info("s", {"model_class": "M", "total_params": 3, "start_time": 1.0})
    for i in range(n):
        store.put_update("s", {**_record(i), "grad_mm": {"0_W": 1.0 / (i + 1)}})
    store.put_update("t", _record(0))


def _same_contents(a, b):
    assert a.list_session_ids() == b.list_session_ids()
    for sid in a.list_session_ids():
        assert a.get_static_info(sid) == b.get_static_info(sid)
        assert a.get_updates(sid) == b.get_updates(sid)
        assert a.get_updates(sid, since_iteration=5) == b.get_updates(sid, since_iteration=5)
    assert a.latest_session_id() == b.latest_session_id()


@pytest.mark.parametrize("kind", ["file", "sqlite"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_stores_read_the_other_packages_files(tmp_path, kind, writer):
    from deeplearning4j_tpu.ui import storage as jst

    cls = {"file": (jst.FileStatsStorage, FileStatsStorage),
           "sqlite": (jst.SqliteStatsStorage, SqliteStatsStorage)}[kind]
    wcls, rcls = (cls[0], cls[1]) if writer == "jax" else (cls[1], cls[0])
    path = str(tmp_path / f"stats.{kind}")
    w = wcls(path)
    _fill(w)
    if kind == "sqlite":
        w.close()
    if kind == "file":
        with open(path, "rb") as f:
            written = f.read()
        other = str(tmp_path / "other.file")
        _fill(cls[1 if writer == "jax" else 0](other))
        with open(other, "rb") as f:
            assert f.read() == written  # the same bytes from either package
    r, again = rcls(path), wcls(path)
    _same_contents(r, again)
    assert len(r.get_updates("s")) == 12
    if kind == "sqlite":
        r.close()
        again.close()


@pytest.mark.parametrize("store_kind", ["file", "sqlite"])
def test_stats_storage_retention_consistent(tmp_path, store_kind):
    """The JAX package's retention case, on the port's stores, and the
    capped store's rows equal the JAX store's fed the same records."""
    from deeplearning4j_tpu.ui import storage as jst

    cap = 20
    make = {"file": (FileStatsStorage, jst.FileStatsStorage),
            "sqlite": (SqliteStatsStorage, jst.SqliteStatsStorage)}[store_kind]
    path = str(tmp_path / f"stats_{store_kind}.bin")
    store = make[0](path, max_updates_per_session=cap)
    twin = make[1](str(tmp_path / f"jax_{store_kind}.bin"), max_updates_per_session=cap)
    for s in (store, twin):
        s.put_static_info("s", {"start_time": 0.0})
        for i in range(100):
            s.put_update("s", _record(i))
    ups = store.get_updates("s")
    assert ups == twin.get_updates("s")
    assert len(ups) <= cap + cap // 2
    its = [u["iteration"] for u in ups]
    assert its == sorted(set(its))
    assert its[-1] == 99
    assert its[-cap // 2:] == list(range(100 - cap // 2, 100))
    recent = store.get_updates("s", since_iteration=90)
    assert [u["iteration"] for u in recent] == list(range(91, 100))
    if store_kind == "file":
        again = FileStatsStorage(path, max_updates_per_session=cap)
    else:
        store.close()
        twin.close()
        again = SqliteStatsStorage(path, max_updates_per_session=cap)
    re_its = [u["iteration"] for u in again.get_updates("s")]
    assert len(re_its) <= cap + cap // 2
    assert set(re_its) <= set(its)
    assert re_its == sorted(set(re_its))
    assert re_its[-cap // 2:] == its[-cap // 2:]
    if store_kind == "sqlite":
        again.close()
    with pytest.raises(ValueError):
        make[0](str(tmp_path / "tiny.bin"), max_updates_per_session=1)


def test_stats_storage_uncapped_unchanged(tmp_path):
    store = FileStatsStorage(str(tmp_path / "u.bin"))
    for i in range(50):
        store.put_update("s", _record(i))
    assert len(store.get_updates("s")) == 50


def test_in_memory_storage_and_listeners():
    s = InMemoryStatsStorage()
    seen = []
    s.register_listener(lambda sid, rec: seen.append((sid, rec["iteration"])))
    _fill(s, n=3)
    assert s.list_session_ids() == ["s", "t"]
    assert [u["iteration"] for u in s.get_updates("s", since_iteration=0)] == [1, 2]
    assert seen[:3] == [("s", 0), ("s", 1), ("s", 2)]
    assert s.latest_session_id() == "s"  # newest update ts: s's iteration 2


# -- StatsListener and the conv-activation listener on LeNet ------------------

@pytest.fixture(scope="module")
def lenet_runs(tmp_path_factory):
    """LeNet in both packages from the same weights, 3 steps of batch 8
    with StatsListener (histograms every report) and the activation
    listener into an in-memory store each."""
    from deeplearning4j_tpu.models.lenet import lenet_conf
    from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu.ui import ConvolutionalIterationListener as JC
    from deeplearning4j_tpu.ui import InMemoryStatsStorage as JS
    from deeplearning4j_tpu.ui import StatsListener as JL

    jnet = MultiLayerNetwork(lenet_conf()).init()
    tnet = port_twin(jnet, tmp_path_factory.mktemp("twin"))
    x, y = _xy(24, 0)
    out = {}
    for name, net, S, L, C in (("jax", jnet, JS, JL, JC),
                               ("port", tnet, InMemoryStatsStorage, StatsListener,
                                ConvolutionalIterationListener)):
        st = S()
        net.set_collect_stats(True)
        net.set_listeners(L(st, session_id="s", report_memory=False, histogram_bins=20,
                            histogram_frequency=1),
                          C(st, "s", frequency=1, max_channels=4, max_hw=8))
        net.fit(x, y, batch_size=8, epochs=1, async_prefetch=False)
        out[name] = (net, st)
    return out


def _pairs(lenet_runs, key):
    ju = [u for u in lenet_runs["jax"][1].get_updates("s") if key in u]
    tu = [u for u in lenet_runs["port"][1].get_updates("s") if key in u]
    assert len(ju) == len(tu) == 3
    return list(zip(ju, tu))


def test_stats_listener_mean_magnitudes_match_jax(lenet_runs):
    for a, b in _pairs(lenet_runs, "score"):
        assert b["iteration"] == a["iteration"] and b["epoch"] == a["epoch"]
        np.testing.assert_allclose(b["score"], a["score"], rtol=1e-5)
        for group in ("grad_mm", "update_mm", "param_mm"):
            assert list(b[group]) == list(a[group])
            for k in a[group]:
                np.testing.assert_allclose(b[group][k], a[group][k], rtol=1e-5,
                                           err_msg=f"{group} {k}")
        assert set(b) == set(a)


def test_stats_listener_histograms_match_jax(lenet_runs):
    tnet = lenet_runs["port"][0]
    for a, b in _pairs(lenet_runs, "hists"):
        assert list(b["hists"]) == list(a["hists"])
        for k, h in a["hists"].items():
            assert b["hists"][k]["counts"] == h["counts"], k
            # edges are min + i (max - min) / bins: their rounding is
            # relative to the range, so an edge near 0 is held absolutely
            np.testing.assert_allclose(b["hists"][k]["edges"], h["edges"], rtol=1e-6,
                                       atol=1e-6 * np.abs(h["edges"]).max())
    last = _pairs(lenet_runs, "hists")[-1][1]["hists"]
    for li, p in enumerate(tnet.params_list):
        for name, v in p.items():
            assert sum(last[f"{li}_{name}"]["counts"]) == v.numel()


def test_stats_listener_static_info_matches_jax(lenet_runs):
    a = lenet_runs["jax"][1].get_static_info("s")
    b = lenet_runs["port"][1].get_static_info("s")
    assert set(b) == set(a)
    for k in ("model_class", "layers", "total_params", "graph", "backend", "device"):
        assert b[k] == a[k], k
    assert b["backend"] == "cpu" and b["n_devices"] == 1


def test_conv_listener_grid_matches_jax(lenet_runs):
    for a, b in _pairs(lenet_runs, "activations"):
        assert b["activations"]["layer"] == a["activations"]["layer"] == 0
        ga, gb = np.asarray(a["activations"]["channels"]), np.asarray(b["activations"]["channels"])
        assert gb.shape == ga.shape == (4, 8, 8)  # [C][H][W] of the NHWC map
        np.testing.assert_allclose(gb, ga, rtol=0, atol=1e-3)
        assert gb.min() >= 0.0 and gb.max() <= 1.0


def test_conv_listener_grid_is_hwc_without_a_permute():
    """The grid is the first conv layer's NHWC activations as they come:
    channel c of the grid is activations[0, ::s, ::s, c] rescaled."""
    from deeplearning4j_tpu_torch.models.lenet import lenet_network

    net = lenet_network(device="cpu")
    st = InMemoryStatsStorage()
    lst = ConvolutionalIterationListener(st, "s", frequency=1, max_channels=3, max_hw=12)
    x, y = _xy(8, 3)

    class Batch:
        features = x

    lst.iteration_done(net, 0, {"batch": lambda: Batch})
    acts, _ = net._forward(net.params_list, net.state_list, torch.as_tensor(x[:1]),
                           training=False, rng=None, to_layer=1)
    a = acts.detach().numpy()[0]
    assert a.shape == (24, 24, 20)
    a = a[::2, ::2, :3]
    a = (a - a.min()) / (a.max() - a.min())
    grid = np.asarray(st.get_updates("s")[0]["activations"]["channels"])
    np.testing.assert_allclose(grid, np.moveaxis(a, -1, 0).round(3), atol=1e-3)


def test_stats_listener_reads_each_report_back_in_few_copies(monkeypatch):
    """One copy for the mean magnitudes and one for the histograms, where
    a read per leaf would take one per tensor."""
    from deeplearning4j_tpu_torch.models.lenet import lenet_network

    calls = []
    orig = torch.Tensor.cpu

    def counting_cpu(self, *a, **k):
        calls.append(tuple(self.shape))
        return orig(self, *a, **k)

    net = lenet_network(device="cpu")
    net.set_collect_stats(True)
    st = InMemoryStatsStorage()
    net.set_listeners(StatsListener(st, session_id="s", histogram_bins=8, histogram_frequency=2))
    x, y = _xy(16, 1)
    monkeypatch.setattr(torch.Tensor, "cpu", counting_cpu)
    net.fit(x, y, batch_size=8, epochs=1, async_prefetch=False)
    monkeypatch.setattr(torch.Tensor, "cpu", orig)
    n_leaves = sum(len(p) for p in net.params_list)
    # report 1: the stacked magnitudes + the concatenated leaves; report 2:
    # the magnitudes only
    assert calls.count((3 * n_leaves,)) == 2
    assert calls.count((sum(v.numel() for p in net.params_list for v in p.values()),)) == 1
    assert len(calls) == 3
    ups = st.get_updates("s")
    assert "hists" in ups[0] and "hists" not in ups[1]


def test_device_memory_stats_on_the_cpu_is_empty():
    assert tstats._device_memory_stats() == {}


# -- the dashboard -------------------------------------------------------------

ROUTES = ["/train/overview/data", "/train/histogram/data", "/train/activations/data",
          "/train/model/data", "/train/model/graph", "/train/flow/data",
          "/train/system/data", "/train/alerts/data", "/train/sessions/current",
          "/train/sessions/all", "/tsne/data", "/train/tsne/data"]
PAGES = ["/", "/train", "/train/overview", "/train/model", "/train/system",
         "/train/histogram", "/train/activations", "/train/flow", "/train/alerts",
         "/tsne", "/train/tsne"]


@pytest.fixture(scope="module")
def both_servers(lenet_runs):
    """A JAX UIServer and a port UIServer over stores holding the same
    records (the JAX run's, copied into each package's store)."""
    from deeplearning4j_tpu.ui import InMemoryStatsStorage as JS
    from deeplearning4j_tpu.ui import UIServer as JUI

    src = lenet_runs["jax"][1]
    stores = (JS(), InMemoryStatsStorage())
    for st in stores:
        st.put_static_info("s", src.get_static_info("s"))
        for u in src.get_updates("s"):
            st.put_update("s", {**u, "memory": {"device0": {"bytes_in_use": 5,
                                                            "bytes_limit": 9}}})
    return JUI(stores[0], port=0), UIServer(stores[1], port=0, device="cpu")


def _route(ui, route, method="get", body=b""):
    resp = getattr(ui, f"_{method}")(route, body, {})
    assert resp is not None, route
    return resp[0], json.loads(resp[2].decode())


@pytest.mark.parametrize("route", ROUTES)
def test_every_data_route_matches_jax(both_servers, route):
    jui, tui = both_servers
    (jc, jd), (tc, td) = _route(jui, route), _route(tui, route)
    assert tc == jc == 200
    if route == "/train/system/data":
        assert set(td) == set(jd)
        jd.pop("live"), td.pop("live")  # each package's own registry
    assert td == jd


@pytest.mark.parametrize("page", PAGES)
def test_every_page_matches_jax(both_servers, page):
    jui, tui = both_servers
    assert tui._get(page, b"", {}) == jui._get(page, b"", {})


def test_unknown_routes_are_404_as_jax(both_servers):
    jui, tui = both_servers
    assert tui._get("/nope", b"", {}) is None and jui._get("/nope", b"", {}) is None
    assert tui._post("/nope", b"{}", {}) is None and jui._post("/nope", b"{}", {}) is None


def test_tsne_upload_escapes_and_matches_jax(both_servers):
    jui, tui = both_servers
    body = json.dumps({"coords": [[0, 1], [2.5, 3]],
                       "words": ["<b>x</b>", "y&z"]}).encode()
    for ui in both_servers:
        assert _route(ui, "/tsne/upload", "post", body) == (200, {"status": "ok"})
    assert _route(tui, "/tsne/data") == _route(jui, "/tsne/data")
    assert _route(tui, "/tsne/data")[1]["words"] == ["&lt;b&gt;x&lt;/b&gt;", "y&amp;z"]


@pytest.mark.parametrize("body", [b"{not json", b'{"coords": [[1]]}', b'{"words": []}',
                                  b'{"vectors": [[1, 2], [3, 4]], "perplexity": 5}'])
def test_bad_posts_answer_400_as_jax(both_servers, body):
    jui, tui = both_servers
    for route in ("/tsne/upload", "/tsne/compute"):
        (jc, jd), (tc, td) = _route(jui, route, "post", body), _route(tui, route, "post", body)
        assert tc == jc == 400 and set(td) == set(jd) == {"error"}


def test_remote_bad_record_answers_400(both_servers):
    _, tui = both_servers
    code, d = _route(tui, "/remote/update", "post", b"\x00\x01")
    assert code == 400 and "error" in d


def test_tsne_compute_then_data(both_servers):
    """/tsne/compute runs t-SNE on the server's device; the coordinates
    come from each package's own initial draw (not bit-portable), so the
    two servers agree in keys, words and shape, and the port's coordinates
    equal its Tsne's on the same vectors."""
    from deeplearning4j_tpu_torch.clustering import Tsne

    jui, tui = both_servers
    vecs = np.random.default_rng(2).standard_normal((30, 8)).astype(np.float32)
    body = json.dumps({"vectors": vecs.tolist(), "words": [f"w{i}" for i in range(30)],
                       "perplexity": 5.0, "iters": 60}).encode()
    for ui in both_servers:
        assert _route(ui, "/tsne/compute", "post", body) == (200, {"status": "ok"})
    jd, td = _route(jui, "/tsne/data")[1], _route(tui, "/tsne/data")[1]
    assert set(td) == set(jd) and td["words"] == jd["words"]
    assert np.asarray(td["coords"]).shape == np.asarray(jd["coords"]).shape == (30, 2)
    want = Tsne(perplexity=5.0, n_iter=60, device="cpu").fit_transform(vecs)
    np.testing.assert_allclose(td["coords"], want, rtol=1e-6, atol=1e-6)


def test_tsne_compute_without_a_gpu_answers_an_error(monkeypatch):
    """A server left on the default device does not quietly run t-SNE on
    the CPU: without a GPU the request fails with the device error."""
    ui = UIServer(InMemoryStatsStorage(), port=0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    body = json.dumps({"vectors": [[0.0, 1.0]] * 8, "perplexity": 2.0}).encode()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ui._post("/tsne/compute", body, {})


def test_alerts_route_with_a_ledger_matches_jax_keys(tmp_path):
    from deeplearning4j_tpu.ui import InMemoryStatsStorage as JS
    from deeplearning4j_tpu.ui import UIServer as JUI
    from deeplearning4j_tpu.utils import runledger as jrl
    from deeplearning4j_tpu_torch.utils import runledger as trl

    out = {}
    for name, rl, ui in (("jax", jrl, JUI(JS(), port=0)),
                         ("port", trl, UIServer(InMemoryStatsStorage(), port=0))):
        led = rl.RunLedger(str(tmp_path / f"{name}.jsonl"), sample_every=60.0)
        rl.attach(led)
        try:
            out[name] = _route(ui, "/train/alerts/data")[1]
        finally:
            rl.detach(led)
            led.close()
        assert _route(ui, "/train/alerts/data")[1]["ledger"] is None
    assert set(out["port"]) == set(out["jax"])
    assert out["port"]["ledger"].endswith("port.jsonl")


def test_system_route_charts_the_registry_gauges():
    from deeplearning4j_tpu_torch.utils.metrics import get_registry

    g = get_registry().gauge("step_mfu", "test gauge", labelnames=("source",))
    g.labels(source="ui-test").set(0.25)
    ui = UIServer(InMemoryStatsStorage(), port=0, device="cpu")
    live = _route(ui, "/train/system/data")[1]["live"]
    live = _route(ui, "/train/system/data")[1]["live"]
    key = 'step_mfu{source="ui-test"}'
    assert key in live and len(live[key]) == 2 and live[key][-1][1] == 0.25
    assert all(k.split("{")[0] in UIServer._SYSTEM_GAUGES for k in live)


# -- over HTTP ---------------------------------------------------------------

def _http_get(port, route):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{route}") as r:
        return r.headers.get("Content-Type", ""), r.read()


def _train(router, n_iters=3, seed=0, device="cpu"):
    from deeplearning4j_tpu_torch.models.lenet import lenet_network

    net = lenet_network(device=device)
    net.set_collect_stats(True)
    net.set_listeners(StatsListener(router, session_id="test-session", report_memory=False))
    x, y = _xy(8 * n_iters, seed)
    net.fit(x, y, batch_size=8, epochs=1, async_prefetch=False)
    return net


def test_ui_server_routes_over_http(tmp_path):
    storage = FileStatsStorage(str(tmp_path / "stats.bin"))
    _train(storage, n_iters=4)
    server = UIServer(storage, port=0, device="cpu")
    port = server.start()
    try:
        ct, body = _http_get(port, "/train/overview")
        assert "text/html" in ct and b"dl4j-tpu" in body
        d = json.loads(_http_get(port, "/train/overview/data")[1])
        assert len(d["score"]) == 4 and d["session"] == "test-session"
        d = json.loads(_http_get(port, "/train/model/data")[1])
        assert any(l["series"] for l in d["layers"])
        d = json.loads(_http_get(port, "/train/system/data")[1])
        assert d["static"]["model_class"] == "MultiLayerNetwork"
        assert json.loads(_http_get(port, "/train/sessions/all")[1])["sessions"] == [
            "test-session"]
    finally:
        server.stop()


@pytest.mark.parametrize("router_pkg,server_pkg", [("port", "port"), ("port", "jax"),
                                                   ("jax", "port")])
def test_remote_router_into_a_server(router_pkg, server_pkg):
    """Remote training process -> POST /remote -> dashboard storage, with
    the router and the server from either package (the wire is the codec
    and the static JSON)."""
    from deeplearning4j_tpu.ui import InMemoryStatsStorage as JS
    from deeplearning4j_tpu.ui import RemoteUIStatsStorageRouter as JR
    from deeplearning4j_tpu.ui import UIServer as JUI

    storage = JS() if server_pkg == "jax" else InMemoryStatsStorage()
    server = (JUI if server_pkg == "jax" else UIServer)(storage, port=0)
    port = server.start()
    router = (JR if router_pkg == "jax" else RemoteUIStatsStorageRouter)(
        f"http://127.0.0.1:{port}")
    try:
        if router_pkg == "jax":
            router.put_static_info("test-session", {"model_class": "M"})
            for i in range(3):
                router.put_update("test-session", {**_record(i), "grad_mm": {"0_W": 0.5}})
        else:
            _train(router)
        router.flush()
        ups = storage.get_updates("test-session")
        assert len(ups) == 3
        assert np.isfinite(ups[-1]["score"]) and ups[-1]["grad_mm"]
        assert storage.get_static_info("test-session")["model_class"]
    finally:
        router.close()
        server.stop()
    assert not any(t.name == "dl4j-ui-remote-router" and t.is_alive()
                   for t in threading.enumerate() if t is router._worker)


def test_remote_router_drops_when_the_dashboard_is_down():
    router = RemoteUIStatsStorageRouter("http://127.0.0.1:9", timeout=0.2, queue_size=2)
    try:
        for i in range(5):
            router.put_update("s", _record(i))
        router.flush(timeout=5.0)
        assert router._q.unfinished_tasks == 0
    finally:
        router.close()
    assert not router._worker.is_alive()


# -- health history ------------------------------------------------------------

def _wait_until(pred, timeout=8.0, interval=0.02):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        v = pred()
        if v:
            return v
        time.sleep(interval)
    return pred()


def test_health_transition_listener_routes_records():
    from deeplearning4j_tpu_torch.train.listeners import HealthTransitionListener
    from deeplearning4j_tpu_torch.utils.health import OK, get_health

    storage = InMemoryStatsStorage()
    lst = HealthTransitionListener(storage, session_id="bb-session")
    h = get_health()
    hb = h.register("bb_listener_port", stall_after=0.08)
    ev = threading.Event()

    def work():
        with hb.busy():
            ev.wait(10)

    t = threading.Thread(target=work, daemon=True, name="dl4j-bb-lst")
    t.start()
    try:
        assert _wait_until(lambda: h.transitions_since(lst._seq))
    finally:
        ev.set()
        t.join(5)
    lst.iteration_done(None, 7, {})
    ups = storage.get_updates("bb-session")
    assert ups, "transition record never routed"
    rec = ups[-1]
    assert rec["iteration"] == 7
    assert "bb_listener_port" in [tr["component"] for tr in rec["health_transitions"]]
    assert rec["health_level"]["bb_listener_port"] >= 1
    n = len(storage.get_updates("bb-session"))
    _wait_until(lambda: h.status()["components"]["bb_listener_port"]["status"] == OK)
    lst.on_fit_end(None)
    h.unregister(hb)
    lst.iteration_done(None, 8, {})
    assert len(storage.get_updates("bb-session")) <= n + 1


def test_stats_listener_embeds_health_history(tmp_path):
    """StatsListener carries health transitions in its records, and the
    numeric health_level survives the file store's codec."""
    from deeplearning4j_tpu_torch.utils.health import get_health

    storage = FileStatsStorage(str(tmp_path / "h.bin"))
    from deeplearning4j_tpu_torch.models.lenet import lenet_network

    net = lenet_network(device="cpu")
    lst = StatsListener(storage, session_id="bb-stats")
    net.set_listeners(lst)
    h = get_health()
    hb = h.register("bb_stats_comp_port", stall_after=0.05)
    ev = threading.Event()

    def work():
        with hb.busy():
            ev.wait(10)

    t = threading.Thread(target=work, daemon=True, name="dl4j-bb-stats")
    t.start()
    x, y = _xy(10, 4)
    try:
        assert _wait_until(lambda: h.transitions_since(lst._health_seq))
        net.fit(x, y, epochs=1, batch_size=10, async_prefetch=False)
    finally:
        ev.set()
        t.join(5)
        h.unregister(hb)
        net.set_listeners()
    ups = FileStatsStorage(str(tmp_path / "h.bin")).get_updates("bb-stats")
    assert any(u.get("health_level", {}).get("bb_stats_comp_port", 0) >= 1 for u in ups)

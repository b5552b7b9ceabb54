"""The port's Keras-backend entry point (keras_backend.py) against the JAX
package's: the JAX test's /fit then /evaluate case, the configuration
fit_from_keras_config builds, the .h5 path without h5py, and the device
default."""

import json
import sys
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch import keras_backend as kb
from deeplearning4j_tpu_torch.keras_backend import KerasBackendServer, fit_from_keras_config

MODEL_CONFIG = json.dumps({
    "class_name": "Sequential",
    "config": [
        {"class_name": "Dense",
         "config": {"output_dim": 12, "activation": "tanh",
                    "batch_input_shape": [None, 6], "name": "d1"}},
        {"class_name": "Dense",
         "config": {"output_dim": 2, "activation": "softmax", "name": "d2"}},
    ],
})


def _data(tmp_path, n=64):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((n, 6)).astype(np.float32)
    y = np.zeros((n, 2), np.float32)
    y[np.arange(n), (x[:, 0] > 0).astype(int)] = 1.0
    np.save(tmp_path / "x.npy", x)
    np.save(tmp_path / "y.npy", y)
    return x, y


def _post(port, route, payload):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{route}",
                                 data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_keras_backend_server_fit_then_evaluate(tmp_path):
    """The JAX test's case (tests/test_data_cli.py): 20 epochs of the
    sign of feature 0, then /evaluate on the same data."""
    _data(tmp_path)
    server = KerasBackendServer(port=0, device="cpu")
    port = server.start()
    try:
        code, out = _post(port, "/fit", {
            "model_config": MODEL_CONFIG,
            "features_path": str(tmp_path / "x.npy"),
            "labels_path": str(tmp_path / "y.npy"),
            "batch_size": 16, "nb_epoch": 20})
        assert code == 200 and set(out) == {"score"} and np.isfinite(out["score"])
        code, ev = _post(port, "/evaluate", {"features_path": str(tmp_path / "x.npy"),
                                             "labels_path": str(tmp_path / "y.npy")})
        assert code == 200 and set(ev) == {"accuracy", "f1"}
        assert ev["accuracy"] > 0.9
        assert all(t.device.type == "cpu" for p in server._net.params_list for t in p.values())
    finally:
        server.stop()


def test_server_answers_as_the_jax_server(tmp_path):
    """The same requests to both servers: the same status and keys, and
    /evaluate before any /fit is a 400 in both."""
    from deeplearning4j_tpu.keras_backend import KerasBackendServer as JServer

    _data(tmp_path)
    js, ts = JServer(port=0), KerasBackendServer(port=0, device="cpu")
    jp, tp = js.start(), ts.start()
    try:
        ev = {"features_path": str(tmp_path / "x.npy"), "labels_path": str(tmp_path / "y.npy")}
        (jc, jd), (tc, td) = _post(jp, "/evaluate", ev), _post(tp, "/evaluate", ev)
        assert tc == jc == 400 and set(td) == set(jd) == {"error"}
        fit = {"model_config": MODEL_CONFIG, **ev, "batch_size": 16, "nb_epoch": 2}
        (jc, jd), (tc, td) = _post(jp, "/fit", fit), _post(tp, "/fit", fit)
        assert tc == jc == 200 and set(td) == set(jd)
        (jc, jd), (tc, td) = _post(jp, "/evaluate", ev), _post(tp, "/evaluate", ev)
        assert tc == jc == 200 and set(td) == set(jd)
        (jc, jd), (tc, td) = _post(jp, "/nope", {}), _post(tp, "/nope", {})
        assert tc == jc == 404
    finally:
        js.stop()
        ts.stop()


def test_fit_from_keras_config_conf_equals_jax(tmp_path):
    """The configuration is the JAX package's (its JSON). The weights are
    each package's own seeded init, which is not bit-portable, so the
    scores are held only to be finite."""
    from deeplearning4j_tpu.keras_backend import fit_from_keras_config as jfit
    from deeplearning4j_tpu.modelimport.keras import import_keras_sequential_config as jimp
    from deeplearning4j_tpu_torch.modelimport.keras import import_keras_sequential_config

    tc = json.dumps({"loss": "categorical_crossentropy"})
    jconf, _ = jimp(MODEL_CONFIG, tc)
    tconf, _ = import_keras_sequential_config(MODEL_CONFIG, tc)
    assert tconf.to_json() == jconf.to_json()
    x, y = _data(tmp_path)
    jnet, jscore = jfit(MODEL_CONFIG, x, y, batch_size=64, nb_epoch=1)
    tnet, tscore = fit_from_keras_config(MODEL_CONFIG, x, y, batch_size=64, nb_epoch=1,
                                         device="cpu")
    assert tnet.conf.to_json() == jnet.conf.to_json()
    assert np.isfinite(tscore) and np.isfinite(jscore) and tnet.iteration == jnet.iteration


def test_h5_path_without_h5py_raises_import_error(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(ImportError, match="h5py"):
        kb._load_array(str(tmp_path / "x.h5"))
    x, _ = _data(tmp_path)
    np.testing.assert_array_equal(kb._load_array(str(tmp_path / "x.npy")), x)


def test_h5_path_with_h5py_reads_the_dataset(tmp_path):
    h5py = pytest.importorskip("h5py")
    path = str(tmp_path / "d.h5")
    with h5py.File(path, "w") as f:
        f["data"] = np.arange(6.0).reshape(2, 3)
        f["feats"] = np.ones((2, 2))
    np.testing.assert_array_equal(kb._load_array(path), np.arange(6.0).reshape(2, 3))
    np.testing.assert_array_equal(kb._load_array(path, "feats"), np.ones((2, 2)))


def test_entry_points_default_to_cuda_and_raise_without_it(tmp_path, monkeypatch):
    x, y = _data(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fit_from_keras_config(MODEL_CONFIG, x, y)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        KerasBackendServer(port=0)

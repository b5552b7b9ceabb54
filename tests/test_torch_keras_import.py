"""The port's Keras 1.x importer (deeplearning4j_tpu_torch/modelimport/
keras.py) against the JAX package's, on the CPU.

The fixtures of the JAX package's tests/test_keras_import.py are rebuilt
here with h5py in the Keras 1.x ``save_model()`` layout (Sequential MLP,
CNN in tf and theano ordering, LSTM gate packing, BN running statistics,
a functional merge, Conv1D / ZeroPadding2D / pooling-1D layers, the
config-only path and the errors). For each archive both importers must
give the same configuration JSON and bit-equal parameters and layer
state, and outputs within f32 rtol 1e-5 / atol 1e-6; the golden numpy
forwards of the JAX tests hold the port too (rtol 1e-4 / atol 1e-4, as
there). VGG16 is checked by its configuration JSON at full width (no
init) and by a forward at image_size 32 from the JAX package's weights.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

h5py = pytest.importorskip("h5py")

from deeplearning4j_tpu import modelimport as jki  # noqa: E402
from deeplearning4j_tpu.models import vgg16 as jvgg  # noqa: E402
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN  # noqa: E402
from deeplearning4j_tpu_torch import modelimport as tki  # noqa: E402
from deeplearning4j_tpu_torch.models import vgg16 as tvgg  # noqa: E402
from deeplearning4j_tpu_torch.nn.conf import layers as TL  # noqa: E402
from deeplearning4j_tpu_torch.nn.params import params_from_numpy  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = dict(rtol=1e-5, atol=1e-6)
GOLDEN = dict(rtol=1e-4, atol=1e-4)


def _seq_config(layers):
    return json.dumps({"class_name": "Sequential", "config": layers})


def _training_config(loss="categorical_crossentropy"):
    return json.dumps({"loss": loss, "optimizer": {"name": "sgd"}})


def write_keras_h5(path, model_config, weights, training_config=None):
    """weights: {layer_name: {param_name_without_suffix: array}}, written
    with the TF-backend ':0' suffix Keras 1.x emits."""
    with h5py.File(path, "w") as f:
        f.attrs["model_config"] = np.bytes_(model_config)
        if training_config is not None:
            f.attrs["training_config"] = np.bytes_(training_config)
        mw = f.create_group("model_weights")
        mw.attrs["layer_names"] = np.array([n.encode() for n in weights], dtype="S64")
        for lname, params in weights.items():
            g = mw.create_group(lname)
            wnames = [f"{lname}_{p}:0" for p in params]
            g.attrs["weight_names"] = np.array([n.encode() for n in wnames], dtype="S64")
            for wn, arr in zip(wnames, params.values()):
                g.create_dataset(wn, data=np.asarray(arr, np.float32))


def _softmax(z):
    e = np.exp(z - z.max(axis=-1, keepdims=True))
    return e / e.sum(axis=-1, keepdims=True)


def _same_nets(tnet, jnet):
    """Same conf JSON, bit-equal parameters and layer state."""
    assert tnet.conf.to_json() == jnet.conf.to_json()
    assert len(tnet.params_list) == len(jnet.params_list)
    for tp, jp in zip(tnet.params_list, jnet.params_list):
        assert set(tp) == set(jp)
        for k in tp:
            assert tp[k].dtype == torch.float32
            assert np.array_equal(tp[k].numpy(), np.asarray(jp[k]))
    for ts, js in zip(tnet.state_list, jnet.state_list):
        assert (ts is None) == (js is None)
        for k in (ts or {}):
            assert np.array_equal(ts[k].numpy(), np.asarray(js[k]))


def _both(path, seq=True):
    if seq:
        return (tki.import_keras_sequential_model_and_weights(str(path), device="cpu"),
                jki.import_keras_sequential_model_and_weights(str(path)))
    return (tki.import_keras_model_and_weights(str(path), device="cpu"),
            jki.import_keras_model_and_weights(str(path)))


def _out(net, *xs):
    o = net.output(*xs)
    return np.asarray(o[0] if isinstance(o, (list, tuple)) else o)


def test_sequential_mlp(tmp_path):
    rng = np.random.default_rng(0)
    W1, b1 = rng.normal(size=(4, 8)).astype(np.float32), rng.normal(size=8).astype(np.float32)
    W2, b2 = rng.normal(size=(8, 3)).astype(np.float32), rng.normal(size=3).astype(np.float32)
    mc = _seq_config([
        {"class_name": "Dense",
         "config": {"name": "dense_1", "output_dim": 8, "activation": "relu",
                    "batch_input_shape": [None, 4], "init": "glorot_uniform"}},
        {"class_name": "Dense",
         "config": {"name": "dense_2", "output_dim": 3, "activation": "softmax",
                    "init": "glorot_uniform"}},
    ])
    path = tmp_path / "mlp.h5"
    write_keras_h5(path, mc, {"dense_1": {"W": W1, "b": b1}, "dense_2": {"W": W2, "b": b2}},
                   training_config=_training_config())
    tnet, jnet = _both(path)
    _same_nets(tnet, jnet)
    assert isinstance(tnet.layer_confs[-1], TL.OutputLayer)
    assert tnet.layer_confs[-1].loss == "mcxent"
    x = rng.normal(size=(5, 4)).astype(np.float32)
    np.testing.assert_allclose(_out(tnet, x), _out(jnet, x), **OUT)
    want = _softmax(np.maximum(x @ W1 + b1, 0.0) @ W2 + b2)
    np.testing.assert_allclose(_out(tnet, x), want, **GOLDEN)


def _np_conv_valid(x, W, b):
    n, h, w, cin = x.shape
    kh, kw, _, cout = W.shape
    oh, ow = h - kh + 1, w - kw + 1
    out = np.zeros((n, oh, ow, cout), np.float32)
    for i in range(oh):
        for j in range(ow):
            out[:, i, j, :] = x[:, i:i + kh, j:j + kw, :].reshape(n, -1) @ W.reshape(-1, cout)
    return out + b


def _np_maxpool(x, k):
    n, h, w, c = x.shape
    out = np.zeros((n, h // k, w // k, c), np.float32)
    for i in range(h // k):
        for j in range(w // k):
            out[:, i, j, :] = x[:, i * k:(i + 1) * k, j * k:(j + 1) * k, :].max((1, 2))
    return out


def test_cnn_tf_ordering(tmp_path):
    rng = np.random.default_rng(1)
    Wc = rng.normal(size=(3, 3, 3, 4)).astype(np.float32)
    bc = rng.normal(size=4).astype(np.float32)
    Wd = rng.normal(size=(3 * 3 * 4, 5)).astype(np.float32)
    bd = rng.normal(size=5).astype(np.float32)
    mc = _seq_config([
        {"class_name": "Convolution2D",
         "config": {"name": "convolution2d_1", "nb_filter": 4, "nb_row": 3,
                    "nb_col": 3, "border_mode": "valid", "subsample": [1, 1],
                    "dim_ordering": "tf", "activation": "relu",
                    "batch_input_shape": [None, 8, 8, 3], "init": "glorot_uniform"}},
        {"class_name": "MaxPooling2D",
         "config": {"name": "maxpooling2d_1", "pool_size": [2, 2], "strides": [2, 2],
                    "border_mode": "valid", "dim_ordering": "tf"}},
        {"class_name": "Flatten", "config": {"name": "flatten_1"}},
        {"class_name": "Dense",
         "config": {"name": "dense_1", "output_dim": 5, "activation": "softmax",
                    "init": "glorot_uniform"}},
    ])
    path = tmp_path / "cnn.h5"
    write_keras_h5(path, mc, {"convolution2d_1": {"W": Wc, "b": bc},
                              "dense_1": {"W": Wd, "b": bd}},
                   training_config=_training_config())
    tnet, jnet = _both(path)
    _same_nets(tnet, jnet)
    x = rng.normal(size=(2, 8, 8, 3)).astype(np.float32)
    np.testing.assert_allclose(_out(tnet, x), _out(jnet, x), **OUT)
    flat = _np_maxpool(np.maximum(_np_conv_valid(x, Wc, bc), 0.0), 2).reshape(2, -1)
    np.testing.assert_allclose(_out(tnet, x), _softmax(flat @ Wd + bd), **GOLDEN)


def test_cnn_theano_kernel_transpose(tmp_path):
    """A theano-ordering kernel (OIHW, true convolution) lands rotated 180
    degrees and transposed to HWIO, bit-equal to the JAX importer's."""
    rng = np.random.default_rng(2)
    Wc = rng.normal(size=(3, 3, 3, 4)).astype(np.float32)
    bc = rng.normal(size=4).astype(np.float32)
    W_th = Wc.transpose(3, 2, 0, 1)[:, :, ::-1, ::-1]
    mc = _seq_config([
        {"class_name": "Convolution2D",
         "config": {"name": "convolution2d_1", "nb_filter": 4, "nb_row": 3,
                    "nb_col": 3, "border_mode": "valid", "subsample": [1, 1],
                    "dim_ordering": "th", "activation": "linear",
                    "batch_input_shape": [None, 3, 8, 8], "init": "glorot_uniform"}},
        {"class_name": "GlobalAveragePooling2D",
         "config": {"name": "gap_1", "dim_ordering": "th"}},
    ])
    path = tmp_path / "cnn_th.h5"
    write_keras_h5(path, mc, {"convolution2d_1": {"W": W_th, "b": bc}})
    tnet, jnet = _both(path)
    _same_nets(tnet, jnet)
    assert np.array_equal(tnet.params_list[0]["W"].numpy(), Wc)
    x = rng.normal(size=(2, 8, 8, 3)).astype(np.float32)
    np.testing.assert_allclose(_out(tnet, x), _out(jnet, x), **OUT)
    np.testing.assert_allclose(_out(tnet, x), _np_conv_valid(x, Wc, bc).mean(axis=(1, 2)),
                               **GOLDEN)


def test_lstm_gate_packing(tmp_path):
    rng = np.random.default_rng(3)
    n_in, H, T, B = 3, 4, 5, 2
    ks = {}
    for g in ("i", "f", "c", "o"):
        ks[f"W_{g}"] = rng.normal(size=(n_in, H)).astype(np.float32)
        ks[f"U_{g}"] = rng.normal(size=(H, H)).astype(np.float32)
        ks[f"b_{g}"] = rng.normal(size=H).astype(np.float32)
    mc = _seq_config([
        {"class_name": "LSTM",
         "config": {"name": "lstm_1", "output_dim": H, "activation": "tanh",
                    "inner_activation": "sigmoid", "return_sequences": True,
                    "batch_input_shape": [None, T, n_in], "init": "glorot_uniform",
                    "inner_init": "orthogonal", "forget_bias_init": "one"}},
    ])
    path = tmp_path / "lstm.h5"
    write_keras_h5(path, mc, {"lstm_1": ks})
    tnet, jnet = _both(path)
    _same_nets(tnet, jnet)
    p = tnet.params_list[0]
    assert np.array_equal(p["W"].numpy()[:, H:2 * H], ks["W_f"])  # [i|f|g|o]
    assert np.array_equal(p["RW"].numpy()[:, 2 * H:3 * H], ks["U_c"])
    x = rng.normal(size=(B, T, n_in)).astype(np.float32)
    np.testing.assert_allclose(_out(tnet, x), _out(jnet, x), **OUT)


def test_batchnorm_running_stats(tmp_path):
    rng = np.random.default_rng(4)
    n = 6
    gamma, beta = rng.normal(size=n).astype(np.float32), rng.normal(size=n).astype(np.float32)
    mean = rng.normal(size=n).astype(np.float32)
    var = rng.uniform(0.5, 2.0, size=n).astype(np.float32)
    mc = _seq_config([
        {"class_name": "Dense",
         "config": {"name": "dense_1", "output_dim": n, "activation": "linear",
                    "batch_input_shape": [None, n], "init": "glorot_uniform"}},
        {"class_name": "BatchNormalization",
         "config": {"name": "batchnormalization_1", "mode": 0, "epsilon": 1e-5,
                    "momentum": 0.99}},
    ])
    path = tmp_path / "bn.h5"
    write_keras_h5(path, mc, {
        "dense_1": {"W": np.eye(n, dtype=np.float32), "b": np.zeros(n, np.float32)},
        "batchnormalization_1": {"gamma": gamma, "beta": beta,
                                 "running_mean": mean, "running_std": var}})
    tnet, jnet = _both(path)
    _same_nets(tnet, jnet)
    assert np.array_equal(tnet.state_list[1]["var"].numpy(), var)
    x = rng.normal(size=(3, n)).astype(np.float32)
    np.testing.assert_allclose(_out(tnet, x), _out(jnet, x), **OUT)
    np.testing.assert_allclose(_out(tnet, x), gamma * (x - mean) / np.sqrt(var + 1e-5) + beta,
                               **GOLDEN)


def _functional_config():
    return json.dumps({
        "class_name": "Model",
        "config": {
            "name": "model_1",
            "layers": [
                {"class_name": "InputLayer", "name": "input_1",
                 "config": {"name": "input_1", "batch_input_shape": [None, 3]},
                 "inbound_nodes": []},
                {"class_name": "InputLayer", "name": "input_2",
                 "config": {"name": "input_2", "batch_input_shape": [None, 2]},
                 "inbound_nodes": []},
                {"class_name": "Dense", "name": "dense_a",
                 "config": {"name": "dense_a", "output_dim": 4, "activation": "tanh",
                            "init": "glorot_uniform"},
                 "inbound_nodes": [[["input_1", 0, 0]]]},
                {"class_name": "Dense", "name": "dense_b",
                 "config": {"name": "dense_b", "output_dim": 4, "activation": "tanh",
                            "init": "glorot_uniform"},
                 "inbound_nodes": [[["input_2", 0, 0]]]},
                {"class_name": "Merge", "name": "merge_1",
                 "config": {"name": "merge_1", "mode": "concat"},
                 "inbound_nodes": [[["dense_a", 0, 0], ["dense_b", 0, 0]]]},
                {"class_name": "Merge", "name": "merge_2",
                 "config": {"name": "merge_2", "mode": "sum"},
                 "inbound_nodes": [[["dense_a", 0, 0], ["dense_b", 0, 0]]]},
                {"class_name": "Merge", "name": "merge_3",
                 "config": {"name": "merge_3", "mode": "concat"},
                 "inbound_nodes": [[["merge_1", 0, 0], ["merge_2", 0, 0]]]},
                {"class_name": "Dense", "name": "dense_out",
                 "config": {"name": "dense_out", "output_dim": 3,
                            "activation": "softmax", "init": "glorot_uniform"},
                 "inbound_nodes": [[["merge_3", 0, 0]]]},
            ],
            "input_layers": [["input_1", 0, 0], ["input_2", 0, 0]],
            "output_layers": [["dense_out", 0, 0]],
        },
    })


def test_functional_model_merge(tmp_path):
    rng = np.random.default_rng(5)
    W1, b1 = rng.normal(size=(3, 4)).astype(np.float32), rng.normal(size=4).astype(np.float32)
    W2, b2 = rng.normal(size=(2, 4)).astype(np.float32), rng.normal(size=4).astype(np.float32)
    W3, b3 = rng.normal(size=(12, 3)).astype(np.float32), rng.normal(size=3).astype(np.float32)
    path = tmp_path / "func.h5"
    write_keras_h5(path, _functional_config(), {
        "dense_a": {"W": W1, "b": b1}, "dense_b": {"W": W2, "b": b2},
        "dense_out": {"W": W3, "b": b3}}, training_config=_training_config())
    tnet, jnet = _both(path, seq=False)
    _same_nets(tnet, jnet)
    xa = rng.normal(size=(4, 3)).astype(np.float32)
    xb = rng.normal(size=(4, 2)).astype(np.float32)
    np.testing.assert_allclose(_out(tnet, xa, xb), _out(jnet, xa, xb), **OUT)
    ha, hb = np.tanh(xa @ W1 + b1), np.tanh(xb @ W2 + b2)
    merged = np.concatenate([ha, hb, ha + hb], axis=1)
    np.testing.assert_allclose(_out(tnet, xa, xb), _softmax(merged @ W3 + b3), **GOLDEN)
    # a Sequential archive through the functional entry point
    seq = tmp_path / "seq.h5"
    write_keras_h5(seq, _seq_config([
        {"class_name": "Dense",
         "config": {"name": "d", "output_dim": 2, "activation": "relu",
                    "batch_input_shape": [None, 3], "init": "glorot_uniform"}}]),
        {"d": {"W": W1[:, :2], "b": b1[:2]}})
    tnet, jnet = _both(seq, seq=False)
    _same_nets(tnet, jnet)


def test_conv1d_zero_padding_and_1d_pooling(tmp_path):
    """The second slice's layers through the importer: Convolution1D
    (Keras 1's 4-d kernel reshaped to [k, nIn, nOut]), MaxPooling1D,
    GlobalAveragePooling1D; ZeroPadding2D and GlobalMaxPooling2D."""
    rng = np.random.default_rng(6)
    W1 = rng.normal(size=(3, 1, 4, 5)).astype(np.float32)
    b1 = rng.normal(size=5).astype(np.float32)
    mc = _seq_config([
        {"class_name": "Convolution1D",
         "config": {"name": "conv1d_1", "nb_filter": 5, "filter_length": 3,
                    "border_mode": "same", "subsample_length": 1, "activation": "relu",
                    "batch_input_shape": [None, 9, 4], "init": "glorot_uniform"}},
        {"class_name": "MaxPooling1D",
         "config": {"name": "pool1d_1", "pool_length": 2, "stride": 2,
                    "border_mode": "valid"}},
        {"class_name": "GlobalAveragePooling1D", "config": {"name": "gap1d_1"}},
    ])
    path = tmp_path / "c1d.h5"
    write_keras_h5(path, mc, {"conv1d_1": {"W": W1, "b": b1}})
    tnet, jnet = _both(path)
    _same_nets(tnet, jnet)
    assert isinstance(tnet.layer_confs[0], TL.Convolution1DLayer)
    x = rng.normal(size=(3, 9, 4)).astype(np.float32)
    np.testing.assert_allclose(_out(tnet, x), _out(jnet, x), **OUT)

    Wc = rng.normal(size=(3, 3, 2, 3)).astype(np.float32)
    bc = rng.normal(size=3).astype(np.float32)
    mc = _seq_config([
        {"class_name": "ZeroPadding2D",
         "config": {"name": "zp_1", "padding": [1, 2], "dim_ordering": "tf",
                    "batch_input_shape": [None, 6, 6, 2]}},
        {"class_name": "Convolution2D",
         "config": {"name": "conv_1", "nb_filter": 3, "nb_row": 3, "nb_col": 3,
                    "border_mode": "valid", "subsample": [2, 2], "dim_ordering": "tf",
                    "activation": "tanh", "init": "he_normal"}},
        {"class_name": "GlobalMaxPooling2D", "config": {"name": "gmp_1"}},
    ])
    path = tmp_path / "zp.h5"
    write_keras_h5(path, mc, {"conv_1": {"W": Wc, "b": bc}})
    tnet, jnet = _both(path)
    _same_nets(tnet, jnet)
    assert tuple(tnet.layer_confs[0].padding) == (1, 1, 2, 2)
    x = rng.normal(size=(2, 6, 6, 2)).astype(np.float32)
    np.testing.assert_allclose(_out(tnet, x), _out(jnet, x), **OUT)


def test_config_only_and_errors(tmp_path):
    mc = _seq_config([
        {"class_name": "Dense",
         "config": {"name": "d", "output_dim": 2, "activation": "relu",
                    "batch_input_shape": [None, 3], "init": "glorot_uniform"}}])
    conf, names = tki.import_keras_sequential_config(mc)
    jconf, jnames = jki.import_keras_sequential_config(mc)
    assert conf.to_json() == jconf.to_json() and names == jnames == ["d"]
    gconf, gnames = tki.import_keras_model_config(_functional_config(), _training_config())
    jgconf, jgnames = jki.import_keras_model_config(_functional_config(), _training_config())
    assert gconf.to_json() == jgconf.to_json() and gnames == jgnames
    for bad in (json.dumps({"class_name": "Graph", "config": []}),
                _seq_config([{"class_name": "Unknown", "config": {"name": "u"}}]),
                _seq_config([{"class_name": "Dense",
                              "config": {"name": "d", "output_dim": 2,
                                         "activation": "bogus"}}])):
        with pytest.raises(tki.KerasImportError):
            tki.import_keras_sequential_config(bad)
        with pytest.raises(jki.KerasImportError):
            jki.import_keras_sequential_config(bad)
    with pytest.raises(tki.KerasImportError):
        tki.import_keras_model_config(mc)
    path = tmp_path / "bad.h5"
    with h5py.File(path, "w") as f:
        f.create_group("model_weights")
    with pytest.raises(tki.KerasImportError):
        tki.import_keras_sequential_model_and_weights(str(path), device="cpu")


def test_config_path_never_imports_h5py():
    """h5py is needed only by the HDF5 reader: importing the importer and
    translating a configuration load no h5py."""
    code = ("import sys\n"
            "from deeplearning4j_tpu_torch.models.vgg16 import vgg16_conf\n"
            "vgg16_conf(num_classes=10, image_size=32)\n"
            "print('h5py' in sys.modules)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120, env=dict(os.environ, PYTHONPATH=ROOT))
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "False"


def test_archive_import_defaults_to_cuda(tmp_path, monkeypatch):
    path = tmp_path / "mlp.h5"
    write_keras_h5(path, _seq_config([
        {"class_name": "Dense",
         "config": {"name": "d", "output_dim": 2, "activation": "relu",
                    "batch_input_shape": [None, 3], "init": "glorot_uniform"}}]),
        {"d": {"W": np.ones((3, 2)), "b": np.zeros(2)}})
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for fn in (tki.import_keras_sequential_model_and_weights,
               tki.import_keras_model_and_weights):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            fn(str(path))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tvgg.vgg16_network(num_classes=2, image_size=32)


def test_vgg16_conf_json_at_full_width():
    assert tvgg.vgg16_keras_config() == jvgg.vgg16_keras_config()
    js = jvgg.vgg16_conf().to_json()
    assert tvgg.vgg16_conf().to_json() == js
    from deeplearning4j_tpu_torch.nn.conf.network import MultiLayerConfiguration

    assert MultiLayerConfiguration.from_json(js).to_json() == js
    conf = tvgg.vgg16_conf()
    convs = [c for c in conf.layers if isinstance(c, TL.ConvolutionLayer)]
    assert len(convs) == 13 and all(c.has_bias for c in convs)
    assert [c.n_out for c in conf.layers if isinstance(c, TL.DenseLayer)] == [4096, 4096]
    assert isinstance(conf.layers[-1], TL.OutputLayer) and conf.layers[-1].n_out == 1000


def test_vgg16_forward_at_32px_matches_jax():
    jnet = JMLN(jvgg.vgg16_conf(num_classes=10, image_size=32, precision="f32")).init()
    tnet = tvgg.vgg16_network(num_classes=10, image_size=32, precision="f32", device="cpu")
    tnet.params_list = params_from_numpy(
        tnet.conf, [{k: np.asarray(v) for k, v in p.items()} for p in jnet.params_list],
        device="cpu")
    x = np.random.default_rng(7).uniform(size=(2, 32, 32, 3)).astype(np.float32)
    np.testing.assert_allclose(_out(tnet, x), _out(jnet, x), **OUT)

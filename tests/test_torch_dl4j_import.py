"""The port's DL4J-format zip importer (modelimport/dl4j.py) on the cases
of tests/test_dl4j_import.py and tests/test_dl4j_updater_state.py, on the
CPU (`device="cpu"`; the importer builds the network on the caller's
device), plus the crossing between packages: a zip the JAX package
exports imports into the port with the same parameters, state and
updater moments (exact), and the imported GravesLSTM's forward (the
IFOG gate permutation into K1's gate order) equals the JAX package's on
the same zip (f32 rtol 1e-5 / atol 1e-6).
"""

import io
import numpy as np
import pytest

from deeplearning4j_tpu_torch.modelimport.dl4j import (
    export_dl4j_zip,
    import_dl4j_multilayer,
    read_nd4j_array,
    write_nd4j_array,
    _perm_ifog,
)
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.layers import (
    BatchNormalization,
    DenseLayer,
    GravesLSTM,
    LSTM,
    OutputLayer,
    RnnOutputLayer,
    SubsamplingLayer,
    ConvolutionLayer,
)
from deeplearning4j_tpu_torch.nn.conf.network import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork


def test_nd4j_binary_round_trip():
    rng = np.random.default_rng(0)
    for arr in (rng.standard_normal(17).astype(np.float32),
                rng.standard_normal((3, 5)).astype(np.float64)):
        buf = io.BytesIO()
        write_nd4j_array(arr, buf)
        buf.seek(0)
        back = read_nd4j_array(buf)
        np.testing.assert_array_equal(back.reshape(-1), arr.reshape(-1))


def test_perm_ifog_blocks():
    """DL4J [I,F,O,G] -> framework [i,f,g,o] means [G,F,I,O]."""
    H = 2
    cols = np.array([[10, 11, 20, 21, 30, 31, 40, 41]], np.float32)
    out = _perm_ifog(cols, H)
    np.testing.assert_array_equal(
        out[0], [40, 41, 20, 21, 10, 11, 30, 31])


def _mlp_net(seed=5):
    conf = (NeuralNetConfiguration.builder().seed(seed)
            .weight_init("xavier").list()
            .layer(DenseLayer(n_out=9, activation="tanh"))
            .layer(BatchNormalization())
            .layer(OutputLayer(n_out=4, activation="softmax", loss="mcxent"))
            .set_input_type(InputType.feed_forward(6)).build())
    return MultiLayerNetwork(conf, device="cpu").init()


def test_mlp_zip_round_trip(tmp_path):
    net = _mlp_net()
    # give BN non-trivial running stats
    x = np.random.default_rng(0).standard_normal((32, 6)).astype(np.float32)
    y = np.zeros((32, 4), np.float32)
    y[np.arange(32), np.random.default_rng(1).integers(0, 4, 32)] = 1.0
    net.fit(x, y, batch_size=16, epochs=1, async_prefetch=False)

    path = str(tmp_path / "mlp.zip")
    export_dl4j_zip(net, path)
    back = import_dl4j_multilayer(path, device="cpu")
    np.testing.assert_allclose(
        np.asarray(back.output(x)), np.asarray(net.output(x)),
        rtol=1e-5, atol=1e-6)


def test_graves_lstm_zip_round_trip_golden_forward(tmp_path):
    """The headline case: gate permutation + peephole
    column mapping proven by forward equality on a Graves LSTM."""
    conf = (NeuralNetConfiguration.builder().seed(11)
            .weight_init("xavier").list()
            .layer(GravesLSTM(n_out=7, activation="tanh"))
            .layer(RnnOutputLayer(n_out=3, activation="softmax",
                                  loss="mcxent"))
            .set_input_type(InputType.recurrent(5)).build())
    net = MultiLayerNetwork(conf, device="cpu").init()
    x = np.random.default_rng(2).standard_normal((4, 10, 5)).astype(np.float32)
    golden = np.asarray(net.output(x))

    path = str(tmp_path / "graves.zip")
    export_dl4j_zip(net, path)
    back = import_dl4j_multilayer(path, device="cpu")
    np.testing.assert_allclose(np.asarray(back.output(x)), golden,
                               rtol=1e-5, atol=1e-6)
    # peephole vectors landed in the right slots
    for k in ("pI", "pF", "pO"):
        np.testing.assert_allclose(np.asarray(back.params_list[0][k]),
                                   np.asarray(net.params_list[0][k]),
                                   rtol=1e-6)


def test_vanilla_lstm_zip_round_trip(tmp_path):
    conf = (NeuralNetConfiguration.builder().seed(3)
            .weight_init("xavier").list()
            .layer(LSTM(n_out=6, activation="tanh"))
            .layer(RnnOutputLayer(n_out=2, activation="softmax",
                                  loss="mcxent"))
            .set_input_type(InputType.recurrent(4)).build())
    net = MultiLayerNetwork(conf, device="cpu").init()
    x = np.random.default_rng(4).standard_normal((3, 8, 4)).astype(np.float32)
    path = str(tmp_path / "lstm.zip")
    export_dl4j_zip(net, path)
    back = import_dl4j_multilayer(path, device="cpu")
    np.testing.assert_allclose(np.asarray(back.output(x)),
                               np.asarray(net.output(x)),
                               rtol=1e-5, atol=1e-6)


def test_length_mismatch_detected(tmp_path):
    net = _mlp_net()
    path = str(tmp_path / "bad.zip")
    export_dl4j_zip(net, path)
    import zipfile, json

    with zipfile.ZipFile(path) as zf:
        conf = zf.read("configuration.json")
        coeff = zf.read("coefficients.bin")
    # truncate the flat buffer: drop the final 4 bytes (one float)
    buf = io.BytesIO(coeff)
    arr = read_nd4j_array(buf)
    short = np.asarray(arr).reshape(-1)[:-1]
    out = io.BytesIO()
    write_nd4j_array(short, out)
    with zipfile.ZipFile(path, "w") as zf:
        zf.writestr("configuration.json", conf)
        zf.writestr("coefficients.bin", out.getvalue())
    with pytest.raises(ValueError, match="too short|mismatch"):
        import_dl4j_multilayer(path, device="cpu")


# -- ComputationGraph zips ----------------------------------------------------

from deeplearning4j_tpu_torch.modelimport.dl4j import (
    export_dl4j_graph,
    import_dl4j_computation_graph,
    _dl4j_topo_names,
)
from deeplearning4j_tpu_torch.nn.compgraph import ComputationGraph
from deeplearning4j_tpu_torch.nn.conf.graph import (
    ElementWiseVertex,
    MergeVertex,
)


def _graph_net(seed=11):
    """Diamond graph: dense branches -> merge, plus a residual elementwise
    add and a BN layer — exercises vertex mapping AND the topological flat
    walk (branch params interleave)."""
    from deeplearning4j_tpu_torch.nn.conf.network import NeuralNetConfiguration
    conf = (NeuralNetConfiguration.builder().seed(seed)
            .weight_init("xavier").graph_builder()
            .add_inputs("in")
            .add_layer("a", DenseLayer(n_in=8, n_out=6, activation="tanh"),
                       "in")
            .add_layer("b", DenseLayer(n_in=8, n_out=6, activation="relu"),
                       "in")
            .add_vertex("add", ElementWiseVertex(op="add"), "a", "b")
            .add_vertex("m", MergeVertex(), "a", "add")
            .add_layer("bn", BatchNormalization(n_in=12), "m")
            .add_layer("out", OutputLayer(n_in=12, n_out=3,
                                          activation="softmax",
                                          loss="mcxent"), "bn")
            .set_outputs("out").build())
    return ComputationGraph(conf, device="cpu").init()


def test_graph_zip_round_trip(tmp_path):
    net = _graph_net()
    x = np.random.default_rng(3).standard_normal((5, 8)).astype(np.float32)
    want = np.asarray(net.output(x))
    path = tmp_path / "graph.zip"
    export_dl4j_graph(net, str(path))
    back = import_dl4j_computation_graph(str(path), device="cpu")
    got = np.asarray(back.output(x))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_graph_import_frozen_reference_fixture():
    """Byte-frozen fixture zip in the exact Jackson shape (WRAPPER_OBJECT
    vertices, networkInputs/vertexInputs names, vertices deliberately
    listed OUT of topological order, Adam updaterState.bin) — the
    reference's regressiontest discipline (RegressionTest080.java loads
    release-era artifacts) rather than JSON built adjacent to the code
    under test. Regenerate ONLY with tests/fixtures/make_cg_fixture.py
    and only for deliberate format-version bumps."""
    import os as _os

    from deeplearning4j_tpu_torch.modelimport.dl4j import updater_state_to_flat

    fixtures = _os.path.join(_os.path.dirname(_os.path.abspath(__file__)),
                             "fixtures")
    path = _os.path.join(fixtures, "cg_adam_v1.zip")
    expected = np.load(_os.path.join(fixtures, "cg_adam_v1_expected.npz"))

    net = import_dl4j_computation_graph(path, device="cpu")
    np.testing.assert_allclose(np.asarray(net.output(expected["x"])),
                               expected["out"], rtol=1e-5, atol=1e-6)
    # resume state: iteration counter + the Adam [m|v] block view survive
    assert net.iteration == int(expected["iteration"])
    assert net.net_conf.updater == "adam"
    # flat-walk order: FIFO Kahn over JSON-order vertex numbers -> b, a, out
    np.testing.assert_allclose(
        updater_state_to_flat(
            net, indexed_layer_confs=[
                (net._pidx[n], net.conf.vertices[n].layer)
                for n in ("b", "a", "out")]),
        expected["updater_state"], atol=0, rtol=0)


def test_dl4j_topo_matches_reference_kahn():
    """FIFO Kahn with ascending-index tie-break: inputs first, then both
    ready children in vertex-number order, etc."""
    order = _dl4j_topo_names(
        ["in"], ["z", "a", "out"],
        {"z": ["in"], "a": ["in"], "out": ["z", "a"]})
    assert order == ["in", "z", "a", "out"]
    # diamond where JSON order disagrees with readiness
    order = _dl4j_topo_names(
        ["x"], ["c", "b"], {"c": ["b"], "b": ["x"]})
    assert order == ["x", "b", "c"]


def test_bn_lock_gamma_beta_import(tmp_path):
    """lockGammaBeta zips carry only mean/var (2*nOut floats); gamma/beta
    come from the conf constants (reference
    BatchNormalizationParamInitializer)."""
    import io as _io
    import json as _json
    import zipfile as _zipfile
    from deeplearning4j_tpu_torch.modelimport.dl4j import write_nd4j_array

    rng = np.random.default_rng(9)
    n = 4
    W = rng.standard_normal((n, 2)).astype(np.float32)
    b = rng.standard_normal(2).astype(np.float32)
    mean = rng.standard_normal(n).astype(np.float32)
    var = (rng.random(n).astype(np.float32) + 0.5)
    conf = {"confs": [
        {"layer": {"batchNormalization": {
            "nin": n, "nout": n, "eps": 1e-5, "decay": 0.9,
            "lockGammaBeta": True, "gamma": 2.0, "beta": 0.5}}},
        {"layer": {"output": {"nin": n, "nout": 2,
                              "activationFn": "softmax",
                              "lossFn": "mcxent"}}},
    ]}
    flat = np.concatenate([mean, var, W.reshape(-1, order="F"), b])
    buf = _io.BytesIO()
    write_nd4j_array(flat, buf)
    p = tmp_path / "bn_locked.zip"
    with _zipfile.ZipFile(p, "w") as zf:
        zf.writestr("configuration.json", _json.dumps(conf))
        zf.writestr("coefficients.bin", buf.getvalue())
    net = import_dl4j_multilayer(str(p), device="cpu")
    p0 = net.params_list[0]
    np.testing.assert_allclose(np.asarray(p0["gamma"]), np.full(n, 2.0))
    np.testing.assert_allclose(np.asarray(p0["beta"]), np.full(n, 0.5))
    st = net.state_list[0]
    np.testing.assert_allclose(np.asarray(st["mean"]), mean, rtol=1e-6)
    np.testing.assert_allclose(np.asarray(st["var"]), var, rtol=1e-6)
    # and the forward APPLIES the locked constants (gamma*xhat + beta),
    # matching the reference's lockGammaBeta semantics
    x = rng.standard_normal((6, n)).astype(np.float32)
    xhat = (x - mean) / np.sqrt(var + 1e-5)
    logits = (2.0 * xhat + 0.5) @ W + b
    e = np.exp(logits - logits.max(axis=1, keepdims=True))
    want = e / e.sum(axis=1, keepdims=True)
    np.testing.assert_allclose(np.asarray(net.output(x)), want,
                               rtol=1e-4, atol=1e-5)


# -- updaterState.bin --------------------------------------------------------------


from deeplearning4j_tpu_torch.modelimport.dl4j import (
    _UPDATER_COMPONENTS,
    export_dl4j_graph,
    export_dl4j_zip,
    import_dl4j_computation_graph,
    import_dl4j_multilayer,
    restore_updater_state,
    updater_state_to_flat,
)
from deeplearning4j_tpu_torch.nn.compgraph import ComputationGraph
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.layers import (
    BatchNormalization,
    DenseLayer,
    GravesLSTM,
    OutputLayer,
    RnnOutputLayer,
)
from deeplearning4j_tpu_torch.nn.conf.network import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork


def _cls_data(n=32, nin=6, k=4, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, nin)).astype(np.float32)
    y = np.zeros((n, k), np.float32)
    y[np.arange(n), rng.integers(0, k, n)] = 1.0
    return x, y


def _mlp_net_u(updater="adam", seed=5):
    conf = (NeuralNetConfiguration.builder().seed(seed)
            .updater(updater).learning_rate(0.05)
            .weight_init("xavier").list()
            .layer(DenseLayer(n_out=9, activation="tanh"))
            .layer(BatchNormalization())
            .layer(OutputLayer(n_out=4, activation="softmax", loss="mcxent"))
            .set_input_type(InputType.feed_forward(6)).build())
    return MultiLayerNetwork(conf, device="cpu").init()


def _max_param_diff(a, b):
    return max(
        float(np.max(np.abs(np.asarray(pa[k]) - np.asarray(pb[k]))))
        for pa, pb in zip(a.params_list, b.params_list) for k in pa
    )


@pytest.mark.parametrize("updater", ["adam", "nesterovs", "rmsprop",
                                     "adagrad", "adamax", "adadelta"])
def test_resume_matches_uninterrupted(tmp_path, updater):
    """export mid-training -> import -> one more step == uninterrupted."""
    x, y = _cls_data()
    net = _mlp_net_u(updater)
    net.fit(x, y, batch_size=16, epochs=2, async_prefetch=False)

    path = str(tmp_path / "mid.zip")
    export_dl4j_zip(net, path)
    back = import_dl4j_multilayer(path, device="cpu")
    assert back.iteration == net.iteration
    assert back.net_conf.updater == updater

    # the moments made the trip exactly
    a = updater_state_to_flat(net)
    b = updater_state_to_flat(back)
    np.testing.assert_allclose(a, b, atol=0, rtol=0)

    # one more epoch on both: identical trajectories
    net.fit(x, y, batch_size=16, epochs=1, async_prefetch=False)
    back.fit(x, y, batch_size=16, epochs=1, async_prefetch=False)
    assert _max_param_diff(net, back) < 1e-6


def test_cold_updater_diverges(tmp_path):
    """Sanity: WITHOUT the updater state the resumed trajectory differs —
    proves the test above actually exercises the moments."""
    x, y = _cls_data()
    net = _mlp_net_u("adam")
    net.fit(x, y, batch_size=16, epochs=2, async_prefetch=False)
    path = str(tmp_path / "mid.zip")
    export_dl4j_zip(net, path)
    cold = import_dl4j_multilayer(path, load_updater=False, device="cpu")
    net.fit(x, y, batch_size=16, epochs=1, async_prefetch=False)
    cold.fit(x, y, batch_size=16, epochs=1, async_prefetch=False)
    assert _max_param_diff(net, cold) > 1e-6


def test_graves_lstm_state_layout_round_trip(tmp_path):
    """Gate-permuted + peephole-packed moment layout survives the trip."""
    conf = (NeuralNetConfiguration.builder().seed(3)
            .updater("adam").learning_rate(0.02).list()
            .layer(GravesLSTM(n_out=7, activation="tanh"))
            .layer(RnnOutputLayer(n_out=2, activation="softmax",
                                  loss="mcxent"))
            .set_input_type(InputType.recurrent(3)).build())
    net = MultiLayerNetwork(conf, device="cpu").init()
    rng = np.random.default_rng(0)
    x = rng.standard_normal((16, 8, 3)).astype(np.float32)
    yy = np.zeros((16, 8, 2), np.float32)
    yy[..., 0] = 1.0
    net.fit(x, yy, batch_size=16, epochs=2, async_prefetch=False)

    path = str(tmp_path / "lstm.zip")
    export_dl4j_zip(net, path)
    back = import_dl4j_multilayer(path, device="cpu")
    np.testing.assert_allclose(updater_state_to_flat(net),
                               updater_state_to_flat(back), atol=0, rtol=0)
    net.fit(x, yy, batch_size=16, epochs=1, async_prefetch=False)
    back.fit(x, yy, batch_size=16, epochs=1, async_prefetch=False)
    assert _max_param_diff(net, back) < 1e-6


def test_state_view_halves_are_m_then_v():
    """Pin the nd4j block layout: for a one-block Adam net, the first half
    of the view is ALL m (in flat param order), the second ALL v."""
    conf = (NeuralNetConfiguration.builder().seed(1)
            .updater("adam").learning_rate(0.05).list()
            .layer(DenseLayer(n_out=5, activation="tanh"))
            .layer(OutputLayer(n_out=2, activation="softmax", loss="mcxent"))
            .set_input_type(InputType.feed_forward(3)).build())
    net = MultiLayerNetwork(conf, device="cpu").init()
    x, y = _cls_data(16, 3, 2)
    net.fit(x, y, batch_size=16, epochs=1, async_prefetch=False)
    flat = updater_state_to_flat(net)
    n = net.num_params()
    assert flat.size == 2 * n
    m0 = np.asarray(net.upd_state[0]["W"]["m"]).reshape(-1, order="F")
    v0 = np.asarray(net.upd_state[0]["W"]["v"]).reshape(-1, order="F")
    np.testing.assert_allclose(flat[: m0.size], m0)
    np.testing.assert_allclose(flat[n: n + v0.size], v0)


def test_bn_mean_var_split_blocks():
    """BN running mean/var are NONE-updater params in DL4J: they carry no
    state but break block contiguity, so the layers before and after BN
    form separate [m|v] blocks rather than one."""
    net = _mlp_net_u("adam")
    x, y = _cls_data()
    net.fit(x, y, batch_size=32, epochs=1, async_prefetch=False)
    flat = updater_state_to_flat(net)
    sizes = [sum(int(np.prod(np.asarray(v).shape)) for v in p.values())
             for p in net.params_list]
    assert flat.size == 2 * sum(sizes)
    # block 1 = dense W+b + bn gamma+beta; its m-half must START with
    # dense W's m and the v-half with dense W's v
    blk1 = sizes[0] + sizes[1]
    mW = np.asarray(net.upd_state[0]["W"]["m"]).reshape(-1, order="F")
    vW = np.asarray(net.upd_state[0]["W"]["v"]).reshape(-1, order="F")
    np.testing.assert_allclose(flat[: mW.size], mW)
    np.testing.assert_allclose(flat[blk1: blk1 + vW.size], vW)
    # block 2 = output W+b, its own [m|v]
    mW2 = np.asarray(net.upd_state[2]["W"]["m"]).reshape(-1, order="F")
    np.testing.assert_allclose(flat[2 * blk1: 2 * blk1 + mW2.size], mW2)


def test_graph_resume_matches_uninterrupted(tmp_path):
    conf = (NeuralNetConfiguration.builder().seed(9)
            .updater("adam").learning_rate(0.03)
            .graph_builder().add_inputs("in")
            .add_layer("d", DenseLayer(n_out=8, activation="relu"), "in")
            .add_layer("out", OutputLayer(n_out=4, activation="softmax",
                                          loss="mcxent"), "d")
            .set_outputs("out")
            .set_input_types(InputType.feed_forward(6))
            .build())
    net = ComputationGraph(conf, device="cpu").init()
    x, y = _cls_data()
    net.fit(x, y, batch_size=16, epochs=2, async_prefetch=False)
    path = str(tmp_path / "graph.zip")
    export_dl4j_graph(net, path)
    back = import_dl4j_computation_graph(path, device="cpu")
    assert back.iteration == net.iteration
    net.fit(x, y, batch_size=16, epochs=1, async_prefetch=False)
    back.fit(x, y, batch_size=16, epochs=1, async_prefetch=False)
    assert _max_param_diff(net, back) < 1e-6


def test_stateless_updater_writes_no_entry(tmp_path):
    net = _mlp_net_u("sgd")
    x, y = _cls_data()
    net.fit(x, y, batch_size=32, epochs=1, async_prefetch=False)
    assert updater_state_to_flat(net).size == 0
    path = str(tmp_path / "sgd.zip")
    export_dl4j_zip(net, path)
    import zipfile

    with zipfile.ZipFile(path) as zf:
        assert "updaterState.bin" not in zf.namelist()
    back = import_dl4j_multilayer(path, device="cpu")
    np.testing.assert_allclose(np.asarray(back.output(x)),
                               np.asarray(net.output(x)), atol=1e-6)


# -- across packages ------------------------------------------------------------


def _jax_graves(seed=11):
    from deeplearning4j_tpu.nn.conf import (
        GravesLSTM as JGraves, InputType as JIT, NeuralNetConfiguration as JNNC,
        RnnOutputLayer as JRnnOut)
    from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN

    return JMLN(JNNC.builder().seed(seed).updater("adam").learning_rate(0.02)
                .weight_init("xavier").list()
                .layer(JGraves(n_out=7, activation="tanh"))
                .layer(JRnnOut(n_out=3, activation="softmax", loss="mcxent"))
                .set_input_type(JIT.recurrent(5)).build()).init()


def test_a_jax_exported_zip_imports_into_the_port_exactly(tmp_path):
    from deeplearning4j_tpu.modelimport import dl4j as jdl4j

    jnet = _jax_graves()
    rng = np.random.default_rng(5)
    x = rng.standard_normal((4, 10, 5)).astype(np.float32)
    y = np.zeros((4, 10, 3), np.float32)
    y[..., 1] = 1.0
    jnet.fit(x, y, batch_size=4, epochs=2, async_prefetch=False)
    path = str(tmp_path / "jax.zip")
    jdl4j.export_dl4j_zip(jnet, path)
    tnet = import_dl4j_multilayer(path, device="cpu")
    jback = jdl4j.import_dl4j_multilayer(path)
    for pj, pt in zip(jback.params_list, tnet.params_list):
        for k in pj:
            np.testing.assert_array_equal(pt[k].numpy(), np.asarray(pj[k]))
    np.testing.assert_array_equal(updater_state_to_flat(tnet),
                                  jdl4j.updater_state_to_flat(jback))
    assert tnet.iteration == jback.iteration == jnet.iteration
    np.testing.assert_allclose(tnet.output(x).numpy(), np.asarray(jnet.output(x)),
                               rtol=1e-5, atol=1e-6)
    # and back: the port's export is the JAX package's, byte for byte
    tpath = str(tmp_path / "port.zip")
    export_dl4j_zip(tnet, tpath)
    import zipfile as _zf

    with _zf.ZipFile(path) as a, _zf.ZipFile(tpath) as b:
        for name in a.namelist():
            assert a.read(name) == b.read(name), name


def test_one_adam_step_from_the_imported_state_matches_the_jax_package(tmp_path):
    from deeplearning4j_tpu.modelimport import dl4j as jdl4j

    import os as _os

    path = _os.path.join(_os.path.dirname(_os.path.abspath(__file__)),
                         "fixtures", "cg_adam_v1.zip")
    expected = np.load(_os.path.join(_os.path.dirname(_os.path.abspath(__file__)),
                                     "fixtures", "cg_adam_v1_expected.npz"))
    jnet = jdl4j.import_dl4j_computation_graph(path)
    tnet = import_dl4j_computation_graph(path, device="cpu")
    x = expected["x"]
    rng = np.random.default_rng(7)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, x.shape[0])]
    jnet.fit(x, y, batch_size=x.shape[0], epochs=1, async_prefetch=False)
    tnet.fit(x, y, batch_size=x.shape[0], epochs=1, async_prefetch=False)
    for pj, pt in zip(jnet.params_list, tnet.params_list):
        for k in pj:
            np.testing.assert_allclose(pt[k].numpy(), np.asarray(pj[k]),
                                       rtol=1e-5, atol=1e-7)

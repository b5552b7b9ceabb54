"""The port's model zip (deeplearning4j_tpu_torch/utils/model_serializer.py)
against the JAX package's: zips cross-load both ways with exact
parameters, layer state, updater state and counters; the entries the
writers produce are the same bytes (`.npz` entries are compared member by
member, since `np.savez` stamps each member with the wall-clock time);
integrity verification gives the same per-entry statuses; and a snapshot
taken before an in-place optimizer step holds the pre-step state.

Nets: a small char-LSTM (vocab 7, hidden 8, 2 GravesLSTM layers, TBPTT 4,
RMSProp), `tiny_resnet_conf` (Nesterovs, BN running statistics), and
small nets holding every layer of the second layer slice: AutoEncoder,
RBM, VAE, a frozen dense layer and a center-loss head (its centers are
layer state); Convolution1D, Subsampling1D, self-attention and masked-free
global pooling over time; ZeroPadding, LocalResponseNormalization and a
frozen BN in a CNN; and a graph with a frozen conv and a center-loss head.
Each is trained a couple of steps so the updater state and counters are
not at their initial values. JAX runs the Pallas kernels in interpret mode.
Outputs agree to rtol 1e-5 (f32); everything read from a zip is exact.
"""

import io
import json
import os
import zipfile

import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.data.dataset import DataSet as JDataSet
from deeplearning4j_tpu.models import resnet as jresnet
from deeplearning4j_tpu.models.charlstm import char_lstm_conf as jchar_conf
from deeplearning4j_tpu.nn.compgraph import ComputationGraph as JCG
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN
from deeplearning4j_tpu.ops import pallas_conv_bn, pallas_lstm
from deeplearning4j_tpu.train import checkpoint as jckpt
from deeplearning4j_tpu.utils import model_serializer as jms
from deeplearning4j_tpu_torch.data import DataSet
from deeplearning4j_tpu_torch.nn.compgraph import ComputationGraph
from deeplearning4j_tpu_torch.nn.conf import (
    ComputationGraphConfiguration,
    MultiLayerConfiguration,
)
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.ops import fused_conv_bn
from deeplearning4j_tpu_torch.train import checkpoint as tckpt
from deeplearning4j_tpu_torch.train.checkpoint import CheckpointListener
from deeplearning4j_tpu_torch.utils import model_serializer as tms

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
OUT_RTOL = 1e-5
BYTE_IDENTICAL = ("configuration.json", "meta.json", "coefficients.bin")


@pytest.fixture(autouse=True)
def _interpret_mode():
    old = pallas_lstm._INTERPRET, pallas_conv_bn._INTERPRET
    pallas_lstm._INTERPRET = pallas_conv_bn._INTERPRET = True
    yield
    pallas_lstm._INTERPRET, pallas_conv_bn._INTERPRET = old
    fused_conv_bn._STATS_STASH.clear()


def _charlstm_data(seed=0):
    rng = np.random.default_rng(seed)
    x = np.eye(7, dtype=np.float32)[rng.integers(0, 7, (2, 8))]
    y = np.eye(7, dtype=np.float32)[rng.integers(0, 7, (2, 8))]
    return x, y


def _resnet_data(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((4, 8, 8, 3)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 4)]
    return x, y


def _ff_data(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(size=(6, 8)).astype(np.float32)
    return x, np.eye(3, dtype=np.float32)[rng.integers(0, 3, 6)]


def _seq_data(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((4, 9, 3)).astype(np.float32)
    return x, np.eye(3, dtype=np.float32)[rng.integers(0, 3, 4)]


def _cnn_data(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((4, 6, 6, 2)).astype(np.float32)
    return x, np.eye(3, dtype=np.float32)[rng.integers(0, 3, 4)]


def _slice_conf(kind):
    """JAX confs holding the second layer slice's layers."""
    from deeplearning4j_tpu.nn.conf import layers as JL
    from deeplearning4j_tpu.nn.conf.inputs import InputType as JIT
    from deeplearning4j_tpu.nn.conf.network import NeuralNetConfiguration as JNNC

    b = (JNNC.builder().seed(4).updater("adam").learning_rate(0.01)
         .weight_init("xavier"))
    if kind == "graph":
        gb = b.graph_builder().add_inputs("in")
        gb.add_layer("conv", JL.FrozenLayer(inner=JL.ConvolutionLayer(
            n_in=2, n_out=3, kernel_size=(3, 3), activation="relu")), "in")
        gb.add_layer("pool", JL.GlobalPoolingLayer(pooling_type="avg"), "conv")
        gb.add_layer("out", JL.CenterLossOutputLayer(n_in=3, n_out=3, activation="softmax",
                                                     alpha=0.3, lambda_=0.1), "pool")
        return gb.set_outputs("out").set_input_types(JIT.convolutional(6, 6, 2)).build()
    lb = b.list()
    if kind == "ff":
        lb = (lb.layer(JL.AutoEncoder(n_out=7, activation="sigmoid"))
              .layer(JL.RBM(n_out=6, activation="sigmoid"))
              .layer(JL.VariationalAutoencoder(n_out=5, encoder_layer_sizes=[6],
                                               decoder_layer_sizes=[6]))
              .layer(JL.FrozenLayer(inner=JL.DenseLayer(n_out=4, activation="tanh")))
              .layer(JL.CenterLossOutputLayer(n_out=3, activation="softmax",
                                              alpha=0.3, lambda_=0.1))
              .set_input_type(JIT.feed_forward(8)))
    elif kind == "seq":
        lb = (lb.layer(JL.Convolution1DLayer(n_out=4, kernel_size=3, activation="tanh"))
              .layer(JL.Subsampling1DLayer(pooling_type="max", kernel_size=2, stride=1))
              .layer(JL.SelfAttentionLayer(n_out=4, n_heads=2))
              .layer(JL.GlobalPoolingLayer(pooling_type="avg"))
              .layer(JL.OutputLayer(n_out=3, activation="softmax"))
              .set_input_type(JIT.recurrent(3)))
    else:
        lb = (lb.layer(JL.ZeroPaddingLayer(padding=(1, 1, 0, 2)))
              .layer(JL.ConvolutionLayer(n_out=4, kernel_size=(3, 3), activation="relu"))
              .layer(JL.LocalResponseNormalization(n=3.0))
              .layer(JL.FrozenLayer(inner=JL.BatchNormalization()))
              .layer(JL.SubsamplingLayer(pooling_type="max", kernel_size=(2, 2),
                                         stride=(2, 2)))
              .layer(JL.OutputLayer(n_out=3, activation="softmax"))
              .set_input_type(JIT.convolutional(6, 6, 2)))
    return lb.build()


CASES = {
    "charlstm": (lambda: jchar_conf(vocab_size=7, hidden=8, layers=2,
                                    tbptt_length=4, learning_rate=0.01),
                 JMLN, MultiLayerNetwork, MultiLayerConfiguration,
                 _charlstm_data),
    "tiny_resnet": (lambda: jresnet.tiny_resnet_conf(), JCG, ComputationGraph,
                    ComputationGraphConfiguration, _resnet_data),
    "slice2_ff": (lambda: _slice_conf("ff"), JMLN, MultiLayerNetwork,
                  MultiLayerConfiguration, _ff_data),
    "slice2_seq": (lambda: _slice_conf("seq"), JMLN, MultiLayerNetwork,
                   MultiLayerConfiguration, _seq_data),
    "slice2_cnn": (lambda: _slice_conf("cnn"), JMLN, MultiLayerNetwork,
                   MultiLayerConfiguration, _cnn_data),
    "slice2_graph": (lambda: _slice_conf("graph"), JCG, ComputationGraph,
                     ComputationGraphConfiguration, _cnn_data),
}


def _trained_jax(which):
    make_conf, jcls, _, _, data = CASES[which]
    jn = jcls(make_conf()).init()
    x, y = data()
    jn.fit(JDataSet(x, y), epochs=1, batch_size=len(x), async_prefetch=False)
    return jn


def _trained_port(which):
    make_conf, _, tcls, tconf_cls, data = CASES[which]
    tn = tcls(tconf_cls.from_json(make_conf().to_json()), device="cpu").init()
    x, y = data(1)
    tn.fit(DataSet(x, y), epochs=1, batch_size=len(x))
    return tn


def _np(t):
    return t.detach().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)


def _assert_same_state(tn, jn):
    """Exact equality of params, layer state, updater state, counters."""
    for name, port_tree, jax_tree in (
            ("params", tn.params_list, jn.params_list),
            ("layer state", tn.state_list, jn.state_list),
            ("updater state", tn.upd_state, jn.upd_state)):
        pl = tms.tree_leaves(port_tree)
        jl = jax.tree_util.tree_leaves(jax_tree)
        assert len(pl) == len(jl), name
        for i, (a, b) in enumerate(zip(pl, jl)):
            a, b = _np(a), np.asarray(b)
            assert a.dtype == b.dtype and a.shape == b.shape, (name, i)
            np.testing.assert_array_equal(a, b, err_msg=f"{name} leaf {i}")
    assert (tn.iteration, tn.epoch) == (int(jn.iteration), int(jn.epoch))


def _assert_same_outputs(tn, jn, which):
    x, _ = CASES[which][4](2)
    np.testing.assert_allclose(_np(tn.output(x)), np.asarray(jn.output(x)),
                               rtol=OUT_RTOL, atol=1e-6)


def _npz_members(data: bytes):
    with np.load(io.BytesIO(data)) as npz:
        return {k: npz[k] for k in npz.files}


def _assert_same_entries(path_a, path_b):
    with zipfile.ZipFile(path_a) as za, zipfile.ZipFile(path_b) as zb:
        assert za.namelist() == zb.namelist()
        for name in BYTE_IDENTICAL:
            assert za.read(name) == zb.read(name), name
        for name in za.namelist():
            if not name.endswith(".npz"):
                continue
            ma, mb = _npz_members(za.read(name)), _npz_members(zb.read(name))
            assert sorted(ma) == sorted(mb), name
            for k in ma:
                assert ma[k].dtype == mb[k].dtype, (name, k)
                assert ma[k].shape == mb[k].shape, (name, k)
                assert ma[k].tobytes() == mb[k].tobytes(), (name, k)


# -- cross-loading ---------------------------------------------------------------


@pytest.mark.parametrize("which", sorted(CASES))
def test_jax_zip_loads_in_the_port_and_saves_back_the_same_entries(which, tmp_path):
    jn = _trained_jax(which)
    jpath, tpath = str(tmp_path / "jax.zip"), str(tmp_path / "port.zip")
    jms.save_model(jn, jpath)
    tn = tms.load_model(jpath, device="cpu")
    assert type(tn).__name__ == type(jn).__name__
    _assert_same_state(tn, jn)
    _assert_same_outputs(tn, jn, which)
    tms.save_model(tn, tpath)
    _assert_same_entries(jpath, tpath)


@pytest.mark.parametrize("which", sorted(CASES))
def test_port_zip_loads_in_jax_with_the_same_entries(which, tmp_path):
    tn = _trained_port(which)
    assert tn.iteration > 0
    tpath, jpath = str(tmp_path / "port.zip"), str(tmp_path / "jax.zip")
    tms.save_model(tn, tpath)
    jn = jms.load_model(tpath)
    _assert_same_state(tn, jn)
    _assert_same_outputs(tn, jn, which)
    jms.save_model(jn, jpath)
    _assert_same_entries(tpath, jpath)


def test_slice2_zips_carry_centers_and_frozen_layers(tmp_path):
    """The center-loss centers (trained away from zero) and the frozen
    layers' untouched parameters survive a JAX zip into the port."""
    jn = _trained_jax("slice2_ff")
    jpath = str(tmp_path / "jax.zip")
    jms.save_model(jn, jpath)
    tn = tms.load_model(jpath, device="cpu")
    centers = tn.state_list[-1]["centers"]
    assert centers.shape == (3, 4) and float(centers.abs().max()) > 0
    assert type(tn.layer_confs[3]).__name__ == "FrozenLayer"
    assert tn._trainable_keys()[3] == []


@pytest.mark.parametrize("preset", ["lenet", "lenet_bf16", "vgg16", "vgg16_small"])
def test_preset_json_round_trips(preset):
    """The lenet and vgg16 presets' JSON: the port's preset equals the JAX
    package's, and each package reads the other's back to the same text."""
    from deeplearning4j_tpu.models import lenet as jlenet
    from deeplearning4j_tpu.models import vgg16 as jvgg
    from deeplearning4j_tpu.nn.conf.network import MultiLayerConfiguration as JMLC
    from deeplearning4j_tpu_torch.models import lenet as tlenet
    from deeplearning4j_tpu_torch.models import vgg16 as tvgg

    make = {"lenet": lambda m: m.lenet_conf(),
            "lenet_bf16": lambda m: m.lenet_conf(precision="bf16", seed=3),
            "vgg16": lambda m: m.vgg16_conf(),
            "vgg16_small": lambda m: m.vgg16_conf(num_classes=5, image_size=32,
                                                  precision="f32")}[preset]
    jmod, tmod = (jlenet, tlenet) if preset.startswith("lenet") else (jvgg, tvgg)
    js, ts = make(jmod).to_json(), make(tmod).to_json()
    assert ts == js
    assert MultiLayerConfiguration.from_json(js).to_json() == js
    assert JMLC.from_json(ts).to_json() == ts
    assert MultiLayerConfiguration.from_yaml(make(tmod).to_yaml()).to_json() == js


@pytest.mark.parametrize("host_resident", [True, False])
def test_recsys_preset_json_round_trips(host_resident):
    """The recsys preset's JSON, with the table host-resident and on the
    device: the port's equals the JAX package's and each reads the other's
    back to the same text, `host_resident` included."""
    from deeplearning4j_tpu.models import recsys as jrecsys
    from deeplearning4j_tpu.nn.conf.network import MultiLayerConfiguration as JMLC
    from deeplearning4j_tpu_torch.models import recsys as trecsys

    js = jrecsys.recsys_conf(vocab=5000, hidden=32, host_resident=host_resident).to_json()
    ts = trecsys.recsys_conf(vocab=5000, hidden=32, host_resident=host_resident).to_json()
    assert ts == js
    back = MultiLayerConfiguration.from_json(js)
    assert back.to_json() == js
    assert back.layers[0].host_resident is host_resident
    assert JMLC.from_json(ts).to_json() == ts


def test_recsys_zips_cross_load_both_ways(tmp_path):
    """A trained recsys net's zip (table, tower, SGD counters) loads in the
    other package to the same parameters and outputs, both ways."""
    from deeplearning4j_tpu.models import recsys as jrecsys
    from deeplearning4j_tpu_torch.models import recsys as trecsys

    rng = np.random.default_rng(5)
    x = rng.integers(0, 300, (16, 1)).astype(np.float32)
    y = np.eye(2, dtype=np.float32)[(x[:, 0].astype(np.int64) & 1)]
    jn = jrecsys.recsys_network(vocab=300, dim=8, hidden=16, host_resident=False)
    jn.fit(JDataSet(x, y), epochs=2)
    jpath, tpath = str(tmp_path / "jax.zip"), str(tmp_path / "port.zip")
    jms.save_model(jn, jpath)
    tn = tms.load_model(jpath, device="cpu")
    assert tn.layer_confs[0].host_resident is False
    for jp, tp in zip(jn.params_list, tn.params_list):
        for k in jp:
            assert np.asarray(jp[k]).tobytes() == tp[k].numpy().tobytes(), k
    np.testing.assert_allclose(tn.output(x).numpy(), np.asarray(jn.output(x)),
                               rtol=OUT_RTOL)
    tn2 = trecsys.recsys_network(vocab=300, dim=8, hidden=16, host_resident=True,
                                 device="cpu")
    tn2.fit(DataSet(x, y), epochs=2)
    tms.save_model(tn2, tpath)
    jn2 = jms.load_model(tpath)
    assert jn2.layer_confs[0].host_resident is True
    for jp, tp in zip(jn2.params_list, tn2.params_list):
        for k in jp:
            assert np.asarray(jp[k]).tobytes() == tp[k].numpy().tobytes(), k
    assert jn2.iteration == tn2.iteration == 2


def test_leaf_order_is_jax_tree_util_order():
    """Sorted dict keys at every level, None an empty subtree, lists in
    order — checked on a tree with unsorted insertion order."""
    tree = [{"b": {"z": 1, "a": 2}, "a": 3}, None, {"c": [4, None, 5]}, {}]
    assert tms.tree_leaves(tree) == jax.tree_util.tree_leaves(tree)
    leaves = [10, 20, 30, 40, 50]
    treedef = jax.tree_util.tree_structure(tree)
    assert (tms._tree_unflatten(tree, leaves)
            == jax.tree_util.tree_unflatten(treedef, leaves))


def test_train_state_rides_along_and_reads_back_in_both_packages(tmp_path):
    tn = _trained_port("charlstm")
    ts = {"epoch": 1, "batch_in_epoch": 2, "iterator_state": {"epoch": 1}}
    path = str(tmp_path / "m.zip")
    tms.save_model(tn, path, train_state=ts)
    assert tms.read_train_state(path) == ts == jms.read_train_state(path)


def test_save_without_updater_loads_a_fresh_updater(tmp_path):
    tn = _trained_port("charlstm")
    path = str(tmp_path / "m.zip")
    tms.save_model(tn, path, save_updater=False)
    assert "updaterState.npz" not in zipfile.ZipFile(path).namelist()
    back = tms.load_model(path, device="cpu")
    assert torch.equal(back.params(), tn.params())
    assert all(not v.any() for v in tms.tree_leaves(back.upd_state))


# -- the DL4J-era fixture (format v1) ----------------------------------------------


def test_format_v1_fixture_loads_and_matches_its_expected_outputs():
    """The JAX package's golden file: flat f32 layerState.bin /
    updaterState.bin, read through the v1 fallback."""
    expected = np.load(os.path.join(FIXTURES, "mln_adam_v1_expected.npz"))
    net = tms.load_model(os.path.join(FIXTURES, "mln_adam_v1.zip"),
                         device="cpu")
    out = _np(net.output(expected["x"]))
    np.testing.assert_allclose(out, expected["out"], rtol=1e-5, atol=1e-6)
    assert net.iteration == int(expected["iteration"])
    jn = jms.load_model(os.path.join(FIXTURES, "mln_adam_v1.zip"))
    _assert_same_state(net, jn)


def test_wrong_type_restore_raises(tmp_path):
    tn = _trained_port("charlstm")
    path = str(tmp_path / "m.zip")
    tms.save_model(tn, path)
    with pytest.raises(ValueError, match="not a ComputationGraph"):
        tms.restore_computation_graph(path, device="cpu")
    assert isinstance(tms.restore_multi_layer_network(path, device="cpu"),
                      MultiLayerNetwork)


# -- integrity --------------------------------------------------------------------


def _damaged(kind, tmp_path):
    tn = _trained_port("charlstm")
    path = str(tmp_path / f"{kind}.zip")
    tms.save_model(tn, path)
    if kind == "corrupt":
        tckpt.corrupt_zip_entry(path)
    elif kind == "torn":
        with open(path, "rb") as f:
            data = f.read()
        with open(path, "wb") as f:
            f.write(data[: len(data) // 2])
    elif kind == "legacy":
        with zipfile.ZipFile(path) as zf:
            entries = {n: zf.read(n) for n in zf.namelist()
                       if n != "manifest.json"}
        with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as zf:
            for n, d in entries.items():
                zf.writestr(n, d)
    elif kind == "bit_flip_in_named_entry":
        tckpt.corrupt_zip_entry(path, "meta.json")
    return path


@pytest.mark.parametrize("kind", ["corrupt", "torn", "legacy",
                                  "bit_flip_in_named_entry", "intact"])
def test_verify_checkpoint_gives_the_jax_packages_statuses(kind, tmp_path):
    path = _damaged(kind, tmp_path)
    got, want = tms.verify_checkpoint(path), jms.verify_checkpoint(path)
    assert got["ok"] == want["ok"] and got["legacy"] == want["legacy"]
    assert ({n: e["status"] for n, e in got["entries"].items()}
            == {n: e["status"] for n, e in want["entries"].items()})
    assert ("error" in got) == ("error" in want)
    assert got["ok"] == (kind in ("legacy", "intact"))


def test_corrupt_zip_entry_damages_the_same_byte_as_the_jax_package(tmp_path):
    tn = _trained_port("charlstm")
    a, b = str(tmp_path / "a.zip"), str(tmp_path / "b.zip")
    tms.save_model(tn, a)
    with open(a, "rb") as f:
        data = f.read()
    with open(b, "wb") as f:
        f.write(data)
    assert tckpt.corrupt_zip_entry(a) == jckpt.corrupt_zip_entry(b)
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()


# -- snapshot isolation under the in-place updater -----------------------------------


def test_async_snapshot_holds_the_pre_step_state_after_an_in_place_step(tmp_path):
    """Capture asynchronously, run one more optimizer STEP (which adds
    to the parameters and overwrites the RMSProp state in place), then
    flush: the published zip holds the pre-step params and updater state
    bit for bit."""
    tn = _trained_port("charlstm")
    before_p = tn.params().clone()
    before_u = [t.clone() for t in tms.tree_leaves(tn.upd_state)]
    x, y = _charlstm_data(3)
    with CheckpointListener(str(tmp_path / "ck"), every_n_epochs=None,
                            async_save=True) as lst:
        path = lst.save(tn, reason="manual")
        tn.fit(DataSet(x, y), epochs=1, batch_size=len(x))
        assert not torch.equal(tn.params(), before_p)  # the step did land
        lst.flush()
    back = tms.load_model(path, device="cpu")
    assert torch.equal(back.params(), before_p)
    for a, b in zip(tms.tree_leaves(back.upd_state), before_u):
        assert torch.equal(a, b)


def test_snapshot_clones_every_leaf():
    tn = _trained_port("tiny_resnet")
    snap = tms.ModelSnapshot.capture(tn)
    live = {id(t) for t in tms.tree_leaves(
        [tn.params_list, tn.state_list, tn.upd_state])}
    held = tms.tree_leaves([snap.params_list, snap.state_list, snap.upd_state])
    assert held and not any(id(t) in live for t in held)
    assert snap.ready is None  # CPU tensors: no event to wait on


def test_in_place_updater_commit_is_bit_equal_to_add():
    """The in-place updater step gives the bits of adding `apply_tree`'s
    update with `p.add_(u)`."""
    from deeplearning4j_tpu_torch.train.updaters import make_updater

    g = torch.Generator().manual_seed(0)
    params = [{"W": torch.randn(5, 4, generator=g), "b": torch.randn(4, generator=g)}]
    grads = [{k: torch.randn(v.shape, generator=g) for k, v in params[0].items()}]
    upd = make_updater("nesterovs", learning_rate=0.1)
    state = upd.init_tree(params)
    ref_p = {k: v.clone() for k, v in params[0].items()}
    ref_s = {k: {n: t.clone() for n, t in s.items()} for k, s in state[0].items()}
    for step in range(2):
        u, ns = upd.apply_tree(grads, [ref_s], 0.1, float(step))
        for k in ref_p:
            ref_p[k].add_(u[0][k])
            ref_s[k] = ns[0][k]
        upd.step_(params, grads, state, 0.1, float(step))
    for k in ref_p:
        assert torch.equal(params[0][k], ref_p[k])
        assert torch.equal(state[0][k]["v"], ref_s[k]["v"])


# -- restore into an existing net ---------------------------------------------------------


def test_restore_fit_state_refuses_a_changed_configuration(tmp_path):
    tn = _trained_port("charlstm")
    path = str(tmp_path / "m.zip")
    tms.save_model(tn, path)
    other = MultiLayerNetwork(MultiLayerConfiguration.from_json(
        jchar_conf(vocab_size=7, hidden=9, layers=2, tbptt_length=4,
                   learning_rate=0.01).to_json()), device="cpu").init()
    with pytest.raises(tms.ConfigMismatchError):
        tms.restore_fit_state(other, path)
    lr_only = MultiLayerNetwork(MultiLayerConfiguration.from_json(
        jchar_conf(vocab_size=7, hidden=8, layers=2, tbptt_length=4,
                   learning_rate=0.02).to_json()), device="cpu").init()
    with pytest.raises(tms.ConfigMismatchError):
        tms.restore_fit_state(lr_only, path)
    meta = tms.restore_fit_state(lr_only, path, ignore_lr=True)
    assert torch.equal(lr_only.params(), tn.params())
    assert meta["iteration"] == tn.iteration and meta["train_state"] is None
    assert json.loads(lr_only.conf.to_json())["net_conf"]["learning_rate"] == 0.02

"""The port's transfer learning (nn/transferlearning.py: TransferLearning.
Builder, GraphTransferLearning, TransferLearningHelper) against the JAX
package's, on the CPU.

Both packages build from the same source network (configuration JSON,
parameters and BN state carried across); the built configurations must
be equal JSON, the kept parameters and state bit-equal copies, and the
layers a builder re-initializes are set to the JAX package's draws before
training. f32 scores rtol 1e-5 and parameters rtol 1e-5 / atol 1e-6 after
the steps (the same expressions, summed in another order); through the
tiny ResNet's BN blocks rtol 1e-4 / atol 1e-5 (tests/test_torch_resnet.py's
GRAD_RTOL for the same network). Frozen leaves
and their updater state are held bit-unchanged (torch.equal) after fit,
eager and under set_fused_steps.
"""

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.models import resnet as jresnet
from deeplearning4j_tpu.nn.compgraph import ComputationGraph as JCG
from deeplearning4j_tpu.nn.conf import layers as JL
from deeplearning4j_tpu.nn.conf.inputs import InputType as JIT
from deeplearning4j_tpu.nn.conf.network import NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN
from deeplearning4j_tpu.nn import transferlearning as jtl
from deeplearning4j_tpu.ops import pallas_conv_bn as pcb
from deeplearning4j_tpu.train.listeners import IterationListener as JListener
from deeplearning4j_tpu_torch.data.dataset import DataSet as TDS
from deeplearning4j_tpu_torch.nn import transferlearning as ttl
from deeplearning4j_tpu_torch.nn.compgraph import ComputationGraph as TCG
from deeplearning4j_tpu_torch.nn.conf import layers as TL
from deeplearning4j_tpu_torch.nn.conf.graph import ComputationGraphConfiguration
from deeplearning4j_tpu_torch.nn.conf.network import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork as TMLN
from deeplearning4j_tpu_torch.nn.params import params_from_numpy, states_from_numpy
from deeplearning4j_tpu_torch.ops import fused_conv_bn as fcb
from deeplearning4j_tpu_torch.ops import helpers
from deeplearning4j_tpu_torch.train.listeners import IterationListener as TListener

SCORE = dict(rtol=1e-5, atol=0)
PARAM = dict(rtol=1e-5, atol=1e-6)
GRAPH_PARAM = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(autouse=True)
def _interpret_mode():
    old = pcb._INTERPRET
    pcb._INTERPRET = False  # the JAX package's XLA path, as the port's builtin one
    yield
    pcb._INTERPRET = old
    fcb._STATS_STASH.clear()


def _np_tree(tree):
    return [None if p is None else {k: np.asarray(v) for k, v in p.items()} for p in tree]


def _load_jax_weights(tnet, jnet):
    tnet.params_list = params_from_numpy(tnet.conf, _np_tree(jnet.params_list), device="cpu")
    tnet.state_list = states_from_numpy(tnet.conf, _np_tree(jnet.state_list), device="cpu")
    tnet.upd_state = tnet.updater_def.init_tree(tnet.params_list)
    return tnet


def _port_of(jnet):
    if isinstance(jnet, JCG):
        tnet = TCG(ComputationGraphConfiguration.from_json(jnet.conf.to_json()), device="cpu")
    else:
        tnet = TMLN(MultiLayerConfiguration.from_json(jnet.conf.to_json()), device="cpu")
    return _load_jax_weights(tnet.init(), jnet)


class _Scores:
    def __init__(self):
        self.scores = []

    def iteration_done(self, model, iteration, info):
        self.scores.append(float(info["score"]()))

    def on_epoch_start(self, model, epoch):
        pass

    def on_epoch_end(self, model, epoch):
        pass


class _JScores(_Scores, JListener):
    pass


class _TScores(_Scores, TListener):
    pass


def _src_conf():
    return (JNNC.builder().seed(12).updater("nesterovs").learning_rate(0.05)
            .momentum(0.9).weight_init("xavier").list()
            .layer(JL.DenseLayer(n_out=10, activation="relu"))
            .layer(JL.BatchNormalization())
            .layer(JL.DenseLayer(n_out=7, activation="tanh"))
            .layer(JL.OutputLayer(n_out=4, activation="softmax", loss="mcxent"))
            .set_input_type(JIT.feed_forward(6)).build())


def _xy(n=32, nout=4, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, 6)).astype(np.float32)
    y = np.eye(nout, dtype=np.float32)[rng.integers(0, nout, n)]
    return x, y


def _trained_pair():
    """A trained JAX source network and its port copy."""
    jsrc = JMLN(_src_conf()).init()
    x, y = _xy()
    jsrc.fit(x, y, epochs=2, batch_size=8, async_prefetch=False)
    return jsrc, _port_of(jsrc)


def _builds(jsrc, tsrc, build):
    """build(TransferLearning.Builder of that package) on both sources: the
    same JSON, kept parameters and state bit-equal; the port net then
    takes the JAX net's re-initialized layers."""
    jnew = build(jtl.TransferLearning.Builder(jsrc), JL).build()
    tnew = build(ttl.TransferLearning.Builder(tsrc), TL).build()
    assert tnew.conf.to_json() == jnew.conf.to_json()
    assert tnew.device.type == "cpu"
    for i, (tp, jp) in enumerate(zip(tnew.params_list, jnew.params_list)):
        if i < len(jsrc.params_list) and all(
                k in jsrc.params_list[i] and jp[k].shape == jsrc.params_list[i][k].shape
                and np.array_equal(np.asarray(jp[k]), np.asarray(jsrc.params_list[i][k]))
                for k in jp):
            for k in tp:  # a kept layer: a copy of the source's tensors
                assert np.array_equal(tp[k].numpy(), np.asarray(jp[k]))
                assert tp[k].data_ptr() != tsrc.params_list[i][k].data_ptr()
    return jnew, _load_jax_weights(tnew, jnew)


def _fit_compare(jnet, tnet, x, y, epochs=2, batch=8, ptol=PARAM):
    jl, tl = _JScores(), _TScores()
    jnet.set_listeners(jl)
    tnet.set_listeners(tl)
    jnet.fit(x, y, epochs=epochs, batch_size=batch, async_prefetch=False)
    tnet.fit(x, y, epochs=epochs, batch_size=batch, async_prefetch=False)
    assert len(tl.scores) == len(jl.scores) > 0
    np.testing.assert_allclose(tl.scores, jl.scores, **SCORE)
    for tp, jp in zip(tnet.params_list, jnet.params_list):
        for k in tp:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), **ptol)
    for ts, js in zip(tnet.state_list, jnet.state_list):
        for k in (ts or {}):
            np.testing.assert_allclose(ts[k].numpy(), np.asarray(js[k]), **ptol)


_BUILDS = {
    "freeze": lambda b, L: b.set_feature_extractor(1),
    "freeze_replace": lambda b, L: (b.set_feature_extractor(1)
                                    .n_out_replace(3, 3, weight_init="xavier")
                                    .fine_tune_configuration(learning_rate=0.02)),
    "replace_middle": lambda b, L: b.n_out_replace(2, 5, weight_init="xavier"),
    "remove_add": lambda b, L: (b.set_feature_extractor(2).remove_output_layer()
                                .add_layer(L.DenseLayer(n_out=6, activation="relu"))
                                .add_layer(L.OutputLayer(n_out=3, activation="softmax",
                                                         loss="mcxent"))),
}


@pytest.mark.parametrize("name", sorted(_BUILDS))
def test_builder_matches_jax_and_trains_alike(name):
    jsrc, tsrc = _trained_pair()
    jnew, tnew = _builds(jsrc, tsrc, _BUILDS[name])
    n_out = tnew.layer_confs[-1].n_out
    x, y = _xy(n=24, nout=n_out, seed=3)
    _fit_compare(jnew, tnew, x, y)
    # the source networks are untouched by the builders and the fits
    assert not isinstance(tsrc.layer_confs[0], TL.FrozenLayer)
    for tp, jp in zip(tsrc.params_list, jsrc.params_list):
        for k in tp:
            assert np.array_equal(tp[k].numpy(), np.asarray(jp[k]))


def test_fine_tune_rejects_an_unknown_hyperparameter():
    _, tsrc = _trained_pair()
    with pytest.raises(ValueError, match="unknown fine-tune"):
        ttl.TransferLearning.Builder(tsrc).fine_tune_configuration(bogus=1).build()
    with pytest.raises(ValueError, match="removed more layers"):
        ttl.TransferLearning.Builder(tsrc).remove_layers_from_output(9).build()


def _snapshot(net, frozen):
    return ({i: {k: v.clone() for k, v in net.params_list[i].items()} for i in frozen},
            {i: {k: {n: t.clone() for n, t in s.items()} for k, s in net.upd_state[i].items()}
             for i in frozen},
            {i: (None if net.state_list[i] is None
                 else {k: v.clone() for k, v in net.state_list[i].items()}) for i in frozen})


def _assert_unchanged(net, snap, frozen):
    params, upd, state = snap
    for i in frozen:
        for k, v in params[i].items():
            assert torch.equal(net.params_list[i][k], v)
        for k, s in upd[i].items():
            for n, t in s.items():
                assert torch.equal(net.upd_state[i][k][n], t)
        for k, v in (state[i] or {}).items():
            assert torch.equal(net.state_list[i][k], v)


@pytest.mark.parametrize("updater", ["nesterovs", "adam", "rmsprop"])
def test_frozen_leaves_stay_bit_equal_eager_and_fused(updater):
    """After fit, eager and under set_fused_steps(2), every frozen leaf, its
    updater state and the frozen BN's running statistics are bit-equal to
    their values before; the fused fit equals the loop bit for bit."""
    jsrc, tsrc = _trained_pair()
    tnew = (ttl.TransferLearning.Builder(tsrc).set_feature_extractor(1)
            .fine_tune_configuration(updater=updater).build())
    frozen = [0, 1]
    fused = ttl.TransferLearning.Builder(tsrc).set_feature_extractor(1) \
        .fine_tune_configuration(updater=updater).build()
    fused.params_list = [{k: v.clone() for k, v in p.items()} for p in tnew.params_list]
    fused.upd_state = fused.updater_def.init_tree(fused.params_list)
    fused.set_fused_steps(2)
    x, y = _xy(n=32, seed=5)
    head = tnew.params_list[3]["W"].clone()
    for net in (tnew, fused):
        snap = _snapshot(net, frozen)
        net.fit(x, y, epochs=2, batch_size=8, async_prefetch=False)
        _assert_unchanged(net, snap, frozen)
    assert fused._programs
    assert not torch.equal(head, tnew.params_list[3]["W"])
    for a, b in zip(tnew.params_list, fused.params_list):
        for k in a:
            assert torch.equal(a[k], b[k])


def test_frozen_layers_take_no_gradient():
    """The step asks autograd for the trainable leaves only."""
    _, tsrc = _trained_pair()
    tnew = ttl.TransferLearning.Builder(tsrc).set_feature_extractor(1).build()
    assert tnew._trainable_keys() == [[], [], ["W", "b"], ["W", "b"]]
    seen = []
    grad = torch.autograd.grad

    def spy(outputs, inputs, **kw):
        seen.append([tuple(t.shape) for t in inputs])
        return grad(outputs, inputs, **kw)

    x, y = _xy(n=8)
    torch.autograd.grad = spy
    try:
        tnew.fit(x, y, batch_size=8, async_prefetch=False)
    finally:
        torch.autograd.grad = grad
    assert seen == [[(10, 7), (7,), (7, 4), (4,)]]


def test_helper_featurize_and_fit_featurized():
    """TransferLearningHelper: the features equal the JAX helper's; the tail
    trained on them gives the same scores as the JAX helper's and as the
    port's full network fine-tuned on the raw input, and its parameters
    land in the full network."""
    jsrc, tsrc = _trained_pair()
    jnew = jtl.TransferLearning.Builder(jsrc).set_feature_extractor(1).build()
    tnew = ttl.TransferLearning.Builder(tsrc).set_feature_extractor(1).build()
    full = ttl.TransferLearning.Builder(tsrc).set_feature_extractor(1).build()
    from deeplearning4j_tpu.data.dataset import DataSet as JDS

    x, y = _xy(n=24, seed=7)
    jh, th = jtl.TransferLearningHelper(jnew), ttl.TransferLearningHelper(tnew)
    assert th.boundary == jh.boundary == 2
    jf, tf = jh.featurize(JDS(x, y)), th.featurize(TDS(x, y))
    np.testing.assert_allclose(tf.features.numpy(), np.asarray(jf.features), rtol=1e-5,
                               atol=1e-6)
    jl, tl, fl = _JScores(), _TScores(), _TScores()
    jh.unfrozen_network().set_listeners(jl)
    th.unfrozen_network().set_listeners(tl)
    full.set_listeners(fl)
    jh.fit_featurized(np.asarray(jf.features), y, epochs=2, batch_size=8)
    th.fit_featurized(tf.features, y, epochs=2, batch_size=8)
    full.fit(x, y, epochs=2, batch_size=8, async_prefetch=False)
    np.testing.assert_allclose(tl.scores, jl.scores, **SCORE)
    np.testing.assert_allclose(tl.scores, fl.scores, rtol=1e-6)
    for i in (2, 3):
        for k in tnew.params_list[i]:
            assert torch.equal(tnew.params_list[i][k], th.tail.params_list[i - 2][k])
            np.testing.assert_allclose(tnew.params_list[i][k].numpy(),
                                       full.params_list[i][k].numpy(), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(tnew.output(x).numpy(), np.asarray(jnew.output(x)), **PARAM)
    with pytest.raises(ValueError, match="no frozen layers"):
        ttl.TransferLearningHelper(tsrc)


# -- graphs ------------------------------------------------------------------

@pytest.fixture
def fused_cpu_path(monkeypatch):
    """The conv/BN probes at their structural scope (what a Hopper GPU
    routes), so CPU tensors take the kernels' plain versions; the calls of
    each plain version are counted."""
    monkeypatch.setattr(helpers._HELPERS["conv2d"], "supported",
                        lambda **c: fcb.conv_decision(**c)["status"] == "covered")
    monkeypatch.setattr(helpers._HELPERS["batch_norm"], "supported",
                        lambda **c: c["training"] and fcb.peek_stats(c["x"]))
    monkeypatch.setattr(helpers._HELPERS["bn_backward"], "supported",
                        lambda **c: c["training"])
    calls = {"conv": 0, "bn_apply": 0, "bn_reduce": 0, "bn_dx": 0}

    def counted(name, fn):
        def wrap(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrap

    for attr, name in (("conv1x1_stats_reference", "conv"), ("conv_kxk_stats_reference", "conv"),
                       ("bn_normalize_reference", "bn_apply"),
                       ("bn_backward_reduce_reference", "bn_reduce"),
                       ("bn_backward_apply_reference", "bn_dx")):
        monkeypatch.setattr(fcb, attr, counted(name, getattr(fcb, attr)))
    return calls


def _graph_build(b, L):
    return (b.set_feature_extractor("s0b0_relu").n_out_replace("out", 5, weight_init="xavier")
            .fine_tune_configuration(learning_rate=0.02))


def _graph_pair():
    jsrc = JCG(jresnet.tiny_resnet_conf()).init()
    tsrc = _port_of(jsrc)
    jnew = _graph_build(jtl.GraphTransferLearning(jsrc), JL).build()
    tnew = _graph_build(ttl.GraphTransferLearning(tsrc), TL).build()
    assert tnew.conf.to_json() == jnew.conf.to_json()
    return jnew, _load_jax_weights(tnew, jnew)


def _graph_xy(n=6, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, 8, 8, 3)).astype(np.float32)
    return x, np.eye(5, dtype=np.float32)[rng.integers(0, 5, n)]


def _frozen_idx(net):
    return [i for i, c in enumerate(net._layer_confs) if isinstance(c, TL.FrozenLayer)]


def test_graph_transfer_matches_jax():
    jnew, tnew = _graph_pair()
    frozen = _frozen_idx(tnew)
    frozen_names = {tnew.layer_vertex_names[i] for i in frozen}
    assert "stem_conv" in frozen_names and "s0b0_c_bn" in frozen_names
    assert "s1b0_a_conv" not in frozen_names and "out" not in frozen_names
    # no frozen BN is marked for the fused ReLU: the marks are s1b0's
    assert set(tnew.relu_fused_bn) == {"s1b0_a_bn", "s1b0_b_bn"}
    snap = _snapshot(tnew, frozen)
    x, y = _graph_xy()
    _fit_compare(jnew, tnew, x, y, epochs=3, batch=3, ptol=GRAPH_PARAM)
    _assert_unchanged(tnew, snap, frozen)


def test_graph_transfer_kernels_reach_the_unfrozen_stage_only(fused_cpu_path):
    """With the probes at their structural scope, a step runs the conv/BN
    kernels' plain versions for the unfrozen stage's 4 convs and 4 BNs
    only; the scores agree with the builtin path, and the frozen leaves
    stay bit-equal, eager and fused."""
    jnew, tnew = _graph_pair()
    builtin = tnew.clone()
    frozen = _frozen_idx(tnew)
    snap = _snapshot(tnew, frozen)
    x, y = _graph_xy(n=6, seed=1)
    steps = 2
    tl = _TScores()
    tnew.set_listeners(tl)
    tnew.fit(x, y, epochs=steps, batch_size=6, async_prefetch=False)
    assert fused_cpu_path == {"conv": 4 * steps, "bn_apply": 4 * steps,
                              "bn_reduce": 4 * steps, "bn_dx": 4 * steps}
    _assert_unchanged(tnew, snap, frozen)
    for name in ("conv2d", "batch_norm", "bn_backward"):
        helpers.set_helper_enabled(name, False)
    try:
        bl = _TScores()
        builtin.set_listeners(bl)
        builtin.fit(x, y, epochs=steps, batch_size=6, async_prefetch=False)
    finally:
        for name in ("conv2d", "batch_norm", "bn_backward"):
            helpers.set_helper_enabled(name, True)
    np.testing.assert_allclose(tl.scores, bl.scores, rtol=1e-5)
    fused = _graph_pair()[1].set_fused_steps(2)
    snap = _snapshot(fused, frozen)
    fused.fit(x, y, epochs=2, batch_size=3, async_prefetch=False)
    assert fused._programs
    _assert_unchanged(fused, snap, frozen)


def test_graph_builder_vertex_edits_match_jax():
    """remove_vertex_and_connections, add_layer, add_vertex, set_outputs."""
    from deeplearning4j_tpu.nn.conf.graph import ElementWiseVertex as JEW
    from deeplearning4j_tpu_torch.nn.conf.graph import ElementWiseVertex as TEW

    jsrc = JCG(jresnet.tiny_resnet_conf()).init()
    tsrc = _port_of(jsrc)

    def build(b, L, EW):
        return (b.remove_vertex_and_connections("out")
                .add_layer("fc", L.DenseLayer(n_in=16, n_out=16, activation="relu"), "avgpool")
                .add_vertex("skip", EW(op="add"), "fc", "avgpool")
                .add_layer("out2", L.OutputLayer(n_in=16, n_out=2, activation="softmax",
                                                 loss="mcxent"), "skip")
                .set_outputs("out2")).build()

    jnew, tnew = build(jtl.GraphTransferLearning(jsrc), JL, JEW), \
        build(ttl.GraphTransferLearning(tsrc), TL, TEW)
    assert tnew.conf.to_json() == jnew.conf.to_json()
    _load_jax_weights(tnew, jnew)
    x, _ = _graph_xy(n=4)
    np.testing.assert_allclose(tnew.output(x).numpy(), np.asarray(jnew.output(x)), **PARAM)
    with pytest.raises(ValueError, match="still consumes"):
        ttl.GraphTransferLearning(tsrc).remove_vertex_and_connections("avgpool").build()
    with pytest.raises(ValueError, match="non-layer vertex"):
        ttl.GraphTransferLearning(tsrc).n_out_replace("s0b0_c_bn", 4).build()

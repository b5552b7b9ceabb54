"""The port's fused fit dispatch against its own per-step loop and against
the JAX package's fused `fit`, on the CPU.

The port's counterparts of tests/test_fused_fit.py (`set_fused_steps`:
k same-shape batches as one program) and tests/test_tbptt_fused.py (all
of a listener-free TBPTT batch's segments as one program). On the CPU a
fused program is the same loop of eager steps that a CUDA graph replays
on the card, so the port's fused path must equal the port's loop bit for
bit: parameters, updater state, score and iteration count. The loop is
forced by a listener, the JAX package's own switch, or by
`set_fused_steps(1)`.

Against the JAX package's fused fit, from the same parameters (carried
across with `params_from_numpy`), the tolerances are the port's usual
f32 ones: scores 1e-5 relative, parameters and updater state 1e-4 at each
tensor's scale (sums in another order, compounded over the steps).
Where a layer draws random numbers (dropout) the two packages' draws
differ, so only the port's fused path and its loop are compared.
"""

import copy

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn.compgraph import ComputationGraph as JCG
from deeplearning4j_tpu.nn.conf import (
    DenseLayer,
    GravesLSTM,
    InputType,
    LSTM,
    NeuralNetConfiguration,
    OutputLayer,
    RnnOutputLayer,
)
from deeplearning4j_tpu.nn.conf.network import BackpropType
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN
from deeplearning4j_tpu_torch.data import DataSet
from deeplearning4j_tpu_torch.nn.compgraph import ComputationGraph as TCG
from deeplearning4j_tpu_torch.nn.conf.graph import ComputationGraphConfiguration
from deeplearning4j_tpu_torch.nn.conf.network import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork as TMLN
from deeplearning4j_tpu_torch.nn.params import params_from_numpy
from deeplearning4j_tpu_torch.train.listeners import IterationListener

SCORE_RTOL = 1e-5
PARAM_RTOL = 1e-4


class _NoOp(IterationListener):
    """Forces the per-step loop (listeners must see their iteration)."""

    def iteration_done(self, model, iteration, info):
        pass


def _leaves(tree):
    if torch.is_tensor(tree):
        return [tree]
    if isinstance(tree, dict):
        return [v for k in sorted(tree) for v in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [v for t in tree for v in _leaves(t)]
    return []


def _bit_equal(a, b):
    """Two port nets left in the same state, bit for bit."""
    assert a.iteration == b.iteration
    for x, y in zip(_leaves([a.params_list, a.upd_state, a.state_list]),
                    _leaves([b.params_list, b.upd_state, b.state_list])):
        assert torch.equal(x, y)
    assert torch.equal(a._score, b._score)


def _close(port, ref, rtol):
    p = np.asarray(port.detach(), np.float64)
    r = np.asarray(ref, np.float64)
    np.testing.assert_allclose(p, r, rtol=rtol, atol=rtol * max(np.abs(r).max(), 1e-30))


def _near_jax(tnet, jnet):
    """The port's net against the JAX package's after the same fit."""
    assert tnet.iteration == jnet.iteration
    np.testing.assert_allclose(float(tnet._score), float(jnet._score), rtol=SCORE_RTOL)
    for tp, jp in zip(tnet.params_list, jnet.params_list):
        for k in jp:
            _close(tp[k], jp[k], PARAM_RTOL)
    for tu, ju in zip(tnet.upd_state, jnet.upd_state):
        for k in ju:
            for n in ju[k]:
                _close(tu[k][n], ju[k][n], PARAM_RTOL)


def _ports(jnet, n=2):
    """`n` port nets on the JAX net's configuration and parameters."""
    graph = isinstance(jnet, JCG)
    conf_cls = ComputationGraphConfiguration if graph else MultiLayerConfiguration
    tconf = conf_cls.from_json(jnet.conf.to_json())
    nets = []
    for _ in range(n):
        t = (TCG if graph else TMLN)(copy.deepcopy(tconf), device="cpu").init()
        t.params_list = params_from_numpy(
            tconf, [{k: np.asarray(v) for k, v in p.items()} for p in jnet.params_list],
            device="cpu")
        nets.append(t)
    return nets


# -- set_fused_steps: the standard program ------------------------------------


def _mlp_conf(dropout=0.0):
    return (
        NeuralNetConfiguration.builder()
        .seed(11)
        .updater("adam")
        .learning_rate(0.01)
        .list()
        .layer(DenseLayer(n_out=16, activation="relu", dropout=dropout))
        .layer(OutputLayer(n_out=3, activation="softmax", loss="mcxent"))
        .set_input_type(InputType.feed_forward(8))
        .build()
    )


def _cls_data(n=96, nin=8, k=3, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, nin)).astype(np.float32)
    y = np.zeros((n, k), np.float32)
    y[np.arange(n), rng.integers(0, k, n)] = 1.0
    return x, y


def _std_trio(conf_fn, k, x, y, epochs, batch_size):
    """(JAX fused, port loop, port fused) after the same fit."""
    jnet = JMLN(conf_fn()).init()
    loop, fused = _ports(jnet)
    jnet.set_fused_steps(k)
    fused.set_fused_steps(k)
    jnet.fit(x, y, epochs=epochs, batch_size=batch_size, async_prefetch=False)
    for net in (loop, fused):
        net.fit(x, y, epochs=epochs, batch_size=batch_size, async_prefetch=False)
    return jnet, loop, fused


def test_fused_std_matches_loop_exact_chunks():
    x, y = _cls_data(96)  # batch 24 -> 4 batches: one k=4 group an epoch
    jnet, loop, fused = _std_trio(_mlp_conf, 4, x, y, 3, 24)
    assert fused.iteration == loop.iteration == 12
    assert len(fused._programs) == 1
    _bit_equal(loop, fused)
    _near_jax(fused, jnet)


def test_fused_std_ragged_tail_falls_back():
    # 96 / 20 -> 4 full batches (one fused group) + a ragged 16 whose
    # signature change sends it down the per-step path
    x, y = _cls_data(96)
    jnet, loop, fused = _std_trio(_mlp_conf, 4, x, y, 2, 20)
    assert fused.iteration == loop.iteration == 10
    _bit_equal(loop, fused)
    _near_jax(fused, jnet)


def test_fused_std_dropout_rng_matches():
    # dropout draws from the per-step generator: the fused program seeds
    # step j's from iteration + j, as the loop does
    x, y = _cls_data(96)
    jnet = JMLN(_mlp_conf(dropout=0.5)).init()
    loop, fused = _ports(jnet)
    fused.set_fused_steps(4)
    for net in (loop, fused):
        net.fit(x, y, epochs=2, batch_size=24, async_prefetch=False)
    assert fused._draws_random()
    _bit_equal(loop, fused)


def test_fused_chunk_smaller_than_k_falls_back():
    x, y = _cls_data(48)  # 2 batches of 24 < k=8 -> per-step path
    jnet, loop, fused = _std_trio(_mlp_conf, 8, x, y, 2, 24)
    assert fused.iteration == loop.iteration == 4
    assert not fused._programs
    _bit_equal(loop, fused)
    _near_jax(fused, jnet)


# -- set_fused_steps: the cross-batch TBPTT program ----------------------------


def _rnn_conf(cell=LSTM, fwd=4, bwd=None, updater="adam", dropout=0.0, seed=5):
    return (
        NeuralNetConfiguration.builder()
        .seed(seed)
        .updater(updater)
        .learning_rate(0.02)
        .list()
        .layer(cell(n_out=8, activation="tanh", dropout=dropout))
        .layer(RnnOutputLayer(n_out=2, activation="softmax", loss="mcxent"))
        .set_input_type(InputType.recurrent(3))
        .backprop_type(BackpropType.TRUNCATED_BPTT)
        .t_bptt_lengths(fwd, fwd if bwd is None else bwd)
        .build()
    )


def _seq_xy(n=32, t=12, seed=2):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, t, 3)).astype(np.float32)
    cs = np.cumsum(x[..., 0], axis=1)
    y = np.zeros((n, t, 2), np.float32)
    y[..., 0] = (cs <= 0).astype(np.float32)
    y[..., 1] = (cs > 0).astype(np.float32)
    return x, y


def test_fused_tbptt_cross_batch_matches_loop():
    x, y = _seq_xy(n=64)  # batch 16 -> 4 fit batches x 3 segments each
    jnet = JMLN(_rnn_conf()).init().set_fused_steps(2)
    loop, fused = _ports(jnet)
    loop.add_listener(_NoOp())
    fused.set_fused_steps(2)
    jnet.fit(x, y, epochs=2, batch_size=16, async_prefetch=False)
    for net in (loop, fused):
        net.fit(x, y, epochs=2, batch_size=16, async_prefetch=False)
    assert fused.iteration == loop.iteration == 24  # 2 epochs x 4 x 3
    assert [key[0] + str(key[2]) for key in fused._programs] == ["tbptt2"]
    _bit_equal(loop, fused)
    _near_jax(fused, jnet)


# -- ComputationGraph ------------------------------------------------------------


def _graph_conf():
    return (
        NeuralNetConfiguration.builder()
        .seed(3)
        .updater("adam")
        .learning_rate(0.01)
        .graph_builder()
        .add_inputs("in")
        .add_layer("d", DenseLayer(n_out=16, activation="relu"), "in")
        .add_layer("out", OutputLayer(n_out=3, activation="softmax", loss="mcxent"), "d")
        .set_outputs("out")
        .set_input_types(InputType.feed_forward(8))
        .build()
    )


def test_fused_graph_matches_loop():
    x, y = _cls_data(96)
    jnet = JCG(_graph_conf()).init().set_fused_steps(4)
    loop, fused = _ports(jnet)
    fused.set_fused_steps(4)
    jnet.fit(x, y, epochs=3, batch_size=24, async_prefetch=False)
    for net in (loop, fused):
        net.fit(x, y, epochs=3, batch_size=24, async_prefetch=False)
    assert fused.iteration == loop.iteration == 12
    assert len(fused._programs) == 1
    _bit_equal(loop, fused)
    _near_jax(fused, jnet)


def _rnn_graph_conf(fwd=4, bwd=4):
    return (
        NeuralNetConfiguration.builder().seed(5)
        .updater("adam").learning_rate(0.02)
        .graph_builder().add_inputs("seq")
        .add_layer("lstm", LSTM(n_out=8, activation="tanh"), "seq")
        .add_layer("out", RnnOutputLayer(n_out=2, activation="softmax", loss="mcxent"),
                   "lstm")
        .set_outputs("out")
        .set_input_types(InputType.recurrent(3))
        .backprop_type("tbptt")
        .t_bptt_lengths(fwd, bwd)
        .build()
    )


@pytest.mark.parametrize("fwd,bwd", [(4, 4), (6, 3)])
def test_graph_tbptt_fused_matches_loop(fwd, bwd):
    """ComputationGraph TBPTT (ported in this slice): all of a batch's
    segments as one program equals the per-segment loop, with the
    truncated loss builder when bwd < fwd; and both equal the JAX
    package's fused TBPTT within the tolerances."""
    x, y = _seq_xy(t=12)
    jnet = JCG(_rnn_graph_conf(fwd, bwd)).init()
    loop, fused = _ports(jnet)
    loop.add_listener(_NoOp())
    jnet.fit(x, y, epochs=2, batch_size=16, async_prefetch=False)
    for net in (loop, fused):
        net.fit(x, y, epochs=2, batch_size=16, async_prefetch=False)
    assert fused.iteration == loop.iteration == 2 * 2 * (12 // fwd)
    assert len(fused._programs) == 1
    _bit_equal(loop, fused)
    _near_jax(fused, jnet)


def test_graph_tbptt_ragged_tail_falls_back():
    x, y = _seq_xy(t=10)  # 10 % 4 != 0 -> the loop on both
    jnet = JCG(_rnn_graph_conf(4, 4)).init()
    loop, fused = _ports(jnet)
    loop.add_listener(_NoOp())
    jnet.fit(x, y, epochs=1, batch_size=16, async_prefetch=False)
    for net in (loop, fused):
        net.fit(x, y, epochs=1, batch_size=16, async_prefetch=False)
    assert fused.iteration == loop.iteration == 2 * 3
    assert not fused._programs
    _bit_equal(loop, fused)
    _near_jax(fused, jnet)


def test_fused_listeners_disable_fusion():
    from deeplearning4j_tpu_torch.train.listeners import CollectScoresIterationListener

    x, y = _cls_data(96)
    net = _ports(JMLN(_mlp_conf()).init(), 1)[0].set_fused_steps(4)
    collector = CollectScoresIterationListener()
    net.add_listener(collector)
    net.fit(x, y, epochs=1, batch_size=24, async_prefetch=False)
    # listeners force the per-step path: one callback per iteration
    assert len(collector.scores) == 4
    assert not net._programs


# -- fused TBPTT within one batch (tests/test_tbptt_fused.py) -------------------


def _tbptt_trio(conf_kwargs, data_kwargs=None, epochs=2, mask=False):
    """(JAX fused, port loop, port fused) after one fit on one DataSet."""
    x, y = _seq_xy(**{"n": 16, **(data_kwargs or {})})
    fm = lm = None
    if mask:
        t = x.shape[1]
        lengths = np.random.default_rng(3).integers(t // 2, t + 1, x.shape[0])
        fm = (np.arange(t)[None, :] < lengths[:, None]).astype(np.float32)
        lm = fm.copy()
    jnet = JMLN(_rnn_conf(seed=7, **conf_kwargs)).init()
    loop, fused = _ports(jnet)
    loop.add_listener(_NoOp())
    from deeplearning4j_tpu.data import DataSet as JDataSet

    jnet.fit(JDataSet(x, y, features_mask=fm, labels_mask=lm), epochs=epochs,
             async_prefetch=False)
    for net in (loop, fused):
        net.fit(DataSet(x, y, fm, lm), epochs=epochs, async_prefetch=False)
    return jnet, loop, fused


@pytest.mark.parametrize("updater", ["adam", "nesterovs"])
def test_fused_matches_loop_params_and_updater(updater):
    jnet, loop, fused = _tbptt_trio({"fwd": 4, "updater": updater})
    assert fused.iteration == loop.iteration == 2 * 3  # 12 / 4 segments
    assert len(fused._programs) == 1
    _bit_equal(loop, fused)
    _near_jax(fused, jnet)


def test_fused_matches_loop_with_backward_truncation():
    # bwd < fwd: the truncated loss builder inside the fused program
    jnet, loop, fused = _tbptt_trio({"fwd": 6, "bwd": 3})
    _bit_equal(loop, fused)
    _near_jax(fused, jnet)


def test_fused_matches_loop_with_dropout_rng():
    _, loop, fused = _tbptt_trio({"fwd": 4, "dropout": 0.5})
    assert fused._draws_random() and len(fused._programs) == 1
    _bit_equal(loop, fused)


def test_fused_matches_loop_with_masks():
    jnet, loop, fused = _tbptt_trio({"fwd": 4}, mask=True)
    _bit_equal(loop, fused)
    _near_jax(fused, jnet)


def test_fused_single_segment():
    jnet, loop, fused = _tbptt_trio({"fwd": 12})
    assert fused.iteration == loop.iteration == 2
    _bit_equal(loop, fused)
    _near_jax(fused, jnet)


def test_ragged_tail_falls_back_to_loop():
    # T=10, seg=4 -> segments 4/4/2: the fused path declines
    jnet, loop, fused = _tbptt_trio({"fwd": 4}, data_kwargs={"t": 10})
    assert fused.iteration == loop.iteration == 2 * 3
    assert not fused._programs
    _bit_equal(loop, fused)
    _near_jax(fused, jnet)


def test_graves_peepholes_fused():
    jnet, loop, fused = _tbptt_trio({"fwd": 4, "cell": GravesLSTM})
    _bit_equal(loop, fused)
    _near_jax(fused, jnet)


# -- bookkeeping ----------------------------------------------------------------


def test_fused_groups_advance_the_resume_position_by_their_batches():
    """A fused group counts all its batches consumed before it dispatches
    (a checkpoint taken inside it records them), and a ragged group's
    batches one by one: after 2 groups of 4 and a tail of 2, the epoch
    position reads 4, 8, 9, 10 at the dispatches."""
    x, y = _cls_data(100)  # batch 10 -> 10 batches: 4 + 4 + 2
    net = _ports(JMLN(_mlp_conf()).init(), 1)[0].set_fused_steps(4)
    seen = []
    for name in ("_fit_datasets_fused", "_fit_dataset"):
        inner = getattr(net, name)

        def spy(*a, inner=inner):
            seen.append(net.train_state()["batch_in_epoch"])
            return inner(*a)

        setattr(net, name, spy)
    net.fit(x, y, epochs=1, batch_size=10, async_prefetch=False)
    assert seen == [4, 8, 10, 10]
    assert net.iteration == 10


def test_set_params_and_restore_drop_the_fused_programs(tmp_path):
    from deeplearning4j_tpu_torch.utils import model_serializer as ms

    x, y = _cls_data(96)
    net = _ports(JMLN(_mlp_conf()).init(), 1)[0].set_fused_steps(4)
    net.fit(x, y, epochs=1, batch_size=24, async_prefetch=False)
    assert net._programs
    net.set_params(net.params())
    assert not net._programs
    net.fit(x, y, epochs=1, batch_size=24, async_prefetch=False)
    ms.save_model(net, str(tmp_path / "m.zip"))
    ms.restore_fit_state(net, str(tmp_path / "m.zip"))
    assert not net._programs
    assert not net.clone()._programs


def test_lr_schedule_reaches_every_fused_step():
    """The host fills each group's lr column from the schedule: a step
    schedule that changes inside a group gives the loop's bits."""
    def conf():
        c = _mlp_conf()
        c.net_conf.lr_policy = "step"
        c.net_conf.lr_policy_decay_rate = 0.5
        c.net_conf.lr_policy_steps = 3.0
        return c

    x, y = _cls_data(96)
    jnet, loop, fused = _std_trio(conf, 4, x, y, 2, 24)
    _bit_equal(loop, fused)
    _near_jax(fused, jnet)


@pytest.mark.parametrize("fused_k", [1, 2])
def test_fits_keep_the_tensors_a_graph_reads_in_place(fused_k):
    """A captured graph reads and writes the parameters, the updater state
    and the BN running statistics at fixed addresses: every fit path
    (eager steps, fused groups, a ragged tail) updates them in place, so a
    graph captured before stays valid after."""
    from deeplearning4j_tpu_torch.models import resnet as tresnet

    rng = np.random.default_rng(4)
    x = rng.standard_normal((20, 8, 8, 3)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 20)]
    net = TCG(tresnet.tiny_resnet_conf(), device="cpu").init().set_fused_steps(fused_k)
    before = net._state_addresses()
    means = [s["mean"].clone() for s in net.state_list if s is not None]
    net.fit(x, y, epochs=2, batch_size=4)  # 5 batches: groups of 2 and a tail
    assert net.iteration == 10
    assert net._state_addresses() == before
    assert any(not torch.equal(m, s["mean"])
               for m, s in zip(means, [s for s in net.state_list if s is not None]))

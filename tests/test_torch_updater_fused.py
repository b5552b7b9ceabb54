"""The fused optimizer tail (ops/fused_updater.py and `NetworkBase._step`'s
fused branch) on the CPU.

The card runs the tail as one multi-tensor kernel; on the CPU the same
branch runs its plain version (`apply_updater_reference`: the per-leaf
updater with the L2 gradient folded in as g + l2 * w and the L2 terms
added to the score after). A net whose `_fused_tail` is forced on runs
that branch, and is held against an identical net on today's path
(autograd's L2 term and `UpdaterDef.step_`): parameters and updater state
bit-equal at L2 0; at L2 1e-4 and 1e-3 within 1e-6 of each leaf's
largest magnitude, and the score and the diagnostic norm within rtol
1e-6 (the L2 term's gradient and the norm may be summed in another
order). Also: the engagement rule (each decline reason from a small net
that has it, counted per step on the card and replayed from a capture's
tally), and the launch table's packing.
"""

import ctypes

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.models.charlstm import char_lstm_network
from deeplearning4j_tpu_torch.models.resnet import tiny_resnet_conf
from deeplearning4j_tpu_torch.nn import netbase
from deeplearning4j_tpu_torch.nn import transferlearning as ttl
from deeplearning4j_tpu_torch.nn.compgraph import ComputationGraph
from deeplearning4j_tpu_torch.nn.conf import (LSTM, DenseLayer, InputType, NeuralNetConfiguration,
                                               OutputLayer, RnnOutputLayer)
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.ops import fused_updater as fu
from deeplearning4j_tpu_torch.train.sentinel import DivergenceSentinel
from deeplearning4j_tpu_torch.train.updaters import make_updater
from deeplearning4j_tpu_torch.utils.metrics import get_registry

CLOSE = dict(rtol=1e-6, atol=0)


def _mln_conf(updater="nesterovs", l2=0.0, **kw):
    b = NeuralNetConfiguration.builder().seed(2).updater(updater).learning_rate(0.05).l2(l2)
    for k, v in kw.items():
        b = getattr(b, k)(v)
    return (b.list().layer(DenseLayer(n_out=16, activation="tanh"))
            .layer(OutputLayer(n_out=3, activation="softmax", loss="mcxent"))
            .set_input_type(InputType.feed_forward(8)).build())


def _xy(n=32, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, 8)).astype(np.float32)
    return x, np.eye(3, dtype=np.float32)[rng.integers(0, 3, n)]


def _forced(net):
    """`net` with the fused tail forced on: its steps run the fused
    branch, through the plain version on the CPU."""
    net._fused_tail = lambda keys, norm_keys: True
    return net


def _leaves(net):
    out = []
    for p, s in zip(net.params_list, net.upd_state):
        for k in sorted(p):
            out.append(p[k])
            out.extend(s[k][n] for n in sorted(s[k]))
    return out


def _fit_pair(make, fit, steps):
    """(today's, fused) nets after the same `steps` fits, with each step's
    diagnostic."""
    nets, diags = [], []
    for fused in (False, True):
        net = make()
        if fused:
            _forced(net)
        d = []
        for _ in range(steps):
            fit(net)
            d.append(net._step_diag.clone())
        nets.append(net)
        diags.append(torch.stack(d))
    return nets, diags


def _hold(nets, diags, exact):
    """Leaves bit-equal, or within 1e-6 of each leaf's largest magnitude
    (where autograd sums a weight's data gradient from several
    contributions, as an LSTM's W over time, g + l2 * w rounds once where
    autograd rounds twice, and an element whose data gradient cancels its
    L2 term differs by more than 1e-6 of itself)."""
    for a, b in zip(*map(_leaves, nets)):
        if exact:
            assert torch.equal(a, b)
        else:
            assert (b - a).abs().max() <= CLOSE["rtol"] * a.abs().max()
    torch.testing.assert_close(diags[1], diags[0], **CLOSE)
    torch.testing.assert_close(nets[1]._score, nets[0]._score, **CLOSE)


@pytest.mark.parametrize("l2", [0.0, 1e-4, 1e-3])
@pytest.mark.parametrize("updater", ["sgd", "nesterovs", "rmsprop"])
def test_fused_branch_matches_the_per_leaf_path(updater, l2):
    x, y = _xy()
    nets, diags = _fit_pair(lambda: MultiLayerNetwork(_mln_conf(updater, l2), device="cpu").init(),
                            lambda net: net.fit(x, y, batch_size=16), 3)
    _hold(nets, diags, exact=l2 == 0.0)
    assert nets[1]._step_diag[1] > 0


@pytest.mark.parametrize("case", ["lr_mult", "maximize"])
def test_fused_branch_per_leaf_lr_and_maximize(case):
    kw = ({"bias_learning_rate": 0.2} if case == "lr_mult" else {"minimize": False})
    x, y = _xy(seed=1)

    def make():
        conf = _mln_conf("nesterovs", 1e-3, **kw)
        if case == "lr_mult":
            conf.layers[0].learning_rate = 0.01
        return MultiLayerNetwork(conf, device="cpu").init()

    nets, diags = _fit_pair(make, lambda net: net.fit(x, y, batch_size=32), 3)
    _hold(nets, diags, exact=False)


def test_fused_branch_in_a_tbptt_char_lstm_with_l2():
    """RMSProp over both GravesLSTM layers' W, RW, b and peepholes and the
    output layer, L2 on the regularizable ones, as one fused TBPTT batch."""
    rng = np.random.default_rng(3)
    ids = rng.integers(0, 10, (4, 13))
    eye = np.eye(10, dtype=np.float32)
    x, y = eye[ids[:, :-1]], eye[ids[:, 1:]]

    def make():
        net = char_lstm_network(vocab_size=10, hidden=8, tbptt_length=4,
                                learning_rate=0.01, seed=3, device="cpu")
        for layer in net.conf.layers:
            layer.l2 = 1e-3
        return net

    nets, diags = _fit_pair(make, lambda net: net.fit(x, y, batch_size=4), 2)
    _hold(nets, diags, exact=False)


def _truncated_rnn(kind, updater):
    """An LSTM and its RNN output layer under TBPTT 6 with a backward
    length of 2, L2 1e-3, as a MultiLayerNetwork or a ComputationGraph."""
    b = (NeuralNetConfiguration.builder().seed(5).updater(updater).learning_rate(0.02)
         .l2(1e-3))
    lstm = LSTM(n_out=8, activation="tanh")
    out = RnnOutputLayer(n_out=2, activation="softmax", loss="mcxent")
    if kind == "graph":
        conf = (b.graph_builder().add_inputs("seq").add_layer("lstm", lstm, "seq")
                .add_layer("out", out, "lstm").set_outputs("out")
                .set_input_types(InputType.recurrent(3)).backprop_type("tbptt")
                .t_bptt_lengths(6, 2).build())
        return ComputationGraph(conf, device="cpu").init()
    conf = (b.list().layer(lstm).layer(out).set_input_type(InputType.recurrent(3))
            .backprop_type("tbptt").t_bptt_lengths(6, 2).build())
    return MultiLayerNetwork(conf, device="cpu").init()


@pytest.mark.parametrize("updater", ["nesterovs", "rmsprop"])
@pytest.mark.parametrize("kind", ["multilayer", "graph"])
def test_fused_branch_under_truncated_tbptt_with_l2(kind, updater):
    """With tbptt_bwd_length < tbptt_fwd_length the score weighs slice B's
    loss by nB / (nA + nB) and slice A takes no gradient: the L2 term
    counts whole in the score but its gradient only by that weight, and
    the fused branch folds in just that share."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((8, 12, 3)).astype(np.float32)
    y = np.eye(2, dtype=np.float32)[(np.cumsum(x[..., 0], axis=1) > 0).astype(int)]
    nets, diags = _fit_pair(lambda: _truncated_rnn(kind, updater),
                            lambda net: net.fit(x, y, batch_size=8), 2)
    _hold(nets, diags, exact=False)
    # the share is the gradient autograd gives slice B's loss, in f32
    loss_b = torch.tensor(1.0, requires_grad=True)
    [want] = torch.autograd.grad((torch.tensor(2.0) * 4 + loss_b * 2) / 6, loss_b)
    xa, xb = torch.zeros(8, 4, 3), torch.zeros(8, 2, 3)
    if kind == "graph":
        xa, xb = [xa], [xb]
    assert netbase._l2_grad_share(nets[1]._trunc_loss_builder(),
                                  (xa, None, None, None, xb, None, None, None)) == float(want)
    assert netbase._l2_grad_share(nets[1]._std_loss_builder(), None) == 1.0


def test_fused_branch_in_a_tiny_resnet():
    """Nesterovs over conv weights (L2) and BN gamma/beta (none)."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((8, 8, 8, 3)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 8)]

    def make():
        conf = tiny_resnet_conf()
        for v in conf.vertices.values():
            if hasattr(getattr(v, "layer", None), "l2"):
                v.layer.l2 = 1e-4
        return ComputationGraph(conf, device="cpu").init()

    nets, diags = _fit_pair(make, lambda net: net.fit(x, y, batch_size=4), 2)
    _hold(nets, diags, exact=False)


def test_frozen_layers_keep_their_l2_in_the_score():
    """Transfer learning: the frozen layer's L2 term stays in the built
    loss (a constant), the trainable ones' come from the tail, and the
    frozen leaves stay bit-unchanged."""
    x, y = _xy(seed=2)

    def make():
        src = MultiLayerNetwork(_mln_conf("sgd", 1e-3), device="cpu").init()
        return ttl.TransferLearning.Builder(src).set_feature_extractor(0).build()

    nets, diags = _fit_pair(make, lambda net: net.fit(x, y, batch_size=16), 2)
    _hold(nets, diags, exact=False)
    src = MultiLayerNetwork(_mln_conf("sgd", 1e-3), device="cpu").init()
    for k, v in src.params_list[0].items():
        assert torch.equal(nets[1].params_list[0][k], v)


def _declining(reason):
    """A small net whose step declines the fused tail for `reason`."""
    if reason == "updater":
        return MultiLayerNetwork(_mln_conf("adam"), device="cpu").init()
    if reason == "normalization":
        return MultiLayerNetwork(_mln_conf(gradient_normalization="clip_l2_per_layer"),
                                 device="cpu").init()
    if reason == "l1":
        return MultiLayerNetwork(_mln_conf(l1=1e-4), device="cpu").init()
    net = MultiLayerNetwork(_mln_conf(), device="cpu").init()
    if reason == "stats":
        net.set_collect_stats(True)
    elif reason == "mesh":
        net._mesh_plan = type("Plan", (), {"n_data_shards": 2})()
    elif reason == "frozen_norm":
        net = ttl.TransferLearning.Builder(net).set_feature_extractor(0).build()
        net.set_sentinel(DivergenceSentinel())
    elif reason == "dtype":
        net.params_list[1]["W"] = net.params_list[1]["W"].t().contiguous().t()
    return net


@pytest.mark.parametrize("reason", netbase.UPDATER_DECLINE_REASONS)
def test_each_decline_reason(reason):
    net = _declining(reason)
    assert net._tail_decline(net._trainable_keys(), net._norm_keys()) == reason


def test_a_plain_net_engages_and_a_cpu_net_counts_nothing():
    net = MultiLayerNetwork(_mln_conf("rmsprop", 1e-4), device="cpu").init()
    keys = net._trainable_keys()
    assert net._tail_decline(keys, net._norm_keys()) is None
    # a sentinel over a net without frozen layers still engages
    net.set_sentinel(DivergenceSentinel())
    assert net._tail_decline(keys, net._norm_keys()) is None
    declined = _declined("updater")
    n0 = declined.value
    adam = _declining("updater")
    assert not adam._fused_tail(keys, adam._norm_keys())
    assert declined.value == n0


def _declined(reason):
    return get_registry().counter("fit_updater_declined_total", "",
                                  ("reason",)).labels(reason)


def test_card_declines_are_counted_and_a_capture_records_them():
    """On a CUDA net a declined step counts under its reason; while a
    graph captures, into the capture's tally (added back per replay)."""
    net = _declining("l1")
    net.device = torch.device("cuda")  # the decision reads only the device type
    keys, nk = net._trainable_keys(), net._norm_keys()
    declined = _declined("l1")
    n0 = declined.value
    assert not net._fused_tail(keys, nk)
    assert declined.value == n0 + 1
    net._tail_declines = {}
    assert not net._fused_tail(keys, nk) and not net._fused_tail(keys, nk)
    assert net._tail_declines == {"l1": 2} and declined.value == n0 + 1
    prog = netbase._Program(("std", None, 1), {})
    prog.tail_declines = net._tail_declines
    net._tail_declines = None
    net._graph_tally(prog)
    assert declined.value == n0 + 3 and prog.replays == 1


def test_plan_packs_leaves_and_blocks_into_launches():
    # 300 one-element leaves: MAX_LEAVES a launch
    plan = fu.plan_launches((1,) * 300)
    assert len(plan) == -(-300 // fu.MAX_LEAVES)
    assert [i for launch in plan for i in launch.leaves] == list(range(300))
    # ResNet-50's largest leaf, then one that overflows a launch's blocks
    big, bigger = 3 * 3 * 512 * 512, fu.MAX_BLOCKS * fu.CHUNK + 5
    plan = fu.plan_launches((big, 3, bigger, 0, 64))
    chunks = []
    for launch in plan:
        assert len(launch.blocks) <= fu.MAX_BLOCKS and len(launch.leaves) <= fu.MAX_LEAVES
        chunks += [(launch.leaves[slot], c) for slot, c in launch.blocks]
    want = ([(0, c) for c in range(big // fu.CHUNK)] + [(1, 0)]
            + [(2, c) for c in range(fu.MAX_BLOCKS + 1)] + [(4, 0)])
    assert chunks == want
    # the second launch picks leaf 2 up where the first stopped
    assert plan[1].leaves[0] == 2 and plan[1].blocks[0][1] > 0


def test_table_layout_and_templates():
    """The ctypes table is the C struct's 3,184 bytes (no padding: 36 x 3
    pointers, 36 sizes, 3 x 36 floats, 320 leaf bytes, 320 chunk ints),
    and each launch's template carries the sizes and the block map."""
    assert ctypes.sizeof(fu._Table) == 36 * 8 * 3 + 36 * 8 + 36 * 4 * 3 + 320 + 320 * 4
    numels = (fu.CHUNK * 2 + 1, 7)
    [tpl] = fu._templates(numels)
    t = fu._Table.from_buffer_copy(tpl)
    assert list(t.n[:2]) == list(numels)
    assert [(t.leaf[b], t.chunk[b]) for b in range(4)] == [(0, 0), (0, 1), (0, 2), (1, 0)]
    t.s[0] = None  # SGD's empty state slot
    assert t.s[0] is None


def test_apply_updater_checks_its_inputs():
    upd = make_updater("nesterovs", learning_rate=0.1)
    p, g = torch.zeros(4), torch.zeros(4)
    lr, loss = torch.tensor(0.1), torch.tensor(1.0)
    with pytest.raises(ValueError, match="runs"):
        fu.apply_updater(make_updater("adam"), [p], [g], [{}], [0.0], [1.0], lr, lr, loss)
    with pytest.raises(ValueError, match="f32"):
        fu.apply_updater(upd, [p.double()], [g.double()], [{"v": p.double()}], [0.0], [1.0],
                         lr, lr, loss)
    with pytest.raises(ValueError, match="shape"):
        fu.apply_updater(upd, [p], [torch.zeros(5)], [{"v": torch.zeros(4)}], [0.0], [1.0],
                         lr, lr, loss)
    with pytest.raises(ValueError, match="0-d"):
        fu.apply_updater(upd, [p], [g], [{"v": torch.zeros(4)}], [0.0], [1.0],
                         torch.zeros(1), lr, loss)
    diag = fu.apply_updater(upd, [p], [g + 1], [{"v": torch.zeros(4)}], [0.5], [1.0],
                            lr, lr, loss)
    assert torch.equal(diag, torch.tensor([1.0, 2.0]))

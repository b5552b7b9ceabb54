"""The fused fit dispatch on a Hopper GPU (`cuda` marker; each test skips
itself without one): a fused group replayed from a CUDA graph against the
same steps run eagerly, bit for bit, and the kernels' launch counts per
replay against the eager launches.

cuDNN runs deterministic algorithms here (the conv backward may otherwise
reduce with atomics), and TF32 is off, as every f32 policy sets it. This
file imports nothing of JAX: `python -m pytest --noconftest
tests/test_torch_fused_cuda.py` runs it where JAX is not installed.
"""

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.data import DataSet, ListDataSetIterator
from deeplearning4j_tpu_torch.models.charlstm import char_lstm_network
from deeplearning4j_tpu_torch.models.resnet import tiny_resnet_conf
from deeplearning4j_tpu_torch.nn.compgraph import ComputationGraph
from deeplearning4j_tpu_torch.nn.conf import DenseLayer, InputType, NeuralNetConfiguration, OutputLayer
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.ops import fused_conv_bn as fcb
from deeplearning4j_tpu_torch.ops import fused_lstm as fl
from deeplearning4j_tpu_torch.train.listeners import IterationListener
from deeplearning4j_tpu_torch.utils.metrics import get_registry


@pytest.fixture(autouse=True)
def _deterministic():
    if not (torch.cuda.is_available()
            and torch.cuda.get_device_capability() >= (9, 0)):
        pytest.skip("needs an NVIDIA GPU of compute capability >= 9.0")
    old = (torch.backends.cudnn.deterministic, torch.backends.cudnn.allow_tf32,
           torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    yield
    (torch.backends.cudnn.deterministic, torch.backends.cudnn.allow_tf32,
     torch.backends.cuda.matmul.allow_tf32) = old


class _NoOp(IterationListener):
    def iteration_done(self, model, iteration, info):
        pass


def _leaves(net):
    out = []
    for tree in (net.params_list, net.upd_state, net.state_list):
        stack = [tree]
        while stack:
            t = stack.pop()
            if torch.is_tensor(t):
                out.append(t)
            elif isinstance(t, dict):
                stack.extend(t[k] for k in sorted(t))
            elif isinstance(t, (list, tuple)):
                stack.extend(t)
    return out


def _bit_equal(a, b):
    assert a.iteration == b.iteration
    for x, y in zip(_leaves(a), _leaves(b)):
        assert torch.equal(x, y)
    assert torch.equal(a._score, b._score)


def _counts():
    torch.cuda.synchronize()
    return {**fl.launch_counts(), **fcb.launch_counts()}


def _delta(before, after):
    return {k: after[k] - before[k] for k in after if after[k] != before[k]}


def _windows(n, T, vocab, seed):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, vocab, (n, T + 1))
    eye = np.eye(vocab, dtype=np.float32)
    return DataSet(eye[ids[:, :-1]], eye[ids[:, 1:]])


def _fit_pair(make, iterator, epochs=1):
    """(eager, graphed) nets after the same fit, and each fit's launches."""
    nets, launches = [], []
    for graphed in (False, True):
        net = make()
        if not graphed:
            net.add_listener(_NoOp())  # the JAX package's switch to the loop
        before = _counts()
        net.fit(iterator(), epochs=epochs)
        launches.append(_delta(before, _counts()))
        nets.append(net)
    return nets, launches


@pytest.mark.cuda
def test_graphed_tbptt_equals_the_eager_loop_and_counts_its_launches():
    """A listener-free TBPTT batch is one graph of its 4 segments: warm-up,
    capture, replays; 2 K1 and 2 K3 launches a segment either way."""
    data = _windows(24, 40, 12, 0)
    make = lambda: char_lstm_network(vocab_size=12, hidden=64, tbptt_length=10,
                                     learning_rate=0.01, seed=3, device="cuda")
    (eager, graphed), (le, lg) = _fit_pair(
        make, lambda: ListDataSetIterator(data, 8), epochs=2)
    _bit_equal(eager, graphed)
    assert le == lg == {"lstm_sequence": 2 * 24, "lstm_sequence_backward": 2 * 24}
    [g] = graphed.fit_graphs()
    assert g["replays"] == 5 and g["pool_bytes"] > 0  # 6 batches: 1 warm-up


@pytest.mark.cuda
def test_graphed_fused_steps_equal_eager_for_a_tiny_resnet():
    """set_fused_steps(2) on a ComputationGraph through K4-K8: three groups
    (warm-up, capture + replay, replay) equal six eager steps, with each
    kernel's launches equal."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((24, 8, 8, 3)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 24)]

    def make():
        return ComputationGraph(tiny_resnet_conf(), device="cuda").init().set_fused_steps(2)

    (eager, graphed), (le, lg) = _fit_pair(
        make, lambda: ListDataSetIterator(DataSet(x, y), 4))
    _bit_equal(eager, graphed)
    assert le == lg and all(le.get(k, 0) > 0 for k in fcb.launch_counts())
    assert graphed.fit_graphs()[0]["replays"] == 2


@pytest.mark.cuda
def test_dropout_groups_run_eagerly_on_the_card_and_are_counted():
    conf = (NeuralNetConfiguration.builder().seed(2).updater("sgd").learning_rate(0.1)
            .list().layer(DenseLayer(n_out=16, activation="relu", dropout=0.5))
            .layer(OutputLayer(n_out=3, activation="softmax", loss="mcxent"))
            .set_input_type(InputType.feed_forward(8)).build())
    rng = np.random.default_rng(0)
    x = rng.standard_normal((32, 8)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 32)]
    declined = get_registry().counter(
        "fit_graph_declined_total", "", ("reason",)).labels("rng")
    n0 = declined.value
    loop = MultiLayerNetwork(conf, device="cuda").init()
    fused = MultiLayerNetwork(conf, device="cuda").init().set_fused_steps(2)
    for net in (loop, fused):
        net.fit(x, y, batch_size=8, epochs=2)
    _bit_equal(loop, fused)
    assert declined.value - n0 == 4 and not fused.fit_graphs()


@pytest.mark.cuda
def test_prefetch_on_the_card_trains_to_the_inline_bits():
    data = _windows(16, 40, 12, 4)
    nets = []
    for prefetch in (False, True):
        net = char_lstm_network(vocab_size=12, hidden=64, tbptt_length=10,
                                learning_rate=0.01, seed=5, device="cuda")
        net.set_fused_steps(2)
        net.fit(ListDataSetIterator(data, 4), epochs=2, async_prefetch=prefetch)
        nets.append(net)
    _bit_equal(*nets)

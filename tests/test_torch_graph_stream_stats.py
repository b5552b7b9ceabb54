"""ComputationGraph streaming inference (`rnn_time_step`,
`rnn_clear_previous_state`, `clear_rnn_state`) and `set_collect_stats`
(per-layer mean |grad|, |update| and |param| computed inside the step)
in the port against the JAX package, from the same zip. Tolerances: f32
rtol 1e-5 / atol 1e-6 for outputs and statistics.
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch_parity  # noqa: E402
from deeplearning4j_tpu_torch.train.listeners import IterationListener  # noqa: E402


def _jax_rnn_graph(seed=3):
    from deeplearning4j_tpu.nn.compgraph import ComputationGraph as JCG
    from deeplearning4j_tpu.nn.conf import (
        DenseLayer, GravesLSTM, InputType, NeuralNetConfiguration,
        RnnOutputLayer)

    conf = (NeuralNetConfiguration.builder().seed(seed).graph_builder()
            .add_inputs("in")
            .add_layer("lstm", GravesLSTM(n_out=6, activation="tanh"), "in")
            .add_layer("out", RnnOutputLayer(n_out=4, activation="softmax",
                                             loss="mcxent"), "lstm")
            .set_outputs("out").set_input_types(InputType.recurrent(5))
            .build())
    return JCG(conf).init()


def test_graph_rnn_time_step_matches_the_jax_graph(tmp_path):
    jnet = _jax_rnn_graph()
    tnet = torch_parity.port_twin(jnet, tmp_path)
    rng = np.random.default_rng(0)
    seq = rng.standard_normal((3, 7, 5)).astype(np.float32)
    # a window, then single steps, carried across calls
    torch_parity.assert_close(jnet.rnn_time_step(seq[:, :4]),
                              tnet.rnn_time_step(seq[:, :4]), what="window")
    for t in range(4, 7):
        torch_parity.assert_close(jnet.rnn_time_step(seq[:, t]),
                                  tnet.rnn_time_step(seq[:, t]), what=f"step {t}")
    # the streamed sequence equals one full forward
    torch_parity.assert_close(jnet.output(seq)[:, -1], tnet.output(seq)[:, -1],
                              what="full forward")
    # cleared: the next call starts from a zero carry
    tnet.clear_rnn_state()
    jnet.clear_rnn_state()
    torch_parity.assert_close(jnet.rnn_time_step(seq[:, 0]),
                              tnet.rnn_time_step(seq[:, 0]), what="after clear")
    # a new batch size starts a new stream
    out = tnet.rnn_time_step(seq[:2, 0])
    tnet.rnn_clear_previous_state()
    torch.testing.assert_close(out, tnet.rnn_time_step(seq[:2, 0]), rtol=0, atol=0)


class _Stats(IterationListener):
    def __init__(self):
        self.stats = []

    def iteration_done(self, model, iteration, info):
        self.stats.append(info["stats"]())


def _jax_mlp(frozen):
    from deeplearning4j_tpu.nn.conf import (
        DenseLayer, NeuralNetConfiguration, OutputLayer)
    from deeplearning4j_tpu.nn.conf.layers import FrozenLayer
    from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN

    first = DenseLayer(n_in=6, n_out=5, activation="tanh")
    conf = (NeuralNetConfiguration.builder().seed(2).updater("nesterovs")
            .learning_rate(0.05).list()
            .layer(FrozenLayer(inner=first) if frozen else first)
            .layer(OutputLayer(n_in=5, n_out=3, activation="softmax",
                               loss="mcxent"))
            .build())
    return JMLN(conf).init()


@pytest.mark.parametrize("frozen", [False, True])
def test_collected_stats_match_the_jax_package(frozen, tmp_path):
    jnet = _jax_mlp(frozen)
    tnet = torch_parity.port_twin(jnet, tmp_path)
    jnet.set_collect_stats(True)
    tnet.set_collect_stats(True)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((16, 6)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 16)]
    from deeplearning4j_tpu.train.listeners import IterationListener as JL

    class JStats(JL):
        def __init__(self):
            self.stats = []

        def iteration_done(self, model, iteration, info):
            self.stats.append(info["stats"]())

    js, ts = JStats(), _Stats()
    jnet.set_listeners(js)
    tnet.set_listeners(ts)
    jnet.fit(x, y, batch_size=8, epochs=1, async_prefetch=False)
    tnet.fit(x, y, batch_size=8, epochs=1, async_prefetch=False)
    assert len(ts.stats) == len(js.stats) == 2
    for j, t in zip(js.stats, ts.stats):
        for kind in ("grad_mm", "update_mm", "param_mm"):
            for jl, tl in zip(j[kind], t[kind]):
                assert sorted(jl) == sorted(tl)
                for k in jl:
                    torch_parity.assert_close(jl[k], tl[k], what=f"{kind} {k}")
    if frozen:
        assert float(ts.stats[-1]["grad_mm"][0]["W"]) == 0.0


def test_collecting_stats_turns_fusion_off_and_tbptt_loops(tmp_path):
    """The JAX package's rule: per-step statistics need per-step
    dispatches, so set_fused_steps groups and the fused TBPTT batch give
    way to the loop (no fused program is built)."""
    from deeplearning4j_tpu_torch.data import DataSet, ListDataSetIterator
    from deeplearning4j_tpu_torch.models.charlstm import char_lstm_network

    net = char_lstm_network(vocab_size=5, hidden=4, layers=1, tbptt_length=3,
                            device="cpu")
    rng = np.random.default_rng(0)
    x = np.eye(5, dtype=np.float32)[rng.integers(0, 5, (4, 6))]
    it = ListDataSetIterator(DataSet(x, x), 2)
    net.set_collect_stats(True).set_fused_steps(2)
    net.fit(it, epochs=1, async_prefetch=False)
    assert net._programs == {}
    assert net._last_stats is not None and net.iteration == 4
    net.set_collect_stats(False)
    net.fit(it, epochs=1, async_prefetch=False)
    assert net._programs

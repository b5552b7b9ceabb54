"""The port's scan over runs of identical blocks
(`ComputationGraph.set_block_scan`, deeplearning4j_tpu_torch/nn/
compgraph.py) on the CPU, held against its own unrolled walk and against
the JAX package's scan (tests/test_compgraph.py's block-scan cases).

Runs are detected as the JAX package detects them. The scanned graph is
bit-identical to the unrolled one: output, and parameters, layer state
and updater state after three training steps, eager and under
`set_fused_steps`, with dropout drawing in the blocks too.
`compile_total{kind="graph_block"}` counts one body per unit unrolled
and one per run scanned: (4, 2) on the two-stage ResNet. The port's
scanned forward agrees with the JAX package's at f32 rtol 1e-5.
"""

import numpy as np
import pytest
import torch
from torch_parity import port_twin

from deeplearning4j_tpu.models.resnet import resnet_conf as jax_resnet_conf
from deeplearning4j_tpu.models.resnet import tiny_resnet_conf as jax_tiny_conf
from deeplearning4j_tpu.nn.compgraph import ComputationGraph as JaxGraph
from deeplearning4j_tpu.nn.compgraph import _detect_block_runs as jax_detect
from deeplearning4j_tpu_torch.models.resnet import resnet_conf, tiny_resnet_conf
from deeplearning4j_tpu_torch.nn.compgraph import ComputationGraph
from deeplearning4j_tpu_torch.nn.conf import (
    DenseLayer,
    NeuralNetConfiguration,
    OutputLayer,
    Updater,
)
from deeplearning4j_tpu_torch.utils.metrics import get_registry

F32 = dict(rtol=1e-5, atol=1e-6)
SMALL = dict(blocks=(3, 3), widths=(2, 4), num_classes=3, image_size=8,
             stem_width=4)


def _public(runs):
    return [{k: v for k, v in r.items() if not k.startswith("_")} for r in runs]


def _xy(n=8, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, 8, 8, 3)).astype(np.float32)
    y = np.zeros((n, 3), np.float32)
    y[np.arange(n), rng.integers(0, 3, n)] = 1.0
    return x, y


@pytest.fixture(scope="module")
def jax_small():
    return JaxGraph(jax_resnet_conf(**SMALL)).init()


def _pair(jax_net, tmp_path, scan="scan"):
    """Two port twins of `jax_net`: unrolled and scanned."""
    a = port_twin(jax_net, tmp_path).set_block_scan("unroll")
    b = port_twin(jax_net, tmp_path).set_block_scan(scan)
    return a, b


def _graph_block():
    return get_registry().counter(
        "compile_total", "forward-cache insertions (new shapes)",
        ("kind",)).labels("graph_block")


def _assert_nets_equal(a, b):
    for p, q in zip(a.params_list, b.params_list):
        for k in p:
            assert torch.equal(p[k], q[k]), k
    for s, t in zip(a.state_list, b.state_list):
        assert (s is None) == (t is None)
        for k in s or {}:
            assert torch.equal(s[k], t[k]), k
    for s, t in zip(a.upd_state, b.upd_state):
        for k in s:
            for n in s[k]:
                assert torch.equal(s[k][n], t[k][n]), (k, n)


def test_runs_detected_as_in_the_jax_package(jax_small):
    """The two-stage ResNet: two runs of two identity blocks (a stage's
    entry block projects, so it cannot join), equal to the JAX package's
    records; the tiny ResNet has none."""
    net = ComputationGraph(resnet_conf(**SMALL), device="cpu")
    runs = net._block_runs()
    assert [r["count"] for r in runs] == [2, 2]
    assert _public(runs) == _public(jax_small._block_runs())
    tiny = ComputationGraph(tiny_resnet_conf(), device="cpu")
    assert tiny._block_runs() == []
    assert JaxGraph(jax_tiny_conf())._block_runs() == []


def test_resnet50_runs_from_the_configuration():
    """ResNet-50's stages (3, 4, 6, 3) hold runs of 2, 3, 5 and 2
    identity blocks (11 ops each), found from the configuration alone,
    as the JAX package finds them."""
    net = ComputationGraph(resnet_conf(), device="cpu")
    runs = net._block_runs()
    assert [r["count"] for r in runs] == [2, 3, 5, 2]
    assert sum(r["count"] for r in runs) == 12
    jconf = jax_resnet_conf()
    jtopo = jconf.topological_order()
    jpidx = {n: i for i, n in enumerate(
        n for n in jtopo if n in jconf.vertices and hasattr(jconf.vertices[n], "layer"))}
    assert _public(runs) == _public(jax_detect(jconf, jtopo, jpidx))


def test_scanned_output_equals_unrolled_and_the_jax_scan(jax_small, tmp_path):
    x, _ = _xy()
    a, b = _pair(jax_small, tmp_path)
    out_a, out_b = a.output(x), b.output(x)
    assert torch.equal(out_a, out_b)
    jax_small.set_block_scan(True)
    try:
        want = np.asarray(jax_small.output(x))
        jax_keys = sorted(jax_small.feed_forward(x))
    finally:
        jax_small.set_block_scan(None)
    np.testing.assert_allclose(out_b.numpy(), want, **F32)
    # feed_forward keeps only each run's exit activation, as in JAX
    assert sorted(b.feed_forward(x)) == jax_keys
    assert len(a.feed_forward(x)) > len(jax_keys)


@pytest.mark.parametrize("fused", [1, 3])
def test_scanned_training_is_bit_identical(jax_small, tmp_path, fused):
    """Three Nesterovs steps, one batch each (eager) or one fused group of
    three: parameters, BN running statistics and updater state equal the
    unrolled run's bit for bit."""
    x, y = _xy(24)
    a, b = _pair(jax_small, tmp_path)
    for net in (a, b):
        net.set_fused_steps(fused)
        net.fit(x, y, epochs=1, batch_size=8, async_prefetch=False)
    assert a.iteration == b.iteration == 3
    _assert_nets_equal(a, b)
    assert torch.equal(a.output(x), b.output(x))


def test_graph_block_counter_reads_four_then_two(jax_small, tmp_path):
    """One fit step: 4 bodies counted unrolled (2 runs x 2 blocks), 2
    scanned (one per run); a second step of the same shape adds none."""
    x, y = _xy()
    gb = _graph_block()
    got = []
    for mode in ("unroll", "scan"):
        net = port_twin(jax_small, tmp_path).set_block_scan(mode)
        c0 = gb.value
        net.fit(x, y, epochs=1, batch_size=8, async_prefetch=False)
        got.append(gb.value - c0)
        c1 = gb.value
        net.fit(x, y, epochs=1, batch_size=8, async_prefetch=False)
        assert gb.value == c1
    assert tuple(got) == (4, 2)


def test_set_block_scan_drops_the_forward_cache(jax_small, tmp_path):
    x, _ = _xy()
    net = port_twin(jax_small, tmp_path).set_block_scan("unroll")
    net.output(x)
    before = net.output_compile_count
    net.output(x)
    assert net.output_compile_count == before
    net.set_block_scan("scan")
    net.output(x)
    assert net.output_compile_count == before + 1


def test_mode_validation_and_the_environment(jax_small, tmp_path, monkeypatch):
    net = port_twin(jax_small, tmp_path)
    for bad in ("on", "yes", 2, "SCAN"):
        with pytest.raises(ValueError, match="set_block_scan"):
            net.set_block_scan(bad)
    net.set_block_scan(None)
    monkeypatch.delenv("DL4J_BLOCK_SCAN", raising=False)
    assert not net._block_scan_enabled()
    for value, on in (("1", True), ("scan", True), ("on", True), ("0", False),
                      ("unroll", False)):
        monkeypatch.setenv("DL4J_BLOCK_SCAN", value)
        assert net._block_scan_enabled() is on
    monkeypatch.setenv("DL4J_BLOCK_SCAN", "1")
    x, _ = _xy()
    gb = _graph_block()
    c0 = gb.value
    net.output(x)
    assert gb.value - c0 == 2
    net.set_block_scan(False)
    assert not net._block_scan_enabled()


def _dropout_chain(device="cpu"):
    """in -> three identical dense layers with input dropout -> output:
    one run of three period-1 units whose training draws random numbers."""
    conf = (NeuralNetConfiguration.builder().seed(11).updater(Updater.SGD)
            .learning_rate(0.1).graph_builder().add_inputs("in")
            .add_layer("d0", DenseLayer(n_in=6, n_out=6, activation="tanh",
                                        dropout=0.7), "in")
            .add_layer("d1", DenseLayer(n_in=6, n_out=6, activation="tanh",
                                        dropout=0.7), "d0")
            .add_layer("d2", DenseLayer(n_in=6, n_out=6, activation="tanh",
                                        dropout=0.7), "d1")
            .add_layer("out", OutputLayer(n_in=6, n_out=3, activation="softmax",
                                          loss="mcxent"), "d2")
            .set_outputs("out").build())
    return ComputationGraph(conf, device=device).init()


def test_dropout_draws_follow_the_walk_order():
    """A run whose layers draw dropout masks: the scanned run consumes
    the step's generator in the unrolled walk's order, so three steps land on
    the same parameters bit for bit."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((16, 6)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 16)]
    a = _dropout_chain().set_block_scan("unroll")
    b = _dropout_chain().set_block_scan("scan")
    assert [(r["period"], r["count"]) for r in b._block_runs()] == [(1, 3)]
    for net in (a, b):
        net.fit(x, y, epochs=3, batch_size=16, async_prefetch=False)
    _assert_nets_equal(a, b)
    assert not torch.equal(a.params_list[0]["W"], _dropout_chain().params_list[0]["W"])


def _strided_chain(pkg):
    """in -> three identical stride-2 convs -> pooling -> output, in the
    conf package `pkg`: a run whose unit halves the activation, which the
    JAX package's scan refuses (its carry must keep its shape)."""
    conf = pkg.NeuralNetConfiguration
    layers = (pkg.ConvolutionLayer(n_in=4, n_out=4, kernel_size=(3, 3), stride=(2, 2),
                                   convolution_mode="same", activation="tanh")
              for _ in range(3))
    gb = (conf.builder().seed(5).updater(pkg.Updater.SGD).learning_rate(0.1)
          .graph_builder().add_inputs("in")
          .set_input_types(pkg.InputType.convolutional(16, 16, 4)))
    prev = "in"
    for i, layer in enumerate(layers):
        gb.add_layer(f"c{i}", layer, prev)
        prev = f"c{i}"
    gb.add_layer("pool", pkg.GlobalPoolingLayer(pooling_type="avg"), prev)
    gb.add_layer("out", pkg.OutputLayer(n_in=4, n_out=3, activation="softmax",
                                        loss="mcxent"), "pool")
    return gb.set_outputs("out").build()


def test_a_shrinking_unit_runs_unrolled_as_in_jax(tmp_path):
    """A run of stride-2 units: the scanned graph gives the unrolled
    output, publishes every unit's activation and counts one body per
    unit, as the JAX package falls back to its unrolled walk."""
    import deeplearning4j_tpu.nn.conf as jconf_pkg

    jnet = JaxGraph(_strided_chain(jconf_pkg)).init()
    assert [(r["period"], r["count"]) for r in jnet._block_runs()] == [(1, 3)]
    a, b = _pair(jnet, tmp_path)
    assert _public(b._block_runs()) == _public(jnet._block_runs())
    x = np.random.default_rng(4).standard_normal((2, 16, 16, 4)).astype(np.float32)
    gb = _graph_block()
    c0 = gb.value
    out = b.output(x)
    assert gb.value - c0 == 3
    assert torch.equal(out, a.output(x))
    jnet.set_block_scan(True)
    try:
        np.testing.assert_allclose(out.numpy(), np.asarray(jnet.output(x)), **F32)
        jax_keys = sorted(jnet.feed_forward(x))
    finally:
        jnet.set_block_scan(None)
    assert sorted(b.feed_forward(x)) == sorted(a.feed_forward(x)) == jax_keys

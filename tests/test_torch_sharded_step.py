"""The port's data-parallel step (nn/netbase.set_mesh +
parallel/sharded.MeshPlan) on gloo processes on the CPU: the bucketed
gradient all-reduce is bit-identical to the monolithic one at R = 2 (plain
fits, fused-2 groups and TBPTT), the bf16 wire halves the books exactly
with the trajectory within 5e-2 / 5e-3, the bucket schedule equals the
JAX package's on the same leaf shapes, mid-epoch resume round-trips
through a sharded net (rank 0 writes, every rank restores), the
deprecated ParallelWrapper facade (output, averaging_frequency, workers),
auto mesh on and off and `unset_mesh`, prefetch on and off, and the
world-1 mesh that issues no collective and books 0 bytes.

Two spawns of 2 ranks (module fixtures) run the port's fits; each test
reads its case.
"""

import os

import jax
import numpy as np
import pytest

from deeplearning4j_tpu.models.charlstm import char_lstm_conf
from deeplearning4j_tpu.nn.compgraph import ComputationGraph
from deeplearning4j_tpu.nn.conf import (
    BatchNormalization,
    DenseLayer,
    NeuralNetConfiguration,
    OutputLayer,
    Updater,
)
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu.parallel import data_parallel_mesh
from deeplearning4j_tpu.utils import model_serializer as jms

from tests import torch_parallel_workers as W
from tests.torch_dist import once, run_ranks

RTOL, ATOL = 5e-5, 5e-6
BF16_RTOL, BF16_ATOL = 5e-2, 5e-3  # the JAX package's test_collectives.py pin


def _mlp_conf(seed=7, with_bn=False):
    b = (NeuralNetConfiguration.builder().seed(seed).updater(Updater.NESTEROVS)
         .learning_rate(0.05).momentum(0.9).weight_init("xavier").list()
         .layer(DenseLayer(n_in=12, n_out=16, activation="tanh")))
    if with_bn:
        b = b.layer(BatchNormalization(n_in=16))
    return b.layer(OutputLayer(n_in=16, n_out=4, activation="softmax",
                               loss="mcxent")).build()


def _graph_conf():
    return (NeuralNetConfiguration.builder().seed(9).updater(Updater.SGD)
            .learning_rate(0.05).weight_init("xavier").graph_builder()
            .add_inputs("in")
            .add_layer("h", DenseLayer(n_in=12, n_out=16, activation="tanh"), "in")
            .add_layer("out", OutputLayer(n_in=16, n_out=4, activation="softmax",
                                          loss="mcxent"), "h")
            .set_outputs("out").build())


def _data(n=64, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, 12)).astype(np.float32)
    y = np.zeros((n, 4), np.float32)
    y[np.arange(n), rng.integers(0, 4, n)] = 1.0
    return x, y


def _lstm_data():
    vocab, seq = 11, 8
    rng = np.random.default_rng(5)
    x = np.eye(vocab, dtype=np.float32)[rng.integers(0, vocab, (16, seq))]
    y = np.eye(vocab, dtype=np.float32)[rng.integers(0, vocab, (16, seq))]
    return x, y


def _leaves_equal(a, b):
    assert [k for k, _ in a] == [k for k, _ in b]
    for (k, u), (_, v) in zip(a, b):
        np.testing.assert_array_equal(u, v, err_msg=k)


def _leaves_close(a, b, rtol=RTOL, atol=ATOL):
    assert [k for k, _ in a] == [k for k, _ in b]
    for (k, u), (_, v) in zip(a, b):
        np.testing.assert_allclose(u, v, rtol=rtol, atol=atol, err_msg=k)


@pytest.fixture(scope="module")
def zips(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("zips")
    out = {}
    for name, net in (("mlp", MultiLayerNetwork(_mlp_conf()).init()),
                      ("lstm", MultiLayerNetwork(char_lstm_conf(
                          vocab_size=11, hidden=8, tbptt_length=4)).init()),
                      ("graph", ComputationGraph(_graph_conf()).init())):
        out[name] = os.path.join(tmp, f"{name}.zip")
        jms.save_model(net, out[name])
    return out


@pytest.fixture(scope="module")
def buckets(zips, tmp_path_factory):
    return once(tmp_path_factory, "buckets", lambda: run_ranks(
        W.bucket_cases, 2, zips, _data(64, seed=3), _lstm_data())[0])


@pytest.fixture(scope="module")
def surface(zips, tmp_path_factory):
    ckpt = str(tmp_path_factory.mktemp("ckpt"))
    return once(tmp_path_factory, "surface", lambda: run_ranks(
        W.sharded_surface, 2, zips["mlp"], _data(64, seed=11), ckpt, zips["graph"]))


# -- bucketed == monolithic -------------------------------------------------------


@pytest.mark.parametrize("bb", [512, None])
def test_bucketed_bit_identical_to_monolithic(buckets, bb):
    """Bucket size is a schedule knob, never a numerics knob: a sum of two
    f32 terms does not depend on how the buffer is cut."""
    mono, buck = buckets["mlp_bb0"], buckets[f"mlp_bb{bb}"]
    assert buck["scores"] == mono["scores"]
    _leaves_equal(buck["params"], mono["params"])
    desc = buck["describe"]
    assert desc["mode"] == "bucketed"
    # 512 B: [1/b, 1/W, 0/b] (336 B), then 0/W (768 B) alone
    assert desc["n_buckets"] == (2 if bb == 512 else 1)
    assert buckets["mlp_bb0"]["describe"]["mode"] == "monolithic"


def test_bucketed_fused_dispatch_bit_identical(buckets):
    _leaves_equal(buckets["fused_bb512"]["params"], buckets["fused_bb0"]["params"])
    assert buckets["fused_bb512"]["iteration"] == 8


def test_fused_equals_per_step_under_mesh(buckets):
    """set_fused_steps(2) under a mesh: on the CPU the fused program is the
    loop of steps, bit for bit."""
    _leaves_equal(buckets["fused_bb0"]["params"], buckets["mlp_bb0"]["params"])


def test_bucketed_tbptt_bit_identical(buckets):
    _leaves_equal(buckets["tbptt_bb256"]["params"], buckets["tbptt_bb0"]["params"])
    assert buckets["tbptt_bb256"]["scores"] == buckets["tbptt_bb0"]["scores"]
    assert buckets["tbptt_bb256"]["describe"]["n_buckets"] > 1


def test_bf16_wire_halves_books(buckets):
    f32, bf16 = buckets["mlp_bbNone"], buckets["bf16"]
    assert f32["books"]["bytes"] > 0
    assert bf16["books"]["bytes"] * 2 == f32["books"]["bytes"]
    assert f32["describe"]["grad_dtype"] == "f32"
    assert bf16["describe"]["grad_dtype"] == "bf16"
    # the f32 payload is the parameter bytes, a step
    assert f32["payload"] == 4 * (12 * 16 + 16 + 16 * 4 + 4)
    assert f32["books"]["bytes"] == f32["payload"] * f32["iteration"]


def test_bf16_wire_trajectory_within_pin(buckets):
    f32, bf16 = buckets["mlp_bbNone"], buckets["bf16"]
    np.testing.assert_allclose(bf16["scores"], f32["scores"], rtol=BF16_RTOL, atol=BF16_ATOL)
    _leaves_close(bf16["params"], f32["params"], BF16_RTOL, BF16_ATOL)


def test_estimate_is_not_booked_without_a_link_figure(buckets):
    """The ring estimate needs the card's link bandwidth; the CPU has none,
    so nothing is booked under source="estimate" and the describe says
    None."""
    rec = buckets["mlp_bbNone"]
    assert rec["books"]["estimate"] == 0
    assert rec["describe"]["ring_estimate_seconds"] is None
    assert rec["describe"]["transport"] == "gloo"


def test_measured_collective_counter_moves_when_sampled(buckets):
    assert buckets["sampled"]["measured"] > 0
    # the default sampling (every 16 steps) does not reach an 8-step fit
    assert buckets["mlp_bbNone"]["books"]["measured"] == 0


def test_collective_plan_matches_jax_plan():
    """CollectivePlan.build yields the JAX plan's buckets on the same leaf
    shapes: reverse leaf order, dtype breaks, bytes at the wire dtype."""
    from deeplearning4j_tpu.parallel.sharded import MeshPlan as JaxPlan
    from deeplearning4j_tpu.models.resnet import tiny_resnet_conf
    from deeplearning4j_tpu_torch.parallel.mesh import data_parallel_mesh as tmesh
    from deeplearning4j_tpu_torch.parallel.sharded import MeshPlan
    from tests.torch_parity import port_twin

    import tempfile

    jnet = ComputationGraph(tiny_resnet_conf()).init()
    with tempfile.TemporaryDirectory() as d:
        tnet = port_twin(jnet, d)
    jmesh = data_parallel_mesh(jax.devices()[:2])
    for bb, gd in ((512, None), (4096, None), (0, "bf16"), (4 << 20, "bf16"), (1, None)):
        jp = JaxPlan(jmesh, bucket_bytes=bb, grad_dtype=gd).place_net(jnet)
        tp = MeshPlan(tmesh(), bucket_bytes=bb, grad_dtype=gd).place_net(tnet)
        want = jp.collective_plan(jnet)
        got = tp.collective_plan(tnet)
        assert [b["leaves"] for b in got.buckets] == [b["leaves"] for b in want.buckets]
        assert [b["bytes"] for b in got.buckets] == [b["bytes"] for b in want.buckets]
        assert got.describe() == want.describe()
        assert tp.grad_payload_bytes(tnet) == jp.grad_payload_bytes(jnet)


def test_bucketed_matches_monolithic_at_four_ranks(zips):
    """At four ranks gloo's ring sums four terms in an order that depends on
    where an element sits in the buffer, so bucketed and monolithic agree
    within f32 rounding, not bit for bit (ROADMAP queue 3)."""
    res = run_ranks(W.bucket_bit_check, 4, zips["mlp"], _data(64, seed=3))[0]
    np.testing.assert_allclose(res[512]["scores"], res[0]["scores"], rtol=1e-6, atol=1e-7)
    _leaves_close(res[512]["params"], res[0]["params"], 1e-6, 1e-7)


# -- the sharded step's surface ------------------------------------------------


def test_prefetch_on_off_same_trajectory(surface):
    for rec in surface:
        assert rec["prefetch_on"]["scores"] == rec["prefetch_off"]["scores"]
        _leaves_equal(rec["prefetch_on"]["params"], rec["prefetch_off"]["params"])


def test_books_are_payload_times_steps(surface):
    rec = surface[0]["prefetch_on"]
    assert rec["iteration"] == 8
    assert rec["books"]["bytes"] == rec["payload"] * 8


def test_fused_groups_equal_per_step(surface):
    for rec in surface:
        _leaves_equal(rec["fused"]["params"], rec["per_step"]["params"])
        assert rec["fused"]["books"]["bytes"] == rec["per_step"]["books"]["bytes"]


def test_sharded_resume_roundtrip(surface):
    """Crash after 5 sharded steps with a checkpoint every step (rank 0
    writes), resume a fresh sharded net: the reference's suffix."""
    assert surface[0]["ckpt_files"], "rank 0 wrote no checkpoint"
    for rec in surface:
        assert rec["crash_raised"]
        ref, got = rec["ref_bucketed"], rec["resumed"]
        assert got["iteration"] == ref["iteration"] == 8
        np.testing.assert_allclose(got["scores"], ref["scores"][-len(got["scores"]):],
                                   rtol=RTOL, atol=ATOL)
        _leaves_close(got["params"], ref["params"])


def test_auto_mesh_engages_under_a_process_group(surface):
    for rec in surface:
        assert rec["auto_before"]
        assert rec["auto_after"] == 2
        # a world-2 data-parallel epoch equals each rank's own epoch on the
        # whole batch
        _leaves_close(rec["auto_params"], rec["local_params"])


def test_auto_mesh_off_and_unset_mesh(surface):
    for rec in surface:
        assert rec["auto_off_plan"]
        assert rec["unset_plan"]
        assert all(np.isfinite(v).all() for _, v in rec["unset_params"])


def test_parallel_wrapper_output_equals_output(surface):
    for rec in surface:
        assert rec["deprecated"]
        np.testing.assert_allclose(rec["wrapper_out"], rec["plain_out"], rtol=2e-5, atol=1e-6)
        np.testing.assert_allclose(rec["wrapper_out_19"], rec["plain_out_19"],
                                   rtol=2e-5, atol=1e-6)


def test_parallel_wrapper_rejects_averaging_frequency(surface):
    assert all(rec["avg_freq_rejected"] for rec in surface)


def test_parallel_wrapper_workers_stack_minibatches(surface):
    for rec in surface:
        _leaves_close(rec["stacked"], rec["global"], 1e-6, 0)


def test_graph_rides_the_sharded_step(surface):
    rec = surface[0]["graph"]
    assert rec["iteration"] == 8
    assert rec["books"]["bytes"] == rec["payload"] * 8
    _leaves_equal(rec["params"], surface[1]["graph"]["params"])


def test_a_lone_noncontiguous_gradient_is_reduced():
    """A gradient leaf in a bucket of its own that is not contiguous (a
    conv weight's gradient from cuDNN through the HWIO view) goes through
    a flat buffer: a collective takes only contiguous tensors."""
    for rec in run_ranks(W.noncontiguous_reduce, 2):
        assert rec["contiguous"] and all(rec["contiguous"])
        assert rec["score"] == 3.0
        for name, g in rec["grads"]:
            np.testing.assert_array_equal(g, np.full_like(g, 3.0), err_msg=name)


def test_world1_mesh_issues_no_collective():
    """A world-1 meshed fit (no process group) books 0 bytes and issues no
    collective, as the JAX package does at one shard."""
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork as TNet
    from deeplearning4j_tpu_torch.nn.conf import MultiLayerConfiguration

    net = TNet(MultiLayerConfiguration.from_json(_mlp_conf().to_json()), device="cpu").init()
    ref = TNet(MultiLayerConfiguration.from_json(_mlp_conf().to_json()), device="cpu").init()
    before = W._books()
    net.set_mesh()
    assert net._mesh_plan.n_data_shards == 1
    x, y = _data(32)
    net.fit(x, y, batch_size=16, epochs=1, async_prefetch=False)
    ref.fit(x, y, batch_size=16, epochs=1, async_prefetch=False)
    after = W._books()
    assert after["bytes"] == before["bytes"]
    assert net._mesh_plan.mesh.stats.snapshot() == {}
    _leaves_equal(W._leaves(net.params_list), W._leaves(ref.params_list))


def test_set_mesh_rejects_knobs_with_explicit_plan():
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork as TNet
    from deeplearning4j_tpu_torch.nn.conf import MultiLayerConfiguration
    from deeplearning4j_tpu_torch.parallel.mesh import data_parallel_mesh as tmesh
    from deeplearning4j_tpu_torch.parallel.sharded import MeshPlan

    net = TNet(MultiLayerConfiguration.from_json(_mlp_conf().to_json()), device="cpu").init()
    with pytest.raises(ValueError):
        net.set_mesh(plan=MeshPlan(tmesh()), bucket_bytes=512)
    with pytest.raises(ValueError):
        MeshPlan(tmesh(), grad_dtype="f16")

"""The port's step cost model, kernel coverage and conv routing
(analysis/costmodel.py, analysis/kernelcoverage.py, the economic stage of
ops/fused_conv_bn.conv_decision) and the step audit (analysis/graph_audit.py).

Oracles: the JAX package's per-instance pricing (`_conv_valid_pairs`,
`_same_pad_lo`, `conv_instance_cost`, `bn_instance_cost`,
`instance_roofline`) and its `kernelcoverage.conv_instances` are pure
functions that run on this CPU, so the port's are held equal to them
exactly. The JAX program cost model and jaxpr audit cannot trace here
(jax 0.9.0 has no `jax.core.ClosedJaxpr`), so the port's step model is
held to hand counts, to `torch.utils.flop_counter.FlopCounterMode`
(JX007) and to utils/flops' analytic count, and the audit's JX001–JX005
cases of the JAX tests/test_analysis.py are restated on torch steps.
Everything traces on fake tensors at tiny shapes; ResNet-50's coverage
table is configuration walking only.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.analysis import costmodel as jcm
from deeplearning4j_tpu.analysis import kernelcoverage as jkc
from deeplearning4j_tpu.models.resnet import resnet50_conf as jresnet50_conf
from deeplearning4j_tpu_torch.analysis import costmodel as cm
from deeplearning4j_tpu_torch.analysis import graph_audit as ga
from deeplearning4j_tpu_torch.analysis import kernelcoverage as kc
from deeplearning4j_tpu_torch.models import charlstm, lenet, resnet
from deeplearning4j_tpu_torch.nn.compgraph import ComputationGraph
from deeplearning4j_tpu_torch.nn.conf import (
    DenseLayer,
    InputType,
    NeuralNetConfiguration,
    OutputLayer,
    Updater,
)
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.ops import fused_conv_bn as fcb
from deeplearning4j_tpu_torch.utils import flops as tflops

PEAK, BW = 989e12, 3.35e12  # the H100 SXM figures (utils/flops)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mlp(n_in=12, hidden=16, classes=4, updater=Updater.ADAM, input_type=True):
    b = (NeuralNetConfiguration.builder().seed(7).updater(updater)
         .learning_rate(0.05).weight_init("xavier").list()
         .layer(DenseLayer(n_in=n_in, n_out=hidden, activation="tanh"))
         .layer(OutputLayer(n_in=hidden, n_out=classes, activation="softmax",
                            loss="mcxent")))
    if input_type:
        b = b.set_input_type(InputType.feed_forward(n_in))
    return MultiLayerNetwork(b.build(), device="cpu").init()


def _resnet50_instances(batch=128):
    return jkc.conv_instances(jresnet50_conf(), batch=batch)


# -- per-instance pricing: exactly the JAX package's -------------------------------

def test_valid_pairs_and_same_pads_equal_the_jax_package():
    for in_sz in range(1, 12):
        for k in (1, 2, 3, 5, 7):
            for s in (1, 2, 3):
                assert cm._same_pad_lo(in_sz, k, s) == jcm._same_pad_lo(in_sz, k, s)
                out, lo = cm._same_pad_lo(in_sz, k, s)
                for w_dil in (1, 2):
                    for b_dil in (1, 2):
                        assert cm._conv_valid_pairs(out, k, in_sz, s, lo, w_dil, b_dil) == \
                            jcm._conv_valid_pairs(out, k, in_sz, s, lo, w_dil, b_dil)


@pytest.mark.parametrize("itemsize", [2, 4])
def test_instance_costs_equal_the_jax_package_on_resnet50(itemsize):
    rows = _resnet50_instances()
    assert len(rows) == 53
    for name, ctx in rows:
        kw = dict(kernel=ctx["kernel"], stride=ctx["stride"], x_shape=ctx["x_shape"],
                  n_out=ctx["n_out"], itemsize=itemsize)
        got, want = cm.conv_instance_cost(**kw), jcm.conv_instance_cost(**kw)
        assert got == want, name
        assert cm.instance_roofline(got["flops"], got["bytes"], PEAK, BW) == \
            jcm.instance_roofline(want["flops"], want["bytes"], PEAK, BW), name
        out_shape = got["out_shape"]
        for reads in (1, 4):
            b = dict(x_shape=out_shape, itemsize=itemsize, n_reads=reads)
            assert cm.bn_instance_cost(**b) == jcm.bn_instance_cost(**b)
            bc = cm.bn_instance_cost(**b)
            assert cm.instance_roofline(bc["flops"], bc["bytes"], PEAK, BW) == \
                jcm.instance_roofline(bc["flops"], bc["bytes"], PEAK, BW)


@pytest.mark.parametrize("x_shape", [(2, 33, 29, 3), (3, 31, 31, 3), (1, 7, 9, 3),
                                     (5, 224, 223, 3), (2, 1, 1, 3)])
def test_stem_costs_equal_the_jax_package_at_odd_sizes(x_shape):
    kw = dict(kernel=(7, 7), stride=(2, 2), x_shape=x_shape, n_out=64, itemsize=2)
    got, want = cm.conv_instance_cost(**kw), jcm.conv_instance_cost(**kw)
    assert got == want
    assert cm.instance_roofline(got["flops"], got["bytes"], PEAK, BW) == \
        jcm.instance_roofline(want["flops"], want["bytes"], PEAK, BW)


def test_instance_roofline_off_the_card_takes_the_h100_figures():
    got = cm.instance_roofline(1e12, 1e9)
    assert got["ridge_intensity"] == round(PEAK / BW, 3)
    assert got["verdict"] == "compute-bound"
    assert cm.instance_roofline(1e9, 1e9)["verdict"] == "memory-bound"


# -- coverage and routing ---------------------------------------------------------

def test_conv_instances_equal_the_jax_package():
    t = kc.conv_instances(resnet.resnet50_conf(), batch=128)
    j = _resnet50_instances()
    assert [(n, c) for n, c in t] == [(n, c) for n, c in j]


def test_coverage_table_verdicts_equal_the_jax_instance_functions():
    """53 ResNet-50 instances at batch 128 in bf16: every one covered or
    declined with a verdict, none unsupported, and the split is the JAX
    instance functions' verdict on the H100 figures: 34 covered, 19
    declined (compute-bound)."""
    rows = kc.coverage_table(resnet.resnet50_conf(), 128)
    s = kc.coverage_summary(rows)
    assert s == {"total": 53, "covered": 34, "declined": 19, "unsupported": 0}
    for row, (name, ctx) in zip(rows, _resnet50_instances()):
        c = jcm.conv_instance_cost(kernel=ctx["kernel"], stride=ctx["stride"],
                                   x_shape=ctx["x_shape"], n_out=ctx["n_out"], itemsize=2)
        v = jcm.instance_roofline(c["flops"], c["bytes"], PEAK, BW)["verdict"]
        assert row["layer"] == name
        assert row["status"] == ("declined" if v == "compute-bound" else "covered")
        assert row["reason"] == ("compute_bound" if v == "compute-bound" else "memory_bound")
    assert kc.launches_per_step(rows) == {"conv1x1_stats": 29, "conv_kxk_stats": 5,
                                          "bn_apply": 34}
    declined = {(tuple(r["kernel"]), tuple(r["stride"]), tuple(r["x_shape"][1:]))
                for r in rows if r["status"] == "declined"}
    assert ((3, 3), (1, 1), (28, 28, 128)) in declined
    assert ((1, 1), (1, 1), (7, 7, 512)) in declined
    assert ((7, 7), (2, 2), (224, 224, 3)) not in declined
    assert "53 conv instances — 34 covered, 19 declined" in kc.format_table(rows)


def test_coverage_smoke_main_passes(caplog):
    assert kc.main(["--batch", "8", "--image", "32"]) == 0


def test_runtime_routing_covers_every_resnet50_conv():
    """What this process routes by: the structural stage, so all 53
    ResNet-50 convs at batch 128 in bf16 take K4 or K5 (36 and 17), each
    BN after them K6."""
    rows = kc.coverage_table(resnet.resnet50_conf(), 128, planning=False)
    assert kc.coverage_summary(rows) == {"total": 53, "covered": 53, "declined": 0,
                                         "unsupported": 0}
    assert {r["reason"] for r in rows} == {"structural"}
    assert kc.launches_per_step(rows) == {"conv1x1_stats": 36, "conv_kxk_stats": 17,
                                          "bn_apply": 53}


def test_conv_decision_plans_compute_bound_declines_and_routes_structurally(monkeypatch):
    from deeplearning4j_tpu_torch.utils.metrics import get_registry

    ctx = dict(kernel=(3, 3), stride=(1, 1), dilation=(1, 1), same=True,
               has_bias=False, activation="identity", training=True, n_in=256,
               n_out=256, x_shape=(128, 14, 14, 256))
    d = fcb.conv_decision(dtype=torch.bfloat16, planning=True, **ctx)
    assert (d["status"], d["reason"]) == ("declined", "compute_bound")
    assert d["roofline"]["intensity"] > d["roofline"]["ridge_intensity"]
    # the same conv at a small batch is memory-bound: the plan covers it
    small = fcb.conv_decision(dtype=torch.bfloat16, planning=True,
                              **dict(ctx, x_shape=(2, 14, 14, 256)))
    assert (small["status"], small["reason"]) == ("covered", "memory_bound")
    # at run time the structural stage routes: the compute-bound conv is covered
    run = fcb.conv_decision(dtype=torch.bfloat16, **ctx)
    assert (run["status"], run["reason"], run["roofline"]) == ("covered", "structural", None)
    monkeypatch.setattr(torch.cuda, "get_device_capability", lambda device=None: (9, 0))
    assert fcb.conv_supported(dtype=torch.bfloat16, device=torch.device("cuda"), **ctx)
    # a structural decline is counted by its reason
    child = get_registry().counter(
        "conv_declined_total", "", ("op", "helper", "family", "reason")).labels(
        "conv2d", "cuda_conv_bn_stats", "conv3x3", "bias")
    before = child.value
    assert not fcb.conv_supported(dtype=torch.bfloat16, device=torch.device("cuda"),
                                  **dict(ctx, has_bias=True))
    assert child.value == before + 1


# -- the step cost model -----------------------------------------------------------

def test_mlp_model_flops_equal_the_hand_count_and_the_net_is_untouched():
    net = _mlp()
    before = [{k: v.clone() for k, v in p.items()} for p in net.params_list]
    it0 = net.iteration
    m = cm.train_step_cost(net, batch_size=8)
    # forward 2BKN for both layers; backward dW for both and dX for the
    # second only (the batch takes no gradient)
    b = 8
    fwd = 2 * b * 12 * 16 + 2 * b * 16 * 4
    want = fwd + 2 * b * 12 * 16 + 2 * (2 * b * 16 * 4)
    assert m.model_flops == want
    assert m.families["dot_general"].count == 5
    assert net.iteration == it0
    for p0, p in zip(before, net.params_list):
        for k in p0:
            assert torch.equal(p0[k], p[k])


@pytest.mark.parametrize("shape,stride", [((2, 8, 8, 3), 2), ((2, 9, 9, 5), 2),
                                          ((1, 7, 6, 4), 1)])
def test_same_conv_counts_no_pad_taps(shape, stride):
    """A SAME 3x3 conv through the port's builtin conv (an explicit F.pad
    where XLA's pads are asymmetric) counts the valid pairs only: the JAX
    package's conv_instance_cost."""
    x = torch.empty(shape, device="meta")
    w = torch.empty((3, 3, shape[-1], 6), device="meta")
    pads = tuple(fcb.same_pads(shape[1 + i], 3, stride)[1:] for i in range(2))
    got = cm.cost_fn(lambda x, w: fcb.conv2d_nhwc(x, w, (stride, stride), pads), x, w)
    want = jcm.conv_instance_cost(kernel=(3, 3), stride=(stride, stride), x_shape=shape,
                                  n_out=6, itemsize=4)["flops"]
    assert got.model_flops == want
    # FlopCounterMode's figure takes every tap
    assert got.counter_comparable_flops > want


def test_charlstm_flops_reconcile_with_the_analytic_count():
    """The analytic count is 3 x forward for every product; the step
    computes no gradient for the batch (the first layer's input product)
    or for the zero initial hidden state (each layer's first recurrent
    step): exactly those are missing."""
    V, H, L, B, T = 10, 8, 2, 2, 8
    net = charlstm.char_lstm_network(vocab_size=V, hidden=H, layers=L, device="cpu")
    m = cm.train_step_cost(net, batch_size=B, timesteps=T)
    analytic, src = tflops.train_step_flops_for(net, B, timesteps=T, prefer_cost_model=False)
    assert src == "analytic"
    skipped = 2 * 4 * H * V * T * B + L * 2 * 4 * H * H * B
    assert m.model_flops == analytic - skipped


def test_lenet_flops_within_ten_percent_of_the_analytic_count():
    net = lenet.lenet_network(device="cpu")
    v, src = tflops.train_step_flops_for(net, 4)
    analytic, _ = tflops.train_step_flops_for(net, 4, prefer_cost_model=False)
    assert src == "costmodel"
    assert abs(v / analytic - 1) < 0.10


def test_tiny_resnet_flops_sources_and_band():
    """The JAX package's test_train_step_flops_for_sources band: valid
    taps only (8-pixel images are mostly border) and no stem input
    gradient, so the traced count sits under the analytic one."""
    net = ComputationGraph(resnet.tiny_resnet_conf(), device="cpu").init()
    v, src = tflops.train_step_flops_for(net, 4)
    per_ex, asrc = tflops.analytic_step_flops_per_example(net.conf)
    assert src == "costmodel" and asrc == "analytic"
    assert 0.4 < v / (per_ex * 4) < 2.5
    bare = _mlp(input_type=False)
    assert tflops.train_step_flops_for(bare, 4)[1] == "analytic"


@pytest.mark.parametrize("which", ["mlp", "tiny_resnet", "charlstm", "lenet"])
def test_jx007_cross_check_agrees_with_flop_counter_mode(which):
    net = {"mlp": _mlp,
           "tiny_resnet": lambda: ComputationGraph(resnet.tiny_resnet_conf(),
                                                   device="cpu").init(),
           "charlstm": lambda: charlstm.char_lstm_network(vocab_size=10, hidden=8,
                                                          device="cpu"),
           "lenet": lambda: lenet.lenet_network(device="cpu")}[which]()
    model, counted, findings = cm.check_network(net, batch_size=2, timesteps=6)
    assert counted and counted > 0
    assert abs(model.counter_comparable_flops - counted) <= 1e-9 * counted
    assert findings == []


def test_jx007_fires_on_divergence_and_skips_without_a_count():
    net = ComputationGraph(resnet.tiny_resnet_conf(), device="cpu").init()
    m = cm.train_step_cost(net, batch_size=2)
    found = cm.cross_check(m, m.counter_comparable_flops * 2.0, tolerance=0.10)
    assert found and found[0].code == "JX007" and found[0].severity == "error"
    assert not cm.cross_check(m, None)


def test_activation_peak_and_residency():
    """The JAX package's test_activation_peak_and_residency, restated."""
    net = ComputationGraph(resnet.tiny_resnet_conf(), device="cpu").init()
    m = cm.train_step_cost(net, batch_size=4)
    assert m.activation_peak_bytes > 0
    assert m.largest_activation is not None
    assert m.activation_peak_bytes >= m.largest_activation["bytes"]
    assert m.param_bytes > 0 and m.updater_bytes > 0
    assert m.resident_bytes >= m.param_bytes + m.updater_bytes + m.activation_peak_bytes
    # JX008 skips off the GPU, is quiet at a roomy budget, fires past it
    assert not cm.residency_findings(m, hbm_bytes=None)
    assert not cm.residency_findings(m, hbm_bytes=80e9)
    bad = cm.residency_findings(m, hbm_bytes=1024)
    assert bad and bad[0].code == "JX008" and bad[0].severity == "error"
    # the peak grows with the batch; the resident params do not
    m8 = cm.train_step_cost(net, batch_size=8)
    assert m8.activation_peak_bytes > m.activation_peak_bytes
    assert m8.param_bytes == m.param_bytes


def test_roofline_table_and_verdicts():
    """The JAX package's test_roofline_table_and_verdicts, restated on
    the H100 figures: a 2048^3 product is compute-bound (341 FLOP/B past
    the 295 FLOP/B ridge)."""
    net = ComputationGraph(resnet.tiny_resnet_conf(), device="cpu").init()
    m = cm.train_step_cost(net, batch_size=4)
    rows = m.table(peak_flops=PEAK, hbm_bandwidth=BW)
    assert rows[0]["family"] == "conv_general_dilated"
    assert all(r["verdict"] in ("compute-bound", "memory-bound") for r in rows)
    roof = m.roofline(peak_flops=PEAK, hbm_bandwidth=BW)
    assert roof["step_time_lower_bound_seconds"] > 0
    assert 0 < roof["mfu_ceiling"] <= 1.0
    a = torch.empty((2048, 2048), device="meta")
    big = cm.cost_fn(lambda a, b: a @ b, a, a)
    row = big.table(peak_flops=PEAK, hbm_bandwidth=BW)[0]
    assert row["family"] == "dot_general" and row["verdict"] == "compute-bound"
    d = m.to_dict()
    for key in ("flops_total", "bytes_total", "model_flops", "model_flops_per_chip",
                "param_bytes", "updater_bytes", "resident_bytes",
                "activation_peak_bytes", "largest_activation", "families"):
        assert key in d
    assert d["families"]["conv_general_dilated"]["kind"] == "mxu"


def test_train_step_args_runs_the_step_on_fakes():
    """The traced program is the fit's own step on fake tensors: it runs
    under its fake mode, returns a scalar score, and leaves the net as it
    was; without an InputType there is no batch to shape."""
    net = _mlp()
    before = [{k: v.clone() for k, v in p.items()} for p in net.params_list]
    step, args = cm.train_step_args(net, batch_size=4)
    with step.fake_mode:
        states, score = step(*args)
    assert score.shape == () and tuple(args[1][0].shape) == (4, 12)
    assert all(torch.equal(p0[k], p[k]) for p0, p in zip(before, net.params_list) for k in p0)
    with pytest.raises(ValueError, match="InputType"):
        cm.train_step_args(_mlp(input_type=False))


def test_attach_cost_model_switches_the_flop_source():
    net = _mlp()
    v, src = net.model_flops_per_example()
    assert src == "analytic" and v > 0
    m = cm.train_step_cost(net, batch_size=4)
    net.attach_cost_model(m, batch=4)
    v2, src2 = net.model_flops_per_example()
    assert src2 == "costmodel" and v2 == pytest.approx(m.model_flops / 4)
    assert net._cost_model_meta["activation_peak_bytes"] == m.activation_peak_bytes


# -- the step audit (JX001-JX005, JAX tests/test_analysis.py:208-276) ---------------

def test_injected_f64_constant_yields_jx001():
    c64 = torch.ones(3, dtype=torch.float64)
    fs = ga.audit_fn(lambda x: x + c64, np.ones(3, np.float32))
    jx1 = [f for f in fs if f.code == "JX001"]
    assert jx1 and jx1[0].severity == "error"


def test_large_closed_over_tensor_yields_jx003():
    big = torch.ones((600, 600))  # 1.44 MiB, closed over
    fs = ga.audit_fn(lambda x: x + big, np.ones((600, 600), np.float32))
    assert "JX003" in [f.code for f in fs]
    # passing it as an argument instead is the fix, and is clean
    fs = ga.audit_fn(lambda x, c: x + c, np.ones((600, 600), np.float32), big)
    assert "JX003" not in [f.code for f in fs]


def test_host_round_trip_yields_jx004():
    fs = ga.audit_fn(lambda x: x * float(x.sum()), np.ones(3, np.float32))
    assert "JX004" in [f.code for f in fs]


def test_dead_input_yields_jx005():
    fs = ga.audit_fn(lambda a, b: a * 2.0, np.ones(3, np.float32), np.ones(3, np.float32))
    jx5 = [f for f in fs if f.code == "JX005"]
    assert len(jx5) == 1 and "arg[1]" in jx5[0].name


def test_dead_param_in_graph_yields_jx005():
    gb = (NeuralNetConfiguration.builder().graph_builder().add_inputs("in")
          .set_input_types(InputType.feed_forward(6)))
    gb.add_layer("h", DenseLayer(n_out=4), "in")
    gb.add_layer("side", DenseLayer(n_out=3), "in")
    gb.add_layer("out", OutputLayer(n_out=2), "h")
    gb.set_outputs("out")
    net = ComputationGraph(gb.build(), device="cpu").init()
    fs = ga.audit_network(net)
    assert sorted(f.name for f in fs if f.code == "JX005") == [
        "JX005:param:side/W", "JX005:param:side/b"]


def test_bf16_widening_casts_are_informational():
    net = charlstm.char_lstm_network(vocab_size=11, hidden=8, layers=1, device="cpu",
                                     precision="bf16")
    fs = net.doctor(timesteps=6)
    assert {f.code for f in fs} == {"SF006", "JX002"}
    assert all(f.severity == "info" for f in fs)
    assert any("bfloat16 -> float32" in f.message for f in fs if f.code == "JX002")


def test_clean_networks_audit_clean():
    lstm = charlstm.char_lstm_network(vocab_size=11, hidden=8, layers=1, device="cpu")
    assert ga.audit_network(lstm, timesteps=6) == []
    tiny = ComputationGraph(resnet.tiny_resnet_conf(), device="cpu").init()
    assert ga.audit_network(tiny) == []
    assert ga.audit_network(lenet.lenet_network(device="cpu")) == []
    assert lstm.doctor(timesteps=6) == []
    assert _mlp().doctor() == []


def test_audit_without_an_input_type_is_skipped_with_info():
    fs = ga.audit_network(_mlp(input_type=False))
    assert [(f.code, f.severity) for f in fs] == [("JX000", "info")]

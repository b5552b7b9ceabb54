"""The port's profiler (utils/profiler.py): kernel names to families (the
port's own K1–K8 symbols, cuDNN/CUTLASS/cuBLAS conv and GEMM kernels,
ATen's elementwise, reduction and copy kernels), the family summary, the
roofline columns from the step cost model, and the profile JSON — on
CPU captures (torch.profiler without a card summarises the aten ops'
own CPU time and says so). The card's capture, with every kernel by
family, is chip_smoke.py's phase 15d.
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.analysis import costmodel
from deeplearning4j_tpu_torch.models import charlstm
from deeplearning4j_tpu_torch.utils import devprof
from deeplearning4j_tpu_torch.utils import profiler as P

# kernel names as the CUDA profiler reports them on the card
CARD_NAMES = {
    "void conv1x1_stats_bf16_kernel<(anonymous namespace)::Tile128>(...)": "K4 conv1x1_stats",
    "conv_kxk_stats_bf16_kernel": "K5 conv_kxk_stats",
    "void bn_apply_kernel<__nv_bfloat16, true>(...)": "K6 bn_apply",
    "bn_reduce_kernel": "K7 bn_backward_reduce",
    "void bn_dx_kernel<float>(...)": "K8 bn_backward_apply",
    "lstm_sequence_cluster_kernel": "K1 lstm_sequence",
    "lstm_sequence_bwd_cluster_kernel": "K3 lstm_sequence_bwd",
    "void drw_partial_kernel<float>(...)": "K3 lstm_sequence_bwd",
    "lstm_step_kernel": "K2 lstm_step",
    "void dl4j::convbn::column_sums(...)": "column_sums",
    "sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc_tilesize128x128x64":
        "conv (library)",
    "sm90_xmma_dgrad_implicit_gemm_bf16bf16": "conv (library)",
    "cutlass__5x_cudnn::Kernel<cutlass_tensorop_bf16_s16816wgrad_optimized>": "conv (library)",
    "sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64": "gemm (library)",
    "void cutlass::Kernel2<cutlass_80_wmma_tensorop_s161616gemm_bf16_16x16_128x2_tn>": "gemm (library)",
    "void at::native::vectorized_elementwise_kernel<4, at::native::CUDAFunctor_add<float>>":
        "elementwise",
    "void at::native::reduce_kernel<512, 1, at::native::ReduceOp<float>>": "reduction",
    "void at::native::(anonymous namespace)::CatArrayBatchedCopy<float>": "copy",
    "Memcpy HtoD (Pinned -> Device)": "copy",
    "void at::native::elementwise_kernel<128, 2, direct_copy_kernel_cuda>": "copy",
    "void at::native::(anonymous namespace)::max_pool_backward_nhwc<float>": "reduction",
    "some_unknown_symbol": "other",
}


@pytest.fixture(autouse=True)
def _sampling_off():
    prev = devprof.get_profiler().sample_every
    devprof.configure(sample_every=0)
    yield
    devprof.configure(sample_every=prev)


@pytest.mark.parametrize("name", sorted(CARD_NAMES))
def test_op_family_of_card_kernel_names(name):
    assert P.op_family(name) == CARD_NAMES[name]


def test_family_summary_aggregates_and_sorts():
    rows = [("conv1x1_stats_bf16_kernel", 0.002), ("conv1x1_stats_f32_kernel", 0.001),
            ("bn_apply_kernel", 0.0025), ("vectorized_elementwise_kernel", 0.0005)]
    assert P.family_summary(rows) == [("K4 conv1x1_stats", 0.003), ("K6 bn_apply", 0.0025),
                                      ("elementwise", 0.0005)]


def _lstm():
    return charlstm.char_lstm_network(vocab_size=11, hidden=8, layers=1, device="cpu")


def _fit(net, listener, batches=3):
    net.set_listeners(listener)
    x = np.zeros((2 * batches, 12, 11), np.float32)
    x[..., 0] = 1
    y = np.zeros_like(x)
    y[..., 1] = 1
    net.fit(x, y, batch_size=2, epochs=1, async_prefetch=False)


def test_roofline_columns_map_families_to_the_cost_model():
    m = costmodel.train_step_cost(_lstm(), batch_size=2, timesteps=12).to_dict()
    fams = {"K1 lstm_sequence": 1.0, "K4 conv1x1_stats": 2.0, "K6 bn_apply": 0.5,
            "K7 bn_backward_reduce": 0.25, "copy": 0.1, "other": 0.3}
    cols = P.roofline_columns(fams, m, steps=3)
    dot = m["families"]["dot_general"]
    assert cols["K1 lstm_sequence"]["flops"] == 3 * dot["flops"]
    assert cols["K1 lstm_sequence"]["cost_model_family"] == "dot_general"
    assert cols["K1 lstm_sequence"]["bound_ms"] == pytest.approx(
        max(3 * dot["flops"] / 989e12, 3 * dot["bytes"] / 3.35e12) * 1e3)
    ew = sum(f["bytes"] for f in m["families"].values() if f["kind"] == "elementwise")
    assert cols["K6 bn_apply"]["bytes"] == 3 * ew
    assert cols["K7 bn_backward_reduce"]["cost_model_family"] == "reduction"
    assert "flops" not in cols["K4 conv1x1_stats"]  # no conv in an LSTM
    assert cols["other"] == {"ms": 0.3}
    assert P.roofline_columns(fams, None)["K6 bn_apply"] == {"ms": 0.5}


def _one_conv_bn_graph(relu: bool):
    """input 8x8x3 -> 3x3 SAME conv (4 out, no bias) -> BN [-> relu] -> out."""
    from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
    from deeplearning4j_tpu_torch.nn.conf.layers import (
        ActivationLayer,
        BatchNormalization,
        ConvolutionLayer,
        GlobalPoolingLayer,
        OutputLayer,
    )

    gb = (NeuralNetConfiguration.builder().seed(1).graph_builder()
          .add_inputs("input").set_input_types(InputType.convolutional(8, 8, 3)))
    gb.add_layer("c", ConvolutionLayer(kernel_size=(3, 3), stride=(1, 1), n_out=4,
                                       convolution_mode="same", has_bias=False,
                                       activation="identity"), "input")
    gb.add_layer("bn", BatchNormalization(), "c")
    last = "bn"
    if relu:
        gb.add_layer("act", ActivationLayer(activation="relu"), "bn")
        last = "act"
    gb.add_layer("pool", GlobalPoolingLayer(pooling_type="avg"), last)
    gb.add_layer("out", OutputLayer(n_out=2, activation="softmax", loss="mcxent"), "pool")
    gb.set_outputs("out")
    return gb.build()


@pytest.mark.parametrize("relu", [False, True])
def test_kernel_costs_count_one_conv_bn_by_hand(relu):
    """kernelcoverage.kernel_costs on one 3x3 conv -> BN at batch 2, bf16:
    K5 reads x (2x8x8x3) and w (3x3x3x4) and writes y (2x8x8x4) plus two
    f32 [4] statistics; its FLOPs are 2*n*cout*cin over the 22x22 valid
    SAME taps; K6 reads and writes y; K7 reads g and y, K8 reads g and y
    and writes dx, each one tensor more when the BN applies the ReLU."""
    from deeplearning4j_tpu_torch.analysis.kernelcoverage import kernel_costs

    kc = kernel_costs(_one_conv_bn_graph(relu), batch=2, itemsize=2)
    mc, gate = 2 * 8 * 8 * 4, int(relu)
    assert kc["conv_kxk_stats"] == {"flops": 2.0 * 2 * 4 * 3 * 22 * 22,
                                    "bytes": 2 * (384 + 108 + mc) + 8 * 4, "launches": 1}
    assert kc["conv1x1_stats"]["launches"] == 0
    assert kc["bn_apply"] == {"flops": 3.0 * mc, "bytes": 2 * 2 * mc + 12 * 4,
                              "launches": 1}
    assert kc["bn_backward_reduce"]["bytes"] == 2 * (2 + gate) * mc + 8 * 4
    assert kc["bn_backward_apply"]["bytes"] == 2 * (3 + gate) * mc + 12 * 4


def test_kernel_costs_launches_match_the_resnet50_routing():
    """ResNet-50 at b128: the instances priced are the ones the process
    routes to K4-K8 (36 1x1, 17 kxk, a BN pass of each kind per conv),
    and 33 of the 53 BNs (the stem's, every block's _a and _b) apply the
    ReLU, so K7 moves 33 [M, C] reads more than its ungated floor."""
    from deeplearning4j_tpu_torch.analysis import kernelcoverage as kc
    from deeplearning4j_tpu_torch.analysis.costmodel import conv_instance_cost
    from deeplearning4j_tpu_torch.models.resnet import resnet50_conf

    conf = resnet50_conf()
    costs = kc.kernel_costs(conf, batch=128, itemsize=2)
    per_step = kc.launches_per_step(kc.coverage_table(conf, batch=128, planning=False))
    assert {k: costs[k]["launches"] for k in per_step} == per_step
    assert costs["bn_backward_reduce"]["launches"] == 53
    assert costs["bn_backward_apply"]["launches"] == 53
    outs = {name: conv_instance_cost(kernel=c["kernel"], stride=c["stride"],
                                     x_shape=c["x_shape"], n_out=c["n_out"],
                                     itemsize=2)["out_shape"]
            for name, c in kc.conv_instances(conf, batch=128)}
    mc = {name: s[0] * s[1] * s[2] * s[3] for name, s in outs.items()}
    gated = [n for n in mc if n.endswith(("_a_conv", "_b_conv")) or n == "stem_conv"]
    assert len(gated) == 33
    chans = sum(s[3] for s in outs.values())
    assert costs["bn_backward_reduce"]["bytes"] == (
        2 * 2 * sum(mc.values()) + 2 * sum(mc[n] for n in gated) + 8 * chans)


def test_roofline_columns_hold_port_kernels_to_their_own_work():
    """With kernel_costs, K4-K8 are held to their own instances' work
    (bound_of "kernel", the launches it covers); a family without its own
    count keeps its cost-model group's bound and says so."""
    m = costmodel.train_step_cost(_lstm(), batch_size=2, timesteps=12).to_dict()
    own = {"conv1x1_stats": {"flops": 4e12, "bytes": 1e9, "launches": 36},
           "bn_apply": {"flops": 3e9, "bytes": 6.7e9, "launches": 53},
           "conv_kxk_stats": {"flops": 0.0, "bytes": 0.0, "launches": 0}}
    fams = {"K4 conv1x1_stats": 9.0, "K6 bn_apply": 4.0, "K5 conv_kxk_stats": 1.0,
            "K1 lstm_sequence": 1.0, "other": 0.3}
    cols = P.roofline_columns(fams, m, steps=2, kernel_costs=own)
    k4 = cols["K4 conv1x1_stats"]
    assert (k4["bound_of"], k4["launches"], k4["flops"]) == ("kernel", 72, 8e12)
    assert k4["bound_ms"] == pytest.approx(8e12 / 989e12 * 1e3)
    assert cols["K6 bn_apply"]["bound_ms"] == pytest.approx(2 * 6.7e9 / 3.35e12 * 1e3)
    assert cols["K1 lstm_sequence"]["bound_of"] == "family group"
    assert "bound_ms" not in cols["K5 conv_kxk_stats"]  # none routed, no conv priced
    assert cols["other"] == {"ms": 0.3}
    only = P.roofline_columns(fams, None, steps=1, kernel_costs=own)
    assert only["K4 conv1x1_stats"]["bound_of"] == "kernel"
    assert only["K1 lstm_sequence"] == {"ms": 1.0}


def test_trace_writes_a_summary_and_profile_json(tmp_path):
    a = torch.randn(64, 64)
    with P.trace(str(tmp_path)):
        for _ in range(3):
            a = torch.tanh(a @ a)
    rows = P.op_summary(str(tmp_path), top=1000)
    names = [n for n, _ in rows]
    assert "aten::mm" in names and all(s >= 0 for _, s in rows)
    assert dict(P.family_summary(rows))["gemm (library)"] > 0
    out = tmp_path / "profile.json"
    payload = P.write_profile_json(str(tmp_path), str(out), meta={"what": "mm"})
    doc = json.loads(out.read_text())
    assert doc == payload
    assert doc["device"] is False and doc["total_device_sec"] == 0.0
    assert doc["families_ms"]["gemm (library)"] > 0 and doc["meta"] == {"what": "mm"}
    assert list(tmp_path.glob("trace.*.json"))


def test_profiler_listener_captures_its_window_with_cost_model_columns(tmp_path):
    net = _lstm()
    lines = []
    lst = P.ProfilerListener(str(tmp_path), start_iteration=0, n_iterations=2,
                             print_fn=lines.append)
    _fit(net, lst, batches=4)
    assert not lst._active and lst.summary
    assert lines and lines[0].startswith("device op time (top):")
    m = costmodel.train_step_cost(net, batch_size=2, timesteps=12).to_dict()
    payload = P.write_profile_json(str(tmp_path), str(tmp_path / "p.json"),
                                   cost_model=m, steps=2)
    assert payload["cost_model"]["model_flops"] > 0
    assert payload["families"]["gemm (library)"]["cost_model_family"] == "dot_general"
    assert payload["families"]["gemm (library)"]["bound_ms"] > 0


def test_profiler_listener_closes_a_window_cut_by_the_epoch(tmp_path, caplog):
    net = _lstm()
    lst = P.ProfilerListener(str(tmp_path), start_iteration=0, n_iterations=10)
    _fit(net, lst, batches=3)
    assert not lst._active
    assert P.latest_summary(str(tmp_path)) is not None
    assert "truncated" in caplog.text


def test_op_summary_of_an_empty_dir_is_empty(tmp_path):
    assert P.op_summary(str(tmp_path)) == []
    payload = P.write_profile_json(str(tmp_path), str(tmp_path / "e.json"))
    assert payload["families_ms"] == {} and payload["top_ops_ms"] == []


def test_performance_listener_labels_its_mfu_source(monkeypatch):
    """With a peak figure, the listener's MFU carries its FLOP source:
    "analytic" until a cost model is attached, then "costmodel"."""
    from deeplearning4j_tpu_torch.train.listeners import PerformanceListener

    monkeypatch.setenv("BENCH_PEAK_FLOPS", "1e12")
    net = _mlp()
    m = costmodel.train_step_cost(net, batch_size=4)
    lst = PerformanceListener(frequency=1)
    lst._win_examples0 = lst._fit_examples_total()
    # the listener reports MFU for a net on the card only
    monkeypatch.setattr(net, "device", torch.device("cuda"))
    got = lst._window_mfu(net, 1.0)
    assert got is not None and got[1] == "analytic"
    net.attach_cost_model(m, batch=4)
    assert lst._window_mfu(net, 1.0)[1] == "costmodel"


def _mlp():
    from deeplearning4j_tpu_torch.nn.conf import (
        DenseLayer,
        InputType,
        NeuralNetConfiguration,
        OutputLayer,
    )
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    conf = (NeuralNetConfiguration.builder().seed(1).list()
            .layer(DenseLayer(n_in=4, n_out=6, activation="tanh"))
            .layer(OutputLayer(n_in=6, n_out=2, activation="softmax", loss="mcxent"))
            .set_input_type(InputType.feed_forward(4)).build())
    return MultiLayerNetwork(conf, device="cpu").init()

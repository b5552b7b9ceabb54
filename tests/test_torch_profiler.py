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

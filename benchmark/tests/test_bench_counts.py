"""The yardstick's arithmetic against values worked out by hand."""

import json
import os

import pytest
import tiny  # noqa: F401  (puts the repo's root on the path)

from benchmark import harness, peaks

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SPEC = harness.Spec(ROOT)
RESNET = SPEC.config("resnet50")
LSTM = SPEC.config("charlstm")
REF_RESNET = SPEC.module("reference", "resnet")
REF_LSTM = SPEC.module("reference", "graveslstm")
CONVBN = SPEC.module("counts", "convbn")
LSTM_SEQ = SPEC.module("counts", "lstm_seq")


def test_one_conv_bn_instance_by_hand():
    """The stem at batch 2, bf16: 7x7/2, 3 -> 64, 224 -> 112. Along one
    axis the first output's window starts 2 pixels into the padding (5 of
    7 taps land), the last ends 3 past the image (4 land) and the one
    before it 1 past (6 land), the 109 others take all 7:
    5 + 6 + 4 + 763 = 778 valid pairs."""
    work = CONVBN.work(RESNET, REF_RESNET, {"phase": "train", "batch": 2}, 2)
    conv, apply_, reduce_, dx = work[:4]
    assert conv[0] == 2.0 * 2 * 64 * 3 * 778 * 778
    assert conv[1] == 2 * (2 * 224 * 224 * 3 + 7 * 7 * 3 * 64 + 2 * 112 * 112 * 64) + 8 * 64
    mc = 2 * 112 * 112 * 64
    assert apply_ == (3.0 * mc, 2 * 2 * mc + 12 * 64)
    assert reduce_ == (3.0 * mc, 2 * 3 * mc + 8 * 64)  # the ReLU gate reads y once more
    assert dx == (4.0 * mc, 2 * 4 * mc + 12 * 64)
    # a strided 1x1 projection reads only the rows it samples
    units = REF_RESNET.conv_bn_instances(RESNET, 2)
    i = [u["name"] for u in units].index("s1b0_sc")
    sc = work[4 * i]
    assert sc[1] == 2 * (2 * 28 * 28 * 256 + 256 * 512 + 2 * 28 * 28 * 512) + 8 * 512
    assert sc[0] == 2.0 * 2 * 28 * 28 * 256 * 512
    # 53 convs, each with its BN; inference runs none of the family
    assert len(work) == 4 * 53
    assert CONVBN.work(RESNET, REF_RESNET, {"phase": "infer", "batch": 2}, 2) == []


def test_one_lstm_segment_by_hand():
    """A TBPTT segment of 50 steps at B = 32 over both layers (H = 200),
    f32: the forward's recurrent product 2 B H 4H a step, the backward's
    two products 4 B H 4H a step."""
    unit = {"phase": "train", "batch": 32, "length": 50}
    (f1, b1), (g1, c1), (f2, b2), (g2, c2) = LSTM_SEQ.work(LSTM, REF_LSTM, unit, 4)
    T, B, H = 50, 32, 200
    assert f1 == f2 == 2.0 * B * H * 4 * H * T
    assert g1 == g2 == 4.0 * B * H * 4 * H * T
    fwd_bytes = 4 * (T * B * 4 * H + H * 4 * H + 3 * H + 2 * B * H     # xg, RW, peepholes, h0 c0
                     + T * B * H + T * B * 4 * H + 2 * T * B * H + B * H)  # y, gates, h c, cF
    assert b1 == b2 == fwd_bytes
    bwd_bytes = 4 * (T * B * 4 * H + 2 * T * B * H + H * 4 * H + 3 * H + T * B * H + B * H
                     + T * B * 4 * H + H * 4 * H + 3 * H + 2 * B * H)
    assert c1 == c2 == bwd_bytes
    # ops-bound on the H100 at f32: 15.28 us a forward of 100 steps (PERF.md's K1 bound)
    t100 = 2.0 * B * H * 4 * H * 100 / peaks.flops_peak("NVIDIA H100 80GB HBM3", "f32")
    assert abs(t100 * 1e3 - 0.01528) < 1e-5


def test_model_flops_per_sample():
    # char-LSTM: 557,000 multiply-adds a token forward (the issue's count)
    assert REF_LSTM.forward_flops_per_sample(LSTM) == 2.0 * (800 * 277 + 800 * 400 + 200 * 77)
    # ResNet-50 v1.5 at 224: about 4.1 G multiply-adds an image
    f = REF_RESNET.forward_flops_per_sample(RESNET)
    assert 8.0e9 < f < 8.4e9


def test_peaks_by_card_and_precision():
    assert peaks.flops_peak("NVIDIA H100 80GB HBM3", "bf16") == 989e12
    assert peaks.flops_peak("NVIDIA H100 80GB HBM3", "f32") == 67e12
    assert peaks.flops_peak("NVIDIA H100 PCIe", "bf16") == 756e12
    assert peaks.hbm_peak("NVIDIA H100 80GB HBM3") == 3.35e12
    assert peaks.flops_peak("NVIDIA A100-SXM4-80GB", "bf16") is None


def test_family_files_union_by_family(tmp_path):
    import shutil

    dest = tmp_path / "b"
    shutil.copytree(os.path.join(ROOT, "benchmark"), dest / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), dest / "BENCHMARK.json")
    extra = {"family": "convbn", "counts": "convbn", "kernels": ["cudnn_stats_pass"],
             "why": "a later implementation of the same work"}
    (dest / "benchmark" / "families" / "convbn_more.json").write_text(json.dumps(extra))
    fams = harness.Spec(str(dest)).families()
    assert "cudnn_stats_pass" in fams["convbn"]["patterns"]
    assert "conv1x1_stats" in fams["convbn"]["patterns"]


@pytest.mark.parametrize("name,want", [
    ("void conv1x1_stats_bf16_kernel<128, true>(float const*, int)", "conv1x1_stats_bf16_kernel"),
    ("void (anonymous namespace)::bn_apply_kernel<__nv_bfloat16>(int)", "bn_apply_kernel"),
    ("sm90_xmma_fprop_implicit_gemm_bf16", "sm90_xmma_fprop_implicit_gemm_bf16"),
    ("void at::native::elementwise_kernel<128, 4>(int)", "elementwise_kernel"),
])
def test_kernel_names_cut(name, want):
    from benchmark import trace

    assert trace.clean_name(name) == want


def test_trace_reduction_unions_and_gaps():
    from benchmark import trace

    dev = [("k_a", 0.0, 1.0), ("k_b", 0.5, 1.5), ("conv1x1_stats_x", 2.0, 3.0)]
    host = [("outer", 0.0, 4.0), ("cudaStreamSynchronize", 1.6, 1.9)]
    t = trace.Trace(dev, host, 4.0)
    assert t.busy_s == 2.5
    assert t.family_seconds(["conv1x1_stats"]) == 1.0
    assert t.idle_gaps(3) == [["cudaStreamSynchronize", 0.5]]
    assert t.top_ops(1) == [["k_a", 1.0]] or t.top_ops(1)[0][1] == 1.0

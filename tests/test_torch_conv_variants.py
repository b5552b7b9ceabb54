"""Which engine and tile the conv kernels K4 and K5 take
(`fused_conv_bn.conv_variant`), checked on the CPU: the choice is made in
Python before a launch, so it is testable without a card.

This file imports nothing of JAX.
"""

import pytest
import torch

from deeplearning4j_tpu_torch.models import resnet as tresnet
from deeplearning4j_tpu_torch.nn.compgraph import ComputationGraph
from deeplearning4j_tpu_torch.nn.conf import layers as TL
from deeplearning4j_tpu_torch.ops import fused_conv_bn as fcb

# an H100 SM has 228 KB of shared memory, 1 KB of it reserved per block
SM_SHARED = 228 * 1024
BLOCK_RESERVED = 1024


def _resnet50_convs():
    net = ComputationGraph(tresnet.resnet50_conf(precision="bf16"), device="cpu")
    return [(tuple(lc.kernel_size), lc.n_in, lc.n_out) for lc in net._layer_confs
            if isinstance(lc, TL.ConvolutionLayer)]


def test_every_resnet50_conv_gets_its_producer_tile_and_ring():
    convs = _resnet50_convs()
    assert len(convs) == 53
    producers = {}
    for kernel, cin, cout in convs:
        v = fcb.conv_variant(kernel, cin, cout, torch.bfloat16)
        producers[v["producer"]] = producers.get(v["producer"], 0) + 1
        assert v["producer"] == ("vector" if cin % 8 == 0 else "gather")
        assert v["bn"] == (64 if cout <= 64 else 128)
        depth_slices = -(-(kernel[0] * kernel[1] * cin) // fcb.SLICE_K)
        assert v["stages"] == min(fcb.MAX_STAGES[v["bn"]], depth_slices) >= 1
        assert v["tile_rows"] == fcb.TILE_M == 128
        assert v["smem_bytes"] <= fcb.SMEM_LIMIT == 227 * 1024
        # two blocks fit on one SM, so a block's epilogue or loads overlap
        # with another block's product
        assert 2 * (v["smem_bytes"] + BLOCK_RESERVED) <= SM_SHARED
        assert fcb.conv_variant(kernel, cin, cout, torch.float32)["producer"] == "simt"
    assert producers == {"vector": 52, "gather": 1}
    stem = fcb.conv_variant((7, 7), 3, 64, torch.bfloat16)
    assert (stem["producer"], stem["bn"], stem["stages"]) == ("gather", 64, 3)  # K = 147


@pytest.mark.parametrize("kernel,cin,cout,producer,bn", [
    ((3, 3), 24, 40, "vector", 64),    # a slice straddles taps
    ((3, 3), 19, 33, "gather", 64),    # ragged Cin and Cout
    ((1, 1), 37, 70, "gather", 128),
    ((1, 1), 64, 70, "gather", 128),   # ragged N: rows of w not 16-byte aligned
    ((1, 1), 64, 64, "vector", 64),
    ((1, 1), 64, 256, "vector", 128),
    ((7, 7), 3, 64, "gather", 64),
])
def test_variant_follows_channels(kernel, cin, cout, producer, bn):
    v = fcb.conv_variant(kernel, cin, cout, torch.bfloat16)
    assert (v["producer"], v["bn"]) == (producer, bn)


def test_unaligned_tensor_takes_the_gather_producer_and_f64_has_no_kernel():
    base = torch.zeros(64 * 64 + 1, dtype=torch.bfloat16)
    w = base[1:].view(64, 64)  # 2 bytes past an aligned start
    assert w.data_ptr() % 16 != 0
    x = torch.zeros(128, 64, dtype=torch.bfloat16)
    assert fcb.conv_variant((1, 1), 64, 64, torch.bfloat16, x)["producer"] == "vector"
    assert fcb.conv_variant((1, 1), 64, 64, torch.bfloat16, x, w)["producer"] == "gather"
    with pytest.raises(TypeError):
        fcb.conv_variant((1, 1), 64, 64, torch.float64)

"""Which sequence kernel the LSTM wrappers launch (`fused_lstm.lstm_variant`)
and the scratch they allocate for it (`fused_lstm.sequence_scratch`),
checked on the CPU: both are decided in Python before a launch, so they are
testable without a card.

This file imports nothing of JAX.
"""

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.ops import fused_lstm as fl

# an H100 block may use 227 KB of shared memory (dynamic + static)
SMEM_LIMIT = 227 * 1024


@pytest.mark.parametrize("backward", [False, True], ids=["forward", "backward"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("B", [1, 8, 32, 64, 65, 128])
def test_char_lstm_shapes_take_the_cluster_variant(B, dtype, backward):
    v = fl.lstm_variant(B, 200, dtype, backward=backward)
    assert v["variant"] == "cluster"
    R = 4 if B <= 64 else 8  # past 64 rows, clusters of 4 would outnumber the SMs
    assert (v["C"], v["R"], v["U"]) == (8, R, 25)
    assert v["ctas"] == 8 * -(-B // R) <= 136  # 8 clusters x 8 CTAs at B=32
    assert 0 < v["smem_bytes"] <= SMEM_LIMIT


def test_cluster_shared_memory_at_char_lstm_and_at_the_limit():
    # forward: RW slice [200][100] + h [2][200][R] + pre [2][R][100], f32
    assert fl.lstm_variant(32, 200, torch.float32)["smem_bytes"] == 4 * (20000 + 1600 + 800)
    assert fl.lstm_variant(128, 200, torch.float32)["smem_bytes"] == 4 * (20000 + 3200 + 1600)
    # backward: RW^T slice [100][200] + dpre [100][R] + receive [2][8][R][25]
    assert (fl.lstm_variant(32, 200, torch.float32, backward=True)["smem_bytes"]
            == 4 * (20000 + 400 + 1600))
    assert (fl.lstm_variant(128, 200, torch.float32, backward=True)["smem_bytes"]
            == 4 * (20000 + 800 + 3200))
    for backward in (False, True):
        for B in (32, 128):
            top = fl.lstm_variant(B, 256, torch.float32, backward=backward)
            assert (top["variant"], top["U"]) == ("cluster", 32)
            assert top["smem_bytes"] <= SMEM_LIMIT


@pytest.mark.parametrize("backward", [False, True], ids=["forward", "backward"])
@pytest.mark.parametrize("H", [257, 300, 512])
def test_past_the_cluster_limit_takes_the_grid_variant(H, backward):
    v = fl.lstm_variant(32, H, torch.float32, backward=backward)
    assert v["variant"] == "grid"
    assert (v["C"], v["R"], v["U"]) == (-(-H // 8), 8, 8)
    assert v["ctas"] == v["C"]
    assert v["smem_bytes"] <= SMEM_LIMIT
    with pytest.raises(ValueError, match="cluster"):
        fl.lstm_variant(32, H, torch.float32, backward=backward, variant="cluster")


def test_grid_variant_keeps_its_range_and_shapes_past_it_raise():
    # the grid backward takes H up to ~550 at B=32, the forward far more
    assert fl.lstm_variant(32, 540, torch.float32, backward=True)["variant"] == "grid"
    with pytest.raises(ValueError, match="no backward sequence kernel"):
        fl.lstm_variant(32, 560, torch.float32, backward=True)
    assert fl.lstm_variant(32, 1000, torch.float32)["variant"] == "grid"
    with pytest.raises(ValueError, match="no forward sequence kernel"):
        fl.lstm_variant(32, 2000, torch.float32)
    # a large batch grows the grid's per-block carry, never the cluster's
    assert fl.lstm_variant(100_000, 200, torch.float32)["variant"] == "cluster"
    with pytest.raises(ValueError):
        fl.lstm_variant(100_000, 300, torch.float32)


def test_grid_variant_can_be_asked_for_where_the_cluster_would_run():
    v = fl.lstm_variant(32, 200, torch.float32, variant="grid", backward=True)
    assert (v["variant"], v["C"], v["U"]) == ("grid", 25, 8)
    # the grid backward's footprint: RW rows, dRW slice, dpre and hprev
    # rows, the dc carry, plus 2912 bytes of static shared memory
    assert v["smem_bytes"] == 4 * (8 * 801 + 200 * 32 + 8 * 800 + 8 * 200 + 32 * 8) + 2912


@pytest.mark.parametrize("B,H", [(5, 20), (13, 200), (1, 9), (33, 255), (70, 200)])
def test_ragged_shapes_are_covered_by_masked_rows_and_units(B, H):
    """B not a multiple of R, H not a multiple of C: the clusters cover
    every row and the CTAs every unit, the rest is masked."""
    v = fl.lstm_variant(B, H, torch.float32)
    C, R, U = v["C"], v["R"], v["U"]
    assert v["variant"] == "cluster"
    clusters = v["ctas"] // C
    assert (clusters - 1) * R < B <= clusters * R
    assert (U - 1) * C < H <= C * U
    owned = [max(0, min(U, H - q * U)) for q in range(C)]
    assert sum(owned) == H
    rows = [min(R, B - c * R) for c in range(clusters)]
    assert sum(rows) == B and min(rows) >= 1
    # the gate threads (R * U) and the backward's partial threads (H) fit
    # in one 256-thread CTA
    assert R * U <= 256 and H <= 256


@pytest.mark.parametrize("T,B,H", [(50, 32, 200), (100, 32, 200), (7, 5, 20), (3, 1, 200)])
def test_scratch_shapes(T, B, H):
    assert fl.sequence_scratch(T, B, H, "cluster") == {}
    s = fl.sequence_scratch(T, B, H, "cluster", backward=True)
    assert s["dpre"] == (T, B, 4 * H)  # the f32 dpre of every step
    assert s["drw_part"] == (-(-T * B // fl.DRW_CHUNK), H, 4 * H)
    assert s["dp_part"] == (B, 3, H)
    assert fl.sequence_scratch(T, B, H, "grid") == {"hbuf": (2, B, H), "bar": (1,)}
    assert fl.sequence_scratch(T, B, H, "grid", backward=True) == {
        "xbuf": (2, B, 4 * H), "bar": (1,)}
    # at the training segment: 5.1 MB of dpre, 7 partials of dRW
    if (T, B, H) == (50, 32, 200):
        assert int(np.prod(s["dpre"])) * 4 == 5_120_000
        assert s["drw_part"][0] == 7
    with pytest.raises(ValueError):
        fl.sequence_scratch(T, B, H, "warp")


def test_variant_rejects_bad_arguments():
    with pytest.raises(TypeError):
        fl.lstm_variant(32, 200, torch.float64)
    with pytest.raises(ValueError, match="variant must be"):
        fl.lstm_variant(32, 200, torch.float32, variant="warp")
    with pytest.raises(ValueError):
        fl.lstm_variant(0, 200, torch.float32)


@pytest.mark.parametrize("variant", ["cluster", "grid"])
def test_cpu_wrappers_take_the_plain_version_whatever_the_variant(variant):
    rng = np.random.default_rng(3)
    T, B, H = 4, 3, 8
    a = [torch.from_numpy((rng.standard_normal(s) * k).astype(np.float32)) for s, k in
         (((T, B, 4 * H), 1.0), ((H, 4 * H), 0.1), ((H,), 0.3), ((H,), 0.3),
          ((H,), 0.3), ((B, H), 0.5), ((B, H), 0.5))]
    fl.reset_launch_counts()
    out = fl.lstm_sequence_forward(*a, variant=variant)
    ref = fl.lstm_sequence_forward_reference(*a)
    for o, r in zip(out, ref):
        assert torch.equal(o, r)
    _, acts, hprev, cprev, _ = ref
    dy, dcF = torch.ones(T, B, H), torch.ones(B, H)
    bout = fl.lstm_sequence_backward(acts, hprev, cprev, *a[1:5], dy, dcF, variant=variant)
    bref = fl.lstm_sequence_backward_reference(acts, hprev, cprev, *a[1:5], dy, dcF)
    for o, r in zip(bout, bref):
        assert torch.equal(o, r)
    assert fl.launch_counts()["lstm_sequence"] == 0
    assert fl.launch_counts()["lstm_sequence_backward"] == 0


# -- the probes decline shapes no kernel variant takes -------------------------

_PROBE = dict(peephole=True, mask=None, gate_act="sigmoid", cell_act="tanh",
              reverse=False, dtype=torch.float32)


@pytest.fixture
def on_hopper(monkeypatch):
    """Route as a Hopper GPU would: the probes' device check passes."""
    from deeplearning4j_tpu_torch.ops import cuda_build

    monkeypatch.setattr(cuda_build, "on_hopper", lambda device=None: True)


@pytest.mark.parametrize("B,H,backward,takes", [
    (32, 200, True, True),     # char-LSTM training: the cluster variants
    (32, 200, False, True),
    (32, 560, True, False),    # past the grid backward's shared memory
    (32, 560, False, True),    # ... which the forward alone fits
    (32, 1500, False, False),  # past the grid forward's shared memory
    (4096, 300, True, False),  # the grid backward's per-block carry grows with B
    (4096, 300, False, True),
], ids=["char_lstm_train", "char_lstm_infer", "bwd_560", "fwd_560", "fwd_1500",
        "bwd_b4096", "fwd_b4096"])
def test_sequence_probe_declines_where_no_variant_takes_the_shape(on_hopper, B, H,
                                                                  backward, takes):
    dev = torch.device("cuda")
    assert fl.supported(**_PROBE, device=dev, B=B, H=H, backward=backward) is takes
    try:
        fl.lstm_variant(B, H, torch.float32)
        if backward:
            fl.lstm_variant(B, H, torch.float32, backward=True)
        fits = True
    except ValueError:
        fits = False
    assert fits is takes  # the probe says what lstm_variant says


def _step_probe_case(H, dtype, takes):
    # K2 holds its RW slice [H, 16] in RW's dtype, its h rows [8, hp] in
    # f32 (hp: H rounded up to a multiple of 4 and to an odd number of
    # 16-byte units) and the partial sums [4, 8, 16] in f32
    itemsize = 2 if dtype == torch.bfloat16 else 4
    hp = -(-H // 4) * 4
    hp += 4 if (hp // 4) % 2 == 0 else 0
    assert fl.step_h_stride(H) == hp
    assert fl.step_smem(H, dtype) == 16 * itemsize * H + 32 * hp + 2048
    assert (fl.step_smem(H, dtype) <= fl.SMEM_LIMIT) is takes
    assert fl.step_supported(peephole=True, gate_act="sigmoid", cell_act="tanh",
                             device=torch.device("cuda"), H=H, dtype=dtype) is takes


@pytest.mark.parametrize("H,takes", [(200, True), (2398, True), (2399, False), (3000, False)])
def test_step_probe_declines_past_the_step_kernels_shared_memory(on_hopper, H, takes):
    _step_probe_case(H, torch.float32, takes)
    assert not fl.step_supported(peephole=True, gate_act="sigmoid", cell_act="tanh",
                                 device=torch.device("cuda"), H=200,
                                 dtype=torch.float64)


@pytest.mark.parametrize("H,takes", [(2399, True), (3596, True), (3597, False)])
def test_step_probe_takes_bf16_to_its_own_shared_memory_limit(on_hopper, H, takes):
    """bf16 RW takes half the slice: the limit is H = 3596, not 2398."""
    _step_probe_case(H, torch.bfloat16, takes)


@pytest.mark.parametrize("H,kernel", [(600, False), (24, True)], ids=["H600", "H24"])
def test_graves_lstm_at_an_untaken_shape_runs_its_builtin_loop(on_hopper, monkeypatch,
                                                               H, kernel):
    """A GravesLSTM training at B = 32, H = 600 (the backward kernel's grid
    variant stops near H = 550) gets the layer's builtin loop, not the
    helper; at a shape the kernels take, the helper runs."""
    from deeplearning4j_tpu_torch.nn.conf import layers as TL
    from deeplearning4j_tpu_torch.nn.layers.registry import LayerContext
    from deeplearning4j_tpu_torch.nn.layers.registry import forward_layer, init_layer_params
    from deeplearning4j_tpu_torch.ops import helpers

    calls = []
    h = helpers._HELPERS["lstm_sequence"]
    plain_fn = h.fn
    monkeypatch.setattr(h, "fn", lambda *a: calls.append(a[0].shape) or plain_fn(*a))
    conf = TL.GravesLSTM(n_in=3, n_out=H, activation="tanh", weight_init="xavier")
    params = init_layer_params(torch.Generator().manual_seed(0), conf, torch.float32)
    params = {k: v.requires_grad_() for k, v in params.items()}
    x = torch.from_numpy(np.random.default_rng(5).standard_normal((32, 2, 3))
                         .astype(np.float32))
    y, _ = forward_layer(conf, params, x, LayerContext(training=True))
    y.square().sum().backward()
    assert tuple(y.shape) == (32, 2, H)
    assert all(p.grad is not None for p in params.values())
    assert calls == ([(2, 32, 4 * H)] if kernel else [])

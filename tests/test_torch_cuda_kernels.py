"""The port's CUDA kernels against their plain PyTorch versions, on a
Hopper GPU (`cuda` marker; each test skips itself without one).

This file imports nothing of JAX, so it also runs where JAX is not
installed: `python -m pytest --noconftest tests/test_torch_cuda_kernels.py`
(tests/conftest.py imports jax).
"""

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.ops import fused_lstm as fl


@pytest.fixture(autouse=True)
def _no_tf32():
    """The plain versions compute in f32: cuDNN's default TF32 would give
    their convolutions about three decimal digits. Every f32 policy turns
    it off (common/dtypes.py); so does this file."""
    old = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = old


def _require_hopper():
    if not (torch.cuda.is_available()
            and torch.cuda.get_device_capability() >= (9, 0)):
        pytest.skip("needs an NVIDIA GPU of compute capability >= 9.0")


def _inputs(seed, T, B, H, dtype):
    rng = np.random.default_rng(seed)
    shapes = [(B, 4 * H) if T is None else (T, B, 4 * H), (H, 4 * H),
              (H,), (H,), (H,), (B, H), (B, H)]
    scales = [1.0, 0.1, 0.3, 0.3, 0.3, 0.5, 0.5]
    return [torch.from_numpy((rng.standard_normal(s) * k).astype(np.float32))
            .to(dtype).cuda() for s, k in zip(shapes, scales)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("seq", [False, True])
def test_kernel_matches_plain_version_and_counts_one_launch(dtype, seq):
    _require_hopper()
    dt = getattr(torch, dtype)
    fn, ref = ((fl.lstm_sequence_forward, fl.lstm_sequence_forward_reference)
               if seq else (fl.lstm_step, fl.lstm_step_reference))
    a = _inputs(4, 20 if seq else None, 8, 200, dt)
    before = fl.launch_counts()
    outs = fn(*a)
    torch.cuda.synchronize()
    name = "lstm_sequence" if seq else "lstm_step"
    assert fl.launch_counts()[name] == before[name] + 1
    tol = (dict(rtol=1e-5, atol=1e-5) if dt == torch.float32
           else dict(rtol=2 ** -7, atol=2 ** -7))
    for o, r in zip(outs, ref(*a)):
        torch.testing.assert_close(o.float(), r.float(), **tol)


# K2's largest hidden size: its shared memory at H + 1 passes the H100's
# 227 KB (fused_lstm.step_smem)
STEP_LIMIT = {"float32": 2398, "bfloat16": 3596}


def _step_inputs(seed, B, H, dtype, peephole):
    a = _inputs(seed, None, B, H, dtype)
    if not peephole:
        a[2:5] = [torch.zeros_like(p) for p in a[2:5]]
    return a


def _step_close(outs, refs, dtype, H):
    """f32: 1e-5 * sqrt(H) absolute (a sum of H products taken in another
    order); bf16: one bf16 rounding step, 2^-7 * max(1, |plain|)."""
    for o, r in zip(outs, refs):
        o, r = o.float(), r.float()
        assert bool(torch.isfinite(o).all())
        d = (o - r).abs()
        lim = (torch.full_like(r, 1e-5 * H ** 0.5) if dtype == torch.float32
               else 2 ** -7 * r.abs().clamp_min(1.0))
        assert bool((d <= lim).all()), f"max abs err {d.max().item():.3e}"


@pytest.mark.cuda
@pytest.mark.parametrize("peephole", [True, False], ids=["peep", "nopeep"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("H", [24, 200, 300, "limit"])
@pytest.mark.parametrize("B", [1, 8, 64, 70])
def test_step_kernel_matches_plain_version_at_every_shape(B, H, dtype, peephole):
    """K2 at 1, 8 and 64 slots and a ragged 70 (the last block of rows
    part full), at char-LSTM's H = 200, a small and a larger H, and its
    largest H (f32 2398, not a multiple of its 4 units a block: the
    plain-load staging path), one launch per call."""
    _require_hopper()
    dt = getattr(torch, dtype)
    H = STEP_LIMIT[dtype] if H == "limit" else H
    a = _step_inputs(9, B, H, dt, peephole)
    before = fl.launch_counts()["lstm_step"]
    outs = fl.lstm_step(*a)
    torch.cuda.synchronize()
    assert fl.launch_counts()["lstm_step"] == before + 1
    _step_close(outs, fl.lstm_step_reference(*a), dt, H)


@pytest.mark.cuda
def test_step_kernel_shared_memory_and_geometry_agree_with_the_probe():
    _require_hopper()
    import ctypes

    from deeplearning4j_tpu_torch.ops import cuda_build

    lib = cuda_build.library("lstm_step")
    lib.lstm_step_smem.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.lstm_step_smem.restype = ctypes.c_longlong
    for code, dt in ((0, torch.float32), (1, torch.bfloat16)):
        for H in (1, 2, 3, 16, 24, 199, 200, 300, 2398, 3596):
            assert lib.lstm_step_smem(code, H) == fl.step_smem(H, dt)
    geo = [ctypes.c_int() for _ in range(4)]
    lib.lstm_step_geometry(*(ctypes.byref(g) for g in geo))
    assert [g.value for g in geo[:3]] == [fl.STEP_UNITS, fl.STEP_SPLIT, fl.STEP_ROWS]
    for dtype, H in STEP_LIMIT.items():
        dt = getattr(torch, dtype)
        assert fl.step_smem(H, dt) <= fl.SMEM_LIMIT < fl.step_smem(H + 1, dt)
    with pytest.raises(ValueError, match="shared memory"):
        fl.lstm_step(*_step_inputs(1, 1, STEP_LIMIT["float32"] + 1, torch.float32, True))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_step_rows_are_bit_equal_across_batch_size_and_slot_index(dtype):
    """Each row of a B = 8 call has the bits of the same row launched
    alone at B = 1, and of the same row at another slot index (rows
    rolled within B = 8, and placed in the last row block of B = 64)."""
    _require_hopper()
    dt = getattr(torch, dtype)
    a = _step_inputs(13, 8, 200, dt, True)
    h8, c8 = fl.lstm_step(*a)
    rows = lambda t, idx: t[idx].contiguous()  # noqa: E731
    for b in range(8):
        h1, c1 = fl.lstm_step(rows(a[0], [b]), *a[1:5], rows(a[5], [b]), rows(a[6], [b]))
        assert torch.equal(h1[0], h8[b]) and torch.equal(c1[0], c8[b])
    perm = torch.roll(torch.arange(8), 3)
    hp, cp = fl.lstm_step(rows(a[0], perm), *a[1:5], rows(a[5], perm), rows(a[6], perm))
    assert torch.equal(hp, h8[perm]) and torch.equal(cp, c8[perm])
    big = _step_inputs(14, 64, 200, dt, True)
    for t, src in ((big[0], a[0]), (big[5], a[5]), (big[6], a[6])):
        t[56:] = src
    h64, c64 = fl.lstm_step(*big[:1], *a[1:5], *big[5:])
    torch.cuda.synchronize()
    assert torch.equal(h64[56:], h8) and torch.equal(c64[56:], c8)


def _graphed_engine(K, n_slots=8):
    from deeplearning4j_tpu_torch.models.charlstm import char_lstm_network
    from deeplearning4j_tpu_torch.serving.decode import DecodeEngine

    net = char_lstm_network(vocab_size=77, hidden=200, layers=2, seed=3)
    eng = DecodeEngine(net, n_slots=n_slots,
                       component_prefix=f"cuda_graph_k{K}").set_fused_steps(K)
    return net, eng


def _hits(op="lstm_decode_step"):
    from deeplearning4j_tpu_torch.utils import metrics

    fam = metrics.get_registry().get("helper_hit_total")
    return 0.0 if fam is None else sum(c.value for labels, c in fam.children()
                                       if labels[0] == op)


@pytest.mark.cuda
@pytest.mark.parametrize("K", [1, 4])
def test_graphed_engine_carry_is_bit_equal_to_eager_steps_and_counts_replays(K):
    """N replays of the captured program leave the static carry with the
    bits of N eager calls of the model's decode step on the same tokens;
    each replay counts its 2 K launches of K2 and its 2 K SPI hits, and
    the engine captured one graph per parameter set."""
    _require_hopper()
    net, eng = _graphed_engine(K)
    n, steps = eng.n_slots, 5
    rng = np.random.default_rng(K)
    feeds = rng.integers(0, 77, size=(steps, K, n)).astype(np.int32)
    force = rng.random((steps, K, n)) < 0.5
    force[:, 0] = True
    try:
        eng.warmup()
        assert eng.metrics()["captures"] == {K: 2} and eng.program_cache_size() == 2
        for st in eng._carry.values():
            for a in st.values():
                a.copy_(torch.from_numpy(rng.standard_normal(tuple(a.shape))
                                         .astype(np.float32) * 0.3))
        start = {i: {k: a.clone() for k, a in st.items()} for i, st in eng._carry.items()}
        fl.reset_launch_counts()
        hits0 = _hits()
        got = []
        for s in range(steps):
            eng._live = s % 2  # both sets hold the model's weights
            if K == 1:
                eng._io[1]["feed"].copy_(torch.from_numpy(feeds[s, 0]))
            else:
                eng._io[K]["toks"].copy_(torch.from_numpy(feeds[s]))
                eng._io[K]["force"].copy_(torch.from_numpy(force[s]))
            got.append(eng._run_program())
        torch.cuda.synchronize()
        assert fl.launch_counts()["lstm_step"] == 2 * K * steps
        assert _hits() - hits0 == 2 * K * steps
        graphed = {i: {k: a.clone() for k, a in st.items()} for i, st in eng._carry.items()}
    finally:
        eng.shutdown()
    step = net.rnn_decode_step_fn()
    ref = start
    with torch.no_grad():
        for s in range(steps):
            prev = torch.from_numpy(feeds[s, 0]).cuda()
            toks = []
            for t in range(K):
                tok = torch.where(torch.from_numpy(force[s, t]).cuda(),
                                  torch.from_numpy(feeds[s, t]).cuda(), prev)
                x = torch.nn.functional.one_hot(tok.long(), 77).to(torch.float32)
                ref, out = step(net.params_list, net.state_list, ref, x)
                prev = torch.argmax(out, dim=-1).to(torch.int32)
                toks.append(prev.cpu().numpy())
            np.testing.assert_array_equal(got[s].reshape(-1, n), np.stack(toks))
    for i in ref:
        for k in ref[i]:
            assert torch.equal(graphed[i][k], ref[i][k])


@pytest.mark.cuda
def test_graphed_engine_serves_the_sequential_loops_tokens_across_a_swap():
    """Small width, K = 1 and K = 4: the tokens of the sequential
    rnn_time_step loop before and after a weight swap, with no capture
    after the first step's two."""
    _require_hopper()
    from deeplearning4j_tpu_torch.models.charlstm import char_lstm_network
    from deeplearning4j_tpu_torch.serving.decode import DecodeEngine

    net = char_lstm_network(vocab_size=13, hidden=16, layers=2, seed=4)
    v1 = net.params_list
    v2 = [{k: t * 1.4 for k, t in p.items()} for p in v1]
    eye = np.eye(13, dtype=np.float32)

    def loop(params, prompt, mx):
        net.params_list = params
        net.clear_rnn_state()
        try:
            for t in prompt:
                out = net.rnn_time_step(eye[[t]])
            toks = []
            while len(toks) < mx:
                toks.append(int(torch.argmax(out[0]).item()))
                out = net.rnn_time_step(eye[[toks[-1]]])
        finally:
            net.params_list = v1
            net.clear_rnn_state()
        return toks

    rng = np.random.default_rng(8)
    reqs = [(rng.integers(0, 13, size=1 + i % 4).tolist(), 4 + i % 3) for i in range(6)]
    for K in (1, 4):
        eng = DecodeEngine(net, n_slots=3, component_prefix=f"cuda_swap_k{K}").set_fused_steps(K)
        try:
            out1 = [f.result(120) for f in [eng.generate(p, max_new_tokens=m) for p, m in reqs]]
            caps = eng.metrics()["captures"]
            eng.load_version(v2)
            out2 = [f.result(120) for f in [eng.generate(p, max_new_tokens=m) for p, m in reqs]]
            m = eng.metrics()
        finally:
            eng.shutdown()
        assert caps == {K: 2} and m["captures"] == {K: 2} and m["program_cache_size"] == 2
        assert m["version"] == 1 and m["failed"] == 0
        assert out1 == [loop(v1, p, mx) for p, mx in reqs]
        assert out2 == [loop(v2, p, mx) for p, mx in reqs]


def _backward_inputs(seed, T, B, H, dtype):
    """The forward kernel's stashes plus random cotangents."""
    a = _inputs(seed, T, B, H, dtype)
    _, acts, hprev, cprev, _ = fl.lstm_sequence_forward(*a)
    rng = np.random.default_rng(seed + 1)
    dy, dcF = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               .to(dtype).cuda() for s in ((T, B, H), (B, H)))
    return [acts, hprev, cprev, *a[1:5], dy, dcF]


def _backward_tolerance(dtype, T, B):
    """f32: 1e-5 for the per-step outputs; dRW and the peephole grads are
    sums of T*B products, whose rounding in another order grows like
    sqrt(T*B). bf16: one bf16 rounding step of the per-step outputs."""
    if dtype == torch.float32:
        return dict(rtol=1e-5, atol=1e-5), dict(rtol=1e-5, atol=1e-5 * (T * B) ** 0.5)
    tol = dict(rtol=2 ** -7, atol=2 ** -7)
    return tol, tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(50, 32, 200), (7, 5, 20)], ids=["segment", "ragged"])
def test_backward_kernel_matches_plain_version_and_counts_one_launch(dtype, shape):
    _require_hopper()
    dt = getattr(torch, dtype)
    T, B, H = shape
    args = _backward_inputs(6, T, B, H, dt)
    before = fl.launch_counts()["lstm_sequence_backward"]
    outs = fl.lstm_sequence_backward(*args)
    torch.cuda.synchronize()
    assert fl.launch_counts()["lstm_sequence_backward"] == before + 1
    refs = fl.lstm_sequence_backward_reference(*args)
    step_tol, sum_tol = _backward_tolerance(dt, T, B)
    for i, (o, r) in enumerate(zip(outs, refs)):
        assert o.dtype == r.dtype
        torch.testing.assert_close(o.float(), r.float(),
                                   **(sum_tol if 1 <= i <= 4 else step_tol))


# (T, B, H) and variant: char-LSTM's widths at T=50 and T=100, a ragged
# shape (B not a multiple of the cluster's rows, H not a multiple of its 8
# CTAs), a short B=1 sequence, B=70 (clusters of 8 rows, the last ragged),
# each on both variants; H=300, past the cluster variant's H <= 256, on the
# grid variant
_VARIANT_CASES = [(s, v) for s in ((50, 32, 200), (100, 32, 200), (7, 5, 20), (3, 1, 200),
                                   (10, 70, 200))
                  for v in ("cluster", "grid")] + [((20, 32, 300), "grid")]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,variant", _VARIANT_CASES,
                         ids=[f"{v}-{'x'.join(map(str, s))}" for s, v in _VARIANT_CASES])
def test_sequence_kernels_match_plain_versions_on_each_variant(dtype, shape, variant):
    """K1 and K3 on one variant against their plain versions, and two
    launches of each bit-equal (every sum runs in a fixed order)."""
    _require_hopper()
    dt = getattr(torch, dtype)
    T, B, H = shape
    assert fl.lstm_variant(B, H, dt, variant=variant)["variant"] == variant
    a = _inputs(11, T, B, H, dt)
    outs = fl.lstm_sequence_forward(*a, variant=variant)
    again = fl.lstm_sequence_forward(*a, variant=variant)
    torch.cuda.synchronize()
    tol = (dict(rtol=1e-5, atol=1e-5) if dt == torch.float32
           else dict(rtol=2 ** -7, atol=2 ** -7))
    for o, r, o2 in zip(outs, fl.lstm_sequence_forward_reference(*a), again):
        torch.testing.assert_close(o.float(), r.float(), **tol)
        assert torch.equal(o, o2)
    _, acts, hprev, cprev, _ = outs
    rng = np.random.default_rng(12)
    dy, dcF = (torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(dt).cuda()
               for s in ((T, B, H), (B, H)))
    args = [acts, hprev, cprev, *a[1:5], dy, dcF]
    bouts = fl.lstm_sequence_backward(*args, variant=variant)
    bagain = fl.lstm_sequence_backward(*args, variant=variant)
    torch.cuda.synchronize()
    step_tol, sum_tol = _backward_tolerance(dt, T, B)
    for i, (o, r, o2) in enumerate(zip(bouts, fl.lstm_sequence_backward_reference(*args),
                                       bagain)):
        assert o.dtype == r.dtype
        torch.testing.assert_close(o.float(), r.float(),
                                   **(sum_tol if 1 <= i <= 4 else step_tol))
        assert torch.equal(o, o2)


@pytest.mark.cuda
def test_cluster_occupancy_fits_the_char_lstm_grid():
    """Every cluster of the training segment's launch can be resident at
    once (8 clusters of 8 CTAs at B=32), forward and backward."""
    _require_hopper()
    for backward in (False, True):
        v = fl.lstm_variant(32, 200, torch.float32, backward=backward)
        assert fl.cluster_occupancy(200, v["R"], backward=backward) >= v["ctas"] // v["C"] == 8


@pytest.mark.cuda
def test_autograd_function_runs_both_kernels_and_matches_plain_backward():
    _require_hopper()
    T, B, H = 12, 4, 40
    a = _inputs(7, T, B, H, torch.float32)
    rng = np.random.default_rng(8)
    gy, ghF, gcF = (torch.from_numpy(rng.standard_normal(s).astype(np.float32)).cuda()
                    for s in ((T, B, H), (B, H), (B, H)))
    leaves = [t.clone().requires_grad_() for t in a]
    before = fl.launch_counts()
    y, hF, cF = fl.lstm_sequence(*leaves)
    ((y * gy).sum() + (hF * ghF).sum() + (cF * gcF).sum()).backward()
    torch.cuda.synchronize()
    after = fl.launch_counts()
    assert after["lstm_sequence"] == before["lstm_sequence"] + 1
    assert after["lstm_sequence_backward"] == before["lstm_sequence_backward"] + 1
    _, acts, hprev, cprev, _ = fl.lstm_sequence_forward_reference(*a)
    dy = gy.clone()
    dy[-1] += ghF
    refs = fl.lstm_sequence_backward_reference(acts, hprev, cprev, *a[1:5], dy, gcF)
    step_tol, sum_tol = _backward_tolerance(torch.float32, T, B)
    for i, (leaf, r) in enumerate(zip(leaves, refs)):
        torch.testing.assert_close(leaf.grad, r, **(sum_tol if 1 <= i <= 4 else step_tol))


@pytest.mark.cuda
def test_kernel_errors_propagate_instead_of_falling_back():
    _require_hopper()
    a = _inputs(5, None, 2, 16, torch.float32)
    with pytest.raises(TypeError):
        fl.lstm_step(*(x.double() for x in a))
    from deeplearning4j_tpu_torch.ops import helpers

    def broken(*args):
        raise RuntimeError("kernel failed")

    helpers.register_helper("test_cuda_op", broken)
    try:
        with pytest.raises(RuntimeError, match="kernel failed"):
            helpers.get_helper("test_cuda_op")(a[0])
        assert helpers.helper_enabled("test_cuda_op") is True
    finally:
        helpers._HELPERS.pop("test_cuda_op", None)


# -- the conv/BN kernels (K4-K8) ---------------------------------------------

from deeplearning4j_tpu_torch.ops import fused_conv_bn as fcb  # noqa: E402


def _t(rng, shape, dtype, scale=1.0, shift=0.0):
    return torch.from_numpy((rng.standard_normal(shape) * scale + shift)
                            .astype(np.float32)).to(dtype).cuda()


def _sums_close(sums, rows, M):
    """Per-channel sums against the exact (f64) column sums of `rows` [M,
    C], at 1e-7 * sqrt(M) of the largest |sum|: an f32 sum of M values in
    some order (unit roundoff 6e-8, rounding errors growing like
    sqrt(M))."""
    tol = 1e-7 * M ** 0.5
    for s, r in zip(sums, rows):
        e = r.sum(0)
        assert (s.double() - e).abs().max().item() <= tol * e.abs().max().item()


def _conv_close(outs, refs, dtype, K, M):
    """y: f32 1e-5 at the output's scale times sqrt(K) (a sum of K products
    in another order); bf16 one rounding step. s1, s2: the sums of the
    kernel's own stored y, as `_sums_close` holds them."""
    y, s1, s2 = outs
    ry = refs[0]
    assert y.dtype == ry.dtype and s1.dtype == s2.dtype == torch.float32
    if dtype == torch.float32:
        tol = 1e-5 * K ** 0.5
        torch.testing.assert_close(y, ry, rtol=tol, atol=tol * ry.abs().max().item())
    else:
        torch.testing.assert_close(y.float(), ry.float(), rtol=2 ** -7,
                                   atol=2 ** -7 * max(1.0, ry.float().abs().max().item()))
    yd = y.double().reshape(-1, y.shape[-1])
    _sums_close((s1, s2), (yd, yd * yd), M)


# 1x1 shapes: each reaches one producer and tile edge of the bf16 engine
# (csrc/conv_bn.cuh): one 128 x 64 and one 128 x 128 tile (the wgmma
# descriptors on a single slice), M not a multiple of 128, a 72-wide last
# column tile, the gather producer with ragged N, and deep K (8 slices
# through a 3-stage ring).
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("M,K,N", [(4096, 64, 256), (1003, 37, 70), (128, 64, 64), (128, 64, 128),
                                   (221, 64, 64), (300, 64, 200), (392, 512, 2048)],
                         ids=["small", "ragged", "tile64", "tile128", "ragged_m",
                              "ragged_tile", "deep_k"])
def test_conv1x1_stats_matches_plain_version_and_is_deterministic(dtype, M, K, N):
    _require_hopper()
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(20)
    x, w = _t(rng, (M, K), dt), _t(rng, (K, N), dt, scale=K ** -0.5)
    before = fcb.launch_counts()["conv1x1_stats"]
    outs = fcb.conv1x1_stats(x, w)
    again = fcb.conv1x1_stats(x, w)
    torch.cuda.synchronize()
    assert fcb.launch_counts()["conv1x1_stats"] == before + 2
    _conv_close(outs, fcb.conv1x1_stats_reference(x, w), dt, K, M)
    for a, b in zip(outs, again):
        assert torch.equal(a, b)


# k x k shapes (n, H, W, Cin, Cout, k, stride): the gather producer (Cin
# 16 is vector; 19, 3, 5, 37 gather), a 64-deep slice straddling taps (Cin
# 24), the vector producer at stride 2 on odd H and W (the high-side pad),
# the stem 7x7/2 with Cin 3 on odd H and W, ragged N (33, 7, 70).
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,h,wd,cin,cout,k,s", [
    (2, 14, 14, 16, 24, 3, 1), (2, 11, 11, 19, 33, 3, 2), (2, 17, 17, 3, 10, 7, 2),
    (3, 9, 9, 5, 7, 3, 1), (3, 13, 10, 24, 40, 3, 1), (2, 15, 17, 64, 128, 3, 2),
    (2, 33, 29, 3, 64, 7, 2), (3, 9, 9, 37, 70, 3, 1), (2, 14, 14, 64, 64, 3, 1)],
    ids=["3x3", "3x3s2_ragged", "stem_odd", "ragged", "straddle", "3x3s2_odd_vector",
         "stem_small", "gather_ragged_n", "3x3_64"])
def test_conv_kxk_stats_matches_plain_version_and_is_deterministic(dtype, n, h, wd, cin, cout,
                                                                   k, s):
    _require_hopper()
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(21)
    x, w = _t(rng, (n, h, wd, cin), dt), _t(rng, (k, k, cin, cout), dt, scale=(k * k * cin) ** -0.5)
    before = fcb.launch_counts()["conv_kxk_stats"]
    outs = fcb.conv_kxk_stats(x, w, (s, s))
    again = fcb.conv_kxk_stats(x, w, (s, s))
    torch.cuda.synchronize()
    assert fcb.launch_counts()["conv_kxk_stats"] == before + 2
    ho, wo = -(-h // s), -(-wd // s)
    assert tuple(outs[0].shape) == (n, ho, wo, cout)
    _conv_close(outs, fcb.conv_kxk_stats_reference(x, w, (s, s)), dt, k * k * cin, n * ho * wo)
    for a, b in zip(outs, again):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("M,C", [(4096, 64), (1003, 37)], ids=["small", "ragged"])
def test_bn_kernels_match_plain_versions_and_reduce_deterministically(dtype, M, C):
    _require_hopper()
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(22)
    x, g = _t(rng, (M, C), dt, shift=0.3), _t(rng, (M, C), dt)
    v = [_t(rng, (C,), torch.float32, scale=0.5, shift=1.0) for _ in range(3)]
    step = (dict(rtol=1e-5, atol=1e-5) if dt == torch.float32
            else dict(rtol=2 ** -7, atol=2 ** -7))
    before = fcb.launch_counts()
    for relu in (False, True):
        y = fcb.bn_normalize(x, *v, relu)
        torch.testing.assert_close(y.float(), fcb.bn_normalize_reference(x, *v, relu).float(), **step)
    sums = fcb.bn_backward_reduce(g, x)
    again = fcb.bn_backward_reduce(g, x)
    dx = fcb.bn_backward_apply(g, x, *v)
    torch.cuda.synchronize()
    after = fcb.launch_counts()
    assert [after[k] - before[k] for k in ("bn_apply", "bn_backward_reduce",
                                           "bn_backward_apply")] == [2, 2, 1]
    for a, b in zip(sums, again):
        assert torch.equal(a, b)
    gd = g.double()
    _sums_close(sums, (gd, gd * x.double()), M)
    torch.testing.assert_close(dx.float(), fcb.bn_backward_apply_reference(g, x, *v).float(), **step)


@pytest.mark.cuda
def test_conv_bn_functions_run_the_kernels_under_autograd():
    _require_hopper()
    rng = np.random.default_rng(23)
    x = _t(rng, (2, 9, 9, 8), torch.float32).requires_grad_()
    w = _t(rng, (3, 3, 8, 16), torch.float32, scale=0.1).requires_grad_()
    gamma = torch.ones(16, device="cuda", requires_grad=True)
    beta = torch.zeros(16, device="cuda", requires_grad=True)
    before = fcb.launch_counts()
    y, s1, s2 = fcb.conv2d_bn_stats(x, w, (2, 2))
    out, _, _ = fcb.bn_apply(y, s1, s2, gamma, beta, 1e-5, y.numel() // 16, True)
    out.square().sum().backward()
    torch.cuda.synchronize()
    after = fcb.launch_counts()
    assert {k: after[k] - before[k] for k in after} == {
        "conv1x1_stats": 0, "conv_kxk_stats": 1, "bn_apply": 1,
        "bn_backward_reduce": 1, "bn_backward_apply": 1}
    refs = [t.detach().cpu().requires_grad_() for t in (x, w, gamma, beta)]
    yr, r1, r2 = fcb.conv2d_bn_stats(*refs[:2], (2, 2))
    outr, _, _ = fcb.bn_apply(yr, r1, r2, *refs[2:], 1e-5, yr.numel() // 16, True)
    outr.square().sum().backward()
    torch.testing.assert_close(out.cpu(), outr.detach(), rtol=1e-4, atol=1e-4)
    for a, b in zip((x, w, gamma, beta), refs):
        torch.testing.assert_close(a.grad.cpu(), b.grad, rtol=1e-3, atol=1e-3 * b.grad.abs().max().item())


def _bn_step(dt):
    """K6 and K8 against their plain versions: f32 1e-5 (fma against a
    separate multiply and add), bf16 one rounding step."""
    return (dict(rtol=1e-5, atol=1e-5) if dt == torch.float32
            else dict(rtol=2 ** -7, atol=2 ** -7))


def _misaligned(t):
    """A copy of t whose storage starts one element past a 16-byte
    boundary: the streaming kernels' one-channel path."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


# [M, C] of the streaming layout (csrc/bn_stream.cuh): the ragged
# channels (37: one channel a thread), rows per block 32, 8 and 1 (C = 64,
# 256, 2048 in bf16; 2048 f32 spans two column tiles), a bf16 row in
# three column tiles (4104: 513 units), each with ragged M.
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("M,C", [(1003, 37), (4099, 64), (1001, 256), (67, 2048), (35, 4104)])
def test_streaming_bn_kernels_match_plain_versions_at_ragged_shapes(dtype, M, C):
    _require_hopper()
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(24)
    x, g, y = _t(rng, (M, C), dt, shift=0.3), _t(rng, (M, C), dt), _t(rng, (M, C), dt)
    v = [_t(rng, (C,), torch.float32, scale=0.5, shift=1.0) for _ in range(3)]
    mb = _t(rng, (C,), dt, scale=0.2, shift=0.3).float()
    step = _bn_step(dt)
    for xs in (x, _misaligned(x)):
        before = fcb.launch_counts()
        for relu in (False, True):
            torch.testing.assert_close(fcb.bn_normalize(xs, *v, relu).float(),
                                       fcb.bn_normalize_reference(xs, *v, relu).float(), **step)
        for kw in ({}, {"gate_y2": y}, {"mean_b": mb}, {"gate_y2": y, "mean_b": mb}):
            torch.testing.assert_close(fcb.bn_backward_apply(g, xs, *v, **kw).float(),
                                       fcb.bn_backward_apply_reference(g, xs, *v, **kw).float(),
                                       **step)
        torch.cuda.synchronize()
        after = fcb.launch_counts()
        assert [after[k] - before[k] for k in ("bn_apply", "bn_backward_apply")] == [2, 4]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("M,C", [(4096, 64), (1003, 37), (1001, 256)])
def test_pullback_prologue_gives_the_bits_of_the_materialised_inputs(dtype, M, C):
    """K7 and K8 with the ReLU gate and the centring on their loads give
    the same bits as the same kernels fed torch.where(y > 0, g, 0) and x -
    mean_b; K7 stays deterministic; one launch per call."""
    _require_hopper()
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(25)
    x, g, y = _t(rng, (M, C), dt, shift=0.3), _t(rng, (M, C), dt), _t(rng, (M, C), dt)
    y[:3] = 0.0
    v = [_t(rng, (C,), torch.float32, scale=0.5, shift=1.0) for _ in range(3)]
    mb = _t(rng, (C,), dt, scale=0.2, shift=0.3).float()
    g_m = torch.where(y > 0, g, torch.zeros_like(g))
    x_m = x - mb.to(dt)
    before = fcb.launch_counts()
    for kw, gi, xi in (({"gate_y2": y, "mean_b": mb}, g_m, x_m), ({"gate_y2": y}, g_m, x),
                       ({"mean_b": mb}, g, x_m)):
        sums = fcb.bn_backward_reduce(g, x, **kw)
        again = fcb.bn_backward_reduce(g, x, **kw)
        mat = fcb.bn_backward_reduce(gi, xi)
        for a, b, c in zip(sums, again, mat):
            assert torch.equal(a, b) and torch.equal(a, c)
        assert torch.equal(fcb.bn_backward_apply(g, x, *v, **kw),
                           fcb.bn_backward_apply(gi, xi, *v))
    torch.cuda.synchronize()
    after = fcb.launch_counts()
    assert [after[k] - before[k] for k in ("bn_backward_reduce", "bn_backward_apply")] == [9, 6]
    gd = g_m.double()
    _sums_close(fcb.bn_backward_reduce(g, x, gate_y2=y, mean_b=mb), (gd, gd * x_m.double()), M)

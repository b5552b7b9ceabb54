"""The port's conv/BN kernels (deeplearning4j_tpu_torch/ops/fused_conv_bn.py)
and its conv, pool and BN layers against the JAX package.

On the CPU the JAX package's Pallas kernels run in interpret mode (as
tests/test_pallas_conv_bn.py runs them) and the port's wrappers take
their plain PyTorch versions, because the tensors lie on the CPU. Same
numpy inputs into both. Tolerances: f32 1e-5 relative (at the scale of
the compared tensor: the two differ in summation order only); bf16 one
rounding step, 2**-7 relative at that scale (the JAX kernels round every
intermediate to bf16, the port's math is f32 and rounds once). The CUDA
kernels are held against the plain versions by
tests/test_torch_cuda_kernels.py, on a Hopper GPU.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deeplearning4j_tpu.nn.conf import layers as JL
from deeplearning4j_tpu.nn.layers.registry import LayerContext as JCtx
from deeplearning4j_tpu.nn.layers.registry import forward_layer as jforward
from deeplearning4j_tpu.ops import pallas_conv_bn as pcb
from deeplearning4j_tpu_torch.nn.conf import layers as TL
from deeplearning4j_tpu_torch.nn.layers.registry import LayerContext as TCtx
from deeplearning4j_tpu_torch.nn.layers.registry import forward_layer as tforward
from deeplearning4j_tpu_torch.ops import fused_conv_bn as fcb
from deeplearning4j_tpu_torch.ops import helpers

BF16_STEP = 2.0 ** -7
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}

# (kernel, strides, cin, cout, hw): the five families, the stem's Cin = 3,
# and odd sizes where XLA's SAME puts the extra pad on the high side
FAMILIES = [
    ((1, 1), (1, 1), 8, 32, 6),
    ((1, 1), (2, 2), 16, 8, 7),
    ((3, 3), (1, 1), 8, 8, 5),
    ((3, 3), (2, 2), 8, 8, 8),
    ((3, 3), (2, 2), 8, 8, 7),
    ((7, 7), (2, 2), 3, 8, 16),
    ((7, 7), (2, 2), 3, 8, 9),
]


@pytest.fixture(autouse=True)
def _interpret_mode():
    old = pcb._INTERPRET
    pcb._INTERPRET = True
    pcb._STATS_STASH.clear()
    pcb._RELU_STASH.clear()
    fcb._STATS_STASH.clear()
    yield
    pcb._INTERPRET = old


def _np(a):
    return np.asarray(a.float().detach() if torch.is_tensor(a) else
                      jnp.asarray(a, jnp.float32), np.float64)


def _close(port, ref, dtype, rtol=1e-5, terms=1):
    """f32: rtol (1e-5) at the reference's scale; bf16: one rounding step
    at that scale, times sqrt(terms) for a sum of `terms` bf16 values that
    XLA may accumulate in bf16 in an order of its own (the port's sums
    accumulate in f32)."""
    p, r = _np(port), _np(ref)
    bf16 = dtype in ("bfloat16", torch.bfloat16, jnp.bfloat16)
    tol = BF16_STEP * terms ** 0.5 if bf16 else rtol
    scale = max(np.abs(r).max(), 1e-30)
    np.testing.assert_allclose(p, r, rtol=tol, atol=tol * scale)


def _both(a, dtype):
    jd, td = DTYPES[dtype]
    a = np.asarray(a, np.float32)
    return jnp.asarray(a, jd), torch.from_numpy(a).to(td)


# -- kernels ------------------------------------------------------------------


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("kernel,strides,cin,cout,hw", FAMILIES)
def test_conv2d_bn_stats_matches_jax(kernel, strides, cin, cout, hw, dtype):
    rng = np.random.default_rng(0)
    jx, tx = _both(rng.standard_normal((2, hw, hw, cin)), dtype)
    jw, tw = _both(rng.standard_normal((*kernel, cin, cout)) * 0.2, dtype)
    jy, js1, js2 = pcb.conv2d_bn_stats(jx, jw, strides)
    ty, ts1, ts2 = fcb.conv2d_bn_stats(tx, tw, strides)
    assert tuple(ty.shape) == tuple(jy.shape) and ty.dtype == tx.dtype
    assert ts1.dtype == ts2.dtype == torch.float32
    for p, r in ((ty, jy), (ts1, js1), (ts2, js2)):
        _close(p, r, dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("relu", [False, True])
def test_bn_apply_matches_jax(relu, dtype):
    rng = np.random.default_rng(1)
    c = 8
    jx, tx = _both(rng.standard_normal((4, 5, 5, c)) * 1.3 + 0.4, dtype)
    n = 4 * 5 * 5
    x2 = _np(tx).reshape(n, c)
    s1, s2 = x2.sum(0).astype(np.float32), (x2 * x2).sum(0).astype(np.float32)
    gamma = (rng.standard_normal(c) * 0.2 + 1.0).astype(np.float32)
    beta = (rng.standard_normal(c) * 0.1).astype(np.float32)
    jout = pcb.bn_apply(jx, *(jnp.asarray(a) for a in (s1, s2, gamma, beta)),
                        1e-5, n, relu)
    tout = fcb.bn_apply(tx, *(torch.from_numpy(a) for a in (s1, s2, gamma, beta)),
                        1e-5, n, relu)
    _close(tout[0], jout[0], dtype)
    for p, r in zip(tout[1:], jout[1:]):  # mean, var: f32 in both dtypes
        _close(p, r, "float32")


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_bn_backward_fused_matches_jax(dtype):
    rng = np.random.default_rng(2)
    c, n = 16, 3 * 4 * 4
    jg, tg = _both(rng.standard_normal((3, 4, 4, c)), dtype)
    jx, tx = _both(rng.standard_normal((3, 4, 4, c)) * 0.5, dtype)
    center = (rng.standard_normal(c) * 0.01).astype(np.float32)
    gamma = (rng.standard_normal(c) * 0.2 + 1.0).astype(np.float32)
    inv = (rng.random(c) + 0.5).astype(np.float32)
    jout = pcb.bn_backward_fused(jg, jx, *(jnp.asarray(a) for a in (center, gamma, inv)), n)
    tout = fcb.bn_backward_fused(tg, tx, *(torch.from_numpy(a) for a in (center, gamma, inv)), n)
    assert tout[0].dtype == tg.dtype
    _close(tout[0], jout[0], dtype)
    for p, r in zip(tout[1:], jout[1:]):  # dgamma, dbeta: f32 sums
        _close(p, r, "float32" if dtype == "float32" else dtype)


def _pullback_inputs(seed, c, dtype):
    """g, x, the saved BN output y (about half <= 0), mean_b (the mean
    rounded to dtype, as f32), center, gamma, inv: numpy, n = 48 rows."""
    rng = np.random.default_rng(seed)
    shape = (3, 4, 4, c)
    g, x, y = (rng.standard_normal(shape) for _ in range(3))
    x = x * 0.5 + 0.3
    y[0, 0, 0, :2] = 0.0  # y == 0 is gated too
    mean = (rng.standard_normal(c) * 0.2 + 0.3).astype(np.float32)
    mean_b = _np(torch.from_numpy(mean).to(DTYPES[dtype][1])).astype(np.float32)
    center = (rng.standard_normal(c) * 0.01).astype(np.float32)
    gamma = (rng.standard_normal(c) * 0.2 + 1.0).astype(np.float32)
    inv = (rng.random(c) + 0.5).astype(np.float32)
    return g, x, y, mean_b, center, gamma, inv


@pytest.mark.parametrize("c", [8, 37, 64])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_bn_pullback_with_gate_and_centring_matches_jax(dtype, c):
    """K7 and K8's plain versions and `bn_backward_fused` with the ReLU
    gate (gate_y) and the centring (mean_b) on their loads, against the
    JAX package's kernels fed the gate and the centring composed in JAX."""
    g, x, y, mean_b, center, gamma, inv = _pullback_inputs(5, c, dtype)
    n = 48
    (jg, tg), (jx, tx), (jy, ty) = (_both(a, dtype) for a in (g, x, y))
    jd = DTYPES[dtype][0]
    jg_gated = jnp.where(jy > 0, jg, jnp.zeros_like(jg))
    jxc = jx - jnp.broadcast_to(jnp.asarray(mean_b).astype(jd), jx.shape)
    vec = [jnp.asarray(a) for a in (center, gamma, inv)]
    jout = pcb.bn_backward_fused(jg_gated, jxc, *vec, n)
    tout = fcb.bn_backward_fused(tg, tx, *(torch.from_numpy(a) for a in (center, gamma, inv)),
                                 n, mean_b=torch.from_numpy(mean_b), gate_y=ty)
    assert tout[0].dtype == tg.dtype
    _close(tout[0], jout[0], dtype)
    for p, r in zip(tout[1:], jout[1:]):  # dgamma, dbeta: f32 sums
        _close(p, r, "float32" if dtype == "float32" else dtype)
    # the two kernels' plain versions on their own
    jg2, jx2 = jg_gated.reshape(n, c), jxc.reshape(n, c)
    pro = dict(mean_b=torch.from_numpy(mean_b), gate_y2=ty.reshape(n, c))
    tg2, tx2 = tg.reshape(n, c), tx.reshape(n, c)
    for p, r in zip(fcb.bn_backward_reduce_reference(tg2, tx2, **pro),
                    pcb._bnb_reduce_call(jg2, jx2)):
        _close(p, r[0], "float32" if dtype == "float32" else dtype)
    coef = [(np.random.default_rng(6).standard_normal(c) * 0.5 + 1.0).astype(np.float32)
            for _ in range(3)]
    _close(fcb.bn_backward_apply_reference(tg2, tx2, *(torch.from_numpy(a) for a in coef),
                                           **pro),
           pcb._bnb_apply_call(jg2, jx2, *(jnp.asarray(a)[None, :] for a in coef)), dtype)


@pytest.mark.parametrize("c", [8, 37])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float64"])
def test_bn_pullback_prologue_equals_the_materialised_tensors(dtype, c):
    """With `gate_y`/`mean_b` given, the port's plain path gives the same
    tensors, bit for bit, as with them left None and the gated g
    (torch.where(y > 0, g, 0)) and the centred x (x - mean_b in x's dtype)
    materialised: K7, K8 (wrapper and plain version) and
    `bn_backward_fused`."""
    td = getattr(torch, dtype)
    g, x, y, mean_b, center, gamma, inv = _pullback_inputs(7, c, "bfloat16")
    tg, tx, ty = (torch.from_numpy(a).to(td) for a in (g, x, y))
    acc = torch.promote_types(td, torch.float32)
    mb = torch.from_numpy(mean_b).to(acc)
    g_gated = torch.where(ty > 0, tg, torch.zeros_like(tg))
    x_centred = tx - mb.to(td)
    n = 48
    g2, x2, y2 = (t.reshape(n, c) for t in (tg, tx, ty))
    gm2, xm2 = g_gated.reshape(n, c), x_centred.reshape(n, c)
    coef = [torch.from_numpy(np.random.default_rng(8).standard_normal(c) + 1.0).to(acc)
            for _ in range(3)]
    for fn in (fcb.bn_backward_reduce, fcb.bn_backward_reduce_reference):
        for p, r in zip(fn(g2, x2, mean_b=mb, gate_y2=y2), fn(gm2, xm2)):
            assert torch.equal(p, r)
    for fn in (fcb.bn_backward_apply, fcb.bn_backward_apply_reference):
        assert torch.equal(fn(g2, x2, *coef, mean_b=mb, gate_y2=y2), fn(gm2, xm2, *coef))
    # each keyword alone
    assert torch.equal(fcb.bn_backward_apply(g2, x2, *coef, gate_y2=y2),
                       fcb.bn_backward_apply(gm2, x2, *coef))
    assert torch.equal(fcb.bn_backward_apply(g2, x2, *coef, mean_b=mb),
                       fcb.bn_backward_apply(g2, xm2, *coef))
    vec = [torch.from_numpy(a).to(acc) for a in (center, gamma, inv)]
    for p, r in zip(fcb.bn_backward_fused(tg, tx, *vec, n, mean_b=mb, gate_y=ty),
                    fcb.bn_backward_fused(g_gated, x_centred, *vec, n)):
        assert torch.equal(p, r)


def test_bn_pullback_helper_gets_raw_x_mean_b_and_the_gate(fused_cpu_path, monkeypatch):
    """On the helper path `BNApply`'s backward hands the kernels raw x,
    mean_b and the saved output y, and materialises neither the gated g
    nor the centred x; its gradients equal the builtin path's, which
    forms both in plain torch."""
    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.standard_normal((2, 5, 5, 8)).astype(np.float32) + 0.2)
    x = x.to(torch.bfloat16).requires_grad_()
    x2 = x.detach().reshape(50, 8).float()
    s1, s2 = x2.sum(0), (x2 * x2).sum(0)
    gamma, beta = torch.ones(8, requires_grad=True), torch.zeros(8, requires_grad=True)
    r = torch.from_numpy(rng.standard_normal((2, 5, 5, 8)).astype(np.float32)).to(torch.bfloat16)
    seen = []
    h = helpers._HELPERS["bn_backward"]
    fused = h.fn

    def spy(g, x_in, *a, **kw):
        seen.append((x_in, kw))
        return fused(g, x_in, *a, **kw)

    monkeypatch.setattr(h, "fn", spy)

    def grads():
        y, _, _ = fcb.bn_apply(x, s1, s2, gamma, beta, 1e-5, 50, True)
        return torch.autograd.grad((y * r).sum(), (x, gamma, beta)), y

    (got, y) = grads()
    (x_in, kw), = seen
    assert torch.equal(x_in, x.detach())  # raw x, not x - mean_b
    assert kw["gate_y"] is not None and torch.equal(kw["gate_y"], y.detach())
    assert kw["mean_b"].dtype == torch.bfloat16
    helpers.set_helper_enabled("bn_backward", False)
    try:
        ref, _ = grads()
    finally:
        helpers.set_helper_enabled("bn_backward", True)
    assert len(seen) == 1
    for p, q in zip(got, ref):
        _close(p, q, "bfloat16")


def _conv_bn_loss_jax(x, w, gamma, beta, r, strides, relu):
    y, s1, s2 = pcb.conv2d_bn_stats(x, w, strides)
    n = y.size // y.shape[-1]
    out, _, _ = pcb.bn_apply(y, jax.lax.stop_gradient(s1), jax.lax.stop_gradient(s2),
                             gamma, beta, 1e-5, n, relu)
    return jnp.sum(out * r)


def _conv_bn_out_torch(x, w, gamma, beta, strides, relu):
    y, s1, s2 = fcb.conv2d_bn_stats(x, w, strides)
    n = y.numel() // y.shape[-1]
    return fcb.bn_apply(y, s1, s2, gamma, beta, 1e-5, n, relu)[0]


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("kernel,strides,cin,cout,hw",
                         [FAMILIES[1], FAMILIES[4], FAMILIES[6]])
def test_conv_bn_gradients_match_jax_custom_vjp(kernel, strides, cin, cout, hw, relu):
    rng = np.random.default_rng(3)
    arrs = [rng.standard_normal((2, hw, hw, cin)),
            rng.standard_normal((*kernel, cin, cout)) * 0.3,
            rng.standard_normal(cout) * 0.2 + 1.0, rng.standard_normal(cout) * 0.1]
    arrs = [np.asarray(a, np.float32) for a in arrs]
    ho = -(-hw // strides[0])
    r = rng.standard_normal((2, ho, ho, cout)).astype(np.float32)
    jg = jax.grad(_conv_bn_loss_jax, argnums=(0, 1, 2, 3))(
        *(jnp.asarray(a) for a in arrs), jnp.asarray(r), strides, relu)
    ts = [torch.from_numpy(a).requires_grad_() for a in arrs]
    out = _conv_bn_out_torch(*ts, strides, relu)
    tg = torch.autograd.grad((out * torch.from_numpy(r)).sum(), ts)
    for p, q, name in zip(tg, jg, ("dx", "dw", "dgamma", "dbeta")):
        assert p.shape == q.shape, name
        _close(p, q, "float32")


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("kernel,strides", [((1, 1), (2, 2)), ((3, 3), (2, 2)),
                                            ((7, 7), (2, 2))])
def test_conv_bn_f64_gradcheck_through_the_plain_path(kernel, strides, relu):
    g = torch.Generator().manual_seed(4)
    x = torch.randn(2, 5, 5, 3, generator=g, dtype=torch.float64, requires_grad=True)
    w = (torch.randn(*kernel, 3, 4, generator=g, dtype=torch.float64) * 0.3).requires_grad_()
    gamma = (torch.rand(4, generator=g, dtype=torch.float64) + 0.5).requires_grad_()
    beta = torch.randn(4, generator=g, dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradcheck(
        lambda *a: _conv_bn_out_torch(*a, strides, relu), (x, w, gamma, beta))


def test_cpu_wrappers_take_the_plain_versions_without_launching():
    fcb.reset_launch_counts()
    x = torch.randn(2, 6, 6, 4)
    y, s1, s2 = fcb.conv2d_bn_stats(x, torch.randn(3, 3, 4, 8), (1, 1))
    fcb.bn_apply(y, s1, s2, torch.ones(8), torch.zeros(8), 1e-5, 72, True)
    fcb.bn_backward_fused(y, y, torch.zeros(8), torch.ones(8), torch.ones(8), 72)
    assert set(fcb.launch_counts().values()) == {0}


@pytest.mark.parametrize("call", ["k4", "k5", "k6", "k7", "k8"])
def test_wrappers_raise_on_bad_dtype_shape_and_layout(call):
    f16 = torch.float16
    x2, w2 = torch.randn(10, 4), torch.randn(4, 6)
    c = torch.zeros(4)
    bad = {
        "k4": [lambda: fcb.conv1x1_stats(x2.to(f16), w2.to(f16)),
               lambda: fcb.conv1x1_stats(x2, torch.randn(5, 6)),
               lambda: fcb.conv1x1_stats(x2.t(), w2)],
        "k5": [lambda: fcb.conv_kxk_stats(torch.randn(1, 5, 5, 4), torch.randn(3, 3, 2, 4), (1, 1)),
               lambda: fcb.conv_kxk_stats(torch.randn(1, 5, 5, 4), torch.randn(3, 3, 4, 4).double(), (1, 1))],
        "k6": [lambda: fcb.bn_normalize(x2, c[:3], c, c, False),
               lambda: fcb.bn_normalize(x2, c.double(), c, c, False)],
        "k7": [lambda: fcb.bn_backward_reduce(x2, torch.randn(9, 4)),
               lambda: fcb.bn_backward_reduce(x2.to(f16), x2.to(f16))],
        "k8": [lambda: fcb.bn_backward_apply(x2, x2[:, :3], c, c, c),
               lambda: fcb.bn_backward_apply(x2, x2, c, c, torch.zeros(5))],
    }[call]
    for fn in bad:
        with pytest.raises((TypeError, ValueError)):
            fn()


@pytest.mark.parametrize("kernel", ["k7", "k8"])
def test_pullback_prologue_arguments_are_checked(kernel):
    g2, x2, c = torch.randn(10, 4), torch.randn(10, 4), torch.zeros(4)
    fn = (fcb.bn_backward_reduce if kernel == "k7"
          else lambda *a, **k: fcb.bn_backward_apply(*a, c, c, c, **k))
    for kw in ({"gate_y2": torch.randn(10, 3)}, {"gate_y2": torch.randn(10, 4).double()},
               {"gate_y2": torch.randn(4, 10).t()}, {"mean_b": torch.zeros(5)},
               {"mean_b": torch.zeros(4, dtype=torch.bfloat16)}):
        with pytest.raises((TypeError, ValueError)):
            fn(g2, x2, **kw)
    fn(g2, x2, gate_y2=torch.randn(10, 4), mean_b=torch.zeros(4))  # the shapes it takes


def test_probes_need_a_hopper_gpu_and_the_structural_scope(monkeypatch):
    ctx = dict(kernel=(3, 3), stride=(2, 2), dilation=(1, 1), same=True,
               has_bias=False, activation="identity", dtype=torch.bfloat16,
               training=True, n_in=3, n_out=64, x_shape=(2, 9, 9, 3))
    assert fcb.conv_decision(**ctx)["status"] == "covered"
    assert not fcb.conv_supported(**ctx, device=torch.device("cpu"))
    monkeypatch.setattr(torch.cuda, "get_device_capability", lambda device=None: (9, 0))
    assert fcb.conv_supported(**ctx, device=torch.device("cuda"))
    for k, v, reason in (("training", False, "inference"), ("has_bias", True, "bias"),
                         ("same", False, "padding"), ("activation", "relu", "fused_activation"),
                         ("dilation", (2, 2), "dilation"), ("kernel", (5, 5), "kernel_shape"),
                         ("dtype", torch.float64, "dtype")):
        d = fcb.conv_decision(**dict(ctx, **{k: v}))
        assert (d["status"], d["reason"]) == ("unsupported", reason)
    assert fcb.bn_bwd_supported(x_shape=(4, 8), dtype=torch.float32, training=True,
                                device=torch.device("cuda"))
    assert not fcb.bn_bwd_supported(x_shape=(4, 8), dtype=torch.float32, training=True,
                                    device=torch.device("cpu"))
    monkeypatch.setattr(torch.cuda, "get_device_capability", lambda device=None: (8, 0))
    assert not fcb.conv_supported(**ctx, device=torch.device("cuda"))


def test_stash_matches_by_identity_and_ages_out():
    a, b = torch.zeros(2), torch.zeros(2)
    fcb._stash_stats(a, 1, 2)
    assert not fcb.peek_stats(b) and fcb.peek_stats(a)
    assert fcb.take_stats(a) == (1, 2) and fcb.take_stats(a) is None
    for _ in range(9):
        fcb._stash_stats(torch.zeros(1), 0, 0)
    assert len(fcb._STATS_STASH) == 8


# -- layers -------------------------------------------------------------------


def _layer_pair(jconf, tconf, jparams, x, dtype, state=None, training=True, fuse=False):
    """Forward and grads of sum(y * r) through one layer in both packages,
    from the same numpy params and input. Returns ((jy, jstate, jgrads),
    (ty, tstate, tgrads)); grads are over (x, *params in sorted order)."""
    jd, td = DTYPES[dtype]
    names = sorted(jparams)
    jst = None if state is None else {k: jnp.asarray(v) for k, v in state.items()}
    tst = None if state is None else {k: torch.from_numpy(v) for k, v in state.items()}
    jy, jnew = jforward(jconf, {k: jnp.asarray(v) for k, v in jparams.items()},
                        jnp.asarray(x, jd), JCtx(training=training, state=jst))
    r = np.random.default_rng(9).standard_normal(jy.shape).astype(np.float32)

    def jloss(xx, *ps):
        y, _ = jforward(jconf, dict(zip(names, ps)), xx, JCtx(training=training, state=jst))
        return jnp.sum(y.astype(jnp.float32) * r)

    jg = jax.grad(jloss, argnums=tuple(range(1 + len(names))))(
        jnp.asarray(x, jd), *(jnp.asarray(jparams[k]) for k in names))
    tx = torch.from_numpy(np.asarray(x, np.float32)).to(td).requires_grad_()
    tps = [torch.from_numpy(np.asarray(jparams[k])).requires_grad_() for k in names]
    ty, tnew = tforward(tconf, dict(zip(names, tps)), tx,
                        TCtx(training=training, state=tst, fuse_relu=fuse))
    tg = torch.autograd.grad((ty.float() * torch.from_numpy(r)).sum(), [tx, *tps])
    return (jy, jnew, jg), (ty, tnew, tg)


def _assert_pair(j, t, dtype):
    """Outputs and dx to one bf16 step; parameter gradients, sums over the
    N*H*W positions of the output, to sqrt(N*H*W) steps."""
    (jy, jnew, jg), (ty, tnew, tg) = j, t
    assert ty.dtype == DTYPES[dtype][1]
    _close(ty, jy, dtype)
    terms = ty.numel() // ty.shape[-1]
    for i, (p, q) in enumerate(zip(tg, jg)):
        assert tuple(p.shape) == tuple(q.shape)
        _close(p, q, dtype, terms=1 if i == 0 else terms)
    if jnew is not None:
        for k in jnew:
            _close(tnew[k], jnew[k], "float32" if dtype == "float32" else dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("kernel,stride,mode", [((3, 3), (2, 2), "same"),
                                                ((7, 7), (2, 2), "same"),
                                                ((3, 3), (1, 1), "truncate")])
def test_builtin_conv_layer_matches_jax(kernel, stride, mode, dtype):
    rng = np.random.default_rng(5)
    kw = dict(kernel_size=kernel, stride=stride, n_in=3, n_out=5, has_bias=True,
              activation="identity", convolution_mode=mode, padding=(1, 1))
    jc, tc = JL.ConvolutionLayer(**kw), TL.ConvolutionLayer(**kw)
    params = {"W": (rng.standard_normal((*kernel, 3, 5)) * 0.2).astype(np.float32),
              "b": (rng.standard_normal(5) * 0.1).astype(np.float32)}
    x = rng.standard_normal((2, 9, 9, 3))
    _assert_pair(*_layer_pair(jc, tc, params, x, dtype), dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("ptype", ["max", "avg", "sum", "pnorm"])
def test_pool_layers_match_jax(ptype, dtype):
    rng = np.random.default_rng(6)
    kw = dict(pooling_type=ptype, kernel_size=(3, 3), stride=(2, 2),
              convolution_mode="same", pnorm=2)
    x = rng.standard_normal((2, 7, 7, 4))
    _assert_pair(*_layer_pair(JL.SubsamplingLayer(**kw), TL.SubsamplingLayer(**kw),
                              {}, x, dtype), dtype)
    gkw = dict(pooling_type=ptype, pnorm=2)
    _assert_pair(*_layer_pair(JL.GlobalPoolingLayer(**gkw), TL.GlobalPoolingLayer(**gkw),
                              {}, x, dtype), dtype)


def test_stem_maxpool_pads_the_high_side_with_minus_inf():
    conf = TL.SubsamplingLayer(pooling_type="max", kernel_size=(3, 3), stride=(2, 2),
                               convolution_mode="same")
    x = -torch.ones(1, 4, 4, 1)
    x[0, 0, 0, 0] = -5.0
    y, _ = tforward(conf, {}, x, TCtx())
    # windows start at rows/cols 0 and 2 (pad 0 low, 1 high): a zero pad
    # would give 0, a symmetric pad would shift the windows
    assert y.shape == (1, 2, 2, 1) and bool((y == -1).all())


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("training,lock", [(True, False), (True, True), (False, False)])
def test_builtin_batchnorm_layer_matches_jax(training, lock, dtype):
    rng = np.random.default_rng(7)
    kw = dict(n_in=6, lock_gamma_beta=lock, decay=0.9, eps=1e-5)
    params = {} if lock else {
        "gamma": (rng.standard_normal(6) * 0.2 + 1).astype(np.float32),
        "beta": (rng.standard_normal(6) * 0.1).astype(np.float32)}
    state = {"mean": (rng.standard_normal(6) * 0.1).astype(np.float32),
             "var": (rng.random(6) + 0.5).astype(np.float32)}
    x = rng.standard_normal((3, 4, 4, 6)) * 1.5 + 0.7
    _assert_pair(*_layer_pair(JL.BatchNormalization(**kw), TL.BatchNormalization(**kw),
                              params, x, dtype, state=state, training=training), dtype)


@pytest.fixture
def fused_cpu_path(monkeypatch):
    """Route the CPU through the fused path: the three probes patched to
    their structural scope, as a Hopper GPU would route, so the wrappers
    run their plain versions."""
    monkeypatch.setattr(helpers._HELPERS["conv2d"], "supported",
                        lambda **c: fcb.conv_decision(**c)["status"] == "covered")
    monkeypatch.setattr(helpers._HELPERS["batch_norm"], "supported",
                        lambda **c: c["training"] and fcb.peek_stats(c["x"]))
    monkeypatch.setattr(helpers._HELPERS["bn_backward"], "supported",
                        lambda **c: c["training"])


@pytest.mark.parametrize("relu", [False, True])
def test_fused_conv_bn_layers_match_the_builtin_layers(fused_cpu_path, relu):
    """conv -> BN (-> relu) through the helpers equals the builtin conv, BN
    and relu layers, forward and grads. With `fuse_relu` (the graph's mark)
    the BN returns its output rectified, on the kernel path as on the
    builtin one, and no relu layer runs after it."""
    from deeplearning4j_tpu_torch.nn.layers.core import activation_forward

    rng = np.random.default_rng(8)
    conv = TL.ConvolutionLayer(kernel_size=(3, 3), stride=(2, 2), n_in=3, n_out=6,
                               has_bias=False, activation="identity",
                               convolution_mode="same")
    bn = TL.BatchNormalization(n_in=6)
    act = TL.ActivationLayer(activation="relu")
    w = torch.from_numpy((rng.standard_normal((3, 3, 3, 6)) * 0.3).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((2, 7, 7, 3)).astype(np.float32))
    gb = [torch.ones(6), torch.zeros(6)]
    st = {"mean": torch.zeros(6), "var": torch.ones(6)}
    r = torch.from_numpy(rng.standard_normal((2, 4, 4, 6)).astype(np.float32))
    ops = ("conv2d", "batch_norm", "bn_backward")

    def run(fused, kernels):
        for op in ops:
            helpers.set_helper_enabled(op, kernels)
        try:
            ps = [t.clone().requires_grad_() for t in (w, *gb)]
            ctx = TCtx(training=True, state=st, fuse_relu=fused and relu)
            y, _ = tforward(conv, {"W": ps[0]}, x, ctx)
            assert fcb.peek_stats(y) == kernels
            z, new = tforward(bn, {"gamma": ps[1], "beta": ps[2]}, y, ctx)
            out = activation_forward(act, {}, z, ctx)[0] if relu and not fused else z
            return out, new, torch.autograd.grad((out * r).sum(), ps)
        finally:
            for op in ops:
                helpers.set_helper_enabled(op, True)

    ref = run(False, kernels=False)
    for got in (run(True, kernels=True), run(True, kernels=False)):
        assert not fcb._STATS_STASH
        if relu:
            assert bool((got[0] >= 0).all())
        _close(got[0], ref[0], "float32")
        for k in ("mean", "var"):
            _close(got[1][k], ref[1][k], "float32")
        for p, q in zip(got[2], ref[2]):
            _close(p, q, "float32", rtol=1e-4)

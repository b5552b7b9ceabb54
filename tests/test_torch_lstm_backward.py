"""The port's LSTM backward (deeplearning4j_tpu_torch/ops/fused_lstm.py:
`lstm_sequence_backward_reference`, `lstm_sequence_backward`,
`LSTMSequence`) against the JAX package's Pallas backward
(ops/pallas_lstm.py `_bwd_call`, `jax.grad` of `lstm_sequence`).

On the CPU the Pallas kernels run in interpret mode (as
tests/test_pallas_lstm.py runs them) and the port's wrappers take their
plain PyTorch versions, because the tensors lie on the CPU. Same numpy
inputs into both; f32, rtol 1e-5 / atol 1e-6: the two compute the same
expressions and differ only in summation order. The gradient check runs
in f64 at torch.autograd.gradcheck's own tolerances. The CUDA kernel
itself is held against the plain version by tests/test_torch_cuda_kernels.py,
on a Hopper GPU.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deeplearning4j_tpu.ops import pallas_lstm
from deeplearning4j_tpu_torch.ops import fused_lstm as fl

RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(autouse=True)
def _interpret_mode():
    old = pallas_lstm._INTERPRET
    pallas_lstm._INTERPRET = True
    yield
    pallas_lstm._INTERPRET = old


def _inputs(seed, T, B, H, peephole):
    rng = np.random.default_rng(seed)
    xg = rng.standard_normal((T, B, 4 * H))
    rw = rng.standard_normal((H, 4 * H)) * 0.2
    ps = [rng.standard_normal(H) * 0.3 if peephole else np.zeros(H)
          for _ in range(3)]
    h0 = rng.standard_normal((B, H)) * 0.1
    c0 = rng.standard_normal((B, H)) * 0.1
    return [np.asarray(a, np.float32) for a in (xg, rw, *ps, h0, c0)]


def _cotangents(seed, T, B, H):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((T, B, H), (B, H), (B, H))]


def _close(port, ref):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref),
                               rtol=RTOL, atol=ATOL)


def _torch(arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


@pytest.mark.parametrize("peephole", [False, True])
def test_backward_reference_matches_pallas_bwd_call(peephole):
    T, B, H = 6, 4, 16
    a = _inputs(0, T, B, H, peephole)
    _, acts, hprev, cprev = pallas_lstm._fwd_call(*(jnp.asarray(x) for x in a))
    dy, _, dcF = _cotangents(1, T, B, H)
    bwd_in = [acts, hprev, cprev, a[1], a[2], a[3], a[4], dy, dcF]
    ref = pallas_lstm._bwd_call(*(jnp.asarray(x) for x in bwd_in))
    port = fl.lstm_sequence_backward_reference(*_torch(bwd_in))
    for p, r in zip(port, ref):
        _close(p, r)
    assert [t.dtype for t in port] == [torch.float32] * 7


@pytest.mark.parametrize("peephole", [False, True])
def test_lstm_sequence_function_grads_match_jax_grad(peephole):
    """Cotangents on y, hF and cF through `LSTMSequence` (plain forward
    and plain backward on the CPU) against the VJP of the Pallas
    custom_vjp, for all seven inputs."""
    T, B, H = 5, 3, 8
    a = _inputs(2, T, B, H, peephole)
    gy, ghF, gcF = _cotangents(3, T, B, H)
    out, vjp = jax.vjp(pallas_lstm.lstm_sequence, *(jnp.asarray(x) for x in a))
    ref = vjp((jnp.asarray(gy), jnp.asarray(ghF), jnp.asarray(gcF)))

    leaves = [t.requires_grad_() for t in _torch(a)]
    y, cF = fl.LSTMSequence.apply(*leaves)
    hF = y[-1]
    for p, r in zip((y, hF, cF), out):
        _close(p, r)
    loss = ((y * torch.from_numpy(gy)).sum() + (hF * torch.from_numpy(ghF)).sum()
            + (cF * torch.from_numpy(gcF)).sum())
    loss.backward()
    for leaf, r in zip(leaves, ref):
        _close(leaf.grad, r)


class _PlainLSTM(torch.autograd.Function):
    """The two plain versions as one Function, for gradcheck in f64 (the
    checked wrappers take only f32 and bf16)."""

    @staticmethod
    def forward(ctx, xg, rw, pI, pF, pO, h0, c0):
        y, acts, hprev, cprev, cF = fl.lstm_sequence_forward_reference(
            xg, rw, pI, pF, pO, h0, c0)
        ctx.save_for_backward(acts, hprev, cprev, rw, pI, pF, pO)
        return y, cF

    @staticmethod
    def backward(ctx, dy, dcF):
        dxg, drw, dpi, dpf, dpo, dh0, dc0 = fl.lstm_sequence_backward_reference(
            *ctx.saved_tensors, dy.contiguous(), dcF.contiguous())
        return dxg, drw, dpi, dpf, dpo, dh0, dc0


def test_plain_forward_backward_pair_passes_gradcheck_in_f64():
    a = [t.double().requires_grad_() for t in _torch(_inputs(4, 4, 2, 3, True))]
    assert torch.autograd.gradcheck(_PlainLSTM.apply, a)


def test_plain_backward_keeps_the_kernel_dtypes_for_bf16():
    T, B, H = 3, 2, 4
    a = _torch(_inputs(5, T, B, H, True))
    _, acts, hprev, cprev, _ = fl.lstm_sequence_forward_reference(
        *(t.bfloat16() for t in a))
    dy, _, dcF = _torch(_cotangents(6, T, B, H))
    out = fl.lstm_sequence_backward(acts, hprev, cprev, a[1].bfloat16(),
                                    *(t.bfloat16() for t in a[2:5]),
                                    dy.bfloat16(), dcF.bfloat16())
    assert [t.dtype for t in out] == ([torch.bfloat16] + [torch.float32] * 4
                                      + [torch.bfloat16] * 2)


def test_cpu_backward_wrapper_takes_the_plain_version_without_launching():
    T, B, H = 4, 3, 8
    a = _torch(_inputs(7, T, B, H, True))
    _, acts, hprev, cprev, _ = fl.lstm_sequence_forward_reference(*a)
    dy, _, dcF = _torch(_cotangents(8, T, B, H))
    args = (acts, hprev, cprev, *a[1:5], dy, dcF)
    before = fl.launch_counts()
    out = fl.lstm_sequence_backward(*args)
    ref = fl.lstm_sequence_backward_reference(*args)
    assert all(torch.equal(o, r) for o, r in zip(out, ref))
    leaves = [t.requires_grad_() for t in a]
    y, hF, cF = fl.lstm_sequence(*leaves)
    (y.sum() + cF.sum()).backward()
    assert fl.launch_counts() == before


def test_backward_wrapper_raises_on_bad_dtype_shape_and_layout():
    T, B, H = 3, 2, 8
    a = _torch(_inputs(9, T, B, H, True))
    _, acts, hprev, cprev, _ = fl.lstm_sequence_forward_reference(*a)
    dy, _, dcF = _torch(_cotangents(10, T, B, H))
    args = [acts, hprev, cprev, *a[1:5], dy, dcF]
    with pytest.raises(TypeError):
        fl.lstm_sequence_backward(*(x.double() for x in args))
    bad = list(args)
    bad[7] = dy[:, :, :-1].contiguous()     # dy narrower than hprev
    with pytest.raises(ValueError):
        fl.lstm_sequence_backward(*bad)
    bad = list(args)
    bad[0] = acts.transpose(0, 1)            # not contiguous
    with pytest.raises(ValueError):
        fl.lstm_sequence_backward(*bad)


def test_helper_entry_goes_through_the_function_only_under_grad():
    a = _torch(_inputs(11, 3, 2, 4, True))
    y, _, _ = fl.lstm_sequence(*a)
    assert y.grad_fn is None
    a[1].requires_grad_()
    y, hF, cF = fl.lstm_sequence(*a)
    assert type(y.grad_fn).__name__ == "LSTMSequenceBackward"
    assert hF._base is y  # hF is y[-1], taken outside the Function
    with torch.no_grad():
        assert fl.lstm_sequence(*a)[0].grad_fn is None


@pytest.mark.parametrize("capability,expected", [((9, 0), True), ((8, 0), False)])
def test_sequence_probe_accepts_grad_only_on_hopper(monkeypatch, capability,
                                                    expected):
    # the probe takes training and inference calls alike: a grad flag in
    # the context changes nothing
    probe = dict(peephole=True, mask=None, gate_act="sigmoid",
                 cell_act="tanh", reverse=False, grad=True)
    assert not fl.supported(**probe, device=torch.device("cpu"))
    monkeypatch.setattr(torch.cuda, "get_device_capability",
                        lambda device=None: capability)
    assert fl.supported(**probe, device=torch.device("cuda")) is expected
    # masks and the reverse direction stay with the builtin loop
    assert not fl.supported(**dict(probe, reverse=True),
                            device=torch.device("cuda"))

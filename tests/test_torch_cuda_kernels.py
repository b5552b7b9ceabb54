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

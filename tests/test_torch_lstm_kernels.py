"""The port's fused LSTM kernels (deeplearning4j_tpu_torch/ops/fused_lstm.py)
against the JAX package's Pallas kernels (ops/pallas_lstm.py).

On the CPU the Pallas kernels run in interpret mode (as
tests/test_pallas_lstm.py runs them) and the port's wrappers take their
plain PyTorch versions, because the tensors lie on the CPU. Same numpy
inputs into both; f32, rtol 1e-5 / atol 1e-6 (the two differ only in
summation order). The CUDA kernels themselves are held against the
plain versions by tests/test_torch_cuda_kernels.py, on a Hopper GPU.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deeplearning4j_tpu.ops import pallas_lstm
from deeplearning4j_tpu_torch.ops import fused_lstm as fl
from deeplearning4j_tpu_torch.ops import helpers

RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(autouse=True)
def _interpret_mode():
    old = pallas_lstm._INTERPRET
    pallas_lstm._INTERPRET = True
    yield
    pallas_lstm._INTERPRET = old


def _inputs(seed, T, B, H, peephole):
    rng = np.random.default_rng(seed)
    xg = rng.standard_normal((B, 4 * H) if T is None else (T, B, 4 * H))
    rw = rng.standard_normal((H, 4 * H)) * 0.2
    if peephole:
        ps = [rng.standard_normal(H) * 0.3 for _ in range(3)]
    else:
        ps = [np.zeros(H) for _ in range(3)]
    h0 = rng.standard_normal((B, H)) * 0.1
    c0 = rng.standard_normal((B, H)) * 0.1
    return [np.asarray(a, np.float32) for a in (xg, rw, *ps, h0, c0)]


def _close(port, ref):
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("peephole", [False, True])
def test_step_reference_matches_pallas_step(peephole):
    a = _inputs(0, None, 8, 16, peephole)
    h1, c1 = pallas_lstm.lstm_step(*(jnp.asarray(x) for x in a))
    th1, tc1 = fl.lstm_step_reference(*(torch.from_numpy(x) for x in a))
    _close(th1, h1)
    _close(tc1, c1)


@pytest.mark.parametrize("B,H", [(1, 24), (5, 40), (8, 200)])
@pytest.mark.parametrize("peephole", [False, True])
def test_step_reference_matches_pallas_step_at_one_to_eight_slots(peephole, B, H):
    """One slot (a lone request), a ragged batch, and the decode engine's
    8 slots at char-LSTM's H = 200."""
    a = _inputs(1, None, B, H, peephole)
    h1, c1 = pallas_lstm.lstm_step(*(jnp.asarray(x) for x in a))
    th1, tc1 = fl.lstm_step_reference(*(torch.from_numpy(x) for x in a))
    _close(th1, h1)
    _close(tc1, c1)


@pytest.mark.parametrize("peephole", [False, True])
def test_sequence_reference_matches_pallas_forward(peephole):
    a = _inputs(1, 6, 4, 16, peephole)
    ref = pallas_lstm._fwd_call(*(jnp.asarray(x) for x in a))
    port = fl.lstm_sequence_forward_reference(*(torch.from_numpy(x) for x in a))
    for p, r in zip(port[:4], ref):  # y, acts, hprev, cprev
        _close(p, r)
    # the final cell state, as _lstm_fwd derives it from the stashes
    _, _, cF = pallas_lstm.lstm_sequence(*(jnp.asarray(x) for x in a))
    _close(port[4], cF)


@pytest.mark.parametrize("seq", [False, True])
def test_cpu_wrappers_take_the_plain_version_without_launching(seq):
    a = [torch.from_numpy(x) for x in _inputs(2, 5 if seq else None, 3, 8, True)]
    before = fl.launch_counts()
    if seq:
        y, hF, cF = fl.lstm_sequence(*a)
        ref = fl.lstm_sequence_forward_reference(*a)
        assert torch.equal(y, ref[0]) and torch.equal(hF, ref[0][-1])
        assert torch.equal(cF, ref[4])
    else:
        out = fl.lstm_step(*a)
        ref = fl.lstm_step_reference(*a)
        assert all(torch.equal(o, r) for o, r in zip(out, ref))
    assert fl.launch_counts() == before


def test_probes_are_false_for_cpu_tensors():
    cpu = torch.device("cpu")
    assert not fl.step_supported(peephole=True, gate_act="sigmoid",
                                 cell_act="tanh", device=cpu)
    assert not fl.supported(peephole=True, mask=None, gate_act="sigmoid",
                            cell_act="tanh", reverse=False, device=cpu)
    assert helpers.get_helper("lstm_decode_step", peephole=True,
                              gate_act="sigmoid", cell_act="tanh",
                              device=cpu) is None
    assert helpers.get_helper("lstm_sequence", peephole=True, mask=None,
                              gate_act="sigmoid", cell_act="tanh",
                              reverse=False, device=cpu) is None
    # scope: non-sigmoid gates, masks, reverse and gradients stay out
    assert not fl.step_supported(peephole=False, gate_act="hardsigmoid",
                                 cell_act="tanh", device=cpu)
    assert not fl.supported(peephole=False, mask=None, gate_act="sigmoid",
                            cell_act="tanh", reverse=True, device=cpu)


@pytest.mark.parametrize("fn", [fl.lstm_step, fl.lstm_sequence_forward])
def test_wrappers_raise_on_bad_dtype_shape_and_layout(fn):
    seq = fn is fl.lstm_sequence_forward
    a = [torch.from_numpy(x) for x in _inputs(3, 4 if seq else None, 2, 8, True)]
    with pytest.raises(TypeError):
        fn(*(x.double() for x in a))
    bad = list(a)
    bad[1] = a[1][:, :-4].contiguous()  # rw not [H, 4H]
    with pytest.raises(ValueError):
        fn(*bad)
    bad = list(a)
    bad[5] = torch.zeros(2, 9)          # h0 width differs from rw
    with pytest.raises(ValueError):
        fn(*bad)
    bad = list(a)
    bad[1] = torch.zeros(32, 8).t()     # [8, 32] but not contiguous
    with pytest.raises(ValueError):
        fn(*bad)


def test_cpu_helper_that_raises_is_disabled_and_falls_back():
    calls = []

    def broken(*args):
        calls.append(1)
        raise RuntimeError("boom")

    helpers.register_helper("test_torch_op", broken, name="broken")
    try:
        fn = helpers.get_helper("test_torch_op")
        with pytest.raises(helpers.HelperError):
            fn(torch.zeros(2))
        assert helpers.helper_enabled("test_torch_op") is False
        assert helpers.get_helper("test_torch_op") is None
        assert calls == [1]
    finally:
        helpers._HELPERS.pop("test_torch_op", None)

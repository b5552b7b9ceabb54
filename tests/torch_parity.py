"""Cross-package parity helper for the port's tests: build one
configuration in both packages, move the weights through the model zip
(`configuration.json` + `coefficients.bin`, which each package loads from
the other), and compare forward, score, gradients or parameters after a
step at a named tolerance.

    jnet = jax_multilayer(conf_builder(jax_dsl))
    tnet = port_twin(jnet, tmp_path)          # the same weights, on the CPU
    assert_params_close(jnet, tnet, "f32_step")

Tolerances (rtol, atol) by name:
  f32_forward  1e-5 / 1e-6   the same f32 expressions, summed in another order
  f32_step     1e-5 / 1e-7   parameters after optimizer steps in f32
  f64_grad     1e-10 / 1e-12 gradients in f64
  exact        0 / 0
"""

from __future__ import annotations

import os
import uuid

import numpy as np
import pytest
import torch

TOLERANCES = {
    "f32_forward": (1e-5, 1e-6),
    "f32_step": (1e-5, 1e-7),
    "f64_grad": (1e-10, 1e-12),
    "exact": (0.0, 0.0),
}


def host(a) -> np.ndarray:
    """A JAX array, a tensor (any device) or numpy, as numpy."""
    if torch.is_tensor(a):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def port_twin(jax_net, tmp_dir, device="cpu"):
    """The port's network with the JAX network's configuration, weights,
    layer state, updater state and counters, through a model zip."""
    from deeplearning4j_tpu.utils import model_serializer as jms
    from deeplearning4j_tpu_torch.utils import model_serializer as tms

    path = os.path.join(str(tmp_dir), f"twin-{uuid.uuid4().hex}.zip")
    jms.save_model(jax_net, path)
    return tms.load_model(path, device=device)


def jax_twin(port_net, tmp_dir):
    """The JAX package's network with the port network's state."""
    from deeplearning4j_tpu.utils import model_serializer as jms
    from deeplearning4j_tpu_torch.utils import model_serializer as tms

    path = os.path.join(str(tmp_dir), f"twin-{uuid.uuid4().hex}.zip")
    tms.save_model(port_net, path)
    return jms.load_model(path)


def _pairs(jax_tree, port_tree):
    for jl, tl in zip(jax_tree, port_tree):
        if jl is None or tl is None:
            assert jl is None and tl is None
            continue
        assert sorted(jl) == sorted(tl), (sorted(jl), sorted(tl))
        for k in sorted(jl):
            yield k, jl[k], tl[k]


def assert_params_close(jax_net, port_net, tol: str = "f32_step") -> None:
    rtol, atol = TOLERANCES[tol]
    for k, a, b in _pairs(jax_net.params_list, port_net.params_list):
        np.testing.assert_allclose(host(b), host(a), rtol=rtol, atol=atol,
                                   err_msg=f"param {k}")


def assert_close(jax_value, port_value, tol: str = "f32_forward",
                 what: str = "") -> None:
    rtol, atol = TOLERANCES[tol]
    np.testing.assert_allclose(host(port_value), host(jax_value), rtol=rtol,
                               atol=atol, err_msg=what)


def assert_grads_close(jax_grads, port_grads, tol: str = "f64_grad") -> None:
    """Per-layer gradient dicts, matched by name (the JAX package returns
    each layer's dict in sorted key order)."""
    rtol, atol = TOLERANCES[tol]
    for k, a, b in _pairs(jax_grads, port_grads):
        np.testing.assert_allclose(host(b), host(a), rtol=rtol, atol=atol,
                                   err_msg=f"grad {k}")


def port_grads(net, x, y, f_mask=None, l_mask=None):
    """(score, per-layer gradient dicts) of the port network's training
    loss on one batch, in the network's dtype, no random draws."""
    leaves = [(i, k) for i, p in enumerate(net.params_list) for k in p]
    for i, k in leaves:
        net.params_list[i][k].requires_grad_(True)
    try:
        as_t = lambda a: None if a is None else torch.as_tensor(  # noqa: E731
            np.asarray(a), device=net.device)
        s, _ = net._loss(net.params_list, net.state_list, as_t(x), as_t(y),
                         as_t(f_mask), as_t(l_mask), None)
        gs = torch.autograd.grad(s, [net.params_list[i][k] for i, k in leaves],
                                 allow_unused=True)
    finally:
        for i, k in leaves:
            net.params_list[i][k].requires_grad_(False)
    out = [dict() for _ in net.params_list]
    for (i, k), g in zip(leaves, gs):
        out[i][k] = (torch.zeros_like(net.params_list[i][k]) if g is None
                     else g)
    return s.detach(), out


def jax_grads(net, x, y, f_mask=None, l_mask=None):
    """(score, per-layer gradient dicts) of the JAX network's training
    loss on one batch, no random draws."""
    import jax
    import jax.numpy as jnp

    as_j = lambda a: None if a is None else jnp.asarray(a)  # noqa: E731
    (s, _), g = jax.value_and_grad(
        lambda p: net._loss(p, net.state_list, as_j(x), as_j(y),
                            as_j(f_mask), as_j(l_mask), rng=None),
        has_aux=True)(net.params_list)
    return s, g


@pytest.fixture
def one_torch_thread():
    """One intra-op thread for a test of many tiny ops (an embeddings fit).
    Under several test workers a thread pool per process oversubscribes
    the cores, and the small ops then wait on each other's threads. A
    test module takes it with `pytestmark = pytest.mark.usefixtures(...)`
    after importing it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

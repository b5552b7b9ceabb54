"""The port's losses (deeplearning4j_tpu_torch/ops/losses.py) and updaters
(train/updaters.py) against the JAX package's (ops/losses.py,
train/updaters.py), on the same numpy inputs.

Tolerances, f32: losses and their input gradients rtol 1e-5 / atol 1e-6
(the same expressions, summed in another order); updater updates and
state over three steps rtol 1e-5 / atol 1e-7; gradient normalization
rtol 1e-5 / atol 1e-7; learning-rate schedules rtol 1e-12 (both are
host-side Python floats).
"""

import types
import zlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deeplearning4j_tpu.ops import losses as jlosses
from deeplearning4j_tpu.train import updaters as jupd
from deeplearning4j_tpu_torch.ops import losses
from deeplearning4j_tpu_torch.train import updaters

RTOL, ATOL = 1e-5, 1e-6

# loss -> (output activation, label kind)
_LOSSES = {
    "mse": ("identity", "real"),
    "l2": ("tanh", "real"),
    "l1": ("identity", "real"),
    "mean_absolute_error": ("identity", "real"),
    "mean_absolute_percentage_error": ("identity", "away"),
    "mean_squared_logarithmic_error": ("sigmoid", "unit"),
    "xent": ("sigmoid", "binary"),
    "mcxent": ("softmax", "onehot"),
    "negativeloglikelihood": ("softmax", "onehot"),
    "kl_divergence": ("softmax", "dist"),
    "reconstruction_crossentropy": ("sigmoid", "binary"),
    "cosine_proximity": ("identity", "real"),
    "hinge": ("identity", "sign"),
    "squared_hinge": ("tanh", "sign"),
    "poisson": ("softplus", "counts"),
    "squared_loss": ("identity", "real"),
    "rmse_xent": ("sigmoid", "unit"),
}
# the non-fused branches of the two cross-entropies
_EXTRA = [("xent", "softmax", "binary"), ("mcxent", "sigmoid", "onehot")]
_CASES = [(n, a, k) for n, (a, k) in _LOSSES.items()] + _EXTRA


def _labels(rng, kind, shape):
    C = shape[-1]
    if kind == "real":
        return rng.standard_normal(shape)
    if kind == "away":
        return rng.uniform(0.5, 2.0, shape) * rng.choice([-1, 1], shape)
    if kind == "unit":
        return rng.uniform(0.05, 0.95, shape)
    if kind == "binary":
        return rng.integers(0, 2, shape)
    if kind == "onehot":
        return np.eye(C)[rng.integers(0, C, shape[:-1])]
    if kind == "dist":
        p = rng.uniform(0.1, 1.0, shape)
        return p / p.sum(-1, keepdims=True)
    if kind == "sign":
        return rng.choice([-1.0, 1.0], shape)
    if kind == "counts":
        return rng.integers(0, 4, shape)
    raise ValueError(kind)


def test_every_registered_loss_is_covered():
    assert set(_LOSSES) == set(losses._REGISTRY) == set(jlosses._REGISTRY)


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
@pytest.mark.parametrize("name,act,kind", _CASES,
                         ids=[f"{n}-{a}" for n, a, _ in _CASES])
def test_loss_value_and_input_gradient_match_jax(name, act, kind, masked):
    rng = np.random.default_rng(zlib.crc32(f"{name}-{act}".encode()))
    shape = (4, 3, 5)  # [batch, time, classes]
    preout = rng.standard_normal(shape).astype(np.float32)
    labels = _labels(rng, kind, shape).astype(np.float32)
    mask = None
    if masked:
        mask = rng.integers(0, 2, shape[:2]).astype(np.float32)
        mask[1] = 0.0   # one fully masked example: absent from the mean
        mask[0, 0] = 1.0

    def jax_score(z):
        m = None if mask is None else jnp.asarray(mask)
        per = jlosses.loss_value(name, jnp.asarray(labels), z, act, m)
        return jlosses.masked_example_mean(per, m), per

    (jscore, jper), jgrad = jax.value_and_grad(jax_score, has_aux=True)(
        jnp.asarray(preout))

    z = torch.from_numpy(preout).requires_grad_()
    m = None if mask is None else torch.from_numpy(mask)
    per = losses.loss_value(name, torch.from_numpy(labels), z, act, m)
    score = losses.masked_example_mean(per, m)
    score.backward()
    np.testing.assert_allclose(per.detach().numpy(), np.asarray(jper), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(score.item(), float(jscore), rtol=RTOL, atol=ATOL)
    jgrad = np.asarray(jgrad)
    if name == "cosine_proximity" and masked:
        # the JAX package differentiates jnp.linalg.norm at a zero
        # (masked) row and gets NaN; torch's norm has gradient 0 there
        nan = np.isnan(jgrad)
        assert nan.any() and (z.grad.numpy()[nan] == 0).all()
        jgrad = np.where(nan, 0.0, jgrad)
    np.testing.assert_allclose(z.grad.numpy(), jgrad, rtol=RTOL, atol=ATOL)
    if masked:
        assert np.asarray(jlosses.example_presence(jper, jnp.asarray(mask))).tolist() \
            == losses.example_presence(per, m).tolist()


def test_unknown_loss_raises_with_the_known_names():
    with pytest.raises(ValueError, match="mcxent"):
        losses.loss_value("nope", torch.zeros(1, 2), torch.zeros(1, 2), "identity")


_UPDATERS = ["sgd", "nesterovs", "adam", "adamax", "adadelta", "adagrad",
             "rmsprop", "none"]


@pytest.mark.parametrize("name", _UPDATERS)
def test_updater_three_steps_match_jax(name):
    rng = np.random.default_rng(len(name))
    hyper = dict(learning_rate=0.05, momentum=0.8, rho=0.9, rms_decay=0.9,
                 beta1=0.85, beta2=0.99, epsilon=1e-6)
    jdef = jupd.make_updater(name, **hyper)
    tdef = updaters.make_updater(name, **hyper)
    p = rng.standard_normal((3, 4)).astype(np.float32)
    js, ts = jdef.init(jnp.asarray(p)), tdef.init(torch.from_numpy(p))
    for t in range(3):
        g = rng.standard_normal((3, 4)).astype(np.float32)
        ju, js = jdef.apply(jnp.asarray(g), js, 0.05, float(t), jdef.hyper)
        tu, ts = tdef.apply(torch.from_numpy(g), ts, 0.05, float(t), tdef.hyper)
        np.testing.assert_allclose(tu.numpy(), np.asarray(ju), rtol=1e-5, atol=1e-7)
        assert sorted(ts) == sorted(js or {})
        for k in ts:
            np.testing.assert_allclose(ts[k].numpy(), np.asarray(js[k]),
                                       rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("name", ["rmsprop", "adam"])
def test_step_in_place_equals_the_tree_apply(name):
    """`step_` adds the updates to the parameters and writes the new
    state into the state's own tensors."""
    rng = np.random.default_rng(0)
    tdef = updaters.make_updater(name, learning_rate=0.1)
    params = [{"W": torch.from_numpy(rng.standard_normal((2, 3)).astype(np.float32)),
               "b": torch.zeros(3)}, {}]
    state = tdef.init_tree(params)
    keep = {k: v for k, v in state[0]["W"].items()}
    grads = [{k: torch.from_numpy(rng.standard_normal(v.shape).astype(np.float32))
              for k, v in p.items()} for p in params]
    before = [{k: v.clone() for k, v in p.items()} for p in params]
    exp_u, exp_s = tdef.apply_tree(grads, state, 0.1, 0.0)
    tdef.step_(params, grads, state, [{"W": 0.1, "b": 0.1}, {}], 0.0)
    for p, b, u in zip(params, before, exp_u):
        for k in p:
            torch.testing.assert_close(p[k], b[k] + u[k], rtol=0, atol=0)
    for k, v in keep.items():
        assert state[0]["W"][k] is v
        torch.testing.assert_close(v, exp_s[0]["W"][k], rtol=0, atol=0)


def test_unknown_updater_raises():
    with pytest.raises(ValueError):
        updaters.make_updater("lamb")


_NORMS = ["none", "renormalize_l2_per_layer", "renormalize_l2_per_param_type",
          "clip_elementwise_absolute_value", "clip_l2_per_layer",
          "clip_l2_per_param_type"]


@pytest.mark.parametrize("threshold", [0.5, 50.0], ids=["clips", "passes"])
@pytest.mark.parametrize("mode", _NORMS)
def test_normalize_gradients_matches_jax(mode, threshold):
    rng = np.random.default_rng(1)
    grads = [{"W": rng.standard_normal((3, 4)), "b": rng.standard_normal(4)},
             {}, {"RW": rng.standard_normal((2, 8)) * 3}]
    grads = [{k: v.astype(np.float32) for k, v in g.items()} for g in grads]
    ref = jupd.normalize_gradients(
        [{k: jnp.asarray(v) for k, v in g.items()} for g in grads], mode, threshold)
    out = updaters.normalize_gradients(
        [{k: torch.from_numpy(v) for k, v in g.items()} for g in grads], mode, threshold)
    for o, r in zip(out, ref):
        assert sorted(o) == sorted(r)
        for k in o:
            np.testing.assert_allclose(np.asarray(o[k]), np.asarray(r[k]),
                                       rtol=1e-5, atol=1e-7)


def test_unknown_gradient_normalization_raises():
    with pytest.raises(ValueError):
        updaters.normalize_gradients([{"W": torch.ones(2)}], "clip_everything", 1.0)


_POLICIES = ["none", "schedule", "exponential", "inverse", "poly", "sigmoid", "step"]


@pytest.mark.parametrize("policy", _POLICIES)
def test_schedule_lr_matches_jax(policy):
    conf = types.SimpleNamespace(
        learning_rate=0.2, lr_policy=policy, lr_policy_decay_rate=0.9,
        lr_policy_steps=7.0, lr_policy_power=1.5,
        lr_schedule={"0": 0.3, "4": 0.1, "10": 0.01})
    for it in (0, 1, 3, 4, 6, 9, 10, 25):
        np.testing.assert_allclose(updaters.schedule_lr(conf, it),
                                   jupd.schedule_lr(conf, it), rtol=1e-12)


def test_updater_from_conf_maps_the_builder_names():
    from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration

    conf = (NeuralNetConfiguration.builder().updater("adam").learning_rate(0.3)
            .adam_mean_decay(0.7).adam_var_decay(0.95).epsilon(1e-5).build())
    u = updaters.updater_from_conf(conf)
    assert u.name == "adam"
    assert u.hyper["beta1"] == 0.7 and u.hyper["beta2"] == 0.95
    assert u.hyper["epsilon"] == 1e-5 and u.hyper["learning_rate"] == 0.3

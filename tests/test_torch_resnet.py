"""The ResNet slice of the port: ComputationGraph training on the repo's
ResNet configurations, against the JAX package on the CPU.

Same configuration JSON, same weights and BN state (carried across with
`params_from_numpy` / `states_from_numpy`), same numpy batches into both.
The port runs twice: with the helpers off (the builtin torch layers) and
with the conv/BN probes patched to their structural scope, as a Hopper GPU
routes, so that the CPU goes through the kernels' plain versions. f32
throughout; tolerances are stated at each comparison.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deeplearning4j_tpu.models import resnet as jresnet
from deeplearning4j_tpu.nn.compgraph import ComputationGraph as JCG
from deeplearning4j_tpu.ops import pallas_conv_bn as pcb
from deeplearning4j_tpu.train.listeners import IterationListener as JListener
from deeplearning4j_tpu_torch.analysis.kernelcoverage import conv_instances
from deeplearning4j_tpu_torch.models import resnet as tresnet
from deeplearning4j_tpu_torch.nn.compgraph import ComputationGraph as TCG
from deeplearning4j_tpu_torch.nn.conf import layers as TL
from deeplearning4j_tpu_torch.nn.conf.graph import ComputationGraphConfiguration
from deeplearning4j_tpu_torch.nn.params import params_from_numpy, states_from_numpy
from deeplearning4j_tpu_torch.ops import fused_conv_bn as fcb
from deeplearning4j_tpu_torch.ops import helpers
from deeplearning4j_tpu_torch.train.listeners import IterationListener as TListener

SCORE_RTOL = 1e-5   # f32 scores: summation order only
GRAD_RTOL = 1e-4    # f32 gradients at each tensor's scale, after a deep chain
STATE_RTOL = 1e-4   # BN running stats: raw-moment vs two-pass variance

CONFS = {
    "tiny": lambda mod: mod.tiny_resnet_conf(),
    "two_blocks": lambda mod: mod.resnet_conf(
        blocks=(2, 2), widths=(2, 4), num_classes=3, image_size=8, channels=3,
        stem_width=4, seed=7),
}


@pytest.fixture(autouse=True)
def _interpret_mode():
    old = pcb._INTERPRET
    pcb._INTERPRET = True
    yield
    pcb._INTERPRET = old
    fcb._STATS_STASH.clear()


@pytest.fixture
def fused_cpu_path(monkeypatch):
    """The three conv/BN probes at their structural scope (what a Hopper
    GPU routes), so CPU tensors go through the kernels' plain versions;
    every plain-version call is counted."""
    monkeypatch.setattr(helpers._HELPERS["conv2d"], "supported",
                        lambda **c: fcb.conv_decision(**c)["status"] == "covered")
    monkeypatch.setattr(helpers._HELPERS["batch_norm"], "supported",
                        lambda **c: c["training"] and fcb.peek_stats(c["x"]))
    monkeypatch.setattr(helpers._HELPERS["bn_backward"], "supported",
                        lambda **c: c["training"])
    calls = {"conv1x1": 0, "convkxk": 0, "bn_apply": 0, "bn_apply_relu": 0,
             "bn_reduce": 0, "bn_dx": 0}

    def counted(name, fn):
        def wrap(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrap

    monkeypatch.setattr(fcb, "conv1x1_stats_reference",
                        counted("conv1x1", fcb.conv1x1_stats_reference))
    monkeypatch.setattr(fcb, "conv_kxk_stats_reference",
                        counted("convkxk", fcb.conv_kxk_stats_reference))
    plain_norm = fcb.bn_normalize_reference

    def norm(x2, mb, sc, sh, relu):
        calls["bn_apply_relu" if relu else "bn_apply"] += 1
        return plain_norm(x2, mb, sc, sh, relu)

    monkeypatch.setattr(fcb, "bn_normalize_reference", norm)
    monkeypatch.setattr(fcb, "bn_backward_reduce_reference",
                        counted("bn_reduce", fcb.bn_backward_reduce_reference))
    monkeypatch.setattr(fcb, "bn_backward_apply_reference",
                        counted("bn_dx", fcb.bn_backward_apply_reference))
    return calls


def _pair(which):
    """(JAX net, port net) on the same configuration, weights and state."""
    jconf = CONFS[which](jresnet)
    jn = JCG(jconf).init()
    tconf = ComputationGraphConfiguration.from_json(jconf.to_json())
    tn = TCG(tconf, device="cpu").init()
    tn.params_list = params_from_numpy(
        tconf, [{k: np.asarray(v) for k, v in p.items()} for p in jn.params_list],
        device="cpu")
    tn.state_list = states_from_numpy(
        tconf, [None if s is None else {k: np.asarray(v) for k, v in s.items()}
                for s in jn.state_list], device="cpu")
    return jn, tn


def _batch(seed=0, n=6):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, 8, 8, 3)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, n)]
    return x, y


def _close(port, ref, rtol):
    p = np.asarray(port.detach() if torch.is_tensor(port) else port, np.float64)
    r = np.asarray(ref, np.float64)
    np.testing.assert_allclose(p, r, rtol=rtol, atol=rtol * max(np.abs(r).max(), 1e-30))


# -- configuration ------------------------------------------------------------


@pytest.mark.parametrize("which", ["resnet50", "tiny"])
def test_conf_json_round_trips_byte_identical(which):
    jconf = (jresnet.resnet50_conf(precision="bf16") if which == "resnet50"
             else jresnet.tiny_resnet_conf())
    js = jconf.to_json()
    assert ComputationGraphConfiguration.from_json(js).to_json() == js
    tconf = (tresnet.resnet50_conf(precision="bf16") if which == "resnet50"
             else tresnet.tiny_resnet_conf())
    assert tconf.to_json() == js


def test_resnet50_routes_every_conv_to_k4_or_k5_and_fuses_33_relus():
    conf = tresnet.resnet50_conf(precision="bf16")
    net = TCG(conf, device="cpu")
    fams = {}
    for _, ctx in conv_instances(conf, batch=128):
        d = fcb.conv_decision(dtype=torch.bfloat16, **ctx)
        assert d["status"] == "covered", d
        fams[d["family"]] = fams.get(d["family"], 0) + 1
    # stages 1-3 enter with stride 2 on the 3x3 and the projection
    assert fams == {"conv1x1": 33, "conv1x1s2": 3, "conv3x3": 13, "conv3x3s2": 3,
                    "conv7x7s2": 1}  # K4: 36, K5: 17
    n_bn = sum(isinstance(lc, TL.BatchNormalization) for lc in net._layer_confs)
    assert n_bn == 53 and len(net.relu_fused_bn) == 33
    assert not any(n.endswith(("_c_bn", "_sc_bn")) for n in net.relu_fused_bn)
    assert all(conf.vertices[r].layer.activation == "relu"
               and conf.vertex_inputs[r] == [b] for b, r in net.relu_fused_bn.items())


# -- the slice ----------------------------------------------------------------


@pytest.mark.parametrize("which", list(CONFS))
def test_output_matches_jax(which):
    jn, tn = _pair(which)
    x, _ = _batch()
    _close(tn.output(x), jn.output(x), SCORE_RTOL)


def _jax_loss_grads(jn, x, y):
    def loss(p):
        return jn._loss(p, jn.state_list, [jnp.asarray(x)], [jnp.asarray(y)],
                        None, None, None)

    (s, st), g = jax.value_and_grad(loss, has_aux=True)(jn.params_list)
    return float(s), g, st


def _port_loss_grads(tn, x, y):
    leaves = [v.requires_grad_() for p in tn.params_list for v in p.values()]
    try:
        s, st = tn._loss(tn.params_list, tn.state_list, [torch.from_numpy(x)],
                         [torch.from_numpy(y)], None, None, None)
        g = torch.autograd.grad(s, leaves)
    finally:
        for v in leaves:
            v.requires_grad_(False)
    return float(s.detach()), g, st


def _check_loss_grads(jn, tn, x, y):
    js, jg, jst = _jax_loss_grads(jn, x, y)
    ts, tg, tst = _port_loss_grads(tn, x, y)
    assert ts == pytest.approx(js, rel=SCORE_RTOL)
    # jax returns each layer's dict in sorted key order: match by name
    jleaves = [jg[i][k] for i, p in enumerate(tn.params_list) for k in p]
    assert len(jleaves) == len(tg)
    for a, b in zip(tg, jleaves):
        _close(a, b, GRAD_RTOL)
    for a, b in zip(tst, jst):
        if b is not None:
            for k in b:
                _close(a[k], b[k], STATE_RTOL)


@pytest.mark.parametrize("which", list(CONFS))
def test_loss_and_grads_match_jax_with_helpers_off(which):
    jn, tn = _pair(which)
    _check_loss_grads(jn, tn, *_batch(1))


@pytest.mark.parametrize("which", list(CONFS))
def test_loss_and_grads_match_jax_through_the_plain_kernels(which, fused_cpu_path):
    jn, tn = _pair(which)
    _check_loss_grads(jn, tn, *_batch(1))
    calls = fused_cpu_path
    n_conv = sum(isinstance(lc, TL.ConvolutionLayer) for lc in tn._layer_confs)
    n_bn = sum(isinstance(lc, TL.BatchNormalization) for lc in tn._layer_confs)
    assert calls["conv1x1"] + calls["convkxk"] == n_conv
    assert calls["bn_apply"] + calls["bn_apply_relu"] == n_bn
    assert calls["bn_apply_relu"] == len(tn.relu_fused_bn)
    assert calls["bn_reduce"] == calls["bn_dx"] == n_bn
    assert not fcb._STATS_STASH


class _Scores:
    def __init__(self):
        self.scores = []

    def iteration_done(self, model, iteration, info):
        self.scores.append(float(info["score"]()))


def _fit_three(jn, tn, x, y):
    jlog = type("J", (_Scores, JListener), {})()
    tlog = type("T", (_Scores, TListener), {})()
    jn.set_listeners(jlog)
    tn.set_listeners(tlog)
    for _ in range(3):
        jn.fit(x, y, batch_size=len(x), async_prefetch=False)
        tn.fit(x, y, batch_size=len(x))
    return jlog.scores, tlog.scores


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("which", list(CONFS))
def test_three_nesterovs_steps_match_jax_fit(which, fused, request):
    """Like with like: the port's builtin layers against the JAX package's
    XLA lowering, the port's fused path against its Pallas kernels, at the
    configuration's lr 0.1. Scores to 1e-5 relative, except the two-block
    net's fused path: its 2-channel convs feed the BNs mostly one-signed
    outputs, so the raw-moment variance E[y^2] - mean^2 of both fused
    paths cancels and depends on the summation order — the two packages
    part by 4e-6 at the first forward, and the JAX package's own XLA and
    Pallas paths by 3.4e-5 by the third step — so 1e-4 there. Parameters
    after the three steps: ten times the score tolerance, at each tensor's
    scale."""
    pcb._INTERPRET = fused
    if fused:
        request.getfixturevalue("fused_cpu_path")
    jn, tn = _pair(which)
    x, y = _batch(2)
    js, ts = _fit_three(jn, tn, x, y)
    assert len(ts) == 3 and tn.iteration == 3
    rtol = 1e-4 if (fused and which == "two_blocks") else SCORE_RTOL
    np.testing.assert_allclose(ts, js, rtol=rtol)
    assert ts[-1] < ts[0]
    for a, b in zip(tn.state_list, jn.state_list):
        if b is not None:
            for k in b:
                _close(a[k], b[k], max(rtol, STATE_RTOL))
    for a, b in zip(tn.params_list, jn.params_list):
        for k in b:
            _close(a[k], b[k], 10 * rtol)


def test_tiny_fused_fit_is_no_further_from_f64_than_the_jax_packages(fused_cpu_path):
    """The f64 witness of test_three_nesterovs_steps_match_jax_fit[tiny-True]:
    the same three steps through the port's plain kernels in f64. The
    stem BN's beta has three entries whose exact gradient is zero, so
    both f32 packages leave rounding noise there (~1e-8 against a 6.8e-8
    tolerance); the port's stands no further from the witness than the
    JAX package's, within 1.5x by the median and by the worst tensor (the
    rule of test_resnet50_f32_gradients_are_as_close_to_f64_as_the_jax_packages).
    The conv statistics' plain sums (f64 accumulation, see
    ops/fused_conv_bn.py `_stats_of_stored`) are what keep it there: with
    f32 sums in torch's order the port stood up to 1.8x off and moved with
    the CPU's thread count (scripts/tiny_resnet_f64_witness.py)."""
    from deeplearning4j_tpu_torch.common.dtypes import PrecisionPolicy

    pcb._INTERPRET = True
    jn, tn = _pair("tiny")
    t64 = tn.clone()
    f64 = torch.float64
    t64.policy = PrecisionPolicy(param_dtype=f64, compute_dtype=f64, output_dtype=f64)
    t64.params_list = [{k: v.double() for k, v in p.items()} for p in t64.params_list]
    t64.state_list = [None if s is None else {k: v.double() for k, v in s.items()}
                      for s in t64.state_list]
    t64.upd_state = t64.updater_def.init_tree(t64.params_list)
    x, y = _batch(2)
    _fit_three(jn, tn, x, y)
    for _ in range(3):
        t64.fit(x.astype(np.float64), y.astype(np.float64), batch_size=len(x))
    errs = {"port": [], "jax": []}
    for a, b, w in zip(tn.params_list, jn.params_list, t64.params_list):
        for k in b:
            ref = w[k].numpy()
            scale = max(np.abs(ref).max(), 1e-30)
            errs["port"].append(np.abs(a[k].double().numpy() - ref).max() / scale)
            errs["jax"].append(np.abs(np.asarray(b[k], np.float64) - ref).max() / scale)
    port, jax_ = np.median(errs["port"]), np.median(errs["jax"])
    assert port <= 1.5 * jax_, (port, jax_)
    assert max(errs["port"]) <= 1.5 * max(errs["jax"]), (max(errs["port"]), max(errs["jax"]))


def test_fit_takes_a_multidataset_and_score_reads_the_running_stats():
    from deeplearning4j_tpu_torch.data import MultiDataSet

    _, tn = _pair("tiny")
    x, y = _batch(3, n=8)
    before = [{k: v.clone() for k, v in s.items()} if s else None for s in tn.state_list]
    tn.fit(MultiDataSet([x], [y]), batch_size=4)
    assert tn.iteration == 2
    moved = [not torch.equal(a["mean"], b["mean"])
             for a, b in zip(tn.state_list, before) if b is not None]
    assert all(moved)
    other = tn.clone()
    assert other.score(x, y) == pytest.approx(tn.score(x, y), rel=0, abs=0)
    acts = tn.feed_forward(x)
    assert tuple(acts["out"].shape) == (8, 3)


# -- init and entry points ----------------------------------------------------


def test_conv_weights_have_he_init_statistics():
    net = TCG(tresnet.resnet_conf(blocks=(1,), widths=(64,), num_classes=10,
                                  image_size=32), device="cpu").init()
    seen = 0
    for lc, p in zip(net._layer_confs, net.params_list):
        if isinstance(lc, TL.ConvolutionLayer):
            w = p["W"].double()
            fan_in = lc.n_in * lc.kernel_size[0] * lc.kernel_size[1]
            assert tuple(w.shape) == (*lc.kernel_size, lc.n_in, lc.n_out)
            assert "b" not in p
            # std sqrt(2 / fan_in): the sample std of >= 9,408 draws within 3%
            assert float(w.std()) == pytest.approx((2.0 / fan_in) ** 0.5, rel=0.03)
            assert abs(float(w.mean())) < 4 * (2.0 / fan_in) ** 0.5 / w.numel() ** 0.5
            seen += 1
    assert seen == 5


def test_states_and_params_carry_across_are_checked():
    jn, tn = _pair("tiny")
    states = [None if s is None else {k: np.asarray(v) for k, v in s.items()}
              for s in jn.state_list]
    bad = list(states)
    i = next(i for i, s in enumerate(bad) if s is not None)
    bad[i] = {"mean": bad[i]["mean"]}
    with pytest.raises(ValueError, match="state"):
        states_from_numpy(tn.conf, bad, device="cpu")
    with pytest.raises(ValueError, match="dicts for"):
        params_from_numpy(tn.conf, [{}], device="cpu")


def test_resnet50_network_runs_on_the_gpu_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tresnet.resnet50_network(num_classes=10, image_size=32)


# -- ResNet-50 at full width and depth, images cut for the CPU ------------------


def _resnet50_pair(img, lr):
    jconf = jresnet.resnet50_conf(image_size=img, learning_rate=lr)
    jn = JCG(jconf).init()
    tconf = ComputationGraphConfiguration.from_json(jconf.to_json())
    tn = TCG(tconf, device="cpu").init()
    tn.params_list = params_from_numpy(
        tconf, [{k: np.asarray(v) for k, v in p.items()} for p in jn.params_list],
        device="cpu")
    tn.state_list = states_from_numpy(
        tconf, [None if s is None else {k: np.asarray(v) for k, v in s.items()}
                for s in jn.state_list], device="cpu")
    return jn, tn


def _resnet50_batch(img, n=8):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((n, img, img, 3)).astype(np.float32)
    return x, np.eye(1000, dtype=np.float32)[rng.integers(0, 1000, n)]


def test_published_lr_rises_alike_in_both_packages_at_full_width():
    """ResNet-50 (blocks 3,4,6,3, widths 64-512, 1000 classes, f32) on 64 px
    random images at batch 8, three steps on one batch. At the
    configuration's lr 0.1 the score rises several-fold by step 3 in the
    JAX package and in the port alike (which is why chip_smoke.py phase 6
    trains at 0.01); at 0.01 it falls in both. The first scores agree to
    1e-5; later ones part, as the next test explains."""
    pcb._INTERPRET = False
    x, y = _resnet50_batch(64)
    for lr in (0.1, 0.01):
        jn, tn = _resnet50_pair(64, lr)
        js, ts = _fit_three(jn, tn, x, y)
        assert ts[0] == pytest.approx(js[0], rel=SCORE_RTOL)
        for s in (js, ts):
            if lr == 0.1:
                assert max(s[1:]) > 3 * s[0], (lr, js, ts)
            else:
                assert s[2] < s[0], (lr, js, ts)


def test_resnet50_f32_gradients_are_as_close_to_f64_as_the_jax_packages():
    """At 32 px and batch 8 the last stage's BNs normalize over 8 values per
    channel, some with a variance near zero, and the pullback's inv**3
    amplifies f32 rounding: both packages' f32 gradients stand ~2% (median
    over tensors) and up to ~30% (worst tensor) off the f64 gradient, in
    different tensors. The port's f32 gradient is held to be no further
    from f64 than the JAX package's: the two packages disagree with each
    other there by conditioning, not by a fault."""
    from deeplearning4j_tpu_torch.common.dtypes import PrecisionPolicy

    pcb._INTERPRET = False
    x, y = _resnet50_batch(32)
    jn, tn = _resnet50_pair(32, 0.1)
    _, jg, _ = _jax_loss_grads(jn, x, y)
    _, tg, _ = _port_loss_grads(tn, x, y)
    t64 = tn.clone()
    f64 = torch.float64
    t64.policy = PrecisionPolicy(param_dtype=f64, compute_dtype=f64, output_dtype=f64)
    t64.params_list = [{k: v.double() for k, v in p.items()} for p in t64.params_list]
    t64.state_list = [None if s is None else {k: v.double() for k, v in s.items()}
                      for s in t64.state_list]
    _, g64, _ = _port_loss_grads(t64, x.astype(np.float64), y.astype(np.float64))
    errs = {"port": [], "jax": []}
    i = 0
    for li, p in enumerate(tn.params_list):
        for k in p:
            ref = g64[i].numpy()
            scale = max(np.abs(ref).max(), 1e-30)
            errs["port"].append(np.abs(tg[i].numpy() - ref).max() / scale)
            errs["jax"].append(np.abs(np.asarray(jg[li][k], np.float64) - ref).max() / scale)
            i += 1
    port, jax_ = np.median(errs["port"]), np.median(errs["jax"])
    assert port <= 1.5 * jax_, (port, jax_)
    assert max(errs["port"]) <= 1.5 * max(errs["jax"]), (max(errs["port"]), max(errs["jax"]))


def test_resnet50_f32_gradient_at_init_is_ill_conditioned():
    """Why chip_smoke.py phase 6 holds the kernels' whole f32 gradient to an
    f64 witness, and K7 + K8 at a fixed bound only from a shared forward.
    ResNet-50 at full width and depth, 32 px noise images, batch 8, the
    port's builtin f32 path, at init. The same batch in another order (the
    same gradient in exact arithmetic; only the rounding of the batch sums
    changes) flips ReLU gates whose inputs lie within rounding of zero, and
    the gradient jumps: it moves by more than 1e-3 of the median tensor's
    largest entry (~1.5e-2 measured). From one forward the backward is well
    conditioned: taking the BN pullback on centered x (x - mean) instead of
    the raw x both packages keep moves it by less than 1e-4 of any tensor's
    largest entry (~3e-6 measured), so the cancellation in
    sum(g*x) - mean*sum(g) is not the cause."""
    from deeplearning4j_tpu_torch.nn.layers import norm

    net = tresnet.resnet50_network(image_size=32, learning_rate=0.01, seed=0, device="cpu")
    x, y = _resnet50_batch(32)
    perm = np.random.default_rng(1).permutation(len(x))

    def grads(xx=x, yy=y):
        return _port_loss_grads(net, xx, yy)[1]

    def dist(ga, gb):
        d = [((a.double() - b.double()).abs().max() / b.double().abs().max()).item()
             for a, b in zip(ga, gb)]
        return np.median(d), max(d)

    def acts(xx):
        with torch.no_grad():
            a, _ = net._forward(net.params_list, net.state_list, [torch.from_numpy(xx)],
                                training=True, rng=None)
        return a

    plain = norm.bn_backward_pieces

    def centered(g, xx, mean, inv, gamma, n):
        return plain(g, xx - mean, torch.zeros_like(mean), inv, gamma, n)

    g = grads()
    assert dist(grads(x[perm], y[perm]), g)[0] > 1e-3
    a0, a1 = acts(x), acts(x[perm])
    inv = torch.from_numpy(np.argsort(perm))
    gated = [n for n in net.topo if n in net.relu_fused_bn or n.endswith("_relu")]
    assert sum(int(((a0[n] > 0) != (a1[n][inv] > 0)).sum()) for n in gated) >= 1
    try:
        norm.bn_backward_pieces = centered
        assert dist(grads(), g)[1] < 1e-4
    finally:
        norm.bn_backward_pieces = plain

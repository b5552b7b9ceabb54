"""The fused optimizer tail on a Hopper GPU (`cuda` marker; each test
skips itself without one): csrc/updater_apply.cu against the per-leaf
torch ops it replaces (`apply_updater_reference` on the same CUDA
tensors), and graphed fits that run it.

- The kernel, per updater, with L2 0 and 1e-3, over leaves of 1, 3, 64,
  4,095 and 2,359,296 floats, one at a misaligned storage offset (the
  element-wise path), and 300 small leaves (more launches than one), with
  per-leaf lr multipliers, three steps: parameters and state bit-equal at
  L2 0 and within rtol 1e-6 otherwise; score and norm within rtol 1e-6
  (the kernel sums in f64 in another order than torch's f32 sums); the
  launches `plan_launches` predicts; no synchronization (sync debug mode
  "error").
- A graphed tiny-ResNet fit (set_fused_steps(2), Nesterovs, L2 1e-4) and
  a graphed TBPTT char-LSTM fit (RMSProp, L2 1e-3), also with a backward
  length shorter than the segment (the truncated loss, whose L2 gradient
  enters by slice B's weight alone): replays bit-equal to
  the eager loop of the same steps, the launches a step as the table
  predicts, no synchronize after the capture, no declined step; and the
  fused fit against the per-leaf tail's within 1e-5 of each leaf's largest
  magnitude (L2's gradient rounds once in the kernel, twice in autograd).

This file imports nothing of JAX: `python -m pytest --noconftest
tests/test_torch_updater_cuda.py` runs it where JAX is not installed.
"""

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.data import DataSet, ListDataSetIterator
from deeplearning4j_tpu_torch.models.charlstm import char_lstm_network
from deeplearning4j_tpu_torch.models.resnet import tiny_resnet_conf
from deeplearning4j_tpu_torch.nn import netbase
from deeplearning4j_tpu_torch.nn.compgraph import ComputationGraph
from deeplearning4j_tpu_torch.ops import fused_updater as fu
from deeplearning4j_tpu_torch.train.listeners import IterationListener
from deeplearning4j_tpu_torch.train.updaters import make_updater
from deeplearning4j_tpu_torch.utils.metrics import get_registry

SIZES = (1, 3, 64, 4095, 2359296)


@pytest.fixture(autouse=True)
def _card():
    if not (torch.cuda.is_available()
            and torch.cuda.get_device_capability() >= (9, 0)):
        pytest.skip("needs an NVIDIA GPU of compute capability >= 9.0")
    old = (torch.backends.cudnn.deterministic, torch.backends.cudnn.allow_tf32,
           torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    yield
    (torch.backends.cudnn.deterministic, torch.backends.cudnn.allow_tf32,
     torch.backends.cuda.matmul.allow_tf32) = old


def _leaves(kind, seed):
    """(params, grads, l2 flags, lr multipliers) on the card: SIZES and one
    leaf at storage offset 1, or 300 leaves of 1-700 floats."""
    g = torch.Generator().manual_seed(seed)
    if kind == "sizes":
        sizes = SIZES
    else:
        sizes = tuple(int(n) for n in torch.randint(1, 700, (300,), generator=g))
    params = [torch.randn(n, generator=g).cuda() for n in sizes]
    if kind == "sizes":
        buf = torch.randn(4097, generator=g).cuda()
        params.append(buf[1:])  # 4 floats past a 16-byte boundary
    grads = [torch.randn(p.shape, generator=g).cuda() * 0.1 for p in params]
    mults = [(1.0, 0.5, 2.0)[i % 3] for i in range(len(params))]
    return params, grads, mults


def _copy(p):
    """A copy of `p` at p's storage offset: a misaligned leaf stays so."""
    out = torch.empty(p.numel() + p.storage_offset(), device=p.device)[p.storage_offset():]
    return out.copy_(p)


def _run(updater, params, grads, mults, l2, negate, fused):
    """Three steps from zeroed state on copies; (params, states, diags).
    The kernel's steps run under sync debug mode "error"."""
    ps = [_copy(p) for p in params]
    states = [updater.init(p) for p in ps]
    l2s = [l2 if i % 2 == 0 else 0.0 for i in range(len(ps))]
    lr, t = torch.tensor(0.05, device="cuda"), torch.tensor(0.0, device="cuda")
    loss = torch.tensor(2.5, device="cuda")
    step = fu.apply_updater if fused else fu.apply_updater_reference
    if fused:
        torch.cuda.set_sync_debug_mode("error")
    try:
        diags = [step(updater, ps, grads, states, l2s, mults, lr, t, loss, negate)
                 for _ in range(3)]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return ps, states, torch.stack(diags)


@pytest.mark.cuda
@pytest.mark.parametrize("negate", [False, True])
@pytest.mark.parametrize("l2", [0.0, 1e-3])
@pytest.mark.parametrize("kind", ["sizes", "many"])
@pytest.mark.parametrize("name", ["sgd", "nesterovs", "rmsprop"])
def test_kernel_matches_the_per_leaf_ops(name, kind, l2, negate):
    updater = make_updater(name, learning_rate=0.05)
    params, grads, mults = _leaves(kind, 7)
    ref = _run(updater, params, grads, mults, l2, negate, fused=False)
    before = fu.launch_counts()
    got = _run(updater, params, grads, mults, l2, negate, fused=True)
    after = fu.launch_counts()
    plan = fu.plan_launches(tuple(p.numel() for p in params))
    assert after["updater_apply"] - before["updater_apply"] == 3 * len(plan)
    assert after["updater_finish"] - before["updater_finish"] == 3
    if kind == "many":
        assert len(plan) > 1
    for a, b in zip(ref[0], got[0]):
        if l2 == 0.0:
            assert torch.equal(a, b)
        else:
            torch.testing.assert_close(b, a, rtol=1e-6, atol=0)
    for sa, sb in zip(ref[1], got[1]):
        for k in sa:
            if l2 == 0.0:
                assert torch.equal(sa[k], sb[k])
            else:
                torch.testing.assert_close(sb[k], sa[k], rtol=1e-6, atol=0)
    torch.testing.assert_close(got[2], ref[2], rtol=1e-6, atol=0)


class _NoOp(IterationListener):
    def iteration_done(self, model, iteration, info):
        pass


def _resnet():
    conf = tiny_resnet_conf()
    for v in conf.vertices.values():
        if hasattr(getattr(v, "layer", None), "l2"):
            v.layer.l2 = 1e-4
    return ComputationGraph(conf, device="cuda").init().set_fused_steps(2)


def _resnet_iter():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((24, 8, 8, 3)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 24)]
    return ListDataSetIterator(DataSet(x, y), 4)


def _lstm():
    net = char_lstm_network(vocab_size=12, hidden=64, tbptt_length=10,
                            learning_rate=0.01, seed=3, device="cuda")
    for layer in net.conf.layers:
        layer.l2 = 1e-3
    return net


def _truncated_lstm():
    net = _lstm()
    net.conf.tbptt_bwd_length = 4
    return net


def _lstm_iter():
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 12, (24, 41))
    eye = np.eye(12, dtype=np.float32)
    return ListDataSetIterator(DataSet(eye[ids[:, :-1]], eye[ids[:, 1:]]), 8)


# (make, iterator, optimizer steps in the fit)
NETS = {"tiny_resnet": (_resnet, _resnet_iter, 6), "tbptt_lstm": (_lstm, _lstm_iter, 12),
        "truncated_lstm": (_truncated_lstm, _lstm_iter, 12)}


def _tensors(net):
    out = []
    for tree in (net.params_list, net.upd_state, net.state_list):
        stack = [tree]
        while stack:
            t = stack.pop()
            if torch.is_tensor(t):
                out.append(t)
            elif isinstance(t, dict):
                stack.extend(t[k] for k in sorted(t))
            elif isinstance(t, (list, tuple)):
                stack.extend(t)
    return out


def _declined():
    return sum(get_registry().counter("fit_updater_declined_total", "", ("reason",))
               .labels(r).value for r in netbase.UPDATER_DECLINE_REASONS)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", sorted(NETS))
def test_graphed_fit_runs_the_kernel_and_replays_the_eager_bits(kind, monkeypatch):
    make, iterator, steps = NETS[kind]
    eager = make()
    eager.add_listener(_NoOp())  # the per-step loop, every step eager
    eager.fit(iterator(), epochs=2)
    graphed = make()
    d0, c0 = _declined(), fu.launch_counts()
    graphed.fit(iterator())  # warm-up and capture (a capture synchronizes)
    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a, **k: calls.append(a))
    graphed.fit(iterator())  # replays
    monkeypatch.undo()
    torch.cuda.synchronize()
    c1 = fu.launch_counts()
    assert calls == [] and _declined() == d0
    [g] = graphed.fit_graphs()
    assert g["replays"] >= 1
    leaves = tuple(p[k].numel() for p, ks in zip(graphed.params_list,
                                                 graphed._trainable_keys()) for k in ks)
    per_step = len(fu.plan_launches(leaves))
    assert c1["updater_apply"] - c0["updater_apply"] == 2 * steps * per_step
    assert c1["updater_finish"] - c0["updater_finish"] == 2 * steps
    assert eager.iteration == graphed.iteration
    for a, b in zip(_tensors(eager), _tensors(graphed)):
        assert torch.equal(a, b)
    assert torch.equal(eager._score, graphed._score)
    # the same fit with the per-leaf tail
    per_leaf = make()
    per_leaf._fused_tail = lambda keys, norm_keys: False
    for _ in range(2):
        per_leaf.fit(iterator())
    for a, b in zip(_tensors(per_leaf), _tensors(graphed)):
        assert (b - a).abs().max() <= 1e-5 * a.abs().max()
    torch.testing.assert_close(graphed._score, per_leaf._score, rtol=1e-5, atol=0)

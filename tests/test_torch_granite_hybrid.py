"""The Granite-4.0-H hybrid (models/granite_hybrid.py) and its new pieces on
the CPU, at a small size with seeded random weights: hidden 64, 4 SSD heads
of 16, d_state 16, chunk 16, vocabulary 97, the published pattern's 10
layers (five Mamba-2, attention at index 5, four Mamba-2), 40 tokens (not a
whole number of chunks, so the padding runs too).

- The port against the plain reference (benchmark/reference/granite4h.py,
  plain torch in f32): logits, loss, every leaf's gradient and the
  parameters after two Adam steps through `fit`.
- The SSD: the reference's chunked algorithm against the token-by-token
  recurrence in f64, the port's plain chunked SSD against the reference's,
  and the kernels' backward decomposition (`ssd_backward_plain`) against
  autograd.
- The tied leaf's gradient against the sum of its two uses, the sparse
  loss at its kinks, blocked attention against the whole softmax, the
  conf's JSON and the model zip, the fused (graph-captured on the card)
  fit against the step loop, and the parameter count at published widths.

Every tolerance is written beside its reason.
"""

import math
import os
import sys

import pytest
import torch

from deeplearning4j_tpu_torch.data import DataSet, ListDataSetIterator
from deeplearning4j_tpu_torch.models.granite_hybrid import GRANITE_4_0_H_MICRO, granite4h_conf
from deeplearning4j_tpu_torch.nn.compgraph import ComputationGraph
from deeplearning4j_tpu_torch.nn.conf import ComputationGraphConfiguration
from deeplearning4j_tpu_torch.nn.conf import layers as L
from deeplearning4j_tpu_torch.nn.layers.attention import blocked_causal_attention
from deeplearning4j_tpu_torch.ops import fused_ssd as fs
from deeplearning4j_tpu_torch.ops.losses import loss_value, tied_sparse_mcxent
from deeplearning4j_tpu_torch.train.listeners import IterationListener
from deeplearning4j_tpu_torch.utils import flops
from deeplearning4j_tpu_torch.utils.model_serializer import load_model, save_model

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
from benchmark.reference import granite4h as REF  # noqa: E402

SMALL = dict(GRANITE_4_0_H_MICRO, hidden_size=64, intermediate_size=128,
             shared_intermediate_size=128, mamba_n_heads=4, mamba_d_head=16, mamba_expand=1,
             mamba_d_state=16, mamba_chunk_size=16, num_attention_heads=4,
             num_key_value_heads=2, vocab_size=97, num_hidden_layers=10,
             learning_rate=1e-3, beta1=0.9, beta2=0.999, epsilon=1e-8)
B, T = 2, 40


@pytest.fixture(autouse=True)
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _net(precision="f32"):
    conf = granite4h_conf(SMALL, num_hidden_layers=10, learning_rate=SMALL["learning_rate"],
                          precision=precision)
    return ComputationGraph(conf, device="cpu").init()


def _leaves(net):
    return {f"{n}.{k}": v for n, d in zip(net.layer_vertex_names, net.params_list)
            for k, v in d.items()}


def _load(net, w):
    with torch.no_grad():
        for k, v in _leaves(net).items():
            v.copy_(w[k])


def _batch(seed):
    g = torch.Generator().manual_seed(seed)
    return REF.make_batch(SMALL, {"batch": B, "length": T}, g, "cpu")


def _rel(a, b):
    return float((a - b).norm() / b.norm())


@pytest.fixture(scope="module")
def twins():
    """The port's net with the reference's weights, the weights, a batch."""
    w = REF.make_weights(SMALL, 7, "cpu")
    net = _net()
    _load(net, w)
    return net, w, _batch(11)


def test_the_port_has_the_reference_leaves(twins):
    net, w, _ = twins
    live = _leaves(net)
    assert set(live) == set(w)
    assert all(live[k].shape == w[k].shape for k in w)
    assert net.num_params() == REF.num_params(SMALL)


def test_logits_and_loss_match_the_reference(twins):
    """f32 on both sides, in other orders of summation (the chunked SSD in
    two formulations, blocked against whole attention): 1e-5 relative is
    some 100 ulps of f32 over 10 layers."""
    net, w, (ids, labels) = twins
    got = net.output(ids)  # softmax of the logits
    want = torch.softmax(REF.logits(SMALL, w, ids), -1)
    assert _rel(got, want) < 1e-5
    score = net.score(DataSet(ids, labels))
    ref = float(REF.forward_loss(SMALL, w, ids, labels, None))
    assert abs(score - ref) / ref < 1e-6  # one f32 mean over 80 tokens
    assert abs(ref - math.log(97)) < 0.5  # random weights: near uniform


def test_every_leaf_gradient_matches_the_reference(twins):
    """Each leaf's gradient within 1e-4 of its norm: f32 sums in other
    orders through the backward of 10 layers (the SSD's backward is a
    different algebra on each side)."""
    net, w, (ids, labels) = twins
    leaves = _leaves(net)
    for v in leaves.values():
        v.requires_grad_(True)
    try:
        loss, _ = net._loss(net.params_list, net.state_list, [ids], [labels], None, None, None)
        g_port = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    finally:
        for v in leaves.values():
            v.requires_grad_(False)
    p = {k: v.clone().requires_grad_(True) for k, v in w.items()}
    g_ref = dict(zip(p, torch.autograd.grad(REF.forward_loss(SMALL, p, ids, labels, None),
                                            list(p.values()))))
    for k in w:
        assert _rel(g_port[k], g_ref[k]) < 1e-4, k


def test_two_adam_steps_match_the_reference(twins):
    """Two Adam steps through fit against the reference's: each leaf's
    change within 1e-3 of the change's norm. Adam divides by sqrt(v), so a
    gradient element near nought moves its parameter by up to lr whatever
    its size; the f32 gradients agree to 1e-4 (above), which bounds the
    rest."""
    _, w, (ids, labels) = twins
    ids2, labels2 = _batch(12)
    net = _net()
    _load(net, w)
    net.fit(ListDataSetIterator(DataSet(torch.cat([ids, ids2]), torch.cat([labels, labels2])),
                                B), async_prefetch=False)
    assert net.iteration == 2
    losses, p, state, _ = REF.train_steps(SMALL, w, [(ids, labels), (ids2, labels2)])
    for k, v in _leaves(net).items():
        assert _rel(v - w[k], p[k] - w[k]) < 1e-3, k
        m, s = net.upd_state[net.layer_vertex_names.index(k.split(".")[0])][k.split(".")[1]].values()
        assert _rel(m, state[k][0]) < 1e-3, k
    assert float(state["_t"]) == 2.0


def _recurrence(x, dt, A, Bm, Cm, D):
    """The published recurrence token by token: h_t = exp(dt_t A) h_{t-1} +
    dt_t x_t B_t^T, y_t = h_t C_t + D x_t (B, C shared by a group's heads)."""
    b, t_, H, P = x.shape
    rep = H // Bm.shape[2]
    h = x.new_zeros(b, H, P, Bm.shape[3])
    ys = []
    for t in range(t_):
        Bt, Ct = Bm[:, t].repeat_interleave(rep, 1), Cm[:, t].repeat_interleave(rep, 1)
        h = (torch.exp(dt[:, t] * A)[..., None, None] * h
             + (dt[:, t, :, None, None] * x[:, t, :, :, None] * Bt[:, :, None, :]))
        ys.append(torch.einsum("bhpn,bhn->bhp", h, Ct) + D[:, None] * x[:, t])
    return torch.stack(ys, 1)


def _ssd_inputs(seed, b=2, t=48, H=4, P=8, G=2, N=16, dtype=torch.float64):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(b, t, H, P, generator=g, dtype=dtype)
    dt = torch.nn.functional.softplus(torch.randn(b, t, H, generator=g, dtype=dtype) - 1.0)
    A = -torch.exp(torch.rand(H, generator=g, dtype=dtype) * 2.7)
    Bm = torch.randn(b, t, G, N, generator=g, dtype=dtype)
    Cm = torch.randn(b, t, G, N, generator=g, dtype=dtype)
    D = torch.randn(H, generator=g, dtype=dtype)
    return x, dt, A, Bm, Cm, D


def test_the_reference_ssd_is_the_recurrence():
    """f64: the chunked algebra is exact, so 1e-12 relative is rounding."""
    x, dt, A, Bm, Cm, D = _ssd_inputs(1)
    rep = x.shape[2] // Bm.shape[2]
    y = REF.ssd_minimal(x * dt[..., None], A * dt, Bm.repeat_interleave(rep, 2),
                        Cm.repeat_interleave(rep, 2), 16) + D[:, None] * x
    assert _rel(y, _recurrence(x, dt, A, Bm, Cm, D)) < 1e-12


@pytest.mark.parametrize("t", [48, 40])
def test_the_port_ssd_is_the_reference_ssd(t):
    """f64, both the chunked algebra, the port's padded to whole chunks:
    1e-12 relative is rounding."""
    x, dt, A, Bm, Cm, D = _ssd_inputs(2, t=t)
    assert _rel(fs.ssd_chunked(x, dt, A, Bm, Cm, D, 16), _recurrence(x, dt, A, Bm, Cm, D)) < 1e-12


def test_the_kernels_backward_decomposition_is_autograd():
    """The terms the backward kernels compute (ssd_backward_plain), carried
    to dt and A as autograd carries l's gradient, against autograd of the
    plain version, f64: 1e-10 relative is rounding."""
    x, dt, A, Bm, Cm, D = _ssd_inputs(3)
    ins = [v.clone().requires_grad_(True) for v in (x, dt, A, Bm, Cm, D)]
    y = fs.ssd_chunked(*ins, 16)
    dy = torch.randn_like(y)
    want = torch.autograd.grad((y * dy).sum(), ins)
    l = fs.chunk_decay(dt, A, 16)
    dx, ddt, dl, dB, dC, dD = fs.ssd_backward_plain(x, dt, l, Bm, Cm, D, dy, 16)
    b, t_, H = dt.shape
    dlc = dl.view(b, t_ // 16, 16, H)
    cs = dlc.cumsum(2)
    da = (cs[:, :, -1:] - cs + dlc).reshape(b, t_, H)  # sum of dl over t >= s
    got = (dx, ddt + da * A, (da * dt).sum((0, 1)), dB, dC, dD)
    for name, a, w in zip(("dx", "ddt", "dA", "dB", "dC", "dD"), got, want):
        assert _rel(a, w) < 1e-10, name


def test_blocked_attention_is_the_whole_softmax():
    g = torch.Generator().manual_seed(4)
    q, k, v = (torch.randn(2, 3, 37, 8, generator=g, dtype=torch.float64) for _ in range(3))
    s = (q @ k.transpose(-1, -2)) * 0.3
    s = s.masked_fill(torch.ones(37, 37, dtype=torch.bool).triu(1), float("-inf"))
    want = torch.softmax(s, -1) @ v
    assert _rel(blocked_causal_attention(q, k, v, 0.3, block=8), want) < 1e-13  # f64 rounding


def test_the_tied_leaf_takes_both_uses_gradient(twins):
    """One leaf for the embedding and the head: its gradient is the sum of
    the gradients of two untied copies (the same sums: 1e-6 relative)."""
    net, w, (ids, labels) = twins
    emb = net._pidx["embed"]
    W = net.params_list[emb]["W"]
    W.requires_grad_(True)
    try:
        loss, _ = net._loss(net.params_list, net.state_list, [ids], [labels], None, None, None)
        (g_tied,) = torch.autograd.grad(loss, [W])
    finally:
        W.requires_grad_(False)
    # untied: the embedding reads W1, the head's loss W2
    W1, W2 = W.clone().requires_grad_(True), W.clone().requires_grad_(True)
    params = list(net.params_list)
    params[emb] = {"W": W1}
    acts, _ = net._forward(params, net.state_list, [ids], training=True, rng=None,
                           preout_outputs=True)
    head_conf = net.conf.vertices["lm_head"].layer
    loss = tied_sparse_mcxent(acts["lm_head__features"], W2, labels,
                              1.0 / head_conf.logits_scaling).mean()
    g1, g2 = torch.autograd.grad(loss, [W1, W2])
    assert g1.norm() > 0 and g2.norm() > 0
    assert _rel(g_tied, g1 + g2) < 1e-6


@pytest.mark.parametrize("case", ["max", "equal"])
def test_sparse_loss_at_its_kinks(case):
    """The tied head's sparse loss (identity table, so the logits are x)
    and its gradient against the one-hot mcxent with the label at the
    largest logit, and at equal logits (gradient 1/V - onehot): the same
    log-softmax, 1e-6."""
    V = 11
    g = torch.Generator().manual_seed(5)
    z = (torch.randn(2, 3, V, generator=g) if case == "max" else torch.zeros(2, 3, V))
    ids = z.argmax(-1) if case == "max" else torch.tensor([[0, 5, 10], [3, 3, 7]])
    za, zb = z.clone().requires_grad_(True), z.clone().requires_grad_(True)
    sparse = tied_sparse_mcxent(za, torch.eye(V), ids, 1.0, chunk=4)
    dense = loss_value("mcxent", torch.nn.functional.one_hot(ids, V).float(), zb, "softmax") / 3
    assert torch.allclose(sparse, dense, rtol=1e-6, atol=1e-7)
    ga, = torch.autograd.grad(sparse.mean(), za)
    gb, = torch.autograd.grad(dense.mean(), zb)
    assert torch.allclose(ga, gb, rtol=1e-6, atol=1e-8)
    if case == "equal":
        want = (1.0 / V - torch.nn.functional.one_hot(ids, V).float()) / 6
        assert torch.allclose(ga, want, atol=1e-8)


def test_the_tied_head_loss_in_chunks_is_the_whole_loss():
    """The tied head's chunked loss (chunks of 7 of 40 tokens, the backward
    forming each chunk's logits again) against mcxent of the whole logits
    with one-hot labels, value and gradients: the same f32 sums, 1e-6."""
    g = torch.Generator().manual_seed(6)
    x = torch.randn(2, 20, 8, generator=g)
    W = torch.randn(13, 8, generator=g)
    ids = torch.randint(0, 13, (2, 20), generator=g)
    xa, Wa = x.clone().requires_grad_(True), W.clone().requires_grad_(True)
    xb, Wb = x.clone().requires_grad_(True), W.clone().requires_grad_(True)
    a = tied_sparse_mcxent(xa, Wa, ids, 0.125, chunk=7)
    b = loss_value("mcxent", torch.nn.functional.one_hot(ids, 13).float(),
                   (xb * 0.125) @ Wb.T, "softmax") / 20
    assert torch.allclose(a, b, rtol=1e-6)
    ga = torch.autograd.grad(a.sum(), [xa, Wa])
    gb = torch.autograd.grad(b.sum(), [xb, Wb])
    for u, v in zip(ga, gb):
        assert torch.allclose(u, v, rtol=1e-5, atol=1e-7)


def test_conf_json_and_model_zip_round_trip(twins, tmp_path):
    net, w, (ids, _) = twins
    conf = net.conf
    back = ComputationGraphConfiguration.from_json(conf.to_json())
    assert back.to_json() == conf.to_json()
    kinds = {type(v.layer) for v in back.vertices.values() if hasattr(v, "layer")}
    assert {L.SequenceEmbeddingLayer, L.RMSNormLayer, L.Mamba2Layer,
            L.GroupedQueryAttentionLayer, L.GatedMLPLayer, L.TiedOutputLayer} <= kinds
    path = str(tmp_path / "g.zip")
    save_model(net, path)
    other = load_model(path, device="cpu")
    for k, v in _leaves(other).items():
        assert torch.equal(v, _leaves(net)[k]), k
    assert torch.equal(other.output(ids), net.output(ids))


class _Scores(IterationListener):
    def __init__(self):
        self.scores = []

    def iteration_done(self, net, iteration, info):
        self.scores.append(float(info["score"]()))


def test_the_fused_fit_is_the_step_loop():
    """set_fused_steps(2) (one CUDA graph of two steps on the card) is, on
    the CPU, the loop of the same steps: bit-equal to the per-step fit."""
    data = DataSet(*(torch.cat(t) for t in zip(_batch(21), _batch(22))))
    a, b = _net(), _net()
    a.set_fused_steps(2)
    a.fit(ListDataSetIterator(data, B), async_prefetch=False)
    assert any(k[0] == "std" and k[2] == 2 for k in a._programs)
    listener = _Scores()
    b.set_listeners(listener)
    b.fit(ListDataSetIterator(data, B), async_prefetch=False)
    assert [float(s) for s in a._fused_scores] == listener.scores
    for k, v in _leaves(a).items():
        assert torch.equal(v, _leaves(b)[k]), k


def test_bf16_policy_keeps_token_ids_exact():
    """Under the bf16 policy the ids stay integers (a bf16 id is not exact
    past 256): an id of 95 and 96 pick their own rows."""
    net = _net("bf16")
    ids = torch.tensor([[95, 96, 1, 2]])
    x = net._cast_inputs([ids])[0]
    assert x.dtype == torch.int64
    acts = net.feed_forward(ids)
    W = net.params_list[net._pidx["embed"]]["W"]
    assert torch.equal(acts["embed"][0, :2], W[[95, 96]].to(torch.bfloat16))


def test_published_widths_count_951991232_parameters():
    """The 10-layer cut at the published widths, counted from each layer's
    parameter shapes (the port's init gives these shapes at the small
    size above); the reference counts the same."""
    conf = granite4h_conf(num_hidden_layers=10)
    small = _net()
    shapes = {}
    for name in small.layer_vertex_names:
        lc = conf.vertices[name].layer
        n = lc.n_in
        if isinstance(lc, L.SequenceEmbeddingLayer):
            shapes[name] = lc.n_in * lc.n_out
        elif isinstance(lc, L.RMSNormLayer):
            shapes[name] = n
        elif isinstance(lc, L.GatedMLPLayer):
            shapes[name] = 3 * n * lc.hidden_size
        elif isinstance(lc, L.GroupedQueryAttentionLayer):
            shapes[name] = 2 * n * (lc.n_heads + lc.n_kv_heads) * lc.head_dim
        elif isinstance(lc, L.Mamba2Layer):
            inner = lc.n_heads * lc.head_dim
            conv = inner + 2 * lc.n_groups * lc.d_state
            shapes[name] = (n * (inner + conv + lc.n_heads) + conv * (lc.d_conv + 1)
                            + 3 * lc.n_heads + inner + inner * n)
        else:
            shapes[name] = 0
        sl = small.conf.vertices[name].layer
        got = sum(v.numel() for v in small.params_list[small._pidx[name]].values())
        # the same formula at the small size is what the port's init draws
        if isinstance(sl, L.Mamba2Layer):
            inner = sl.n_heads * sl.head_dim
            conv = inner + 2 * sl.n_groups * sl.d_state
            assert got == (sl.n_in * (inner + conv + sl.n_heads) + conv * (sl.d_conv + 1)
                           + 3 * sl.n_heads + inner + inner * sl.n_in)
    assert sum(shapes.values()) == 951_991_232
    assert REF.num_params(dict(GRANITE_4_0_H_MICRO, num_hidden_layers=10)) == 951_991_232
    kinds = [type(conf.vertices[f"l{i}_mixer"].layer).__name__ for i in range(10)]
    assert kinds == ["Mamba2Layer"] * 5 + ["GroupedQueryAttentionLayer"] + ["Mamba2Layer"] * 4


def test_the_flop_estimate_prices_the_decoder_layers():
    """utils/flops.py's walk of the 10-layer cut at 16,384 tokens gives the
    reference's 1.999 GFLOP a token (the same terms summed in another
    order: 1e-12), three times that a step: 9.826e13 for the sequence."""
    conf = granite4h_conf(num_hidden_layers=10, seq_len=16384)
    fwd = flops.forward_flops(conf)
    want = REF.forward_flops_per_sample(dict(GRANITE_4_0_H_MICRO, num_hidden_layers=10)) * 16384
    assert abs(fwd - want) / want < 1e-12
    step, source = flops.analytic_step_flops_per_example(conf)
    assert source == "analytic" and step == 3.0 * fwd
    assert abs(step - 9.8264e13) / 9.8264e13 < 1e-3

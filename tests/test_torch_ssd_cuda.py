"""The SSD chunked-scan kernels (csrc/ssd_scan.cu behind ops/fused_ssd.py)
on a Hopper GPU (`cuda` marker; each test skips itself without one).

- Forward and backward against the plain chunked version (`ssd_chunked`
  in f32 on the same bf16 inputs and the same bf16 output gradient,
  differentiated by autograd) at small shapes, a ragged length and the
  published shapes (64 heads of 64, state 128, one group, chunk 256,
  16,384 tokens). Tolerance: 1e-2 of each output's norm. The kernels'
  products take bf16 operands (x, B, C, and the intra-chunk scores, the
  incoming state and its gradient rounded to bf16 before each product,
  2^-9 relative each) against the plain version's f32 throughout: 2e-3 to
  4e-3 measured; a missing or wrong term is of the order of the output
  itself. dA is a sum over every token of a head whose terms cancel
  (a few hundred at the small shapes): its error is held to 1e-2 of the
  sum of its terms' magnitudes (the plain version's gradient of a
  per-token A), as a sum is, not to 1e-2 of its own size.
- A forward and backward captured in a CUDA graph and replayed: bit-equal
  to the eager run (no atomics; fixed orders of summation), the capture's
  launches recorded in its tally and none counted.
- Launch counts: 3 forward, 4 backward.
- What the kernels do not take raises (f32 operands, a head width that is
  not a power of two, one above 64).
- A graphed fit of a small Granite net (set_fused_steps(2)): each replay
  adds the launches its capture recorded, 7 a Mamba-2 layer and step.

This file imports nothing of JAX: `python -m pytest --noconftest
tests/test_torch_ssd_cuda.py` runs it where JAX is not installed.
"""

import pytest
import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.ops import fused_ssd as fs

TOL = 1e-2


@pytest.fixture(autouse=True)
def _card():
    if not (torch.cuda.is_available()
            and torch.cuda.get_device_capability() >= (9, 0)):
        pytest.skip("needs an NVIDIA GPU of compute capability >= 9.0")
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = old


def _inputs(B, T, H, P, G, N, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(B, T, H, P, device="cuda", generator=g).bfloat16()
    dt = torch.nn.functional.softplus(torch.randn(B, T, H, device="cuda", generator=g) - 3.0)
    A = -torch.exp(torch.rand(H, device="cuda", generator=g) * 2.7)
    Bm = torch.randn(B, T, G, N, device="cuda", generator=g).bfloat16()
    Cm = torch.randn(B, T, G, N, device="cuda", generator=g).bfloat16()
    D = torch.randn(H, device="cuda", generator=g)
    return x, dt, A, Bm, Cm, D


def _rel(a, b):
    return float((a.float() - b.float()).norm() / b.float().norm())


def _dA_terms(ins, dy, Q):
    """The terms of dA: the plain version's gradient of a per-token A
    [B, T, H], on inputs padded to whole chunks (a padded step has dt 0
    and no term)."""
    x, dt, A, Bm, Cm, D = (t.float() for t in ins)
    pad = (-x.shape[1]) % Q
    x, dt, Bm, Cm, dy = (F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))
                         for t in (x, dt, Bm, Cm, dy))
    a_tok = A.expand(*dt.shape).clone().requires_grad_(True)
    terms, = torch.autograd.grad((fs.ssd_chunked(x, dt, a_tok, Bm, Cm, D, Q) * dy).sum(),
                                 a_tok)
    return terms


SHAPES = {"small": (2, 64, 4, 16, 2, 16, 16), "ragged": (1, 50, 4, 16, 1, 16, 16),
          "two_chunks": (1, 512, 8, 64, 1, 128, 256),
          "published": (1, 16384, 64, 64, 1, 128, 256)}


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(SHAPES))
def test_kernels_match_the_plain_version(name):
    B, T, H, P, G, N, Q = SHAPES[name]
    ins = _inputs(B, T, H, P, G, N)
    k = [t.clone().requires_grad_(True) for t in ins]
    p = [t.clone().float().requires_grad_(True) for t in ins]
    fs.reset_launch_counts()
    yk = fs.ssd_scan(*k, Q)
    yp = fs.ssd_chunked(*p, Q)
    assert yk.dtype == torch.bfloat16 and yk.shape == (B, T, H, P)
    assert _rel(yk, yp) < TOL
    g = torch.Generator(device="cuda").manual_seed(1)
    dy = torch.randn(yp.shape, device="cuda", generator=g).bfloat16().float()
    gk = torch.autograd.grad((yk.float() * dy).sum(), k)
    gp = torch.autograd.grad((yp * dy).sum(), p)
    terms = _dA_terms(ins, dy, Q)
    torch.cuda.synchronize()
    for what, a, b in zip(("dx", "ddt", "dA", "dB", "dC", "dD"), gk, gp):
        assert torch.isfinite(a).all(), what
        if what == "dA":
            err = ((a - b).abs() / terms.abs().sum((0, 1))).max()
            assert err < TOL, (what, float(err), _rel(a, b))
        else:
            assert _rel(a, b) < TOL, (what, _rel(a, b))
    counts = fs.launch_counts()
    assert [counts[n] for n in fs.KERNELS] == [1] * 7


@pytest.mark.cuda
def test_a_captured_scan_replays_bit_equal():
    ins = _inputs(1, 512, 8, 64, 1, 128)
    leaves = [t.clone().requires_grad_(True) for t in ins]
    dy = torch.randn(1, 512, 8, 64, device="cuda")

    def run():
        y = fs.ssd_scan(*leaves, 256)
        return (y,) + torch.autograd.grad((y.float() * dy).sum(), leaves)

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        eager = [t.clone() for t in run()]
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    fs.reset_launch_counts()
    graph = torch.cuda.CUDAGraph()
    with fs.recording_launches(side) as tally, \
            torch.cuda.graph(graph, stream=side, capture_error_mode="thread_local"):
        out = run()
    assert tally == {n: 1 for n in fs.KERNELS}
    assert sum(fs.launch_counts().values()) == 0
    for _ in range(2):
        graph.replay()
    torch.cuda.synchronize()
    for a, b in zip(out, eager):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_what_the_kernels_do_not_take_raises():
    x, dt, A, Bm, Cm, D = _inputs(1, 64, 4, 16, 1, 16)
    with pytest.raises(ValueError, match="take bf16"):
        fs.ssd_scan(x.float(), dt, A, Bm.float(), Cm.float(), D, 16)
    with pytest.raises(ValueError, match="power of two"):
        fs.ssd_scan(x[..., :12].contiguous(), dt, A, Bm, Cm, D, 16)
    wide = torch.cat([x] * 8, -1)
    with pytest.raises(ValueError, match="<= 64"):
        fs.ssd_scan(wide, dt, A, Bm, Cm, D, 16)


@pytest.mark.cuda
def test_a_graphed_granite_fit_counts_its_replayed_launches():
    from deeplearning4j_tpu_torch.data import DataSet, ListDataSetIterator
    from deeplearning4j_tpu_torch.models.granite_hybrid import (GRANITE_4_0_H_MICRO,
                                                                 granite4h_network)

    cfg = dict(GRANITE_4_0_H_MICRO, hidden_size=64, shared_intermediate_size=128,
               mamba_n_heads=4, mamba_d_head=16, mamba_expand=1, mamba_d_state=16,
               mamba_chunk_size=16, num_attention_heads=4, num_key_value_heads=2,
               vocab_size=97)
    net = granite4h_network(cfg, num_hidden_layers=10, device="cuda")
    net.set_fused_steps(2)
    g = torch.Generator().manual_seed(3)
    ids = torch.randint(0, 97, (8, 41), generator=g)
    data = DataSet(ids[:, :-1], ids[:, 1:])
    net.fit(ListDataSetIterator(data, 2), async_prefetch=False)  # warm-up, capture + replay
    fs.reset_launch_counts()
    net.fit(ListDataSetIterator(data, 2), async_prefetch=False)  # two replays
    torch.cuda.synchronize()
    graphs = net.fit_graphs()
    assert len(graphs) == 1 and graphs[0]["replays"] == 3
    # 9 Mamba-2 layers, 2 steps a replay, 2 replays
    assert fs.launch_counts() == {n: 9 * 2 * 2 for n in fs.KERNELS}
    assert all(torch.isfinite(s) for s in net._fused_scores)

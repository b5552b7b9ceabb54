"""Sequence (context) parallelism: ring attention over a mesh axis.

The port of the JAX package's parallel/sequence.py. The sequence axis is
split over the "seq" axis of a mesh and attention runs as a RING: each
rank keeps its query block and passes its key/value block around the axis
with `ppermute`, accumulating attention with the online-softmax
(flash-style) update, so the full [T, T] score matrix never exists. After
p hops every query block has attended to every key/value block (Ring
Attention, Liu et al.; blockwise streaming softmax, Rabe & Staats).

The products are `torch.einsum` on operands promoted to at least f32, the
JAX module's `preferred_element_type` accumulation: bf16 inputs are exact
in f32, so the softmax statistics and the weighted sums accumulate in f32
across hops. The JAX module computes them with XLA ops, not a Pallas
kernel, and so does this one.
"""

from __future__ import annotations

import torch

from deeplearning4j_tpu_torch.parallel.mesh import Mesh, all_gather, copy_to_axis, ppermute

SEQ_AXIS = "seq"


def _acc_dtype(dtype):
    return torch.promote_types(dtype, torch.float32)


def _block_attend(q, k, v, *, scale, causal, q_start, kv_start):
    """Scores of one (q-block, kv-block) pair and its unnormalized
    streaming statistics. q: [B, Tq, H, D]; k, v: [B, Tk, H, D]. Returns
    (m, l, o): running max [B, H, Tq], sum-exp [B, H, Tq], weighted values
    [B, Tq, H, D], in at least f32."""
    acc = _acc_dtype(q.dtype)
    s = torch.einsum("bqhd,bkhd->bhqk", q.to(acc), k.to(acc)) * scale
    if causal:
        Tq, Tk = q.shape[1], k.shape[1]
        qpos = q_start + torch.arange(Tq, device=q.device)[:, None]
        kpos = kv_start + torch.arange(Tk, device=q.device)[None, :]
        s = torch.where(qpos >= kpos, s, torch.full_like(s, -torch.inf))
    m = s.amax(dim=-1)
    # a fully masked row (causal, the kv block entirely in the future) has
    # max -inf; exp(-inf - -inf) would be NaN — clamp those rows
    m_safe = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(s - m_safe[..., None])
    p = torch.where(torch.isfinite(s), p, torch.zeros_like(p))
    l = p.sum(dim=-1)
    # p rounded to v's dtype, as the JAX module's p.astype(v.dtype)
    o = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).to(acc), v.to(acc))
    return m_safe, l, o


def _merge(acc, new):
    """Online-softmax merge of two partial attention states."""
    m_a, l_a, o_a = acc
    m_n, l_n, o_n = new
    m = torch.maximum(m_a, m_n)
    ca = torch.exp(m_a - m)
    cn = torch.exp(m_n - m)
    l = l_a * ca + l_n * cn
    o = o_a * ca.movedim(1, -1)[..., None] + o_n * cn.movedim(1, -1)[..., None]
    return m, l, o


def ring_attention_sharded(q, k, v, *, mesh: Mesh, axis_name: str = SEQ_AXIS,
                           causal: bool = False):
    """q, k, v: this rank's sequence blocks [B, T_local, H, D]; the kv
    block rotates around `axis_name`. Rank i keeps its queries; at hop s
    it holds kv block (i - s) mod p. The result equals full attention over
    the gathered sequence up to float reassociation. Returns this rank's
    output block."""
    p = mesh.axis_size(axis_name)
    idx = mesh.axis_index(axis_name)
    t_local = q.shape[1]
    acc_dt = _acc_dtype(q.dtype)
    scale = torch.tensor(float(q.shape[-1]), dtype=acc_dt).sqrt() ** -1
    q_start = idx * t_local
    B, T, H, D = q.shape
    acc = (torch.full((B, H, T), -torch.inf, dtype=acc_dt, device=q.device),
           torch.zeros((B, H, T), dtype=acc_dt, device=q.device),
           torch.zeros((B, T, H, D), dtype=acc_dt, device=q.device))
    perm = [(j, (j + 1) % p) for j in range(p)]
    k_cur, v_cur = k, v
    for s in range(p):
        kv_owner = (idx - s) % p  # whose block this rank holds now
        new = _block_attend(q, k_cur, v_cur, scale=scale, causal=causal,
                            q_start=q_start, kv_start=kv_owner * t_local)
        acc = _merge(acc, new)
        if s < p - 1:  # after the last hop kv is never read again
            k_cur = ppermute(k_cur, mesh, axis_name, perm)
            v_cur = ppermute(v_cur, mesh, axis_name, perm)
    m, l, o = acc
    l = torch.clamp_min(l, 1e-20)
    return (o / l.movedim(1, -1)[..., None]).to(q.dtype)


def full_attention(q, k, v, *, causal: bool = False):
    """Single-process reference: softmax attention over [B, T, H, D]
    inputs, head-batched, statistics in at least f32."""
    acc = _acc_dtype(q.dtype)
    scale = torch.tensor(float(q.shape[-1]), dtype=acc).sqrt() ** -1
    s = torch.einsum("bqhd,bkhd->bhqk", q.to(acc), k.to(acc)) * scale
    if causal:
        T = q.shape[1]
        mask = torch.tril(torch.ones((T, T), dtype=torch.bool, device=q.device))
        s = torch.where(mask, s, torch.full_like(s, -torch.inf))
    a = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", a.to(v.dtype).to(acc), v.to(acc))
    return out.to(q.dtype)


def ring_self_attention(x, wq, wk, wv, wo, *, mesh: Mesh, n_heads: int,
                        causal: bool = False, axis_name: str = SEQ_AXIS):
    """Sequence-parallel multi-head self-attention over a mesh.

    x: [B, T, E], the same on every rank, T divisible by the axis size.
    Each rank projects its own block (no communication); only the k/v
    blocks travel the ring; the output blocks are gathered, so every rank
    returns the whole [B, T, E]. x and the weights enter through
    `copy_to_axis`: each rank uses its block of them, and their gradients
    are collected from every rank, as shard_map's transpose of its
    replicated inputs gives them."""
    p = mesh.axis_size(axis_name)
    i = mesh.axis_index(axis_name)
    B, T, E = x.shape
    if T % p:
        raise ValueError(f"sequence length {T} does not split over {p} ranks")
    D = E // n_heads
    Tl = T // p
    x, wq, wk, wv, wo = (copy_to_axis(a, mesh, axis_name) for a in (x, wq, wk, wv, wo))
    xb = x[:, i * Tl:(i + 1) * Tl]
    q = (xb @ wq).reshape(B, Tl, n_heads, D)
    k = (xb @ wk).reshape(B, Tl, n_heads, D)
    v = (xb @ wv).reshape(B, Tl, n_heads, D)
    o = ring_attention_sharded(q, k, v, mesh=mesh, axis_name=axis_name, causal=causal)
    out = o.reshape(B, Tl, E) @ wo
    # gather the blocks on the sequence dim (all_gather concatenates dim 0)
    return all_gather(out.transpose(0, 1).contiguous(), mesh, axis_name).transpose(0, 1)

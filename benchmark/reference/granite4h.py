"""Plain PyTorch Granite-4.0-H (model_type `granitemoehybrid`): the
reference the Granite cells are judged by.

The published layer equations (Hugging Face's GraniteMoeHybridForCausalLM
for the config's keys; Mamba-2 after Dao & Gu, arXiv:2405.21060, §6 and its
minimal SSD listing):

    h = E[ids] * embedding_multiplier
    per layer:  h = h + residual_multiplier * mixer(rmsnorm(h))
                h = h + residual_multiplier * mlp(rmsnorm(h))
    logits = rmsnorm(h) E^T / logits_scaling       (tied embedding E)
    loss = mean over the batch's tokens of -log softmax(logits)[label]

- rmsnorm(x) = x / sqrt(mean(x^2) + rms_norm_eps) * gamma;
- mlp(x) = (silu(x W_in[:, :I]) * x W_in[:, I:]) W_out, I the
  shared_intermediate_size, no bias;
- attention (layer_types "attention"): q = x Wq in num_attention_heads
  heads of hidden / heads, k = x Wk and v = x Wv in num_key_value_heads
  heads, each shared by heads / kv_heads query heads, softmax(q k^T *
  attention_multiplier) causal, no position encoding ("nope"), then Wo;
- Mamba-2 (layer_types "mamba"): [z | xBC | dt] = x W_in; xBC = silu(
  depthwise causal conv1d of width mamba_d_conv with bias); [xs | B | C] =
  xBC with mamba_n_groups groups of B and C; dt = softplus(dt + dt_bias);
  A = -exp(A_log); y = SSD(xs, dt, A, B, C) + D xs; out = rmsnorm(y *
  silu(z)) * norm_gamma @ W_out. The SSD is the paper's chunked algorithm
  (`ssd_minimal`) over mamba_chunk_size steps, in f32.

Training: Adam (Kingma & Ba) with the bias correction counted from 1,
m = b1 m + (1 - b1) g, v = b2 v + (1 - b2) g^2, step -lr m_hat /
(sqrt(v_hat) + eps), as DL4J's Adam.

Departures from the published description, none of which changes the
function: attention is computed in blocks of queries, each block under
its own checkpoint, and never as a [T, T] tensor; every half-layer runs
under torch.utils.checkpoint and the loss is taken in sequence chunks,
each under a checkpoint, so that the reference fits on the card beside
nothing else; the logits' division by logits_scaling (a power of two) is
applied to the features before the product, which is exact.

Layouts: linear weights [in, out]; the embedding [vocab, hidden]; the conv
weight [channels, width]. Leaves are named "<vertex>.<param>" after the
port's graph (models/granite_hybrid.py) so that the two can be compared
leaf by leaf: "embed.W", "l<i>_mixer_norm.gamma", "l<i>_mixer.<param>",
"l<i>_mlp_norm.gamma", "l<i>_mlp.W_in", "l<i>_mlp.W_out", "final_norm.gamma".

Float32 with TF32 off (precision.exact_f32). Imports torch only. Token ids
arrive as float32 (exact below 2^24) and are cast back to int64.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

ATTN_BLOCK = 1024     # queries an attention block takes
LOSS_CHUNK = 2048     # tokens a chunk of the loss takes


def layer_types(cfg) -> List[str]:
    return list(cfg["layer_types"])[: int(cfg["num_hidden_layers"])]


def _mamba_widths(cfg):
    inner = int(cfg["mamba_n_heads"]) * int(cfg["mamba_d_head"])
    conv = inner + 2 * int(cfg["mamba_n_groups"]) * int(cfg["mamba_d_state"])
    return inner, conv, inner + conv + int(cfg["mamba_n_heads"])


def leaf_shapes(cfg) -> Dict[str, tuple]:
    hdim, vocab = int(cfg["hidden_size"]), int(cfg["vocab_size"])
    inter = int(cfg["shared_intermediate_size"])
    out = {"embed.W": (vocab, hdim)}
    for i, kind in enumerate(layer_types(cfg)):
        out[f"l{i}_mixer_norm.gamma"] = (hdim,)
        m = f"l{i}_mixer."
        if kind == "mamba":
            inner, conv, proj = _mamba_widths(cfg)
            H = int(cfg["mamba_n_heads"])
            out.update({m + "W_in": (hdim, proj), m + "conv_W": (conv, int(cfg["mamba_d_conv"])),
                        m + "conv_b": (conv,), m + "dt_bias": (H,), m + "A_log": (H,),
                        m + "D": (H,), m + "norm_gamma": (inner,), m + "W_out": (inner, hdim)})
        else:
            hq, hkv = int(cfg["num_attention_heads"]), int(cfg["num_key_value_heads"])
            d = hdim // hq
            out.update({m + "Wq": (hdim, hq * d), m + "Wk": (hdim, hkv * d),
                        m + "Wv": (hdim, hkv * d), m + "Wo": (hq * d, hdim)})
        out[f"l{i}_mlp_norm.gamma"] = (hdim,)
        out[f"l{i}_mlp.W_in"] = (hdim, 2 * inter)
        out[f"l{i}_mlp.W_out"] = (inter, hdim)
    out["final_norm.gamma"] = (hdim,)
    return out


def num_params(cfg) -> int:
    return sum(math.prod(s) for s in leaf_shapes(cfg).values())


def make_weights(cfg, seed: int, device) -> Dict[str, torch.Tensor]:
    """Every parameter from `seed`, on `device`, float32: the embedding
    and every linear N(0, 0.02^2) (Granite's initializer_range); the RMSNorm
    gains 1; Mamba-2's own defaults (mamba_ssm): the conv's weight and bias
    uniform in +-1/sqrt(width), A = U(1, 16) as A_log, dt = exp(U(log 1e-3,
    log 1e-1)) as its softplus inverse dt_bias, D = 1. One draw of normals
    and one of uniforms."""
    shapes = leaf_shapes(cfg)
    g = torch.Generator(device=device).manual_seed(int(seed))
    normal = [n for n, s in shapes.items() if n.split(".")[1] in ("W", "W_in", "W_out", "Wq",
                                                                  "Wk", "Wv", "Wo")]
    uniform = [n for n, s in shapes.items() if n.split(".")[1] in ("conv_W", "conv_b",
                                                                   "dt_bias", "A_log")]
    out = {}
    flat = torch.randn(sum(math.prod(shapes[n]) for n in normal), generator=g,
                       device=device, dtype=torch.float32)
    off = 0
    for n in normal:
        k = math.prod(shapes[n])
        out[n] = (0.02 * flat[off:off + k]).view(shapes[n])
        off += k
    del flat
    flat = torch.rand(sum(math.prod(shapes[n]) for n in uniform), generator=g,
                      device=device, dtype=torch.float32)
    off = 0
    bound = 1.0 / math.sqrt(int(cfg["mamba_d_conv"]))
    for n in uniform:
        k = math.prod(shapes[n])
        u = flat[off:off + k].view(shapes[n])
        off += k
        kind = n.split(".")[1]
        if kind in ("conv_W", "conv_b"):
            out[n] = (2.0 * u - 1.0) * bound
        elif kind == "A_log":
            out[n] = torch.log(1.0 + 15.0 * u)
        else:
            dt = torch.exp(math.log(1e-3) + u * (math.log(1e-1) - math.log(1e-3)))
            dt = dt.clamp_min(1e-4)
            out[n] = dt + torch.log(-torch.expm1(-dt))
    for n, s in shapes.items():
        if n not in out:
            out[n] = torch.ones(s, device=device, dtype=torch.float32)
    return {n: out[n].contiguous() for n in shapes}


def samples_per_batch(cfg, traffic) -> int:
    """Tokens a batch: rows x length."""
    return int(traffic["batch"]) * int(traffic["length"])


def units_per_batch(cfg, traffic) -> List[dict]:
    """One optimizer step a batch, over `batch` sequences of `length`."""
    return [{"phase": "train", "batch": int(traffic["batch"]), "length": int(traffic["length"])}]


def forward_flops_per_sample(cfg, length: int = None) -> float:
    """Forward FLOPs of one token at sequence length `length` (the cell's
    16,384 by default): 2 x the multiply-adds of every projection, the
    SSD's (Q + 1)(N G/H + P) + 4NP a head (Q the chunk, N the state, P the
    head width, G groups of H heads: the causal half of the intra-chunk
    square, C B^T once a group), attention's q k^T and
    p v over (T + 1) / 2 keys on average (causal), and the tied head. The
    conv, norms, gates and softmax are left out."""
    T = int(length or cfg.get("seq_len", 16384))
    hdim, vocab = int(cfg["hidden_size"]), int(cfg["vocab_size"])
    inter = int(cfg["shared_intermediate_size"])
    inner, conv, proj = _mamba_widths(cfg)
    H, P = int(cfg["mamba_n_heads"]), int(cfg["mamba_d_head"])
    N, Q = int(cfg["mamba_d_state"]), min(int(cfg["mamba_chunk_size"]), T)
    hq, hkv = int(cfg["num_attention_heads"]), int(cfg["num_key_value_heads"])
    d = hdim // hq
    mlp = 2.0 * hdim * 2 * inter + 2.0 * inter * hdim
    G = int(cfg["mamba_n_groups"])
    mamba = (2.0 * hdim * proj + 2.0 * inner * hdim
             + H * ((Q + 1.0) * (N * G / H + P) + 4.0 * N * P))
    attn = (2.0 * hdim * (hq + 2 * hkv) * d + 2.0 * hq * d * hdim
            + 2.0 * 2.0 * hq * d * (T + 1) / 2.0)
    total = sum(mlp + (mamba if k == "mamba" else attn) for k in layer_types(cfg))
    return total + 2.0 * hdim * vocab


def make_batch(cfg, traffic, g, device):
    """One batch from generator `g` on `device`: `batch` windows of
    `length` + 1 token ids drawn from a Zipf law over the whole vocabulary
    (the k-th most frequent id with weight 1 / k, as in text), the inputs
    and, one token on, the labels; int64 [batch, length] each."""
    batch, length = int(traffic["batch"]), int(traffic["length"])
    v = int(cfg["vocab_size"])
    w = 1.0 / torch.arange(1, v + 1, device=device, dtype=torch.float32)
    ids = torch.multinomial(w.expand(batch, v), length + 1, replacement=True, generator=g)
    return ids[:, :-1].contiguous(), ids[:, 1:].contiguous()


# -- the forward ---------------------------------------------------------------

def rmsnorm(x, gamma, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * gamma


def _lin(q, x, W):
    return q(x) @ q(W)


def segsum(x):
    """exp(segsum(x))'s argument [..., T, T]: sum of x over (s, t] for s <= t,
    -inf above the diagonal (the paper's stable form)."""
    T = x.size(-1)
    x = x[..., None].expand(*x.shape, T)
    mask = torch.tril(torch.ones(T, T, device=x.device, dtype=torch.bool), diagonal=-1)
    x = x.masked_fill(~mask, 0)
    s = torch.cumsum(x, dim=-2)
    mask = torch.tril(torch.ones(T, T, device=x.device, dtype=torch.bool), diagonal=0)
    return s.masked_fill(~mask, -torch.inf)


def ssd_minimal(X, A, Bm, Cm, block_len: int):
    """The paper's minimal chunked SSD (Listing 1), no initial state:
    X [b, T, h, p] (x dt), A [b, T, h] (A dt), Bm and Cm [b, T, h, n] ->
    Y [b, T, h, p]; T a multiple of block_len."""
    b, T, h, p = X.shape
    c, L = T // block_len, block_len
    X = X.view(b, c, L, h, p)
    Bm = Bm.view(b, c, L, h, -1)
    Cm = Cm.view(b, c, L, h, -1)
    A = A.view(b, c, L, h).permute(0, 3, 1, 2)                 # b h c l
    A_cumsum = torch.cumsum(A, dim=-1)
    Lmat = torch.exp(segsum(A))
    Y_diag = torch.einsum("bclhn,bcshn,bhcls,bcshp->bclhp", Cm, Bm, Lmat, X)
    decay_states = torch.exp(A_cumsum[:, :, :, -1:] - A_cumsum)
    states = torch.einsum("bclhn,bhcl,bclhp->bchpn", Bm, decay_states, X)
    states = torch.cat([torch.zeros_like(states[:, :1]), states], dim=1)
    decay_chunk = torch.exp(segsum(F.pad(A_cumsum[:, :, :, -1], (1, 0))))
    new_states = torch.einsum("bhzc,bchpn->bzhpn", decay_chunk, states)
    states = new_states[:, :-1]
    Y_off = torch.einsum("bclhn,bchpn,bhcl->bclhp", Cm, states, torch.exp(A_cumsum))
    return (Y_diag + Y_off).reshape(b, T, h, p)


def mamba(cfg, p, m, x, q):
    B, T, _ = x.shape
    H, P = int(cfg["mamba_n_heads"]), int(cfg["mamba_d_head"])
    G, N = int(cfg["mamba_n_groups"]), int(cfg["mamba_d_state"])
    K, Q = int(cfg["mamba_d_conv"]), int(cfg["mamba_chunk_size"])
    inner, conv, _ = _mamba_widths(cfg)
    z, xbc, dt = _lin(q, x, p[m + "W_in"]).split([inner, conv, H], dim=-1)
    xbc = F.conv1d(xbc.transpose(1, 2), p[m + "conv_W"].view(conv, 1, K), p[m + "conv_b"],
                   padding=K - 1, groups=conv)[..., :T].transpose(1, 2)
    xs, Bm, Cm = F.silu(xbc).split([inner, G * N, G * N], dim=-1)
    dt = F.softplus(dt + p[m + "dt_bias"])
    A = -torch.exp(p[m + "A_log"])
    xs = xs.reshape(B, T, H, P)
    pad = (-T) % Q
    rep = H // G
    Bh = Bm.reshape(B, T, G, N).repeat_interleave(rep, dim=2)
    Ch = Cm.reshape(B, T, G, N).repeat_interleave(rep, dim=2)
    X, Ad = q(xs) * dt[..., None], A * dt
    if pad:
        X, Ad, Bh, Ch = (F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad)) for t in (X, Ad, Bh, Ch))
    y = ssd_minimal(X, Ad, q(Bh), q(Ch), Q)[:, :T] + p[m + "D"][:, None] * xs
    y = y.reshape(B, T, inner) * F.silu(z)
    return _lin(q, rmsnorm(y, p[m + "norm_gamma"], float(cfg["rms_norm_eps"])), p[m + "W_out"])


def _attn_block(qh, kh, vh, i, j, scale):
    s = (qh[:, :, i:j] @ kh[:, :, :j].transpose(-1, -2)) * scale
    rows = torch.arange(i, j, device=qh.device)[:, None]
    s = s.masked_fill(torch.arange(j, device=qh.device)[None, :] > rows, float("-inf"))
    return torch.softmax(s, dim=-1) @ vh[:, :, :j]


def attention(cfg, p, m, x, q):
    B, T, hdim = x.shape
    hq, hkv = int(cfg["num_attention_heads"]), int(cfg["num_key_value_heads"])
    d = hdim // hq
    qh = _lin(q, x, p[m + "Wq"]).view(B, T, hq, d).transpose(1, 2)
    kh = _lin(q, x, p[m + "Wk"]).view(B, T, hkv, d).transpose(1, 2)
    vh = _lin(q, x, p[m + "Wv"]).view(B, T, hkv, d).transpose(1, 2)
    kh = kh.repeat_interleave(hq // hkv, dim=1)
    vh = vh.repeat_interleave(hq // hkv, dim=1)
    qh, kh, vh = q(qh), q(kh), q(vh)
    scale = float(cfg["attention_multiplier"])
    o = torch.cat([checkpoint(_attn_block, qh, kh, vh, i, min(i + ATTN_BLOCK, T), scale,
                              use_reentrant=False)
                   for i in range(0, T, ATTN_BLOCK)], dim=2)
    return _lin(q, o.transpose(1, 2).reshape(B, T, hq * d), p[m + "Wo"])


def mlp(cfg, p, m, x, q):
    gate, up = _lin(q, x, p[m + "W_in"]).chunk(2, dim=-1)
    return _lin(q, F.silu(gate) * up, p[m + "W_out"])


def _half(fn, cfg, p, norm, m, h, q):
    eps, res = float(cfg["rms_norm_eps"]), float(cfg["residual_multiplier"])
    return h + res * fn(cfg, p, m, rmsnorm(h, p[norm], eps), q)


def _loss_chunk(h, gamma, E, labels, eps, scaling, q):
    z = _lin(q, rmsnorm(h, gamma, eps) * (1.0 / scaling), E.T)
    return F.cross_entropy(z.reshape(-1, z.shape[-1]), labels.reshape(-1), reduction="sum")


def trunk(cfg, p, ids, q=None):
    """The last layer's output h [b, t, hidden] for token ids [b, t]."""
    q = q or (lambda t: t)
    h = F.embedding(ids, p["embed.W"]) * float(cfg["embedding_multiplier"])
    for i, kind in enumerate(layer_types(cfg)):
        mixer = mamba if kind == "mamba" else attention
        h = checkpoint(_half, mixer, cfg, p, f"l{i}_mixer_norm.gamma", f"l{i}_mixer.", h, q,
                       use_reentrant=False)
        h = checkpoint(_half, mlp, cfg, p, f"l{i}_mlp_norm.gamma", f"l{i}_mlp.", h, q,
                       use_reentrant=False)
    return h


def logits(cfg, p, ids):
    """The logits [b, t, vocab] of token ids [b, t] (whole: small sizes)."""
    h = rmsnorm(trunk(cfg, p, ids), p["final_norm.gamma"], float(cfg["rms_norm_eps"]))
    return (h * (1.0 / float(cfg["logits_scaling"]))) @ p["embed.W"].T


def forward_loss(cfg, p, ids, labels, q):
    """The mean next-token cross-entropy of a batch, differentiable in `p`."""
    q = q or (lambda t: t)
    h = trunk(cfg, p, ids, q)
    eps, scaling = float(cfg["rms_norm_eps"]), float(cfg["logits_scaling"])
    T = h.shape[1]
    total = sum(checkpoint(_loss_chunk, h[:, i:i + LOSS_CHUNK], p["final_norm.gamma"],
                           p["embed.W"], labels[:, i:i + LOSS_CHUNK], eps, scaling, q,
                           use_reentrant=False)
                for i in range(0, T, LOSS_CHUNK))
    return total / labels.numel()


def train_steps(cfg, w0, batches, q=None, s0=None):
    """Adam steps from weights `w0` and state `s0` ({leaf: [m, v] stacked,
    "_t": the steps taken}; zero where None), one a batch of (ids,
    labels). Returns (losses, params, state as `s0`, the first step's
    gradient norm by leaf). `q` rounds the products' operands (a
    control)."""
    lr, eps = float(cfg["learning_rate"]), float(cfg["epsilon"])
    b1, b2 = float(cfg["beta1"]), float(cfg["beta2"])
    p = {k: v.detach().clone() for k, v in w0.items()}
    mv = {k: (torch.zeros((2,) + v.shape, dtype=v.dtype, device=v.device) if s0 is None
              else s0[k].detach().clone()) for k, v in p.items()}
    t0 = 0 if s0 is None else int(round(float(s0["_t"])))
    losses, g1 = [], None
    for j, (x, y) in enumerate(batches):
        leaves = {k: v.requires_grad_(True) for k, v in p.items()}
        loss = forward_loss(cfg, leaves, x.long(), y.long(), q)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        tt = float(t0 + j + 1)
        with torch.no_grad():
            for (k, v), g in zip(leaves.items(), grads):
                v.requires_grad_(False)
                m, s = mv[k][0], mv[k][1]
                m.mul_(b1).add_((1.0 - b1) * g)
                s.mul_(b2).add_((1.0 - b2) * g * g)
                mhat = m / (1.0 - b1 ** tt)
                vhat = s / (1.0 - b2 ** tt)
                v.add_(-lr * mhat / (torch.sqrt(vhat) + eps))
            if g1 is None:
                g1 = {k: float(g.norm()) for k, g in zip(leaves, grads)}
        del grads
        losses.append(float(loss.detach()))
    state = dict(mv)
    state["_t"] = torch.tensor(float(t0 + len(batches)), device=next(iter(p.values())).device)
    return losses, p, state, g1

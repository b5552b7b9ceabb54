"""Plain PyTorch GravesLSTM stack: the reference the char-LSTM cells are
judged by.

DL4J's GravesLSTMCharModellingExample network: `layers` GravesLSTM layers
of `hidden` units (Graves 2013, arXiv:1308.0850: peephole connections
from the cell to the input and forget gates (the previous cell) and to
the output gate (the new cell); sigmoid gates, tanh cell and output), then
a softmax output layer over the vocabulary at every time step, trained
by cross-entropy summed over the time steps and classes and averaged
over the batch, plus the L2 penalty 0.5 l2 sum w^2 over the weights (W,
RW and the peepholes, which DL4J keeps in RW, and the output layer's W;
no bias), with truncated BPTT: the sequence in segments of
`tbptt_length` steps, one optimizer step a segment, the state carried
from one segment to the next without its gradient and reset to zero at
each batch. RMSProp: r = decay r + (1 - decay) g^2, update
-lr g / (sqrt(r) + eps).

Layouts: W [nIn, 4H], RW [H, 4H], b [4H] with gate blocks [i | f | g | o],
peepholes pI, pF, pO [H]; the output layer's W [H, vocab], b [vocab].
Inputs are one-hot [B, T, vocab] with next-character labels.

Float32 with TF32 off (precision.exact_f32). Imports torch only.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch


def lstm_layers(cfg) -> List[tuple]:
    """(nIn, H) of every LSTM layer."""
    out, n_in = [], int(cfg["vocab_size"])
    for _ in range(int(cfg["layers"])):
        out.append((n_in, int(cfg["hidden"])))
        n_in = int(cfg["hidden"])
    return out


def forward_flops_per_sample(cfg) -> float:
    """Forward FLOPs of one token (one time step of one sequence):
    2 * 4H (nIn + H) a layer and 2 H vocab for the output layer; the gate
    arithmetic is left out (the program's utils/flops.py, copied)."""
    total = sum(2.0 * 4 * h * (n_in + h) for n_in, h in lstm_layers(cfg))
    return total + 2.0 * int(cfg["hidden"]) * int(cfg["vocab_size"])


def leaf_shapes(cfg) -> Dict[str, tuple]:
    out = {}
    for i, (n_in, h) in enumerate(lstm_layers(cfg)):
        out.update({f"{i}.W": (n_in, 4 * h), f"{i}.RW": (h, 4 * h), f"{i}.b": (4 * h,),
                    f"{i}.pI": (h,), f"{i}.pF": (h,), f"{i}.pO": (h,)})
    n = int(cfg["layers"])
    out[f"{n}.W"] = (int(cfg["hidden"]), int(cfg["vocab_size"]))
    out[f"{n}.b"] = (int(cfg["vocab_size"]),)
    return out


def make_weights(cfg, seed: int, device) -> Dict[str, torch.Tensor]:
    """Every parameter from `seed`, drawn on `device` in one call: W
    N(0, 1/nIn), RW and the peepholes N(0, 1/H), the gate biases 0.1 n
    with 1 added to the forget block (DL4J's forget-gate bias), the output
    layer N(0, 1/H) with a zero bias; float32."""
    shapes = leaf_shapes(cfg)
    total = sum(math.prod(s) for s in shapes.values())
    g = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.randn(total, generator=g, device=device, dtype=torch.float32)
    h = int(cfg["hidden"])
    out, off = {}, 0
    for name, shape in shapes.items():
        n = math.prod(shape)
        v = flat[off:off + n].view(shape)
        off += n
        kind = name.split(".", 1)[1]
        if kind in ("W", "RW"):
            v = v / math.sqrt(shape[0])
        elif kind in ("pI", "pF", "pO"):
            v = v / math.sqrt(h)
        elif len(shape) == 1 and shape[0] == 4 * h:
            v = 0.1 * v
            v[h:2 * h] += 1.0
        else:
            v = torch.zeros_like(v)
        out[name] = v.contiguous()
    return out


def samples_per_batch(cfg, traffic) -> int:
    """Tokens a batch: rows x time steps."""
    return int(traffic["batch"]) * int(traffic["length"])


def units_per_batch(cfg, traffic) -> List[dict]:
    """The optimizer steps one batch takes: one a TBPTT segment."""
    seg = int(cfg["tbptt_length"])
    return [{"phase": "train", "batch": int(traffic["batch"]), "length": seg}
            ] * (int(traffic["length"]) // seg)


def make_batch(cfg, traffic, g, device):
    """One batch from generator `g` on `device`: `batch` windows of
    `length` + 1 characters drawn from a Zipf law over the vocabulary (the
    k-th most frequent symbol with weight 1 / k, as in text), one-hot, the
    labels the same windows one character on; float32."""
    batch, length = int(traffic["batch"]), int(traffic["length"])
    v = int(cfg["vocab_size"])
    w = 1.0 / torch.arange(1, v + 1, device=device, dtype=torch.float32)
    ids = torch.multinomial(w.expand(batch, v), length + 1, replacement=True, generator=g)
    oh = torch.nn.functional.one_hot(ids, v).float()
    return oh[:, :-1].contiguous(), oh[:, 1:].contiguous()


def _layer(p, i, x, h, c, q):
    """One GravesLSTM layer over x [B, T, nIn] from (h, c); `q` rounds the
    products' operands (a control) or is the identity."""
    H = h.shape[1]
    W, RW, b = p[f"{i}.W"], q(p[f"{i}.RW"]), p[f"{i}.b"]
    pI, pF, pO = p[f"{i}.pI"], p[f"{i}.pF"], p[f"{i}.pO"]
    xg = q(x) @ q(W) + b
    ys = []
    for t in range(x.shape[1]):
        z = xg[:, t] + q(h) @ RW
        zi, zf, zg, zo = z[:, :H], z[:, H:2 * H], z[:, 2 * H:3 * H], z[:, 3 * H:]
        i_g = torch.sigmoid(zi + c * pI)
        f_g = torch.sigmoid(zf + c * pF)
        c = f_g * c + i_g * torch.tanh(zg)
        o_g = torch.sigmoid(zo + c * pO)
        h = o_g * torch.tanh(c)
        ys.append(h)
    return torch.stack(ys, dim=1), h, c


def segment_loss(cfg, p, x, y, carry, q=None):
    """Loss of one segment and the carry it leaves: [(h, c)] a layer."""
    q = q or (lambda t: t)
    new = []
    for i, (h, c) in enumerate(carry):
        x, h, c = _layer(p, i, x, h, c, q)
        new.append((h, c))
    n = int(cfg["layers"])
    logits = q(x) @ q(p[f"{n}.W"]) + p[f"{n}.b"]
    loss = -(y * torch.log_softmax(logits, dim=-1)).sum(dim=(1, 2)).mean()
    return loss, new


def l2_penalty(cfg, p):
    """0.5 l2 sum w^2 over the weights (no bias)."""
    l2 = float(cfg["l2"])
    return 0.5 * l2 * sum((v * v).sum() for k, v in p.items()
                          if k.split(".", 1)[1] in ("W", "RW", "pI", "pF", "pO"))


def train_steps(cfg, w0, batches, q=None, r0=None):
    """RMSProp steps from weights `w0` and state `r0` (zero where None),
    one a TBPTT segment of each batch [(x, y) one-hot [B, T, vocab]].
    Returns (losses, params, {leaf: r}, the first step's gradient norm by
    leaf). A step's loss holds the L2 penalty, as the program's score
    does. `q` rounds the products' operands (a control)."""
    lr, decay = float(cfg["learning_rate"]), float(cfg["rms_decay"])
    eps, seg = float(cfg["epsilon"]), int(cfg["tbptt_length"])
    p = {k: v.detach().clone() for k, v in w0.items()}
    r = {k: (torch.zeros_like(v) if r0 is None else r0[k].detach().clone())
         for k, v in p.items()}
    losses, g1 = [], None
    for x, y in batches:
        B = x.shape[0]
        carry = [(x.new_zeros(B, h), x.new_zeros(B, h)) for _, h in lstm_layers(cfg)]
        for s in range(0, x.shape[1], seg):
            leaves = {k: v.requires_grad_(True) for k, v in p.items()}
            loss, carry = segment_loss(cfg, leaves, x[:, s:s + seg], y[:, s:s + seg], carry, q)
            loss = loss + l2_penalty(cfg, leaves)
            grads = torch.autograd.grad(loss, list(leaves.values()))
            carry = [(h.detach(), c.detach()) for h, c in carry]
            with torch.no_grad():
                for (k, v), g in zip(leaves.items(), grads):
                    v.requires_grad_(False)
                    r[k] = decay * r[k] + (1.0 - decay) * g * g
                    v.add_(-lr * g / (torch.sqrt(r[k]) + eps))
                if g1 is None:
                    g1 = {k: float(g.norm()) for k, g in zip(leaves, grads)}
            losses.append(float(loss.detach()))
    return losses, p, r, g1

"""Plain PyTorch ResNet: the reference the ResNet cells are judged by.

The bottleneck ResNet of He et al. (arXiv:1512.03385), with the stride of
a stage's first block on its 3x3 conv as in NVIDIA's ResNet-50 v1.5:
a 7x7/2 stem conv, BN and ReLU, a 3x3/2 max pool, stages of
[1x1 w, 3x3 w, 1x1 4w] blocks whose first block projects its shortcut by
a 1x1 conv and BN, a ReLU after each residual add, a global average pool
and a softmax classifier trained by the mean cross-entropy plus the L2
penalty 0.5 l2 sum w^2 over the conv and classifier weights (DL4J's L2:
BN's gamma and beta and the biases carry none). Convs carry no bias (BN
follows each). Padding is SAME with the odd pixel on the high
side (XLA's rule); the max pool pads with -inf. Batch norm normalises
over every axis but the channels with the biased batch variance (the
training mode), eps from the configuration. Inputs are NHWC images and one-hot
labels; conv weights HWIO, the classifier's W [C, classes].

Float32 throughout, TF32 off (precision.exact_f32). It imports torch and
this folder only: nothing of the program. The benchmark makes the
weights here from the seed and hands the same to the program.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint


# -- the architecture ------------------------------------------------------------

def _blocks(cfg) -> List[dict]:
    """Every bottleneck block: name, input channels, width, stride, and
    whether it projects its shortcut."""
    out, cin = [], int(cfg["stem_width"])
    for si, (n, w) in enumerate(zip(cfg["blocks"], cfg["widths"])):
        for bi in range(int(n)):
            out.append({"name": f"s{si}b{bi}", "cin": cin, "width": int(w),
                        "stride": 2 if (si > 0 and bi == 0) else 1,
                        "project": bi == 0})
            cin = 4 * int(w)
    return out


def units(cfg) -> List[dict]:
    """Every conv + BN unit in forward order: name, kernel, stride, cin,
    cout, and whether a ReLU follows its BN directly."""
    out = [{"name": "stem", "k": 7, "stride": 2, "cin": int(cfg["channels"]),
            "cout": int(cfg["stem_width"]), "relu": True}]
    for b in _blocks(cfg):
        w, n = b["width"], b["name"]
        out += [{"name": f"{n}_a", "k": 1, "stride": 1, "cin": b["cin"], "cout": w, "relu": True},
                {"name": f"{n}_b", "k": 3, "stride": b["stride"], "cin": w, "cout": w, "relu": True},
                {"name": f"{n}_c", "k": 1, "stride": 1, "cin": w, "cout": 4 * w, "relu": False}]
        if b["project"]:
            out.append({"name": f"{n}_sc", "k": 1, "stride": b["stride"], "cin": b["cin"],
                        "cout": 4 * w, "relu": False})
    return out


def same_pads(n: int, k: int, s: int):
    """(out, pad_lo, pad_hi) of one spatial dimension under SAME padding."""
    out = -(-n // s)
    total = max((out - 1) * s + k - n, 0)
    return out, total // 2, total - total // 2


def conv_bn_instances(cfg, batch: int) -> List[dict]:
    """Every conv + BN unit at `batch` with its NHWC input shape: name,
    kernel, stride, x_shape, n_out, relu."""
    size = int(cfg["image_size"])
    out = []
    h = size
    stem_out = same_pads(h, 7, 2)[0]
    pool_out = same_pads(stem_out, 3, 2)[0]
    shapes = {"stem": h}
    h = pool_out
    for b in _blocks(cfg):
        n = b["name"]
        shapes[f"{n}_a"] = h
        shapes[f"{n}_b"] = h
        h2 = same_pads(h, 3, b["stride"])[0]
        shapes[f"{n}_c"] = h2
        shapes[f"{n}_sc"] = h
        h = h2
    for u in units(cfg):
        hin = shapes[u["name"]]
        out.append({"name": u["name"], "kernel": (u["k"], u["k"]),
                    "stride": (u["stride"], u["stride"]),
                    "x_shape": (int(batch), hin, hin, u["cin"]),
                    "n_out": u["cout"], "relu": u["relu"]})
    return out


def forward_flops_per_sample(cfg) -> float:
    """Forward FLOPs of one image: 2 k^2 cin cout Ho Wo a conv and 2 C
    classes for the classifier; pooling, BN and the adds are left out
    (the arithmetic of the program's utils/flops.py, copied)."""
    total = 0.0
    for inst in conv_bn_instances(cfg, 1):
        (k, _), (s, _) = inst["kernel"], inst["stride"]
        ho = same_pads(inst["x_shape"][1], k, s)[0]
        total += 2.0 * k * k * inst["x_shape"][3] * inst["n_out"] * ho * ho
    c = 4 * int(cfg["widths"][-1])
    return total + 2.0 * c * int(cfg["num_classes"])


# -- weights ---------------------------------------------------------------------

def leaf_shapes(cfg) -> Dict[str, tuple]:
    out = {}
    for u in units(cfg):
        out[f"{u['name']}_conv.W"] = (u["k"], u["k"], u["cin"], u["cout"])
        out[f"{u['name']}_bn.gamma"] = (u["cout"],)
        out[f"{u['name']}_bn.beta"] = (u["cout"],)
    c = 4 * int(cfg["widths"][-1])
    out["out.W"] = (c, int(cfg["num_classes"]))
    out["out.b"] = (int(cfg["num_classes"]),)
    return out


def make_weights(cfg, seed: int, device) -> Dict[str, torch.Tensor]:
    """Every parameter from `seed`, drawn on `device` in one call: He
    normal convs (std sqrt(2 / k^2 cin)), BN gamma 1 + 0.1 n and beta
    0.1 n, but the gamma of each residual branch's last BN (`_c`) 0.2 +
    0.02 n, the classifier N(0, 1/C) with a 0.01 n bias; float32.

    The small branch gamma is the scale trained ResNets hold there and
    that Goyal et al. (arXiv:1706.02677) start from (at 0). With gamma 1
    on every branch, a random ResNet-50 in inference mode is chaotic: a
    rounding of its operands to bf16 already moves the log-probabilities
    by about half their spread over the classes, and to fp8 by about the
    whole of it, so no comparison could tell the two apart. Nonzero, so
    every branch conv and its gradients stay in the comparison."""
    shapes = leaf_shapes(cfg)
    total = sum(math.prod(s) for s in shapes.values())
    g = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.randn(total, generator=g, device=device, dtype=torch.float32)
    out, off = {}, 0
    for name, shape in shapes.items():
        n = math.prod(shape)
        v = flat[off:off + n].view(shape)
        off += n
        if name.endswith("_conv.W"):
            v = v * math.sqrt(2.0 / (shape[0] * shape[1] * shape[2]))
        elif name.endswith("_c_bn.gamma"):
            v = 0.2 + 0.02 * v
        elif name.endswith(".gamma"):
            v = 1.0 + 0.1 * v
        elif name.endswith(".beta"):
            v = 0.1 * v
        elif name == "out.W":
            v = v / math.sqrt(shape[0])
        else:
            v = 0.01 * v
        out[name] = v.contiguous()
    return out


# -- inputs ----------------------------------------------------------------------

def make_batch(cfg, traffic, g, device):
    """One batch of `traffic["batch"]` rows from generator `g` on `device`:
    N(0, 1) NHWC images and one-hot labels drawn uniformly over the
    classes, float32."""
    batch = int(traffic["batch"])
    s, c, k = int(cfg["image_size"]), int(cfg["channels"]), int(cfg["num_classes"])
    x = torch.randn((batch, s, s, c), generator=g, device=device)
    lab = torch.randint(0, k, (batch,), generator=g, device=device)
    return x, F.one_hot(lab, k).float()


def samples_per_batch(cfg, traffic) -> int:
    """Images a batch."""
    return int(traffic["batch"])


def units_per_batch(cfg, traffic) -> List[dict]:
    """The optimizer steps one batch takes: one."""
    return [{"phase": "train", "batch": int(traffic["batch"])}]


# -- the forward -------------------------------------------------------------------

def _conv(x, w_hwio, stride, q):
    k = w_hwio.shape[0]
    _, t, b = same_pads(x.shape[2], k, stride)
    _, l, r = same_pads(x.shape[3], k, stride)
    if (t, b, l, r) != (0, 0, 0, 0):
        x = F.pad(x, (l, r, t, b))
    return F.conv2d(q(x), q(w_hwio.permute(3, 2, 0, 1)), stride=stride)


def _unit(x, p, u, eps, q):
    y = F.batch_norm(_conv(x, p[f"{u['name']}_conv.W"], u["stride"], q), None, None,
                     p[f"{u['name']}_bn.gamma"], p[f"{u['name']}_bn.beta"],
                     training=True, eps=eps)
    return torch.relu(y) if u["relu"] else y


def forward(cfg, p, x_nhwc, q=None, remat=False):
    """Logits [N, classes], BN on the batch's statistics. `q` rounds conv
    and matmul operands (a control); `remat` recomputes each block in the
    backward instead of keeping its activations (the same arithmetic, less
    memory)."""
    q = q or (lambda t: t)
    eps = float(cfg["bn_eps"])
    us = {u["name"]: u for u in units(cfg)}
    x = x_nhwc.permute(0, 3, 1, 2)
    x = _unit(x, p, us["stem"], eps, q)
    _, t, b = same_pads(x.shape[2], 3, 2)
    _, l, r = same_pads(x.shape[3], 3, 2)
    x = F.max_pool2d(F.pad(x, (l, r, t, b), value=float("-inf")), 3, 2)
    for blk in _blocks(cfg):
        n = blk["name"]

        def body(h, n=n, project=blk["project"]):
            y = _unit(h, p, us[f"{n}_a"], eps, q)
            y = _unit(y, p, us[f"{n}_b"], eps, q)
            y = _unit(y, p, us[f"{n}_c"], eps, q)
            sc = _unit(h, p, us[f"{n}_sc"], eps, q) if project else h
            return torch.relu(y + sc)

        x = checkpoint(body, x, use_reentrant=False) if remat and x.requires_grad else body(x)
    pooled = x.mean(dim=(2, 3))
    return q(pooled) @ q(p["out.W"]) + p["out.b"]


def loss_of(logits, y_onehot):
    return -(y_onehot * torch.log_softmax(logits, dim=-1)).sum(-1).mean()


# -- training ------------------------------------------------------------------------

def l2_penalty(cfg, p):
    """0.5 l2 sum w^2 over the conv and classifier weights."""
    l2 = float(cfg["l2"])
    return 0.5 * l2 * sum((v * v).sum() for k, v in p.items() if k.endswith(".W"))


def train_steps(cfg, w0, batches, q=None, v0=None):
    """Nesterovs steps from weights `w0` and velocity `v0` (zero where
    None) over `batches` [(x NHWC, y one-hot)], one a batch (nd4j's
    formulation: v' = mu v - lr g, update -mu v + (1 + mu) v'). Returns
    (losses, params, {leaf: v}, the first step's gradient norm by leaf).
    A step's loss holds the L2 penalty, as the program's score does."""
    lr, mu = float(cfg["learning_rate"]), float(cfg["momentum"])
    p = {k: v.detach().clone() for k, v in w0.items()}
    vel = {k: (torch.zeros_like(v) if v0 is None else v0[k].detach().clone())
           for k, v in p.items()}
    losses, g1 = [], None
    for x, y in batches:
        leaves = {k: v.requires_grad_(True) for k, v in p.items()}
        loss = (loss_of(forward(cfg, leaves, x, q=q, remat=True), y)
                + l2_penalty(cfg, leaves))
        grads = torch.autograd.grad(loss, list(leaves.values()))
        with torch.no_grad():
            for (k, v), g in zip(leaves.items(), grads):
                v.requires_grad_(False)
                v_new = mu * vel[k] - lr * g
                v.add_(-mu * vel[k] + (1.0 + mu) * v_new)
                vel[k] = v_new
            if g1 is None:
                g1 = {k: float(g.norm()) for k, g in zip(leaves, grads)}
        losses.append(float(loss.detach()))
    return losses, p, vel, g1

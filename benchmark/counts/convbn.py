"""Work of the conv + BN family: the least each conv + BN unit of a
training step must read, write and compute, whatever kernels do it.

For every conv that a BN follows, in one optimizer step at `batch`:

- the forward conv with the BN's two per-channel statistics: its FLOPs at
  the valid (output position, tap) pairs (taps that land in padding do
  no work); x read once (a strided 1x1 reads only the rows it samples),
  the weights once, y written once, and two f32 vectors of C;
- the BN apply: 3 FLOPs an element, x read and y written once, and
  three f32 vectors of C (gamma, beta, the statistics in);
- the BN backward reduce: 3 FLOPs an element, the output gradient and x
  read once, and the saved output once more where the BN applies the
  ReLU itself (the gate), two f32 vectors out;
- the BN backward apply: 4 FLOPs an element, the output gradient and x
  read and dx written once (and the gate's read), three f32 vectors in.

Arithmetic copied from the program's analysis/kernelcoverage.kernel_costs
and analysis/costmodel.conv_instance_cost (PR 18's per-instance work of
K4-K8), so the yardstick stays when the kernels change. Inference runs
none of this family: its units give no work.
"""

from __future__ import annotations

from typing import List, Tuple


def _valid_pairs(out_sz: int, k: int, in_sz: int, stride: int, pad_lo: int) -> int:
    n = 0
    for o in range(out_sz):
        base = o * stride - pad_lo
        n += sum(1 for t in range(k) if 0 <= base + t < in_sz)
    return n


def work(cfg, ref, unit, itemsize: int) -> List[Tuple[float, float]]:
    """[(flops, bytes)] of each instance one `unit` runs: a dict with
    "phase" ("train" or "infer") and "batch"."""
    if unit["phase"] != "train":
        return []
    out = []
    for inst in ref.conv_bn_instances(cfg, unit["batch"]):
        n, h, w, cin = inst["x_shape"]
        (kh, kw), (sh, sw) = inst["kernel"], inst["stride"]
        cout = inst["n_out"]
        ho, ph, _ = ref.same_pads(h, kh, sh)
        wo, pw, _ = ref.same_pads(w, kw, sw)
        flops = 2.0 * n * cout * cin * _valid_pairs(ho, kh, h, sh, ph) \
            * _valid_pairs(wo, kw, w, sw, pw)
        m = n * ho * wo
        if (kh, kw) == (1, 1):
            x_bytes = itemsize * m * cin
        else:
            x_bytes = itemsize * n * h * w * cin
        conv_bytes = x_bytes + itemsize * (kh * kw * cin * cout + m * cout) + 8 * cout
        out.append((flops, conv_bytes))
        mc, gate = m * cout, int(bool(inst["relu"]))
        out.append((3.0 * mc, itemsize * 2 * mc + 12 * cout))
        out.append((3.0 * mc, itemsize * (2 + gate) * mc + 8 * cout))
        out.append((4.0 * mc, itemsize * (3 + gate) * mc + 12 * cout))
    return out

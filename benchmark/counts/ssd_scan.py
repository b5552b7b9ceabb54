"""Work of the SSD scan family: the chunked scan of every Mamba-2 layer,
forward and backward, from the configuration alone, whatever kernels do
it (the program's ops/fused_ssd.py today).

For a layer of H heads of width P, state N, G groups of B and C and chunk
Q, over B rows of T tokens (T padded to a whole number of chunks):

- forward: per token and head the intra-chunk products C B^T, once a
  group (G/H of it a head: B and C are shared by the group's heads), and
  (C B^T o L) (dt x), each over the causal half of the [Q, Q] square,
  Q(Q + 1)/2 pairs a chunk: (Q + 1)(N G/H + P) FLOPs; and the chunk state
  (x o w)^T B and its output C S^T, 4NP;
  reads x [B, T, H, P], dt [B, T, H] (f32), B and C [B, T, G, N] and A, D
  [H] (f32); writes y [B, T, H, P];
- backward: twice the forward's FLOPs (each product's two operand
  gradients; the heads' score gradients summed before the products with
  B and C, which the group shares); reads x, dt, B, C, A, D and dy;
  writes dx, ddt (f32), dB, dC, dA and dD (f32).

The conv, gates, softplus and norms around the scan are left out; bytes
are each input read once and each output written once.
"""

from __future__ import annotations

from typing import List, Tuple


def work(cfg, ref, unit, itemsize: int) -> List[Tuple[float, float]]:
    rows, T = int(unit["batch"]), int(unit["length"])
    H, P = int(cfg["mamba_n_heads"]), int(cfg["mamba_d_head"])
    N, G, Q = int(cfg["mamba_d_state"]), int(cfg["mamba_n_groups"]), int(cfg["mamba_chunk_size"])
    Tp = -(-T // Q) * Q
    tokens = rows * Tp
    flops = tokens * H * ((Q + 1.0) * (N * G / H + P) + 4.0 * N * P)
    x, bc, dt, hd = tokens * H * P * itemsize, 2 * tokens * G * N * itemsize, 4 * tokens * H, 8 * H
    out = []
    for kind in ref.layer_types(cfg):
        if kind != "mamba":
            continue
        out.append((flops, x + dt + bc + hd + x))
        if unit["phase"] == "train":
            out.append((2.0 * flops, (x + dt + bc + hd + x) + (x + dt + bc + hd)))
    return out

"""Work of the LSTM sequence family: the serial recurrence of every LSTM
layer over one TBPTT segment, forward and backward, whatever kernels do
it (the program's K1 and K3 today).

For a layer of H units at batch B over T steps:

- forward: the recurrent product h @ RW each step, 2 B H 4H FLOPs;
  reads the input projection xg [T, B, 4H], RW [H, 4H], the three
  peepholes and (h0, c0); writes y [T, B, H], the gate activations
  [T, B, 4H] and the previous h and c [T, B, H] each that the backward
  reads, and the final c;
- backward: two products a step, dh = dz @ RW^T and dRW += h^T dz,
  4 B H 4H FLOPs; reads the saved gates, h and c, RW, the peepholes, dy
  [T, B, H] and dcF; writes dxg [T, B, 4H], dRW, the peepholes' gradients
  and (dh0, dc0).

The gate arithmetic (some tens of FLOPs an element) is left out, as the
bounds of PERF.md's kernel table (PR 11) leave it out; bytes are each
input read once and each output written once. A unit of the inference
phase runs the forward only.
"""

from __future__ import annotations

from typing import List, Tuple


def work(cfg, ref, unit, itemsize: int) -> List[Tuple[float, float]]:
    B, T = int(unit["batch"]), int(unit["length"])
    out = []
    for _, H in ref.lstm_layers(cfg):
        fwd_bytes = itemsize * (T * B * 4 * H + 4 * H * H + 3 * H + 2 * B * H
                                + T * B * H + T * B * 4 * H + 2 * T * B * H + B * H)
        out.append((8.0 * T * B * H * H, fwd_bytes))
        if unit["phase"] == "train":
            bwd_bytes = itemsize * (T * B * 4 * H + 2 * T * B * H + 4 * H * H + 3 * H
                                    + T * B * H + B * H
                                    + T * B * 4 * H + 4 * H * H + 3 * H + 2 * B * H)
            out.append((16.0 * T * B * H * H, bwd_bytes))
    return out

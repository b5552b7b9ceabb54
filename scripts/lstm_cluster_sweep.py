#!/usr/bin/env python3
"""Per-step device time of the LSTM sequence kernels' cluster variant on
one NVIDIA GPU, swept over the shape.

    python3 scripts/lstm_cluster_sweep.py [--seed N] [--out FILE.json]

1. K1 (T=100) and K3 (T=50) at B=32 and H = 8, 64, 128, 200, 256: the
   per-step time that does not grow with H (the exchange, the barrier, the
   gate math of few units) against the part that does.
2. K1 and K3 at H=200 and B = 8, 32, 64, 128, 256 with clusters of R = 4
   and of R = 8 batch rows each: the measurement behind
   `fused_lstm._cluster_rows` (the script swaps that choice for each run).

f32, random inputs from --seed, device time per call by torch.profiler
(device activity only). Prints one line per shape and the card's name
and power limit, and exits non-zero without a CUDA device. Imports
nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def device_ms(torch, fn, reps=10):
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()) / 1e3 / reps


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None, help="also write the record as JSON here")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("lstm_cluster_sweep: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from deeplearning4j_tpu_torch.ops import fused_lstm as fl

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(args.seed)

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).cuda()

    def inputs(T, B, H):
        """Forward inputs, and backward inputs on the forward's stashes."""
        a = [rnd(T, B, 4 * H), rnd(H, 4 * H, scale=0.1), *(rnd(H, scale=0.3) for _ in range(3)),
             rnd(B, H, scale=0.5), rnd(B, H, scale=0.5)]
        _, acts, hprev, cprev, _ = fl.lstm_sequence_forward(*a)
        return a, [acts, hprev, cprev, *a[1:5], rnd(T, B, H), rnd(B, H)]

    def times(T_fwd, T_bwd, B, H):
        a, _ = inputs(T_fwd, B, H)
        _, b = inputs(T_bwd, B, H)
        k1 = device_ms(torch, lambda: fl.lstm_sequence_forward(*a))
        k3 = device_ms(torch, lambda: fl.lstm_sequence_backward(*b))
        return {"k1_ms": k1, "k1_us_per_step": 1e3 * k1 / T_fwd,
                "k3_ms": k3, "k3_us_per_step": 1e3 * k3 / T_bwd}

    record = {"by_hidden": [], "by_rows": []}
    print("K1 at T=100, K3 at T=50 (chain + dRW pass), B=32, cluster variant, f32")
    for H in (8, 64, 128, 200, 256):
        r = {"B": 32, "H": H, "R": fl.lstm_variant(32, H, torch.float32)["R"],
             **times(100, 50, 32, H)}
        record["by_hidden"].append(r)
        print(f"  H={H}: K1 {r['k1_ms']:.4f} ms = {r['k1_us_per_step']:.3f} us/step; "
              f"K3 {r['k3_ms']:.4f} ms = {r['k3_us_per_step']:.3f} us/step", flush=True)
    print("H=200, clusters of R=4 vs R=8 batch rows")
    chosen = fl._cluster_rows
    try:
        for B in (8, 32, 64, 128, 256):
            row = {"B": B, "H": 200, "chosen_R": chosen(B)}
            for R in (4, 8):
                fl._cluster_rows = lambda _B, R=R: R
                row[f"R{R}"] = times(100, 50, B, 200)
            fl._cluster_rows = chosen
            record["by_rows"].append(row)
            print(f"  B={B} (takes R={row['chosen_R']}): " + "; ".join(
                f"R={R} K1 {row[f'R{R}']['k1_ms']:.4f} ms, K3 {row[f'R{R}']['k3_ms']:.4f} ms"
                for R in (4, 8)), flush=True)
    finally:
        fl._cluster_rows = chosen
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60, check=True).stdout.strip().splitlines()[0]
    record["card"] = card
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(record, f, indent=2)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())

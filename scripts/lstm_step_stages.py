#!/usr/bin/env python3
"""Where the decode-step kernel K2 (csrc/lstm_step.cu) spends its time on
one NVIDIA GPU: the device time of the kernel cut short after each of its
stages.

    python3 scripts/lstm_step_stages.py [--seed N] [--out FILE.json]

The script copies csrc/lstm_step.cu into deeplearning4j_tpu_torch/_build/
and builds five libraries from it, each with the kernel returning at
another point (the shipped source is not changed):

  0  at entry (the cost of a launch of its grid and block)
  1  after the RW copies have landed (one cp.async round trip)
  2  after all staging and the first barrier (h, and the gate operands)
  3  after the product and the second barrier
  4  the whole kernel (gate math and the stores)

Each at H = 200, f32, B = 1, 8 and 64, called through the C entry;
device time per call by torch.profiler (device activity only). Prints
one line per shape and stage and the card's name and power limit, and
exits non-zero without a CUDA device. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (stage, text the early return goes after, the return to insert)
RETURNS = (
    (0, "const int H4 = 4 * H;\n", "  return;\n"),
    (1, 'asm volatile("cp.async.commit_group;\\n" ::: "memory");\n',
     '    asm volatile("cp.async.wait_all;\\n" ::: "memory");\n    __syncthreads();\n'
     '    return;\n'),
    (2, "__syncthreads();\n\n  // 3.", None),
    (3, "__syncthreads();\n\n  // 4.", None),
)


def staged_source(src: str, stage: int) -> str:
    """The kernel's source with an early return at `stage` (4: none)."""
    for st, anchor, ret in RETURNS:
        if st != stage:
            continue
        i = src.index(anchor)
        if ret is None:  # after the barrier that opens the anchor
            i += len("__syncthreads();\n")
            return src[:i] + "  return;\n" + src[i:]
        i += len(anchor)
        return src[:i] + ret + src[i:]
    return src


def device_ms(torch, fn, reps=50):
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
        print("lstm_step_stages: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from deeplearning4j_tpu_torch.ops import cuda_build

    work = os.path.join(cuda_build.BUILD_DIR, "stages")
    os.makedirs(work, exist_ok=True)
    shutil.copy(os.path.join(cuda_build.CSRC, "common.cuh"), work)
    with open(os.path.join(cuda_build.CSRC, "lstm_step.cu")) as f:
        src = f.read()
    procs = {}
    for stage in range(5):
        cu = os.path.join(work, f"lstm_step_stage{stage}.cu")
        with open(cu, "w") as f:
            f.write(staged_source(src, stage))
        lib = os.path.join(work, f"liblstm_step_stage{stage}.so")
        procs[stage] = (lib, subprocess.Popen(
            [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o", lib, cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    fns = {}
    for stage, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            print(log, file=sys.stderr)
            return 1
        fns[stage] = cuda_build.entry_of(ctypes.CDLL(lib), "lstm_step", 9, 2)

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    gen = torch.Generator().manual_seed(args.seed)
    H = 200
    rec = {"card": card, "H": H, "us": {}}
    for B in (1, 8, 64):
        a = [(torch.randn(*s, generator=gen) * k).cuda()
             for s, k in (((B, 4 * H), 1.0), ((H, 4 * H), 0.1), ((H,), 0.3), ((H,), 0.3),
                          ((H,), 0.3), ((B, H), 0.5), ((B, H), 0.5))]
        out = [torch.empty(B, H, device="cuda") for _ in range(2)]
        stream = torch.cuda.current_stream().cuda_stream
        for stage, fn in fns.items():
            def call(fn=fn):
                return fn(0, *(t.data_ptr() for t in (*a, *out)), B, H, stream)

            if call() != 0:
                print(f"stage {stage} did not launch", file=sys.stderr)
                return 1
            us = device_ms(torch, call) * 1e3
            rec["us"][f"B={B} stage={stage}"] = us
            print(f"B={B} stage {stage}: {us:.3f} us")
    print(card)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(rec, f, indent=2)
    return 0


if __name__ == "__main__":
    sys.exit(main())

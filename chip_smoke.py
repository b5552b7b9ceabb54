#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py [--seed N] [--out chiprun_out/chip_smoke.json]

Phases; any failure raises and the script exits non-zero without its
result lines:

1. Device: the card's name and power limit (nvidia-smi), and the build of
   every kernel from `deeplearning4j_tpu_torch/csrc/` (one nvcc per source,
   in parallel).
2. Kernels: each hand-written kernel against its plain PyTorch version on
   the card, at the shapes the main path gives it, with and without
   peepholes, in f32 and bf16 (the backward kernel at the training
   segment and at a ragged shape, on the forward kernel's stashes).
   Device time per call by torch.profiler (CUPTI) for the kernel, its
   plain version and one library call that computes the same function
   without peepholes, beside the roofline bound; the wall time per
   back-to-back call by CUDA events beside them.
3. Slice: full-width char-LSTM (vocab 77, hidden 200, 2 GravesLSTM
   layers, f32, weights from --seed): `output()` on a [32, 100, 77]
   one-hot batch equals the same net with the helpers switched off, and
   went through the sequence kernel.
4. Serve: `DecodeEngine(n_slots=8)`, two tenants weighted 3:1, 24
   requests (prompts of 1-32 tokens, 32-64 new tokens) with one weight
   swap halfway, once with one step per iteration and once with
   `set_fused_steps(4)`. Every request's tokens equal the port's own
   sequential greedy `rnn_time_step` loop; the books conserve; the decode
   step went through the step kernel.
5. Train: the same full-width char-LSTM (TBPTT 50, RMSProp; lr 0.01, see
   TRAIN_LR) fits 3 batches of [32, 1000, 77] windows of SURVEY.md (60
   optimizer steps): tokens/s, first and last score (the last must be
   lower), two launches of the forward and of the backward kernel per
   step; then step p50/p99 over the same batches with the device synced
   at each step, and the device-busy share of one fit batch under
   torch.profiler. Over the 20 segments of one fit batch, in lockstep, the
   helpers-on step holds to the helpers-off step (the builtin loop plus
   autograd) in gradients, score, and the parameters and RMSProp state
   it leaves; left to run free, their score drift stays within a factor
   of the drift between the builtin loop on the card and on the CPU. One
   bf16 fit batch gives finite scores.

The last three lines of standard output are the kernels JSON line, the
card line, and {"ok": true, "device": {...}}. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import collections
import json
import math
import os
import statistics
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published peaks (NVIDIA data sheet): HBM bandwidth and the f32
# rate outside the tensor cores, which is what both kernels' FMAs use
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12

VOCAB, HIDDEN, LAYERS = 77, 200, 2
F32_ATOL = 1e-5          # kernel vs plain, both f32 math: summation order only
# dRW and the peephole grads are sums of T*B products: the rounding of a
# sum taken in another order grows like sqrt(T*B), so their f32 tolerance
# is F32_ATOL * sqrt(T*B)
BF16_ULP = 2.0 ** -7     # bf16 rounding step at |v| in [1, 2)
SLICE_ATOL = 1e-4        # softmax outputs after 100 steps x 2 layers, f32
TRAIN_BATCHES, TRAIN_B, TRAIN_T, TBPTT = 3, 32, 1000, 50
# At the published lr 0.1 RMSProp's first step moves every weight by
# ~4.5 lr = 0.45, ten times the xavier scale, and the score rises more than
# threefold at the second step, in the JAX package and in the port alike
# (tests/test_torch_charlstm_fit.py::
# test_published_lr_rises_alike_in_both_packages_at_full_width). Phase 5
# trains at 0.01, where the score falls. The work per step does not depend
# on lr.
TRAIN_LR = 0.01
# helpers on vs off, in lockstep over the 20 segments of one fit batch
# (both paths take each step from the same parameters and updater state),
# f32: the gradients agree to 1e-4 of each tensor's largest entry (sums
# over up to T*B = 1600 terms in another order), the score to 1e-5
# relative; after the step, the parameters to 1e-4 of the step's own size
# (|p_on - p_off| over |p_off - p_before|, L2 over all leaves: RMSProp
# moves an entry by ~4.5 lr whatever its gradient, so a rounding-level
# gradient near zero may move its entry by a visible fraction of that) and
# RMSProp's r to 1e-4 of each tensor's largest entry.
TRAIN_GRAD_RTOL = 1e-4
TRAIN_SCORE_RTOL = 1e-5
TRAIN_PARAM_RTOL = 1e-4
TRAIN_STATE_RTOL = 1e-4
# Left to run free over the 20 steps of one fit batch, the two paths part
# further each step: RMSProp amplifies any rounding difference. The
# witness is the builtin loop on the card against the builtin loop on the
# CPU from the same parameters, which differ in nothing but the order of
# their f32 sums. The largest relative score drift of helpers on vs off
# must stay within DRIFT_FACTOR times the witness's. The peak of a chaotic
# drift varies several-fold between rounding-only pairs, so the factor is
# wide: it guards against a gross departure, and a fault beyond rounding
# shows in the lockstep check.
DRIFT_FACTOR = 30


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, reps=20, rounds=5) -> float:
    """Median over `rounds` of the mean time of `reps` back-to-back calls,
    by CUDA events, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    vals = []
    for _ in range(rounds):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(reps):
            fn()
        e.record()
        e.synchronize()
        vals.append(s.elapsed_time(e) / reps)
    return statistics.median(vals)


def device_ms(torch, fn, reps=20):
    """Device time per call: the CUDA kernels, copies and memsets that
    `reps` calls put on the card, summed by torch.profiler (CUPTI), over
    `reps`. Host overhead between launches is not in it. None when the
    profiler sees no device activity."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total_us = sum(getattr(e, "self_device_time_total", 0.0)
                   for e in prof.key_averages())
    return total_us / 1e3 / reps if total_us > 0 else None


def bound(nbytes: float, flops: float) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# -- phase 2: kernels ---------------------------------------------------------


def kernel_inputs(torch, gen, dtype, T, B, H, peephole):
    def mk(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).to(dtype).cuda()

    xg = mk(B, 4 * H) if T is None else mk(T, B, 4 * H)
    rw = mk(H, 4 * H, scale=0.1)
    if peephole:
        p = [mk(H, scale=0.3) for _ in range(3)]
    else:
        p = [torch.zeros(H, dtype=dtype, device="cuda") for _ in range(3)]
    return [xg, rw, *p, mk(B, H, scale=0.5), mk(B, H, scale=0.5)]


def compare(torch, outs, refs, dtype):
    """(max abs err, max rel err, within tolerance) over paired outputs."""
    err = rel = 0.0
    ok = True
    for o, r in zip(outs, refs):
        o, r = o.float(), r.float()
        check(bool(torch.isfinite(o).all()), "kernel output is not finite")
        d = (o - r).abs()
        err = max(err, d.max().item())
        rel = max(rel, (d.max() / r.abs().max().clamp_min(1e-30)).item())
        if dtype == torch.float32:
            ok &= bool((d <= F32_ATOL).all())
        else:
            ok &= bool((d <= BF16_ULP * r.abs().clamp_min(1.0)).all())
    return err, rel, ok


def kernel_phase(torch, fl, seed):
    gen = torch.Generator().manual_seed(seed)
    H = HIDDEN
    specs = {
        "lstm_step": dict(fn=fl.lstm_step, ref=fl.lstm_step_reference,
                          shapes=[(None, b) for b in (1, 8, 64)],
                          timed=(None, 8)),
        "lstm_sequence": dict(fn=fl.lstm_sequence_forward,
                              ref=fl.lstm_sequence_forward_reference,
                              shapes=[(100, b) for b in (1, 8, 32)],
                              timed=(100, 32)),
    }
    rows = {}
    for name, sp in specs.items():
        errs = {torch.float32: 0.0, torch.bfloat16: 0.0}
        for dtype in (torch.float32, torch.bfloat16):
            for T, B in sp["shapes"]:
                for peep in (True, False):
                    a = kernel_inputs(torch, gen, dtype, T, B, H, peep)
                    outs = sp["fn"](*a)
                    torch.cuda.synchronize()
                    refs = sp["ref"](*a)
                    err, rel, ok = compare(torch, outs, refs, dtype)
                    print(f"  {name} {str(dtype)[6:]} T={T} B={B} "
                          f"peepholes={peep}: max abs {err:.3e} rel {rel:.3e}"
                          f" {'ok' if ok else 'OUT OF TOLERANCE'}")
                    check(ok, f"{name} disagrees with its plain version "
                              f"({dtype}, T={T}, B={B}, peepholes={peep})")
                    errs[dtype] = max(errs[dtype], err)
        T, B = sp["timed"]
        a = kernel_inputs(torch, gen, torch.float32, T, B, H, True)
        call = {"kernel": cuda_ms(torch, lambda: sp["fn"](*a)),
                "plain": cuda_ms(torch, lambda: sp["ref"](*a), reps=3)}
        dev = {"kernel": device_ms(torch, lambda: sp["fn"](*a)),
               "plain": device_ms(torch, lambda: sp["ref"](*a), reps=3)}
        steps = 1 if T is None else T
        nin = sum(t.numel() for t in a)
        nout = (2 * B * H) if T is None else (3 * T * B * H + T * B * 4 * H + B * H)
        b_ms, b_by = bound(4 * (nin + nout), 2.0 * steps * B * H * 4 * H)
        # the library yardstick computes the same function without
        # peepholes: input weights = identity on the 4H projections
        z = [torch.zeros(H, device="cuda") for _ in range(3)]
        eye = torch.eye(4 * H, device="cuda")
        rwT = a[1].t().contiguous()
        zb = torch.zeros(4 * H, device="cuda")
        if T is None:
            def lib():
                return torch.lstm_cell(a[0], (a[5], a[6]), eye, rwT, zb, zb)[0]
            ker_out = fl.lstm_step(a[0], a[1], *z, a[5], a[6])[0]
        else:
            lstm = torch.nn.LSTM(4 * H, H).cuda()
            with torch.no_grad():
                lstm.weight_ih_l0.copy_(eye)
                lstm.weight_hh_l0.copy_(rwT)
                lstm.bias_ih_l0.zero_()
                lstm.bias_hh_l0.zero_()
            hc = (a[5][None], a[6][None])

            def lib():
                with torch.no_grad():
                    return lstm(a[0], hc)[0]
            ker_out = fl.lstm_sequence_forward(a[0], a[1], *z, a[5], a[6])[0]
        call["library"] = cuda_ms(torch, lib)
        dev["library"] = device_ms(torch, lib)
        lib_diff = (lib() - ker_out).abs().max().item()
        ms = {k: dev[k] if dev[k] is not None else call[k] for k in call}
        source = "profiler" if dev["kernel"] is not None else "events"
        print(f"  {name} T={T} B={B} f32: device time per call ({source}) "
              f"kernel {ms['kernel']:.5f} ms, plain {ms['plain']:.5f} ms, "
              f"library {ms['library']:.5f} ms; bound {b_ms:.5f} ms by {b_by}; "
              f"wall time per back-to-back call (events) kernel "
              f"{call['kernel']:.5f} ms, plain {call['plain']:.5f} ms, library "
              f"{call['library']:.5f} ms; library vs kernel without "
              f"peepholes: max abs {lib_diff:.2e}")
        rows[name] = dict(err_f32=errs[torch.float32],
                          err_bf16=errs[torch.bfloat16], ms=ms["kernel"],
                          plain_ms=ms["plain"], library_ms=ms["library"],
                          ms_source=source, call_ms=call, bound_ms=b_ms,
                          bound_by=b_by, shape={"T": T, "B": B, "H": H})
    return rows


def backward_inputs(torch, fl, gen, dtype, T, B, H, peephole):
    """(forward inputs, backward inputs): the forward kernel's stashes of
    random inputs plus random cotangents dy, dcF."""
    a = kernel_inputs(torch, gen, dtype, T, B, H, peephole)
    _, acts, hprev, cprev, _ = fl.lstm_sequence_forward(*a)
    dy = torch.randn(T, B, H, generator=gen).to(dtype).cuda()
    dcF = torch.randn(B, H, generator=gen).to(dtype).cuda()
    return a, [acts, hprev, cprev, *a[1:5], dy, dcF]


def compare_backward(torch, outs, refs, dtype, T, B):
    """compare() for the seven backward outputs: (dxg, drw, dpi, dpf, dpo,
    dh0, dc0); the four sums get the sqrt(T*B) f32 tolerance."""
    err, ok = 0.0, True
    for i, (o, r) in enumerate(zip(outs, refs)):
        o, r = o.float(), r.float()
        check(bool(torch.isfinite(o).all()), "kernel output is not finite")
        d = (o - r).abs()
        err = max(err, d.max().item())
        if dtype == torch.float32:
            tol = F32_ATOL * (math.sqrt(T * B) if 1 <= i <= 4 else 1.0)
            ok &= bool((d <= tol).all())
        else:
            ok &= bool((d <= BF16_ULP * r.abs().clamp_min(1.0)).all())
    return err, ok


def backward_phase(torch, fl, seed):
    """The backward kernel against its plain version at the training
    segment (T=50, B=32, H=200) and a ragged shape (B not a multiple of
    the 8-row pass, H not a multiple of the 8-unit block), then its
    times at the training segment."""
    gen = torch.Generator().manual_seed(seed + 7)
    errs = {torch.float32: 0.0, torch.bfloat16: 0.0}
    for dtype in (torch.float32, torch.bfloat16):
        for T, B, H in ((TBPTT, 32, HIDDEN), (7, 5, 20)):
            for peep in (True, False):
                _, b = backward_inputs(torch, fl, gen, dtype, T, B, H, peep)
                outs = fl.lstm_sequence_backward(*b)
                torch.cuda.synchronize()
                refs = fl.lstm_sequence_backward_reference(*b)
                err, ok = compare_backward(torch, outs, refs, dtype, T, B)
                print(f"  lstm_sequence_backward {str(dtype)[6:]} T={T} B={B} "
                      f"H={H} peepholes={peep}: max abs {err:.3e} "
                      f"{'ok' if ok else 'OUT OF TOLERANCE'}")
                check(ok, f"lstm_sequence_backward disagrees with its plain "
                          f"version ({dtype}, T={T}, B={B}, H={H}, "
                          f"peepholes={peep})")
                errs[dtype] = max(errs[dtype], err)
    T, B, H = TBPTT, 32, HIDDEN
    a, b = backward_inputs(torch, fl, gen, torch.float32, T, B, H, True)
    call = {"kernel": cuda_ms(torch, lambda: fl.lstm_sequence_backward(*b)),
            "plain": cuda_ms(torch, lambda: fl.lstm_sequence_backward_reference(*b),
                             reps=3)}
    dev = {"kernel": device_ms(torch, lambda: fl.lstm_sequence_backward(*b)),
           "plain": device_ms(torch, lambda: fl.lstm_sequence_backward_reference(*b),
                              reps=3)}
    nin = sum(t.numel() for t in b)
    nout = T * B * 4 * H + H * 4 * H + 3 * H + 2 * B * H
    # dRW += hprev^T . dpre and dh = dpre . RW^T: 2 FLOP per term each
    b_ms, b_by = bound(4 * (nin + nout), 4.0 * T * B * H * 4 * H)
    # library yardstick, an approximation: cuDNN's LSTM backward at the
    # same shape without peepholes (input weights = identity on the 4H
    # projections, so it also runs an input-weight gradient GEMM that the
    # kernel leaves to autograd outside), timed as (forward + backward) -
    # forward, with TF32 off
    lstm = torch.nn.LSTM(4 * H, H).cuda()
    with torch.no_grad():
        lstm.weight_ih_l0.copy_(torch.eye(4 * H, device="cuda"))
        lstm.weight_hh_l0.copy_(a[1].t())
        lstm.bias_ih_l0.zero_()
        lstm.bias_hh_l0.zero_()
    x = a[0].clone().requires_grad_()
    hc = (a[5][None], a[6][None])
    dy = b[7]

    def lib_fwd():
        return lstm(x, hc)[0]

    def lib_fwd_bwd():
        lstm(x, hc)[0].backward(dy)

    fb, f = device_ms(torch, lib_fwd_bwd), device_ms(torch, lib_fwd)
    dev["library"] = None if fb is None or f is None else fb - f
    call["library"] = cuda_ms(torch, lib_fwd_bwd) - cuda_ms(torch, lib_fwd)
    ms = {k: dev[k] if dev[k] is not None else call[k] for k in call}
    source = "profiler" if dev["kernel"] is not None else "events"
    print(f"  lstm_sequence_backward T={T} B={B} f32: device time per call "
          f"({source}) kernel {ms['kernel']:.5f} ms, plain {ms['plain']:.5f} ms, "
          f"library (cuDNN fwd+bwd - fwd, approximate) {ms['library']:.5f} ms; "
          f"bound {b_ms:.5f} ms by {b_by}; wall time per back-to-back call "
          f"(events) kernel {call['kernel']:.5f} ms, plain {call['plain']:.5f} ms, "
          f"library {call['library']:.5f} ms")
    return dict(err_f32=errs[torch.float32], err_bf16=errs[torch.bfloat16],
                ms=ms["kernel"], plain_ms=ms["plain"], library_ms=ms["library"],
                ms_source=source, call_ms=call, bound_ms=b_ms, bound_by=b_by,
                shape={"T": T, "B": B, "H": H})


# -- phase 3: slice -----------------------------------------------------------


def slice_phase(torch, fl, helpers, net, seed):
    rng = np.random.default_rng(seed)
    x = np.eye(VOCAB, dtype=np.float32)[rng.integers(0, VOCAB, (32, 100))]
    fl.reset_launch_counts()
    out = net.output(x)
    torch.cuda.synchronize()
    launches = fl.launch_counts()
    check(tuple(out.shape) == (32, 100, VOCAB), f"output shape {tuple(out.shape)}")
    check(bool(torch.isfinite(out).all()), "output() is not finite")
    check(bool(((out.sum(-1) - 1).abs() < 1e-4).all()), "softmax rows do not sum to 1")
    check(launches["lstm_sequence"] >= 1,
          f"output() did not launch the sequence kernel: {launches}")
    for op in ("lstm_sequence", "lstm_decode_step"):
        helpers.set_helper_enabled(op, False)
    try:
        plain = net.output(x)
        torch.cuda.synchronize()
    finally:
        for op in ("lstm_sequence", "lstm_decode_step"):
            helpers.set_helper_enabled(op, True)
    err = (out - plain).abs().max().item()
    print(f"  output() [32, 100, {VOCAB}] vs helpers off: max abs {err:.3e} "
          f"(tolerance {SLICE_ATOL}); launches {launches}")
    check(err <= SLICE_ATOL, f"output() differs from the plain path by {err}")
    return {"max_abs_err": err, "launches": launches}


# -- phase 4: serve -----------------------------------------------------------


def greedy_reference(torch, net, prompt, max_new):
    """The sequential loop: one request at a time, one token per
    rnn_time_step call at batch 1."""
    net.clear_rnn_state()
    eye = np.eye(VOCAB, dtype=np.float32)
    out = None
    for t in prompt:
        out = net.rnn_time_step(eye[[t]])
    toks = []
    while len(toks) < max_new:
        g = int(torch.argmax(out[0]).item())
        toks.append(g)
        out = net.rnn_time_step(eye[[g]])
    net.clear_rnn_state()
    return toks


def serve(torch, DecodeEngine, metrics, net, waves, v2, fused):
    """Both waves through one engine, the weight swap between them.
    Returns (tokens per request, stats)."""
    metrics.get_registry().unregister("decode_step_seconds")
    eng = DecodeEngine(net, n_slots=8, tenant_weights={"a": 3.0, "b": 1.0},
                       component_prefix=f"smoke_k{fused}")
    eng.set_fused_steps(fused)
    try:
        outs = []
        t0 = time.perf_counter()
        for w, wave in enumerate(waves):
            if w == 1:
                v = eng.load_version(v2)
            futs = [eng.generate(p, max_new_tokens=m, tenant=t)
                    for p, m, t in wave]
            outs += [f.result(timeout=300) for f in futs]
        wall = time.perf_counter() - t0
        m = eng.metrics()
    finally:
        eng.shutdown()
    n = sum(len(w) for w in waves)
    check(m["conservation_ok"] and m["completed"] == n and m["shed"] == 0
          and m["failed"] == 0, f"books do not conserve: {m['tenants']}")
    check(m["swaps"] == 1 and m["version"] == v, f"weight swap not served: {m}")
    check(m["program_cache_size"] == 2, f"step functions rebuilt: {m}")
    hist = metrics.get_registry().get("decode_step_seconds").labels()
    stats = {"fused_steps": fused, "tokens": m["tokens"], "seconds": wall,
             "tokens_per_s": m["tokens"] / wall, "steps": m["steps"],
             "step_p50_s": hist.percentile(50), "step_p99_s": hist.percentile(99),
             "tenants": {t: b["completed"] for t, b in m["tenants"].items()}}
    return outs, stats


def serve_phase(torch, fl, DecodeEngine, metrics, net, seed, card):
    rng = np.random.default_rng(seed + 1)
    reqs = [(rng.integers(0, VOCAB, size=int(rng.integers(1, 33))).tolist(),
             int(rng.integers(32, 65)), "a" if i % 4 else "b")
            for i in range(24)]
    waves = [reqs[:12], reqs[12:]]
    v1 = net.params_list
    v2 = [{k: t * 1.01 for k, t in p.items()} for p in v1]
    fl.reset_launch_counts()
    out1, st1 = serve(torch, DecodeEngine, metrics, net, waves, v2, 1)
    out4, st4 = serve(torch, DecodeEngine, metrics, net, waves, v2, 4)
    torch.cuda.synchronize()
    launches = fl.launch_counts()
    check(launches["lstm_step"] >= 1,
          f"the decode engine did not launch the step kernel: {launches}")
    check(out4 == out1, "set_fused_steps(4) changed the emitted tokens")
    refs = [greedy_reference(torch, net, p, m) for p, m, _ in waves[0]]
    net.params_list = v2
    try:
        refs += [greedy_reference(torch, net, p, m) for p, m, _ in waves[1]]
    finally:
        net.params_list = v1
    bad = [i for i, (o, r) in enumerate(zip(out1, refs)) if o != r]
    check(not bad, f"engine tokens differ from the sequential loop for "
                   f"requests {bad}")
    for st in (st1, st4):
        print(f"  K={st['fused_steps']}: {st['tokens']} tokens in "
              f"{st['seconds']:.3f} s = {st['tokens_per_s']:.1f} tokens/s, "
              f"{st['steps']} steps, decode_step_seconds p50 "
              f"{st['step_p50_s']:.6f} p99 {st['step_p99_s']:.6f} on {card}")
    print(f"  24 requests equal the sequential rnn_time_step loop; launches "
          f"{launches}")
    # one more K=1 pass under the profiler: the device's busy share while
    # serving (device time of everything it ran over the pass's wall time)
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        outp, stp = serve(torch, DecodeEngine, metrics, net, waves, v2, 1)
    check(outp == out1, "the profiled pass emitted other tokens")
    busy_s = sum(getattr(e, "self_device_time_total", 0.0)
                 for e in prof.key_averages()) / 1e6
    busy = busy_s / stp["seconds"]
    print(f"  K=1 under the profiler: device busy {busy_s:.4f} s of "
          f"{stp['seconds']:.3f} s wall = busy share {busy:.4f}")
    return {"launches": launches, "k1": st1, "k4": st4,
            "profiled_k1": {**stp, "device_busy_s": busy_s, "busy_share": busy}}


# -- phase 5: train -----------------------------------------------------------


def corpus_batches(DataSet, seed, n):
    """`n` batches of [TRAIN_B, TRAIN_T, VOCAB] one-hot windows of SURVEY.md
    and, as labels, the same windows one character on. The 76 most
    frequent characters get a symbol each and the rest share the 77th;
    the window starts come from --seed."""
    with open(os.path.join(HERE, "SURVEY.md"), encoding="utf-8") as f:
        text = f.read()
    vocab = {ch: i for i, (ch, _) in
             enumerate(collections.Counter(text).most_common(VOCAB - 1))}
    ids = np.array([vocab.get(ch, VOCAB - 1) for ch in text])
    rng = np.random.default_rng(seed + 2)
    eye = np.eye(VOCAB, dtype=np.float32)
    out = []
    for _ in range(n):
        starts = rng.integers(0, len(ids) - TRAIN_T - 1, TRAIN_B)
        w = ids[starts[:, None] + np.arange(TRAIN_T + 1)]
        out.append(DataSet(eye[w[:, :-1]], eye[w[:, 1:]]))
    return out


def segment_grads(torch, net, ds):
    """Gradients of the loss of a one-segment DataSet at the net's current
    parameters, from zero h/c: what one optimizer step of fit uses."""
    x, y = net._as_data(ds.features), net._as_data(ds.labels)
    leaves = [v for p in net.params_list for v in p.values()]
    for v in leaves:
        v.requires_grad_(True)
    try:
        states = [{} for _ in range(LAYERS)] + [None]
        score, _ = net._loss(net.params_list, states, x, y, None, None, rng=None)
        return torch.autograd.grad(score, leaves)
    finally:
        for v in leaves:
            v.requires_grad_(False)


def train_phase(torch, fl, helpers, char_lstm_network, DataSet,
                ExistingDataSetIterator, IterationListener, seed, card):
    class Scores(IterationListener):
        """Each optimizer step's score, kept as a device tensor and read
        after the fit, so the listener adds no sync."""

        def __init__(self):
            self.scores = []

        def iteration_done(self, model, iteration, info):
            self.scores.append(info["score"]())

        def values(self):
            return [float(s) for s in self.scores]

    class StepClock(Scores):
        """Scores, plus the host clock after a device sync at each step."""

        def __init__(self):
            super().__init__()
            self.times = [time.perf_counter()]

        def iteration_done(self, model, iteration, info):
            torch.cuda.synchronize()
            self.times.append(time.perf_counter())
            super().iteration_done(model, iteration, info)

    def network(**kw):
        return char_lstm_network(vocab_size=VOCAB, hidden=HIDDEN, layers=LAYERS,
                                 tbptt_length=TBPTT, seed=seed,
                                 learning_rate=TRAIN_LR, **kw)

    def fit_scores(net, ds):
        """The scores of fitting `ds`, and the kernel launches it made."""
        log, before = Scores(), fl.launch_counts()
        net.set_listeners(log).fit(ExistingDataSetIterator([ds]))
        torch.cuda.synchronize()
        return log.values(), {k: v - before[k] for k, v in fl.launch_counts().items()}

    def helpers_off(fn):
        helpers.set_helper_enabled("lstm_sequence", False)
        try:
            return fn()
        finally:
            helpers.set_helper_enabled("lstm_sequence", True)

    # the main path: fit with a listener that only keeps the scores
    batches = corpus_batches(DataSet, seed, TRAIN_BATCHES)
    steps = TRAIN_BATCHES * (TRAIN_T // TBPTT)
    net = network()
    log = Scores()
    net.set_listeners(log)
    fl.reset_launch_counts()
    t0 = time.perf_counter()
    net.fit(ExistingDataSetIterator(batches))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = fl.launch_counts()
    scores = log.values()
    check(net.iteration == steps and len(scores) == steps,
          f"fit ran {net.iteration} optimizer steps, expected {steps}")
    check(all(math.isfinite(s) for s in scores), f"non-finite score: {scores}")
    check(scores[-1] < scores[0],
          f"the score did not fall: first {scores[0]}, last {scores[-1]}")
    for k in ("lstm_sequence", "lstm_sequence_backward"):
        check(launches[k] == LAYERS * steps,
              f"{k} launched {launches[k]} times in {steps} optimizer steps, "
              f"expected {LAYERS} per step")
    tokens = TRAIN_BATCHES * TRAIN_B * TRAIN_T
    # the same batches again, timed per step: the device synced at each
    clock = StepClock()
    net.set_listeners(clock).fit(ExistingDataSetIterator(batches))
    step_s = np.diff(clock.times)
    st = {"steps": steps, "tokens": tokens, "seconds": wall,
          "tokens_per_s": tokens / wall,
          "step_p50_s": float(np.percentile(step_s, 50)),
          "step_p99_s": float(np.percentile(step_s, 99)),
          "first_score": scores[0], "last_score": scores[-1], "scores": scores}
    print(f"  fit {TRAIN_BATCHES} x [{TRAIN_B}, {TRAIN_T}, {VOCAB}], TBPTT "
          f"{TBPTT}: {steps} optimizer steps, {tokens} tokens in {wall:.3f} s "
          f"= {st['tokens_per_s']:.1f} tokens/s (no per-step sync); a second "
          f"pass, device synced each step: step p50 {st['step_p50_s']:.6f} s "
          f"p99 {st['step_p99_s']:.6f} s (host clock) on {card}")
    print(f"  score first {scores[0]:.4f} last {scores[-1]:.4f}; launches {launches}")

    # one more fit batch under the profiler: the device's busy share and
    # the device time by kernel
    from torch.profiler import ProfilerActivity, profile

    net.set_listeners()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        net.fit(ExistingDataSetIterator(batches[:1]))
        torch.cuda.synchronize()
        wall1 = time.perf_counter() - t1
    rows = sorted(((e.key, getattr(e, "self_device_time_total", 0.0) / 1e3, e.count)
                   for e in prof.key_averages()), key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in rows)
    check(busy_ms > 0, "the profiler saw no device time in the fit batch")
    st["profiled_batch"] = {
        "seconds": wall1, "device_busy_s": busy_ms / 1e3,
        "busy_share": busy_ms / 1e3 / wall1,
        "top_device_ms": [{"name": n[:80], "ms": ms, "calls": c}
                          for n, ms, c in rows[:10]]}
    print(f"  one fit batch under the profiler: device busy {busy_ms / 1e3:.4f} s "
          f"of {wall1:.3f} s wall = busy share {busy_ms / 1e3 / wall1:.4f}; "
          f"device time by kernel:")
    for n, ms, c in rows[:10]:
        print(f"    {ms:9.3f} ms {100 * ms / busy_ms:5.1f}%  x{c:<5d} {n[:70]}")

    # helpers on vs off over the 20 segments of one fit batch, in lockstep:
    # each step from the same parameters and updater state, compared in
    # gradients, score, and the parameters and RMSProp state it leaves
    on = network()
    off, start = on.clone(), on.clone()
    grad_err = score_err = param_err = state_err = 0.0
    for k in range(TRAIN_T // TBPTT):
        sl = slice(k * TBPTT, (k + 1) * TBPTT)
        seg = DataSet(batches[0].features[:, sl], batches[0].labels[:, sl])
        before = [{n: v.clone() for n, v in p.items()} for p in on.params_list]
        off.params_list = [{n: v.clone() for n, v in p.items()} for p in before]
        off.upd_state = [{n: {s: v.clone() for s, v in u_n.items()} for n, u_n in u.items()}
                         for u in on.upd_state]
        g_on = segment_grads(torch, on, seg)
        g_off = helpers_off(lambda: segment_grads(torch, off, seg))
        s_off, n_off = helpers_off(lambda: fit_scores(off, seg))
        s_on, n_on = fit_scores(on, seg)
        for name in ("lstm_sequence", "lstm_sequence_backward"):
            check(n_off[name] == 0 and n_on[name] == LAYERS,
                  f"launches with the helpers off {n_off}, on {n_on}")
        grad_err = max(grad_err, *(((a - b).abs().max() / b.abs().max()).item()
                                   for a, b in zip(g_on, g_off)))
        score_err = max(score_err, abs(s_on[0] - s_off[0]) / abs(s_off[0]))
        diff_sq = step_sq = 0.0
        for p0, p_on, p_off in zip(before, on.params_list, off.params_list):
            for n in p0:
                diff_sq += (p_on[n] - p_off[n]).double().square().sum().item()
                step_sq += (p_off[n] - p0[n]).double().square().sum().item()
        param_err = max(param_err, math.sqrt(diff_sq / step_sq))
        state_err = max(state_err, *(
            ((u_on[n][s] - u_off[n][s]).abs().max() / u_off[n][s].abs().max()).item()
            for u_on, u_off in zip(on.upd_state, off.upd_state)
            for n in u_off for s in u_off[n]))
    print(f"  helpers on vs off, lockstep over the {TRAIN_T // TBPTT} segments of "
          f"one fit batch: gradients max |diff|/max|g| {grad_err:.3e} "
          f"(tolerance {TRAIN_GRAD_RTOL}), scores max relative diff "
          f"{score_err:.3e} (tolerance {TRAIN_SCORE_RTOL}); after each step, "
          f"params |diff|/|step| {param_err:.3e} (tolerance {TRAIN_PARAM_RTOL}), "
          f"RMSProp r max |diff|/max|r| {state_err:.3e} "
          f"(tolerance {TRAIN_STATE_RTOL})")
    check(grad_err <= TRAIN_GRAD_RTOL, f"gradients differ with the helpers off: {grad_err}")
    check(score_err <= TRAIN_SCORE_RTOL, f"scores differ with the helpers off: {score_err}")
    check(param_err <= TRAIN_PARAM_RTOL, f"steps differ with the helpers off: {param_err}")
    check(state_err <= TRAIN_STATE_RTOL,
          f"RMSProp state differs with the helpers off: {state_err}")

    # left to run free from the same parameters: the drift of helpers on
    # vs off beside its witness, the builtin loop on the card vs on the CPU
    free_on, _ = fit_scores(start.clone(), batches[0])
    free_off, _ = helpers_off(lambda: fit_scores(start.clone(), batches[0]))
    cpu = network(device="cpu")
    cpu.params_list = [{n: v.cpu() for n, v in p.items()} for p in start.params_list]
    free_cpu, _ = fit_scores(cpu, batches[0])
    drift = [abs(a - b) / abs(b) for a, b in zip(free_on, free_off)]
    witness = [abs(a - b) / abs(b) for a, b in zip(free_off, free_cpu)]
    print(f"  free-running fit batch, relative score drift by step: helpers on "
          f"vs off {' '.join(f'{d:.1e}' for d in drift)}; witness, builtin loop "
          f"on the card vs on the CPU {' '.join(f'{d:.1e}' for d in witness)}; "
          f"peaks {max(drift):.3e} vs {max(witness):.3e} (allowed "
          f"{DRIFT_FACTOR}x)")
    check(max(drift) <= DRIFT_FACTOR * max(witness),
          f"helpers on vs off drift {max(drift)} beyond {DRIFT_FACTOR}x the "
          f"rounding-only witness {max(witness)}")
    st["helpers_on_vs_off"] = {
        "grad_rel_err": grad_err, "score_rel_err": score_err,
        "param_rel_err": param_err, "state_rel_err": state_err,
        "free_running_drift": drift, "witness_drift_card_vs_cpu": witness}

    # one bf16 fit batch: the kernels in bf16, finite scores
    bscores, b_launches = fit_scores(network(precision="bf16"), batches[0])
    check(all(math.isfinite(s) for s in bscores), f"bf16 scores not finite: {bscores}")
    check(b_launches["lstm_sequence_backward"] == LAYERS * len(bscores),
          f"the bf16 fit did not run the backward kernel: {b_launches}")
    print(f"  bf16 fit batch: scores {bscores[0]:.4f} .. {bscores[-1]:.4f}, "
          f"all finite; launches {b_launches}")
    st["bf16"] = {"scores": bscores, "launches": b_launches}
    return {"launches": launches, "lr": TRAIN_LR, **st}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=os.path.join("chiprun_out", "chip_smoke.json"))
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from deeplearning4j_tpu_torch.common.dtypes import default_policy
    from deeplearning4j_tpu_torch.data import DataSet, ExistingDataSetIterator
    from deeplearning4j_tpu_torch.models.charlstm import char_lstm_network
    from deeplearning4j_tpu_torch.ops import cuda_build, helpers
    from deeplearning4j_tpu_torch.ops import fused_lstm as fl
    from deeplearning4j_tpu_torch.serving.decode import DecodeEngine
    from deeplearning4j_tpu_torch.train.listeners import IterationListener
    from deeplearning4j_tpu_torch.utils import metrics

    t_start = time.perf_counter()
    default_policy().apply()  # no TF32 anywhere, library yardsticks included
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"[1] device: {card} ({kind}); torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    info = cuda_build.build_all()
    print(f"  kernels built in {time.perf_counter() - t0:.2f} s")
    for name, rec in info.items():
        for line in rec["log"].splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    print(f"[2] kernels vs plain versions (tolerance: f32 {F32_ATOL} abs; "
          f"bf16 {BF16_ULP}*max(1, |plain|))")
    rows = kernel_phase(torch, fl, args.seed)
    print(f"  backward kernel: f32 {F32_ATOL} abs, {F32_ATOL}*sqrt(T*B) for "
          f"the sums dRW and dp; bf16 as above")
    rows["lstm_sequence_backward"] = backward_phase(torch, fl, args.seed)

    print("[3] slice: output() at full width")
    net = char_lstm_network(vocab_size=VOCAB, hidden=HIDDEN, layers=LAYERS,
                            seed=args.seed)
    sl = slice_phase(torch, fl, helpers, net, args.seed)

    print("[4] serve: DecodeEngine(n_slots=8), 24 requests, one swap, K=1 and K=4")
    sv = serve_phase(torch, fl, DecodeEngine, metrics, net, args.seed, card)

    print(f"[5] train: fit {TRAIN_BATCHES} batches of [{TRAIN_B}, {TRAIN_T}, "
          f"{VOCAB}] at full width, TBPTT {TBPTT}, RMSProp lr {TRAIN_LR}")
    tr = train_phase(torch, fl, helpers, char_lstm_network, DataSet,
                     ExistingDataSetIterator, IterationListener, args.seed, card)

    # each main path's count, read just after it ran from zero
    by_path = {"output": sl["launches"], "serve": sv["launches"],
               "train": tr["launches"]}
    main_launches = {name: sum(c[name] for c in by_path.values())
                     for name in rows}
    meta = {
        "lstm_step": ("deeplearning4j_tpu_torch/csrc/lstm_step.cu",
                      "deeplearning4j_tpu/ops/pallas_lstm.py:287"),
        "lstm_sequence": ("deeplearning4j_tpu_torch/csrc/lstm_sequence.cu",
                          "deeplearning4j_tpu/ops/pallas_lstm.py:133"),
        "lstm_sequence_backward": (
            "deeplearning4j_tpu_torch/csrc/lstm_sequence_bwd.cu",
            "deeplearning4j_tpu/ops/pallas_lstm.py:178"),
    }
    kernels = [{
        "name": name, "route": "cuda", "source": meta[name][0],
        "replaces": meta[name][1], "launches": main_launches[name],
        "launches_by_path": {p: c[name] for p, c in by_path.items()},
        "max_abs_err": r["err_f32"], "max_abs_err_bf16": r["err_bf16"],
        "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
        "bound_by": r["bound_by"], "library_ms": r["library_ms"],
        "ms_source": r["ms_source"], "call_ms": r["call_ms"],
        "shape": r["shape"],
    } for name, r in rows.items()]
    record = {"card": card, "kind": kind, "seed": args.seed,
              "kernels": kernels, "slice": sl, "serve": sv, "train": tr,
              "build": {k: v["seconds"] for k, v in info.items()},
              "seconds": time.perf_counter() - t_start}
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(record, f, indent=2)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

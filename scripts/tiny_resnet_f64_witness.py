#!/usr/bin/env python3
"""How far the tiny ResNet's three Nesterovs steps stand from an f64 run,
in the port and in the JAX package, on the CPU.

    JAX_PLATFORMS=cpu python scripts/tiny_resnet_f64_witness.py [--threads N] [--f32-stats]

The setting of tests/test_torch_resnet.py::test_three_nesterovs_steps_match_jax_fit[tiny-True]:
the same parameters and batch through the port's plain conv/BN kernels
and the JAX package's Pallas kernels (interpret mode), three steps at
lr 0.1; the witness is the port's plain path in f64. Prints, per
parameter tensor, each package's largest distance from the witness over
the witness's largest entry, then the median and worst of each and their
ratio (the tests hold the port to 1.5x the JAX package's), and the stem
BN's beta in all three. `--threads` sets torch's CPU threads; with
`--f32-stats` the conv statistics' plain sums accumulate in f32 in
torch's order (the port before the f64 accumulation of
ops/fused_conv_bn.py `_stats_of_stored`).
"""

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--threads", type=int, default=None)
    ap.add_argument("--f32-stats", action="store_true")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    import test_torch_resnet as T
    from deeplearning4j_tpu.ops import pallas_conv_bn as pcb
    from deeplearning4j_tpu_torch.common.dtypes import PrecisionPolicy
    from deeplearning4j_tpu_torch.ops import fused_conv_bn as fcb
    from deeplearning4j_tpu_torch.ops import helpers

    if args.threads:
        torch.set_num_threads(args.threads)
    helpers._HELPERS["conv2d"].supported = \
        lambda **c: fcb.conv_decision(**c)["status"] == "covered"
    helpers._HELPERS["batch_norm"].supported = \
        lambda **c: c["training"] and fcb.peek_stats(c["x"])
    helpers._HELPERS["bn_backward"].supported = lambda **c: c["training"]
    pcb._INTERPRET = True
    f64_stats = fcb._stats_of_stored
    if args.f32_stats:
        def f32_stats(y32, dtype, dims):
            yb = y32.to(dtype)
            yf = yb.to(y32.dtype)
            return yb, yf.sum(dims), (yf * yf).sum(dims)

        fcb._stats_of_stored = f32_stats

    jn, tn = T._pair("tiny")
    t64 = tn.clone()
    f64 = torch.float64
    t64.policy = PrecisionPolicy(param_dtype=f64, compute_dtype=f64, output_dtype=f64)
    t64.params_list = [{k: v.double() for k, v in p.items()} for p in t64.params_list]
    t64.state_list = [None if s is None else {k: v.double() for k, v in s.items()}
                      for s in t64.state_list]
    t64.upd_state = t64.updater_def.init_tree(t64.params_list)
    x, y = T._batch(2)
    T._fit_three(jn, tn, x, y)
    fcb._stats_of_stored = f64_stats  # the witness sums in f64 either way
    for _ in range(3):
        t64.fit(x.astype(np.float64), y.astype(np.float64), batch_size=len(x))

    port, jax_ = [], []
    for name, a, b, w in zip(tn.layer_vertex_names, tn.params_list, jn.params_list,
                             t64.params_list):
        for k in b:
            ref = w[k].numpy()
            scale = max(np.abs(ref).max(), 1e-30)
            port.append(np.abs(a[k].double().numpy() - ref).max() / scale)
            jax_.append(np.abs(np.asarray(b[k], np.float64) - ref).max() / scale)
            print(f"{name:>14} {k:>5} port {port[-1]:.3e} jax {jax_[-1]:.3e}")
    pm, jm = float(np.median(port)), float(np.median(jax_))
    print(f"threads {torch.get_num_threads()}, conv statistics summed in "
          f"{'f32' if args.f32_stats else 'f64'}: median port {pm:.3e} jax {jm:.3e} "
          f"ratio {pm / jm:.2f}; worst port {max(port):.3e} jax {max(jax_):.3e} "
          f"ratio {max(port) / max(jax_):.2f}")
    stem = tn.layer_vertex_names.index("stem_bn")
    print("stem_bn beta: witness", t64.params_list[stem]["beta"].numpy(),
          "port", tn.params_list[stem]["beta"].numpy(),
          "jax", np.asarray(jn.params_list[stem]["beta"]))
    return 0


if __name__ == "__main__":
    sys.exit(main())

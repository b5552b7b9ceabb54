"""Per-conv-instance kernel-coverage table, the port of the JAX package's
analysis/kernelcoverage.py.

Answers, for every ConvolutionLayer of a network conf, the question the
per-family roofline verdicts (analysis/costmodel) can only answer in
aggregate: WHICH conv instances route to the conv + BN-statistics
kernels (K4 for 1×1, K5 for k×k; `ops/fused_conv_bn`), which are
DECLINED by the per-instance roofline (compute-bound: the statistics
epilogue saves a read of the conv output worth nothing there, and
cuDNN's conv keeps them), and which are structurally unsupported.
Shapes come from `shapeflow.propagate_types` — pure config-graph
walking, no init, no trace, no device — so the table is cheap enough to
print on any host.

The decisions are computed in PLANNING mode by default
(`conv_decision(..., planning=True)`): the JAX package's economic stage
on the H100 SXM figures at bf16, on any host. It marks the instances
where the statistics epilogue buys nothing (at b128, where K4/K5 trail
cuDNN). With `planning=False` the table is what this process routes by:
the structural stage alone, since in the port a decline forces the BN's
builtin forward and costs more than it saves (ops/fused_conv_bn).
The contract `main` enforces: every instance resolves to covered or
declined-with-verdict; "unsupported" would be a conv shape the kernel
family silently misses.

In ResNet-50 every conv feeds its own batch norm, so a graphed training
step launches K4 once for each covered 1×1 instance, K5 once for each
covered k×k one, and K6 (the BN apply from the conv's statistics) once
for each covered instance of either: `launches_per_step` gives those
counts from a `planning=False` table.
"""

from __future__ import annotations

import logging
from typing import Dict, List, Optional, Tuple

logger = logging.getLogger("deeplearning4j_tpu_torch")


def conv_instances(conf, batch: int = 128) -> List[Tuple[str, dict]]:
    """(layer_name, probe_ctx) for every 2D ConvolutionLayer in a graph
    or multilayer conf, in topological order. probe_ctx is exactly the
    keyword context `nn/layers/conv.conv_forward` passes to the "conv2d"
    helper probe (minus dtype and device, which the caller supplies).
    Layers whose input type cannot be propagated are skipped."""
    from deeplearning4j_tpu_torch.analysis.shapeflow import propagate_types
    from deeplearning4j_tpu_torch.nn.conf import layers as L

    def ctx_for(layer, it) -> Optional[dict]:
        if it is None or not hasattr(it, "channels"):
            return None
        n_in = int(layer.n_in) if layer.n_in else int(it.channels)
        return dict(
            kernel=tuple(int(k) for k in layer.kernel_size),
            stride=tuple(int(s) for s in layer.stride),
            dilation=tuple(int(d) for d in layer.dilation),
            same=layer.convolution_mode == L.ConvolutionMode.SAME,
            has_bias=bool(layer.has_bias),
            activation=layer.activation or "identity",
            n_in=n_in,
            n_out=int(layer.n_out),
            x_shape=(int(batch), int(it.height), int(it.width), n_in),
            training=True,
        )

    out: List[Tuple[str, dict]] = []
    types = propagate_types(conf)
    if isinstance(types, list):  # MultiLayerConfiguration
        # layer i's INPUT is layer i-1's output (the propagated list is
        # outputs; shift by one, seeding with the conf input type)
        it = conf.input_type
        for i, layer in enumerate(conf.layers):
            pp = conf.preprocessors.get(str(i))
            if pp is not None and it is not None:
                try:
                    it = pp.output_type(it)
                except Exception:
                    it = None
            if type(layer) is L.ConvolutionLayer:
                ctx = ctx_for(layer, it)
                if ctx is not None:
                    out.append((f"layer{i}", ctx))
            it = types[i]
        return out
    for name in conf.topological_order():
        v = conf.vertices.get(name)
        layer = getattr(v, "layer", None)
        if type(layer) is not L.ConvolutionLayer:
            continue
        ins = conf.vertex_inputs.get(name, [])
        ctx = ctx_for(layer, types.get(ins[0]) if ins else None)
        if ctx is not None:
            out.append((name, ctx))
    return out


def coverage_table(conf, batch: int = 128, dtype=None,
                   planning: bool = True) -> List[dict]:
    """One row per conv instance: the layer name, its shape, and the
    `conv_decision` routing verdict (covered / declined / unsupported
    with reason, family slug and the roofline numbers that decided it).
    dtype defaults to bf16, the kernels' training dtype. With
    `planning=False` the verdicts are the ones this process routes by
    (structural; no roofline)."""
    import torch

    from deeplearning4j_tpu_torch.ops.fused_conv_bn import conv_decision

    if dtype is None:
        dtype = torch.bfloat16
    rows = []
    for name, ctx in conv_instances(conf, batch=batch):
        d = conv_decision(dtype=dtype, planning=planning, **ctx)
        row = {
            "layer": name,
            "kernel": list(ctx["kernel"]),
            "stride": list(ctx["stride"]),
            "x_shape": list(ctx["x_shape"]),
            "n_out": ctx["n_out"],
            "status": d["status"],
            "reason": d["reason"],
            "family": d["family"],
        }
        if d["roofline"] is not None:
            row["intensity"] = d["roofline"]["intensity"]
            row["ridge"] = d["roofline"]["ridge_intensity"]
        rows.append(row)
    return rows


def coverage_summary(rows: List[dict]) -> Dict[str, int]:
    counts = {"total": len(rows), "covered": 0, "declined": 0,
              "unsupported": 0}
    for r in rows:
        counts[r["status"]] = counts.get(r["status"], 0) + 1
    return counts


def launches_per_step(rows: List[dict]) -> Dict[str, int]:
    """K4, K5 and K6 launches of one training step of a net whose every
    conv feeds its own batch norm (ResNet-50), by the kernels' launch
    counter names (ops/fused_conv_bn.launch_counts)."""
    covered = [r for r in rows if r["status"] == "covered"]
    k4 = sum(1 for r in covered if tuple(r["kernel"]) == (1, 1))
    return {"conv1x1_stats": k4, "conv_kxk_stats": len(covered) - k4,
            "bn_apply": len(covered)}


def format_table(rows: List[dict]) -> str:
    s = coverage_summary(rows)
    lines = [f"conv kernel coverage: {s['total']} conv instances — "
             f"{s['covered']} covered, {s['declined']} declined "
             f"(roofline), {s['unsupported']} unsupported"]
    lines.append(f"  {'layer':<14} {'kernel':>6} {'stride':>6} "
                 f"{'input (NHWC)':>20} {'n_out':>5} {'FLOP/B':>8}  "
                 f"decision")
    for r in rows:
        k = "x".join(str(v) for v in r["kernel"])
        st = "x".join(str(v) for v in r["stride"])
        shape = "x".join(str(v) for v in r["x_shape"])
        inten = f"{r['intensity']:.0f}" if "intensity" in r else "-"
        verdict = r["status"]
        if r["status"] != "covered":
            verdict += f" ({r['reason']})"
        lines.append(f"  {r['layer']:<14} {k:>6} {st:>6} {shape:>20} "
                     f"{r['n_out']:>5} {inten:>8}  {verdict}")
    return "\n".join(lines)


def main(argv=None) -> int:
    """Kernel-coverage smoke: every conv instance of the preset resolves
    to covered or declined-with-verdict — a silently-unsupported shape
    fails, because that is a kernel-family hole nobody decided on.
    Prints the summary (and with --table the per-instance table) and
    exits 0 when the contract holds."""
    import argparse

    p = argparse.ArgumentParser(description=main.__doc__)
    p.add_argument("--preset", default="resnet50", choices=["resnet50"])
    p.add_argument("--batch", type=int, default=128)
    p.add_argument("--image", type=int, default=224)
    p.add_argument("--table", action="store_true",
                   help="print the full per-instance table")
    args = p.parse_args(argv)
    # operator surface: announce through the package logger (library
    # code configures no handler), as the server mains do
    if all(isinstance(h, logging.NullHandler) for h in logger.handlers):
        logging.basicConfig(level=logging.INFO, format="%(message)s")
    from deeplearning4j_tpu_torch.models.resnet import resnet50_conf

    conf = resnet50_conf(image_size=args.image)
    rows = coverage_table(conf, batch=args.batch)
    if args.table:
        logger.info("%s", format_table(rows))
    s = coverage_summary(rows)
    ok = s["unsupported"] == 0 and s["total"] > 0
    logger.info(
        "kernel coverage %s (batch %d, bf16): %d conv instances — "
        "%d covered, %d declined (roofline), %d unsupported -> %s",
        args.preset, args.batch, s["total"], s["covered"], s["declined"],
        s["unsupported"], "ok" if ok else "FAIL")
    if not ok:
        for r in rows:
            if r["status"] == "unsupported":
                logger.error(
                    "UNSUPPORTED: %s kernel=%s stride=%s reason=%s",
                    r["layer"], r["kernel"], r["stride"], r["reason"])
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())

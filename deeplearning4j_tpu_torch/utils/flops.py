"""FLOP accounting for MFU reporting, the port of the JAX package's
utils/flops.py.

`train_step_flops_for(net, batch)` is the one entry point: it traces the
net's optimizer step with the step cost model (analysis/costmodel.py, on
fake tensors with helpers off) and returns the MXU-family FLOPs the step
really runs (source `"costmodel"`). The hand-written per-layer estimator
— 2·MACs forward × 3 for the step, conf arithmetic copied onto the
port's conf classes — is the fallback for nets the cost model cannot
trace (no InputType on the conf) and the cheap lazy default the fit
loop's devprof sampling starts from (source `"analytic"`); every
surfaced number carries its `flops_source`.
Elementwise/normalization work stays out of the MFU numerator, as in the
JAX package (bandwidth-, not FLOPs-bound; keeps MFU comparable across
frameworks).

The device tables are NVIDIA's published H100 figures, looked up by the
name `torch.cuda.get_device_name` gives the card: the dense bf16 tensor
core peak and the HBM bandwidth. The HBM capacity is read from the card
(`total_memory`), and the link bandwidth from parallel/sharded.py's
LINK_BYTES_PER_S. Off the GPU, or on a card the tables do not know,
the lookups return None unless an environment override names a figure.
"""

from __future__ import annotations

import logging
import os
from typing import Optional, Tuple

from deeplearning4j_tpu_torch.nn.conf import layers as L
from deeplearning4j_tpu_torch.nn.conf.graph import (
    ComputationGraphConfiguration,
    LayerVertex,
)
from deeplearning4j_tpu_torch.nn.conf.inputs import RecurrentInput

logger = logging.getLogger("deeplearning4j_tpu_torch")

# NVIDIA H100 data sheet: dense bf16 tensor-core peak and HBM bandwidth
# of the SXM card (the one nvidia-smi names "NVIDIA H100 80GB HBM3").
# chip_smoke.py's bounds read these too.
H100_BF16_DENSE_FLOP_PER_S = 989e12
H100_HBM_BYTES_PER_S = 3.35e12

# (substring of the device name, figure): first match wins, so the PCIe
# card (756 TFLOP/s dense bf16, 2.0 TB/s HBM2e on the data sheet) sits
# before the SXM default
PEAK_BF16_FLOP_PER_S = (("H100 PCIe", 756e12), ("H100", H100_BF16_DENSE_FLOP_PER_S))
HBM_BYTES_PER_S = (("H100 PCIe", 2.0e12), ("H100", H100_HBM_BYTES_PER_S))


def _layer_forward_flops(conf, it) -> float:
    """Per-example forward FLOPs of one layer given its input type."""
    inner = conf.inner if isinstance(conf, L.FrozenLayer) else conf
    if isinstance(inner, L.ConvolutionLayer):
        out = inner.output_type(it)
        k = inner.kernel_size
        return 2.0 * k[0] * k[1] * inner.n_in * inner.n_out * out.height * out.width
    if isinstance(inner, L.Convolution1DLayer):
        out = inner.output_type(it)
        t = out.timesteps or (it.timesteps or 1)
        return 2.0 * inner.kernel_size * inner.n_in * inner.n_out * t
    if isinstance(inner, (L.LSTM, L.GravesLSTM, L.GravesBidirectionalLSTM)):
        t = it.timesteps or 1
        per_step = 2.0 * 4 * inner.n_out * (inner.n_in + inner.n_out)
        mult = 2 if isinstance(inner, L.GravesBidirectionalLSTM) else 1
        return per_step * t * mult
    if isinstance(inner, L.RnnOutputLayer):
        t = it.timesteps or 1
        return 2.0 * inner.n_in * inner.n_out * t
    if isinstance(inner, (L.DenseLayer, L.OutputLayer, L.CenterLossOutputLayer,
                          L.AutoEncoder)):
        return 2.0 * inner.n_in * inner.n_out
    return 0.0  # embedding (a gather), pooling, normalization, ...


def graph_forward_flops(conf: ComputationGraphConfiguration) -> Optional[float]:
    """Per-example forward FLOPs of a ComputationGraph, via a shape-
    inference walk of the topo order. None if input_types are unset."""
    if conf.input_types is None:
        return None
    types = dict(zip(conf.inputs, conf.input_types))
    total = 0.0
    for name in conf.topological_order():
        if name in types:
            continue
        v = conf.vertices[name]
        its = [types.get(i) for i in conf.vertex_inputs[name]]
        if any(i is None for i in its):
            types[name] = None
            continue
        if isinstance(v, LayerVertex):
            it = its[0]
            if v.preprocessor is not None:
                it = v.preprocessor.output_type(it)
            total += _layer_forward_flops(v.layer, it)
            types[name] = v.layer.output_type(it)
        else:
            types[name] = v.output_type(its)
    return total


def mln_forward_flops(conf) -> Optional[float]:
    """Per-example forward FLOPs of a MultiLayerConfiguration."""
    if conf.input_type is None:
        return None
    it = conf.input_type
    total = 0.0
    for i, layer in enumerate(conf.layers):
        pp = conf.preprocessors.get(str(i))
        if pp is not None:
            it = pp.output_type(it)
        total += _layer_forward_flops(layer, it)
        it = layer.output_type(it)
    return total


def train_step_flops(forward_flops: float, batch: int) -> float:
    """Analytic model FLOPs of one optimizer step: 3× forward (fwd +
    grad wrt activations + grad wrt weights), times the batch."""
    return 3.0 * forward_flops * batch


def forward_flops(conf) -> Optional[float]:
    """Per-example analytic forward FLOPs of either conf flavor."""
    if isinstance(conf, ComputationGraphConfiguration):
        return graph_forward_flops(conf)
    return mln_forward_flops(conf)


def _unbounded_recurrent(conf) -> bool:
    """Does this conf consume recurrent input with NO fixed timestep
    count? The per-layer walk then prices one timestep, and a
    "per-example" number derived from it would be ~seq_len× off."""
    its = getattr(conf, "input_types", None) \
        or (getattr(conf, "input_type", None),)
    return any(isinstance(it, RecurrentInput) and not it.timesteps
               for it in its if it is not None)


def analytic_step_flops_per_example(conf) -> Tuple[Optional[float], str]:
    """(per-example optimizer-step FLOPs, "analytic"). Recurrent confs
    without a fixed timestep count return (None, "analytic"): the walk
    prices ONE timestep, and an MFU from it would be ~seq_len× too small
    (fix the InputType's timesteps)."""
    if _unbounded_recurrent(conf):
        return None, "analytic"
    fwd = forward_flops(conf)
    if fwd is None or fwd <= 0:
        return None, "analytic"
    return 3.0 * fwd, "analytic"


def train_step_flops_for(net, batch: int, *, timesteps: int = 16,
                         prefer_cost_model: bool = True
                         ) -> Tuple[Optional[float], str]:
    """Model FLOPs of one of `net`'s optimizer steps at `batch` —
    `(flops, source)` where source is `"costmodel"` (a trace of the real
    step, MXU families only, helpers off: model FLOPs are
    implementation-independent) or `"analytic"` (the per-layer walk,
    with an unbounded recurrent input priced at `timesteps` steps)."""
    if prefer_cost_model:
        try:
            from deeplearning4j_tpu_torch.analysis.costmodel import train_step_cost

            cm = train_step_cost(net, batch_size=batch, timesteps=timesteps)
            if cm.model_flops > 0:
                return cm.model_flops, "costmodel"
        except Exception:
            logger.warning(
                "cost-model FLOP trace failed; falling back to the "
                "analytic per-layer estimate", exc_info=True)
    fwd = forward_flops(net.conf)
    if fwd is None or fwd <= 0:
        return None, "analytic"
    if _unbounded_recurrent(net.conf):
        fwd *= timesteps  # the analytic walk priced ONE timestep
    return train_step_flops(fwd, batch), "analytic"


# -- device figures ------------------------------------------------------------

def _env(var: str) -> Optional[float]:
    v = os.environ.get(var)
    return float(v) if v else None


def _cuda_device(device):
    import torch

    if device is None:
        return torch.device("cuda") if torch.cuda.is_available() else None
    device = torch.device(device)
    return device if device.type == "cuda" and torch.cuda.is_available() else None


def _by_name(table, device) -> Optional[float]:
    import torch

    dev = _cuda_device(device)
    if dev is None:
        return None
    name = torch.cuda.get_device_name(dev)
    for key, value in table:
        if key in name:
            return value
    return None


def peak_flops_per_chip(device=None) -> Optional[float]:
    """Dense bf16 tensor-core peak of the card (`BENCH_PEAK_FLOPS`
    overrides); None off the GPU or for a card the table does not know."""
    env = _env("BENCH_PEAK_FLOPS")
    return env if env is not None else _by_name(PEAK_BF16_FLOP_PER_S, device)


def peak_hbm_bytes_per_chip(device=None) -> Optional[float]:
    """Device memory capacity of the card, as the card reports it
    (`BENCH_HBM_BYTES` overrides); None off the GPU (a host's RAM is not
    the ceiling a residency rule is about)."""
    env = _env("BENCH_HBM_BYTES")
    if env is not None:
        return env
    import torch

    dev = _cuda_device(device)
    if dev is None:
        return None
    return float(torch.cuda.get_device_properties(dev).total_memory)


def hbm_bandwidth_per_chip(device=None) -> Optional[float]:
    """HBM bandwidth of the card (`BENCH_HBM_BANDWIDTH` overrides)."""
    env = _env("BENCH_HBM_BANDWIDTH")
    return env if env is not None else _by_name(HBM_BYTES_PER_S, device)


def link_bandwidth_per_chip(device=None) -> Optional[float]:
    """One card's link bandwidth each way, from parallel/sharded.py's
    LINK_BYTES_PER_S (`BENCH_LINK_BANDWIDTH` overrides)."""
    env = _env("BENCH_LINK_BANDWIDTH")
    if env is not None:
        return env
    from deeplearning4j_tpu_torch.parallel.sharded import link_bytes_per_s

    dev = _cuda_device(device)
    return None if dev is None else link_bytes_per_s(dev)

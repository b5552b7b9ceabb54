"""Recurrent layers: LSTM, GravesLSTM (peepholes), GravesBidirectionalLSTM.

Reference impl: nn/layers/recurrent/LSTMHelpers.java (fwd activateHelper
:62). Same parameters, layout and math as the JAX package's
nn/layers/recurrent.py:

- the input projection for ALL timesteps and ALL four gates is ONE batched
  product ([b,t,nIn] x [nIn,4H]);
- the sequential part holds only the [H,4H] recurrent product and the
  gate math. The builtin path is a Python loop over time; on a Hopper GPU
  the helper SPI hands it to the fused CUDA kernels (ops/fused_lstm.py),
  consulted at the same two places and under the same conditions as the
  JAX package's Pallas kernels.

Gate block layout in the fused [*, 4H] matrices: [i | f | g | o]
(input gate, forget gate, cell candidate, output gate).

Masking (variable-length sequences): at masked steps the carried (h, c)
pass through unchanged and the emitted output is zero.

Stateful inference: pass ctx.state = {"h": ..., "c": ...} to seed the
loop; the final state is returned so callers implement rnnTimeStep.
"""

from __future__ import annotations

import math

import torch

from deeplearning4j_tpu_torch.nn.conf import layers as L
from deeplearning4j_tpu_torch.nn.layers.core import apply_dropout
from deeplearning4j_tpu_torch.nn.layers.registry import LayerContext, register_layer
from deeplearning4j_tpu_torch.nn.weights import init_weights
from deeplearning4j_tpu_torch.ops.activations import apply_activation
from deeplearning4j_tpu_torch.ops.helpers import HelperError, get_helper


def _lstm_param_set(gen, n_in, n_out, conf, dtype, prefix=""):
    W = init_weights(gen, (n_in, 4 * n_out), n_in, n_out, conf.weight_init, conf.dist, dtype)
    RW = init_weights(gen, (n_out, 4 * n_out), n_out, n_out, conf.weight_init, conf.dist, dtype)
    b = torch.zeros((4 * n_out,), dtype=dtype)
    # forget-gate bias init (reference: LSTMParamInitializer sets the forget
    # block of the bias to forgetGateBiasInit, default 1.0)
    b[n_out: 2 * n_out] = conf.forget_gate_bias_init
    return {prefix + "W": W, prefix + "RW": RW, prefix + "b": b}


def _peephole_params(gen, n_out, dtype, prefix=""):
    scale = 1.0 / math.sqrt(float(n_out))
    return {
        prefix + k: (scale * torch.randn((n_out,), generator=gen)).to(dtype)
        for k in ("pI", "pF", "pO")
    }


def _peepholes(params, prefix, peephole, H, x):
    if peephole:
        return tuple(params[prefix + k].to(x.dtype).contiguous()
                     for k in ("pI", "pF", "pO"))
    zero = torch.zeros((H,), dtype=x.dtype, device=x.device)
    return zero, zero, zero


def _scan_lstm(conf, params, x, ctx, peephole: bool, prefix: str = "", reverse: bool = False):
    """Core loop. x: [batch, time, nIn] -> y [batch, time, H], final (h, c)."""
    H = int(conf.n_out)
    W = params[prefix + "W"]
    RW = params[prefix + "RW"].to(x.dtype).contiguous()
    b = params[prefix + "b"]
    gate_act = conf.gate_activation
    cell_act = conf.activation

    bsz = x.shape[0]
    xg = x @ W.to(x.dtype) + b.to(x.dtype)  # all-timestep input projection

    state = ctx.state or {}
    h0 = state.get("h")
    c0 = state.get("c")
    if h0 is None:
        h0 = torch.zeros((bsz, H), dtype=x.dtype, device=x.device)
    if c0 is None:
        c0 = torch.zeros((bsz, H), dtype=x.dtype, device=x.device)

    # vendor-kernel plugin point (the CudnnHelper analog): a registered
    # fused kernel takes over when it supports this configuration. On the
    # CPU a kernel that raises is disabled by the SPI (HelperError) and
    # the loop below runs instead; on a GPU its error propagates.
    if (x.shape[1] == 1 and ctx.mask is None and not reverse
            and not ctx.training and ctx.state is not None):
        # decode fast path: a [b, 1, nIn] STATEFUL inference step — the
        # serving decode engine's / rnn_time_step's shape — consults the
        # single-step kernel first, which writes no per-step stashes
        step_helper = get_helper(
            "lstm_decode_step", peephole=peephole,
            gate_act=conf.gate_activation, cell_act=conf.activation,
            device=x.device, H=H, dtype=x.dtype,
        )
        if step_helper is not None:
            pv = _peepholes(params, prefix, peephole, H, x)
            try:
                hF, cF = step_helper(xg[:, 0, :].contiguous(), RW, *pv,
                                     h0.contiguous(), c0.contiguous())
            except HelperError:
                pass  # fall through to the sequence helper / loop
            else:
                return hF[:, None, :], (hF, cF)

    # the sequence kernels' probe also needs the shape, and whether a
    # backward will run through the call (the backward kernel's variants
    # take fewer shapes than the forward's)
    backward = torch.is_grad_enabled() and any(
        t.requires_grad for t in (xg, RW, h0, c0, *params.values()))
    helper = get_helper(
        "lstm_sequence", peephole=peephole, mask=ctx.mask,
        gate_act=conf.gate_activation, cell_act=conf.activation,
        reverse=reverse, device=x.device, B=bsz, H=H, dtype=x.dtype,
        backward=backward,
    )
    if helper is not None:
        pv = _peepholes(params, prefix, peephole, H, x)
        try:
            ys, hF, cF = helper(xg.transpose(0, 1).contiguous(), RW, *pv,
                                h0.contiguous(), c0.contiguous())
        except HelperError:
            pass  # fall through to the built-in loop
        else:
            return ys.transpose(0, 1), (hF, cF)

    mask = ctx.mask
    if peephole:
        pI, pF, pO = (params[prefix + k].to(x.dtype) for k in ("pI", "pF", "pO"))

    h, c = h0, c0
    T = x.shape[1]
    ys = [None] * T
    for t in (range(T - 1, -1, -1) if reverse else range(T)):
        g = xg[:, t] + h @ RW  # [b, 4H]
        gi, gf, gg, go = g[:, :H], g[:, H: 2 * H], g[:, 2 * H: 3 * H], g[:, 3 * H:]
        if peephole:
            gi = gi + c * pI
            gf = gf + c * pF
        i = apply_activation(gate_act, gi)
        f = apply_activation(gate_act, gf)
        gg = apply_activation(cell_act, gg)
        c_new = f * c + i * gg
        if peephole:
            go = go + c_new * pO
        o = apply_activation(gate_act, go)
        h_new = o * apply_activation(cell_act, c_new)
        if mask is not None:
            m = mask[:, t].to(x.dtype)[:, None]
            h_new = m * h_new + (1 - m) * h
            c_new = m * c_new + (1 - m) * c
            ys[t] = h_new * m
        else:
            ys[t] = h_new
        h, c = h_new, c_new
    return torch.stack(ys, dim=1), (h, c)


def _make_lstm_forward(peephole: bool):
    def fwd(conf, params, x, ctx: LayerContext):
        x = apply_dropout(x, conf.dropout, ctx)
        y, (h, c) = _scan_lstm(conf, params, x, ctx, peephole)
        new_state = {"h": h, "c": c} if ctx.state is not None else None
        return y, new_state

    return fwd


def lstm_init(gen, conf: L.LSTM, dtype):
    return _lstm_param_set(gen, int(conf.n_in), int(conf.n_out), conf, dtype)


register_layer(L.LSTM, lstm_init, _make_lstm_forward(peephole=False),
               order_fn=lambda c: ("W", "RW", "b"))


def graves_lstm_init(gen, conf: L.GravesLSTM, dtype):
    p = _lstm_param_set(gen, int(conf.n_in), int(conf.n_out), conf, dtype)
    p.update(_peephole_params(gen, int(conf.n_out), dtype))
    return p


register_layer(L.GravesLSTM, graves_lstm_init, _make_lstm_forward(peephole=True),
               order_fn=lambda c: ("W", "RW", "b", "pI", "pF", "pO"))


# -- bidirectional -----------------------------------------------------------

def graves_bidirectional_init(gen, conf: L.GravesBidirectionalLSTM, dtype):
    p = _lstm_param_set(gen, int(conf.n_in), int(conf.n_out), conf, dtype, prefix="f_")
    p.update(_peephole_params(gen, int(conf.n_out), dtype, prefix="f_"))
    p.update(_lstm_param_set(gen, int(conf.n_in), int(conf.n_out), conf, dtype, prefix="b_"))
    p.update(_peephole_params(gen, int(conf.n_out), dtype, prefix="b_"))
    return p


def graves_bidirectional_forward(conf, params, x, ctx: LayerContext):
    x = apply_dropout(x, conf.dropout, ctx)
    # Bidirectional layers are never stateful (no streaming inference over a
    # future-dependent pass) — same restriction as the reference.
    fwd_ctx = LayerContext(training=ctx.training, rng=ctx.rng, mask=ctx.mask,
                           timesteps=ctx.timesteps, state=None)
    yf, _ = _scan_lstm(conf, params, x, fwd_ctx, peephole=True, prefix="f_")
    yb, _ = _scan_lstm(conf, params, x, fwd_ctx, peephole=True, prefix="b_", reverse=True)
    # element-wise ADD of directions (GravesBidirectionalLSTM.java:205)
    return yf + yb, None


register_layer(
    L.GravesBidirectionalLSTM, graves_bidirectional_init, graves_bidirectional_forward,
    order_fn=lambda c: ("f_W", "f_RW", "f_b", "f_pI", "f_pF", "f_pO",
                        "b_W", "b_RW", "b_b", "b_pI", "b_pF", "b_pO"),
)

"""Flattened parameter views and the weight carry-across from the JAX
package.

The reference's load-bearing design: one flat buffer for all params
(MultiLayerNetwork.java:102-104 flattenedParams/flattenedGradients), with
each layer's ParamInitializer defining its slice layout (nn/params/*). Here
parameters live as a list of per-layer dicts of tensors; the flat view is
the API for serialization, averaging and params()/setParams().

Flattening order: layer index ascending, then the layer's param_order()
names, each tensor row-major — the JAX package's order, so the two flat
vectors of one model are the same vector.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.common.devices import resolve_device
from deeplearning4j_tpu_torch.nn.layers.registry import init_layer_state, param_order


def num_params(layer_confs, params_list) -> int:
    return sum(
        p[name].numel()
        for conf, p in zip(layer_confs, params_list)
        for name in param_order(conf)
        if name in p
    )


def params_to_flat(layer_confs, params_list) -> torch.Tensor:
    """Concatenate all parameters into one 1-D vector (reference:
    flattenedParams view order)."""
    chunks = []
    for conf, p in zip(layer_confs, params_list):
        for name in param_order(conf):
            if name in p:
                chunks.append(p[name].reshape(-1))
    if not chunks:
        return torch.zeros((0,), dtype=torch.float32)
    return torch.cat(chunks)


def flat_to_params(layer_confs, params_list, flat) -> List[Dict]:
    """Inverse of params_to_flat: scatter a flat vector back into dicts
    with the same shapes, dtypes and devices as params_list."""
    out = []
    off = 0
    flat = torch.as_tensor(np.asarray(flat) if not torch.is_tensor(flat) else flat)
    for conf, p in zip(layer_confs, params_list):
        new = dict(p)
        for name in param_order(conf):
            if name in p:
                ref = p[name]
                n = ref.numel()
                new[name] = flat[off: off + n].reshape(ref.shape).to(
                    device=ref.device, dtype=ref.dtype)
                off += n
        out.append(new)
    if off != flat.shape[0]:
        raise ValueError(f"flat vector length {flat.shape[0]} != model params {off}")
    return out


def param_table(layer_confs, params_list) -> List[Tuple[str, Tuple[int, ...], int]]:
    """[(qualified_name, shape, size)] in flattening order — the analog of
    the reference's paramTable() keys like '0_W', '1_b'."""
    rows = []
    for i, (conf, p) in enumerate(zip(layer_confs, params_list)):
        for name in param_order(conf):
            if name in p:
                rows.append((f"{i}_{name}", tuple(p[name].shape), p[name].numel()))
    return rows


def _layer_confs(conf):
    """The layer confs in params_list order: a MultiLayerConfiguration's
    layers, a ComputationGraphConfiguration's layer vertices in topological
    order, or a list of layer confs as it is."""
    if hasattr(conf, "topological_order"):
        return [conf.vertices[n].layer for n in conf.topological_order()
                if hasattr(conf.vertices.get(n), "layer")]
    return getattr(conf, "layers", conf)


def _checked_copy(layers, dicts, expected, what, device):
    if len(layers) != len(dicts):
        raise ValueError(f"{len(dicts)} {what} dicts for {len(layers)} layers")
    out = []
    for i, (lc, d) in enumerate(zip(layers, dicts)):
        want = expected(lc)
        if set(d or {}) != want:
            raise ValueError(
                f"layer {i} ({type(lc).__name__}): {what} {sorted(d or {})} "
                f"!= expected {sorted(want)}")
        out.append(None if d is None else {
            k: torch.tensor(np.asarray(v), device=device) for k, v in d.items()})
    return out


def params_from_numpy(conf, params_list, *, device=None) -> List[Dict]:
    """The weight carry-across: the JAX package's `params_list` (one dict
    of arrays per layer, converted with `np.asarray`) as the port's params,
    so both packages compute the same function. The layouts are the same
    on both sides — LSTM W [nIn, 4H], RW [H, 4H], b [4H], pI/pF/pO [H]
    with gate blocks [i|f|g|o], dense/output W [nIn, nOut], conv W HWIO
    [kh, kw, nIn, nOut], BN gamma/beta [C] — so this is a checked copy:
    every layer must carry exactly its param_order() names. `conf` is the
    port's MultiLayerConfiguration, ComputationGraphConfiguration (layers in
    topological order) or a layer list. `device` follows the other entry
    points: "cuda" when None; pass device="cpu" (or the network's device)
    for the CPU."""
    return _checked_copy(
        _layer_confs(conf), params_list,
        lambda lc: set(param_order(lc)) if lc.has_params() else set(),
        "parameters", resolve_device(device))


def states_from_numpy(conf, state_list, *, device=None) -> List:
    """The JAX package's `state_list` (BatchNormalization running "mean"
    and "var" [C], None for stateless layers) as the port's, a checked copy
    in the order of `params_from_numpy`."""
    return _checked_copy(
        _layer_confs(conf), state_list,
        lambda lc: set(init_layer_state(lc, torch.float32) or {}),
        "state", resolve_device(device))

"""Tensor (model) parallelism over the "model" mesh axis.

The port of the JAX package's parallel/tensor.py. The JAX package places
Dense weights with NamedShardings and lets GSPMD insert the collectives;
the port keeps each rank's slice of W and b (and of their updater state)
and runs Megatron's pair of collectives in the Dense forward
(nn/layers/core.py), which reads the layer's role from its LayerContext:

  column layer (W [E, F] split on F): the input goes through
      `copy_to_axis` (identity forward, all-reduce backward), the output
      is this rank's F/m activations;
  row layer (W [F, E] split on F): the partial product x_local @ W_local
      is summed with `psum` (all-reduce forward, identity backward), then
      the replicated bias is added.

`shard_params_tp` applies the column/row alternation to a
MultiLayerNetwork's consecutive Dense layers; combine it with the "data"
axis (`mesh_2d`, then `net.set_mesh(mesh)`) for data plus tensor
parallelism: split leaves are reduced over the data axis only, alone
(parallel/sharded.CollectivePlan). `params()` and the model zip of a split
net give the gathered global values.
"""

from __future__ import annotations

from typing import List, Optional

import torch

from deeplearning4j_tpu_torch.nn.conf import layers as L
from deeplearning4j_tpu_torch.parallel.mesh import MODEL_AXIS, Mesh, _gather_list


def tp_dense_specs(layer_confs: List, axis: str = MODEL_AXIS):
    """Partition spec per layer param for the alternating column/row split
    of consecutive Dense layers, as tuples in the JAX package's
    PartitionSpec spelling: an entry per dim, the axis name where that dim
    is split, None where it is not; () is replicated. Layers that are not
    split get None. Output layers stay replicated (their nOut is the class
    count)."""
    specs = []
    col = True
    for lc in layer_confs:
        inner = lc.inner if isinstance(lc, L.FrozenLayer) else lc
        if isinstance(inner, L.DenseLayer):
            if col:
                specs.append({"W": (None, axis), "b": (axis,)})
            else:
                specs.append({"W": (axis, None), "b": ()})
            col = not col
        else:
            specs.append(None)
    return specs


def _split_dim(spec, axis: str) -> Optional[int]:
    return spec.index(axis) if spec and axis in spec else None


def tp_role(spec: Optional[dict], axis: str = MODEL_AXIS) -> Optional[str]:
    """"column", "row" or None for a layer's spec."""
    if not spec:
        return None
    return "column" if _split_dim(spec["W"], axis) == 1 else "row"


def shard_params_tp(net, mesh: Mesh, axis: str = MODEL_AXIS):
    """Keep this rank's slice of every split Dense W and b, and of their
    updater state, for the alternating column/row split over `mesh`'s
    `axis`. Training and inference then run tensor-parallel. Returns the
    per-layer specs."""
    net._require_init()
    if net.upd_state is None:
        net.upd_state = net.updater_def.init_tree(net.params_list)
    specs = tp_dense_specs(net.layer_confs, axis)
    m, idx = mesh.axis_size(axis), mesh.axis_index(axis)

    def cut(t, d):
        if d is None:
            return t
        if t.shape[d] % m:
            raise ValueError(f"dim {d} of {tuple(t.shape)} does not split over {m} ranks")
        c = t.shape[d] // m
        return t.narrow(d, idx * c, c).contiguous()

    for i, spec in enumerate(specs):
        if spec is None:
            continue
        for k, s in spec.items():
            d = _split_dim(s, axis)
            net.params_list[i][k] = cut(net.params_list[i][k], d)
            st = net.upd_state[i].get(k)
            if st is not None:
                net.upd_state[i][k] = {n: cut(v, d) for n, v in st.items()}
    net._tp_specs = specs
    net._tp_mesh = mesh
    net._tp_axis = axis
    net._reset_step_programs()
    if net._mesh_plan is not None:
        net._mesh_plan.invalidate()
    return specs


def gather_tp(net, tree):
    """`tree` (params_list, or upd_state: per-layer dicts of tensors or of
    dicts of tensors) with every split leaf gathered into its global
    tensor; leaves that are not split are returned as they are."""
    specs, mesh, axis = net._tp_specs, net._tp_mesh, net._tp_axis

    def gather(t, d):
        if d is None:
            return t
        with torch.no_grad():
            return torch.cat(_gather_list(t.contiguous(), mesh, axis), dim=d)

    out = []
    for layer, spec in zip(tree, specs):
        if spec is None or layer is None:
            out.append(layer)
            continue
        new = {}
        for k, v in layer.items():
            d = _split_dim(spec.get(k), axis)
            new[k] = ({n: gather(t, d) for n, t in v.items()} if isinstance(v, dict)
                      else gather(v, d))
        out.append(new)
    return out

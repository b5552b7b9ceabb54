"""The port's ResNet, built from a configuration file: the system under
test of the ResNet cells.

`build` calls the port's own preset builder (`models/resnet.resnet_conf`)
with the file's sizes, gives it the file's L2 weight decay as the
builder's `.l2()` would (the net's value, inherited by every layer at
build), and checks that the network holds the file's hyperparameters, so
the file is the configuration as run. `load` writes the benchmark's
weights into the network's own tensors, in place, so that no address a
captured CUDA graph reads moves. The other functions read what the
comparison judges.
"""

from __future__ import annotations

from typing import Dict


def build(cfg, device):
    from deeplearning4j_tpu_torch.models.resnet import resnet_conf
    from deeplearning4j_tpu_torch.nn.compgraph import ComputationGraph

    conf = resnet_conf(
        blocks=tuple(cfg["blocks"]), widths=tuple(cfg["widths"]),
        num_classes=int(cfg["num_classes"]), image_size=int(cfg["image_size"]),
        channels=int(cfg["channels"]), stem_width=int(cfg["stem_width"]),
        learning_rate=float(cfg["learning_rate"]), updater=cfg["updater"],
        precision=cfg["precision"])
    nc = conf.net_conf
    layers = [v.layer for v in conf.vertices.values() if getattr(v, "layer", None) is not None]
    nc.l2 = float(cfg["l2"])
    for layer in layers:
        if hasattr(layer, "l2"):
            layer.l2 = nc.l2
    got = {"updater": nc.updater, "learning_rate": nc.learning_rate,
           "momentum": nc.momentum, "precision": nc.precision, "l2": nc.l2}
    want = {k: cfg[k] for k in got}
    if got != want:
        raise ValueError(f"the port's resnet_conf gives {got}, the configuration says {want}")
    for layer in layers:
        if hasattr(layer, "eps") and (layer.eps, layer.decay) != (cfg["bn_eps"], cfg["bn_decay"]):
            raise ValueError(f"BN eps/decay {(layer.eps, layer.decay)} differ "
                             f"from the configuration's")
    return ComputationGraph(conf, device=device).init()


def _leaves(net, trees) -> Dict[str, object]:
    out = {}
    for name in net.layer_vertex_names:
        d = trees[net._pidx[name]]
        for k, v in (d or {}).items():
            out[f"{name}.{k}"] = v
    return out


def params(net) -> Dict[str, object]:
    """{"<vertex>.<param>": tensor}: the network's live parameters."""
    return _leaves(net, net.params_list)


def updater_state(net) -> Dict[str, object]:
    """{"<vertex>.<param>": tensor}: each leaf's Nesterovs velocity."""
    return {k: v["v"] for k, v in _leaves(net, net.upd_state).items()}


def load(net, weights) -> None:
    """Copy `weights` {"<vertex>.<param>": tensor} into the network's
    parameters and zero its updater state, in place."""
    import torch

    with torch.no_grad():
        live = params(net)
        if set(live) != set(weights):
            raise ValueError(f"weights {sorted(set(weights) ^ set(live))[:6]} do not "
                             f"match the network's parameters")
        for k, v in live.items():
            v.copy_(weights[k])
        for leaf in _leaves(net, net.upd_state).values():
            for t in leaf.values():
                t.zero_()


def step_losses(net):
    """The losses of the last fused dispatch's steps, as the program
    recorded them (one a step, in order)."""
    return [float(v) for v in net._fused_scores]

"""The port's Granite-4.0-H hybrid, built from a configuration file: the
system under test of the Granite cells.

`build` calls the port's preset builder
(`models/granite_hybrid.granite4h_conf`) with the file's published keys,
its depth and its Adam hyperparameters, and checks what the network holds
against the file. Leaves are "<vertex>.<param>", as the reference names
them. `updater_state` gives each leaf's Adam moments stacked, [m, v],
made one leaf at a time as it is read (the whole state is 7.6 GB at the
published widths), and the step count under "_t", which the reference's
Adam needs to follow from the program's state.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Dict


def build(cfg, device):
    from deeplearning4j_tpu_torch.models.granite_hybrid import granite4h_conf
    from deeplearning4j_tpu_torch.nn.compgraph import ComputationGraph

    conf = granite4h_conf(cfg, num_hidden_layers=int(cfg["num_hidden_layers"]),
                          learning_rate=float(cfg["learning_rate"]), beta1=float(cfg["beta1"]),
                          beta2=float(cfg["beta2"]), epsilon=float(cfg["epsilon"]),
                          precision=cfg["precision"])
    nc = conf.net_conf
    got = {"updater": nc.updater, "learning_rate": nc.learning_rate,
           "beta1": nc.adam_mean_decay, "beta2": nc.adam_var_decay, "epsilon": nc.epsilon,
           "precision": nc.precision}
    want = {k: cfg[k] for k in got}
    if got != want:
        raise ValueError(f"the port's granite4h_conf gives {got}, the configuration says {want}")
    return ComputationGraph(conf, device=device).init()


def _leaves(net, trees) -> Dict[str, object]:
    return {f"{name}.{k}": v for name, d in zip(net.layer_vertex_names, trees)
            for k, v in (d or {}).items()}


def params(net) -> Dict[str, object]:
    """{"<vertex>.<param>": tensor}: the network's live parameters."""
    return _leaves(net, net.params_list)


class _AdamState(Mapping):
    def __init__(self, net):
        import torch

        self._torch = torch
        self._mv = _leaves(net, net.upd_state)
        self._t = float(net.iteration)
        self._dev = next(iter(self._mv.values()))["m"].device

    def __getitem__(self, k):
        if k == "_t":
            return self._torch.tensor(self._t, device=self._dev)
        s = self._mv[k]
        return self._torch.stack([s["m"], s["v"]])

    def __iter__(self):
        yield from self._mv
        yield "_t"

    def __len__(self):
        return len(self._mv) + 1


def updater_state(net):
    """{"<vertex>.<param>": [m, v] stacked, "_t": the steps taken}."""
    return _AdamState(net)


def load(net, weights) -> None:
    """Copy `weights` into the network's parameters and zero its updater
    state, in place."""
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
    return [float(v) for v in net._fused_scores]

"""The port's char-LSTM, built from a configuration file: the system under
test of the char-LSTM cells.

`build` calls the port's preset builder (`models/charlstm.char_lstm_conf`)
with the file's sizes, gives it the example's L2 as the builder's `.l2()`
would (the net's value, inherited by every layer at build), and checks
the hyperparameters it holds against the file. `load` writes the benchmark's weights into the network's tensors in
place; the other functions read what the comparison judges.
"""

from __future__ import annotations

from typing import Dict


def build(cfg, device):
    from deeplearning4j_tpu_torch.models.charlstm import char_lstm_conf
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    conf = char_lstm_conf(
        vocab_size=int(cfg["vocab_size"]), hidden=int(cfg["hidden"]),
        layers=int(cfg["layers"]), tbptt_length=int(cfg["tbptt_length"]),
        learning_rate=float(cfg["learning_rate"]), precision=cfg["precision"])
    nc = conf.net_conf
    nc.l2 = float(cfg["l2"])
    for layer in conf.layers:
        layer.l2 = nc.l2
    got = {"updater": nc.updater, "learning_rate": nc.learning_rate,
           "rms_decay": nc.rms_decay, "epsilon": nc.epsilon, "precision": nc.precision,
           "l2": nc.l2}
    want = {k: cfg[k] for k in got}
    if got != want:
        raise ValueError(f"the port's char_lstm_conf gives {got}, the configuration says {want}")
    return MultiLayerNetwork(conf, device=device).init()


def _leaves(trees) -> Dict[str, object]:
    return {f"{i}.{k}": v for i, d in enumerate(trees) for k, v in (d or {}).items()}


def params(net) -> Dict[str, object]:
    """{"<layer index>.<param>": tensor}: the network's live parameters."""
    return _leaves(net.params_list)


def updater_state(net) -> Dict[str, object]:
    """{"<layer index>.<param>": tensor}: each leaf's RMSProp r."""
    return {k: v["r"] for k, v in _leaves(net.upd_state).items()}


def load(net, weights) -> None:
    """Copy `weights` {"<layer index>.<param>": tensor} into the network's
    parameters and zero its updater state, in place."""
    import torch

    with torch.no_grad():
        live = params(net)
        if set(live) != set(weights):
            raise ValueError(f"weights {sorted(set(weights) ^ set(live))[:6]} do not "
                             f"match the network's parameters")
        for k, v in live.items():
            v.copy_(weights[k])
        for leaf in _leaves(net.upd_state).values():
            for t in leaf.values():
                t.zero_()


def step_losses(net):
    return [float(v) for v in net._fused_scores]

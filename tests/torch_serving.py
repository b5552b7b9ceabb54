"""Shared fixtures of the port's serving tests: one small network built in
both packages with the same weights (carried by the model zip), seeded
request batches, an HTTP helper with a timeout on every call, and a
bounded wait.

    jnet, tnet = mlp_pair(tmp_path)       # JAX MLP and its port twin
    xs = requests([3, 5], n_in=12)        # numpy f32 batches, seeded
"""

from __future__ import annotations

import json
import os
import time
import urllib.error
import urllib.request
import uuid

import numpy as np

# every future and HTTP call in these tests is bounded by this many seconds
TIMEOUT = 30.0

# a fused or padded row against a per-request forward, both f32 on the CPU:
# the same expressions summed at another batch size (rows are not promised
# bit-equal: XLA's and torch's CPU matmuls may round differently per M)
ROW_RTOL, ROW_ATOL = 1e-5, 1e-6


def jax_mlp_conf(seed=7, n_in=12, hidden=16, n_out=4):
    from deeplearning4j_tpu.nn.conf import (
        DenseLayer,
        NeuralNetConfiguration,
        OutputLayer,
        Updater,
    )

    return (NeuralNetConfiguration.builder().seed(seed).updater(Updater.SGD)
            .learning_rate(0.05).weight_init("xavier").list()
            .layer(DenseLayer(n_in=n_in, n_out=hidden, activation="tanh"))
            .layer(OutputLayer(n_in=hidden, n_out=n_out, activation="softmax",
                               loss="mcxent"))
            .build())


def twin(jax_net, tmp_dir):
    """The port's network with the JAX network's weights, on the CPU."""
    from deeplearning4j_tpu.utils import model_serializer as jms
    from deeplearning4j_tpu_torch.utils import model_serializer as tms

    path = os.path.join(str(tmp_dir), f"serve-{uuid.uuid4().hex}.zip")
    jms.save_model(jax_net, path)
    return tms.load_model(path, device="cpu")


def mlp_pair(tmp_dir, **kw):
    from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork

    jnet = MultiLayerNetwork(jax_mlp_conf(**kw)).init()
    return jnet, twin(jnet, tmp_dir)


def two_head_pair(tmp_dir):
    """A ComputationGraph with two output heads (4 and 2 classes)."""
    from deeplearning4j_tpu.nn.compgraph import ComputationGraph
    from deeplearning4j_tpu.nn.conf import (
        DenseLayer,
        NeuralNetConfiguration,
        OutputLayer,
        Updater,
    )

    conf = (NeuralNetConfiguration.builder()
            .seed(7).updater(Updater.SGD).learning_rate(0.05)
            .weight_init("xavier").graph_builder()
            .add_inputs("in")
            .add_layer("d", DenseLayer(n_in=12, n_out=16, activation="tanh"),
                       "in")
            .add_layer("outA", OutputLayer(n_in=16, n_out=4,
                                           activation="softmax",
                                           loss="mcxent"), "d")
            .add_layer("outB", OutputLayer(n_in=16, n_out=2,
                                           activation="softmax",
                                           loss="mcxent"), "d")
            .set_outputs("outA", "outB")
            .build())
    jg = ComputationGraph(conf).init()
    return jg, twin(jg, tmp_dir)


def requests(sizes, n_in=12, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((s, n_in)).astype(np.float32) for s in sizes]


def host(a) -> np.ndarray:
    import torch

    if torch.is_tensor(a):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def http(url, payload=None, headers=None, timeout=TIMEOUT):
    """GET (payload None) or POST JSON; the decoded JSON body."""
    if payload is None:
        resp = urllib.request.urlopen(url, timeout=timeout)
    else:
        req = urllib.request.Request(
            url, data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json", **(headers or {})})
        resp = urllib.request.urlopen(req, timeout=timeout)
    with resp:
        return json.loads(resp.read())


def text_of(url, timeout=TIMEOUT) -> str:
    """GET; the body as text (the Prometheus exposition)."""
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return resp.read().decode()


def status_of(url, payload=None, raw=None, headers=None):
    """(HTTP status, decoded JSON body or None, response headers) of one
    call, error statuses included."""
    data = raw if raw is not None else (
        None if payload is None else json.dumps(payload).encode())
    req = urllib.request.Request(url, data=data, headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=TIMEOUT) as resp:
            body = resp.read()
            return resp.status, _json_or_none(body), dict(resp.headers)
    except urllib.error.HTTPError as e:
        with e:
            return e.code, _json_or_none(e.read()), dict(e.headers)


def _json_or_none(body):
    try:
        return json.loads(body)
    except ValueError:
        return None


def wait_until(pred, timeout=10.0, every=0.01):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(every)
    return pred()


def join_all(threads, timeout=TIMEOUT):
    for t in threads:
        t.join(timeout=timeout)
    assert not any(t.is_alive() for t in threads), "a client thread hung"

"""Recsys preset: an embedding table + dense tower classifier; the port
of the JAX package's models/recsys.py (the same configuration JSON).

One (optionally huge) EmbeddingLayer whose table can be declared
`host_resident=True` — row-sharded across parameter-server endpoints
and trained through the sparse pipeline (parallel/sparse), the card
seeing only the looked-up rows as the tower's input — followed by a
small dense tower. With `host_resident=False` the same conf is the
control: the table lives on the card and the net trains through the
normal fit.

`tower_init` / `tower_step` are the dense tower the parameter-server
recsys workload trains over a host-resident table (the JAX package's
`bench.py` `bench_recsys` tower): plain functions on tensors, the rows
of the batch's ids in, the tower's SGD update and the rows' delta out.
`train_over_paramserver` is one arm of that workload: fresh in-process
endpoints, a client and a SparseEmbeddingPipeline (cache and prefetch,
or neither: the synchronous arm), the tower on its tensors' device.
"""

from __future__ import annotations

import contextlib
import math
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.common.devices import resolve_device
from deeplearning4j_tpu_torch.nn.conf import (
    DenseLayer,
    EmbeddingLayer,
    InputType,
    NeuralNetConfiguration,
    OutputLayer,
    Updater,
)
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.parallel.paramserver import (
    EmbeddingParameterServer,
    EmbeddingPSClient,
)
from deeplearning4j_tpu_torch.parallel.sparse import SparseEmbeddingPipeline


def recsys_conf(vocab: int = 100_000, dim: int = 64, hidden: int = 128,
                classes: int = 2, host_resident: bool = True,
                seed: int = 7, learning_rate: float = 0.05):
    return (
        NeuralNetConfiguration.builder()
        .seed(seed)
        .updater(Updater.SGD)
        .learning_rate(learning_rate)
        .weight_init("xavier")
        .list()
        .layer(EmbeddingLayer(n_in=vocab, n_out=dim, has_bias=False,
                              activation="identity",
                              host_resident=host_resident))
        .layer(DenseLayer(n_out=hidden, activation="relu"))
        .layer(DenseLayer(n_out=hidden, activation="relu"))
        .layer(OutputLayer(n_out=classes, activation="softmax",
                           loss="mcxent"))
        .set_input_type(InputType.feed_forward(1))
        .build()
    )


def recsys_network(vocab: int = 100_000, dim: int = 64, hidden: int = 128,
                   classes: int = 2, host_resident: bool = True,
                   device=None, **kw) -> MultiLayerNetwork:
    """The preset on `device` ("cuda" when None; device="cpu" for the
    CPU)."""
    return MultiLayerNetwork(
        recsys_conf(vocab, dim, hidden, classes, host_resident, **kw),
        device=device).init()


TOWER_KEYS = ("w1", "b1", "w2", "b2", "w3", "b3")


def tower_init(dim: int = 64, hidden: int = 192, classes: int = 2,
               generator: torch.Generator = None, device=None
               ) -> Dict[str, torch.Tensor]:
    """He-scaled f32 normals for the three weights (std sqrt(2 / fan_in)),
    zero biases; drawn on the CPU from `generator` and moved to `device`
    ("cuda" when None), so the card and the CPU start from the same bits."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(0)

    def he(n_in, n_out):
        w = torch.randn((n_in, n_out), generator=generator, dtype=torch.float32)
        return (w * math.sqrt(2.0 / n_in)).to(dev)

    return {"w1": he(dim, hidden), "b1": torch.zeros(hidden, device=dev),
            "w2": he(hidden, hidden), "b2": torch.zeros(hidden, device=dev),
            "w3": he(hidden, classes), "b3": torch.zeros(classes, device=dev)}


def tower_loss(p: Dict[str, torch.Tensor], emb: torch.Tensor,
               y: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross-entropy of the two-ReLU-layer tower."""
    h = torch.relu(emb @ p["w1"] + p["b1"])
    h = torch.relu(h @ p["w2"] + p["b2"])
    logp = F.log_softmax(h @ p["w3"] + p["b3"], dim=1)
    return -logp.gather(1, y.view(-1, 1)).mean()


def tower_step(p: Dict[str, torch.Tensor], emb: torch.Tensor, y: torch.Tensor,
               lr: float) -> Tuple[Dict[str, torch.Tensor], torch.Tensor, torch.Tensor]:
    """One SGD step of the tower on the looked-up rows `emb` [B, dim] and
    int64 labels `y` [B]: (new params, the rows' delta (-lr) * dL/demb to
    push, loss)."""
    leaves = [p[k].detach().requires_grad_(True) for k in TOWER_KEYS]
    e = emb.detach().requires_grad_(True)
    loss = tower_loss(dict(zip(TOWER_KEYS, leaves)), e, y)
    grads = torch.autograd.grad(loss, leaves + [e])
    with torch.no_grad():
        new_p = {k: w - lr * g for k, w, g in zip(TOWER_KEYS, leaves, grads)}
        delta = (-lr) * grads[-1]
    return new_p, delta, loss.detach()


def train_over_paramserver(table: np.ndarray, batches: List[np.ndarray],
                           labels: List[np.ndarray], params: Dict[str, torch.Tensor],
                           *, lr: float, steps: Optional[int] = None, warmup: int = 0,
                           endpoints: int = 2, cache_rows: int = 0,
                           prefetch: bool = False, tenant: Optional[str] = None,
                           window=contextlib.nullcontext) -> dict:
    """Train the tower over `table` [vocab, dim] row-sharded on `endpoints`
    fresh in-process parameter servers: each step looks up `batches[k]`'s
    rows, prefetches the next batch's (with `prefetch`), runs `tower_step`
    on the device of `params` and pushes the rows' delta. The delta is
    copied to the host (blocking) before the push reads it. The steps from
    `warmup` on run inside `window()` and are timed (host clock, the
    device synced at both ends). Returns the tower, each endpoint's table
    after the pushes have landed (read in-process), the pipeline's books,
    its pull times and the timed window's seconds and examples."""
    n = len(batches) - 1 if steps is None else int(steps)
    dev = params["w1"].device
    ys = [torch.from_numpy(np.asarray(y, np.int64)).to(dev) for y in labels[:n]]

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    servers = [EmbeddingParameterServer({"emb": table.copy()}) for _ in range(endpoints)]
    client = None
    try:
        client = EmbeddingPSClient([f"http://127.0.0.1:{s.start()}" for s in servers],
                                   tenant=tenant)
        p = params
        with SparseEmbeddingPipeline(client, "emb", cache_rows=cache_rows,
                                     prefetch=prefetch) as pipe:
            if prefetch:
                pipe.prefetch(batches[0])
            stack = contextlib.ExitStack()
            t0 = time.perf_counter()
            try:
                for k in range(n):
                    if k == warmup:
                        sync()
                        stack.enter_context(window())
                        t0 = time.perf_counter()
                    emb = pipe.lookup(batches[k])
                    if prefetch and k + 1 < len(batches):
                        pipe.prefetch(batches[k + 1])
                    p, delta, _ = tower_step(p, torch.from_numpy(emb).to(dev), ys[k], lr)
                    pipe.push(batches[k], delta.cpu().numpy())
                sync()
                seconds = time.perf_counter() - t0
            finally:
                stack.close()
            stats = pipe.stats()
            pulls = sorted(pipe.pull_seconds)
        if not client.flush(timeout=60.0):
            raise RuntimeError("paramserver flush timed out")
        return {"params": p, "tables": [s.tables["emb"] for s in servers],
                "stats": stats, "pull_seconds": pulls, "seconds": seconds,
                "examples": int(sum(b.size for b in batches[warmup:n]))}
    finally:
        if client is not None:
            client.close()
        for s in servers:
            s.stop()

"""Rank bodies of the port's multi-process tests (run by
tests/torch_dist.run_ranks on gloo CPU processes). Each takes (rank,
world, ...) and returns numpy results; none imports JAX. Nets come in as
model zips the test process wrote from the JAX package's nets, data as
numpy arrays.
"""

from __future__ import annotations

import contextlib
import os

import numpy as np
import torch


def _leaves(tree):
    """[(name, numpy)] of a params/state list in tree order."""
    out = []
    for i, layer in enumerate(tree):
        if layer is None:
            continue
        for k in sorted(layer):
            v = layer[k]
            if isinstance(v, dict):
                for n in sorted(v):
                    out.append((f"{i}/{k}/{n}", v[n].detach().cpu().numpy().copy()))
            else:
                out.append((f"{i}/{k}", v.detach().cpu().numpy().copy()))
    return out


def _load(path):
    from deeplearning4j_tpu_torch.utils.model_serializer import load_model

    return load_model(path, device="cpu")


class _Tap:
    def __init__(self):
        from deeplearning4j_tpu_torch.train.listeners import IterationListener

        scores = self.scores = []

        class Tap(IterationListener):
            def iteration_done(self, model, iteration, info):
                scores.append(float(info["score"]()))

        self.listener = Tap()


def _books():
    from deeplearning4j_tpu_torch.utils.metrics import get_registry

    reg = get_registry()
    return {
        "bytes": reg.counter("allreduce_bytes_total", "").labels().value,
        "estimate": reg.counter("train_step_collective_seconds", "",
                                ("source",)).labels("estimate").value,
        "measured": reg.counter("train_step_collective_seconds", "",
                                ("source",)).labels("measured").value,
        "declined_collective": reg.counter("fit_graph_declined_total", "",
                                           ("reason",)).labels("collective").value,
    }


@contextlib.contextmanager
def fused_cpu_path(calls):
    """The three conv/BN probes at their structural scope (what a Hopper
    GPU routes), so CPU tensors go through the K4-K8 plain versions; the
    K6 and K7 plain-version calls are counted into `calls`."""
    from deeplearning4j_tpu_torch.ops import fused_conv_bn as fcb
    from deeplearning4j_tpu_torch.ops import helpers

    probes = {"conv2d": lambda **c: fcb.conv_decision(**c)["status"] == "covered",
              "batch_norm": lambda **c: c["training"] and fcb.peek_stats(c["x"]),
              "bn_backward": lambda **c: c["training"]}
    saved = {op: helpers._HELPERS[op].supported for op in probes}
    plain = {n: getattr(fcb, n) for n in ("bn_normalize_reference",
                                          "bn_backward_reduce_reference")}

    def counted(name, fn):
        def wrap(*a, **k):
            calls[name] = calls.get(name, 0) + 1
            return fn(*a, **k)
        return wrap

    for op, fn in probes.items():
        helpers._HELPERS[op].supported = fn
    for n, fn in plain.items():
        setattr(fcb, n, counted(n, fn))
    try:
        yield
    finally:
        for op, fn in saved.items():
            helpers._HELPERS[op].supported = fn
        for n, fn in plain.items():
            setattr(fcb, n, fn)


def _fit_record(net, data, *, batch_size, epochs, fused=1, prefetch=True,
                mesh=True, bucket_bytes=None, grad_dtype=None, listen=True,
                fused_bn=False):
    tap = _Tap()
    if mesh:
        net.set_mesh(bucket_bytes=bucket_bytes, grad_dtype=grad_dtype)
    if fused > 1:
        net.set_fused_steps(fused)
    if listen:
        net.set_listeners(tap.listener)
    b0 = _books()
    x, y = data
    calls = {}
    with fused_cpu_path(calls) if fused_bn else contextlib.nullcontext():
        net.fit(x, y, batch_size=batch_size, epochs=epochs, async_prefetch=prefetch)
    b1 = _books()
    rec = {"scores": tap.scores, "params": _leaves(net.params_list),
           "state": _leaves(net.state_list), "iteration": net.iteration,
           "books": {k: b1[k] - b0[k] for k in b0},
           "score": float(net._score), "plain_calls": calls}
    if net._mesh_plan is not None:
        rec["describe"] = net._mesh_plan.collective_describe(net)
        rec["payload"] = net._mesh_plan.grad_payload_bytes(net)
        rec["stats"] = net._mesh_plan.mesh.stats.snapshot()
    return rec


# -- data parallelism against the JAX package -----------------------------------------


def dp_cases(rank, world, cases):
    """`cases`: {name: (zip path, (x, y), fit kwargs)}; each net fit
    data-parallel over every rank."""
    torch.manual_seed(0)
    return {name: _fit_record(_load(path), data, **kw)
            for name, (path, data, kw) in cases.items()}


def bucket_cases(rank, world, zips, mlp_data, lstm_data):
    """Bucketed vs monolithic, fused, TBPTT and the bf16 wire (R ranks)."""
    out = {}
    for bb in (0, 512, None):
        out[f"mlp_bb{bb}"] = _fit_record(_load(zips["mlp"]), mlp_data, batch_size=16,
                                         epochs=2, bucket_bytes=bb)
    for bb in (0, 512):
        out[f"fused_bb{bb}"] = _fit_record(_load(zips["mlp"]), mlp_data, batch_size=16,
                                           epochs=2, bucket_bytes=bb, fused=2, listen=False)
    for bb in (0, 256):
        out[f"tbptt_bb{bb}"] = _fit_record(_load(zips["lstm"]), lstm_data, batch_size=16,
                                           epochs=2, bucket_bytes=bb)
    out["bf16"] = _fit_record(_load(zips["mlp"]), mlp_data, batch_size=16, epochs=2,
                              grad_dtype="bf16")
    # the measured probe: sampled at every step
    net = _load(zips["mlp"])
    from deeplearning4j_tpu_torch.parallel.sharded import MeshPlan
    from deeplearning4j_tpu_torch.parallel.mesh import data_parallel_mesh

    net.set_mesh(plan=MeshPlan(data_parallel_mesh(), bucket_bytes=512, sample_every=1))
    b0 = _books()
    net.fit(*mlp_data, batch_size=16, epochs=1)
    b1 = _books()
    out["sampled"] = {k: b1[k] - b0[k] for k in b0}
    return out


def bucket_bit_check(rank, world, zip_path, data):
    """Monolithic vs bucketed at this world size (gloo's ring order)."""
    return {bb: _fit_record(_load(zip_path), data, batch_size=16, epochs=2, bucket_bytes=bb)
            for bb in (0, 512)}


def noncontiguous_reduce(rank, world):
    """MeshPlan.reduce_grads with every leaf in a bucket of its own and one
    leaf a transposed view (what a cuDNN conv's weight gradient is through
    the HWIO layout): every rank gets the sum. Rank r's gradients are all
    r + 1."""
    from deeplearning4j_tpu_torch.nn.conf import (
        DenseLayer,
        NeuralNetConfiguration,
        OutputLayer,
    )
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    conf = (NeuralNetConfiguration.builder().seed(3).list()
            .layer(DenseLayer(n_in=6, n_out=5, activation="tanh"))
            .layer(OutputLayer(n_in=5, n_out=3, activation="softmax")).build())
    net = MultiLayerNetwork(conf, device="cpu").init()
    net.set_mesh(bucket_bytes=1)
    grads = [{k: torch.full_like(v, rank + 1.0) for k, v in p.items()}
             for p in net.params_list]
    # the output layer's W: a bucket of its own that the score does not
    # ride in (the buckets run from the last leaf to the first)
    grads[1]["W"] = torch.full((3, 5), rank + 1.0).t()
    assert not grads[1]["W"].is_contiguous()
    import torch.distributed as dist

    seen, real = [], dist.all_reduce

    def spy(t, *a, **k):  # NCCL refuses a tensor that is not contiguous
        seen.append(t.is_contiguous())
        return real(t, *a, **k)

    dist.all_reduce = spy
    try:
        out, score = net._mesh_plan.reduce_grads(net, grads, torch.tensor(rank + 1.0))
    finally:
        dist.all_reduce = real
    return {"grads": _leaves(out), "score": float(score), "contiguous": seen}


# -- the sharded step's surface -----------------------------------------------------


def sharded_surface(rank, world, zip_path, data, ckpt_dir, cg_zip):
    """Resume, auto mesh, unset_mesh, the wrapper, prefetch on/off, fused
    dispatch and the books, on R ranks."""
    import warnings

    from deeplearning4j_tpu_torch.data import DataSet, ListDataSetIterator
    from deeplearning4j_tpu_torch.parallel import ParallelWrapper
    from deeplearning4j_tpu_torch.train.checkpoint import CheckpointListener
    from deeplearning4j_tpu_torch.train.listeners import IterationListener

    x, y = data
    out = {}
    # prefetch on vs off: the same trajectory, and the books
    out["prefetch_on"] = _fit_record(_load(zip_path), data, batch_size=16, epochs=2)
    out["prefetch_off"] = _fit_record(_load(zip_path), data, batch_size=16, epochs=2,
                                      prefetch=False)
    out["fused"] = _fit_record(_load(zip_path), data, batch_size=16, epochs=2, fused=2,
                               listen=False)
    out["per_step"] = _fit_record(_load(zip_path), data, batch_size=16, epochs=2,
                                  listen=False)

    # sharded resume round-trip: crash after 5 steps, resume a fresh net
    class CrashAfter(IterationListener):
        def __init__(self, n):
            self.n = n

        def iteration_done(self, model, iteration, info):
            self.n -= 1
            if self.n == 0:
                raise RuntimeError("simulated preemption")

    crashed = _load(zip_path).set_mesh(bucket_bytes=512)
    crashed.set_listeners(CheckpointListener(ckpt_dir, every_n_iterations=1,
                                             every_n_epochs=None, keep_last=2),
                          CrashAfter(5))
    try:
        crashed.fit(x, y, batch_size=16, epochs=2, async_prefetch=False)
        out["crash_raised"] = False
    except RuntimeError as e:
        out["crash_raised"] = "simulated preemption" in str(e)
    out["ckpt_files"] = sorted(os.listdir(ckpt_dir)) if rank == 0 else None
    resumed = _load(zip_path).set_mesh(bucket_bytes=512)
    tap = _Tap()
    resumed.set_listeners(tap.listener)
    resumed.fit(x, y, batch_size=16, epochs=2, async_prefetch=False, resume_from=ckpt_dir)
    out["resumed"] = {"scores": tap.scores, "params": _leaves(resumed.params_list),
                      "iteration": resumed.iteration}
    out["ref_bucketed"] = _fit_record(_load(zip_path), data, batch_size=16, epochs=2,
                                      bucket_bytes=512)

    # auto mesh on (a plain fit under a process group) and off
    os.environ["DL4J_AUTO_MESH"] = "1"
    auto = _load(zip_path)
    out["auto_before"] = auto._mesh_plan is None
    auto.fit(x, y, batch_size=16, epochs=1)
    out["auto_after"] = None if auto._mesh_plan is None else auto._mesh_plan.n_data_shards
    out["auto_params"] = _leaves(auto.params_list)
    os.environ["DL4J_AUTO_MESH"] = "0"
    off = _load(zip_path)
    off.fit(x, y, batch_size=16, epochs=1)
    out["auto_off_plan"] = off._mesh_plan is None
    out["local_params"] = _leaves(off.params_list)
    # unset_mesh: single-process semantics again (each rank alone)
    auto.unset_mesh()
    out["unset_plan"] = auto._mesh_plan is None
    auto.fit(x, y, batch_size=16, epochs=1)
    out["unset_params"] = _leaves(auto.params_list)

    # the wrapper: deprecation, output == output, averaging_frequency,
    # workers stacking
    net = _load(zip_path)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        w = ParallelWrapper(net)
    out["deprecated"] = any(issubclass(c.category, DeprecationWarning) for c in caught)
    out["wrapper_out"] = w.output(x[:5]).numpy()
    out["plain_out"] = net.output(x[:5]).numpy()
    out["wrapper_out_19"] = w.output(x[:19]).numpy()
    out["plain_out_19"] = net.output(x[:19]).numpy()
    try:
        ParallelWrapper(_load(zip_path), averaging_frequency=4)
        out["avg_freq_rejected"] = False
    except ValueError:
        out["avg_freq_rejected"] = True
    st = _load(zip_path)
    ParallelWrapper(st, workers=2).fit(ListDataSetIterator(DataSet(x, y), 8), epochs=1,
                                       async_prefetch=False)
    gl = _load(zip_path)
    ParallelWrapper(gl).fit(x, y, batch_size=16, epochs=1, async_prefetch=False)
    out["stacked"] = _leaves(st.params_list)
    out["global"] = _leaves(gl.params_list)
    out["graph"] = _fit_record(_load(cg_zip), data, batch_size=16, epochs=2)
    return out


def dropout_draw(rank, world, data):
    """A dropout net fit data-parallel (or in one process at world 1):
    every rank draws the global batch's noise and keeps its rows."""
    from deeplearning4j_tpu_torch.nn.conf import (
        DenseLayer,
        NeuralNetConfiguration,
        OutputLayer,
        Updater,
    )
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    conf = (NeuralNetConfiguration.builder().seed(3).updater(Updater.SGD)
            .learning_rate(0.1).weight_init("xavier").list()
            .layer(DenseLayer(n_in=12, n_out=16, activation="relu", dropout=0.5))
            .layer(OutputLayer(n_in=16, n_out=4, activation="softmax", loss="mcxent",
                               dropout=0.8))
            .build())
    net = MultiLayerNetwork(conf, device="cpu").init()
    return _fit_record(net, data, batch_size=16, epochs=1, mesh=world > 1)


# -- multi-host -----------------------------------------------------------------------


def multihost_fit(rank, world, zip_path, local_batches, init_method):
    """`initialize_distributed` over TCP, then each rank fits its own local
    shards through MultiHostDataParallel.fit_local_shards."""
    from deeplearning4j_tpu_torch.data import DataSet, ExistingDataSetIterator
    from deeplearning4j_tpu_torch.parallel import multihost

    multihost.initialize_distributed(init_method, world, rank, backend="gloo", timeout=60)
    try:
        net = _load(zip_path)
        trainer = multihost.MultiHostDataParallel(net, multihost.global_data_parallel_mesh())
        tap = _Tap()
        net.set_listeners(tap.listener)
        it = ExistingDataSetIterator([DataSet(x, y) for x, y in local_batches[rank]])
        trainer.fit_local_shards(it, epochs=2)
        bad = None
        try:
            net._mesh_plan.__class__(net._mesh_plan.mesh).shard_batch(
                DataSet(np.zeros((3, 6), np.float32), np.zeros((3, 3), np.float32)))
        except ValueError as e:
            bad = str(e)
        return {"params": _leaves(net.params_list), "scores": tap.scores,
                "iteration": net.iteration, "indivisible": bad}
    finally:
        import torch.distributed as dist

        dist.destroy_process_group()


# -- tensor parallelism ---------------------------------------------------------------


def tp_fit(rank, world, zip_path, data, data_axis, model_axis):
    """shard_params_tp over a data x model mesh, then a fit (set_mesh when
    the data axis splits the batch)."""
    from deeplearning4j_tpu_torch.parallel import mesh_2d, shard_params_tp

    net = _load(zip_path)
    mesh = mesh_2d(data_axis, model_axis)
    shard_params_tp(net, mesh)
    shapes = [tuple(p["W"].shape) for p in net.params_list]
    if data_axis > 1:
        net.set_mesh(mesh)
    tap = _Tap()
    net.set_listeners(tap.listener)
    x, y = data
    net.fit(x, y, batch_size=32, epochs=2, async_prefetch=False)
    from deeplearning4j_tpu_torch.nn.params import flat_to_params

    glob = flat_to_params(net.layer_confs, net._global_params()[0], net.params())
    return {"shapes": shapes, "scores": tap.scores, "params": _leaves(glob),
            "local_shapes_after": [tuple(p["W"].shape) for p in net.params_list],
            "output": net.output(x[:8]).numpy()}


# -- pipeline and ring attention ------------------------------------------------------


def pipeline_cases(rank, world, cases):
    """`cases`: [(W [S, D, D], b [S, D], x, y or None, M)]: the pipelined
    output, and with y the gradients of mean((out - y)^2) of this rank's
    stage."""
    from deeplearning4j_tpu_torch.parallel.pipeline import (
        pipeline_apply,
        pipeline_parallel_mesh,
        shard_stage_params,
    )

    def stage(p, x):
        return torch.tanh(x @ p["W"] + p["b"])

    mesh = pipeline_parallel_mesh()
    out = []
    for W, b, x, y, M in cases:
        stacked = {"W": torch.tensor(W), "b": torch.tensor(b)}
        local = shard_stage_params(stacked, mesh)
        for v in local.values():
            v.requires_grad_(True)
        got = pipeline_apply(stage, local, torch.tensor(x), mesh=mesh, n_microbatches=M)
        rec = {"out": got.detach().numpy()}
        if y is not None:
            loss = ((got - torch.tensor(y)) ** 2).mean()
            gW, gb = torch.autograd.grad(loss, [local["W"], local["b"]])
            rec.update(gW=gW.numpy(), gb=gb.numpy(), loss=float(loss))
        out.append(rec)
    try:
        pipeline_apply(stage, shard_stage_params(
            {"W": torch.zeros(world, 8, 8), "b": torch.zeros(world, 8)}, mesh),
            torch.zeros(10, 8), mesh=mesh, n_microbatches=4)
        raised = None
    except ValueError as e:
        raised = str(e)
    return {"cases": out, "indivisible": raised}


def ring_cases(rank, world, q, k, v, proj):
    """ring_attention_sharded on this rank's blocks (causal and not, f32
    and bf16), with the gradients of sum(out^2) over the gathered output;
    ring_self_attention with projections, value and weight gradients."""
    from deeplearning4j_tpu_torch.parallel.mesh import Mesh, all_gather
    from deeplearning4j_tpu_torch.parallel.sequence import (
        SEQ_AXIS,
        ring_attention_sharded,
        ring_self_attention,
    )

    mesh = Mesh(np.arange(world), (SEQ_AXIS,))
    T = q.shape[1]
    Tl = T // world
    sl = slice(rank * Tl, (rank + 1) * Tl)
    out = {}
    for causal in (False, True):
        for dt in (torch.float32, torch.bfloat16):
            blocks = [torch.tensor(a[:, sl]).to(dt).requires_grad_(True) for a in (q, k, v)]
            o = ring_attention_sharded(*blocks, mesh=mesh, causal=causal)
            full = all_gather(o.transpose(0, 1).contiguous(), mesh, SEQ_AXIS).transpose(0, 1)
            loss = full.float().square().sum()
            grads = torch.autograd.grad(loss, blocks)
            key = f"{'causal' if causal else 'full'}_{str(dt)[6:]}"
            out[key] = {"out": full.detach().float().numpy(),
                        "grads": [g.float().numpy() for g in grads]}
    x, ws, heads = proj
    xt = torch.tensor(x).requires_grad_(True)
    wt = [torch.tensor(w).requires_grad_(True) for w in ws]
    o = ring_self_attention(xt, *wt, mesh=mesh, n_heads=heads, causal=True)
    loss = o.square().sum()
    grads = torch.autograd.grad(loss, [xt] + wt)
    out["self"] = {"out": o.detach().numpy(), "grads": [g.numpy() for g in grads]}
    out["staged_bytes"] = mesh.staged_bytes
    return out

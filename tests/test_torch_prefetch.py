"""The port's staged input pipeline (data/prefetch.py, data/transforms.py)
on the CPU.

Prefetch on and off must train to the same bits: the device stage only
moves each batch (on the CPU it wraps the host arrays as tensors) and runs
the input transform, which the loop otherwise runs inline with the same
per-batch step. `DeviceBatchTransform`'s normalize is held exactly against
the JAX package's; its flip and crop, for given decisions, exactly against
the JAX package's formulas in jnp (the random draws themselves differ:
another generator). A checkpoint taken under prefetch resumes on the same
batch, to the same bits, as one taken without.
"""

import os
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.data.dataset import DataSet as JDataSet
from deeplearning4j_tpu.data.transforms import DeviceBatchTransform as JTransform
from deeplearning4j_tpu_torch.data import (
    AsyncDataSetIterator,
    DataSet,
    DevicePrefetchIterator,
    DeviceBatchTransform,
    ListDataSetIterator,
    ParallelDataSetIterator,
)
from deeplearning4j_tpu_torch.data.iterators import PIPELINE_THREAD_PREFIX
from deeplearning4j_tpu_torch.models import resnet as tresnet
from deeplearning4j_tpu_torch.nn.compgraph import ComputationGraph
from deeplearning4j_tpu_torch.train.checkpoint import CheckpointListener, scan_checkpoints
from deeplearning4j_tpu_torch.utils import model_serializer as tms

from test_torch_fused_fit import _bit_equal, _cls_data, _mlp_conf, _ports, _rnn_conf, _seq_xy
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN
from deeplearning4j_tpu.nn.compgraph import ComputationGraph as JCG
from test_torch_fused_fit import _graph_conf


def _pipeline_threads():
    return [t for t in threading.enumerate() if t.name.startswith(PIPELINE_THREAD_PREFIX)]


def _fit_both(make, data, **kw):
    """The same net fitted with prefetch off and on."""
    nets = []
    for prefetch in (False, True):
        net = make()
        net.fit(*data, async_prefetch=prefetch, **kw)
        nets.append(net)
    return nets


@pytest.mark.parametrize("case", ["mlp", "mlp_fused", "tbptt", "tbptt_fused2", "graph"])
def test_prefetch_on_and_off_train_to_the_same_bits(case):
    if case.startswith("mlp"):
        jnet, data, kw = JMLN(_mlp_conf()).init(), _cls_data(96), {"batch_size": 24}
    elif case.startswith("tbptt"):
        jnet, data, kw = JMLN(_rnn_conf()).init(), _seq_xy(n=64), {"batch_size": 16}
    else:
        jnet, data, kw = JCG(_graph_conf()).init(), _cls_data(96), {"batch_size": 24}
    k = 4 if case == "mlp_fused" else 2 if case == "tbptt_fused2" else 1
    nets = iter(_ports(jnet))
    off, on = _fit_both(lambda: next(nets).set_fused_steps(k), data, epochs=2, **kw)
    _bit_equal(off, on)
    assert not _pipeline_threads()


def _images(n=12, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, 8, 8, 3)).astype(np.float32) * 2.0 + 0.5
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, n)]
    return x, y


def test_input_transform_inline_and_in_the_worker_train_alike():
    x, y = _images()

    def make():
        net = ComputationGraph(tresnet.tiny_resnet_conf(), device="cpu").init()
        return net.set_input_transform(DeviceBatchTransform(
            normalize=([0.5, 0.4, 0.6], [2.0, 1.5, 2.5]), random_flip=True,
            random_crop=2, seed=3))

    off, on = _fit_both(make, (x, y), epochs=2, batch_size=4)
    _bit_equal(off, on)
    assert off._input_transform._step == on._input_transform._step == 6


def test_normalize_is_exactly_the_jax_packages():
    x, y = _images(5)
    mean, std = [0.5, 0.4, 0.6], [2.0, 1.5, 2.5]
    port = DeviceBatchTransform(normalize=(mean, std))(DataSet(x, y))
    ref = JTransform(normalize=(mean, std))(JDataSet(x, y))
    assert np.array_equal(port.features.numpy(), np.asarray(ref.features))
    assert port.labels is y


def test_flip_and_crop_are_the_jax_packages_formulas_for_given_decisions():
    """The JAX package flips with jnp.where(flip, x[:, :, ::-1, :], x) and
    crops a zero-padded batch with a per-example dynamic_slice; the port,
    fed the same decisions, gives the same bits."""
    x, _ = _images(6)
    t = DeviceBatchTransform(random_flip=True, random_crop=2, seed=9)
    flip, offs = t.decisions(4, 6, "cpu")
    out = t.apply(torch.from_numpy(x), 4).numpy()
    f, o = jnp.asarray(flip.numpy()), offs.numpy()
    ref = jnp.where(f[:, None, None, None], jnp.asarray(x)[:, :, ::-1, :], jnp.asarray(x))
    ref = jnp.pad(ref, ((0, 0), (2, 2), (2, 2), (0, 0)))
    ref = np.stack([np.asarray(ref[i, o[i, 0]:o[i, 0] + 8, o[i, 1]:o[i, 1] + 8])
                    for i in range(6)])
    assert np.array_equal(out, ref)
    assert flip.any() and not flip.all() and (offs != 2).any()


def test_the_draws_depend_only_on_the_step():
    x, y = _images(6)
    t = DeviceBatchTransform(random_flip=True, random_crop=1, seed=2)
    a = [t(DataSet(x, y)).features for _ in range(3)]
    t.reset_steps()
    b = [t(DataSet(x, y)).features for _ in range(3)]
    assert all(torch.equal(p, q) for p, q in zip(a, b))
    assert not torch.equal(a[0], a[1])
    with pytest.raises(ValueError, match="NHWC"):
        t(DataSet(x.reshape(6, -1), y))


def _ckpt_run(tmp_path, name, prefetch, crash_after=None, resume=False):
    """One fit of the checkpoint child's net on a shuffling iterator, a
    listener saving every 4 iterations; `crash_after` raises out of the
    fit after that iteration's save."""
    from torch_fault_tolerance_child import build_data, build_net

    class Crash(RuntimeError):
        pass

    ckdir = str(tmp_path / name)
    net = build_net()
    lst = CheckpointListener(ckdir, every_n_iterations=4, every_n_epochs=None)

    class Stop:
        def iteration_done(self, model, iteration, info):
            if crash_after is not None and iteration == crash_after:
                raise Crash()

        def on_epoch_start(self, model, epoch):
            pass

        def on_epoch_end(self, model, epoch):
            pass

    net.set_listeners(lst, Stop())
    it = ListDataSetIterator(DataSet(*build_data()), 8, shuffle=True, seed=11)
    try:
        net.fit(it, epochs=2, async_prefetch=prefetch,
                resume_from=ckdir if resume else None)
    except Crash:
        pass
    return net, ckdir


def test_a_checkpoint_under_prefetch_resumes_on_the_same_batch(tmp_path):
    """Crash after iteration 9 (epoch 1, its 4th batch): the newest save
    (iteration 8) records the same epoch position and iterator state with
    prefetch on as off, and both resumes end on the uninterrupted run's
    bits."""
    ref, _ = _ckpt_run(tmp_path, "ref", prefetch=False)
    states = {}
    for prefetch in (False, True):
        _, ckdir = _ckpt_run(tmp_path, f"crash{prefetch}", prefetch, crash_after=9)
        _, newest = scan_checkpoints(ckdir)[-1]
        states[prefetch] = tms.read_train_state(os.path.join(ckdir, newest))
        resumed, _ = _ckpt_run(tmp_path, f"crash{prefetch}", prefetch, resume=True)
        _bit_equal(ref, resumed)
    assert states[False] == states[True]
    assert states[True]["batch_in_epoch"] == 3 and states[True]["epoch"] == 1
    assert not _pipeline_threads()


def test_parallel_iterator_keeps_the_base_order_and_raises_in_position():
    items = list(range(20))

    def slow_square(i):
        if i == 13:
            raise KeyError("bad record 13")
        return i * i

    it = ParallelDataSetIterator(items, transform=slow_square, workers=3)
    out = []
    with pytest.raises(KeyError, match="13"):
        for v in it:
            out.append(v)
    assert out == [i * i for i in range(13)]
    unordered = ParallelDataSetIterator(items[:10], transform=lambda i: i, workers=3,
                                        ordered=False)
    assert sorted(unordered) == list(range(10))
    assert not _pipeline_threads()


def test_device_stage_marks_batches_and_passes_the_resume_state_through():
    x, y = _cls_data(40)
    base = ListDataSetIterator(DataSet(x, y), 8, shuffle=True, seed=4)
    staged = DevicePrefetchIterator(AsyncDataSetIterator(base, 2), depth=2,
                                    device="cpu", close_base=True)
    batches = list(staged)
    assert len(batches) == 5
    assert all(b._pipeline_staged and torch.is_tensor(b.features) for b in batches)
    assert staged.state() == base.state() == {"epoch": 1}
    staged.restore_state({"epoch": 0})
    assert base.state() == {"epoch": 0}
    # breaking out of an epoch closes its workers
    for _ in staged:
        break
    staged.close()
    assert not _pipeline_threads()


def test_a_caller_built_device_stage_must_apply_the_nets_transform():
    x, y = _images(8)
    net = ComputationGraph(tresnet.tiny_resnet_conf(), device="cpu").init()
    net.set_input_transform(DeviceBatchTransform(normalize=(0.5, 2.0)))
    staged = DevicePrefetchIterator(ListDataSetIterator(DataSet(x, y), 4), device="cpu")
    with pytest.raises(ValueError, match="input transform"):
        net.fit(staged, epochs=1)
    assert not _pipeline_threads()

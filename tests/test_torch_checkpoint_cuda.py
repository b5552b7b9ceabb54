"""The port's checkpoint snapshot and async save on a Hopper GPU (`cuda`
marker; each test skips itself without one). The CPU half is
tests/test_torch_checkpoint.py.

This file imports nothing of JAX, so it runs where JAX is not installed:
`python -m pytest --noconftest tests/test_torch_checkpoint_cuda.py`.
"""

import os
import sys

import pytest
import torch

from deeplearning4j_tpu_torch.data import DataSet
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.train.checkpoint import CheckpointListener
from deeplearning4j_tpu_torch.train.listeners import (
    CollectScoresIterationListener,
    IterationListener,
)
from deeplearning4j_tpu_torch.utils import model_serializer as ms

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from torch_fault_tolerance_child import build_conf, build_data, build_iterator  # noqa: E402


@pytest.fixture(autouse=True)
def _require_hopper():
    if not (torch.cuda.is_available()
            and torch.cuda.get_device_capability() >= (9, 0)):
        pytest.skip("needs an NVIDIA GPU of compute capability >= 9.0")


class _Crash(IterationListener):
    class Boom(RuntimeError):
        pass

    def __init__(self, at):
        self.at = at

    def iteration_done(self, model, iteration, info):
        if iteration == self.at:
            raise self.Boom(f"crash after iteration {iteration}")


@pytest.mark.cuda
def test_snapshot_event_orders_the_write_after_the_capture(tmp_path):
    """The capture's clones run on a side stream behind ~0.1 s of device
    spinning, and an in-place update of the parameters is queued behind
    them; the write, on the default stream, starts at once. Only the capture's
    event orders the write after the clones, so the zip holds the
    captured bits only if the write waits on it."""
    from deeplearning4j_tpu_torch.utils.model_serializer import tree_leaves

    x, y = build_data()
    net = MultiLayerNetwork(build_conf(), device="cuda").init()
    net.fit(DataSet(x, y), epochs=1, batch_size=8)
    torch.cuda.synchronize()
    want_p = [t.cpu() for t in tree_leaves(net.params_list)]
    want_u = [t.cpu() for t in tree_leaves(net.upd_state)]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        torch.cuda._sleep(200_000_000)  # ~0.1 s at the H100's clocks
        snap = ms.ModelSnapshot.capture(net)
        for t in tree_leaves(net.params_list):
            t.add_(1.0)  # an in-place update, queued behind the clones
    assert isinstance(snap.ready, torch.cuda.Event)
    assert not side.query()  # the clones have not run yet
    path = str(tmp_path / "m.zip")
    snap.write(path)
    back = ms.load_model(path)
    assert back.device.type == "cuda"
    got_p = [t.cpu() for t in tree_leaves(back.params_list)]
    got_u = [t.cpu() for t in tree_leaves(back.upd_state)]
    assert all(torch.equal(a, b) for a, b in zip(got_p, want_p))
    assert all(torch.equal(a, b) for a, b in zip(got_u, want_u))
    torch.cuda.synchronize()
    assert not torch.equal(net.params().cpu(), back.params().cpu())


@pytest.mark.cuda
def test_async_save_during_a_fit_resumes_exactly(tmp_path):
    def run(resume_dir=None, listeners=()):
        net = MultiLayerNetwork(build_conf(), device="cuda").init()
        rec = CollectScoresIterationListener()
        net.set_listeners(*listeners, rec)
        try:
            net.fit(build_iterator(), epochs=2, resume_from=resume_dir)
        except _Crash.Boom:
            pass
        return net, dict(rec.scores)

    ref_net, ref = run()
    ckdir = str(tmp_path / "ck")
    lst = CheckpointListener(ckdir, every_n_iterations=3, every_n_epochs=None,
                             async_save=True, keep_last=0)
    run(listeners=(lst, _Crash(7)))
    lst.close()
    net, resumed = run(resume_dir=ckdir)
    assert min(resumed) == 7
    for it, sc in resumed.items():
        assert sc == ref[it]
    assert torch.equal(net.params(), ref_net.params())

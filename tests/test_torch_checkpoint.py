"""The port's checkpointing and mid-epoch resume (train/checkpoint.py,
nn/netbase.py `fit(resume_from=...)`) against the JAX package's.

The recovery contract: a port fit killed -9 mid-epoch and resumed with
`fit(resume_from=...)` continues to EXACTLY the loss curve of an
uninterrupted run (per-step scores ==, on the CPU); a mid-epoch
checkpoint written by the JAX package's fit resumes in the port to the
JAX package's own resume (rtol 1e-5, f32); a checkpoint taken between
two TBPTT segments of one batch counts that batch as consumed in both
packages (the reference's rule: resume starts at the next batch); and
the fit loop reads no device value unless a listener asks for one.
"""

import glob
import json
import os
import signal
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.data.dataset import DataSet as JDataSet
from deeplearning4j_tpu.data.iterators import ListDataSetIterator as JListIterator
from deeplearning4j_tpu.models.charlstm import char_lstm_conf as jchar_conf
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN
from deeplearning4j_tpu.ops import pallas_lstm
from deeplearning4j_tpu.train.checkpoint import CheckpointListener as JCheckpointListener
from deeplearning4j_tpu.train.listeners import (
    CollectScoresIterationListener as JCollect,
)
from deeplearning4j_tpu.train.listeners import IterationListener as JListener
from deeplearning4j_tpu.utils import model_serializer as jms
from deeplearning4j_tpu_torch.data import DataSet, ListDataSetIterator
from deeplearning4j_tpu_torch.nn.conf import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.train import checkpoint as tckpt
from deeplearning4j_tpu_torch.train.checkpoint import (
    CheckpointListener,
    NoUsableCheckpointError,
    describe_latest,
    latest_checkpoint,
    scan_checkpoints,
)
from deeplearning4j_tpu_torch.train.listeners import (
    CollectScoresIterationListener,
    IterationListener,
)
from deeplearning4j_tpu_torch.utils import model_serializer as tms
from deeplearning4j_tpu_torch.utils.metrics import get_registry

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHILD = os.path.join(REPO, "tests", "torch_fault_tolerance_child.py")
sys.path.insert(0, os.path.join(REPO, "tests"))

import fault_tolerance_child as jchild  # noqa: E402
from torch_fault_tolerance_child import build_conf, build_iterator, build_net  # noqa: E402

SCORE_RTOL = 1e-5


@pytest.fixture(autouse=True)
def _interpret_mode():
    old = pallas_lstm._INTERPRET
    pallas_lstm._INTERPRET = True
    yield
    pallas_lstm._INTERPRET = old


def _child_env():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env.pop("T1_BLACKBOX_ARTIFACT", None)
    return env


def _run_child_until_step(argv, kill_step, sig, wait_for_ckpt_in=None):
    """Start the port child, read STEP lines until `kill_step`, deliver
    `sig` (held until a finished checkpoint zip exists in
    `wait_for_ckpt_in`, so an async writer is never outrun). Returns
    (proc, {iteration: score})."""
    proc = subprocess.Popen(
        [sys.executable, CHILD] + argv, env=_child_env(), cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    steps = {}
    try:
        for line in proc.stdout:
            if line.startswith("STEP "):
                _, it, score = line.split()
                steps[int(it)] = float(score)
                if int(it) >= kill_step:
                    if (wait_for_ckpt_in is not None
                            and not glob.glob(os.path.join(
                                wait_for_ckpt_in, "checkpoint_iter*.zip"))):
                        continue
                    proc.send_signal(sig)
                    break
            elif line.startswith("FIT DONE"):
                break
    finally:
        try:
            proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
    return proc, steps


def _reference_scores(epochs=3):
    net = build_net()
    rec = CollectScoresIterationListener()
    net.set_listeners(rec)
    net.fit(build_iterator(), epochs=epochs)
    return dict(rec.scores)


def _clean_tmp_orphans(ckdir):
    # a killed async writer leaves its in-flight *.tmp behind by design
    for f in glob.glob(os.path.join(ckdir, "*.tmp*")):
        os.remove(f)


class _Crash(IterationListener):
    """Raise after iteration `at` — a simulated crash once the listeners
    before it (a checkpoint save) have run."""

    class Boom(RuntimeError):
        pass

    def __init__(self, at):
        self.at = at

    def iteration_done(self, model, iteration, info):
        if iteration == self.at:
            raise self.Boom(f"crash after iteration {iteration}")


class _JCrash(JListener):
    def __init__(self, at):
        self.at = at

    def iteration_done(self, model, iteration, info):
        if iteration == self.at:
            raise _Crash.Boom(f"crash after iteration {iteration}")


# -- kill -9 mid-fit, resume, same loss curve ------------------------------------


def test_sigkill_mid_fit_resume_matches_reference(tmp_path):
    ckdir = str(tmp_path / "ckpts")
    epochs = 3  # 6 batches/epoch -> 18 iterations
    proc, steps = _run_child_until_step(
        ["--mode", "fit", "--ckpt-dir", ckdir, "--epochs", str(epochs),
         "--async-save"], 9, signal.SIGKILL, wait_for_ckpt_in=ckdir)
    assert proc.returncode == -signal.SIGKILL, proc.stderr.read()
    _clean_tmp_orphans(ckdir)
    found = latest_checkpoint(ckdir)
    assert found is not None, "no checkpoint survived the kill"
    _, meta = found
    ref = _reference_scores(epochs)
    for it, sc in steps.items():
        assert sc == ref[it], f"child diverged from the reference at {it}"

    net = build_net()
    rec = CollectScoresIterationListener()
    net.set_listeners(rec)
    net.fit(build_iterator(), epochs=epochs, resume_from=ckdir)
    resumed = dict(rec.scores)
    assert resumed and net.iteration == epochs * 6
    assert min(resumed) == meta["iteration"]
    for it, sc in resumed.items():
        assert sc == ref[it], f"resumed run diverged at iteration {it}"


def test_sigterm_saves_before_the_dump_and_resumes_to_the_reference(tmp_path):
    """SIGTERM: the preemption save (PRIORITY_SAVE) runs, then the flight
    recorder's dump (which records the save), then the child dies with
    SIGTERM; the preemption checkpoint resumes to the reference."""
    ckdir, dump = str(tmp_path / "pre"), str(tmp_path / "dump.json")
    proc, _ = _run_child_until_step(
        ["--mode", "sigterm", "--ckpt-dir", ckdir, "--epochs", "50",
         "--dump", dump], 8, signal.SIGTERM)
    stderr = proc.stderr.read()
    assert proc.returncode == -signal.SIGTERM, stderr
    path, meta = latest_checkpoint(ckdir)
    assert meta["reason"] == "preemption", stderr
    with open(dump) as f:
        kinds = [e.get("kind") for e in json.load(f).get("events", [])]
    assert "checkpoint_saved" in kinds, kinds

    epochs = 3
    ref = _reference_scores(epochs)
    net = build_net()
    rec = CollectScoresIterationListener()
    net.set_listeners(rec)
    net.fit(build_iterator(), epochs=epochs, resume_from=ckdir)
    resumed = dict(rec.scores)
    assert resumed and min(resumed) == meta["iteration"]
    for it, sc in resumed.items():
        assert sc == ref[it], f"resumed run diverged at iteration {it}"


@pytest.mark.parametrize("window", ["before_commit", "after_commit"])
def test_a_sigterm_inside_a_step_saves_at_the_next_consistent_point(
        tmp_path, monkeypatch, window):
    """A SIGTERM raised inside optimizer step 8 (epoch 1, batch 2) — with
    the batch already counted but the parameters not yet updated, or
    after the updater's in-place commit but before the iteration is
    counted — is held: the preemption save runs once the step is whole,
    so it holds iteration 9 with batch 2 consumed, and a fresh net
    resumed from it scores the uninterrupted run's steps exactly."""
    from deeplearning4j_tpu_torch.train.updaters import UpdaterDef

    fire_at, epochs = 8, 2
    ref = _reference_scores(epochs)
    ckdir = str(tmp_path / "pre")
    delivered = []
    old_handler = signal.signal(signal.SIGTERM, lambda s, f: delivered.append(s))
    net = build_net()
    hook = "apply_tree" if window == "before_commit" else "step_"
    real = getattr(UpdaterDef, hook)

    def raising(self, *args):
        if window == "before_commit" and net.iteration == fire_at and not delivered:
            signal.raise_signal(signal.SIGTERM)  # its Python handler runs in here
        out = real(self, *args)
        if window == "after_commit" and net.iteration == fire_at and not delivered:
            signal.raise_signal(signal.SIGTERM)
        return out

    listener = CheckpointListener(ckdir, every_n_iterations=None,
                                  every_n_epochs=None, save_on_preemption=True)
    try:
        monkeypatch.setattr(UpdaterDef, hook, raising)
        net.set_listeners(listener)
        net.fit(build_iterator(), epochs=epochs)
        monkeypatch.setattr(UpdaterDef, hook, real)
    finally:
        listener.close()
        signal.signal(signal.SIGTERM, old_handler)
    assert delivered == [signal.SIGTERM]
    (it_saved, _), = scan_checkpoints(ckdir)
    path, meta = latest_checkpoint(ckdir)
    ts = tms.read_train_state(path)
    assert (meta["reason"], it_saved) == ("preemption", fire_at + 1)
    assert (ts["epoch"], ts["batch_in_epoch"]) == (1, 3)

    resumed_net = build_net()
    rec = CollectScoresIterationListener()
    resumed_net.set_listeners(rec)
    resumed_net.fit(build_iterator(), epochs=epochs, resume_from=ckdir)
    resumed = dict(rec.scores)
    assert sorted(resumed) == list(range(fire_at + 1, epochs * 6))
    for it, sc in resumed.items():
        assert sc == ref[it], f"resumed run diverged at iteration {it}"


# -- a JAX-written checkpoint resumes in the port ----------------------------------------


def test_jax_mid_epoch_checkpoint_resumes_in_the_port(tmp_path):
    """The JAX package's fit saves at iteration 4 (batch 5 of 6 in epoch
    0) and crashes; its own resume and the port's resume from that
    checkpoint score the same steps within rtol 1e-5."""
    assert (MultiLayerConfiguration.from_json(jchild.build_net().conf.to_json())
            .to_json() == build_conf().to_json())
    ckdir = str(tmp_path / "jax")
    jnet = jchild.build_net()
    jnet.set_listeners(JCheckpointListener(ckdir, every_n_iterations=4,
                                           every_n_epochs=None, keep_last=0),
                       _JCrash(4))
    with pytest.raises(_Crash.Boom):
        jnet.fit(jchild.build_iterator(), epochs=2, async_prefetch=False)
    (it_saved, _), = scan_checkpoints(ckdir)
    assert it_saved == 5

    jres = jchild.build_net()
    jrec = JCollect()
    jres.set_listeners(jrec)
    jres.fit(jchild.build_iterator(), epochs=2, resume_from=ckdir,
             async_prefetch=False)
    tres = build_net()
    trec = CollectScoresIterationListener()
    tres.set_listeners(trec)
    tres.fit(build_iterator(), epochs=2, resume_from=ckdir)
    j, t = dict(jrec.scores), dict(trec.scores)
    assert sorted(t) == sorted(j) == list(range(5, 12))
    np.testing.assert_allclose([t[i] for i in sorted(t)],
                               [j[i] for i in sorted(j)], rtol=SCORE_RTOL)
    assert tres.iteration == int(jres.iteration) == 12


# -- TBPTT: a save between segments consumes the batch -------------------------------------

_TB_T, _TB_SEG, _TB_BATCH = 8, 4, 2


def _tb_data():
    rng = np.random.default_rng(5)
    x = np.eye(7, dtype=np.float32)[rng.integers(0, 7, (3 * _TB_BATCH, _TB_T))]
    y = np.eye(7, dtype=np.float32)[rng.integers(0, 7, (3 * _TB_BATCH, _TB_T))]
    return x, y


def _tb_conf():
    return jchar_conf(vocab_size=7, hidden=8, layers=2,
                      tbptt_length=_TB_SEG, learning_rate=0.01)


def _truncating(iterator_cls):
    """The reference that skips the same segments: an iterator whose
    batch `b` of epoch 0 is cut to its first `segments` TBPTT segments."""

    class Truncate(iterator_cls):
        def __init__(self, base, b, segments):
            self.base, self.b, self.segments = base, b, segments
            self.epoch = 0

        def __iter__(self):
            for i, ds in enumerate(self.base):
                if self.epoch == 0 and i == self.b:
                    cut = slice(0, self.segments * _TB_SEG)
                    ds = type(ds)(ds.features[:, cut], ds.labels[:, cut])
                yield ds
            self.epoch += 1

        def reset(self):
            self.base.reset()

    return Truncate


@pytest.fixture(scope="module")
def tb_init(tmp_path_factory):
    """One set of initial weights for both packages: the JAX net's init,
    through the zip."""
    path = str(tmp_path_factory.mktemp("tb") / "init.zip")
    jms.save_model(JMLN(_tb_conf()).init(), path)
    return path


def _tb_run(pkg, init, ckdir=None, crash_at=None, resume=False, truncate=None):
    x, y = _tb_data()
    if pkg == "jax":
        net = jms.load_model(init)
        it = JListIterator(JDataSet(x, y), _TB_BATCH, shuffle=True, seed=3)
        rec, ck, crash = JCollect, JCheckpointListener, _JCrash
        kw = {"async_prefetch": False}
    else:
        net = tms.load_model(init, device="cpu")
        it = ListDataSetIterator(DataSet(x, y), _TB_BATCH, shuffle=True, seed=3)
        rec, ck, crash = CollectScoresIterationListener, CheckpointListener, _Crash
        kw = {}
    if truncate is not None:
        it = _truncating(type(it).__mro__[1])(it, *truncate)
    rec = rec()
    listeners = [rec]
    if crash_at is not None:
        listeners = [ck(ckdir, every_n_iterations=2, every_n_epochs=None,
                        keep_last=0), crash(crash_at)]
    net.set_listeners(*listeners)
    try:
        net.fit(it, epochs=2, resume_from=ckdir if resume else None, **kw)
    except _Crash.Boom:
        pass
    return net, dict(rec.scores)


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_a_checkpoint_between_tbptt_segments_resumes_at_the_next_batch(
        pkg, tb_init, tmp_path):
    """Batches of 2 segments; a save after iteration 2 (batch 1's FIRST
    segment) records batch_in_epoch 2, so resume skips batch 1's second
    segment and starts at batch 2 — the run equals a reference whose
    batch 1 stops after one segment."""
    ckdir = str(tmp_path / pkg)
    _tb_run(pkg, tb_init, ckdir, crash_at=2)
    (it_saved, name), = scan_checkpoints(ckdir)
    assert it_saved == 3
    from deeplearning4j_tpu_torch.utils.model_serializer import read_train_state

    ts = read_train_state(os.path.join(ckdir, name))
    assert ts["epoch"] == 0 and ts["batch_in_epoch"] == 2
    net, resumed = _tb_run(pkg, tb_init, ckdir, resume=True)
    _, ref = _tb_run(pkg, tb_init, truncate=(1, 1))
    assert min(resumed) == 3 and int(net.iteration) == 11
    assert sorted(ref) == list(range(11))
    for it, sc in resumed.items():
        assert sc == ref[it], f"{pkg}: resumed iteration {it} differs"


def test_tbptt_resume_agrees_across_packages(tb_init, tmp_path):
    for pkg in ("jax", "port"):
        _tb_run(pkg, tb_init, str(tmp_path / pkg), crash_at=2)
    _, j = _tb_run("jax", tb_init, str(tmp_path / "jax"), resume=True)
    _, t = _tb_run("port", tb_init, str(tmp_path / "port"), resume=True)
    assert sorted(t) == sorted(j)
    np.testing.assert_allclose([t[i] for i in sorted(t)],
                               [j[i] for i in sorted(j)], rtol=SCORE_RTOL)


# -- fallbacks and errors ----------------------------------------------------------


def _save_two(ckdir):
    net = build_net()
    listener = CheckpointListener(ckdir, keep_last=0)
    p1 = listener.save(net, reason="manual")
    net.iteration += 5
    p2 = listener.save(net, reason="manual")
    return net, p1, p2


def test_empty_dir_is_a_fresh_start(tmp_path):
    ckdir = str(tmp_path / "fresh")
    os.makedirs(ckdir)
    assert latest_checkpoint(ckdir) is None and describe_latest(ckdir) is None
    net = build_net()
    net.fit(build_iterator(), epochs=1, resume_from=ckdir)
    assert net.iteration == 6


def test_torn_latest_json_falls_back_to_the_scan(tmp_path):
    ckdir = str(tmp_path / "torn")
    net, _, p2 = _save_two(ckdir)
    with open(os.path.join(ckdir, "latest.json"), "w") as f:
        f.write('{"iteration": 5, "file": "checkpoint_')  # crash mid-write
    path, meta = latest_checkpoint(ckdir)
    assert path == p2 and meta["reason"] == "scan"
    restored, _ = CheckpointListener.restore_latest(ckdir, device="cpu")
    assert restored.iteration == net.iteration
    info = describe_latest(ckdir)
    assert info["path"] == p2 and info["age_seconds"] >= 0.0


def test_latest_json_is_monotonic(tmp_path):
    ckdir = str(tmp_path / "mono")
    net = build_net()
    listener = CheckpointListener(ckdir, keep_last=0)
    net.iteration = 10
    listener.save(net, reason="manual")
    net.iteration = 4
    listener.save(net, reason="manual")
    with open(os.path.join(ckdir, "latest.json")) as f:
        assert json.load(f)["iteration"] == 10
    assert len(scan_checkpoints(ckdir)) == 2


def _integrity_failures():
    fam = get_registry().get("checkpoint_integrity_failures_total")
    return 0.0 if fam is None else fam.labels().value


def test_a_corrupt_newest_checkpoint_is_skipped_and_counted(tmp_path):
    ckdir = str(tmp_path / "rot")
    net, p1, p2 = _save_two(ckdir)
    tckpt.corrupt_zip_entry(p2)
    before = _integrity_failures()
    restored, meta = CheckpointListener.restore_latest(ckdir, device="cpu")
    assert meta["file"] == os.path.basename(p1)
    assert restored.iteration == net.iteration - 5
    assert _integrity_failures() == before + 1


def test_an_entirely_corrupt_history_raises(tmp_path):
    ckdir = str(tmp_path / "allrot")
    _, p1, p2 = _save_two(ckdir)
    for p in (p1, p2):
        tckpt.corrupt_zip_entry(p)
    with pytest.raises(NoUsableCheckpointError):
        CheckpointListener.restore_latest(ckdir, device="cpu")
    with pytest.raises(NoUsableCheckpointError):
        build_net().fit(build_iterator(), epochs=1, resume_from=ckdir)


def test_resume_into_a_changed_configuration_raises(tmp_path):
    from deeplearning4j_tpu_torch.utils.model_serializer import ConfigMismatchError

    ckdir = str(tmp_path / "mm")
    CheckpointListener(ckdir).save(build_net(), reason="manual")
    with pytest.raises(ConfigMismatchError):
        build_net(seed=8).fit(build_iterator(), epochs=1, resume_from=ckdir)


def test_on_fit_end_flushes_the_async_writer_and_records_both_phases(tmp_path):
    ckdir = str(tmp_path / "eof")
    h = get_registry().histogram("checkpoint_save_seconds", "", ("phase",))
    n_snap, n_write = h.labels("snapshot").count, h.labels("write").count
    net = build_net()
    lst = CheckpointListener(ckdir, every_n_iterations=1, async_save=True,
                             keep_last=0)
    net.set_listeners(lst)
    net.fit(build_iterator(), epochs=1)
    assert lst._writer_q is None or lst._writer_q.unfinished_tasks == 0
    zips = scan_checkpoints(ckdir)
    assert zips and zips[-1][0] == net.iteration
    lst.close()
    assert h.labels("snapshot").count > n_snap
    assert h.labels("write").count > n_write


def test_run_ledger_is_refused_until_it_is_ported(tmp_path):
    # utils/runledger.py is ported now: the knob records a ledger (a path's
    # ledger is closed and detached when the fit ends) instead of raising
    from deeplearning4j_tpu_torch.utils import runledger

    path = str(tmp_path / "ledger.jsonl")
    net = build_net()
    net.fit(build_iterator(), epochs=1, run_ledger=path)
    assert runledger.current() is None
    samples = list(runledger.iter_samples(runledger.read_ledger(path)))
    steps = (samples[-1][1]["fit_step_total"]
             - samples[0][1].get("fit_step_total", 0.0))
    assert steps == net.iteration > 0


# -- no device reads in the fit loop ----------------------------------------------


@pytest.fixture
def no_device_reads(monkeypatch):
    """Tensor reads to the host raise on THIS thread (the fit thread);
    the checkpoint writer's thread may read."""
    main = threading.get_ident()
    reads = []

    def guard(name):
        orig = getattr(torch.Tensor, name)

        def wrapped(self, *a, **k):
            if threading.get_ident() == main:
                reads.append(name)
                raise AssertionError(f"fit loop called Tensor.{name}")
            return orig(self, *a, **k)
        return wrapped

    for name in ("item", "__float__", "__int__", "__bool__", "tolist", "numpy"):
        monkeypatch.setattr(torch.Tensor, name, guard(name))
    return reads


def test_fit_without_listeners_reads_no_device_value(no_device_reads):
    x, y = _tb_data()
    net = MultiLayerNetwork(MultiLayerConfiguration.from_json(
        _tb_conf().to_json()), device="cpu").init()
    net.fit(ListDataSetIterator(DataSet(x, y), _TB_BATCH, shuffle=True), epochs=1)
    assert net.iteration == 6 and no_device_reads == []


def test_fit_with_an_async_checkpoint_listener_reads_nothing_between_saves(
        tmp_path, no_device_reads):
    """Saves are due at epoch ends only; the per-step path and the
    snapshot read nothing on the fit thread."""
    net = build_net()
    lst = CheckpointListener(str(tmp_path / "ck"), every_n_epochs=1,
                             async_save=True)
    net.set_listeners(lst)
    net.fit(build_iterator(), epochs=2)
    lst.close()
    assert no_device_reads == [] and len(scan_checkpoints(str(tmp_path / "ck"))) == 2

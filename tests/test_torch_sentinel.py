"""The port's divergence sentinel (train/sentinel.py, nn/netbase.py
`set_sentinel`) against the JAX package's, mirroring
tests/test_sentinel_rollback.py: a seeded `nan` fault taints one batch
through the real dispatch path; the sentinel reads the step's [loss, grad
norm] diagnostic, undoes the step, quarantines the batch, rolls back to
the last good checkpoint, skips the batch on replay, and the fit ends
finite. Plus the checkpoint-integrity half, the off-path hook pin, the
shared non-finite-score path with early stopping, and what only the port
has to hold: the undo copies into the same tensors, a batch digest reads
a tensor's bytes, the rollback closes a staged pipeline, and the frozen
leaves' gradient norm (taken while a sentinel is attached).

Against the JAX package: the same verdicts at the same iterations, the
same quarantine records, the same rollback checkpoint, and final
parameters within f32 rtol 1e-5 / atol 1e-7, both started from one zip.
Every test of the JAX file has its counterpart here, the last three on
the port's cli.py and analysis/slo.py: `cli resume`'s integrity
preflight (the same exit codes and verdicts as the JAX CLI on the same
directories), the divergence chaos preset's loop (recovered across two
seeds, each replayed to the same event log, and the JAX CLI's verdict
and events for the same seed), and the default SLO pack's grad-norm
precursor rule (the same rule and transitions as the JAX pack's).
"""

import glob
import math
import os
import signal
import subprocess
import sys
import time
import zipfile

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tests"))

import torch_parity  # noqa: E402
import torch_sentinel_child as child  # noqa: E402
from deeplearning4j_tpu_torch.data import (  # noqa: E402
    DataSet,
    ExistingDataSetIterator,
    ListDataSetIterator,
)
from deeplearning4j_tpu_torch.train import sentinel as sentinel_mod  # noqa: E402
from deeplearning4j_tpu_torch.train.checkpoint import (  # noqa: E402
    CheckpointListener,
    NoUsableCheckpointError,
    corrupt_zip_entry,
    scan_checkpoints,
)
from deeplearning4j_tpu_torch.train.sentinel import (  # noqa: E402
    DivergenceSentinel,
    TrainingDivergedError,
    batch_digest,
)
from deeplearning4j_tpu_torch.utils import blackbox  # noqa: E402
from deeplearning4j_tpu_torch.utils import faultpoints as fp  # noqa: E402
from deeplearning4j_tpu_torch.utils.metrics import get_registry  # noqa: E402
from deeplearning4j_tpu_torch.utils.model_serializer import (  # noqa: E402
    save_model,
    verify_checkpoint,
)

N_IN = 8


def _net(seed=7):
    return child.build_net(seed)


def _iterator(n=128, seed=0):
    rng = np.random.default_rng(seed)
    full = DataSet(rng.standard_normal((n, N_IN)).astype(np.float32),
                   np.eye(3, dtype=np.float32)[rng.integers(0, 3, n)])
    return ListDataSetIterator(full, 8)


class _ScoreTrail:
    """(iteration, score) per step: the replay-equality probe."""

    def __init__(self):
        self.trail = []

    def iteration_done(self, model, iteration, info):
        self.trail.append((iteration, float(info["score"]())))

    def on_epoch_start(self, model, epoch):
        pass

    def on_epoch_end(self, model, epoch):
        pass


def _trails_equal(a, b):
    """Bit-identical, NaN-aware (the anomalous step's score IS NaN)."""
    if len(a) != len(b):
        return False
    for (ia, sa), (ib, sb) in zip(a, b):
        if ia != ib:
            return False
        if not (sa == sb or (math.isnan(sa) and math.isnan(sb))):
            return False
    return True


class _Events:
    def __init__(self):
        self.events = []

    def __call__(self, kind, payload):
        self.events.append((kind, dict(payload)))


def _divergence_run(ckdir, nan_step=8, net=None, **sentinel_kw):
    net = net if net is not None else _net()
    listener = CheckpointListener(ckdir, every_n_iterations=3,
                                  every_n_epochs=None, keep_last=5,
                                  async_save=False)
    kw = dict(rollback_after=1, max_rollbacks=2)
    kw.update(sentinel_kw)
    sent = DivergenceSentinel(**kw)
    trail = _ScoreTrail()
    net.set_listeners(listener, trail)
    net.set_sentinel(sent)
    plan = fp.FaultPlan(seed=1).add("train_step", "nan",
                                    between=(nan_step, nan_step))
    with fp.active(plan):
        net.fit(_iterator(), epochs=1, async_prefetch=False)
    return net, sent, trail.trail


# -- the acceptance loop ------------------------------------------------------


def test_nan_injection_quarantine_rollback_recovers(tmp_path):
    reg = get_registry().scalar_values()
    base_anom = reg.get('train_anomaly_total{kind="nonfinite_loss"}', 0.0)
    net, sent, trail = _divergence_run(str(tmp_path / "ck"))
    assert math.isfinite(float(net._score))
    assert sent.anomalies == 1
    assert sent.quarantined == 1
    assert sent.rollbacks == 1
    assert len(sent.records) == 1
    rec = sent.records[0]
    assert rec["anomaly"] == "nonfinite_loss"
    assert rec["digest"]
    nans = [s for _, s in trail if math.isnan(s)]
    assert len(nans) == 1
    assert math.isfinite(trail[-1][1])
    sc = get_registry().scalar_values()
    assert sc['train_anomaly_total{kind="nonfinite_loss"}'] == base_anom + 1
    assert sc.get('quarantined_batches_total{action="quarantined"}', 0) >= 1
    assert sc.get('quarantined_batches_total{action="replay_skipped"}',
                  0) >= 1
    assert sc.get("train_rollback_total", 0) >= 1
    assert any(f.code == "SN001" for f in sent.findings)


def _jax_divergence_run(jnet, ckdir, nan_step=8, **sentinel_kw):
    from deeplearning4j_tpu.data.dataset import DataSet as JDataSet
    from deeplearning4j_tpu.data.iterators import ListDataSetIterator as JList
    from deeplearning4j_tpu.train.checkpoint import CheckpointListener as JCk
    from deeplearning4j_tpu.train.sentinel import DivergenceSentinel as JSent
    from deeplearning4j_tpu.utils import faultpoints as jfp

    rng = np.random.default_rng(0)
    full = JDataSet(rng.standard_normal((128, N_IN)).astype(np.float32),
                    np.eye(3, dtype=np.float32)[rng.integers(0, 3, 128)])
    kw = dict(rollback_after=1, max_rollbacks=2)
    kw.update(sentinel_kw)
    sent = JSent(**kw)
    trail = _ScoreTrail()
    jnet.set_listeners(JCk(ckdir, every_n_iterations=3, every_n_epochs=None,
                           keep_last=5, async_save=False), trail)
    jnet.set_sentinel(sent)
    plan = jfp.FaultPlan(seed=1).add("train_step", "nan",
                                     between=(nan_step, nan_step))
    with jfp.active(plan):
        jnet.fit(JList(full, 8), epochs=1, async_prefetch=False)
    return sent, trail.trail


def test_the_loop_agrees_with_the_jax_package_from_one_zip(tmp_path):
    """Both packages from the same start: the same anomaly at the same
    step, the same quarantine record (digest included: both hash the
    numpy batch), the same rollback target, the same score trail and
    final parameters within f32 rtol 1e-5."""
    from deeplearning4j_tpu.nn.conf import (
        DenseLayer as JDense, NeuralNetConfiguration as JNNC,
        OutputLayer as JOut)
    from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN

    jconf = (JNNC.builder().seed(7).updater("sgd").learning_rate(0.05)
             .weight_init("xavier").list()
             .layer(JDense(n_in=N_IN, n_out=8, activation="tanh"))
             .layer(JOut(n_in=8, n_out=3, activation="softmax",
                         loss="mcxent"))
             .build())
    jnet = JMLN(jconf).init()
    tnet = torch_parity.port_twin(jnet, tmp_path)
    jev, tev = _Events(), _Events()
    jsent, jtrail = _jax_divergence_run(jnet, str(tmp_path / "j"),
                                        on_event=jev)
    tnet, tsent, ttrail = _divergence_run(str(tmp_path / "t"), net=tnet,
                                          on_event=tev)
    kinds = lambda ev: [(k, p.get("step"), p.get("anomaly"))  # noqa: E731
                        for k, p in ev.events if k != "train_rollback"]
    assert kinds(tev) == kinds(jev)
    assert [k for k, _ in tev.events] == [k for k, _ in jev.events]
    assert tsent.records == jsent.records
    assert tsent.tainted_iterations == jsent.tainted_iterations
    assert [i for i, _ in ttrail] == [i for i, _ in jtrail]
    js = np.array([s for _, s in jtrail])
    ts = np.array([s for _, s in ttrail])
    np.testing.assert_allclose(ts, js, rtol=1e-5, atol=1e-7)
    # the rollback restored the same checkpoint: the replay resumed at
    # the same iteration in both
    restart = lambda tr: [b for a, b in zip(tr, tr[1:])  # noqa: E731
                          if b[0] <= a[0]][0][0]
    assert restart(ttrail) == restart(jtrail)
    torch_parity.assert_params_close(jnet, tnet, "f32_step")
    assert tnet.iteration == jnet.iteration


def test_lr_backoff_survives_rollback_restore(tmp_path):
    net, sent, _ = _divergence_run(str(tmp_path / "ck"), lr_backoff=0.5)
    assert math.isfinite(float(net._score))
    assert sent.rollbacks == 1
    assert net.net_conf.learning_rate == pytest.approx(0.025)


def test_checkpoint_saved_during_anomalous_step_is_rejected(tmp_path):
    net = _net()
    ckdir = str(tmp_path / "ck")
    listener = CheckpointListener(ckdir, every_n_iterations=1,
                                  every_n_epochs=None, keep_last=0,
                                  async_save=False)
    sent = DivergenceSentinel(rollback_after=1, max_rollbacks=2)
    net.set_listeners(listener)
    net.set_sentinel(sent)
    base = get_registry().scalar_values().get(
        "checkpoint_integrity_failures_total", 0.0)
    plan = fp.FaultPlan(seed=1).add("train_step", "nan", between=(8, 8))
    with fp.active(plan):
        net.fit(_iterator(), epochs=1, async_prefetch=False)
    assert math.isfinite(float(net._score))
    assert sent.tainted_iterations == {8}
    sc = get_registry().scalar_values()
    assert sc["checkpoint_integrity_failures_total"] >= base + 1


def test_replay_bit_identical(tmp_path):
    _, _, a = _divergence_run(str(tmp_path / "a"))
    _, _, b = _divergence_run(str(tmp_path / "b"))
    assert _trails_equal(a, b), (a, b)


def test_sentinel_attached_no_anomaly_is_equivalent(tmp_path):
    def run(with_sentinel):
        net = _net()
        trail = _ScoreTrail()
        net.set_listeners(trail)
        if with_sentinel:
            net.set_sentinel(DivergenceSentinel())
        net.fit(_iterator(n=64), epochs=1, async_prefetch=False)
        return trail.trail, net

    (a, na), (b, nb) = run(False), run(True)
    assert _trails_equal(a, b)
    assert all(torch.equal(x, y) for x, y in zip(na.params(), nb.params()))


def test_unattached_hook_under_10us():
    net = _net()
    assert net._sentinel is None
    t0 = time.perf_counter()
    for _ in range(10_000):
        sentinel_mod.pre_step(net)
    per_call = (time.perf_counter() - t0) / 10_000
    assert per_call < 10e-6, f"pre_step cost {per_call * 1e6:.2f}us"


def test_grad_norm_spike_classification():
    sent = DivergenceSentinel(grad_norm_factor=5.0, min_history=4)

    class Stub:
        iteration = 1
        _score = None
        _step_diag = None

    stub = Stub()
    for i in range(6):
        stub._step_diag = torch.tensor([0.5, 1.0 + 0.01 * i])
        stub.iteration += 1
        assert sent.judge(stub) == "ok"
    stub._step_diag = torch.tensor([0.5, 50.0])
    assert sent.judge(stub) == "grad_norm_spike"
    assert sent.streak == 1
    stub._step_diag = torch.tensor([0.5, 1.02])
    assert sent.judge(stub) == "ok"
    assert sent.streak == 0
    assert get_registry().scalar_values()["train_grad_norm"] == \
        pytest.approx(1.02)


def test_no_checkpoint_dir_diverges_with_dump(tmp_path):
    net = _net()
    net.set_sentinel(DivergenceSentinel(rollback_after=1))
    plan = fp.FaultPlan(seed=1).add("train_step", "nan", between=(3, 3))
    with fp.active(plan):
        with pytest.raises(TrainingDivergedError) as ei:
            net.fit(_iterator(n=64), epochs=1, async_prefetch=False)
    assert ei.value.dump_path and os.path.exists(ei.value.dump_path)


# -- checkpoint integrity -----------------------------------------------------


def _fit_with_checkpoints(ckdir, n=96):
    net = _net()
    listener = CheckpointListener(ckdir, every_n_iterations=3,
                                  every_n_epochs=None, keep_last=5,
                                  async_save=False)
    net.set_listeners(listener)
    net.fit(_iterator(n=n), epochs=1, async_prefetch=False)
    return net


def test_corrupt_newest_falls_back_and_is_visible(tmp_path):
    """The fallback renders in the flight recorder's dump view under
    "numerical resilience" (the JAX test reads it through `cli
    blackbox`, which is `render_dump` of the dump file)."""
    import json

    ckdir = str(tmp_path / "ck")
    _fit_with_checkpoints(ckdir)
    cks = scan_checkpoints(ckdir)
    assert len(cks) >= 2
    corrupt_zip_entry(os.path.join(ckdir, cks[-1][1]))
    base = get_registry().scalar_values().get(
        "checkpoint_integrity_failures_total", 0.0)
    model, meta = CheckpointListener.restore_latest(ckdir, device="cpu")
    assert meta["file"] == cks[-2][1]
    sc = get_registry().scalar_values()
    assert sc["checkpoint_integrity_failures_total"] == base + 1
    dump = str(tmp_path / "dump.json")
    blackbox.get_recorder().dump(dump, reason="test")
    with open(dump) as f:
        out = blackbox.render_dump(json.load(f))
    assert "numerical resilience" in out
    assert "corrupt checkpoint skipped" in out


def test_resume_from_corrupt_newest_uses_previous(tmp_path):
    ckdir = str(tmp_path / "ck")
    _fit_with_checkpoints(ckdir)
    cks = scan_checkpoints(ckdir)
    corrupt_zip_entry(os.path.join(ckdir, cks[-1][1]))
    net = _net()
    net.fit(_iterator(), epochs=1, resume_from=ckdir, async_prefetch=False)
    assert math.isfinite(float(net._score))
    assert net.iteration == 16


def test_resume_all_candidates_rejected_raises(tmp_path):
    ckdir = str(tmp_path / "ck")
    _fit_with_checkpoints(ckdir)
    for _, name in scan_checkpoints(ckdir):
        corrupt_zip_entry(os.path.join(ckdir, name))
    net = _net()
    with pytest.raises(NoUsableCheckpointError):
        net.fit(_iterator(), epochs=1, resume_from=ckdir,
                async_prefetch=False)
    with pytest.raises(NoUsableCheckpointError):
        CheckpointListener.restore_latest(ckdir, device="cpu")
    with pytest.raises(FileNotFoundError):
        CheckpointListener.restore_latest(str(tmp_path / "nothing"),
                                          device="cpu")
    net2 = _net()
    net2.fit(_iterator(n=32), epochs=1,
             resume_from=str(tmp_path / "empty"), async_prefetch=False)
    assert net2.iteration == 4


def test_rebinding_sentinel_to_another_net_clears_run_state(tmp_path):
    net, sent, _ = _divergence_run(str(tmp_path / "ck"))
    assert sent.records and sent.tainted_iterations
    other = _net(seed=11)
    other.set_sentinel(sent)
    other.fit(_iterator(n=64), epochs=1, async_prefetch=False)
    assert other.iteration == 8
    assert not sent.records


def test_verify_checkpoint_statuses(tmp_path):
    net = _net()
    p = str(tmp_path / "m.zip")
    save_model(net, p)
    v = verify_checkpoint(p)
    assert v["ok"] and not v["legacy"]
    assert all(e["status"] == "ok" for e in v["entries"].values())

    tampered = str(tmp_path / "tampered.zip")
    with zipfile.ZipFile(p) as zin, zipfile.ZipFile(tampered, "w") as zout:
        for name in zin.namelist():
            data = zin.read(name)
            if name == "trainState.json" or name == "meta.json":
                data = data + b" "
            zout.writestr(name, data)
        zout.writestr("extra.bin", b"not in the manifest")
    v = verify_checkpoint(tampered)
    assert not v["ok"]
    assert v["entries"]["meta.json"]["status"] == "mismatch"
    assert v["entries"]["extra.bin"]["status"] == "unlisted"

    legacy = str(tmp_path / "legacy.zip")
    with zipfile.ZipFile(p) as zin, zipfile.ZipFile(legacy, "w") as zout:
        for name in zin.namelist():
            if name != "manifest.json":
                zout.writestr(name, zin.read(name))
    v = verify_checkpoint(legacy)
    assert v["ok"] and v["legacy"]


def test_sigkill_mid_rollback_resumes_cleanly(tmp_path):
    script = os.path.join(REPO, "tests", "torch_sentinel_child.py")
    ckdir = str(tmp_path / "ck")
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env.pop("T1_BLACKBOX_ARTIFACT", None)
    proc = subprocess.Popen(
        [sys.executable, script, "--ckpt-dir", ckdir,
         "--rollback-hold", "3.0"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
    killed = False
    try:
        for line in proc.stdout:
            if line.startswith("EVENT train_rollback"):
                proc.send_signal(signal.SIGKILL)
                killed = True
                break
            if line.startswith("FIT DONE"):
                break
    finally:
        try:
            proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
    assert killed, "child finished before any rollback fired"
    assert proc.returncode == -signal.SIGKILL
    assert glob.glob(os.path.join(ckdir, "checkpoint_iter*.zip"))

    net = child.build_net()
    net.fit(child.build_iterator(), epochs=1, resume_from=ckdir,
            async_prefetch=False)
    assert math.isfinite(float(net._score))
    assert net.iteration == 16


# -- one detection path / fault kinds ---------------------------------------


def test_earlystopping_invalid_score_counts_in_sentinel_books():
    from deeplearning4j_tpu_torch.train.earlystopping import (
        InvalidScoreIterationTerminationCondition,
    )

    cond = InvalidScoreIterationTerminationCondition()
    base = get_registry().scalar_values().get(
        'train_anomaly_total{kind="nonfinite_loss"}', 0.0)
    assert cond.terminate(3, 1.25) is False
    assert cond.terminate(4, float("nan")) is True
    assert cond.terminate(5, float("inf")) is True
    sc = get_registry().scalar_values()
    assert sc['train_anomaly_total{kind="nonfinite_loss"}'] == base + 2


def test_taint_nan_poisons_features():
    ds = DataSet(np.ones((4, 3), np.float32), np.ones((4, 2), np.float32))
    fp.taint_nan(ds)
    assert np.isnan(ds.features).all()
    assert np.isfinite(ds.labels).all()


def test_fault_kind_serde_and_cooperative_return():
    plan = fp.FaultPlan(seed=3).add("train_step", "nan", between=(1, 1)) \
        .add("ckpt_write", "corrupt", every_nth=1, max_fires=1)
    plan2 = fp.FaultPlan.from_json(plan.to_json())
    assert [r.kind for r in plan2.rules] == ["nan", "corrupt"]
    with fp.active(plan2):
        assert fp.fault_point("train_step") == "nan"
        assert fp.fault_point("train_step") is None
        assert fp.fault_point("ckpt_write") == "corrupt"
        assert fp.fault_point("ckpt_write") is None
    assert [e["kind"] for e in plan2.event_log()] == ["corrupt", "nan"]


# -- what the port alone must hold --------------------------------------------


def test_an_undone_step_is_copied_back_into_the_same_tensors():
    """The updater adds its deltas in place, so the undo copies the
    pre-step clones back INTO the live tensors (a captured graph reads
    their addresses): after the quarantine every parameter, layer state
    and updater leaf holds its pre-step bits at its pre-step address."""
    net = child.build_net()
    net.set_sentinel(DivergenceSentinel(rollback_after=5))
    it = _iterator(n=32)
    net.fit(it, epochs=1, async_prefetch=False)
    before = net._state_addresses()
    clone = [{k: v.clone() for k, v in p.items()} for p in net.params_list]
    progs = dict(net._programs)
    plan = fp.FaultPlan(seed=1).add("train_step", "nan", between=(1, 1))
    with fp.active(plan):
        net.fit(ExistingDataSetIterator(list(_iterator(n=8))), epochs=1,
                async_prefetch=False)
    assert net._sentinel.quarantined == 1
    assert net._state_addresses() == before
    assert net._programs == progs
    for p, c in zip(net.params_list, clone):
        for k in p:
            assert torch.equal(p[k], c[k])


def test_batch_digest_reads_a_tensors_bytes_as_numpy():
    x = np.random.default_rng(0).standard_normal((4, 3)).astype(np.float32)
    a = batch_digest(DataSet(x, x))
    assert a is not None
    assert batch_digest(DataSet(torch.from_numpy(x.copy()), x)) == a


def test_a_shuffled_replay_skips_the_poisoned_batch_by_digest():
    """The batch moved: its position no longer matches, its content
    digest does."""
    rng = np.random.default_rng(3)
    batches = [DataSet(rng.standard_normal((4, N_IN)).astype(np.float32),
                       np.eye(3, dtype=np.float32)[rng.integers(0, 3, 4)])
               for _ in range(4)]
    net = _net()
    sent = DivergenceSentinel(rollback_after=5).bind(net)
    net.set_sentinel(sent)
    # recorded in another epoch: no position of this fit matches it
    net._train_state = {"epoch": 5, "batch_in_epoch": 2}
    sent.quarantine(net, [batches[1]], "nonfinite_loss")
    assert sent.records[0]["batch_in_epoch"] == 1
    net._train_state = {"epoch": 6, "batch_in_epoch": 3}
    assert sent.should_skip_batch(net, batches[1])
    assert not sent.should_skip_batch(net, batches[2])
    # the fit loop consumes it: only 3 of 4 shuffled batches dispatch
    shuffled = ExistingDataSetIterator([batches[3], batches[0], batches[1],
                                        batches[2]])
    it0 = net.iteration
    net.fit(shuffled, epochs=1, async_prefetch=False)
    assert net.iteration - it0 == 3


def test_rollback_under_the_prefetch_pipeline_matches_prefetch_off(tmp_path):
    """The rollback closes and rewinds a staged pipeline (its workers
    joined before the replay starts): the same trail and bits as the
    inline run."""
    _, _, off = _divergence_run(str(tmp_path / "off"))
    net = _net()
    listener = CheckpointListener(str(tmp_path / "on"), every_n_iterations=3,
                                  every_n_epochs=None, keep_last=5,
                                  async_save=False)
    trail = _ScoreTrail()
    net.set_listeners(listener, trail)
    net.set_sentinel(DivergenceSentinel(rollback_after=1, max_rollbacks=2))
    plan = fp.FaultPlan(seed=1).add("train_step", "nan", between=(8, 8))
    with fp.active(plan):
        net.fit(_iterator(), epochs=1, async_prefetch=True)
    assert _trails_equal(trail.trail, off)


# -- the gradient norm over frozen leaves ------------------------------------


def _frozen_pair(tmp_path):
    from deeplearning4j_tpu.nn.conf import (
        DenseLayer as JDense, NeuralNetConfiguration as JNNC,
        OutputLayer as JOut)
    from deeplearning4j_tpu.nn.conf.layers import FrozenLayer as JFrozen
    from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN

    jconf = (JNNC.builder().seed(5).updater("sgd").learning_rate(0.05)
             .list()
             .layer(JFrozen(inner=JDense(n_in=N_IN, n_out=6,
                                         activation="tanh")))
             .layer(JOut(n_in=6, n_out=3, activation="softmax",
                         loss="mcxent"))
             .build())
    jnet = JMLN(jconf).init()
    return jnet, torch_parity.port_twin(jnet, tmp_path)


def test_frozen_leaves_enter_the_norm_only_while_a_sentinel_is_attached(
        tmp_path):
    """The JAX step's diag[1] covers every leaf, frozen ones included.
    The port takes the frozen gradients only while a sentinel (the one
    reader) is attached: then diag[1] equals the JAX value; without one
    it is the trainable leaves' norm, as PR 10 left it. Both pinned, f32
    rtol 1e-5; the parameters after the step are the same either way."""
    jnet, tnet = _frozen_pair(tmp_path)
    tnet2 = torch_parity.port_twin(jnet, tmp_path)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((8, N_IN)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 8)]
    _, jg = torch_parity.jax_grads(jnet, x, y)
    full = math.sqrt(sum(float(np.sum(np.square(np.asarray(v))))
                         for g in jg for v in g.values()))
    trainable = math.sqrt(sum(float(np.sum(np.square(np.asarray(v))))
                              for v in jg[1].values()))
    assert full > trainable * 1.01
    jnet.fit(x, y, batch_size=8, epochs=1, async_prefetch=False)
    jdiag = np.asarray(jnet._step_diag)
    np.testing.assert_allclose(jdiag[1], full, rtol=1e-5)

    tnet.set_sentinel(DivergenceSentinel())
    tnet.fit(x, y, batch_size=8, epochs=1, async_prefetch=False)
    tnet2.fit(x, y, batch_size=8, epochs=1, async_prefetch=False)
    np.testing.assert_allclose(tnet._step_diag.numpy(), jdiag, rtol=1e-5)
    np.testing.assert_allclose(float(tnet2._step_diag[1]), trainable,
                               rtol=1e-5)
    assert all(torch.equal(a, b) for a, b in zip(tnet.params(), tnet2.params()))
    torch_parity.assert_params_close(jnet, tnet, "f32_step")


def test_cli_resume_integrity_preflight(tmp_path, capsys):
    """`cli resume <dir>`: per-entry digest report, exit 1 on a
    corrupted newest checkpoint, exit 0 (with a note) on pre-digest
    legacy checkpoints — the JAX CLI, reading the same directories,
    gives the same exit codes."""
    from deeplearning4j_tpu.cli import main as jax_cli_main
    from deeplearning4j_tpu_torch.cli import main as port_main

    def both(path):
        rc = port_main(["--device", "cpu", "resume", path])
        out = capsys.readouterr().out
        assert jax_cli_main(["resume", path]) == rc
        capsys.readouterr()
        return rc, out

    ckdir = str(tmp_path / "ck")
    _fit_with_checkpoints(ckdir)
    rc, out = both(ckdir)
    assert rc == 0 and "integrity: ok" in out

    cks = scan_checkpoints(ckdir)
    # legacy directory: manifest stripped from a good zip (taken before
    # the newest is corrupted below)
    legacy_dir = str(tmp_path / "legacy")
    os.makedirs(legacy_dir)
    src = os.path.join(ckdir, cks[-2][1])
    dst = os.path.join(legacy_dir, cks[-2][1])
    with zipfile.ZipFile(src) as zin, zipfile.ZipFile(dst, "w") as zout:
        for name in zin.namelist():
            if name != "manifest.json":
                zout.writestr(name, zin.read(name))

    corrupt_zip_entry(os.path.join(ckdir, cks[-1][1]))
    rc, out = both(ckdir)
    assert rc == 1
    assert "integrity: FAILED" in out
    assert "unreadable" in out or "mismatch" in out

    rc, out = both(legacy_dir)
    assert rc == 0 and "no digest manifest" in out


def test_slo_default_pack_grad_norm_precursor():
    """The default pack carries a rate-of-change rule on the sentinel's
    train_grad_norm gauge; a fast ramp fires it (warning), absence of
    the series never alerts — the same rule and transitions as the JAX
    package's pack."""
    from deeplearning4j_tpu.analysis import slo as jax_slo
    from deeplearning4j_tpu_torch.analysis import slo

    def run(mod):
        rules = mod.default_rule_pack(sample_every=1.0)
        rule = next(r for r in rules
                    if r.name == "grad_norm_divergence_precursor")
        assert rule.kind == "rate_of_change"
        assert rule.severity == "warning"
        rs = mod.SLORuleSet([rule])
        # no series -> never violated
        assert rs.evaluate(0.0, {}) == []
        # ramp at 100/s for > for_seconds -> fires
        transitions = []
        for i in range(6):
            transitions += rs.evaluate(
                float(i), {"train_grad_norm": 100.0 * i})
        assert any(t["to"] == "firing" for t in transitions)
        return rule.to_dict(), transitions

    assert run(slo) == run(jax_slo)


def test_chaos_divergence_preset_loop(tmp_path, capsys):
    """The chaos-loop gate: the divergence preset recovers (exit 0)
    across two seeds, two runs of the same seed produce the same event
    log (replay determinism at the CLI surface), and the JAX CLI gives
    the same verdict and events for seed 0. A vacuous plan (the NaN
    never fires) must FAIL the gate."""
    import json

    from deeplearning4j_tpu.cli import main as jax_cli_main
    from deeplearning4j_tpu_torch.cli import main as port_main

    def cli(*argv):
        return port_main(["--device", "cpu", *argv])

    reports = {}
    for seed in (0, 1):
        for rep in range(2):
            out = str(tmp_path / f"r{seed}_{rep}.json")
            rc = cli("chaos", "--preset", "divergence", "--steps", "16",
                     "--seed", str(seed), "--json", out)
            capsys.readouterr()
            assert rc == 0, f"divergence chaos seed={seed} failed"
            with open(out) as f:
                reports[seed, rep] = json.load(f)
    for seed in (0, 1):
        assert reports[seed, 0]["events"] == reports[seed, 1]["events"]
    for rep in reports.values():
        assert rep["outcome"] == "recovered"
        assert rep["final_score_finite"] is True
        assert rep["loop_exercised"] is True
        assert rep["sentinel"]["quarantined"] >= 1
    out = str(tmp_path / "jax0.json")
    assert jax_cli_main(["chaos", "--preset", "divergence", "--steps", "16",
                         "--seed", "0", "--json", out]) == 0
    capsys.readouterr()
    with open(out) as f:
        ref = json.load(f)
    got = reports[0, 0]
    assert ref["verdict"] == got["verdict"] == "ok"
    assert ref["events"] == got["events"]
    assert ref["invocations"] == got["invocations"]
    assert ref["sentinel"]["quarantine_records"] == got["sentinel"]["quarantine_records"]
    plan_path = str(tmp_path / "vacuous.json")
    with open(plan_path, "w") as f:
        f.write(fp.FaultPlan(seed=0).add(
            "train_step", "nan", between=(999, 999)).to_json())
    rc = cli("chaos", "--preset", "divergence", "--steps", "6",
             "--plan", plan_path)
    capsys.readouterr()
    assert rc == 1

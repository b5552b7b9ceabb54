"""The port's early stopping (train/earlystopping.py) against the JAX
package's: on shared weights (the JAX init, through the model zip) and
the same numpy data, `EarlyStoppingTrainer` ends for the same reason at
the same epoch with the same best epoch, its per-epoch scores agree to
rtol 1e-5 (f32), and the file saver's zips load in both packages.
"""

import numpy as np
import pytest

from deeplearning4j_tpu.data.dataset import DataSet as JDataSet
from deeplearning4j_tpu.nn.conf import DenseLayer as JDense
from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JNNConf
from deeplearning4j_tpu.nn.conf import OutputLayer as JOutput
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN
from deeplearning4j_tpu.train import earlystopping as jes
from deeplearning4j_tpu.utils import model_serializer as jms
from deeplearning4j_tpu_torch.data import DataSet
from deeplearning4j_tpu_torch.train import earlystopping as tes
from deeplearning4j_tpu_torch.utils import model_serializer as tms

SCORE_RTOL = 1e-5


def _jconf(lr):
    return (JNNConf.builder().seed(7).updater("adam").learning_rate(lr)
            .weight_init("xavier").list()
            .layer(JDense(n_in=8, n_out=16, activation="relu"))
            .layer(JDense(n_in=16, n_out=12, activation="tanh"))
            .layer(JOutput(n_in=12, n_out=3, activation="softmax",
                           loss="mcxent"))
            .build())


def _xy(n=64, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, 8)).astype(np.float32)
    y = np.zeros((n, 3), np.float32)
    y[np.arange(n), rng.integers(0, 3, n)] = 1.0
    return x, y


def _pair(tmp_path, lr):
    jn = JMLN(_jconf(lr)).init()
    path = str(tmp_path / "init.zip")
    jms.save_model(jn, path)
    return jn, tms.load_model(path, device="cpu")


def _run(es, net, conditions, iteration_conditions=(), saver=None):
    x, y = _xy()
    xv, yv = _xy(32, seed=1)
    ds_cls = DataSet if es is tes else JDataSet
    cfg = es.EarlyStoppingConfiguration(
        score_calculator=es.DataSetLossCalculator(ds_cls(xv, yv)),
        epoch_termination_conditions=conditions(es),
        iteration_termination_conditions=list(iteration_conditions),
        model_saver=saver or es.InMemoryModelSaver(),
        save_last_model=True)
    return es.EarlyStoppingTrainer(cfg, net, x, y, batch_size=16).fit()


def _patience(es):
    return [es.ScoreImprovementEpochTerminationCondition(2, min_improvement=0.02),
            es.MaxEpochsTerminationCondition(30)]


def _max_epochs(es):
    return [es.MaxEpochsTerminationCondition(4)]


@pytest.mark.parametrize("conditions,lr", [(_patience, 0.05), (_max_epochs, 0.01)],
                         ids=["patience", "max_epochs"])
def test_trainer_ends_like_the_jax_package(conditions, lr, tmp_path):
    jn, tn = _pair(tmp_path, lr)
    j = _run(jes, jn, conditions)
    t = _run(tes, tn, conditions)
    assert t.termination_reason == j.termination_reason
    assert t.termination_details == j.termination_details
    assert t.total_epochs == j.total_epochs
    assert t.best_model_epoch == j.best_model_epoch
    assert sorted(t.score_vs_epoch) == sorted(j.score_vs_epoch)
    np.testing.assert_allclose(
        [t.score_vs_epoch[e] for e in sorted(t.score_vs_epoch)],
        [j.score_vs_epoch[e] for e in sorted(j.score_vs_epoch)],
        rtol=SCORE_RTOL)
    xv, yv = _xy(32, seed=1)
    assert t.best_model.score(xv, yv) == pytest.approx(t.best_model_score,
                                                       rel=1e-6)


def test_iteration_condition_aborts_inside_the_first_epoch_in_both(tmp_path):
    jn, tn = _pair(tmp_path, 0.05)
    j = _run(jes, jn, _max_epochs,
             [jes.MaxScoreIterationTerminationCondition(1e-9)])
    t = _run(tes, tn, _max_epochs,
             [tes.MaxScoreIterationTerminationCondition(1e-9)])
    assert t.termination_reason == j.termination_reason == \
        tes.TerminationReason.ITERATION_CONDITION
    assert t.termination_details == j.termination_details
    assert not tn.listeners  # the trainer's condition listener is removed


def test_local_file_saver_writes_zips_both_packages_load(tmp_path):
    jn, tn = _pair(tmp_path, 0.05)
    saver = tes.LocalFileModelSaver(str(tmp_path / "es"))
    t = _run(tes, tn, _max_epochs, saver=saver)
    best = saver.get_best_model()
    assert best.device.type == "cpu"
    xv, yv = _xy(32, seed=1)
    assert best.score(xv, yv) == pytest.approx(t.best_model_score, rel=1e-6)
    jbest = jms.load_model(str(tmp_path / "es" / "bestModel.zip"))
    np.testing.assert_allclose(jbest.score(xv, yv), t.best_model_score,
                               rtol=SCORE_RTOL)
    assert (tmp_path / "es" / "latestModel.zip").exists()


def test_invalid_score_condition_counts_the_anomaly():
    from deeplearning4j_tpu_torch.utils.metrics import get_registry

    fam = get_registry().counter("train_anomaly_total", "", ("kind",))
    before = fam.labels("nonfinite_loss").value
    c = tes.InvalidScoreIterationTerminationCondition()
    assert c.terminate(0, float("nan")) and c.terminate(0, float("inf"))
    assert not c.terminate(0, 1.0)
    assert fam.labels("nonfinite_loss").value == before + 2

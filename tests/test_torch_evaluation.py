"""The port's evaluation suite (train/evaluation.py) against the JAX
package's on the same numpy predictions, and `net.evaluate` /
`evaluate_regression` / `score` of both networks on shared weights.

Every count is an integer and every statistic is computed in f64 numpy
from the same host arrays in both packages, so the `stats()` numbers are
compared exactly; network outputs differ by f32 rounding only, so the
confusion matrices of `net.evaluate` on shared weights are equal, and
scores agree to rtol 1e-5.
"""


import numpy as np
import pytest
import torch

from deeplearning4j_tpu.data.dataset import DataSet as JDataSet
from deeplearning4j_tpu.models import resnet as jresnet
from deeplearning4j_tpu.models.charlstm import char_lstm_conf as jchar_conf
from deeplearning4j_tpu.nn.compgraph import ComputationGraph as JCG
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN
from deeplearning4j_tpu.ops import pallas_conv_bn, pallas_lstm
from deeplearning4j_tpu.train import evaluation as jev
from deeplearning4j_tpu.utils import model_serializer as jms
from deeplearning4j_tpu_torch.data import DataSet, ListDataSetIterator
from deeplearning4j_tpu_torch.ops import fused_conv_bn
from deeplearning4j_tpu_torch.train import evaluation as tev
from deeplearning4j_tpu_torch.utils import model_serializer as tms

SCORE_RTOL = 1e-5


@pytest.fixture(autouse=True)
def _interpret_mode():
    old = pallas_lstm._INTERPRET, pallas_conv_bn._INTERPRET
    pallas_lstm._INTERPRET = pallas_conv_bn._INTERPRET = True
    yield
    pallas_lstm._INTERPRET, pallas_conv_bn._INTERPRET = old
    fused_conv_bn._STATS_STASH.clear()


def _probs(rng, shape):
    p = rng.random(shape).astype(np.float32)
    return p / p.sum(-1, keepdims=True)


def _onehot(rng, shape, k):
    return np.eye(k, dtype=np.float32)[rng.integers(0, k, shape)]


def _same_classification(a, b):
    np.testing.assert_array_equal(a.confusion, b.confusion)
    for name in ("accuracy", "precision", "recall", "f1", "top_n_accuracy"):
        assert getattr(a, name)() == getattr(b, name)(), name
    for c in range(a.confusion.shape[0]):
        for name in ("precision", "recall", "f1"):
            assert getattr(a, name)(c) == getattr(b, name)(c), (name, c)
    assert a.stats() == b.stats()


@pytest.mark.parametrize("as_tensor", [False, True], ids=["numpy", "torch"])
def test_evaluation_with_a_3d_mask_matches_jax(as_tensor):
    rng = np.random.default_rng(0)
    labels = _onehot(rng, (4, 6), 5)
    preds = _probs(rng, (4, 6, 5))
    mask = (rng.random((4, 6)) > 0.3).astype(np.float32)
    meta = [f"ex{i}" for i in range(4)]
    t, j = tev.Evaluation(top_n=2), jev.Evaluation(top_n=2)
    conv = torch.from_numpy if as_tensor else (lambda a: a)
    for sl in (slice(0, 2), slice(2, 4)):
        t.eval_batch(conv(labels[sl]), conv(preds[sl]), conv(mask[sl]),
                     record_meta=meta[sl])
        j.eval_batch(labels[sl], preds[sl], mask[sl], record_meta=meta[sl])
    _same_classification(t, j)
    assert ([(p.actual, p.predicted, p.record_meta) for p in t.get_prediction_errors()]
            == [(p.actual, p.predicted, p.record_meta) for p in j.get_prediction_errors()])


def test_evaluation_merge_and_two_class_f1_match_jax():
    rng = np.random.default_rng(1)
    parts = [(_onehot(rng, 7, 2), _probs(rng, (7, 2))) for _ in range(3)]
    t, j = tev.Evaluation(), jev.Evaluation()
    for lab, pr in parts:
        tp = tev.Evaluation()
        tp.eval_batch(lab, pr)
        t.merge(tp)
        j.eval_batch(lab, pr)
    _same_classification(t, j)


def test_regression_evaluation_matches_jax():
    rng = np.random.default_rng(2)
    labels = rng.standard_normal((3, 5, 4)).astype(np.float32)
    preds = labels + 0.3 * rng.standard_normal((3, 5, 4)).astype(np.float32)
    mask = (rng.random((3, 5)) > 0.2).astype(np.float32)
    t, j = tev.RegressionEvaluation(), jev.RegressionEvaluation()
    t.eval_batch(torch.from_numpy(labels), torch.from_numpy(preds),
                 torch.from_numpy(mask))
    j.eval_batch(labels, preds, mask)
    for c in range(4):
        for name in ("mean_squared_error", "mean_absolute_error",
                     "root_mean_squared_error", "correlation_r2"):
            assert getattr(t, name)(c) == getattr(j, name)(c), (name, c)
    assert t.stats() == j.stats()


@pytest.mark.parametrize("kind", ["binary_column", "two_column", "multiclass",
                                  "roc_binary", "evaluation_binary"])
def test_roc_family_matches_jax(kind):
    rng = np.random.default_rng(3)
    if kind == "binary_column":
        lab = (rng.random(40) > 0.5).astype(np.float32)
        pr = rng.random(40).astype(np.float32)
        t, j = tev.ROC(), jev.ROC()
    elif kind == "two_column":
        lab, pr = _onehot(rng, 40, 2), _probs(rng, (40, 2))
        t, j = tev.ROC(), jev.ROC()
    elif kind == "multiclass":
        lab, pr = _onehot(rng, 40, 4), _probs(rng, (40, 4))
        t, j = tev.ROCMultiClass(), jev.ROCMultiClass()
    elif kind == "roc_binary":
        lab = (rng.random((40, 3)) > 0.5).astype(np.float32)
        pr = rng.random((40, 3)).astype(np.float32)
        t, j = tev.ROCBinary(), jev.ROCBinary()
    else:
        lab = (rng.random((40, 3)) > 0.5).astype(np.float32)
        pr = rng.random((40, 3)).astype(np.float32)
        t, j = tev.EvaluationBinary(), jev.EvaluationBinary()
    t.eval_batch(torch.from_numpy(lab), torch.from_numpy(pr))
    j.eval_batch(lab, pr)
    if kind == "evaluation_binary":
        for c in range(3):
            assert t.accuracy(c) == j.accuracy(c) and t.f1(c) == j.f1(c)
    elif kind in ("multiclass",):
        for c in range(4):
            assert t.calculate_auc(c) == j.calculate_auc(c)
    elif kind == "roc_binary":
        for c in range(3):
            assert t.calculate_auc(c) == j.calculate_auc(c)
    else:
        assert t.calculate_auc() == j.calculate_auc()


# -- net.evaluate on shared weights ---------------------------------------------


def _shared(which, tmp_path):
    """(JAX net, port net) with the JAX init's weights, through the zip."""
    if which == "charlstm":
        jn = JMLN(jchar_conf(vocab_size=7, hidden=8, layers=2, tbptt_length=4,
                             learning_rate=0.01)).init()
    else:
        jn = JCG(jresnet.tiny_resnet_conf()).init()
    path = str(tmp_path / "init.zip")
    jms.save_model(jn, path)
    return jn, tms.load_model(path, device="cpu")


def _eval_data(which):
    rng = np.random.default_rng(4)
    if which == "charlstm":
        x = _onehot(rng, (6, 8), 7)
        y = _onehot(rng, (6, 8), 7)
        m = (rng.random((6, 8)) > 0.25).astype(np.float32)
        return x, y, m
    return (rng.standard_normal((6, 8, 8, 3)).astype(np.float32),
            _onehot(rng, 6, 3), None)


@pytest.mark.parametrize("which", ["charlstm", "tiny_resnet"])
def test_net_evaluate_gives_the_jax_confusion_matrix(which, tmp_path):
    jn, tn = _shared(which, tmp_path)
    x, y, m = _eval_data(which)
    tit = ListDataSetIterator(DataSet(x, y, labels_mask=m), 2)
    t = tn.evaluate(tit)
    j = jn.evaluate(JDataSet(x, y, labels_mask=m), batch_size=2) \
        if which == "charlstm" else jn.evaluate(x, y, batch_size=2)
    np.testing.assert_array_equal(t.confusion, j.confusion)
    assert t.accuracy() == j.accuracy()
    # arrays + batch_size route too
    t2 = tn.evaluate(x, y, batch_size=4) if m is None else tn.evaluate(
        DataSet(x, y, labels_mask=m), batch_size=4)
    np.testing.assert_array_equal(t2.confusion, t.confusion)


@pytest.mark.parametrize("which", ["charlstm", "tiny_resnet"])
def test_net_score_and_evaluate_regression_match_jax(which, tmp_path):
    jn, tn = _shared(which, tmp_path)
    x, y, m = _eval_data(which)
    ts = tn.score(DataSet(x, y, labels_mask=m))
    js = jn.score(JDataSet(x, y, labels_mask=m))
    np.testing.assert_allclose(ts, js, rtol=SCORE_RTOL)
    tr = tn.evaluate_regression(DataSet(x, y, labels_mask=m), batch_size=3)
    if which == "charlstm":
        jr = jn.evaluate_regression(JDataSet(x, y, labels_mask=m), batch_size=3)
    else:  # the JAX ComputationGraph has no evaluate_regression
        jr = jev.RegressionEvaluation()
        for sl in (slice(0, 3), slice(3, 6)):
            jr.eval_batch(y[sl], np.asarray(jn.output(x[sl])))
    for c in range(y.shape[-1]):
        np.testing.assert_allclose(tr.mean_squared_error(c),
                                   jr.mean_squared_error(c), rtol=SCORE_RTOL)


def test_evaluate_moves_each_batch_to_the_host_once(monkeypatch, tmp_path):
    """One host copy of the output per batch: `Tensor.cpu` runs once per
    evaluated batch (labels arrive as numpy)."""
    _, tn = _shared("tiny_resnet", tmp_path)
    x, y, _ = _eval_data("tiny_resnet")
    calls = []
    orig = torch.Tensor.cpu

    def counted(self, *a, **k):
        calls.append(tuple(self.shape))
        return orig(self, *a, **k)

    monkeypatch.setattr(torch.Tensor, "cpu", counted)
    tn.evaluate(x, y, batch_size=2)
    assert calls == [(2, 3)] * 3

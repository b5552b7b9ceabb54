"""Evaluation suite.

Analog of the reference's eval/ package: Evaluation (accuracy, precision,
recall, F1, confusion matrix — eval/Evaluation.java, 1,514 LoC),
RegressionEvaluation, ROC/ROCBinary/ROCMultiClass, and the IEvaluation SPI
(incremental accumulation over batches, mergeable across workers — the
property Spark map-side evaluation relies on, impl/multilayer/evaluation/).

The port of the JAX package's train/evaluation.py. Each batch's labels,
predictions and mask move to the host ONCE (`_host`: a torch tensor on
any device, or anything numpy takes); the argmax, confusion counts and
sums run in numpy on that copy, and the accumulation state is small
host-side numpy, so evaluation streams over any iterator without holding
activations.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Optional

import numpy as np
import torch


def _host(a):
    """One host copy of a batch array: a tensor moves off its device
    once; None stays None."""
    if a is None:
        return None
    if torch.is_tensor(a):
        return a.detach().cpu().numpy()
    return np.asarray(a)


@dataclasses.dataclass
class Prediction:
    """Per-example record metadata (reference: eval/meta/Prediction.java —
    actual/predicted class plus the caller's record metadata, for
    inspecting which examples were misclassified)."""

    actual: int
    predicted: int
    record_meta: Any = None


class IEvaluation:
    """SPI: incremental, mergeable evaluation (reference: eval/IEvaluation)."""

    def eval_batch(self, labels, predictions, mask=None):
        raise NotImplementedError

    def merge(self, other: "IEvaluation") -> "IEvaluation":
        raise NotImplementedError


class Evaluation(IEvaluation):
    """Multi-class classification evaluation over one-hot (or probability)
    labels/predictions."""

    def __init__(self, num_classes: Optional[int] = None, labels_list=None,
                 top_n: int = 1):
        self.num_classes = num_classes
        self.labels_list = labels_list
        self.confusion: Optional[np.ndarray] = None  # [true, predicted]
        # top-N accuracy (reference: Evaluation(int topN), topNAccuracy())
        self.top_n = max(1, int(top_n))
        self.top_n_correct = 0
        self.top_n_total = 0
        # per-example record metadata (reference: Evaluation record-meta
        # overloads + eval/meta/Prediction.java)
        self.predictions: List[Prediction] = []

    def _ensure(self, n):
        if self.confusion is None:
            self.num_classes = n
            self.confusion = np.zeros((n, n), dtype=np.int64)

    def eval_batch(self, labels, predictions, mask=None, record_meta=None):
        """labels/predictions: [batch, nClasses] (or [batch, time, nClasses]
        with optional [batch, time] mask — time-distributed evaluation as in
        the reference's evalTimeSeries). record_meta: optional per-example
        metadata sequence (one entry per EXAMPLE; for time-series labels
        each entry covers all of that example's timesteps); kept with each
        prediction for error inspection (reference: evaluate(iter,
        metaData))."""
        labels = _host(labels)
        predictions = _host(predictions)
        mask = _host(mask)
        time_steps = labels.shape[1] if labels.ndim == 3 else 1
        if labels.ndim == 3:
            n = labels.shape[-1]
            labels = labels.reshape(-1, n)
            predictions = predictions.reshape(-1, n)
            if mask is not None:
                flat = _host(mask).reshape(-1) > 0
            else:
                flat = None
        else:
            flat = _host(mask).reshape(-1) > 0 if mask is not None else None
        t = np.argmax(labels, axis=-1)
        p = np.argmax(predictions, axis=-1)
        probs = predictions
        if flat is not None:
            t, p, probs = t[flat], p[flat], probs[flat]
        self._ensure(int(labels.shape[-1]))
        np.add.at(self.confusion, (t, p), 1)
        if self.top_n > 1:
            k = min(self.top_n, probs.shape[-1])
            topk = np.argpartition(-probs, k - 1, axis=-1)[:, :k]
            self.top_n_correct += int((topk == t[:, None]).any(axis=1).sum())
            self.top_n_total += t.size
        if record_meta is not None:
            metas = [m for m in record_meta for _ in range(time_steps)]
            if len(metas) != (flat.size if flat is not None else t.size):
                raise ValueError(
                    f"record_meta has {len(metas) // time_steps} entries "
                    f"for a batch of "
                    f"{(flat.size if flat is not None else t.size) // time_steps}")
            if flat is not None:
                metas = [m for m, keep in zip(metas, flat) if keep]
            for ti, pi, m in zip(t, p, metas):
                self.predictions.append(Prediction(int(ti), int(pi), m))

    def top_n_accuracy(self) -> float:
        if self.top_n == 1:
            return self.accuracy()
        return (self.top_n_correct / self.top_n_total
                if self.top_n_total else 0.0)

    def get_prediction_errors(self) -> List[Prediction]:
        """Misclassified examples with their metadata (reference:
        Evaluation.getPredictionErrors)."""
        return [p for p in self.predictions if p.actual != p.predicted]

    def get_predictions(self, actual_cls: int,
                        predicted_cls: int) -> List[Prediction]:
        return [p for p in self.predictions
                if p.actual == actual_cls and p.predicted == predicted_cls]

    # alias matching the reference API
    eval = eval_batch

    def merge(self, other: "Evaluation") -> "Evaluation":
        if other.confusion is not None:
            self._ensure(other.confusion.shape[0])
            self.confusion += other.confusion
        self.top_n_correct += other.top_n_correct
        self.top_n_total += other.top_n_total
        self.predictions += other.predictions
        return self

    # -- metrics -------------------------------------------------------------
    def _tp(self):
        return np.diag(self.confusion).astype(np.float64)

    def accuracy(self) -> float:
        if self.confusion is None:
            return 0.0
        total = self.confusion.sum()
        return float(self._tp().sum() / total) if total else 0.0

    def precision(self, cls: Optional[int] = None) -> float:
        if self.confusion is None:
            return 0.0
        col = self.confusion.sum(axis=0).astype(np.float64)
        with np.errstate(divide="ignore", invalid="ignore"):
            per = np.where(col > 0, self._tp() / col, np.nan)
        if cls is not None:
            return float(np.nan_to_num(per[cls]))
        return float(np.nanmean(per)) if not np.all(np.isnan(per)) else 0.0

    def recall(self, cls: Optional[int] = None) -> float:
        if self.confusion is None:
            return 0.0
        row = self.confusion.sum(axis=1).astype(np.float64)
        with np.errstate(divide="ignore", invalid="ignore"):
            per = np.where(row > 0, self._tp() / row, np.nan)
        if cls is not None:
            return float(np.nan_to_num(per[cls]))
        return float(np.nanmean(per)) if not np.all(np.isnan(per)) else 0.0

    def f1(self, cls: Optional[int] = None) -> float:
        """Per-class, binary (2-class: class 1's F1, Evaluation.java:949),
        or macro = mean of per-class F1 over classes where precision AND
        recall are defined (Evaluation.java:954-965 fBeta Macro — NOT the
        harmonic mean of macro-precision/macro-recall)."""
        if self.confusion is None:
            return 0.0
        if cls is not None:
            p = self.precision(cls)
            r = self.recall(cls)
            return 2 * p * r / (p + r) if (p + r) > 0 else 0.0
        n = self.confusion.shape[0]
        if n == 2:
            tp = float(self.confusion[1, 1])
            fp = float(self.confusion[0, 1])
            fn = float(self.confusion[1, 0])
            denom = 2 * tp + fp + fn
            return 2 * tp / denom if denom > 0 else 0.0
        col = self.confusion.sum(axis=0).astype(np.float64)
        row = self.confusion.sum(axis=1).astype(np.float64)
        tp = self._tp()
        vals = []
        for i in range(n):
            if col[i] == 0 or row[i] == 0:  # p or r undefined: excluded
                continue
            p, r = tp[i] / col[i], tp[i] / row[i]
            vals.append(2 * p * r / (p + r) if (p + r) > 0 else 0.0)
        return float(np.mean(vals)) if vals else 0.0

    def stats(self) -> str:
        n = self.confusion.shape[0] if self.confusion is not None else 0
        lines = [
            "========================Evaluation Metrics========================",
            f" # of classes: {n}",
            f" Accuracy:  {self.accuracy():.4f}",
            f" Precision: {self.precision():.4f}",
            f" Recall:    {self.recall():.4f}",
            f" F1 Score:  {self.f1():.4f}",
            "",
            "Confusion matrix (rows=actual, cols=predicted):",
            str(self.confusion),
            "==================================================================",
        ]
        return "\n".join(lines)


class RegressionEvaluation(IEvaluation):
    """Per-column regression metrics (reference: eval/RegressionEvaluation
    — MSE, MAE, RMSE, RSE, correlation)."""

    def __init__(self, n_columns: Optional[int] = None):
        self.n = 0
        self.sum_err2 = None
        self.sum_abs = None
        self.sum_label = None
        self.sum_label2 = None
        self.sum_pred = None
        self.sum_pred2 = None
        self.sum_lp = None

    def eval_batch(self, labels, predictions, mask=None):
        l = _host(labels).astype(np.float64)
        p = _host(predictions).astype(np.float64)
        if l.ndim == 3:
            l = l.reshape(-1, l.shape[-1])
            p = p.reshape(-1, p.shape[-1])
        if mask is not None:
            m = _host(mask).reshape(-1) > 0
            l, p = l[m], p[m]
        if self.sum_err2 is None:
            c = l.shape[-1]
            for name in ("sum_err2", "sum_abs", "sum_label", "sum_label2",
                         "sum_pred", "sum_pred2", "sum_lp"):
                setattr(self, name, np.zeros(c))
        d = p - l
        self.n += l.shape[0]
        self.sum_err2 += (d * d).sum(0)
        self.sum_abs += np.abs(d).sum(0)
        self.sum_label += l.sum(0)
        self.sum_label2 += (l * l).sum(0)
        self.sum_pred += p.sum(0)
        self.sum_pred2 += (p * p).sum(0)
        self.sum_lp += (l * p).sum(0)

    eval = eval_batch

    def merge(self, other: "RegressionEvaluation"):
        if other.sum_err2 is None:
            return self
        if self.sum_err2 is None:
            for name in ("sum_err2", "sum_abs", "sum_label", "sum_label2",
                         "sum_pred", "sum_pred2", "sum_lp"):
                setattr(self, name, np.array(getattr(other, name)))
            self.n = other.n
            return self
        self.n += other.n
        for name in ("sum_err2", "sum_abs", "sum_label", "sum_label2",
                     "sum_pred", "sum_pred2", "sum_lp"):
            setattr(self, name, getattr(self, name) + getattr(other, name))
        return self

    def mean_squared_error(self, col: int = 0) -> float:
        return float(self.sum_err2[col] / self.n)

    def mean_absolute_error(self, col: int = 0) -> float:
        return float(self.sum_abs[col] / self.n)

    def root_mean_squared_error(self, col: int = 0) -> float:
        return float(np.sqrt(self.sum_err2[col] / self.n))

    def correlation_r2(self, col: int = 0) -> float:
        n = self.n
        num = n * self.sum_lp[col] - self.sum_label[col] * self.sum_pred[col]
        den = np.sqrt(n * self.sum_label2[col] - self.sum_label[col] ** 2) * np.sqrt(
            n * self.sum_pred2[col] - self.sum_pred[col] ** 2
        )
        return float((num / den) ** 2) if den > 0 else 0.0

    def stats(self) -> str:
        cols = len(self.sum_err2) if self.sum_err2 is not None else 0
        lines = ["Regression evaluation:"]
        for c in range(cols):
            lines.append(
                f" col {c}: MSE={self.mean_squared_error(c):.6f} "
                f"MAE={self.mean_absolute_error(c):.6f} "
                f"RMSE={self.root_mean_squared_error(c):.6f} "
                f"R^2={self.correlation_r2(c):.4f}"
            )
        return "\n".join(lines)


class ROC(IEvaluation):
    """Binary ROC with exact threshold sweep over accumulated scores
    (reference: eval/ROC.java uses a fixed threshold-step approximation; we
    keep all scores — memory is fine at framework-test scale — and compute
    the exact AUC)."""

    def __init__(self, threshold_steps: int = 0):
        self.scores = []
        self.labels = []

    def eval_batch(self, labels, predictions, mask=None):
        l = _host(labels).astype(np.float64)
        p = _host(predictions).astype(np.float64)
        if l.ndim == 2 and l.shape[-1] == 2:
            # [P(class0), P(class1)] convention, positive = column 1
            l = l[:, 1]
            p = p[:, 1]
        self.labels.append(l.reshape(-1))
        self.scores.append(p.reshape(-1))

    eval = eval_batch

    def merge(self, other: "ROC"):
        self.labels += other.labels
        self.scores += other.scores
        return self

    def calculate_auc(self) -> float:
        y = np.concatenate(self.labels)
        s = np.concatenate(self.scores)
        order = np.argsort(-s, kind="stable")
        y = y[order]
        pos = y.sum()
        neg = len(y) - pos
        if pos == 0 or neg == 0:
            return 0.0
        tps = np.cumsum(y)
        fps = np.cumsum(1 - y)
        tpr = np.concatenate([[0.0], tps / pos])
        fpr = np.concatenate([[0.0], fps / neg])
        # np.trapezoid from numpy 2.0; np.trapz before it
        trapezoid = getattr(np, "trapezoid", None) or np.trapz
        return float(trapezoid(tpr, fpr))


class ROCMultiClass(IEvaluation):
    """One-vs-all ROC per class (reference: eval/ROCMultiClass.java)."""

    def __init__(self):
        self.per_class = {}

    def eval_batch(self, labels, predictions, mask=None):
        l = _host(labels)
        p = _host(predictions)
        for c in range(l.shape[-1]):
            roc = self.per_class.setdefault(c, ROC())
            roc.eval_batch(l[..., c], p[..., c])

    eval = eval_batch

    def merge(self, other: "ROCMultiClass"):
        for c, roc in other.per_class.items():
            if c in self.per_class:
                self.per_class[c].merge(roc)
            else:
                self.per_class[c] = roc
        return self

    def calculate_auc(self, cls: int) -> float:
        return self.per_class[cls].calculate_auc()


class ROCBinary(IEvaluation):
    """Independent per-output-column binary ROC (reference:
    eval/ROCBinary.java — multi-label outputs, one ROC per column, with
    optional per-example mask)."""

    def __init__(self):
        self.per_column = {}

    def eval_batch(self, labels, predictions, mask=None):
        l = _host(labels).astype(np.float64)
        p = _host(predictions).astype(np.float64)
        if l.ndim == 3:
            l = l.reshape(-1, l.shape[-1])
            p = p.reshape(-1, p.shape[-1])
        if mask is not None:
            m = _host(mask).reshape(-1) > 0
            l, p = l[m], p[m]
        for c in range(l.shape[-1]):
            roc = self.per_column.setdefault(c, ROC())
            roc.eval_batch(l[:, c], p[:, c])

    eval = eval_batch

    def merge(self, other: "ROCBinary"):
        for c, roc in other.per_column.items():
            if c in self.per_column:
                self.per_column[c].merge(roc)
            else:
                self.per_column[c] = roc
        return self

    def calculate_auc(self, col: int = 0) -> float:
        return self.per_column[col].calculate_auc()


class EvaluationBinary(IEvaluation):
    """Per-output-column binary evaluation at threshold 0.5
    (reference: eval/EvaluationBinary.java)."""

    def __init__(self):
        self.tp = self.fp = self.tn = self.fn = None

    def eval_batch(self, labels, predictions, mask=None):
        l = _host(labels) > 0.5
        p = _host(predictions) > 0.5
        if l.ndim == 3:
            l = l.reshape(-1, l.shape[-1])
            p = p.reshape(-1, p.shape[-1])
        if mask is not None:
            m = _host(mask).reshape(-1) > 0
            l, p = l[m], p[m]
        if self.tp is None:
            c = l.shape[-1]
            self.tp = np.zeros(c); self.fp = np.zeros(c)
            self.tn = np.zeros(c); self.fn = np.zeros(c)
        self.tp += (l & p).sum(0)
        self.fp += (~l & p).sum(0)
        self.tn += (~l & ~p).sum(0)
        self.fn += (l & ~p).sum(0)

    eval = eval_batch

    def merge(self, other: "EvaluationBinary"):
        if other.tp is None:
            return self
        if self.tp is None:
            self.tp, self.fp = np.array(other.tp), np.array(other.fp)
            self.tn, self.fn = np.array(other.tn), np.array(other.fn)
            return self
        self.tp += other.tp; self.fp += other.fp
        self.tn += other.tn; self.fn += other.fn
        return self

    def accuracy(self, col: int = 0) -> float:
        tot = self.tp[col] + self.fp[col] + self.tn[col] + self.fn[col]
        return float((self.tp[col] + self.tn[col]) / tot) if tot else 0.0

    def f1(self, col: int = 0) -> float:
        denom = 2 * self.tp[col] + self.fp[col] + self.fn[col]
        return float(2 * self.tp[col] / denom) if denom else 0.0

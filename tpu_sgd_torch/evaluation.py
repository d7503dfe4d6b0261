"""Model evaluation metrics: the port of ``tpu_sgd/evaluation.py``
(``RegressionMetrics``, ``BinaryClassificationMetrics``,
``MulticlassMetrics``).

Each computes on the device of the scores it is given (the CPU for numpy
arrays).  The ROC/PR construction sorts the scores descending, takes
int64 cumulative positive and negative counts, collapses tied scores to
their group tail, and integrates with the trapezoid rule in f64: tied
positions repeat their group-tail point and add zero area, so the AUC
counts a tie as half, as the reference's per-threshold grouping does.
The curve getters work on the distinct thresholds, brought to the host
once.  The confusion matrix is one ``bincount``.
"""

from __future__ import annotations

import numpy as np
import torch

Tensor = torch.Tensor


def _as_vector(a, dtype=torch.float32, device=None) -> Tensor:
    """``a`` flattened as a tensor: a tensor stays on its device, anything
    else goes to ``device`` (the CPU by default)."""
    if isinstance(a, Tensor):
        return a.reshape(-1).to(dtype)
    return torch.as_tensor(np.asarray(a), dtype=dtype,
                           device=device).reshape(-1)


# ---------------------------------------------------------------------------
# Regression
# ---------------------------------------------------------------------------


class RegressionMetrics:
    """Error metrics over ``(prediction, observation)`` arrays, as [U]
    RegressionMetrics: ``mean_squared_error``, ``root_mean_squared_error``,
    ``mean_absolute_error``, ``r2``, ``explained_variance``
    (``sum((pred - mean(obs))^2) / n``, the reference's convention)."""

    def __init__(self, predictions, observations):
        pred = _as_vector(predictions)
        obs = _as_vector(observations, device=pred.device)
        if pred.shape != obs.shape:
            raise ValueError(
                f"predictions {tuple(pred.shape)} vs observations "
                f"{tuple(obs.shape)}"
            )
        if pred.shape[0] == 0:
            raise ValueError("empty input")
        err = pred - obs
        n = pred.shape[0]
        obs_mean = torch.mean(obs)
        ss_err = torch.sum(err * err)
        stats = torch.stack([
            torch.mean(err * err),
            torch.mean(torch.abs(err)),
            torch.sum((pred - obs_mean) ** 2) / n,
            1.0 - ss_err / torch.sum((obs - obs_mean) ** 2),
        ]).cpu().numpy()
        self.mean_squared_error = float(stats[0])
        self.root_mean_squared_error = float(np.sqrt(self.mean_squared_error))
        self.mean_absolute_error = float(stats[1])
        self.explained_variance = float(stats[2])
        self.r2 = float(stats[3])


# ---------------------------------------------------------------------------
# Binary classification
# ---------------------------------------------------------------------------


def _binary_curves(scores: Tensor, labels: Tensor):
    """Sorted-cumulative statistics for every threshold: per position
    ``(score, cumTP, cumFP, boundary)``, where every position of a tied
    score group carries its group TAIL's int64 counts."""
    n = scores.shape[0]
    order = torch.argsort(scores, descending=True)
    s = scores[order]
    pos = (labels[order] > 0.5).to(torch.int64)
    cum_tp = torch.cumsum(pos, 0)
    cum_fp = torch.cumsum(1 - pos, 0)
    boundary = torch.ones((n,), dtype=torch.bool, device=s.device)
    boundary[:-1] = s[1:] != s[:-1]
    idx = torch.arange(n, device=s.device)
    ends = torch.where(boundary, idx, n - 1)
    group_end = torch.flip(torch.cummin(torch.flip(ends, (0,)), 0).values,
                           (0,))
    return s, cum_tp[group_end], cum_fp[group_end], boundary


def _trapezoid(x: Tensor, y: Tensor) -> Tensor:
    return torch.sum((x[1:] - x[:-1]) * (y[1:] + y[:-1]) * 0.5)


class BinaryClassificationMetrics:
    """ROC / PR metrics over ``(score, label)`` arrays with 0/1 labels, as
    [U] BinaryClassificationMetrics: ``area_under_roc``, ``area_under_pr``,
    ``roc()``, ``pr()``, ``thresholds()``, ``precision_by_threshold()``,
    ``recall_by_threshold()``, ``f_measure_by_threshold(beta)``;
    ``num_bins`` keeps every ``ceil(groups/num_bins)``-th distinct
    threshold for the curves (the AUCs always integrate the full curve)."""

    def __init__(self, scores, labels, num_bins: int = 0):
        scores = _as_vector(scores)
        labels = _as_vector(labels, device=scores.device)
        if scores.shape != labels.shape:
            raise ValueError(
                f"scores {tuple(scores.shape)} vs labels "
                f"{tuple(labels.shape)}")
        if scores.shape[0] == 0:
            raise ValueError("empty input")
        if num_bins < 0:
            raise ValueError(f"num_bins must be >= 0, got {num_bins}")
        bad = (labels != 0.0) & (labels != 1.0)
        if bool(bad.any()):
            # LIBSVM's -1/+1 would count each negative twice and skew
            # every curve silently
            raise ValueError(
                "labels must be 0/1; found "
                f"{torch.unique(labels[bad])[:5].cpu().numpy()} (map -1/+1 "
                "labels first, e.g. y = (y > 0).astype('float32'))"
            )
        s, cum_tp, cum_fp, boundary = _binary_curves(scores, labels)
        num_pos, num_neg = (int(v) for v in
                            torch.stack([cum_tp[-1], cum_fp[-1]]).cpu())
        self._num_pos, self._num_neg = float(num_pos), float(num_neg)
        if num_pos == 0 or num_neg == 0:
            raise ValueError(
                "labels must contain both classes "
                f"(pos={self._num_pos}, neg={self._num_neg})"
            )
        tp = cum_tp.to(torch.float64)
        fp = cum_fp.to(torch.float64)
        tpr = tp / num_pos
        fpr = fp / num_neg
        prec = tp / torch.clamp(tp + fp, min=1.0)
        zero = torch.zeros((1,), dtype=torch.float64, device=s.device)
        # the reference anchors PR at (0, precision of the top group)
        aucs = torch.stack([
            _trapezoid(torch.cat([zero, fpr]), torch.cat([zero, tpr])),
            _trapezoid(torch.cat([zero, tpr]), torch.cat([prec[:1], prec])),
        ]).cpu().numpy()
        self.area_under_roc = float(aucs[0])
        self.area_under_pr = float(aucs[1])
        self._thresholds = s[boundary].cpu().numpy()
        self._tp = cum_tp[boundary].to(torch.float32).cpu().numpy()
        self._fp = cum_fp[boundary].to(torch.float32).cpu().numpy()
        if num_bins > 0 and self._thresholds.size > num_bins:
            stride = int(np.ceil(self._thresholds.size / num_bins))
            keep = np.zeros(self._thresholds.size, bool)
            keep[stride - 1 :: stride] = True
            keep[-1] = True  # always keep the all-predicted-positive tail
            self._thresholds = self._thresholds[keep]
            self._tp = self._tp[keep]
            self._fp = self._fp[keep]

    def thresholds(self) -> np.ndarray:
        return self._thresholds.copy()

    def roc(self) -> np.ndarray:
        """(FPR, TPR) points with the reference's (0,0) and (1,1) anchors."""
        fpr = self._fp / self._num_neg
        tpr = self._tp / self._num_pos
        pts = np.stack([fpr, tpr], axis=1)
        return np.concatenate([[[0.0, 0.0]], pts, [[1.0, 1.0]]])

    def pr(self) -> np.ndarray:
        """(recall, precision) points anchored at (0, first precision)."""
        recall = self._tp / self._num_pos
        precision = self._tp / np.maximum(self._tp + self._fp, 1.0)
        pts = np.stack([recall, precision], axis=1)
        return np.concatenate([[[0.0, pts[0, 1]]], pts])

    def precision_by_threshold(self) -> np.ndarray:
        p = self._tp / np.maximum(self._tp + self._fp, 1.0)
        return np.stack([self._thresholds, p], axis=1)

    def recall_by_threshold(self) -> np.ndarray:
        return np.stack([self._thresholds, self._tp / self._num_pos], axis=1)

    def f_measure_by_threshold(self, beta: float = 1.0) -> np.ndarray:
        p = self._tp / np.maximum(self._tp + self._fp, 1.0)
        r = self._tp / self._num_pos
        b2 = beta * beta
        denom = np.maximum(b2 * p + r, 1e-38)
        f = (1 + b2) * p * r / denom
        return np.stack([self._thresholds, f], axis=1)


# ---------------------------------------------------------------------------
# Multiclass
# ---------------------------------------------------------------------------


class MulticlassMetrics:
    """Confusion-matrix metrics over ``(prediction, label)`` arrays, as [U]
    MulticlassMetrics: ``confusion_matrix`` (rows = true label, columns =
    prediction), ``accuracy``, per-label ``precision/recall/f_measure`` and
    the label-frequency ``weighted_*`` aggregates."""

    def __init__(self, predictions, labels, num_classes: int = 0):
        pred = _as_vector(predictions, torch.float64)
        obs = _as_vector(labels, torch.float64, device=pred.device)
        if pred.shape != obs.shape:
            raise ValueError(
                f"predictions {tuple(pred.shape)} vs labels "
                f"{tuple(obs.shape)}")
        if pred.shape[0] == 0:
            raise ValueError("empty input")
        k = int(num_classes) if num_classes > 0 else int(
            torch.maximum(pred.max(), obs.max())) + 1
        bad = ((pred < 0) | (pred >= k) | (obs < 0) | (obs >= k)
               | (pred != torch.floor(pred)) | (obs != torch.floor(obs)))
        if bool(bad.any()):
            # a dropped cell would deflate accuracy while the count still
            # has the sample: out-of-range input is the caller's error
            found = torch.unique(torch.cat([pred[bad], obs[bad]]))[:5]
            raise ValueError(
                f"labels/predictions must be integers in [0, {k}); found "
                f"{found.cpu().numpy()}"
            )
        self.num_classes = k
        flat = obs.to(torch.int64) * k + pred.to(torch.int64)
        self.confusion_matrix = torch.bincount(flat, minlength=k * k) \
            .reshape(k, k).to(torch.float32).cpu().numpy()
        self._n = float(pred.shape[0])

    @property
    def labels(self) -> np.ndarray:
        return np.arange(self.num_classes, dtype=np.float64)

    @property
    def accuracy(self) -> float:
        return float(np.trace(self.confusion_matrix) / self._n)

    def precision(self, label) -> float:
        i = int(label)
        col = self.confusion_matrix[:, i].sum()
        return float(self.confusion_matrix[i, i] / col) if col else 0.0

    def recall(self, label) -> float:
        i = int(label)
        row = self.confusion_matrix[i, :].sum()
        return float(self.confusion_matrix[i, i] / row) if row else 0.0

    def f_measure(self, label, beta: float = 1.0) -> float:
        p, r = self.precision(label), self.recall(label)
        b2 = beta * beta
        return (1 + b2) * p * r / (b2 * p + r) if (p + r) else 0.0

    def _weighted(self, per_label) -> float:
        w = self.confusion_matrix.sum(axis=1) / self._n
        return float(sum(w[i] * per_label(i) for i in range(self.num_classes)))

    @property
    def weighted_precision(self) -> float:
        return self._weighted(self.precision)

    @property
    def weighted_recall(self) -> float:
        return self._weighted(self.recall)

    def weighted_f_measure(self, beta: float = 1.0) -> float:
        return self._weighted(lambda i: self.f_measure(i, beta))

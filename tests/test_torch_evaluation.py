"""Parity of the port's evaluation metrics (``tpu_sgd_torch/evaluation.py``)
with the JAX package (``tpu_sgd/evaluation.py``) on the CPU: the cases of
``tests/test_evaluation.py``, each fed the same numpy scores and labels on
both sides.

Tolerances: confusion matrices, thresholds, curve points and counts
exactly; AUCs to 1e-6 against JAX (the port integrates in f64, the JAX
package in f32) and to 1e-4 against sklearn, as the JAX test; the
regression metrics at rtol 1e-5.
"""

import numpy as np
import pytest
import torch

import tpu_sgd.evaluation as je
import tpu_sgd_torch as tst
from tpu_sgd_torch import evaluation as te


def _binary_pair(scores, labels, **kw):
    return (te.BinaryClassificationMetrics(scores, labels, **kw),
            je.BinaryClassificationMetrics(scores, labels, **kw))


def _same_curves(t, j):
    np.testing.assert_array_equal(t.thresholds(), j.thresholds())
    np.testing.assert_allclose(t.roc(), j.roc(), rtol=1e-6)
    np.testing.assert_allclose(t.pr(), j.pr(), rtol=1e-6)
    np.testing.assert_allclose(t.precision_by_threshold(),
                               j.precision_by_threshold(), rtol=1e-6)
    np.testing.assert_allclose(t.recall_by_threshold(),
                               j.recall_by_threshold(), rtol=1e-6)
    np.testing.assert_allclose(t.f_measure_by_threshold(0.5),
                               j.f_measure_by_threshold(0.5), rtol=1e-6)
    assert t.area_under_roc == pytest.approx(j.area_under_roc, abs=1e-6)
    assert t.area_under_pr == pytest.approx(j.area_under_pr, abs=1e-6)


class TestRegressionMetrics:
    def test_against_jax_and_sklearn(self, rng):
        from sklearn import metrics as sk

        obs = rng.normal(size=(300,)).astype(np.float32)
        pred = obs + 0.3 * rng.normal(size=(300,)).astype(np.float32)
        m = te.RegressionMetrics(pred, obs)
        j = je.RegressionMetrics(pred, obs)
        for name in ("mean_squared_error", "root_mean_squared_error",
                     "mean_absolute_error", "explained_variance", "r2"):
            assert getattr(m, name) == pytest.approx(getattr(j, name),
                                                     rel=1e-5)
        assert m.mean_squared_error == pytest.approx(
            sk.mean_squared_error(obs, pred), rel=1e-4)
        assert m.r2 == pytest.approx(sk.r2_score(obs, pred), rel=1e-3)

    def test_explained_variance_convention(self):
        pred = np.array([1.0, 2.0, 3.0], np.float32)
        obs = np.array([1.0, 2.0, 9.0], np.float32)
        m = te.RegressionMetrics(pred, obs)
        expected = float(np.mean((pred - obs.mean()) ** 2))
        assert m.explained_variance == pytest.approx(expected, rel=1e-5)

    def test_perfect_fit(self):
        y = np.array([1.0, -2.0, 5.0], np.float32)
        m = te.RegressionMetrics(y, y)
        assert m.mean_squared_error == 0.0
        assert m.r2 == pytest.approx(1.0)

    def test_empty_and_mismatched_rejected(self):
        with pytest.raises(ValueError, match="empty"):
            te.RegressionMetrics([], [])
        with pytest.raises(ValueError, match="vs observations"):
            te.RegressionMetrics([1.0, 2.0], [1.0])


class TestBinaryClassificationMetrics:
    def test_auc_against_jax_and_sklearn(self, rng):
        from sklearn import metrics as sk

        labels = (rng.random(500) < 0.4).astype(np.float32)
        scores = (labels + rng.normal(scale=0.8, size=500)).astype(np.float32)
        t, j = _binary_pair(scores, labels)
        _same_curves(t, j)
        assert t.area_under_roc == pytest.approx(
            sk.roc_auc_score(labels, scores), abs=1e-4)

    def test_auc_with_ties(self):
        from sklearn import metrics as sk

        rng = np.random.default_rng(7)
        labels = (rng.random(400) < 0.5).astype(np.float32)
        scores = np.round(labels * 0.6 + rng.random(400) * 0.4, 1).astype(
            np.float32)
        t, j = _binary_pair(scores, labels)
        _same_curves(t, j)
        assert t.area_under_roc == pytest.approx(
            sk.roc_auc_score(labels, scores), abs=1e-4)

    def test_tensor_scores_stay_on_their_device(self, rng):
        labels = (rng.random(300) < 0.5).astype(np.float32)
        scores = rng.random(300).astype(np.float32)
        t = te.BinaryClassificationMetrics(torch.as_tensor(scores),
                                           torch.as_tensor(labels))
        j = je.BinaryClassificationMetrics(scores, labels)
        _same_curves(t, j)

    def test_curve_shapes_and_anchors(self):
        scores = np.array([0.9, 0.8, 0.7, 0.6, 0.5], np.float32)
        labels = np.array([1.0, 1.0, 0.0, 1.0, 0.0], np.float32)
        m = te.BinaryClassificationMetrics(scores, labels)
        roc = m.roc()
        assert tuple(roc[0]) == (0.0, 0.0)
        assert tuple(roc[-1]) == (1.0, 1.0)
        pr = m.pr()
        assert pr[0, 0] == 0.0
        assert pr[0, 1] == pr[1, 1]
        assert m.thresholds().shape == (5,)
        p = dict(map(tuple, m.precision_by_threshold()))
        assert p[np.float32(0.9)] == pytest.approx(1.0)
        r = dict(map(tuple, m.recall_by_threshold()))
        assert r[np.float32(0.5)] == pytest.approx(1.0)

    def test_perfect_separation(self):
        scores = np.array([0.9, 0.8, 0.2, 0.1], np.float32)
        labels = np.array([1.0, 1.0, 0.0, 0.0], np.float32)
        m = te.BinaryClassificationMetrics(scores, labels)
        assert m.area_under_roc == pytest.approx(1.0)
        assert m.area_under_pr == pytest.approx(1.0)

    def test_f1_matches_closed_form(self):
        scores = np.array([0.9, 0.8, 0.7, 0.6], np.float32)
        labels = np.array([1.0, 0.0, 1.0, 0.0], np.float32)
        m = te.BinaryClassificationMetrics(scores, labels)
        f = dict(map(tuple, m.f_measure_by_threshold()))
        assert f[np.float32(0.7)] == pytest.approx(0.8)

    def test_num_bins_downsamples_like_jax(self, rng):
        labels = (rng.random(1000) < 0.5).astype(np.float32)
        scores = rng.random(1000).astype(np.float32)
        full = te.BinaryClassificationMetrics(scores, labels)
        t, j = _binary_pair(scores, labels, num_bins=20)
        _same_curves(t, j)
        assert t.thresholds().size <= 21
        assert t.thresholds().size < full.thresholds().size
        assert t.area_under_roc == pytest.approx(full.area_under_roc)

    @pytest.mark.parametrize("scores,labels,match", [
        ([0.5, 0.6], [1.0, 1.0], "both classes"),
        ([0.9, 0.1, 0.8], [1.0, -1.0, 1.0], "map -1/\\+1"),
        ([0.5], [1.0, 0.0], "vs labels"),
        ([], [], "empty"),
    ])
    def test_bad_input_rejected(self, scores, labels, match):
        with pytest.raises(ValueError, match=match):
            te.BinaryClassificationMetrics(np.asarray(scores, np.float32),
                                           np.asarray(labels, np.float32))

    def test_negative_num_bins_rejected(self):
        with pytest.raises(ValueError, match="num_bins"):
            te.BinaryClassificationMetrics([0.1, 0.9], [0.0, 1.0],
                                           num_bins=-1)


class TestMulticlassMetrics:
    def test_confusion_and_aggregates(self):
        pred = np.array([0, 0, 1, 1, 2, 2, 2, 0], np.float64)
        obs = np.array([0, 1, 1, 1, 2, 2, 0, 0], np.float64)
        m = te.MulticlassMetrics(pred, obs)
        np.testing.assert_array_equal(
            m.confusion_matrix,
            [[2.0, 0.0, 1.0], [1.0, 2.0, 0.0], [0.0, 0.0, 2.0]])
        assert m.accuracy == pytest.approx(6 / 8)
        assert m.precision(0) == pytest.approx(2 / 3)
        assert m.recall(2) == pytest.approx(1.0)
        assert m.f_measure(1) == pytest.approx(
            2 * (1.0 * 2 / 3) / (1.0 + 2 / 3))
        np.testing.assert_array_equal(m.labels, [0.0, 1.0, 2.0])

    def test_matches_jax_exactly(self, rng):
        obs = rng.integers(0, 4, size=200).astype(np.float64)
        pred = np.where(rng.random(200) < 0.7, obs,
                        rng.integers(0, 4, size=200)).astype(np.float64)
        m = te.MulticlassMetrics(torch.as_tensor(pred), torch.as_tensor(obs))
        j = je.MulticlassMetrics(pred, obs)
        np.testing.assert_array_equal(m.confusion_matrix, j.confusion_matrix)
        assert m.confusion_matrix.dtype == j.confusion_matrix.dtype
        assert m.accuracy == j.accuracy
        assert m.weighted_precision == pytest.approx(j.weighted_precision)
        assert m.weighted_recall == pytest.approx(j.weighted_recall)
        assert m.weighted_f_measure() == pytest.approx(j.weighted_f_measure())

    def test_weighted_against_sklearn(self, rng):
        from sklearn import metrics as sk

        obs = rng.integers(0, 4, size=200).astype(np.float64)
        pred = np.where(rng.random(200) < 0.7, obs,
                        rng.integers(0, 4, size=200)).astype(np.float64)
        m = te.MulticlassMetrics(pred, obs)
        assert m.accuracy == pytest.approx(sk.accuracy_score(obs, pred))
        assert m.weighted_f_measure() == pytest.approx(
            sk.f1_score(obs, pred, average="weighted", zero_division=0),
            abs=1e-6)

    def test_explicit_num_classes(self):
        m = te.MulticlassMetrics([0.0, 1.0], [0.0, 1.0], num_classes=5)
        assert m.confusion_matrix.shape == (5, 5)
        assert m.recall(4) == 0.0

    def test_out_of_range_and_fractional_rejected(self):
        with pytest.raises(ValueError, match=r"\[0, 3\)"):
            te.MulticlassMetrics([0.0, 1.0, 2.0], [0.0, 3.0, 1.0],
                                 num_classes=3)
        with pytest.raises(ValueError):
            te.MulticlassMetrics([-1.0, 1.0], [0.0, 1.0], num_classes=2)
        with pytest.raises(ValueError, match="integers"):
            te.MulticlassMetrics([0.7, 1.2], [0.2, 1.9], num_classes=2)


def test_logistic_scores_feed_binary_metrics(rng):
    n, d = 400, 5
    w = rng.normal(size=(d,)).astype(np.float32)
    X = rng.normal(size=(n, d)).astype(np.float32)
    y = (X @ w > 0).astype(np.float32)
    model = tst.LogisticRegressionWithSGD.train((X, y), num_iterations=30,
                                                device="cpu")
    model.clear_threshold()
    m = tst.BinaryClassificationMetrics(model.predict(X), y)
    assert m.area_under_roc > 0.95

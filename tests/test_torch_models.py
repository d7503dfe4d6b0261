"""Parity of the port's model families (``tpu_sgd_torch.models``) with the
JAX package on the CPU, both sides with ``schedule="off"`` (the optimizer
runs exactly as configured; the planner's twins are
``tests/test_torch_plan.py``).

Tolerances: full-batch training, so the trajectories are the same
arithmetic — weights and intercept rtol 1e-4 (atol 1e-5), margins and
scores rtol 1e-4 (atol 1e-4); thresholded labels exactly equal.
"""

import numpy as np
import pytest
import torch

import tpu_sgd.models as jm
import tpu_sgd_torch.models as tm
from tpu_sgd_torch.interop import glm_model_from_numpy, sgd_config_from_dict
from tpu_sgd_torch.ops.updaters import L1Updater
from tpu_sgd.ops.updaters import L1Updater as JL1Updater
from tpu_sgd_torch.utils.mlutils import (
    a9a_like_data,
    linear_data,
    logistic_data,
    svm_data,
)


def _close_models(t, j, X):
    np.testing.assert_allclose(t.weights.numpy(), np.asarray(j.weights),
                               rtol=1e-4, atol=1e-5)
    assert t.intercept == pytest.approx(j.intercept, rel=1e-4, abs=1e-5)
    np.testing.assert_allclose(t.predict_margin(X).numpy(),
                               np.asarray(j.predict_margin(X)), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("intercept", [False, True])
def test_linear_regression_matches_jax(intercept):
    X, y, _ = linear_data(1500, 8, intercept=0.7, seed=11)
    kw = dict(intercept=intercept)
    j = jm.LinearRegressionWithSGD.train((X, y), 40, 0.5, schedule="off",
                                         **kw)
    t = tm.LinearRegressionWithSGD.train((X, y), 40, 0.5, device="cpu",
                                         schedule="off", **kw)
    _close_models(t, j, X)
    np.testing.assert_allclose(t.predict(X).numpy(), np.asarray(j.predict(X)),
                               rtol=1e-4, atol=1e-4)
    if intercept:
        assert t.intercept == pytest.approx(0.7, abs=0.05)


@pytest.mark.parametrize("family", ["lasso", "ridge"])
def test_regularized_regression_matches_jax(family):
    X, y, _ = linear_data(1000, 6, seed=12)
    jcls = {"lasso": jm.LassoWithSGD, "ridge": jm.RidgeRegressionWithSGD}
    tcls = {"lasso": tm.LassoWithSGD, "ridge": tm.RidgeRegressionWithSGD}
    j = jcls[family].train((X, y), 30, 0.5, 0.05, schedule="off")
    t = tcls[family].train((X, y), 30, 0.5, 0.05, device="cpu",
                           schedule="off")
    _close_models(t, j, X)


def test_logistic_regression_matches_jax():
    X, y, _ = a9a_like_data(2000, seed=13)
    j = jm.LogisticRegressionWithSGD.train((X, y), 60, 2.0, schedule="off",
                                           intercept=True)
    t = tm.LogisticRegressionWithSGD.train((X, y), 60, 2.0, device="cpu",
                                           intercept=True, schedule="off")
    _close_models(t, j, X)
    np.testing.assert_array_equal(t.predict(X).numpy(),
                                  np.asarray(j.predict(X)))
    j.clear_threshold()
    t.clear_threshold()
    np.testing.assert_allclose(t.predict(X).numpy(), np.asarray(j.predict(X)),
                               rtol=1e-4, atol=1e-5)


def test_svm_with_l1_matches_jax():
    X, y, _ = svm_data(1500, 10, seed=14)
    j = jm.SVMWithSGD.train((X, y), 50, 1.0, 0.01, updater=JL1Updater(),
                            schedule="off")
    t = tm.SVMWithSGD.train((X, y), 50, 1.0, 0.01, updater=L1Updater(),
                            device="cpu", schedule="off")
    _close_models(t, j, X)
    np.testing.assert_array_equal(t.predict(X).numpy(),
                                  np.asarray(j.predict(X)))


def test_thresholds():
    m = tm.SVMModel(np.asarray([1.0, -1.0], np.float32), 0.5, device="cpu")
    X = np.asarray([[1.0, 0.0], [0.0, 2.0], [0.2, 0.0]], np.float32)
    assert m.predict(X).tolist() == [1.0, 0.0, 1.0]
    assert m.set_threshold(1.0).predict(X).tolist() == [1.0, 0.0, 0.0]
    assert m.clear_threshold().predict(X).numpy() == pytest.approx(
        [1.5, -1.5, 0.7])
    lr = tm.LogisticRegressionModel(np.zeros(2, np.float32), device="cpu")
    assert lr.threshold == 0.5
    assert lr.clear_threshold().predict(X[0]).item() == pytest.approx(0.5)


@pytest.mark.parametrize("labels", [[0.0, 2.0], [-1.0, 1.0]])
def test_label_validation(labels):
    X, _, _ = logistic_data(10, 3, seed=15)
    y = np.asarray(labels * 5, np.float32)
    for cls in (tm.LogisticRegressionWithSGD, tm.SVMWithSGD):
        with pytest.raises(ValueError, match="labels should be 0 or 1"):
            cls.train((X, y), 5, device="cpu")
        with pytest.raises(ValueError, match="labels should be 0 or 1"):
            cls.train((torch.from_numpy(X), torch.from_numpy(y)), 5,
                      device="cpu")


def test_static_train_signatures_match_reference():
    """The fourth positional is miniBatchFraction for the linear and
    logistic statics, and the logistic static trains unregularized."""
    X, y, _ = logistic_data(400, 4, seed=16)
    t = tm.LogisticRegressionWithSGD.train((X, y), 20, 1.0, 1.0,
                                           device="cpu", schedule="off")
    j = jm.LogisticRegressionWithSGD.train((X, y), 20, 1.0, 1.0,
                                           schedule="off")
    _close_models(t, j, X)
    alg = tm.LogisticRegressionWithSGD(device="cpu")
    assert alg.optimizer.config.reg_param == 0.01


def test_run_warm_carries_weights_and_intercept():
    X, y, _ = linear_data(600, 4, intercept=0.3, seed=17)
    alg = tm.LinearRegressionWithSGD(0.5, 20, device="cpu").set_intercept(True)
    alg.set_schedule("off")
    m1 = alg.run((X, y))
    m2 = alg.run_warm((X, y), m1)
    jalg = jm.LinearRegressionWithSGD(0.5, 20).set_intercept(True)
    jalg.set_schedule("off")
    j2 = jalg.run_warm((X, y), jalg.run((X, y)))
    _close_models(m2, j2, X)


def test_labeled_points_train_like_arrays():
    X, y, _ = linear_data(200, 3, seed=18)
    pts = [tm.LabeledPoint(float(l), x) for l, x in zip(y, X)]
    a = tm.LinearRegressionWithSGD.train(pts, 10, 0.5, device="cpu")
    b = tm.LinearRegressionWithSGD.train((X, y), 10, 0.5, device="cpu")
    torch.testing.assert_close(a.weights, b.weights)
    p = tm.LabeledPoint.parse("(1.5,[2.0,3.0])")
    assert p.label == 1.5 and p.features.tolist() == [2.0, 3.0]
    assert tm.LabeledPoint.parse("0 1 2").features.tolist() == [1.0, 2.0]


@pytest.mark.parametrize("kind", ["linear", "logistic", "svm"])
def test_glm_model_from_numpy_predicts_like_jax(kind):
    r = np.random.default_rng(19)
    w = r.normal(size=7).astype(np.float32)
    X = r.normal(size=(50, 7)).astype(np.float32)
    jcls, tcls = {
        "linear": (jm.LinearRegressionModel, tm.LinearRegressionModel),
        "logistic": (jm.LogisticRegressionModel, tm.LogisticRegressionModel),
        "svm": (jm.SVMModel, tm.SVMModel),
    }[kind]
    j = jcls(w, 0.25)
    t = glm_model_from_numpy(tcls, np.asarray(j.weights), j.intercept,
                             device="cpu")
    np.testing.assert_allclose(t.predict(X).numpy(), np.asarray(j.predict(X)),
                               rtol=1e-5, atol=1e-5)


def test_sgd_config_from_dict():
    import dataclasses

    from tpu_sgd.config import SGDConfig as JConfig

    jc = JConfig(step_size=0.3, mini_batch_fraction=0.2, sampling="sliced")
    assert dataclasses.asdict(sgd_config_from_dict(dataclasses.asdict(jc))) \
        == dataclasses.asdict(jc)
    with pytest.raises(ValueError, match="no field"):
        sgd_config_from_dict({"mesh": None})


def test_later_slice_options_raise():
    X, y, _ = linear_data(50, 3, seed=20)
    alg = tm.LinearRegressionWithSGD(device="cpu")
    # feature scaling arrived with feature.py, host streaming with the
    # ingest slice, the planner with plan.py: "auto" is the default, and
    # every schedule name is accepted
    assert alg.set_feature_scaling(True) is alg
    assert alg.optimizer.set_host_streaming(True) is alg.optimizer
    assert alg.optimizer.host_streaming
    assert alg.schedule == "auto"
    assert alg.set_schedule("auto") is alg and alg.schedule == "auto"
    assert alg.set_schedule("resident_gram").schedule == "resident_gram"
    with pytest.raises(ValueError, match="schedule must be one of"):
        alg.set_schedule("warp_drive")
    from tpu_sgd_torch.parallel import DATA_AXIS, MODEL_AXIS, Mesh

    # a data mesh trains (test_torch_parallel.py), and so does a 2-D one
    # (test_torch_mesh_resident.py); host streaming on a 2-D mesh is
    # refused with the JAX package's message
    with pytest.raises(NotImplementedError, match="supports 1-D data"):
        tm.LinearRegressionWithSGD.train(
            (X, y), mesh=Mesh({DATA_AXIS: 4, MODEL_AXIS: 2}),
            host_streaming=True, device="cpu")


@pytest.mark.parametrize("model,method,item", [
    ("multinomial", "predict_dense_bucketed", "A10")])
def test_model_methods_of_later_slices_raise(model, method, item):
    """Reference methods of a later slice: each raised naming its ROADMAP
    item until the slice landed.  ``predict_dense_bucketed`` (A10, the
    serving slice) now runs, and gives ``predict``'s classes."""
    X = np.random.default_rng(0).normal(size=(4, 3)).astype(np.float32)
    if model == "linear":
        m = tm.LinearRegressionModel(np.zeros(3), 0.0, device="cpu")
    else:
        m = tm.MultinomialLogisticRegressionModel(
            np.arange(6, dtype=np.float32) - 2.5, 0.0, num_classes=3,
            device="cpu")
    assert item == "A10"
    got = getattr(m, method)(X)
    np.testing.assert_array_equal(got, m.predict(X).numpy())

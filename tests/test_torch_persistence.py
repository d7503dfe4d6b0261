"""Model persistence across the two packages: a model saved by ``tpu_sgd``
loads in ``tpu_sgd_torch`` and the reverse, with equal predictions; the
metadata is the same JSON, key for key and in the same order, and the
weights the same float32 array.  Also the multinomial interop helper.

Tolerances: weights, intercepts and thresholds exactly (they round-trip
as float32 and JSON); predicted labels and classes exactly; raw margins
at rtol 1e-5 (the two frameworks sum the matvec in other orders).
"""

import json
import os

import numpy as np
import pytest
import torch

import tpu_sgd.models as jm
import tpu_sgd_torch as tst
import tpu_sgd_torch.models as tm
from tpu_sgd_torch.utils.persistence import load_glm_model
from tpu_sgd_torch.utils.mlutils import linear_data, logistic_data

CPU = "cpu"
BINARY = ["LinearRegressionModel", "LassoModel", "RidgeRegressionModel",
          "LogisticRegressionModel", "SVMModel"]


def _weights(d=7, seed=0):
    return np.random.default_rng(seed).normal(size=d).astype(np.float32)


def _meta(path):
    with open(os.path.join(path, "metadata.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("name", BINARY)
def test_saved_by_jax_loads_in_the_port(tmp_path, name):
    X, _, _ = linear_data(50, 7, seed=1)
    j = getattr(jm, name)(_weights(), 0.25)
    if hasattr(j, "threshold"):
        j.set_threshold(0.3)
    j.save(str(tmp_path))
    t = getattr(tm, name).load(str(tmp_path), device=CPU)
    np.testing.assert_array_equal(t.weights.numpy(), np.asarray(j.weights))
    assert t.intercept == j.intercept
    assert getattr(t, "threshold", None) == getattr(j, "threshold", None)
    if hasattr(j, "threshold"):  # labels
        np.testing.assert_array_equal(t.predict(X).numpy(),
                                      np.asarray(j.predict(X)))
    else:  # margins
        np.testing.assert_allclose(t.predict(X).numpy(),
                                   np.asarray(j.predict(X)), rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.parametrize("name", BINARY)
def test_saved_by_the_port_loads_in_jax(tmp_path, name):
    X, _, _ = linear_data(50, 7, seed=2)
    t = getattr(tm, name)(_weights(seed=3), -0.5, device=CPU)
    if hasattr(t, "threshold"):
        t.clear_threshold()
    t.save(str(tmp_path))
    j = getattr(jm, name).load(str(tmp_path))
    np.testing.assert_array_equal(np.asarray(j.weights), t.weights.numpy())
    assert j.intercept == t.intercept
    assert getattr(j, "threshold", "none") == getattr(t, "threshold", "none")
    np.testing.assert_allclose(np.asarray(j.predict(X)),
                               t.predict(X).numpy(), rtol=1e-5, atol=1e-6)


def test_metadata_is_the_same_json(tmp_path):
    """Key for key, in the same order; only the per-save id differs."""
    w = _weights()
    jm.SVMModel(w, 0.125).save(str(tmp_path / "j"))
    tm.SVMModel(w, 0.125, device=CPU).save(str(tmp_path / "t"))
    mj, mt = _meta(str(tmp_path / "j")), _meta(str(tmp_path / "t"))
    assert list(mj) == list(mt)
    assert {k: v for k, v in mj.items() if k != "saveId"} == \
        {k: v for k, v in mt.items() if k != "saveId"}
    for side in ("j", "t"):
        data = np.load(str(tmp_path / side / "data.npz"))
        assert data["weights"].dtype == np.float32
        np.testing.assert_array_equal(data["weights"], w)


@pytest.mark.parametrize("intercept", [False, True])
def test_multinomial_round_trips_both_ways(tmp_path, intercept):
    K, d = 3, 5
    r = np.random.default_rng(4)
    X = r.normal(size=(300, d)).astype(np.float32)
    y = np.argmax(X @ r.normal(size=(K, d)).T, axis=1).astype(np.float32)
    t = tst.LogisticRegressionWithLBFGS.train((X, y), num_classes=K,
                                              intercept=intercept,
                                              max_num_iterations=20,
                                              device=CPU)
    t.save(str(tmp_path / "t"))
    j = jm.MultinomialLogisticRegressionModel.load(str(tmp_path / "t"))
    assert j.num_classes == K and j.has_intercept_column == intercept
    np.testing.assert_array_equal(np.asarray(j.predict(X)),
                                  t.predict(X).numpy())
    j.save(str(tmp_path / "j"))
    back = tm.MultinomialLogisticRegressionModel.load(str(tmp_path / "j"),
                                                      device=CPU)
    assert back.num_classes == K
    assert back.num_features == t.num_features
    assert back.has_intercept_column == intercept
    np.testing.assert_array_equal(back.predict(X).numpy(),
                                  t.predict(X).numpy())
    assert list(_meta(str(tmp_path / "j"))) == \
        list(_meta(str(tmp_path / "t")))


def test_multinomial_model_from_numpy_carries_a_jax_model():
    K, d = 4, 6
    r = np.random.default_rng(5)
    X = r.normal(size=(200, d)).astype(np.float32)
    w = r.normal(size=(K - 1) * (d + 1)).astype(np.float32)
    j = jm.MultinomialLogisticRegressionModel(w, 0.0, K, d + 1,
                                              has_intercept_column=True)
    t = tst.multinomial_model_from_numpy(np.asarray(j.weights),
                                         j.num_classes,
                                         j.has_intercept_column,
                                         device=CPU)
    assert t.num_features == d + 1
    np.testing.assert_array_equal(t.predict(X).numpy(),
                                  np.asarray(j.predict(X)))


def test_load_checks_class_version_and_torn_saves(tmp_path):
    path = str(tmp_path / "m")
    tm.LassoModel(_weights(), 0.0, device=CPU).save(path)
    with pytest.raises(ValueError, match="expected RidgeRegressionModel"):
        tm.RidgeRegressionModel.load(path, device=CPU)
    assert isinstance(load_glm_model(path, tm.RidgeRegressionModel,
                                     strict_class=False, device=CPU),
                      tm.RidgeRegressionModel)
    meta = _meta(path)
    meta["saveId"] = "another"
    with open(os.path.join(path, "metadata.json"), "w") as f:
        json.dump(meta, f)
    with pytest.raises(ValueError, match="torn"):
        tm.LassoModel.load(path, device=CPU)
    meta["version"] = "9.9"
    with open(os.path.join(path, "metadata.json"), "w") as f:
        json.dump(meta, f)
    with pytest.raises(ValueError, match="format version"):
        tm.LassoModel.load(path, device=CPU)


def test_trained_logistic_model_round_trips(tmp_path):
    X, y, _ = logistic_data(400, 5, seed=6)
    t = tst.LogisticRegressionWithLBFGS.train((X, y), device=CPU)
    t.save(str(tmp_path))
    j = jm.LogisticRegressionModel.load(str(tmp_path))
    np.testing.assert_array_equal(np.asarray(j.predict(X)),
                                  t.predict(X).numpy())
    loaded = tm.LogisticRegressionModel.load(str(tmp_path), device=CPU)
    assert loaded.weights.device == torch.device("cpu")
    np.testing.assert_array_equal(loaded.predict(X).numpy(),
                                  t.predict(X).numpy())

"""Parity of the port's streaming SGD (``tpu_sgd_torch/models/streaming.py``)
with the JAX package's on the CPU, both sides with ``schedule="off"`` (the
optimizer runs exactly as configured).

Tolerances: every micro-batch runs at frac 1.0, so both sides do the same
arithmetic on the same numpy batches — weights after each batch rtol 2e-4
/ atol 2e-3 (the tight tier of ``tests/test_pallas.py``), the intercept
likewise; batch counts and loss-history lengths exact.
"""

import numpy as np
import pytest
import torch

import tpu_sgd.ops.sparse as js
from tpu_sgd.models import streaming as jst
import tpu_sgd_torch as tst
from tpu_sgd_torch.ops import sparse as ts
from tpu_sgd_torch.utils.mlutils import linear_data, logistic_data


def _pair(family, **kw):
    jcls = {"linear": jst.StreamingLinearRegressionWithSGD,
            "logistic": jst.StreamingLogisticRegressionWithSGD}[family]
    tcls = {"linear": tst.StreamingLinearRegressionWithSGD,
            "logistic": tst.StreamingLogisticRegressionWithSGD}[family]
    j = jcls(**kw)
    j.algorithm.set_schedule("off")
    t = tcls(device="cpu", **kw)
    t.algorithm.set_schedule("off")
    return j, t


def _close(t, j):
    np.testing.assert_allclose(t.latest_model().weights.numpy(),
                               np.asarray(j.latest_model().weights),
                               rtol=2e-4, atol=2e-3)
    assert t.latest_model().intercept == pytest.approx(
        j.latest_model().intercept, rel=2e-4, abs=2e-3)


@pytest.mark.parametrize("family", ["linear", "logistic"])
def test_dense_batches_match_jax_after_each_batch(family):
    d = 10
    w_true = np.linspace(-1, 1, d).astype(np.float32)
    j, t = _pair(family, step_size=0.3, num_iterations=15)
    for alg in (j, t):
        alg.set_initial_weights(np.zeros(d, np.float32))
        alg.algorithm.set_intercept(True)
    gen = linear_data if family == "linear" else logistic_data
    for i in range(5):
        X, y, _ = gen(400, d, weights=w_true, seed=30 + i)
        j.train_on_batch(X, y)
        t.train_on_batch(X, y)
        _close(t, j)
    assert t._batch_count == j._batch_count == 5
    assert len(t.loss_history) == len(j.loss_history) == 5
    np.testing.assert_allclose(t.loss_history, j.loss_history, rtol=2e-4)


def test_sparse_batches_match_jax_after_each_batch():
    d = 300
    j, t = _pair("linear", step_size=0.5, num_iterations=10)
    for alg in (j, t):
        alg.set_initial_weights(np.zeros(d, np.float32))
    w_true = np.random.default_rng(40).uniform(-1, 1, d).astype(np.float32)
    for i in range(4):
        jX, jy, _ = js.sparse_data(500, d, nnz_per_row=12, weights=w_true,
                                   seed=41 + i)
        tX, ty, _ = ts.sparse_data(500, d, nnz_per_row=12, weights=w_true,
                                   seed=41 + i)
        j.train_on_batch(jX, jy)
        t.train_on_batch(tX, ty)
        _close(t, j)
    # dense and sparse batches predict alike
    np.testing.assert_allclose(
        t.latest_model().predict(tX).numpy(),
        t.latest_model().predict(tX.to_dense().numpy()).numpy(),
        rtol=1e-5, atol=1e-5)


def test_config5_stream_converges_like_jax():
    """Config 5's recipe at its size: the weight error falls from 0.325 to
    about 0.004 on both sides."""
    d = 50
    w_true = np.linspace(-1, 1, d).astype(np.float32)
    j, t = _pair("linear", step_size=0.3, num_iterations=25)
    errs = {"j": [], "t": []}
    for alg in (j, t):
        alg.set_initial_weights(np.zeros(d, np.float32))
    for i in range(10):
        X, y, _ = linear_data(2_000, d, weights=w_true, eps=0.05, seed=10 + i)
        j.train_on_batch(X, y)
        t.train_on_batch(X, y)
        errs["j"].append(np.linalg.norm(
            np.asarray(j.latest_model().weights) - w_true))
        errs["t"].append(np.linalg.norm(
            t.latest_model().weights.numpy() - w_true))
    np.testing.assert_allclose(errs["t"], errs["j"], rtol=2e-4, atol=2e-3)
    assert errs["t"][-1] < 0.05 < errs["t"][0]


def test_empty_batch_advances_the_count_and_skips_the_update():
    d = 3
    t = tst.StreamingLinearRegressionWithSGD(device="cpu")
    t.set_initial_weights(np.ones(d, np.float32))
    calls = []
    t.add_model_update_listener(lambda m, i: calls.append(i))
    before = t.latest_model().weights.clone()
    t.train_on_batch(np.zeros((0, d), np.float32), np.zeros(0, np.float32))
    empty_sparse = torch.zeros(0, d).to_sparse_csr()
    t.train_on_batch(empty_sparse, np.zeros(0, np.float32))
    assert t._batch_count == 2 and calls == []
    torch.testing.assert_close(t.latest_model().weights, before)


def test_train_on_skip_and_listeners():
    d = 4
    w_true = np.asarray([1.0, -2.0, 0.5, 3.0], np.float32)
    batches = [linear_data(300, d, weights=w_true, seed=50 + i)[:2]
               for i in range(6)]
    t = tst.StreamingLinearRegressionWithSGD(0.3, 25, device="cpu")
    t.set_initial_weights(np.zeros(d, np.float32))
    seen = []

    def listener(model, i):
        seen.append(i)

    t.add_model_update_listener(listener)
    t.train_on(iter(batches), skip=2)
    assert seen == [1, 2, 3, 4]
    t.remove_model_update_listener(listener)
    t.train_on(iter(batches[:1]))
    assert seen == [1, 2, 3, 4] and t._batch_count == 5
    with pytest.raises(TypeError, match="callable"):
        t.add_model_update_listener(3)
    # skipping the first two batches is training on the rest
    r = tst.StreamingLinearRegressionWithSGD(0.3, 25, device="cpu")
    r.algorithm.set_schedule("off")
    r.set_initial_weights(np.zeros(d, np.float32))
    for X, y in batches[2:]:
        r.train_on_batch(X, y)
    j = jst.StreamingLinearRegressionWithSGD(0.3, 25)
    j.algorithm.set_schedule("off")
    j.set_initial_weights(np.zeros(d, np.float32))
    j.train_on(iter(batches), skip=2)
    _close(r, j)


def test_predict_on_and_predict_on_values():
    d = 3
    t = tst.StreamingLinearRegressionWithSGD(device="cpu")
    with pytest.raises(RuntimeError, match="initialized"):
        t.latest_model()
    t.set_initial_weights(np.ones(d, np.float32), 0.5)
    (pred,) = list(t.predict_on(iter([np.eye(d, dtype=np.float32)])))
    np.testing.assert_allclose(pred.numpy(), np.full(d, 1.5))
    sparse = torch.eye(d).to_sparse_csr()
    out = list(t.predict_on_values([("a", np.ones((1, d), np.float32)),
                                    ("b", sparse)]))
    assert [k for k, _ in out] == ["a", "b"]
    np.testing.assert_allclose(out[0][1].numpy(), [3.5])
    np.testing.assert_allclose(out[1][1].numpy(), np.full(d, 1.5))


def test_weights_carried_in_from_jax_as_numpy():
    """A JAX streaming model's weights and intercept, carried over as numpy,
    give the port's model the same predictions."""
    X, y, _ = linear_data(500, 6, intercept=0.4, seed=60)
    j = jst.StreamingLinearRegressionWithSGD(0.3, 20)
    j.algorithm.set_schedule("off").set_intercept(True)
    j.set_initial_weights(np.zeros(6, np.float32))
    j.train_on_batch(X, y)
    jm = j.latest_model()
    t = tst.StreamingLinearRegressionWithSGD(0.3, 20, device="cpu")
    t.set_initial_weights(np.asarray(jm.weights), jm.intercept)
    np.testing.assert_allclose(t.latest_model().predict(X).numpy(),
                               np.asarray(jm.predict(X)), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("family", ["linear", "logistic"])
def test_default_device_raises_without_a_card(family):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the rule is for hosts "
                    "without one")
    cls = {"linear": tst.StreamingLinearRegressionWithSGD,
           "logistic": tst.StreamingLogisticRegressionWithSGD}[family]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cls()

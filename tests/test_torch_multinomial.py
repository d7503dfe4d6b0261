"""Parity of the port's multinomial logistic regression
(``MultinomialLogisticGradient``, ``LogisticRegressionWithLBFGS.
set_num_classes``, ``MultinomialLogisticRegressionModel``) with the JAX
package on the CPU: the single-device cases of ``tests/test_multinomial.py``,
the swept-vs-sequential and chunked-sweep cases included.

Tolerances: one evaluation and one sweep at the tight tier (grad rtol
2e-4 / atol 2e-3, loss rtol 2e-4); the predicted classes of the same
weights exactly; whole L-BFGS runs by matched objective (<= 1.01x) with
equal history lengths; swept against sequential within the port at the
JAX test's rtol 1e-5.
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_sgd.models import classification as jcls
from tpu_sgd.ops import gradients as jg
from tpu_sgd.ops.updaters import SimpleUpdater as JSimple
from tpu_sgd.ops.updaters import SquaredL2Updater as JL2
from tpu_sgd.optimize.gradient_descent import GradientDescent as JGD
from tpu_sgd.optimize.lbfgs import LBFGS as JLBFGS
import tpu_sgd_torch as tst
from tpu_sgd_torch.config import SGDConfig
from tpu_sgd_torch.ops import gradients as tg
from tpu_sgd_torch.ops import sparse as ts
from tpu_sgd_torch.ops.updaters import SimpleUpdater, SquaredL2Updater
from tpu_sgd_torch.optimize.lbfgs import LBFGS
from tpu_sgd_torch.optimize.owlqn import OWLQN

CPU = "cpu"


def _multiclass_data(n, d, K, seed=0):
    r = np.random.default_rng(seed)
    W = r.normal(size=(K, d)).astype(np.float32) * 2.0
    X = r.normal(size=(n, d)).astype(np.float32)
    logits = X @ W.T
    y = np.argmax(logits + r.gumbel(size=(n, K)), axis=1).astype(np.float32)
    return X, y, W


def _t(a):
    return torch.as_tensor(np.asarray(a))


@pytest.mark.parametrize("with_mask", [False, True])
def test_batch_sums_match_jax(with_mask):
    K, d, n = 4, 7, 600
    X, y, _ = _multiclass_data(n, d, K, seed=12)
    r = np.random.default_rng(13)
    w = r.normal(size=(K - 1) * d).astype(np.float32)
    mask = r.random(n) < 0.5 if with_mask else None
    jgrad, jl, jc = jg.MultinomialLogisticGradient(K).batch_sums(
        jnp.asarray(X), jnp.asarray(y), jnp.asarray(w),
        None if mask is None else jnp.asarray(mask))
    tgrad, tl_, tc = tg.MultinomialLogisticGradient(K).batch_sums(
        _t(X), _t(y), _t(w), None if mask is None else _t(mask))
    np.testing.assert_allclose(tgrad.numpy(), np.asarray(jgrad), rtol=2e-4,
                               atol=2e-3)
    np.testing.assert_allclose(float(tl_), float(jl), rtol=2e-4)
    assert float(tc) == float(jc)


def test_batch_sums_on_sparse_match_dense():
    K, n, d = 3, 300, 40
    X, _, _ = ts.sparse_data(n, d, nnz_per_row=6, seed=3)
    y = np.random.default_rng(4).integers(0, K, n).astype(np.float32)
    w = np.random.default_rng(5).normal(size=(K - 1) * d).astype(np.float32)
    g = tg.MultinomialLogisticGradient(K)
    sp = g.batch_sums(X, _t(y), _t(w))
    de = g.batch_sums(X.to_dense(), _t(y), _t(w))
    for a, b in zip(sp, de):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-5)
    sums, _ = g.loss_sweep(X, _t(y), _t(np.stack([w, 2 * w])))
    np.testing.assert_allclose(float(sums[0]), float(sp[1]), rtol=1e-5)


def test_loss_sweep_matches_jax_and_per_trial():
    K, d, T = 4, 7, 6
    X, y, _ = _multiclass_data(300, d, K, seed=6)
    r = np.random.default_rng(7)
    W = r.normal(size=(T, (K - 1) * d)).astype(np.float32)
    mask = (r.random(300) < 0.5)
    g = tg.MultinomialLogisticGradient(K)
    jgrad = jg.MultinomialLogisticGradient(K)
    for m in (None, mask):
        tm = None if m is None else _t(m)
        sums, count = g.loss_sweep(_t(X), _t(y), _t(W), mask=tm)
        jsums, jcount = jgrad.loss_sweep(
            jnp.asarray(X), jnp.asarray(y), jnp.asarray(W),
            mask=None if m is None else jnp.asarray(m.astype(np.float32)))
        np.testing.assert_allclose(sums.numpy(), np.asarray(jsums), rtol=2e-4)
        assert float(count) == float(jcount)
        for t in range(T):
            _, l_t, c_t = g.batch_sums(_t(X), _t(y), _t(W[t]), mask=tm)
            np.testing.assert_allclose(float(sums[t]), float(l_t), rtol=1e-5)
            assert float(count) == float(c_t)


def test_loss_sweep_row_chunks_match_unchunked(monkeypatch):
    """The port chunks the sweep over rows (the JAX package over trials):
    forcing several row chunks, with a ragged tail, leaves the sums as
    they were and as the JAX sweep's."""
    K, d, T, n = 3, 6, 7, 200
    X, y, _ = _multiclass_data(n, d, K, seed=11)
    W = np.random.default_rng(12).normal(size=(T, (K - 1) * d)).astype(
        np.float32)
    g = tg.MultinomialLogisticGradient(K)
    full, c_full = g.loss_sweep(_t(X), _t(y), _t(W))
    monkeypatch.setattr(tg, "SWEEP_BUDGET_ELEMS", 45 * T * K)
    assert len(tg.row_chunks(_t(X), T * K)) == 5
    chunked, c_chunked = g.loss_sweep(_t(X), _t(y), _t(W))
    np.testing.assert_allclose(chunked.numpy(), full.numpy(), rtol=1e-6)
    assert float(c_chunked) == float(c_full)
    jfull, _ = jg.MultinomialLogisticGradient(K).loss_sweep(
        jnp.asarray(X), jnp.asarray(y), jnp.asarray(W))
    np.testing.assert_allclose(chunked.numpy(), np.asarray(jfull), rtol=2e-4)


def test_predict_class_matches_jax_exactly():
    K, d = 5, 6
    X, _, _ = _multiclass_data(400, d, K, seed=14)
    w = np.random.default_rng(15).normal(size=(K - 1) * d).astype(np.float32)
    got = tg.MultinomialLogisticGradient(K).predict_class(_t(X), _t(w))
    ref = jg.MultinomialLogisticGradient(K).predict_class(jnp.asarray(X),
                                                          jnp.asarray(w))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    margins = np.random.default_rng(1).normal(size=(50, K - 1)).astype(
        np.float32)
    margins[:5] = 0.0  # ties with the pivot: the first maximum wins
    np.testing.assert_array_equal(
        tg.pivot_class_traced(_t(margins)).numpy(),
        tg.pivot_class_host(margins))
    np.testing.assert_array_equal(tg.pivot_class_host(margins),
                                  jg.pivot_class_host(margins))


def test_multinomial_lbfgs_accuracy_matches_jax():
    K, d = 4, 10
    X, y, W = _multiclass_data(4000, d, K, seed=0)
    model = tst.LogisticRegressionWithLBFGS.train((X, y), num_classes=K,
                                                  reg_param=0.001,
                                                  device=CPU)
    assert isinstance(model, tst.MultinomialLogisticRegressionModel)
    pred = model.predict(X).numpy()
    acc = np.mean(pred == y)
    bayes = np.mean(np.argmax(X @ W.T, axis=1) == y)
    assert acc > bayes - 0.05
    assert set(np.unique(pred)) <= set(float(k) for k in range(K))
    jalg = jcls.LogisticRegressionWithLBFGS(reg_param=0.001)
    jalg.set_num_classes(K).set_schedule("off")
    jm = jalg.run((X, y))
    jpred = np.asarray(jm.predict(X))
    assert abs(acc - np.mean(jpred == y)) <= 0.01


def test_multinomial_lbfgs_runs_match_jax():
    K, d = 3, 6
    X, y, _ = _multiclass_data(1500, d, K, seed=8)
    w0 = np.zeros(((K - 1) * d,), np.float32)
    jw, jh = JLBFGS(jg.MultinomialLogisticGradient(K), JL2(), reg_param=1e-3,
                    max_num_iterations=3).optimize_with_history((X, y), w0)
    tw, th = LBFGS(tg.MultinomialLogisticGradient(K), SquaredL2Updater(),
                   reg_param=1e-3, max_num_iterations=3,
                   device=CPU).optimize_with_history((X, y), w0)
    assert len(th) == len(jh)
    np.testing.assert_allclose(th, jh, rtol=2e-4)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=2e-4,
                               atol=2e-3)
    _, jh = JLBFGS(jg.MultinomialLogisticGradient(K), JL2(), reg_param=1e-3,
                   max_num_iterations=40).optimize_with_history((X, y), w0)
    _, th = LBFGS(tg.MultinomialLogisticGradient(K), SquaredL2Updater(),
                  reg_param=1e-3, max_num_iterations=40,
                  device=CPU).optimize_with_history((X, y), w0)
    assert len(th) == len(jh)
    assert th[-1] <= 1.01 * jh[-1]


def test_multinomial_with_intercept():
    K, d = 3, 6
    X, y, _ = _multiclass_data(2000, d, K, seed=1)
    model = tst.LogisticRegressionWithLBFGS.train((X, y), num_classes=K,
                                                  intercept=True, device=CPU)
    assert model.num_features == d + 1
    assert model.has_intercept_column
    assert model.predict(X).shape == (2000,)
    jalg = jcls.LogisticRegressionWithLBFGS()
    jalg.set_num_classes(K).set_intercept(True).set_schedule("off")
    jm = jalg.run((X, y))
    agree = np.mean(model.predict(X).numpy() == np.asarray(jm.predict(X)))
    assert agree >= 0.99
    # warm start from the trained model's own (K-1)*(d+1) weights
    again = tst.LogisticRegressionWithLBFGS(max_num_iterations=2,
                                            device=CPU)
    again.set_num_classes(K).set_intercept(True)
    warm = again.run((X, y), initial_weights=model.weights)
    assert warm.weights.shape == model.weights.shape
    with pytest.raises(ValueError, match="initial_weights has size"):
        again.run((X, y), initial_weights=np.zeros(5, np.float32))


def test_multinomial_k2_equals_binary():
    X, y, _ = _multiclass_data(1000, 5, 2, seed=2)
    m_bin = tst.LogisticRegressionWithLBFGS.train((X, y), device=CPU)
    m_k2 = tst.LogisticRegressionWithLBFGS.train((X, y), num_classes=2,
                                                 device=CPU)
    np.testing.assert_allclose(m_bin.weights.numpy(), m_k2.weights.numpy(),
                               rtol=1e-4, atol=1e-5)


def test_multinomial_label_validation():
    X = np.zeros((10, 3), np.float32)
    y = np.full((10,), 5.0, np.float32)
    with pytest.raises(ValueError, match="in \\[0, 3\\)"):
        tst.LogisticRegressionWithLBFGS.train((X, y), num_classes=3,
                                              device=CPU)
    with pytest.raises(ValueError, match="in \\[0, 3\\)"):
        tst.LogisticRegressionWithLBFGS.train(
            (torch.as_tensor(X), torch.full((10,), 1.5)), num_classes=3,
            device=CPU)


def test_single_vector_predict():
    K, d = 3, 4
    X, y, _ = _multiclass_data(500, d, K, seed=3)
    model = tst.LogisticRegressionWithLBFGS.train((X, y), num_classes=K,
                                                  device=CPU)
    assert model.predict(X[0]).shape == ()
    with pytest.raises(ValueError, match="expected 4-feature input"):
        model.predict(X[:, :3])


def test_multinomial_sgd_matches_jax():
    """The multinomial gradient under GradientDescent, full batch: the
    single-device run of the JAX test's mesh-parity case."""
    K, d = 3, 6
    X, y, _ = _multiclass_data(2000, d, K, seed=5)
    w0 = np.zeros(((K - 1) * d,), np.float32)
    kw = dict(step_size=0.5, num_iterations=30, mini_batch_fraction=1.0,
              convergence_tol=0.0)
    from tpu_sgd.config import SGDConfig as JConfig

    jw, jh = JGD(jg.MultinomialLogisticGradient(K), JSimple(),
                 JConfig(**kw)).optimize_with_history((X, y), w0)
    tw, th = tst.GradientDescent(tg.MultinomialLogisticGradient(K),
                                 SimpleUpdater(), SGDConfig(**kw),
                                 device=CPU).optimize_with_history((X, y), w0)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=2e-4,
                               atol=2e-5)
    np.testing.assert_allclose(th, jh, rtol=2e-4)


class _NoSweep:
    """A gradient with ``loss_sweep`` hidden: forces the sequential
    line-search branch."""

    def __init__(self, inner):
        self._inner = inner

    def __getattr__(self, name):
        if name == "loss_sweep":
            raise AttributeError(name)
        return getattr(self._inner, name)


def test_multinomial_lbfgs_swept_equals_sequential():
    K, d = 3, 6
    X, y, _ = _multiclass_data(1500, d, K, seed=8)
    w0 = np.zeros(((K - 1) * d,), np.float32)
    g = tg.MultinomialLogisticGradient(K)
    w_swept, h_swept = LBFGS(g, max_num_iterations=15,
                             device=CPU).optimize_with_history((X, y), w0)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        w_seq, h_seq = LBFGS(_NoSweep(tg.MultinomialLogisticGradient(K)),
                             max_num_iterations=15,
                             device=CPU).optimize_with_history((X, y), w0)
    assert not hasattr(_NoSweep(g), "loss_sweep")
    np.testing.assert_allclose(w_swept.numpy(), w_seq.numpy(), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(h_swept, h_seq, rtol=1e-5)


def test_multinomial_owlqn_swept_equals_sequential():
    K, d = 3, 5
    X, y, _ = _multiclass_data(1200, d, K, seed=9)
    w0 = np.zeros(((K - 1) * d,), np.float32)

    def run(g):
        return OWLQN(g, reg_param=0.01, max_num_iterations=20,
                     device=CPU).optimize_with_history((X, y), w0)

    w_swept, h_swept = run(tg.MultinomialLogisticGradient(K))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        w_seq, h_seq = run(_NoSweep(tg.MultinomialLogisticGradient(K)))
    assert h_swept[-1] < h_swept[0]
    np.testing.assert_allclose(w_swept.numpy(), w_seq.numpy(), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(h_swept, h_seq, rtol=1e-5)


def test_sequential_fallback_warns_once_per_optimize():
    K, d = 3, 5
    X, y, _ = _multiclass_data(400, d, K, seed=11)
    w0 = np.zeros(((K - 1) * d,), np.float32)

    def loss_sweep_warnings(opt):
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            opt.optimize_with_history((X, y), w0)
        return sum("loss_sweep" in str(r.message)
                   and "SEQUENTIAL" in str(r.message) for r in rec
                   if issubclass(r.category, RuntimeWarning))

    assert loss_sweep_warnings(LBFGS(
        _NoSweep(tg.MultinomialLogisticGradient(K)), max_num_iterations=3,
        device=CPU)) == 1
    assert loss_sweep_warnings(OWLQN(
        _NoSweep(tg.MultinomialLogisticGradient(K)), reg_param=0.01,
        max_num_iterations=3, device=CPU)) == 1
    assert loss_sweep_warnings(LBFGS(
        tg.MultinomialLogisticGradient(K), max_num_iterations=3,
        device=CPU)) == 0


def test_owlqn_multinomial_intercept_exemption_guard(rng):
    n, d, K = 256, 6, 3
    X = rng.normal(size=(n, d)).astype(np.float32)
    y = rng.integers(0, K, n).astype(np.float32)
    g = tg.MultinomialLogisticGradient(K)
    opt = OWLQN(g, reg_param=0.01, max_num_iterations=3,
                penalize_intercept=False, device=CPU)
    with pytest.raises(NotImplementedError, match="per class row"):
        opt.optimize_with_history((X, y), np.zeros(g.weight_dim(d),
                                                   np.float32))
    w, _ = OWLQN(g, reg_param=0.01, max_num_iterations=3,
                 device=CPU).optimize_with_history(
        (X, y), np.zeros(g.weight_dim(d), np.float32))
    assert bool(torch.all(torch.isfinite(w)))


def test_num_classes_below_two_raises():
    with pytest.raises(ValueError, match=">= 2"):
        tg.MultinomialLogisticGradient(1)
    with pytest.raises(ValueError, match=">= 2"):
        tst.LogisticRegressionWithLBFGS(device=CPU).set_num_classes(1)

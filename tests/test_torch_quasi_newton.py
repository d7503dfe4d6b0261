"""Parity of the port's quasi-Newton optimizers (``tpu_sgd_torch/optimize/
lbfgs.py``, ``owlqn.py``) and oracles (``oracle.py``) with the JAX package
on the CPU: the single-device cases of ``tests/test_lbfgs.py``,
``test_owlqn.py`` and ``test_oracle.py`` (configs 1-3 and the objective
helper), with the same numpy inputs made from a seed on both sides.

Tolerances (ROADMAP's three tiers):
  * exact: loss-history lengths and the count of exact zeros under OWL-QN;
  * tight (grad rtol 2e-4 / atol 2e-3, loss rtol 2e-4): one cost
    evaluation, one line-search sweep, the first three L-BFGS iterates;
  * matched objective: whole runs reach the JAX run's objective within
    1.01x.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_sgd.optimize.lbfgs as jl
import tpu_sgd.optimize.oracle as jor
import tpu_sgd.optimize.owlqn as jo
import tpu_sgd.ops.sparse as js
from tpu_sgd.models import classification as jcls
from tpu_sgd.models import regression as jreg
from tpu_sgd.ops import gradients as jg
from tpu_sgd.ops import updaters as ju
import tpu_sgd_torch as tst
import tpu_sgd_torch.optimize.lbfgs as tl
import tpu_sgd_torch.optimize.oracle as tor
import tpu_sgd_torch.optimize.owlqn as to
from tpu_sgd_torch.ops import cuda_kernels as ck
from tpu_sgd_torch.ops import gradients as tg
from tpu_sgd_torch.ops import sparse as ts
from tpu_sgd_torch.ops import updaters as tu
from tpu_sgd_torch.utils.mlutils import (
    linear_data,
    logistic_data,
    svm_data,
)

CPU = "cpu"
GRADS = {"least_squares": (jg.LeastSquaresGradient, tg.LeastSquaresGradient),
         "logistic": (jg.LogisticGradient, tg.LogisticGradient),
         "hinge": (jg.HingeGradient, tg.HingeGradient)}
UPDATERS = {"simple": (ju.SimpleUpdater, tu.SimpleUpdater),
            "l2": (ju.SquaredL2Updater, tu.SquaredL2Updater),
            "l1": (ju.L1Updater, tu.L1Updater)}


def _np(w):
    return w.numpy() if isinstance(w, torch.Tensor) else np.asarray(w)


def _tight_grad(got, ref):
    np.testing.assert_allclose(_np(got), _np(ref), rtol=2e-4, atol=2e-3)


def _tight_loss(got, ref):
    np.testing.assert_allclose(_np(got), _np(ref), rtol=2e-4)


def _data(family, n=1500, d=8, seed=3):
    if family == "least_squares":
        return linear_data(n, d, eps=0.1, seed=seed)[:2]
    if family == "logistic":
        return logistic_data(n, d, seed=seed)[:2]
    return svm_data(n, d, seed=seed)[:2]


# ---- one evaluation --------------------------------------------------------

@pytest.mark.parametrize("family", sorted(GRADS))
@pytest.mark.parametrize("updater", sorted(UPDATERS))
def test_one_cost_evaluation_matches_jax(family, updater):
    X, y = _data(family)
    w = np.random.default_rng(5).normal(size=8).astype(np.float32)
    jgr, tgr = GRADS[family]
    ju_, tu_ = UPDATERS[updater]
    jf, jgv = jl._build_cost(jgr(), *jl._reg_terms(ju_(), 0.05), None,
                             False)(w, X, y)
    tcost = tl._build_cost(tgr(), *tl._reg_terms(tu_(), 0.05),
                           torch.as_tensor(X), torch.as_tensor(y))
    tf, tgv = tcost(torch.as_tensor(w))
    _tight_loss(tf, jf)
    _tight_grad(tgv, jgv)


@pytest.mark.parametrize("family", sorted(GRADS))
def test_one_sweep_matches_jax(family):
    X, y = _data(family)
    W = np.random.default_rng(6).normal(size=(25, 8)).astype(np.float32)
    jgr, tgr = GRADS[family]
    jvals = jl._build_loss_sweep(jgr(), jl._reg_terms(ju.SquaredL2Updater(),
                                                      0.1)[0],
                                 None, False)(W, X, y)
    tvals = tl._build_loss_sweep(tgr(), tl._reg_terms(tu.SquaredL2Updater(),
                                                      0.1)[0],
                                 torch.as_tensor(X), torch.as_tensor(y))(
        torch.as_tensor(W))
    _tight_loss(tvals, jvals)


@pytest.mark.parametrize("with_mask", [False, True])
def test_loss_sweep_equals_per_trial_batch_sums(with_mask):
    """The sweep's per-trial sums are the batch sums of each trial."""
    X, y = _data("logistic", n=700)
    r = np.random.default_rng(9)
    W = torch.as_tensor(r.normal(size=(6, 8)).astype(np.float32))
    mask = torch.as_tensor(r.random(700) < 0.5) if with_mask else None
    Xt, yt = torch.as_tensor(X), torch.as_tensor(y)
    g = tg.LogisticGradient()
    sums, count = g.loss_sweep(Xt, yt, W, mask=mask)
    for t in range(6):
        _, l_t, c_t = g.batch_sums(Xt, yt, W[t], mask)
        np.testing.assert_allclose(float(sums[t]), float(l_t), rtol=1e-5)
        assert float(count) == float(c_t)


def test_sweep_row_chunks_do_not_change_the_sums(monkeypatch):
    """Forcing many row chunks (a small budget, a ragged tail) gives the
    single-chunk sums up to summation order."""
    X, y = _data("hinge", n=1001)
    W = torch.as_tensor(np.random.default_rng(2).normal(
        size=(7, 8)).astype(np.float32))
    Xt, yt = torch.as_tensor(X), torch.as_tensor(y)
    full, c_full = tg.HingeGradient().loss_sweep(Xt, yt, W)
    monkeypatch.setattr(tg, "SWEEP_BUDGET_ELEMS", 100 * 7)
    assert len(tg.row_chunks(Xt, 7)) == 11
    chunked, c_chunked = tg.HingeGradient().loss_sweep(Xt, yt, W)
    np.testing.assert_allclose(chunked.numpy(), full.numpy(), rtol=1e-6)
    assert float(c_chunked) == float(c_full)


# ---- L-BFGS runs -----------------------------------------------------------

@pytest.mark.parametrize("family,updater", [
    ("least_squares", "simple"), ("logistic", "l2"), ("hinge", "l2"),
    ("logistic", "l1")])
def test_first_three_iterates_match_jax(family, updater):
    X, y = _data(family, seed=4)
    jgr, tgr = GRADS[family]
    ju_, tu_ = UPDATERS[updater]
    w0 = np.zeros(8, np.float32)
    jw, jh = jl.LBFGS(jgr(), ju_(), reg_param=0.01,
                      max_num_iterations=3).optimize_with_history((X, y), w0)
    tw, th = tl.LBFGS(tgr(), tu_(), reg_param=0.01, max_num_iterations=3,
                      device=CPU).optimize_with_history((X, y), w0)
    assert len(th) == len(jh)
    _tight_loss(th, jh)
    _tight_grad(tw, jw)


def test_lbfgs_solves_least_squares_exactly():
    X, y, w_true = linear_data(2000, 10, eps=0.0, seed=0)
    opt = tl.LBFGS(tg.LeastSquaresGradient(), tu.SimpleUpdater(),
                   max_num_iterations=100, device=CPU)
    w, hist = opt.optimize_with_history((X, y), np.zeros(10, np.float32))
    np.testing.assert_allclose(w.numpy(), w_true, atol=1e-3)
    assert hist[-1] < 1e-6
    _, jh = jl.LBFGS(jg.LeastSquaresGradient(), ju.SimpleUpdater(),
                     max_num_iterations=100).optimize_with_history(
        (X, y), np.zeros(10, np.float32))
    assert len(hist) == len(jh) < 60


@pytest.mark.parametrize("family", ["logistic", "hinge"])
def test_whole_lbfgs_runs_reach_jax_objective(family):
    X, y = _data(family, n=2000, seed=1)
    jgr, tgr = GRADS[family]
    w0 = np.zeros(8, np.float32)
    _, jh = jl.LBFGS(jgr(), ju.SquaredL2Updater(), reg_param=0.01,
                     max_num_iterations=50).optimize_with_history((X, y), w0)
    _, th = tl.LBFGS(tgr(), tu.SquaredL2Updater(), reg_param=0.01,
                     max_num_iterations=50, device=CPU
                     ).optimize_with_history((X, y), w0)
    assert th[-1] <= 1.01 * jh[-1]
    if family == "logistic":
        # smooth: the same stop iteration; the hinge's kinks let a
        # rounding difference move the relative-improvement stop
        assert len(th) == len(jh)


def test_lbfgs_beats_sgd_and_loss_is_monotone():
    X, y, _ = logistic_data(2000, 8, seed=1)
    w0 = np.zeros(8, np.float32)
    _, h_lb = tl.LBFGS(tg.LogisticGradient(), tu.SquaredL2Updater(),
                       reg_param=0.01, max_num_iterations=50,
                       device=CPU).optimize_with_history((X, y), w0)
    sgd = tst.GradientDescent(tg.LogisticGradient(), tu.SquaredL2Updater(),
                              device=CPU)
    sgd.set_reg_param(0.01).set_num_iterations(50).set_convergence_tol(0.0)
    _, h_sgd = sgd.optimize_with_history((X, y), w0)
    assert h_lb[-1] <= h_sgd[-1] + 1e-4
    assert np.all(np.diff(h_lb) <= 1e-6)


def test_lbfgs_l2_reg_shrinks_weights():
    X, y, _ = logistic_data(1000, 6, seed=2)
    w0 = np.zeros(6, np.float32)

    def norm(reg):
        return float(torch.linalg.vector_norm(tl.LBFGS(
            tg.LogisticGradient(), tu.SquaredL2Updater(), reg_param=reg,
            device=CPU).optimize((X, y), w0)))

    assert norm(1.0) < norm(0.0)


def test_lbfgs_empty_input():
    w0 = np.ones(3, np.float32)
    w, hist = tl.LBFGS(device=CPU).optimize_with_history(
        (np.zeros((0, 3), np.float32), np.zeros((0,), np.float32)), w0)
    np.testing.assert_array_equal(w.numpy(), w0)
    assert len(hist) == 0


def test_run_lbfgs_signature_parity():
    X, y, _ = logistic_data(2000, 6, seed=11)
    args = ((X, y), None, None, 10, 1e-6, 50, 0.01, np.zeros(6, np.float32))
    w, hist = tl.run_lbfgs(args[0], tg.LogisticGradient(),
                           tu.SquaredL2Updater(), *args[3:], device=CPU)
    assert hist[-1] < hist[0]
    w2, _ = tl.LBFGS(tg.LogisticGradient(), tu.SquaredL2Updater(),
                     reg_param=0.01, device=CPU).optimize_with_history(
        (X, y), np.zeros(6, np.float32))
    np.testing.assert_allclose(w.numpy(), w2.numpy(), rtol=1e-6)
    jw, jh = jl.run_lbfgs(args[0], jg.LogisticGradient(),
                          ju.SquaredL2Updater(), *args[3:])
    assert len(hist) == len(jh)
    assert hist[-1] <= 1.01 * jh[-1]


def test_push_correction_keeps_the_ring_order():
    """Once the history is full, the oldest pair leaves and the newest
    lands last, as ``jnp.roll`` places them."""
    m, d = 3, 2
    s = torch.zeros((m, d))
    yv = torch.zeros((m, d))
    rho = torch.zeros((m,))
    k = 0
    js_, jy, jrho, jk = (np.zeros((m, d), np.float32),) * 2 + (
        np.zeros((m,), np.float32), 0)
    for i in range(5):
        pair = torch.full((d,), float(i + 1))
        s, yv, rho, k = tl._push_correction(s, yv, rho, k, m, pair,
                                            2 * pair, 4.0 * (i + 1))
        js_, jy, jrho, jk = jl._push_correction(
            jnp.asarray(js_), jnp.asarray(jy), jnp.asarray(jrho), jk, m,
            jnp.asarray(pair.numpy()), jnp.asarray(2 * pair.numpy()),
            4.0 * (i + 1))
    assert k == jk == m
    np.testing.assert_array_equal(s.numpy(), np.asarray(js_))
    np.testing.assert_array_equal(rho.numpy(), np.asarray(jrho))
    g = torch.tensor([1.0, -2.0])
    np.testing.assert_allclose(
        tl._two_loop(g, s, yv, rho, k).numpy(),
        np.asarray(jl._two_loop(jnp.asarray(g.numpy()), js_, jy, jrho,
                                jnp.asarray(jk))), rtol=1e-6)


def test_lbfgs_on_sparse_matches_jax():
    """Sparse X (CSR, its transpose built once per optimize) against the
    JAX package's BCOO run."""
    n, d = 800, 300
    jX, _, _ = js.sparse_data(n, d, nnz_per_row=12, seed=21, kind="logistic")
    tX, y, _ = ts.sparse_data(n, d, nnz_per_row=12, seed=21, kind="logistic")
    w0 = np.zeros(d, np.float32)
    jw, jh = jl.LBFGS(jg.LogisticGradient(), ju.SquaredL2Updater(),
                      reg_param=0.01, max_num_iterations=3
                      ).optimize_with_history((jX, y), w0)
    tw, th = tl.LBFGS(tg.LogisticGradient(), tu.SquaredL2Updater(),
                      reg_param=0.01, max_num_iterations=3, device=CPU
                      ).optimize_with_history((tX, y), w0)
    assert len(th) == len(jh)
    _tight_loss(th, jh)
    _tight_grad(tw, jw)


def test_cpu_quasi_newton_launches_no_kernel():
    ck.reset_launch_counts()
    X, y = _data("logistic")
    tl.LBFGS(tg.LogisticGradient(), max_num_iterations=3,
             device=CPU).optimize((X, y), np.zeros(8, np.float32))
    to.OWLQN(tg.LogisticGradient(), reg_param=0.01, max_num_iterations=3,
             device=CPU).optimize((X, y), np.zeros(8, np.float32))
    assert all(v == 0 for v in ck.launch_counts().values())


def test_logistic_regression_with_lbfgs_matches_jax():
    X, y, w_true = logistic_data(3000, 8, seed=4)
    jalg = jcls.LogisticRegressionWithLBFGS(reg_param=0.001)
    jalg.set_intercept(True).set_schedule("off")
    jm = jalg.run((X, y))
    tm = tst.LogisticRegressionWithLBFGS.train((X, y), reg_param=0.001,
                                               intercept=True, device=CPU)
    assert isinstance(tm, tst.LogisticRegressionModel)
    acc = float(np.mean(tm.predict(X).numpy() == y))
    bayes = float(np.mean((X @ w_true > 0).astype(np.float32) == y))
    assert acc > bayes - 0.02
    np.testing.assert_allclose(tm.weights.numpy(), np.asarray(jm.weights),
                               rtol=2e-3, atol=2e-3)
    assert tm.intercept == pytest.approx(jm.intercept, abs=2e-3)


# ---- OWL-QN ----------------------------------------------------------------

def _lasso_objective(X, y, w, reg):
    r = X @ w - y
    return 0.5 * np.mean(r * r) + reg * np.sum(np.abs(w))


def test_owlqn_reg_zero_matches_lbfgs():
    X, y, _ = linear_data(1500, 8, eps=0.1, seed=0)
    w0 = np.zeros(8, np.float32)
    w_owl = to.OWLQN(reg_param=0.0, device=CPU).optimize((X, y), w0)
    w_lb = tl.LBFGS(device=CPU).optimize((X, y), w0)
    np.testing.assert_allclose(w_owl.numpy(), w_lb.numpy(), rtol=1e-3,
                               atol=1e-4)


def test_lasso_owlqn_matches_jax_zeros_and_objective():
    """Exact zeros counted exactly, the objective within 1.01x, and OWL-QN
    below the subgradient L-BFGS path."""
    rng = np.random.default_rng(1)
    d, n, reg = 30, 4000, 0.05
    w_true = np.zeros(d, np.float32)
    w_true[:5] = rng.uniform(1, 2, 5)
    X = rng.normal(size=(n, d)).astype(np.float32)
    y = (X @ w_true + 0.05 * rng.normal(size=n)).astype(np.float32)
    w0 = np.zeros(d, np.float32)
    tw, th = to.OWLQN(reg_param=reg, max_num_iterations=200,
                      device=CPU).optimize_with_history((X, y), w0)
    jw, jh = jo.OWLQN(reg_param=reg,
                      max_num_iterations=200).optimize_with_history((X, y),
                                                                    w0)
    tw, jw = tw.numpy(), np.asarray(jw)
    assert int(np.sum(tw == 0.0)) == int(np.sum(jw == 0.0)) >= 20
    assert len(th) == len(jh)
    f_t = _lasso_objective(X, y, tw, reg)
    assert f_t <= 1.01 * _lasso_objective(X, y, jw, reg)
    w_sub = tl.LBFGS(updater=tu.L1Updater(), reg_param=reg,
                     max_num_iterations=200, device=CPU).optimize((X, y), w0)
    assert f_t <= _lasso_objective(X, y, w_sub.numpy(), reg) + 1e-4
    assert np.all(np.abs(tw[:5]) > 0.5)


def test_owlqn_first_iterates_match_jax():
    X, y, _ = linear_data(2000, 10, eps=0.1, seed=3)
    w0 = np.zeros(10, np.float32)
    jw, jh = jo.OWLQN(reg_param=0.01,
                      max_num_iterations=3).optimize_with_history((X, y), w0)
    tw, th = to.OWLQN(reg_param=0.01, max_num_iterations=3,
                      device=CPU).optimize_with_history((X, y), w0)
    assert len(th) == len(jh)
    _tight_loss(th, jh)
    _tight_grad(tw, jw)
    _, h = to.OWLQN(reg_param=0.01, device=CPU).optimize_with_history(
        (X, y), w0)
    assert len(h) >= 2 and np.all(np.diff(h) <= 1e-6)


def test_owlqn_logistic_l1():
    rng = np.random.default_rng(4)
    w_true = rng.normal(size=12).astype(np.float32)
    X = rng.normal(size=(3000, 12)).astype(np.float32)
    y = (X @ w_true > 0).astype(np.float32)
    w = to.OWLQN(tg.LogisticGradient(), reg_param=0.001,
                 max_num_iterations=150, device=CPU).optimize(
        (X, y), np.zeros(12, np.float32)).numpy()
    acc = np.mean((1 / (1 + np.exp(-(X @ w))) > 0.5) == (y > 0.5))
    assert acc > 0.95


def test_owlqn_empty_input():
    _, h = to.OWLQN(device=CPU).optimize_with_history(
        (np.zeros((0, 4), np.float32), np.zeros((0,), np.float32)),
        np.zeros(4, np.float32))
    assert h.shape == (0,)


def test_lasso_with_owlqn_model_matches_jax():
    rng = np.random.default_rng(7)
    w_true = np.zeros(15, np.float32)
    w_true[:3] = 2.0
    X = rng.normal(size=(3000, 15)).astype(np.float32)
    y = (X @ w_true + 1.0 + 0.05 * rng.normal(size=3000)).astype(np.float32)
    model = tst.LassoWithOWLQN.train((X, y), reg_param=0.02, intercept=True,
                                     device=CPU)
    assert isinstance(model, tst.LassoModel)
    assert abs(model.intercept - 1.0) < 0.2
    w = model.weights.numpy()
    assert np.sum(w[3:] == 0.0) >= 8
    np.testing.assert_allclose(w[:3], 2.0, atol=0.2)
    jalg = jreg.LassoWithOWLQN(0.02)
    jalg.set_intercept(True).set_schedule("off")
    jm = jalg.run((X, y))
    assert int(np.sum(w == 0.0)) == int(np.sum(np.asarray(jm.weights) == 0))
    assert model.intercept == pytest.approx(jm.intercept, abs=1e-3)


def test_sparse_owlqn_hinge_matches_jax():
    """Config 3's OWL-QN reference point on sparse features."""
    n, d = 1000, 400
    jX, _, _ = js.sparse_data(n, d, nnz_per_row=15, seed=31, kind="svm")
    tX, y, _ = ts.sparse_data(n, d, nnz_per_row=15, seed=31, kind="svm")
    w0 = np.zeros(d, np.float32)
    jw, jh = jo.OWLQN(jg.HingeGradient(), reg_param=1e-3,
                      max_num_iterations=3).optimize_with_history((jX, y), w0)
    tw, th = to.OWLQN(tg.HingeGradient(), reg_param=1e-3,
                      max_num_iterations=3, device=CPU
                      ).optimize_with_history((tX, y), w0)
    assert len(th) == len(jh)
    _tight_loss(th, jh)
    _tight_grad(tw, jw)
    assert int((tw == 0).sum()) == int(np.sum(np.asarray(jw) == 0))


def test_sparse_owlqn_hinge_l1_from_zero_stalls_as_jax():
    """OWL-QN on hinge + L1 from w = 0 on RCV1-shaped rows (chip_smoke
    leg (d)'s problem, small): while every margin stays inside the hinge
    the gradient does not change, so each curvature pair has s·y = 0 and
    both packages take the same steepest-descent step every iteration:
    the objective falls by a constant amount and ends far above a
    full-batch SGD run's (phase ``sparse``'s step, 60 iterations)."""
    from tpu_sgd.utils.mlutils import rcv1_like_data as j_rcv1
    from tpu_sgd_torch.utils.mlutils import rcv1_like_data as t_rcv1

    n, d, reg = 1000, 2000, 1e-5
    jX, y = j_rcv1(n, d, seed=3)[:2]
    tX, ty = t_rcv1(n, d, seed=3)[:2]
    np.testing.assert_array_equal(np.asarray(y), np.asarray(ty))
    y = np.asarray(y)
    w0 = np.zeros(d, np.float32)
    jw, jh = jo.OWLQN(jg.HingeGradient(), reg_param=reg,
                      max_num_iterations=20).optimize_with_history((jX, y),
                                                                   w0)
    tw, th = to.OWLQN(tg.HingeGradient(), reg_param=reg,
                      max_num_iterations=20, device=CPU
                      ).optimize_with_history((tX, y), w0)
    jh, th = np.asarray(jh, np.float64), np.asarray(th, np.float64)
    assert len(th) == len(jh) == 21
    np.testing.assert_allclose(th, jh, rtol=1e-4)
    sgd = tst.GradientDescent(tg.HingeGradient(), tu.L1Updater(),
                              device=CPU)
    sgd.set_step_size(100.0).set_num_iterations(60).set_reg_param(reg) \
        .set_convergence_tol(0.0)
    w_sgd = sgd.optimize((tX, y), torch.zeros(d))
    L_sgd = tor.full_objective(tg.HingeGradient(), tX, y, w_sgd, reg, "l1")
    for h, w, obj in ((jh, jw, lambda w: jor.full_objective(
                          jg.HingeGradient(), jX, y, w, reg, "l1")),
                      (th, tw, lambda w: tor.full_objective(
                          tg.HingeGradient(), tX, y, w, reg, "l1"))):
        steps = np.diff(h)
        assert np.all(steps < 0)
        np.testing.assert_allclose(steps, steps[0], rtol=1e-3)
        assert h[-1] > 0.9 * h[0]
        assert obj(w) > 5 * L_sgd


# ---- oracles (tests/test_oracle.py, configs 1-3) ---------------------------

def test_config1_matches_normal_equations_oracle():
    X, y, _ = linear_data(20_000, 60, eps=0.1, seed=0)
    w_star = tor.least_squares_oracle(X, y, device=CPU)
    np.testing.assert_allclose(
        w_star.numpy(), np.asarray(jor.least_squares_oracle(X, y)),
        rtol=2e-4, atol=2e-4)
    model = tst.LinearRegressionWithSGD.train((X, y), 100, 1.0, device=CPU)
    gap, L, L_star = tor.objective_gap(tg.LeastSquaresGradient(), X, y,
                                       model.weights, w_star, device=CPU)
    assert gap < 0.01, f"gap {gap:.4f} (L={L:.6f} L*={L_star:.6f})"


def test_config2_matches_lbfgs_oracle():
    X, y, _ = logistic_data(10_000, 60, seed=1)
    reg = 0.01
    w_star = tor.logistic_l2_oracle(X, y, reg, device=CPU)
    j_star = jor.logistic_l2_oracle(X, y, reg)
    L_t = tor.full_objective(tg.LogisticGradient(), X, y, w_star, reg, "l2",
                             device=CPU)
    L_j = jor.full_objective(jg.LogisticGradient(), X, y, j_star, reg, "l2")
    assert L_t <= 1.01 * L_j
    alg = tst.LogisticRegressionWithSGD(2.0, 500, reg, 1.0, device=CPU)
    alg.optimizer.set_convergence_tol(0.0)
    model = alg.run((X, y))
    gap, L, L_star = tor.objective_gap(tg.LogisticGradient(), X, y,
                                       model.weights, w_star, reg, "l2",
                                       device=CPU)
    assert gap < 0.01, f"gap {gap:.4f} (L={L:.6f} L*={L_star:.6f})"


def test_config3_tracks_owlqn_oracle():
    X, y, _ = svm_data(10_000, 50, seed=2)
    reg = 1e-4
    w_star = tor.hinge_l1_oracle(X, y, reg, max_iterations=200, device=CPU)
    j_star = jor.hinge_l1_oracle(X, y, reg, max_iterations=200)
    L_t = tor.full_objective(tg.HingeGradient(), X, y, w_star, reg, "l1",
                             device=CPU)
    L_j = jor.full_objective(jg.HingeGradient(), X, y, j_star, reg, "l1")
    assert L_t <= 1.01 * L_j
    alg = tst.SVMWithSGD(10.0, 3000, reg, 1.0, device=CPU)
    alg.optimizer.set_updater(tu.L1Updater()).set_convergence_tol(0.0)
    model = alg.run((X, y))
    gap, L, L_star = tor.objective_gap(tg.HingeGradient(), X, y,
                                       model.weights, w_star, reg, "l1",
                                       device=CPU)
    assert gap < 0.20, f"gap {gap:.4f} (L={L:.6f} L*={L_star:.6f})"
    acc_sgd = float(np.mean(model.predict(X).numpy() == y))
    acc_star = float(np.mean(
        tst.SVMModel(w_star, 0.0).predict(X).numpy() == y))
    assert acc_sgd > acc_star - 0.01, (acc_sgd, acc_star)


def test_oracle_objective_helper_closed_form():
    rng = np.random.default_rng(0)
    X = rng.normal(size=(50, 4)).astype(np.float32)
    w = rng.normal(size=(4,)).astype(np.float32)
    y = rng.normal(size=(50,)).astype(np.float32)
    expect = float(np.mean(0.5 * (X @ w - y) ** 2)) + 0.5 * 0.1 * float(
        np.sum(w**2))
    got = tor.full_objective(tg.LeastSquaresGradient(), X, y, w, 0.1, "l2",
                             device=CPU)
    np.testing.assert_allclose(got, expect, rtol=1e-5)
    np.testing.assert_allclose(
        got, jor.full_objective(jg.LeastSquaresGradient(), X, y, w, 0.1,
                                "l2"), rtol=2e-4)
    with pytest.raises(ValueError, match="unknown reg kind"):
        tor.full_objective(tg.LeastSquaresGradient(), X, y, w, 0.1,
                           "elastic", device=CPU)


# ---- the schedules of host rows; the mesh takes a data mesh only -------------

def _runs_on_host_rows(opt):
    X, y = _data("least_squares", n=400, d=5)
    _, hist = opt.optimize_with_history((X, y), np.zeros(5, np.float32))
    assert len(hist) > 1 and hist[-1] < hist[0]


def _mesh_raises(opt):
    """``set_mesh`` takes a data mesh (its runs:
    ``tests/test_torch_mesh_qn.py``) and raises for a non-Mesh and, with
    the JAX package's message, for a 2-D mesh."""
    from tpu_sgd_torch.parallel import DATA_AXIS, MODEL_AXIS, Mesh

    with pytest.raises(TypeError, match="Mesh"):
        opt.set_mesh(object())
    with pytest.raises(ValueError, match="data-only mesh"):
        opt.set_mesh(Mesh({DATA_AXIS: 4, MODEL_AXIS: 2}))
    mesh = Mesh({DATA_AXIS: 2})
    assert opt.set_mesh(mesh).mesh is mesh


def _streamed_stats_runs(opt):
    assert opt.set_streamed_stats(True, block_rows=64) is opt
    _runs_on_host_rows(opt)


def _host_streaming_runs(opt):
    assert opt.set_host_streaming(True, batch_rows=128) is opt
    _runs_on_host_rows(opt)


def _ingest_options(opt):
    """The wire knobs apply, the compressed merge of meshed totals too
    (its runs: ``tests/test_torch_mesh_streamed.py``)."""
    assert opt.set_ingest_options(wire_dtype="bfloat16") is opt
    assert opt.set_ingest_options(wire_compress="topk:0.1") is opt
    assert opt.ingest_wire_compress == "topk:0.1"
    assert opt.set_ingest_options(wire_compress=False) \
        .ingest_wire_compress is None


@pytest.mark.parametrize("case", [
    pytest.param(_mesh_raises, id="set_mesh-A5"),
    pytest.param(_streamed_stats_runs, id="set_streamed_stats-A9"),
    pytest.param(_host_streaming_runs, id="set_host_streaming-A9"),
    pytest.param(_ingest_options, id="set_ingest_options-A9")])
@pytest.mark.parametrize("cls", [tl.LBFGS, to.OWLQN])
def test_schedules_of_later_slices_raise(cls, case):
    """``set_mesh`` takes only a data mesh; the schedules of ROADMAP A9's
    second half return the optimizer and run (their parity:
    ``tests/test_torch_streamed_costfun.py``, ``test_torch_streamed_gram
    .py``)."""
    case(cls(device=CPU))


def test_owlqn_has_no_updater_axis():
    with pytest.raises(AttributeError, match="no Updater axis"):
        to.OWLQN(device=CPU).set_updater(tu.L1Updater())

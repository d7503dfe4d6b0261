"""Parity of the port's sufficient-statistics path (``tpu_sgd_torch/ops/
gram.py``, ``optimize/gram_driver.py`` and the optimizers' statistics
setters) with the JAX package on the CPU: the single-device twins of
``tests/test_gram.py``, with the same numpy inputs on both sides.  Sliced
runs get the JAX package's window starts injected into the port, so both
packages sum the same windows.

Tolerances are the JAX file's: window sums against the stock exact path
grad rtol 2e-4 / atol 2e-3 (2e-2 for windows under 64 rows, whose result
carries the whole prefix's rounding), loss rtol 1e-3; trajectories rtol
5e-4 / atol 5e-4; the chunked driver against the per-iteration aligned
driver rtol 1e-5 / atol 1e-6.

The streamed builds, their checkpoints and ``set_streamed_stats`` are
twinned in ``tests/test_torch_streamed_gram.py``, their mesh cases in
``tests/test_torch_mesh_streamed.py``, the planner's ownership of the
gram knobs in ``tests/test_torch_plan.py``.  Not twinned: the listener /
checkpoint cases.
"""

import json
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_sgd as jt
from tpu_sgd.ops import gradients as jg
from tpu_sgd.ops import gram as jgram
from tpu_sgd.optimize import lbfgs as jl
import tpu_sgd_torch as tst
from tpu_sgd_torch.config import SGDConfig
from tpu_sgd_torch.ops import gram as tgram
from tpu_sgd_torch.optimize import gradient_descent as tgd
from tpu_sgd_torch.optimize import gram_driver

CPU = "cpu"
TGram = tgram.GramLeastSquaresGradient
JGram = jgram.GramLeastSquaresGradient


def _data(rng, n=1000, d=16, noise=0.1):
    X = rng.normal(size=(n, d)).astype(np.float32)
    w = rng.uniform(-1, 1, size=(d,)).astype(np.float32)
    y = (X @ w + noise * rng.normal(size=(n,))).astype(np.float32)
    return X, y, w


def _t(*arrays):
    return [torch.as_tensor(a) for a in arrays]


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _jstock_window(X, y, w, start, m):
    return jg.LeastSquaresGradient().window_sums(
        jnp.asarray(X), jnp.asarray(y), jnp.asarray(w), jnp.int32(start), m)


def _build(X, y, **kw):
    return TGram.build(X, y, device=CPU, **kw)


def jax_window_starts(seed, n, m, iterations):
    """The JAX package's sliced window starts of iterations ``1..N`` on one
    device (``fold_in(PRNGKey(seed), i)``, then ``randint``)."""
    key = jax.random.PRNGKey(seed)
    return [int(jax.random.randint(jax.random.fold_in(key, i), (), 0,
                                   max(1, n - m + 1)))
            for i in range(1, iterations + 1)]


def inject_starts(monkeypatch, starts):
    """The port draws ``starts`` in order, one per iteration (the
    per-iteration and the chunked driver alike)."""
    it = iter(starts)
    monkeypatch.setattr(
        tgd, "_window_start",
        lambda gen, n, m, device: torch.tensor([next(it)], device=device))


def _sgd(gradient, updater=None, **cfg):
    """A port ``GradientDescent`` on the CPU with fluent config."""
    opt = tst.GradientDescent(gradient, updater or tst.SimpleUpdater(),
                              device=CPU)
    for k, v in cfg.items():
        getattr(opt, "set_" + k)(v)
    return opt


def _jsgd(gradient, updater=None, **cfg):
    opt = jt.GradientDescent(gradient, updater or jt.SimpleUpdater())
    for k, v in cfg.items():
        getattr(opt, "set_" + k)(v)
    return opt


def _close(got, ref, rtol=5e-4, atol=5e-4):
    np.testing.assert_allclose(_np(got), _np(ref), rtol=rtol, atol=atol)


# ---- window, batch and sweep sums -----------------------------------------

@pytest.mark.parametrize("block", [64, 100, 1000, 2048])
@pytest.mark.parametrize("start,m", [(0, 100), (37, 200), (123, 64),
                                     (900, 100), (999, 1), (0, 1000)])
def test_window_sums_parity(rng, block, start, m):
    # n=1000 is NOT a multiple of 64 or 2048: the edge slice backs off
    X, y, w = _data(rng)
    g0, l0, c0 = _jstock_window(X, y, w, start, m)
    gram = _build(X, y, block_rows=block)
    Xt, yt, wt = gram.data.X, torch.as_tensor(y), torch.as_tensor(w)
    g1, l1, c1 = gram.window_sums(Xt, yt, wt, torch.tensor([start]), m)
    atol = 2e-3 if m >= 64 else 2e-2
    _close(g1, g0, rtol=2e-4, atol=atol)
    assert float(l1) == pytest.approx(float(l0), rel=1e-3, abs=atol)
    assert float(c1) == float(c0) == min(m, 1000)


def test_window_start_clamp_matches_stock(rng):
    X, y, w = _data(rng, n=500)
    g0, l0, _ = _jstock_window(X, y, w, 490, 100)
    gram = _build(X, y, block_rows=128)
    g1, l1, _ = gram.window_sums(gram.data.X, *_t(y, w), 490, 100)
    _close(g1, g0, rtol=2e-4, atol=2e-3)
    assert float(l1) == pytest.approx(float(l0), rel=1e-3, abs=2e-3)


def test_batch_sums_and_loss_sweep_parity(rng):
    X, y, w = _data(rng)
    base = jg.LeastSquaresGradient()
    g0, l0, c0 = base.batch_sums(jnp.asarray(X), jnp.asarray(y),
                                 jnp.asarray(w))
    gram = _build(X, y, block_rows=100)
    Xt, (yt, wt) = gram.data.X, _t(y, w)
    g1, l1, c1 = gram.batch_sums(Xt, yt, wt)
    _close(g1, g0, rtol=2e-4, atol=2e-3)
    assert float(l1) == pytest.approx(float(l0), rel=2e-4)
    assert float(c1) == float(c0)

    W = np.stack([w, 0.5 * w, np.zeros_like(w)])
    s0, n0 = base.loss_sweep(jnp.asarray(X), jnp.asarray(y), jnp.asarray(W))
    s1, n1 = gram.loss_sweep(Xt, yt, torch.as_tensor(W))
    _close(s1, s0, rtol=2e-4, atol=2e-3)
    assert float(n1) == float(n0)


def test_masked_paths_delegate_exactly(rng):
    X, y, w = _data(rng, n=300)
    gram = _build(X, y, block_rows=64)
    Xt, (yt, wt) = gram.data.X, _t(y, w)
    base = tst.LeastSquaresGradient()
    mask = torch.as_tensor(np.arange(300) % 2 == 0)
    # delegation is the SAME code path: bitwise equal
    for a, b in zip(gram.batch_sums(Xt, yt, wt, mask),
                    base.batch_sums(Xt, yt, wt, mask)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    valid = torch.ones(300, dtype=torch.bool)
    for a, b in zip(gram.window_sums(Xt, yt, wt, 10, 50, valid=valid),
                    base.window_sums(Xt, yt, wt, 10, 50, valid=valid)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    # and the JAX package's masked sums, at the tight tier
    jm = jg.LeastSquaresGradient().batch_sums(
        jnp.asarray(X), jnp.asarray(y), jnp.asarray(w),
        jnp.asarray((np.arange(300) % 2 == 0).astype(np.float32)))
    _close(gram.batch_sums(Xt, yt, wt, mask)[0], jm[0], rtol=2e-4, atol=2e-3)


def test_unbound_matrix_falls_back_with_warning(rng):
    X, y, w = _data(rng, n=200)
    gram = _build(X, y, block_rows=64)
    X2, y2, _ = _data(rng, n=150)
    X2t, y2t, wt = _t(X2, y2, w)
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        g1, _, _ = gram.window_sums(X2t, y2t, wt, 0, 50)
        gram.window_sums(X2t, y2t, wt, 0, 50)  # warns only once
    assert sum(issubclass(r.category, RuntimeWarning) for r in rec) == 1
    g0, _, _ = tst.LeastSquaresGradient().window_sums(X2t, y2t, wt, 0, 50)
    np.testing.assert_array_equal(g1.numpy(), g0.numpy())


# ---- whole runs ------------------------------------------------------------

def test_gd_trajectory_parity_sliced(rng, monkeypatch):
    X, y, _ = _data(rng, n=4096, d=24)
    cfg = dict(step_size=0.2, num_iterations=30, mini_batch_fraction=0.1,
               sampling="sliced", seed=7, convergence_tol=0.0)
    w0, h0 = _jsgd(jg.LeastSquaresGradient(), **cfg).optimize_with_history(
        (jnp.asarray(X), jnp.asarray(y)), jnp.zeros((24,)))
    gram = _build(X, y, block_rows=512)
    y_t = torch.as_tensor(y)
    # the port's own windows: gram against stock
    ws, hs = _sgd(tst.LeastSquaresGradient(), **cfg).optimize_with_history(
        (gram.data.X, y_t), np.zeros(24, np.float32))
    wg, hg = _sgd(gram, **cfg).optimize_with_history(
        (gram.data.X, y_t), np.zeros(24, np.float32))
    _close(hg, hs)
    _close(wg, ws)
    # the JAX package's windows: gram against the JAX stock run
    inject_starts(monkeypatch, jax_window_starts(7, 4096, 410, 30))
    w1, h1 = _sgd(gram, **cfg).optimize_with_history(
        (gram.data.X, y_t), np.zeros(24, np.float32))
    _close(h1, h0)
    _close(w1, w0)


def test_gd_trajectory_parity_full_batch(rng):
    X, y, _ = _data(rng, n=1500, d=12)
    cfg = dict(step_size=0.3, num_iterations=25, reg_param=0.01, seed=3)
    w0, h0 = _jsgd(jg.LeastSquaresGradient(), jt.SquaredL2Updater(),
                   **cfg).optimize_with_history(
        (jnp.asarray(X), jnp.asarray(y)), jnp.zeros((12,)))
    gram = _build(X, y, block_rows=256)
    w1, h1 = _sgd(gram, tst.SquaredL2Updater(), **cfg).optimize_with_history(
        (gram.data.X, torch.as_tensor(y)), np.zeros(12, np.float32))
    _close(h1, h0)
    _close(w1, w0)


def test_lbfgs_matches_stock_and_accelerated_cost(rng):
    X, y, _ = _data(rng, n=2000, d=20)
    w0, h0 = jt.LBFGS(jg.LeastSquaresGradient(), jt.SquaredL2Updater(),
                      reg_param=0.01, max_num_iterations=15
                      ).optimize_with_history(
        (jnp.asarray(X), jnp.asarray(y)), jnp.zeros((20,)))
    gram = _build(X, y, block_rows=256)
    w1, h1 = tst.LBFGS(gram, tst.SquaredL2Updater(), reg_param=0.01,
                       max_num_iterations=15, device=CPU
                       ).optimize_with_history(
        (gram.data.X, torch.as_tensor(y)), torch.zeros(20))
    assert float(h1[-1]) == pytest.approx(float(h0[-1]), rel=1e-3)
    _close(w1, w0, rtol=1e-2, atol=1e-3)


def test_bf16_data_close_to_f32_truth(rng):
    """bf16 data: every statistics product runs in f32 on the upcast rows,
    so the window tracks the f32 truth OF THE bf16 DATA tightly."""
    X, y, w = _data(rng, n=2048, d=16)
    Xb = torch.as_tensor(X).to(torch.bfloat16)
    Xf = Xb.to(torch.float32).numpy()  # the bf16 data, exactly, in f32
    gram = _build(Xb, y, block_rows=256)
    g1, l1, c1 = gram.window_sums(Xb, *_t(y, w), 100, 512)
    win = slice(100, 612)
    resid = Xf[win] @ w - y[win]
    _close(g1, Xf[win].T @ resid, rtol=1e-3, atol=5e-2)
    assert float(l1) == pytest.approx(0.5 * float(resid @ resid), rel=1e-3)
    assert gram.data.PG.dtype == torch.float32
    # the JAX build of the same bf16 data agrees at the same bound
    jgr = JGram.build(jnp.asarray(X).astype(jnp.bfloat16), jnp.asarray(y),
                      block_rows=256)
    jg1 = jgr.window_sums(jgr.data, jnp.asarray(y), jnp.asarray(w),
                          jnp.int32(100), 512)[0]
    _close(g1, np.asarray(jg1, np.float32), rtol=1e-3, atol=5e-2)


def test_build_rejects_narrow_stats_and_empty(rng):
    X, y, _ = _data(rng, n=64)
    with pytest.raises(ValueError, match="f32"):
        _build(X, y, stats_dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="non-empty"):
        _build(np.zeros((0, 4), np.float32), np.zeros((0,), np.float32))


def test_int_features_build_and_match(rng):
    Xi = rng.integers(0, 2, size=(500, 8)).astype(np.int32)
    y = rng.normal(size=(500,)).astype(np.float32)
    w = rng.normal(size=(8,)).astype(np.float32)
    gram = _build(Xi, y, block_rows=128)
    assert gram.data.X.dtype == torch.float32
    g1, _, _ = gram.window_sums(gram.data, *_t(y, w), 3, 200)
    g0, _, _ = _jstock_window(Xi.astype(np.float32), y, w, 3, 200)
    _close(g1, g0, rtol=2e-4, atol=2e-3)


def test_build_rejects_bad_rank():
    with pytest.raises(ValueError, match="non-empty"):
        _build(np.zeros((8,), np.float32), np.zeros((8,), np.float32))


# ---- optimizer flags ---------------------------------------------------------

def test_gd_set_sufficient_stats_flag(rng):
    X, y, _ = _data(rng, n=2048, d=16)
    Xt, yt = _t(X, y)
    cfg = dict(step_size=0.2, num_iterations=20, mini_batch_fraction=0.25,
               sampling="sliced", seed=5, convergence_tol=0.0)
    w0, h0 = _sgd(tst.LeastSquaresGradient(), **cfg).optimize_with_history(
        (Xt, yt), np.zeros(16, np.float32))
    opt = _sgd(tst.LeastSquaresGradient(), **cfg).set_sufficient_stats(True)
    w1, h1 = opt.optimize_with_history((Xt, yt), np.zeros(16, np.float32))
    _close(h1, h0)
    assert opt._gram_entry is not None
    # identity cache: same tensors -> same build; the gradient unchanged
    built = opt._gram_entry[2]
    opt.optimize_with_history((Xt, yt), np.zeros(16, np.float32))
    assert opt._gram_entry[2] is built
    assert type(opt.gradient) is tst.LeastSquaresGradient


def test_gd_sufficient_stats_noop_cases(rng):
    X = rng.normal(size=(256, 8)).astype(np.float32)
    y = (rng.uniform(size=(256,)) > 0.5).astype(np.float32)
    opt = (_sgd(tst.LogisticGradient(), num_iterations=3)
           .set_sufficient_stats(True))
    opt.optimize_with_history((X, y), np.zeros(8, np.float32))
    assert opt._gram_entry is None  # not least squares
    opt2 = (_sgd(tst.LeastSquaresGradient(), num_iterations=3,
                 mini_batch_fraction=0.5).set_sufficient_stats(True))
    opt2.optimize_with_history((X, y), np.zeros(8, np.float32))
    assert opt2._gram_entry is None  # bernoulli sampling


def test_lbfgs_and_owlqn_sufficient_stats_flag(rng):
    X, y, _ = _data(rng, n=1500, d=12)
    Xt, yt = _t(X, y)
    r0 = jt.LBFGS(jg.LeastSquaresGradient(), jt.SquaredL2Updater(),
                  reg_param=0.01, max_num_iterations=12
                  ).optimize_with_history((jnp.asarray(X), jnp.asarray(y)),
                                          jnp.zeros((12,)))
    lb = tst.LBFGS(tst.LeastSquaresGradient(), tst.SquaredL2Updater(),
                   reg_param=0.01, max_num_iterations=12,
                   device=CPU).set_sufficient_stats(True)
    r1 = lb.optimize_with_history((Xt, yt), torch.zeros(12))
    assert float(r1[1][-1]) == pytest.approx(float(r0[1][-1]), rel=1e-3)
    assert lb._gram_entry is not None

    o0 = jt.OWLQN(jg.LeastSquaresGradient(), reg_param=1e-3,
                  max_num_iterations=12).optimize_with_history(
        (jnp.asarray(X), jnp.asarray(y)), jnp.zeros((12,)))
    ow = tst.OWLQN(tst.LeastSquaresGradient(), reg_param=1e-3,
                   max_num_iterations=12, device=CPU).set_sufficient_stats(
        True)
    o1 = ow.optimize_with_history((Xt, yt), torch.zeros(12))
    assert float(o1[1][-1]) == pytest.approx(float(o0[1][-1]), rel=1e-3)
    assert ow._gram_entry is not None


def test_lbfgs_statistics_cost_and_sweep_match_jax(rng):
    """One statistics cost evaluation and one 25-trial sweep against the
    JAX package's evaluators on its own statistics, at the tight tier."""
    X, y, w = _data(rng, n=1200, d=10)
    W = rng.normal(size=(25, 10)).astype(np.float32)
    jgr = JGram.build(jnp.asarray(X), jnp.asarray(y), block_rows=128)
    reg = jl._reg_terms(jt.SquaredL2Updater(), 0.05)
    jf, jgv = jl._build_cost(jgr, *reg, None, False)(
        jnp.asarray(w), jgr.data, jnp.asarray(y))
    jvals = jl._build_loss_sweep(jgr, reg[0], None, False)(
        jnp.asarray(W), jgr.data, jnp.asarray(y))
    from tpu_sgd_torch.optimize import lbfgs as tl

    tgr = _build(X, y, block_rows=128)
    treg = tl._reg_terms(tst.SquaredL2Updater(), 0.05)
    tf, tgv = tl._build_cost(tgr, *treg, tgr.data, torch.as_tensor(y))(
        torch.as_tensor(w))
    tvals = tl._build_loss_sweep(tgr, treg[0], tgr.data,
                                 torch.as_tensor(y))(torch.as_tensor(W))
    _close(tgv, jgv, rtol=2e-4, atol=2e-3)
    _close(tf, jf, rtol=2e-4, atol=0)
    _close(tvals, jvals, rtol=2e-4, atol=0)


def test_gramdata_argument_path_matches_plain(rng):
    """Statistics passed as the X argument give the same results as the
    bound matrix, and flow through ``make_run`` unchanged."""
    X, y, w = _data(rng, n=2048, d=16)
    gram = _build(X, y, block_rows=256)
    yt, wt = _t(y, w)
    a = gram.window_sums(gram.data.X, yt, wt, 100, 512)
    b = gram.window_sums(gram.data, yt, wt, 100, 512)
    for u, v in zip(a, b):
        np.testing.assert_array_equal(u.numpy(), v.numpy())

    cfg = SGDConfig(step_size=0.2, num_iterations=10,
                    mini_batch_fraction=0.25, convergence_tol=0.0,
                    sampling="sliced")
    w1, h1, nr1 = tgd.make_run(gram, tst.SimpleUpdater(), cfg)(
        torch.zeros(16), gram.data, yt)
    w0, h0, nr0 = tgd.make_run(tst.LeastSquaresGradient(),
                               tst.SimpleUpdater(), cfg)(
        torch.zeros(16), gram.data.X, yt)
    assert int(nr1) == int(nr0) == 10
    _close(h1, h0)


def test_gramdata_rejects_indexing():
    gram = _build(np.ones((64, 4), np.float32), np.ones(64, np.float32),
                  block_rows=16)
    with pytest.raises(TypeError, match="sliced"):
        gram.data[0]


@pytest.mark.parametrize("family", ["linear", "ridge", "lasso"])
def test_model_level_sufficient_stats(rng, family):
    X = rng.normal(size=(1024, 10)).astype(np.float32)
    w = rng.uniform(-1, 1, size=(10,)).astype(np.float32)
    y = (X @ w + 0.05 * rng.normal(size=(1024,))).astype(np.float32)
    jcls, tcls, extra = {
        "linear": (jt.LinearRegressionWithSGD, tst.LinearRegressionWithSGD,
                   {}),
        "ridge": (jt.RidgeRegressionWithSGD, tst.RidgeRegressionWithSGD,
                  {"reg_param": 0.01}),
        "lasso": (jt.LassoWithSGD, tst.LassoWithSGD, {"reg_param": 0.01}),
    }[family]
    m0 = jcls.train((X, y), num_iterations=40, step_size=0.3,
                    intercept=True, **extra)
    m1 = tcls.train((X, y), num_iterations=40, step_size=0.3,
                    intercept=True, sufficient_stats=True, device=CPU,
                    **extra)
    _close(m1.weights, m0.weights, rtol=1e-3, atol=1e-3)
    assert float(m1.intercept) == pytest.approx(float(m0.intercept),
                                                abs=1e-3)


def test_run_mini_batch_sgd_sufficient_stats(rng):
    X, y, _ = _data(rng, n=1024, d=8)
    args = ((X, y),)
    kw = dict(step_size=0.3, num_iterations=15, reg_param=0.0,
              mini_batch_fraction=1.0, initial_weights=np.zeros(8),
              convergence_tol=0.0)
    w0, h0 = jt.run_mini_batch_sgd(*args, jg.LeastSquaresGradient(),
                                   jt.SimpleUpdater(), **kw)
    w1, h1 = tst.run_mini_batch_sgd(*args, tst.LeastSquaresGradient(),
                                    tst.SimpleUpdater(), **kw,
                                    sufficient_stats=True, device=CPU)
    _close(h1, h0)
    _close(w1, w0)


def test_same_shape_different_matrix_never_binds(rng):
    X, y, w = _data(rng, n=400, d=8)
    gram = _build(X, y, block_rows=128)
    X2t, yt, wt = _t(X + 1.0, y, w)  # same shape, same dtype
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        g1, l1, _ = gram.window_sums(X2t, yt, wt, 0, 200)
    assert any(issubclass(r.category, RuntimeWarning) for r in rec)
    g0, l0, _ = tst.LeastSquaresGradient().window_sums(X2t, yt, wt, 0, 200)
    np.testing.assert_array_equal(g1.numpy(), g0.numpy())
    assert float(l1) == float(l0)


def test_prebuilt_gram_routes_gramdata_through_optimizer(rng, monkeypatch):
    """A user-built gram gradient with its bound matrix must accelerate
    (the stock window never runs), not fall back."""
    X, y, _ = _data(rng, n=2048, d=16)
    gram = _build(X, y, block_rows=256)
    cfg = dict(step_size=0.2, num_iterations=10, mini_batch_fraction=0.25,
               sampling="sliced", convergence_tol=0.0)
    yt = torch.as_tensor(y)
    w0, h0 = _sgd(tst.LeastSquaresGradient(), **cfg).optimize_with_history(
        (gram.data.X, yt), np.zeros(16, np.float32))

    def stock(*a, **k):
        raise AssertionError("the stock window ran")

    monkeypatch.setattr(tst.LeastSquaresGradient, "window_sums", stock)
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        w1, h1 = _sgd(gram, **cfg).optimize_with_history(
            (gram.data.X, yt), np.zeros(16, np.float32))
    assert not any(issubclass(r.category, RuntimeWarning) for r in rec)
    _close(h1, h0)


def test_unbound_executor_is_silent_on_plain_arrays(rng):
    X, y, w = _data(rng, n=256, d=8)
    Xt, yt, wt = _t(X, y, w)
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        g1, _, _ = TGram().window_sums(Xt, yt, wt, 0, 64)
    assert not any(issubclass(r.category, RuntimeWarning) for r in rec)
    g0, _, _ = tst.LeastSquaresGradient().window_sums(Xt, yt, wt, 0, 64)
    np.testing.assert_array_equal(g1.numpy(), g0.numpy())


def test_odd_dimensions_and_blocks(rng):
    n, d = 777, 37
    X = rng.normal(size=(n, d)).astype(np.float32)
    w = rng.uniform(-1, 1, size=(d,)).astype(np.float32)
    y = (X @ w + 0.1 * rng.normal(size=(n,))).astype(np.float32)
    gram = _build(X, y, block_rows=53)
    for start, m in [(0, 100), (51, 53), (700, 77), (123, 1)]:
        g0, _, c0 = _jstock_window(X, y, w, start, m)
        g1, _, c1 = gram.window_sums(gram.data.X, *_t(y, w), start, m)
        _close(g1, g0, rtol=2e-4, atol=2e-2)
        assert float(c1) == float(c0)


def test_f64_data_keeps_f64_stats(rng):
    """f64 data gets f64 statistics by default (the JAX package's x64
    contract), here against numpy's f64 sums."""
    X = rng.normal(size=(64, 4))
    y = rng.normal(size=(64,))
    gram = _build(torch.as_tensor(X), torch.as_tensor(y), block_rows=16)
    assert gram.data.PG.dtype == torch.float64
    np.testing.assert_allclose(gram.data.Pb[2].numpy(), y[:32] @ X[:32],
                               rtol=1e-12)
    np.testing.assert_allclose(gram.data.G_tot.numpy(), X.T @ X, rtol=1e-12)
    g, _, _ = gram.window_sums(gram.data, torch.as_tensor(y),
                               torch.ones(4, dtype=torch.float64), 5, 30)
    assert g.dtype == torch.float64
    r = X[5:35] @ np.ones(4) - y[5:35]
    np.testing.assert_allclose(g.numpy(), X[5:35].T @ r, rtol=1e-10)


# ---- virtual bundles (statistics only) --------------------------------------

def _virtual(X, y, block_rows, tmp_path):
    """A VIRTUAL bundle: the resident build saved and loaded back (the rows
    are not saved)."""
    p = str(tmp_path / "stats")
    _build(X, y, block_rows=block_rows).data.save(p)
    data = tgram.GramData.load(p, device=CPU)
    assert data.X is None
    return TGram(data)


def test_aligned_window_math_vs_numpy(rng, tmp_path):
    X = rng.normal(size=(512, 8)).astype(np.float32)
    w = rng.uniform(-1, 1, 8).astype(np.float32)
    y = (X @ w + 0.1 * rng.normal(size=512)).astype(np.float32)
    gram = _virtual(X, y, 64, tmp_path)
    # m=130 rounds to 2 blocks; start 70 floors to block 1: rows [64, 192)
    g1, l1, c1 = gram.window_sums(gram.data, *_t(y, w), 70, 130)
    rows = slice(64, 192)
    r = X[rows] @ w - y[rows]
    _close(g1, X[rows].T @ r, rtol=1e-4, atol=1e-2)
    assert float(l1) == pytest.approx(0.5 * float(r @ r), rel=1e-4)
    assert float(c1) == 128


def test_virtual_full_batch_matches_stock_on_truncated(rng, tmp_path):
    X = rng.normal(size=(960, 10)).astype(np.float32)
    wt = rng.uniform(-1, 1, 10).astype(np.float32)
    y = (X @ wt + 0.05 * rng.normal(size=960)).astype(np.float32)
    gram = _virtual(X, y, 64, tmp_path)
    cfg = dict(step_size=0.3, num_iterations=20, reg_param=0.01)
    wv, hv = _sgd(gram, tst.SquaredL2Updater(), **cfg).optimize_with_history(
        (gram.data, y), np.zeros(10))
    ws, hs = _jsgd(jg.LeastSquaresGradient(), jt.SquaredL2Updater(),
                   **cfg).optimize_with_history((X, y), np.zeros(10))
    _close(hv, hs)
    _close(wv, ws)


def test_virtual_sliced_gd_converges(rng, tmp_path):
    X = rng.normal(size=(8192, 16)).astype(np.float32)
    wt = rng.uniform(-1, 1, 16).astype(np.float32)
    y = (X @ wt + 0.05 * rng.normal(size=8192)).astype(np.float32)
    gram = _virtual(X, y, 256, tmp_path)
    w, hist = _sgd(gram, step_size=0.3, num_iterations=60,
                   mini_batch_fraction=0.125, sampling="sliced",
                   convergence_tol=0.0).optimize_with_history(
        (gram.data, y), np.zeros(16))
    werr = float(np.linalg.norm(w.numpy() - wt) / np.linalg.norm(wt))
    assert werr < 0.05, werr
    assert hist[-1] < hist[0] * 0.1


def test_virtual_lbfgs_full_batch(rng):
    """L-BFGS from a totals-only bundle (``totals_only_data``)."""
    X = rng.normal(size=(2048, 12)).astype(np.float32)
    wt = rng.uniform(-1, 1, 12).astype(np.float32)
    y = (X @ wt + 0.05 * rng.normal(size=2048)).astype(np.float32)
    G, b, yy = TGram._total_stats(*_t(X, y), B=128,
                                  stats_dtype=torch.float32)
    data = TGram.totals_only_data(G, b, yy, 2048, 12, torch.float32)
    w, _ = tst.LBFGS(TGram(data), tst.SquaredL2Updater(), reg_param=0.001,
                     max_num_iterations=15, device=CPU
                     ).optimize_with_history((data, y), np.zeros(12))
    werr = float(np.linalg.norm(w.numpy() - wt) / np.linalg.norm(wt))
    assert werr < 0.02, werr


def test_total_stats_match_jax_and_mask_rows(rng):
    X, y, _ = _data(rng, n=777, d=9)
    valid = rng.uniform(size=777) < 0.7
    for v in (None, valid):
        jv = None if v is None else jnp.asarray(v)
        ref = JGram._total_stats(jnp.asarray(X), jnp.asarray(y), B=100,
                                 stats_dtype=jnp.float32, valid=jv)
        got = TGram._total_stats(
            *_t(X, y), B=100, stats_dtype=torch.float32,
            valid=None if v is None else torch.as_tensor(v))
        for a, b in zip(got, ref):
            _close(a, b, rtol=1e-5, atol=1e-3)


def test_virtual_guards(rng, tmp_path):
    X = rng.normal(size=(256, 8)).astype(np.float32)
    y = rng.normal(size=256).astype(np.float32)
    gram = _virtual(X, y, 64, tmp_path)
    with pytest.raises(NotImplementedError, match="sliced"):
        _sgd(gram, num_iterations=2, mini_batch_fraction=0.5).optimize(
            (gram.data, y), np.zeros(8))
    with pytest.raises(ValueError, match="GramLeastSquaresGradient"):
        _sgd(tst.LeastSquaresGradient()).optimize((gram.data, y),
                                                  np.zeros(8))
    with pytest.raises(NotImplementedError, match="virtual"):
        gram.window_sums(gram.data, torch.as_tensor(y), torch.zeros(8), 0,
                         64, valid=torch.ones(256, dtype=torch.bool))


def test_resident_aligned_mode(rng):
    X, y, w = _data(rng, n=2048, d=16)
    gram = _build(X, y, block_rows=128, aligned=True)
    g1, _, c1 = gram.window_sums(gram.data.X, *_t(y, w), 200, 300)
    # start 200 floors to block 1 (128); 300 rows round to 2 blocks (256)
    rows = slice(128, 384)
    r = X[rows] @ w - y[rows]
    _close(g1, X[rows].T @ r, rtol=1e-4, atol=1e-2)
    assert float(c1) == 256
    jgr = JGram.build(jnp.asarray(X), jnp.asarray(y), block_rows=128,
                      aligned=True)
    jg1 = jgr.window_sums(jgr.data, jnp.asarray(y), jnp.asarray(w),
                          jnp.int32(200), 300)[0]
    _close(g1, jg1, rtol=2e-4, atol=2e-3)
    _, hist = _sgd(gram, step_size=0.3, num_iterations=40,
                   mini_batch_fraction=0.25, sampling="sliced",
                   convergence_tol=0.0).optimize_with_history(
        (gram.data.X, torch.as_tensor(y)), np.zeros(16, np.float32))
    assert hist[-1] < hist[0] * 0.1


def test_lbfgs_gramdata_with_stock_gradient_clear_error(rng):
    X = rng.normal(size=(128, 8)).astype(np.float32)
    y = rng.normal(size=128).astype(np.float32)
    gram = _build(X, y, block_rows=32)
    lb = tst.LBFGS(tst.LeastSquaresGradient(), tst.SquaredL2Updater(),
                   device=CPU)
    with pytest.raises(ValueError, match="GramLeastSquaresGradient"):
        lb.optimize_with_history((gram.data, y), np.zeros(8))


def test_virtual_gramdata_requires_logical_metadata():
    z = torch.zeros((2, 4, 4))
    with pytest.raises(ValueError, match="logical_shape"):
        tgram.GramData(None, z, torch.zeros((2, 4)), torch.zeros((2,)),
                       torch.zeros((4, 4)), torch.zeros((4,)),
                       torch.zeros(()), 4)


# ---- persistence, across packages -------------------------------------------

def test_gramdata_save_load_round_trip(rng, tmp_path):
    """Statistics persist in the JAX package's format and load back
    VIRTUAL in either package; training from the loaded bundle matches
    training from the original."""
    X = rng.normal(size=(512, 8)).astype(np.float32)
    wt = rng.uniform(-1, 1, 8).astype(np.float32)
    y = (X @ wt + 0.05 * rng.normal(size=512)).astype(np.float32)
    cfg = dict(step_size=0.3, num_iterations=20, mini_batch_fraction=0.25,
               sampling="sliced")

    def run(gg):
        return _sgd(gg, **cfg).optimize_with_history((gg.data, y),
                                                     np.zeros(8))

    g0 = _build(X, y, block_rows=64, aligned=True)
    p = str(tmp_path / "torch_saved")
    g0.data.save(p)
    data = tgram.GramData.load(p, device=CPU)
    assert data.X is None and data.shape == g0.data.shape
    assert data.dtype == torch.float32 and data.block_rows == 64
    w0, h0 = run(g0)
    w1, h1 = run(TGram(data))
    _close(h1, h0, rtol=1e-6, atol=1e-6)
    _close(w1, w0, rtol=1e-6, atol=1e-6)

    # the JAX package loads the port's bundle ...
    jdata = jgram.GramData.load(p)
    assert jdata.X is None and jdata.shape == (512, 8)
    _close(jdata.PG, g0.data.PG, rtol=0, atol=0)
    w_eval = rng.normal(size=8).astype(np.float32)
    jwin = JGram(jdata).window_sums(jdata, jnp.asarray(y),
                                    jnp.asarray(w_eval), jnp.int32(70), 130)
    twin = TGram(data).window_sums(data, *_t(y, w_eval), 70, 130)
    _close(twin[0], jwin[0], rtol=2e-4, atol=2e-3)
    assert float(twin[1]) == pytest.approx(float(jwin[1]), rel=2e-4)
    # ... and the port loads the JAX package's
    jbuilt = JGram.build(jnp.asarray(X), jnp.asarray(y), block_rows=64)
    q = str(tmp_path / "jax_saved")
    jbuilt.data.save(q)
    tdata = tgram.GramData.load(q, device=CPU)
    _close(tdata.PG, jbuilt.data.PG, rtol=0, atol=0)
    _close(tdata.PG, g0.data.PG, rtol=1e-5, atol=1e-3)
    w2, h2 = run(TGram(tdata))
    _close(h2, h0, rtol=1e-5, atol=1e-5)

    meta = json.load(open(p + "/metadata.json"))
    meta["class"] = "SomethingElse"
    json.dump(meta, open(p + "/metadata.json", "w"))
    with pytest.raises(ValueError, match="expected GramData"):
        tgram.GramData.load(p, device=CPU)


def test_bf16_bundle_dtype_crosses_packages(rng, tmp_path):
    X, y, _ = _data(rng, n=256, d=8)
    gram = _build(torch.as_tensor(X).to(torch.bfloat16), y, block_rows=64)
    p = str(tmp_path / "bf16")
    gram.data.save(p)
    assert jgram.GramData.load(p).dtype == jnp.bfloat16
    assert tgram.GramData.load(p, device=CPU).dtype == torch.bfloat16


def test_gram_data_from_numpy_carries_jax_statistics(rng):
    """A bundle built by the JAX package, carried over as numpy, gives the
    same window sums in the port as the port's own build (tight tier)."""
    X, y, _ = _data(rng, n=1500, d=12)
    w = rng.normal(size=12).astype(np.float32)  # away from the optimum
    jd = JGram.build(jnp.asarray(X), jnp.asarray(y), block_rows=128).data
    data = tst.gram_data_from_numpy(
        np.asarray(jd.PG), np.asarray(jd.Pb), np.asarray(jd.Pyy),
        np.asarray(jd.G_tot), np.asarray(jd.b_tot), np.asarray(jd.yy_tot),
        jd.block_rows, jd.shape, str(jd.dtype), X=np.asarray(jd.X),
        device=CPU)
    own = _build(X, y, block_rows=128)
    carried = TGram(data)
    yt, wt = _t(y, w)
    for start, m in [(0, 300), (77, 500), (1400, 100)]:
        a = carried.window_sums(data, yt, wt, start, m)
        b = own.window_sums(own.data, yt, wt, start, m)
        _close(a[0], b[0], rtol=2e-4, atol=2e-3)
        assert float(a[1]) == pytest.approx(float(b[1]), rel=2e-4)
    virtual = tst.gram_data_from_numpy(
        *(np.asarray(getattr(jd, k)) for k in
          ("PG", "Pb", "Pyy", "G_tot", "b_tot", "yy_tot")),
        128, (1500, 12), "float32", device=CPU)
    assert virtual.X is None and virtual.shape == (1500, 12)


def test_gram_random_shape_window_parity_sweep(rng):
    for _ in range(12):
        n = int(rng.integers(40, 1500))
        d = int(rng.integers(2, 40))
        B = int(rng.integers(8, n + 8))
        X = rng.normal(size=(n, d)).astype(np.float32)
        w = rng.uniform(-1, 1, d).astype(np.float32)
        y = (X @ w + 0.1 * rng.normal(size=n)).astype(np.float32)
        gram = _build(X, y, block_rows=B)
        for _ in range(3):
            m = int(rng.integers(1, n + 1))
            start = int(rng.integers(0, n))
            g0, _, c0 = _jstock_window(X, y, w, start, m)
            g1, _, c1 = gram.window_sums(gram.data.X, *_t(y, w), start, m)
            scale = max(1.0, float(np.max(np.abs(np.asarray(g0)))))
            np.testing.assert_allclose(
                g1.numpy(), np.asarray(g0), rtol=5e-4, atol=5e-3 * scale,
                err_msg=f"n={n} d={d} B={B} start={start} m={m}")
            assert float(c1) == float(c0)


def test_feature_scaling_composes_with_sufficient_stats(rng):
    X = (rng.normal(size=(1024, 12)) * np.logspace(0, 3, 12)).astype(
        np.float32)
    wt = (rng.uniform(-1, 1, 12) / np.logspace(0, 3, 12)).astype(np.float32)
    y = (X @ wt + 0.01 * rng.normal(size=1024)).astype(np.float32)
    m0 = tst.LinearRegressionWithLBFGS.train(
        (X, y), feature_scaling=True, intercept=True, device=CPU)
    m1 = tst.LinearRegressionWithLBFGS.train(
        (X, y), feature_scaling=True, intercept=True, sufficient_stats=True,
        device=CPU)
    _close(m1.weights, m0.weights, rtol=1e-3, atol=1e-6)
    mj = jt.LinearRegressionWithLBFGS.train(
        (X, y), feature_scaling=True, intercept=True, sufficient_stats=True)
    _close(m1.weights, mj.weights, rtol=1e-3, atol=1e-6)


def test_unbound_gram_gradient_runs_stock_in_optimizers(rng):
    X, y, _ = _data(rng, n=256, d=8)
    Xt, yt = _t(X, y)
    w0 = torch.zeros(8)
    cfg = dict(step_size=0.2, num_iterations=8, convergence_tol=0.0)
    ws, hs = _sgd(tst.LeastSquaresGradient(), **cfg).optimize_with_history(
        (Xt, yt), w0)
    wu, hu = _sgd(TGram(), **cfg).optimize_with_history((Xt, yt), w0)
    np.testing.assert_array_equal(wu.numpy(), ws.numpy())
    np.testing.assert_array_equal(hu, hs)
    ws, hs = tst.LBFGS(tst.LeastSquaresGradient(), max_num_iterations=5,
                       device=CPU).optimize_with_history((Xt, yt), w0)
    wu, hu = tst.LBFGS(TGram(), max_num_iterations=5,
                       device=CPU).optimize_with_history((Xt, yt), w0)
    np.testing.assert_array_equal(wu.numpy(), ws.numpy())
    np.testing.assert_array_equal(hu, hs)
    wu, hu = tst.OWLQN(TGram(), reg_param=0.01, max_num_iterations=5,
                       device=CPU).optimize_with_history((Xt, yt), w0)
    assert np.all(np.isfinite(wu.numpy())) and len(hu) >= 1


def test_release_sufficient_stats_frees_cache(rng):
    X, y, _ = _data(rng, n=512, d=8)
    Xt, yt = _t(X, y)
    opt = _sgd(tst.LeastSquaresGradient(), step_size=0.2, num_iterations=6,
               convergence_tol=0.0).set_sufficient_stats(True)
    w1, _ = opt.optimize_with_history((Xt, yt), torch.zeros(8))
    assert opt._gram_entry is not None
    assert opt.release_sufficient_stats() is opt
    assert opt._gram_entry is None
    w2, _ = opt.optimize_with_history((Xt, yt), torch.zeros(8))
    np.testing.assert_array_equal(w2.numpy(), w1.numpy())

    lb = tst.LBFGS(tst.LeastSquaresGradient(), max_num_iterations=5,
                   device=CPU).set_sufficient_stats(True)
    lb.optimize_with_history((Xt, yt), torch.zeros(8))
    assert lb._gram_entry is not None
    lb.release_sufficient_stats()
    assert lb._gram_entry is None


# ---- the chunked-gather driver ----------------------------------------------

def _count_chunked_runs(monkeypatch):
    made = []
    real = gram_driver.make_chunked_gram_run

    def counted(*a, **k):
        made.append(k["chunk_iters"])
        return real(*a, **k)

    monkeypatch.setattr(gram_driver, "make_chunked_gram_run", counted)
    return made


def _chunked_setup(rng, n=4096, d=12):
    X = rng.normal(size=(n, d)).astype(np.float32)
    w = rng.uniform(-1, 1, d).astype(np.float32)
    y = (X @ w + 0.05 * rng.normal(size=n)).astype(np.float32)
    return _t(X, y)


@pytest.mark.parametrize("chunk_iters", [1, 7, 16])
def test_chunked_driver_matches_per_iteration_aligned(rng, monkeypatch,
                                                      chunk_iters):
    """Same window stream, same prefix-difference math, also for chunk
    sizes that do not divide the iteration count; against the JAX
    package's per-iteration aligned run on its own windows too."""
    Xt, yt = _chunked_setup(rng)
    made = _count_chunked_runs(monkeypatch)
    cfg = dict(step_size=0.3, num_iterations=30, mini_batch_fraction=0.1,
               sampling="sliced", seed=11, convergence_tol=0.0)

    def make(chunked):
        opt = (_sgd(tst.LeastSquaresGradient(), **cfg)
               .set_sufficient_stats(True)
               .set_gram_options(block_rows=256, aligned=True))
        if chunked:
            opt.set_gram_options(chunk_iters=chunk_iters)
        return opt

    w0, h0 = make(False).optimize_with_history((Xt, yt), np.zeros(12))
    assert made == []
    w1, h1 = make(True).optimize_with_history((Xt, yt), np.zeros(12))
    assert made == [chunk_iters]
    assert len(h0) == len(h1) == 30
    _close(h1, h0, rtol=1e-5, atol=1e-6)
    _close(w1, w0, rtol=1e-5, atol=1e-6)

    jopt = (_jsgd(jg.LeastSquaresGradient(), **cfg)
            .set_sufficient_stats(True)
            .set_gram_options(block_rows=256, aligned=True))
    wj, hj = jopt.optimize_with_history((Xt.numpy(), yt.numpy()),
                                        np.zeros(12, np.float32))
    inject_starts(monkeypatch, jax_window_starts(11, 4096, 410, 30))
    w2, h2 = make(True).optimize_with_history((Xt, yt), np.zeros(12))
    _close(h2, hj)
    _close(w2, wj)


def test_chunked_driver_convergence_contract(rng, monkeypatch):
    """With convergence_tol > 0 the chunked driver records EXACTLY as many
    losses as the per-iteration driver (post-convergence updates inside a
    chunk are masked to no-ops)."""
    Xt, yt = _chunked_setup(rng)
    made = _count_chunked_runs(monkeypatch)

    def make(chunked):
        opt = (_sgd(tst.LeastSquaresGradient(), step_size=0.5,
                    num_iterations=200, mini_batch_fraction=0.1,
                    sampling="sliced", seed=5, convergence_tol=1e-3)
               .set_sufficient_stats(True)
               .set_gram_options(block_rows=256, aligned=True))
        if chunked:
            opt.set_gram_options(chunk_iters=16)
        return opt

    _, h0 = make(False).optimize_with_history((Xt, yt), np.zeros(12))
    _, h1 = make(True).optimize_with_history((Xt, yt), np.zeros(12))
    assert made == [16]
    assert 0 < len(h0) < 200 and len(h0) % 16 != 0
    assert len(h1) == len(h0)
    _close(h1, h0, rtol=1e-5, atol=1e-6)


def test_chunked_driver_virtual_bundle(rng, monkeypatch, tmp_path):
    """Virtual statistics are aligned by construction: the knob engages
    without ``aligned=True``."""
    Xt, yt = _chunked_setup(rng, n=2048)
    gram = _virtual(Xt.numpy(), yt.numpy(), 256, tmp_path)
    made = _count_chunked_runs(monkeypatch)
    cfg = dict(step_size=0.3, num_iterations=20, mini_batch_fraction=0.1,
               sampling="sliced", seed=3, convergence_tol=0.0)
    w0, h0 = _sgd(gram, **cfg).optimize_with_history((gram.data, yt),
                                                     np.zeros(12))
    w1, h1 = (_sgd(gram, **cfg).set_gram_options(chunk_iters=8)
              .optimize_with_history((gram.data, yt), np.zeros(12)))
    assert made == [8]
    _close(h1, h0, rtol=1e-5, atol=1e-6)


def test_chunked_driver_resident_exact_ignores_knob(rng, monkeypatch):
    """Exact (unaligned) resident statistics keep the per-iteration driver:
    their edge corrections need the rows."""
    Xt, yt = _chunked_setup(rng, n=2048)
    made = _count_chunked_runs(monkeypatch)
    (_sgd(tst.LeastSquaresGradient(), step_size=0.3, num_iterations=5,
          mini_batch_fraction=0.1, sampling="sliced", convergence_tol=0.0)
     .set_sufficient_stats(True)
     .set_gram_options(block_rows=256, aligned=False, chunk_iters=8)
     .optimize_with_history((Xt, yt), np.zeros(12)))
    assert made == []


def test_gram_knob_validation():
    """Validate every knob, then apply: a bad later argument leaves the
    earlier ones untouched."""
    for opt in (tst.GradientDescent(device=CPU), tst.LBFGS(device=CPU)):
        with pytest.raises(ValueError, match="block_rows must be positive"):
            opt.set_gram_options(block_rows=0)
    opt = tst.GradientDescent(device=CPU)
    with pytest.raises(ValueError, match="chunk_iters must be positive"):
        opt.set_gram_options(block_rows=64, aligned=True, chunk_iters=0)
    assert (opt.gram_block_rows, opt.gram_aligned, opt.gram_chunk_iters) \
        == (tgram.DEFAULT_BLOCK_ROWS, False, None)
    opt.set_gram_options(block_rows=64, aligned=1, chunk_iters=4)
    assert (opt.gram_block_rows, opt.gram_aligned, opt.gram_chunk_iters) \
        == (64, True, 4)
    with pytest.raises(ValueError, match="chunk_iters must be positive"):
        gram_driver.make_chunked_gram_run(tst.SimpleUpdater(), SGDConfig(),
                                          n=64, block_rows=8, chunk_iters=0)


def test_chunked_driver_ignores_optimizer_aligned_on_prebuilt_exact(
        rng, monkeypatch):
    """A prebuilt EXACT gram gradient keeps its exact per-iteration
    windows: the optimizer's ``aligned`` knob configures future builds and
    must not reroute it through the aligned chunked driver."""
    Xt, yt = _chunked_setup(rng, n=2048)
    gram = _build(Xt, yt, block_rows=256)
    made = _count_chunked_runs(monkeypatch)

    def make(chunk):
        return (_sgd(gram, step_size=0.3, num_iterations=20,
                     mini_batch_fraction=0.1, sampling="sliced", seed=7,
                     convergence_tol=0.0)
                .set_gram_options(aligned=True, chunk_iters=chunk))

    w_c, h_c = make(8).optimize_with_history((gram.data, yt), np.zeros(12))
    assert made == []
    w_0, h_0 = make(None).optimize_with_history((gram.data, yt),
                                                np.zeros(12))
    _close(h_c, h_0, rtol=1e-6, atol=1e-7)
    _close(w_c, w_0, rtol=1e-6, atol=1e-7)


# ---- precision and dtypes ----------------------------------------------------

_PRODUCTS = {"matmul", "__matmul__", "__rmatmul__", "mm", "mv", "dot",
             "bmm"}


def test_statistics_products_run_in_true_stats_dtype(rng):
    """EVERY product inside the statistics evaluators runs in f64, or in
    f32 with TF32 off whatever the process setting, and the build's in
    f64: near convergence the quadratic loss is a near-zero difference of
    ``|y|²``-sized terms, and a TF32 product's ~1e-3 error dwarfs it.  The
    CPU has no TF32, so this records each product's operand dtypes and the
    TF32 flag as it runs."""
    from torch.overrides import TorchFunctionMode

    X, y, w = _data(rng, n=1000, d=16)
    Xb = torch.as_tensor(X).to(torch.bfloat16)
    seen = []

    class Record(TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            if getattr(func, "__name__", "") in _PRODUCTS:
                seen.append(({a.dtype for a in args
                              if isinstance(a, torch.Tensor)},
                             torch.backends.cuda.matmul.allow_tf32))
            return func(*args, **(kwargs or {}))

    mm = torch.backends.cuda.matmul
    prev = mm.allow_tf32
    mm.allow_tf32 = True
    try:
        with Record():
            g = TGram.build(Xb, y, block_rows=128, device=CPU)
        yt, wt = _t(y, w)
        W = torch.stack([wt, 0.5 * wt])
        evaluators = {
            "batch_sums": lambda: g.batch_sums(g.data, yt, wt),
            "loss_sweep": lambda: g.loss_sweep(g.data, yt, W),
            "window_sums_exact": lambda: g.window_sums(g.data, yt, wt, 17,
                                                       256),
            "window_sums_aligned": lambda: TGram(g.data, aligned=True)
            .window_sums(g.data, yt, wt, 17, 256),
            "total_stats": lambda: TGram._total_stats(
                Xb, yt, B=128, stats_dtype=torch.float32),
        }
        build_seen = list(seen)
        for name, fn in evaluators.items():
            seen.clear()
            with Record():
                fn()
            assert seen, name
            assert all(dt == {torch.float64}
                       or (dt == {torch.float32} and not tf32)
                       for dt, tf32 in seen), (name, seen)
        assert build_seen and all(dt == {torch.float64}
                                  for dt, _ in build_seen)
        assert mm.allow_tf32  # the caller's setting is restored
    finally:
        mm.allow_tf32 = prev


def test_stats_dtype_rejects_non_floating(rng):
    X, y, _ = _data(rng)
    for bad in (torch.int32, torch.int16, torch.bool, "int32"):
        with pytest.raises(ValueError, match="floating"):
            _build(X, y, stats_dtype=bad)
    with pytest.raises(ValueError, match="float32 or wider"):
        _build(X, y, stats_dtype=torch.bfloat16)
    g = _build(X, y, stats_dtype="float64")
    assert g.data.PG.dtype == torch.float64


def test_single_block_virtual_stats_warn_on_sliced(rng):
    X, y, _ = _data(rng, n=512, d=8)
    data = TGram.totals_only_data(
        *TGram._total_stats(*_t(X, y), B=512, stats_dtype=torch.float32),
        512, 8, "float32")
    assert data.PG.shape[0] == 2  # one block by construction
    opt = _sgd(TGram(data), step_size=0.1, num_iterations=3,
               mini_batch_fraction=0.25, sampling="sliced")
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        opt.optimize_with_history((data, y), np.zeros(8, np.float32))
    assert any("degenerate to FULL-BATCH" in str(r.message) for r in rec)


# ---- the streamed statistics entry points -----------------------------------

def _streamed_stats_run(opt):
    """``opt`` (a setter's return value) on 300 host rows: a finite,
    non-increasing history."""
    X, y, _ = _data(np.random.default_rng(3), n=300, d=4)
    _, hist = opt.optimize_with_history((X, y), np.zeros(4, np.float32))
    assert len(hist) > 1 and np.all(np.isfinite(hist))
    assert hist[-1] < hist[0]
    return opt


def _streamed_build_runs():
    g = TGram.build_streamed(np.ones((8, 2)), np.ones(8), block_rows=4,
                             device=CPU)
    assert g.data.X is None and g.data.shape == (8, 2)
    return g


def _batch_rows_knob(opt):
    assert opt.set_gram_options(batch_rows=64) is opt
    assert opt.gram_batch_rows == 64
    _streamed_stats_run(opt.set_streamed_stats(True, block_rows=16))
    assert opt._streamed_gram_entry[3][1] == 64


@pytest.mark.parametrize("probe", [
    pytest.param(_streamed_build_runs, id="<lambda>0"),
    pytest.param(lambda: _streamed_stats_run(
        tst.GradientDescent(device=CPU).set_step_size(0.2)
        .set_streamed_stats(True, block_rows=16)), id="<lambda>1"),
    pytest.param(lambda: _streamed_stats_run(
        tst.LBFGS(device=CPU).set_streamed_stats(True, block_rows=16)),
        id="<lambda>2"),
    pytest.param(lambda: _streamed_stats_run(
        tst.OWLQN(device=CPU).set_streamed_stats(True, block_rows=16)),
        id="<lambda>3"),
    pytest.param(lambda: _batch_rows_knob(
        tst.GradientDescent(device=CPU).set_step_size(0.2)),
        id="<lambda>4"),
    pytest.param(lambda: _batch_rows_knob(tst.LBFGS(device=CPU)),
                 id="<lambda>5"),
])
def test_streamed_statistics_raise_naming_a9(probe):
    """Each entry point of the streamed statistics (ROADMAP A9, second
    half) returns its gradient or optimizer and runs on the CPU; their
    parity is held in ``tests/test_torch_streamed_gram.py``."""
    probe()


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the rule is for hosts "
                    "without one")
    X = np.ones((16, 2), np.float32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TGram.build(X, np.ones(16, np.float32))
    gram = _build(X, np.ones(16, np.float32), block_rows=4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tgram.GramData.load("unused")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tst.GradientDescent(gram).optimize((gram.data, np.ones(16)),
                                           np.zeros(2))

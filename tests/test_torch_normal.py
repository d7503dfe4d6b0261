"""Parity of the port's normal-equations solver (``tpu_sgd_torch/optimize/
normal.py``) with the JAX package on the CPU: the resident cases of
``tests/test_normal.py`` plus the port's own block accumulation, Cholesky
failure and raising setters.

Tolerances: the weights at the tight tier (rtol 2e-4 / atol 2e-3 against
JAX; rtol 1e-3 / atol 1e-4 against the numpy closed form, as the JAX
test), the one-entry loss history at rtol 2e-4 against JAX.
"""

import numpy as np
import pytest
import torch

from tpu_sgd.models import regression as jreg
from tpu_sgd.optimize.normal import NormalEquations as JNormal
import tpu_sgd_torch as tst
from tpu_sgd_torch.optimize import normal as tn
from tpu_sgd_torch.utils.mlutils import linear_data

CPU = "cpu"


def _ols(X, y, reg=0.0):
    n, d = X.shape
    A = X.T @ X / n + reg * np.eye(d)
    return np.linalg.solve(A, X.T @ y / n)


def test_exact_ols_matches_numpy_and_jax():
    X, y, _ = linear_data(2000, 12, eps=0.3, seed=0)
    w = tn.NormalEquations(device=CPU).optimize((X, y),
                                                np.zeros(12, np.float32))
    np.testing.assert_allclose(w.numpy(), _ols(X, y), rtol=1e-3, atol=1e-4)
    jw = JNormal().optimize((X, y), np.zeros(12, np.float32))
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=2e-4,
                               atol=2e-3)


def test_ridge_matches_numpy_and_jax():
    X, y, _ = linear_data(2000, 12, eps=0.3, seed=1)
    reg = 0.37
    opt = tn.NormalEquations(reg, device=CPU)
    w = opt.optimize((X, y), np.zeros(12, np.float32)).numpy()
    np.testing.assert_allclose(w, _ols(X, y, reg), rtol=1e-3, atol=1e-4)
    assert opt.loss_history.shape == (1,)
    resid = X @ w - y
    expect = 0.5 * np.mean(resid**2) + 0.5 * reg * np.dot(w, w)
    np.testing.assert_allclose(opt.loss_history[0], expect, rtol=1e-3)
    jopt = JNormal(reg)
    jw = jopt.optimize((X, y), np.zeros(12, np.float32))
    np.testing.assert_allclose(w, np.asarray(jw), rtol=2e-4, atol=2e-3)
    np.testing.assert_allclose(opt.loss_history, jopt.loss_history,
                               rtol=2e-4)


@pytest.mark.parametrize("n", [4096, 4096 * 3 + 17, 100_000])
def test_gram_blocks_match_one_product(n):
    """Full blocks, batched products and the ragged last block sum to the
    Gram of one f64 product, to f32 rounding."""
    rng = np.random.default_rng(n)
    X = rng.normal(size=(n, 7)).astype(np.float32)
    y = rng.normal(size=n).astype(np.float32)
    A, b, yty, count = tn._gram_sums(torch.as_tensor(X), torch.as_tensor(y))
    X64, y64 = X.astype(np.float64), y.astype(np.float64)
    np.testing.assert_allclose(A.numpy(), X64.T @ X64, rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(b.numpy(), X64.T @ y64, rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(float(yty), y64 @ y64, rtol=1e-6)
    assert float(count) == n


def test_bf16_data_rounds_y_like_jax():
    """bf16 X keeps bf16 operands with f32 sums, y rounded to bf16 in Xᵀy
    as the JAX package's ``preferred_element_type`` contract does."""
    X, y, _ = linear_data(3000, 6, eps=0.2, seed=5)
    Xb = torch.as_tensor(X).to(torch.bfloat16)
    A, b, _, _ = tn._gram_sums(Xb, torch.as_tensor(y))
    Xf = Xb.to(torch.float32).double()
    yb = torch.as_tensor(y).to(torch.bfloat16).double()
    np.testing.assert_allclose(A.numpy(), (Xf.T @ Xf).numpy(), rtol=1e-5,
                               atol=1e-3)
    np.testing.assert_allclose(b.numpy(), (Xf.T @ yb).numpy(), rtol=1e-5,
                               atol=1e-3)


def test_model_level_train_with_intercept_matches_jax():
    X, y, w_true = linear_data(3000, 6, intercept=1.7, eps=0.05, seed=3)
    model = tst.LinearRegressionWithNormal.train((X, y), intercept=True,
                                                 device=CPU)
    assert isinstance(model, tst.LinearRegressionModel)
    assert abs(model.intercept - 1.7) < 0.05
    np.testing.assert_allclose(model.weights.numpy(), w_true, atol=0.05)
    mse = float(np.mean((model.predict(X).numpy() - y) ** 2))
    assert mse < 0.01
    jm = jreg.LinearRegressionWithNormal.train((X, y), intercept=True)
    np.testing.assert_allclose(model.weights.numpy(), np.asarray(jm.weights),
                               rtol=2e-4, atol=2e-3)
    assert model.intercept == pytest.approx(jm.intercept, abs=2e-3)


def test_wrong_weight_dim_raises():
    X, y, _ = linear_data(100, 5, seed=4)
    with pytest.raises(ValueError, match="length 3"):
        tn.NormalEquations(device=CPU).optimize((X, y),
                                                np.zeros(3, np.float32))


def test_rank_deficient_gram_raises_like_jax():
    """A Gram that is not positive definite (a duplicated column, reg 0)
    raises the JAX package's FloatingPointError, not torch's own."""
    X, y, _ = linear_data(500, 4, seed=6)
    X = np.concatenate([X, X[:, :1]], axis=1)
    with pytest.raises(FloatingPointError, match="rank-deficient") as t_err:
        tn.NormalEquations(device=CPU).optimize((X, y),
                                                np.zeros(5, np.float32))
    with pytest.raises(FloatingPointError) as j_err:
        JNormal().optimize((X, y), np.zeros(5, np.float32))
    assert str(t_err.value) == str(j_err.value)
    w = tn.NormalEquations(0.1, device=CPU).optimize(
        (X, y), np.zeros(5, np.float32))
    assert bool(torch.all(torch.isfinite(w)))


def test_sparse_features_raise():
    X, y, _ = tst.sparse_data(50, 10, nnz_per_row=3, seed=1)
    with pytest.raises(NotImplementedError, match="dense features"):
        tn.NormalEquations(device=CPU).optimize((X, y), np.zeros(10))


def _mesh_raises(opt):
    """``set_mesh`` takes a data mesh (its runs:
    ``tests/test_torch_mesh_qn.py``) and raises for anything else: a
    non-Mesh, and a 2-D mesh with the reference's message."""
    from tpu_sgd_torch.parallel import DATA_AXIS, MODEL_AXIS, Mesh

    with pytest.raises(TypeError, match="Mesh"):
        opt.set_mesh(object())
    with pytest.raises(ValueError, match="data-only mesh"):
        opt.set_mesh(Mesh({DATA_AXIS: 2, MODEL_AXIS: 2}))
    mesh = Mesh({DATA_AXIS: 2})
    assert opt.set_mesh(mesh).mesh is mesh


def _host_streaming_solves(opt):
    """The host-streamed totals give the resident solve (parity:
    ``tests/test_torch_streamed_gram.py``)."""
    X, y, _ = linear_data(600, 6, eps=0.1, seed=4)
    w0 = np.zeros(6, np.float32)
    assert opt.set_host_streaming(True, batch_rows=128) is opt
    w = opt.optimize((X, y), w0)
    ref = tn.NormalEquations(reg_param=opt.reg_param, device=CPU).optimize(
        (X, y), w0)
    np.testing.assert_allclose(w.numpy(), ref.numpy(), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("call", [
    pytest.param(_mesh_raises, id="<lambda>-A5"),
    pytest.param(_host_streaming_solves, id="<lambda>-A9")])
def test_later_slices_raise(call):
    """``set_mesh`` raises for what is not a data mesh;
    ``set_host_streaming`` runs."""
    call(tn.NormalEquations(device=CPU))


def test_true_f32_matmul_restores_the_settings():
    mm = torch.backends.cuda.matmul
    before = (mm.allow_tf32, mm.allow_bf16_reduced_precision_reduction)
    mm.allow_tf32 = True
    try:
        with tst.device.true_f32_matmul():
            assert mm.allow_tf32 is False
            assert mm.allow_bf16_reduced_precision_reduction is False
        assert mm.allow_tf32 is True
    finally:
        mm.allow_tf32, mm.allow_bf16_reduced_precision_reduction = before

"""Parity of the port's feature transformers (``tpu_sgd_torch/feature.py``),
column statistics (``stat.py``) and the GLM harness's feature-scaling pass
with the JAX package on the CPU: the cases of ``tests/test_feature.py`` and
``tests/test_stat.py``, each fed the same numpy inputs on both sides.
Sparse inputs are the same numpy CSR triples: a BCOO for JAX, a CSR tensor
for the port.

Tolerances: statistics and transforms rtol 1e-5 (atol 1e-6) against JAX,
the closed-form bounds of the JAX tests against numpy; counts and
zeroed factors exactly; correlation matrices at the JAX tests' rtol 2e-3 /
atol 2e-4; scaled training within the JAX tests' bounds, and its weights
at rtol 2e-3 / atol 2e-3 of the JAX run (full-batch L-BFGS).
"""

import numpy as np
import pytest
import torch

import tpu_sgd.feature as jf
import tpu_sgd.ops.sparse as js
import tpu_sgd.stat as jstat
from tpu_sgd.models import classification as jcls
from tpu_sgd.models import regression as jreg
import tpu_sgd_torch as tst
from tpu_sgd_torch import feature as tf
from tpu_sgd_torch import stat as tstat
from tpu_sgd_torch.ops import sparse as ts

CPU = "cpu"


def _skewed(rng, n=500, d=6):
    X = rng.normal(size=(n, d)).astype(np.float32)
    scales = np.array([1e-2, 1.0, 30.0, 400.0, 5.0, 0.5], np.float32)[:d]
    return X * scales


def _sparse_pair(n, d, nnz, seed):
    """The same sparse data for both packages (same numpy draws)."""
    return (js.sparse_data(n, d, nnz_per_row=nnz, seed=seed)[0],
            ts.sparse_data(n, d, nnz_per_row=nnz, seed=seed)[0])


def _close(t, j, rtol=1e-5, atol=1e-6):
    t = t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    np.testing.assert_allclose(t, np.asarray(j), rtol=rtol, atol=atol)


# ---- StandardScaler --------------------------------------------------------

class TestStandardScaler:
    @pytest.mark.parametrize("with_mean", [False, True])
    def test_fit_and_transform_match_jax(self, rng, with_mean):
        X = _skewed(rng)
        tm = tf.StandardScaler(with_mean=with_mean).fit(X)
        jm = jf.StandardScaler(with_mean=with_mean).fit(X)
        for name in ("mean", "variance", "std", "factor"):
            _close(getattr(tm, name), getattr(jm, name))
        Xs = tm.transform(X)
        assert isinstance(Xs, np.ndarray)  # a host array stays on the host
        _close(Xs, jm.transform(X), atol=1e-5)
        np.testing.assert_allclose(Xs.std(axis=0, ddof=1), 1.0, rtol=1e-4)
        if with_mean:
            np.testing.assert_allclose(Xs.mean(axis=0), 0.0, atol=1e-4)
        _close(tm.transform(torch.as_tensor(X)), jm.transform(X), atol=1e-5)

    def test_constant_column_zeroed(self, rng):
        X = _skewed(rng)
        X[:, 2] = 7.0
        model = tf.StandardScaler().fit(X)
        np.testing.assert_allclose(model.transform(X)[:, 2], 0.0)
        assert float(model.factor[2]) == 0.0

    def test_high_mean_low_variance_column_survives(self, rng):
        X = rng.normal(size=(500, 2)).astype(np.float32)
        X[:, 1] = 1e6 + rng.normal(size=500).astype(np.float32)
        model = tf.StandardScaler().fit(X)
        assert float(model.factor[1]) > 0.0
        assert model.transform(X)[:, 1].std() > 0.5

    def test_neither_flag_rejected(self):
        with pytest.raises(ValueError):
            tf.StandardScaler(with_mean=False, with_std=False)

    def test_sparse_matches_dense_and_jax(self):
        jX, tX = _sparse_pair(200, 40, 8, 3)
        t_sp = tf.StandardScaler().fit(tX)
        t_d = tf.StandardScaler().fit(tX.to_dense())
        j_sp = jf.StandardScaler().fit(jX)
        _close(t_sp.variance, t_d.variance, rtol=2e-4)
        _close(t_sp.variance, j_sp.variance, rtol=2e-4)
        out = t_sp.transform(tX)
        assert out.layout == torch.sparse_csr
        _close(out.to_dense(), j_sp.transform(jX).todense(), rtol=2e-4,
               atol=1e-5)

    def test_sparse_with_mean_rejected(self):
        _, tX = _sparse_pair(50, 10, 3, 1)
        model = tf.StandardScaler(with_mean=True).fit(tX.to_dense())
        with pytest.raises(ValueError, match="with_mean"):
            model.transform(tX)

    def test_vector_roundtrip(self, rng):
        X = _skewed(rng)
        model = tf.StandardScaler().fit(X)
        w = torch.as_tensor(rng.normal(size=(X.shape[1],)).astype(np.float32))
        np.testing.assert_allclose(model.transform(w * model.std).numpy(),
                                   w.numpy(), rtol=1e-4)

    def test_bf16_promotes_to_f32(self, rng):
        X = torch.as_tensor(_skewed(rng)).to(torch.bfloat16)
        out = tf.StandardScaler().fit(X).transform(X)
        assert out.dtype == torch.float32


# ---- Normalizer ------------------------------------------------------------

class TestNormalizer:
    @pytest.mark.parametrize("p", [1.0, 2.0, 3.0, float("inf")])
    def test_dense_matches_jax(self, rng, p):
        X = rng.normal(size=(50, 8)).astype(np.float32)
        X[3] = 0.0  # a zero row passes through
        out = tf.Normalizer(p).transform(X)
        _close(out, jf.Normalizer(p).transform(X))
        np.testing.assert_allclose(out[3].numpy(), 0.0)

    def test_single_vector(self):
        out = tf.Normalizer().transform(np.array([3.0, 4.0], np.float32))
        np.testing.assert_allclose(out.numpy(), [0.6, 0.8], rtol=1e-6)

    @pytest.mark.parametrize("p", [2.0, float("inf")])
    def test_sparse_matches_dense_and_jax(self, p):
        jX, tX = _sparse_pair(100, 30, 5, 8)
        out = tf.Normalizer(p).transform(tX)
        assert out.layout == torch.sparse_csr
        _close(out.to_dense(), tf.Normalizer(p).transform(tX.to_dense()),
               rtol=1e-4)
        _close(out.to_dense(), jf.Normalizer(p).transform(jX).todense(),
               rtol=1e-4)

    def test_sparse_single_vector_is_one_row(self):
        v = torch.tensor([3.0, 0.0, 4.0]).to_sparse()
        out = tf.Normalizer().transform(v)
        np.testing.assert_allclose(out.to_dense().numpy(), [0.6, 0.0, 0.8],
                                   rtol=1e-6)
        out_inf = tf.Normalizer(p=float("inf")).transform(v)
        np.testing.assert_allclose(out_inf.to_dense().numpy(),
                                   [0.75, 0.0, 1.0], rtol=1e-6)

    def test_bad_p_rejected(self):
        with pytest.raises(ValueError):
            tf.Normalizer(p=0.0)


# ---- the GLM harness's scaling pass ----------------------------------------

class TestGLMFeatureScaling:
    def test_scaled_training_returns_original_space(self, rng):
        w_true = np.array([2.0, -0.5, 0.03, 1e-3], np.float32)
        X = (rng.normal(size=(800, 4)) * np.array([1.0, 3.0, 40.0, 900.0])) \
            .astype(np.float32)
        y = (X @ w_true + 0.01 * rng.normal(size=(800,))).astype(np.float32)
        scaled = tst.LinearRegressionWithLBFGS(device=CPU) \
            .set_feature_scaling(True).run((X, y))
        np.testing.assert_allclose(scaled.weights.numpy(), w_true, rtol=0.05,
                                   atol=1e-3)
        np.testing.assert_allclose(scaled.predict(X[:50]).numpy(), y[:50],
                                   atol=0.2)
        jalg = jreg.LinearRegressionWithLBFGS().set_feature_scaling(True)
        jalg.set_schedule("off")
        _close(scaled.weights, jalg.run((X, y)).weights, rtol=2e-3,
               atol=2e-3)

    def test_scaling_improves_conditioning_for_sgd(self, rng):
        w_true = np.array([1.0, -2.0, 0.5], np.float32)
        X = (rng.normal(size=(1000, 3)) * np.array([1.0, 50.0, 2000.0])) \
            .astype(np.float32)
        y = (X @ w_true).astype(np.float32)

        def mse(model):
            return float(np.mean((model.predict(X).numpy() - y) ** 2))

        plain = tst.LinearRegressionWithSGD.train(
            (X, y), num_iterations=50, step_size=1e-7, device=CPU)
        scaled = tst.LinearRegressionWithSGD(
            step_size=1.0, num_iterations=50, device=CPU
        ).set_feature_scaling(True).run((X, y))
        assert mse(scaled) < mse(plain) * 1e-2

    @pytest.mark.parametrize("intercept", [True, False])
    def test_multinomial_scaled_predicts(self, rng, intercept):
        K, d, n = 3, 4, 600
        W = rng.normal(size=(K, d)).astype(np.float32)
        X = (rng.normal(size=(n, d)) * np.array([1.0, 10.0, 100.0, 0.1])) \
            .astype(np.float32)
        y = np.argmax(X @ W.T, axis=1).astype(np.float32)

        def alg(mod, **kw):
            a = mod.LogisticRegressionWithLBFGS(max_num_iterations=60, **kw)
            return a.set_num_classes(K).set_intercept(intercept) \
                .set_feature_scaling(True)

        model = alg(tst, device=CPU).run((X, y))
        acc = float(np.mean(model.predict(X).numpy() == y))
        assert acc > (0.9 if intercept else 0.85)
        jm = alg(jcls).set_schedule("off").run((X, y))
        jacc = float(np.mean(np.asarray(jm.predict(X)) == y))
        assert abs(acc - jacc) <= 0.02

    def test_warm_start_original_space(self, rng):
        w_true = np.array([3.0, -1.0], np.float32)
        X = (rng.normal(size=(400, 2)) * np.array([1.0, 100.0])) \
            .astype(np.float32)
        y = (X @ w_true).astype(np.float32)
        model = tst.LinearRegressionWithLBFGS(device=CPU) \
            .set_feature_scaling(True).run((X, y), initial_weights=w_true)
        np.testing.assert_allclose(model.weights.numpy(), w_true, rtol=1e-3,
                                   atol=1e-4)


# ---- column statistics (tests/test_stat.py) ---------------------------------

class TestColStats:
    def test_dense_matches_jax_and_closed_forms(self, rng):
        X = rng.normal(size=(200, 5)).astype(np.float32) * 3 + 1
        X[:, 3] = 0.0
        s = tstat.col_stats(X)
        j = jstat.col_stats(X)
        assert s.count == j.count == 200
        for name in ("mean", "variance", "max", "min", "norm_l1",
                     "norm_l2"):
            _close(getattr(s, name), getattr(j, name), atol=1e-5)
        np.testing.assert_array_equal(s.num_nonzeros, j.num_nonzeros)
        np.testing.assert_allclose(s.variance, X.var(0, ddof=1), rtol=1e-3,
                                   atol=1e-6)

    def test_sparse_matches_dense_and_jax(self):
        jX, tX = _sparse_pair(300, 50, 6, 9)
        s_sp = tstat.col_stats(tX)
        s_d = tstat.col_stats(tX.to_dense())
        j_sp = jstat.col_stats(jX)
        for name in ("mean", "variance", "max", "min", "norm_l2"):
            _close(getattr(s_sp, name), getattr(s_d, name), rtol=1e-3)
            _close(getattr(s_sp, name), getattr(j_sp, name), rtol=1e-4)
        np.testing.assert_array_equal(s_sp.num_nonzeros, s_d.num_nonzeros)
        np.testing.assert_array_equal(s_sp.num_nonzeros, j_sp.num_nonzeros)

    def test_sparse_implicit_zero_extrema(self):
        X = ts.csr_from_triple(
            (np.array([2.0, 3.0, -4.0], np.float32),
             np.array([0, 0, 1]), np.array([0, 1, 2, 3])), 2)
        s = tstat.col_stats(X)
        assert s.min[0] == 0.0 and s.max[0] == 3.0
        assert s.max[1] == 0.0 and s.min[1] == -4.0

    def test_empty_rejected(self):
        with pytest.raises(ValueError, match="empty"):
            tstat.col_stats(np.zeros((0, 3), np.float32))


class TestCorr:
    def test_pearson_matches_jax_and_numpy(self, rng):
        X = rng.normal(size=(400, 6)).astype(np.float32)
        X[:, 1] = 2.0 * X[:, 0] + 0.1 * X[:, 1]
        C = tstat.corr(X)
        np.testing.assert_allclose(C, np.corrcoef(X.T), rtol=2e-3, atol=2e-4)
        np.testing.assert_allclose(C, jstat.corr(X), rtol=2e-3, atol=2e-4)
        np.testing.assert_allclose(np.diag(C), 1.0)

    def test_spearman_matches_jax_with_ties(self):
        from scipy.stats import spearmanr

        rng = np.random.default_rng(4)
        X = np.round(rng.normal(size=(200, 2)), 1).astype(np.float32)
        C = tstat.corr(X, method="spearman")
        assert C[0, 1] == pytest.approx(
            spearmanr(X[:, 0], X[:, 1]).statistic, abs=1e-4)
        np.testing.assert_allclose(C, jstat.corr(X, method="spearman"),
                                   rtol=2e-3, atol=2e-4)

    def test_constant_column_nan_off_diagonal(self, rng):
        X = rng.normal(size=(100, 2)).astype(np.float32)
        X[:, 1] = 5.0
        C = tstat.corr(X)
        assert np.isnan(C[0, 1]) and C[0, 0] == 1.0

    def test_sparse_pearson_matches_dense_and_jax(self):
        jX, tX = _sparse_pair(300, 25, 5, 11)
        C_sp = tstat.corr(tX)
        np.testing.assert_allclose(C_sp, tstat.corr(tX.to_dense()),
                                   rtol=2e-3, atol=2e-3)
        np.testing.assert_allclose(C_sp, jstat.corr(jX), rtol=2e-3,
                                   atol=2e-3)

    def test_sparse_pearson_beyond_one_column_block_matches_dense(self):
        """A CSR X wider than one block of the CSR kernel's right-hand
        side (2,100 columns: blocks of 1,024, 1,024 and 52) against the
        float64 ``np.corrcoef`` of its dense copy, at the tolerance of
        the JAX comparison above."""
        _, tX = _sparse_pair(400, 2100, 40, 12)
        dense = tX.to_dense().double().numpy()
        np.testing.assert_allclose(tstat.corr(tX), np.corrcoef(dense.T),
                                   rtol=2e-3, atol=2e-3)

    def test_sparse_gram_goes_through_the_csr_kernel(self, monkeypatch):
        """The sparse Gram calls ``cuda_kernels.csr_grad_sum`` once a block
        of at most ``CSR_MAX_COLUMNS`` columns (the CSR kernel on the
        card, never a library's sparse-sparse product), and equals the
        float64 ``Xᵀ X``; duplicate entries add, as in a sparse product.
        ``corr`` adds one call for the column means."""
        from tpu_sgd_torch.ops import cuda_kernels

        calls = []
        real = cuda_kernels.csr_grad_sum

        def spy(Xt, coeff):
            calls.append(tuple(coeff.shape))
            return real(Xt, coeff)

        monkeypatch.setattr(cuda_kernels, "csr_grad_sum", spy)
        _, tX = _sparse_pair(300, 2100, 30, 13)
        G = tstat._csr_gram(ts.transpose_csr(tX))
        assert calls == [(300, 1024), (300, 1024), (300, 52)]
        Xd = tX.to_dense().double()
        np.testing.assert_allclose(G.numpy(), (Xd.T @ Xd).numpy(),
                                   rtol=1e-5, atol=1e-5)
        dup = torch.sparse_csr_tensor(
            torch.tensor([0, 3, 4]), torch.tensor([1, 1, 0, 2]),
            torch.tensor([1.0, 2.0, 4.0, 5.0]), size=(2, 3))
        # X = [[4, 1 + 2, 0], [0, 0, 5]]
        np.testing.assert_array_equal(
            tstat._csr_gram(ts.transpose_csr(dup)).numpy(),
            np.array([[16, 12, 0], [12, 9, 0], [0, 0, 25]], np.float32))
        calls.clear()
        tstat.corr(tX)
        assert calls == [(300, 1024), (300, 1024), (300, 52), (300,)]

    def test_bad_methods_rejected(self, rng):
        with pytest.raises(ValueError, match="unknown"):
            tstat.corr(rng.normal(size=(10, 2)), method="kendall")
        _, tX = _sparse_pair(50, 10, 3, 5)
        with pytest.raises(ValueError, match="dense rank"):
            tstat.corr(tX, method="spearman")

"""Parity of the port's sparse-feature path (``tpu_sgd_torch/ops/sparse.py``
and the sparse branches of the gradients, the optimizer and the models)
with the JAX package's BCOO path on the CPU.  Inputs are numpy CSR triples
made from a seed: JAX gets them through ``csr_to_bcoo``, the port through
``csr_from_triple``.

Tolerances:
  * exact: entries, labels, shapes, counts and loss-history lengths;
  * tight: per-step sums at the bounds of ``tests/test_pallas.py`` (grad
    rtol 2e-4 / atol 2e-3, loss rtol 2e-4); whole full-batch runs the same
    on their loss histories and weights;
  * matched objective: hinge + L1 runs (subgradient steps whose active
    sets can flip on a rounding difference) within 1.01x of the other
    side's objective.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_sgd.ops.sparse as js
from tpu_sgd.models import classification as jcls
from tpu_sgd.models import regression as jreg
from tpu_sgd.ops import gradients as jg
from tpu_sgd.ops import updaters as ju
from tpu_sgd.optimize import gradient_descent as jgd
import tpu_sgd_torch as tst
from tpu_sgd_torch.ops import cuda_kernels as ck
from tpu_sgd_torch.ops import gradients as tg
from tpu_sgd_torch.ops import sparse as ts
from tpu_sgd_torch.ops import updaters as tu
from tpu_sgd_torch.optimize import gradient_descent as tgd

RCV1_D = 47_236
GRADS = {"least_squares": (jg.LeastSquaresGradient, tg.LeastSquaresGradient),
         "logistic": (jg.LogisticGradient, tg.LogisticGradient),
         "hinge": (jg.HingeGradient, tg.HingeGradient)}


def _triple(n, d, nnz, seed, values="normal"):
    """A numpy CSR triple with ``nnz`` distinct sorted columns a row."""
    rng = np.random.default_rng(seed)
    cols = np.stack([np.sort(rng.choice(d, size=nnz, replace=False))
                     for _ in range(n)]).astype(np.int32).reshape(-1)
    if values == "onehot":
        vals = np.ones(n * nnz, np.int32)
    else:
        vals = rng.normal(size=n * nnz).astype(np.float32)
    return vals, cols, np.arange(n + 1, dtype=np.int64) * nnz


def _both(triple, d):
    """The same CSR triple as a JAX BCOO and a port CSR tensor."""
    vals = triple[0]
    jdtype = jnp.int32 if vals.dtype == np.int32 else jnp.float32
    tdtype = torch.int32 if vals.dtype == np.int32 else torch.float32
    return (js.csr_to_bcoo(triple, d, dtype=jdtype),
            ts.csr_from_triple(triple, d, dtype=tdtype))


def _labels(family, n, seed):
    rng = np.random.default_rng(seed)
    if family == "least_squares":
        return rng.normal(size=n).astype(np.float32)
    return (rng.uniform(size=n) < 0.5).astype(np.float32)


def _same_entries(jX, tX):
    for a, b in zip(js.host_entries(jX), ts.host_entries(tX)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert tuple(jX.shape) == tuple(tX.shape)


# -- exact tier ----------------------------------------------------------------

@pytest.mark.parametrize("layout", ["csr", "csc", "coo", "bsr"])
def test_is_sparse_detects_every_layout(layout):
    X = torch.tensor([[0.0, 2.0], [1.0, 0.0]])
    conv = {"csr": X.to_sparse_csr, "csc": X.to_sparse_csc,
            "coo": X.to_sparse_coo,
            "bsr": lambda: X.to_sparse_bsr((1, 1))}[layout]
    assert ts.is_sparse(conv())
    assert not ts.is_sparse(X)
    assert not ts.is_sparse(X.numpy())


@pytest.mark.parametrize("kind", ["linear", "logistic", "svm"])
def test_sparse_data_matches_jax(kind):
    jX, jy, jw = js.sparse_data(300, 500, nnz_per_row=12, kind=kind, seed=3)
    tX, ty, tw = ts.sparse_data(300, 500, nnz_per_row=12, kind=kind, seed=3)
    assert tX.layout == torch.sparse_csr
    assert tX.col_indices().dtype == torch.int32
    _same_entries(jX, tX)
    np.testing.assert_array_equal(ty, np.asarray(jy))
    np.testing.assert_array_equal(tw, np.asarray(jw))


def test_csr_from_triple_matches_csr_to_bcoo():
    data = np.asarray([2.0, 1.0, 3.0], np.float32)
    indices = np.asarray([1, 0, 2], np.int32)
    indptr = np.asarray([0, 1, 3])
    jX, tX = _both((data, indices, indptr), 3)
    _same_entries(jX, tX)
    np.testing.assert_array_equal(tX.to_dense().numpy(),
                                  [[0.0, 2.0, 0.0], [1.0, 0.0, 3.0]])


@pytest.mark.parametrize("bad", [-1, 3])
def test_csr_from_triple_rejects_out_of_range_index(bad):
    triple = (np.ones(2, np.float32), np.asarray([0, bad]),
              np.asarray([0, 2]))
    with pytest.raises(IndexError, match="out of range"):
        js.csr_to_bcoo(triple, 3)
    with pytest.raises(IndexError, match="out of range"):
        ts.csr_from_triple(triple, 3)


def test_append_bias_sparse_matches_jax():
    jX, tX = _both(_triple(50, 20, 4, seed=1), 20)
    tb = ts.append_bias_sparse(tX)
    _same_entries(js.append_bias_bcoo(jX), tb)
    np.testing.assert_array_equal(tb.to_dense()[:, -1].numpy(), 1.0)
    assert ts.append_bias_auto(tX).shape == (50, 21)
    assert ts.append_bias_auto(np.zeros((3, 2), np.float32)).shape == (3, 3)


def test_take_rows_matches_jax():
    jX, tX = _both(_triple(40, 15, 3, seed=2), 15)
    idx = np.asarray([7, 0, 39, 12])
    _same_entries(js.take_rows_bcoo(jX, idx), ts.take_rows(tX, idx))
    with pytest.raises(ValueError, match="unique"):
        ts.take_rows(tX, [1, 1])
    with pytest.raises(IndexError, match="row indices"):
        ts.take_rows(tX, [-1])
    with pytest.raises(IndexError, match="row indices"):
        ts.take_rows(tX, [40])


def test_row_matrix_of_a_sparse_vector():
    v = torch.tensor([0.0, 3.0, 0.0, 4.0]).to_sparse()
    r = ts.row_matrix(v)
    assert r.layout == torch.sparse_csr and r.shape == (1, 4)
    np.testing.assert_array_equal(r.to_dense().numpy(), [[0, 3, 0, 4]])
    X = torch.eye(2).to_sparse_csr()
    assert ts.row_matrix(X) is X


def test_load_libsvm_file_csr_matches_jax(tmp_path):
    from tpu_sgd_torch.utils.mlutils import save_as_libsvm_file

    _, tX = _both(_triple(30, 12, 4, seed=4), 12)
    y = np.arange(30, dtype=np.float32) % 2
    path = str(tmp_path / "part.libsvm")
    save_as_libsvm_file(path, tX, y)
    jX, jy = js.load_libsvm_file_bcoo(path)
    tX2, ty = ts.load_libsvm_file_csr(path)
    _same_entries(jX, tX2)
    np.testing.assert_array_equal(ty, jy)


def test_labeled_points_to_arrays_match_jax():
    from tpu_sgd.linalg import DenseVector as JDense, SparseVector as JSparse
    from tpu_sgd.models.labeled_point import LabeledPoint as JLP
    from tpu_sgd.models.labeled_point import to_arrays as jto

    rows = [(1.0, "sparse", (6, [4, 1], [2.0, -1.0])),
            (0.0, "dense", [0.0, 3.0, 0.0, 0.0, 0.0, 5.0]),
            (1.0, "array", np.asarray([1, 0, 0, 0, 0, 0], np.float32))]
    jp, tp = [], []
    for label, kind, f in rows:
        if kind == "sparse":
            jp.append(JLP(label, JSparse(*f)))
            tp.append(tst.LabeledPoint(label, tst.SparseVector(*f)))
        elif kind == "dense":
            jp.append(JLP(label, JDense(f)))
            tp.append(tst.LabeledPoint(label, tst.DenseVector(f)))
        else:
            jp.append(JLP(label, f))
            tp.append(tst.LabeledPoint(label, f))
    jX, jy = jto(jp)
    tX, ty = tst.to_arrays(tp)
    _same_entries(jX, tX)
    np.testing.assert_array_equal(ty, np.asarray(jy))
    # all-dense records stay a dense array, as in the JAX package
    dX, _ = tst.to_arrays(tp[1:])
    np.testing.assert_array_equal(dX, np.asarray(jto(jp[1:])[0]))
    # a torch sparse feature vector counts as a sparse record
    sX, _ = tst.to_arrays([tst.LabeledPoint(
        1.0, torch.tensor([0.0, 2.0, 0.0]).to_sparse())])
    np.testing.assert_array_equal(sX.to_dense().numpy(), [[0, 2, 0]])


def test_sparse_loss_history_lengths_match_jax():
    triple = _triple(400, 60, 8, seed=5)
    jX, tX = _both(triple, 60)
    y = _labels("least_squares", 400, 6)
    kw = dict(step_size=0.1, num_iterations=300, convergence_tol=1e-3)
    jw, jh = jgd.GradientDescent(jg.LeastSquaresGradient()).set_step_size(
        kw["step_size"]).set_num_iterations(kw["num_iterations"]) \
        .set_convergence_tol(kw["convergence_tol"]).optimize_with_history(
            (jX, jnp.asarray(y)), jnp.zeros(60))
    t = tgd.GradientDescent(tg.LeastSquaresGradient(), device="cpu")
    t.set_step_size(kw["step_size"]).set_num_iterations(kw["num_iterations"])
    tw, th = t.set_convergence_tol(kw["convergence_tol"]) \
        .optimize_with_history((tX, y), np.zeros(60))
    assert len(th) == len(jh) < 300


# -- tight tier ----------------------------------------------------------------

@pytest.mark.parametrize("family", sorted(GRADS))
@pytest.mark.parametrize("with_mask", [False, True])
def test_batch_sums_match_jax_at_rcv1_width(family, with_mask):
    """n = 2000 rows of the real RCV1 width (d = 47,236), 75 a row."""
    n = 2000
    jX, tX = _both(_triple(n, RCV1_D, 75, seed=7), RCV1_D)
    y = _labels(family, n, 8)
    w = (np.random.default_rng(9).normal(size=RCV1_D) * 0.1).astype(
        np.float32)
    mask = (np.random.default_rng(10).uniform(size=n) < 0.3
            if with_mask else None)
    JG, TG = GRADS[family]
    jgs, jls, jc = JG().batch_sums(jX, jnp.asarray(y), jnp.asarray(w),
                                   None if mask is None
                                   else jnp.asarray(mask))
    tgs, tls, tc = TG().batch_sums(tX, torch.from_numpy(y),
                                   torch.from_numpy(w),
                                   None if mask is None
                                   else torch.from_numpy(mask))
    np.testing.assert_allclose(tgs.numpy(), np.asarray(jgs), rtol=2e-4,
                               atol=2e-3)
    np.testing.assert_allclose(float(tls), float(jls), rtol=2e-4)
    assert float(tc) == float(jc) == (n if mask is None else mask.sum())


def test_batch_sums_with_a_prebuilt_transpose():
    _, tX = _both(_triple(300, 90, 6, seed=11), 90)
    y = torch.from_numpy(_labels("logistic", 300, 12))
    w = torch.from_numpy(np.random.default_rng(13).normal(size=90)
                         .astype(np.float32))
    g = tg.LogisticGradient()
    got = g.batch_sums(tX, y, w, Xt=ts.transpose_csr(tX))
    ref = g.batch_sums(tX, y, w)
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    np.testing.assert_array_equal(ts.transpose_csr(tX).to_dense().numpy(),
                                  tX.to_dense().numpy().T)
    # make_run takes the transpose a caller already holds
    from tpu_sgd_torch.config import SGDConfig

    run = tgd.make_run(g, tu.SimpleUpdater(),
                       SGDConfig(num_iterations=4, convergence_tol=0.0))
    a = run(torch.zeros(90), tX, y)
    b = run(torch.zeros(90), tX, y, Xt=ts.transpose_csr(tX))
    for u, v in zip(a, b):
        torch.testing.assert_close(u, v, rtol=0, atol=0, equal_nan=True)


def test_int_one_hot_values_promote_like_jax():
    jX, tX = _both(_triple(500, 40, 5, seed=14, values="onehot"), 40)
    assert tX.dtype == torch.int32
    y = _labels("logistic", 500, 15)
    w = (np.random.default_rng(16).normal(size=40) * 0.3).astype(np.float32)
    jgs, jls, _ = jg.LogisticGradient().batch_sums(jX, jnp.asarray(y),
                                                   jnp.asarray(w))
    tgs, tls, _ = tg.LogisticGradient().batch_sums(tX, torch.from_numpy(y),
                                                   torch.from_numpy(w))
    assert tgs.dtype == torch.float32
    np.testing.assert_allclose(tgs.numpy(), np.asarray(jgs), rtol=2e-4,
                               atol=2e-3)
    np.testing.assert_allclose(float(tls), float(jls), rtol=2e-4)
    # and the optimizer trains on them
    w_, h = tgd.GradientDescent(tg.LogisticGradient(), device="cpu") \
        .set_num_iterations(5).optimize_with_history((tX, y), np.zeros(40))
    assert len(h) == 5 and np.all(np.isfinite(h))


@pytest.mark.parametrize("family", ["least_squares", "logistic"])
def test_full_batch_runs_match_jax(family):
    n, d = 1500, 300
    jX, tX = _both(_triple(n, d, 20, seed=17), d)
    y = _labels(family, n, 18)
    JG, TG = GRADS[family]
    cfg = dict(step=0.5, iters=40)
    j = jgd.GradientDescent(JG(), ju.SquaredL2Updater()) \
        .set_step_size(cfg["step"]).set_num_iterations(cfg["iters"]) \
        .set_reg_param(0.01).set_convergence_tol(0.0)
    t = tgd.GradientDescent(TG(), tu.SquaredL2Updater(), device="cpu") \
        .set_step_size(cfg["step"]).set_num_iterations(cfg["iters"]) \
        .set_reg_param(0.01).set_convergence_tol(0.0)
    jw, jh = j.optimize_with_history((jX, jnp.asarray(y)), jnp.zeros(d))
    tw, th = t.optimize_with_history((tX, y), np.zeros(d))
    assert len(th) == len(jh) == cfg["iters"]
    np.testing.assert_allclose(th, np.asarray(jh), rtol=2e-4)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=2e-4,
                               atol=2e-3)


# -- matched objective ---------------------------------------------------------

def _hinge_l1_objective(Xd, y, w, reg):
    m = Xd.astype(np.float64) @ np.asarray(w, np.float64)
    return float(np.mean(np.maximum(0.0, 1 - (2 * y - 1) * m))
                 + reg * np.abs(np.asarray(w, np.float64)).sum())


def test_hinge_l1_runs_reach_jax_objective():
    jX, jy, _ = js.sparse_data(2000, 400, nnz_per_row=20, kind="svm",
                               seed=19)
    tX, ty, _ = ts.sparse_data(2000, 400, nnz_per_row=20, kind="svm",
                               seed=19)
    reg = 1e-3
    jm = jcls.SVMWithSGD.train((jX, jy), 200, 5.0, reg,
                               updater=ju.L1Updater(), schedule="off")
    tm = tst.SVMWithSGD.train((tX, ty), 200, 5.0, reg,
                              updater=tu.L1Updater(), device="cpu",
                              schedule="off")
    Xd = tX.to_dense().numpy()
    L_t = _hinge_l1_objective(Xd, ty, tm.weights.numpy(), reg)
    L_j = _hinge_l1_objective(Xd, ty, np.asarray(jm.weights), reg)
    assert L_t <= 1.01 * L_j
    acc = float(np.mean(tm.predict(tX).numpy() == ty))
    assert acc == pytest.approx(float(np.mean(np.asarray(jm.predict(jX))
                                              == ty)), abs=0.01)


@pytest.mark.parametrize("frac", [1.0, 0.5])
def test_sparse_path_matches_dense_path(frac):
    """Full batch: the same arithmetic, so the histories agree tightly;
    Bernoulli: the same mask draws (same seed and row count), so the
    objective is matched."""
    tX, y, _ = ts.sparse_data(1200, 200, nnz_per_row=15, kind="svm", seed=21)
    runs = {}
    for kind, X in (("sparse", tX), ("dense", tX.to_dense().numpy())):
        alg = tst.SVMWithSGD(2.0, 100, 1e-3, frac, device="cpu")
        alg.optimizer.set_updater(tu.L1Updater()).set_convergence_tol(0.0)
        runs[kind] = (alg.run((X, y)), alg.optimizer.loss_history)
    Xd = tX.to_dense().numpy()
    Ls = _hinge_l1_objective(Xd, y, runs["sparse"][0].weights.numpy(), 1e-3)
    Ld = _hinge_l1_objective(Xd, y, runs["dense"][0].weights.numpy(), 1e-3)
    assert Ls <= 1.01 * Ld
    if frac == 1.0:
        np.testing.assert_allclose(runs["sparse"][1], runs["dense"][1],
                                   rtol=2e-4)


# -- models on sparse features -----------------------------------------------

def test_svm_with_intercept_on_sparse_matches_jax():
    jX, jy, _ = js.sparse_data(800, 50, nnz_per_row=10, kind="svm", seed=23)
    tX, ty, _ = ts.sparse_data(800, 50, nnz_per_row=10, kind="svm", seed=23)
    jm = jcls.SVMWithSGD.train((jX, jy), 40, 1.0, 0.01, intercept=True,
                               schedule="off")
    tm = tst.SVMWithSGD.train((tX, ty), 40, 1.0, 0.01, intercept=True,
                              device="cpu", schedule="off")
    np.testing.assert_allclose(tm.weights.numpy(), np.asarray(jm.weights),
                               rtol=2e-4, atol=2e-3)
    assert tm.intercept == pytest.approx(jm.intercept, rel=2e-4, abs=2e-3)
    np.testing.assert_array_equal(tm.predict(tX).numpy(),
                                  np.asarray(jm.predict(jX)))
    # dense rows and one SparseVector predict as the sparse batch does
    Xd = tX.to_dense().numpy()
    np.testing.assert_array_equal(tm.predict(Xd).numpy(),
                                  tm.predict(tX).numpy())
    v = tst.SparseVector(50, np.nonzero(Xd[3])[0], Xd[3][Xd[3] != 0])
    assert float(tm.predict(v)) == float(tm.predict(tX).numpy()[3])
    assert tm.predict_margin(v).shape == (1,)


def test_linear_regression_on_sparse_matches_jax():
    jX, jy, _ = js.sparse_data(600, 40, nnz_per_row=8, seed=25)
    tX, ty, _ = ts.sparse_data(600, 40, nnz_per_row=8, seed=25)
    jm = jreg.LinearRegressionWithSGD.train((jX, jy), 30, 0.5,
                                            schedule="off")
    tm = tst.LinearRegressionWithSGD.train((tX, ty), 30, 0.5, device="cpu",
                                           schedule="off")
    np.testing.assert_allclose(tm.weights.numpy(), np.asarray(jm.weights),
                               rtol=2e-4, atol=2e-3)
    np.testing.assert_allclose(tm.predict(tX).numpy(),
                               np.asarray(jm.predict(jX)), rtol=2e-4,
                               atol=2e-3)


def test_multinomial_lbfgs_sparse_train_and_predict():
    """Multinomial L-BFGS with an intercept on CSR, against the JAX
    package on the same BCOO rows (the twin of
    ``tests/test_sparse.py::test_multinomial_lbfgs_sparse_train_and_predict``):
    equal iteration counts, the port's objective within 1.01x of the JAX
    run's (30 quasi-Newton steps from other summation orders are held by
    matched objective, as tests/test_torch_multinomial.py holds its
    runs), at least 99% of the predicted classes equal and the JAX test's
    accuracy bar; then prediction on dense rows and on one sparse row
    equal to the sparse batch's."""
    jX, jy, _ = js.sparse_data(600, 30, nnz_per_row=8, kind="linear",
                               seed=23)
    tX, ty, _ = ts.sparse_data(600, 30, nnz_per_row=8, kind="linear",
                               seed=23)
    y = np.asarray(jy)
    y3 = ((y > -0.5).astype(np.float32) + (y > 0.5).astype(np.float32))
    jalg = jcls.LogisticRegressionWithLBFGS(max_num_iterations=30)
    jalg.set_num_classes(3).set_intercept(True)
    jm = jalg.run((jX, y3))
    talg = tst.LogisticRegressionWithLBFGS(max_num_iterations=30,
                                           device="cpu")
    talg.set_num_classes(3).set_intercept(True)
    tm = talg.run((tX, torch.from_numpy(y3)))
    jh = np.asarray(jalg.optimizer.loss_history)
    th = np.asarray(talg.optimizer.loss_history)
    assert len(th) == len(jh)
    assert th[-1] <= 1.01 * jh[-1]
    preds = tm.predict(tX).numpy()
    assert float(np.mean(preds == np.asarray(jm.predict(jX)))) >= 0.99
    assert float(np.mean(preds == y3)) > 0.6
    # dense rows agree with the sparse batch
    Xd = tX.to_dense().numpy()
    np.testing.assert_array_equal(tm.predict(Xd).numpy(), preds)
    # one sparse row predicts as the same dense row
    v = tst.SparseVector(30, np.nonzero(Xd[0])[0], Xd[0][Xd[0] != 0])
    assert float(tm.predict(v)) == float(tm.predict(Xd[0])) == preds[0]


# -- guards ---------------------------------------------------------------------

@pytest.mark.parametrize("layout", ["csr", "csc", "coo", "bsr"])
def test_every_sparse_layout_reaches_the_sparse_path(layout):
    """CSR included: ``Tensor.is_sparse`` is False for it, and a CSR X
    once went past the guard to ``X.contiguous()``."""
    tX, y, _ = ts.sparse_data(300, 30, nnz_per_row=5, seed=27)
    X = {"csr": tX, "csc": tX.to_sparse_csc(),
         "coo": tX.to_sparse_coo(),
         "bsr": tX.to_dense().to_sparse_bsr((1, 1))}[layout]
    opt = tgd.GradientDescent(tg.LeastSquaresGradient(), device="cpu")
    opt.set_num_iterations(10).set_convergence_tol(0.0)
    w, h = opt.optimize_with_history((X, y), np.zeros(30))
    ref = tgd.GradientDescent(tg.LeastSquaresGradient(), device="cpu")
    ref.set_num_iterations(10).set_convergence_tol(0.0)
    wd, hd = ref.optimize_with_history((tX.to_dense(), y), np.zeros(30))
    np.testing.assert_allclose(h, hd, rtol=2e-4)
    np.testing.assert_allclose(w.numpy(), wd.numpy(), rtol=2e-4, atol=2e-3)


@pytest.mark.parametrize("sampling", ["sliced", "indexed"])
def test_sliced_and_indexed_sampling_raise_on_sparse(sampling):
    tX, y, _ = ts.sparse_data(100, 20, nnz_per_row=4, seed=29)
    opt = tgd.GradientDescent(device="cpu").set_sampling(sampling)
    opt.set_mini_batch_fraction(0.5)
    with pytest.raises(NotImplementedError, match="bernoulli"):
        opt.optimize((tX, y), np.zeros(20))
    with pytest.raises(NotImplementedError, match="dense row layout"):
        tg.LeastSquaresGradient().window_sums(
            tX, torch.from_numpy(y), torch.zeros(20), 0, 10)
    # at full batch nothing is sampled, so any sampling mode trains
    opt.set_mini_batch_fraction(1.0).set_num_iterations(3)
    assert len(opt.optimize_with_history((tX, y), np.zeros(20))[1]) == 3


def test_cpu_sparse_path_launches_no_kernel():
    ck.reset_launch_counts()
    tX, y, _ = ts.sparse_data(400, 30, nnz_per_row=5, seed=31)
    tst.LinearRegressionWithSGD.train((tX, y), 5, 0.5, 0.3, device="cpu")
    fg = ck.FusedGradient(tg.LeastSquaresGradient(), tile_m=40)
    opt = tgd.GradientDescent(fg, device="cpu").set_num_iterations(5)
    opt.optimize((tX, y), np.zeros(30))
    with pytest.raises(NotImplementedError, match="dense row layout"):
        fg.window_sums(tX, torch.from_numpy(y), torch.zeros(30), 0, 80)
    assert ck.launch_counts() == {"fused_gradient_sums": 0,
                                  "fused_window_sums": 0,
                                  "fused_window_sums_vpu": 0}

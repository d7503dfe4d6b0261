"""Parity of the port's data utilities (``tpu_sgd_torch/utils/mlutils.py``,
``tpu_sgd_torch/linalg.py``, ``LabeledPoint.parse``) with the JAX package
on the CPU.  Everything here is host-side, so every comparison is exact:
CSR triples, labels, feature counts, split rows, generator draws and
parsed records must be identical."""

import os

import numpy as np
import pytest
import torch

import tpu_sgd.linalg as jl
import tpu_sgd.ops.sparse as js
import tpu_sgd.utils.mlutils as jm
from tpu_sgd.models.labeled_point import LabeledPoint as JLP
import tpu_sgd_torch as tst
import tpu_sgd_torch.linalg as tl
import tpu_sgd_torch.utils.mlutils as tm
from tpu_sgd_torch.ops import sparse as ts


def _data(n=40, d=15, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)).astype(np.float32)
    X[rng.uniform(size=X.shape) < 0.7] = 0.0
    X[:, 0] = 1.0      # every row has an entry
    X[0, -1] = 0.5     # max-index discovery sees column d
    y = rng.integers(0, 2, size=n).astype(np.float32)
    return X, y


def _same_csr(a, b):
    (da, ia, pa), ya, na = a
    (db, ib, pb), yb, nb = b
    for u, v in ((da, db), (ia, ib), (pa, pb), (ya, yb)):
        np.testing.assert_array_equal(np.asarray(u), np.asarray(v))
    assert na == nb


def _write(path, lines):
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


@pytest.mark.parametrize("layout", ["file", "directory", "glob"])
def test_load_libsvm_file_matches_jax(tmp_path, layout):
    X, y = _data()
    if layout == "file":
        path = str(tmp_path / "data.libsvm")
        jm.save_as_libsvm_file(path, X, y)
    else:
        out = str(tmp_path / "parts")
        jm.save_as_libsvm_file(out, X, y, num_partitions=3)
        path = out if layout == "directory" else os.path.join(out, "part-*")
    _same_csr(tm.load_libsvm_file(path, dense=False),
              jm.load_libsvm_file(path, dense=False))
    tX, ty = tm.load_libsvm_file(path)
    jX, jy = jm.load_libsvm_file(path)
    np.testing.assert_array_equal(tX, jX)
    np.testing.assert_array_equal(ty, jy)
    np.testing.assert_array_equal(tX, X)
    tX2, _ = tm.load_libsvm_file(path, num_features=20)
    assert tX2.shape == (40, 20)


def test_libsvm_comments_blank_lines_and_one_based_indices(tmp_path):
    path = str(tmp_path / "c.libsvm")
    _write(path, ["# header", "1 1:0.5 3:2", "", "0 2:1 # tail"])
    t = tm.load_libsvm_file(path, dense=False)
    _same_csr(t, jm.load_libsvm_file(path, dense=False))
    np.testing.assert_array_equal(tm.load_libsvm_file(path)[0],
                                  [[0.5, 0, 2], [0, 1, 0]])


@pytest.mark.parametrize("lines,err,match", [
    (["1 2:1 2:3"], ValueError, "duplicate feature index 2 on data line 1"),
    (["1 0:1"], ValueError, "invalid 0 index"),
])
def test_libsvm_errors_match_jax(tmp_path, lines, err, match):
    path = str(tmp_path / "bad.libsvm")
    _write(path, lines)
    for mod in (jm, tm):
        with pytest.raises(err, match=match):
            mod.load_libsvm_file(path)


def test_libsvm_out_of_range_feature_raises(tmp_path):
    path = str(tmp_path / "wide.libsvm")
    _write(path, ["1 1:1 9:2"])
    with pytest.raises(IndexError):
        jm.load_libsvm_file(path, num_features=5)
    with pytest.raises(IndexError):
        tm.load_libsvm_file(path, num_features=5)
    with pytest.raises(IndexError, match="out of range"):
        ts.load_libsvm_file_csr(path, num_features=5)
    with pytest.raises(FileNotFoundError):
        tm.load_libsvm_file(str(tmp_path / "missing*"))


@pytest.mark.parametrize("sparse", [False, True])
def test_save_load_round_trip(tmp_path, sparse):
    X, y = _data(seed=1)
    Xin = torch.from_numpy(X).to_sparse_csr() if sparse else X
    path = str(tmp_path / "rt.libsvm")
    tm.save_as_libsvm_file(path, Xin, y)
    jpath = str(tmp_path / "rt_jax.libsvm")
    jm.save_as_libsvm_file(jpath, X, y)
    with open(path) as a, open(jpath) as b:
        assert a.read() == b.read()
    Xl, yl = tm.load_libsvm_file(path)
    np.testing.assert_array_equal(Xl, X)
    np.testing.assert_array_equal(yl, y)
    out = str(tmp_path / "parts")
    tm.save_as_libsvm_file(out, Xin, y, num_partitions=4)
    assert sorted(os.listdir(out)) == ["_SUCCESS"] + [
        f"part-{p:05d}" for p in range(4)]
    np.testing.assert_array_equal(tm.load_libsvm_file(out)[0], X)
    with pytest.raises(FileExistsError):
        tm.save_as_libsvm_file(out, Xin, y, num_partitions=2)


def test_labeled_points_round_trip(tmp_path):
    pts = [tst.LabeledPoint(1.0, np.asarray([0.5, 0.0, 2.0], np.float32)),
           tst.LabeledPoint(0.0, tl.SparseVector(3, [2], [4.0]))]
    path = str(tmp_path / "pts")
    tm.save_labeled_points(path, pts, num_partitions=2)
    jpts = jm.load_labeled_points(path)
    tpts = tm.load_labeled_points(path)
    assert [p.label for p in tpts] == [p.label for p in jpts]
    np.testing.assert_array_equal(tpts[0].features, jpts[0].features)
    assert isinstance(tpts[1].features, tl.SparseVector)
    np.testing.assert_array_equal(tpts[1].features.to_array(),
                                  jpts[1].features.to_array())


def _csr_triple(X):
    rows, cols = np.nonzero(X)
    indptr = np.concatenate([[0], np.cumsum((X != 0).sum(axis=1))])
    return X[rows, cols], cols, indptr


@pytest.mark.parametrize("sparse", [False, True])
def test_k_fold_rows_match_jax(sparse):
    X, y = _data(n=23, seed=2)
    if sparse:
        tX = ts.csr_from_triple(_csr_triple(X), X.shape[1])
        jX = js.csr_to_bcoo(_csr_triple(X), X.shape[1])
    else:
        tX = jX = X
    tfolds = list(tm.k_fold(tX, y, 4, seed=3))
    jfolds = list(jm.k_fold(jX, y, 4, seed=3))
    assert len(tfolds) == len(jfolds) == 4
    for (ttr, tva), (jtr, jva) in zip(tfolds, jfolds):
        for (ta, tb), (ja, jb) in ((ttr, jtr), (tva, jva)):
            np.testing.assert_array_equal(tb, jb)
            if sparse:
                for u, v in zip(ts.host_entries(ta), js.host_entries(ja)):
                    np.testing.assert_array_equal(u, np.asarray(v))
            else:
                np.testing.assert_array_equal(ta, ja)
    with pytest.raises(ValueError, match="num_folds"):
        list(tm.k_fold(tX, y, 1))


@pytest.mark.parametrize("sparse", [False, True])
def test_train_test_split_rows_match_jax(sparse):
    X, y = _data(n=31, seed=4)
    tX = torch.from_numpy(X).to_sparse_csr() if sparse else X
    (ttr, tytr), (tte, tyte) = tm.train_test_split(tX, y, 0.3, seed=5)
    (jtr, jytr), (jte, jyte) = jm.train_test_split(X, y, 0.3, seed=5)
    np.testing.assert_array_equal(tytr, jytr)
    np.testing.assert_array_equal(tyte, jyte)
    dense = (lambda a: a.to_dense().numpy()) if sparse else np.asarray
    np.testing.assert_array_equal(dense(ttr), jtr)
    np.testing.assert_array_equal(dense(tte), jte)
    # dense tensors split like arrays
    (a, _), _ = tm.train_test_split(torch.from_numpy(X), y, 0.3, seed=5)
    np.testing.assert_array_equal(a.numpy(), jtr)


def test_take_rows_bounds_check_on_dense():
    X, _ = _data(n=5)
    with pytest.raises(IndexError, match="row indices"):
        tm._take_rows(X, [-1])
    with pytest.raises(IndexError, match="row indices"):
        tm._take_rows(torch.from_numpy(X), [5])


def test_rcv1_like_data_matches_jax():
    jX, jy, jw = jm.rcv1_like_data(300, d=700, nnz_per_row=30, seed=6)
    tX, ty, tw = tm.rcv1_like_data(300, d=700, nnz_per_row=30, seed=6)
    assert tX.layout == torch.sparse_csr and tX.shape == (300, 700)
    for u, v in zip(ts.host_entries(tX), js.host_entries(jX)):
        np.testing.assert_array_equal(u, np.asarray(v))
    np.testing.assert_array_equal(ty, np.asarray(jy))
    np.testing.assert_array_equal(tw, np.asarray(jw))
    # unit-length rows of 30 distinct columns
    crow = tX.crow_indices().numpy()
    assert np.all(np.diff(crow) == 30)
    norms = np.sqrt(np.add.reduceat(tX.values().numpy() ** 2, crow[:-1]))
    np.testing.assert_allclose(norms, 1.0, rtol=1e-5)


def test_append_bias_matches_jax():
    X, _ = _data(n=6)
    np.testing.assert_array_equal(tm.append_bias(X), jm.append_bias(X))
    t = tm.append_bias(torch.from_numpy(X))
    assert isinstance(t, torch.Tensor) and t.shape == (6, 16)
    assert tm.append_bias(np.ones((2, 1), np.int32)).dtype == np.float32


@pytest.mark.parametrize("text", [
    "[1.0,2.5,-3]", "[]", "(5,[0,3],[1.5,-2.0])", "(4,[],[])",
])
def test_vectors_parse_matches_jax(text):
    t, j = tl.Vectors.parse(text), jl.Vectors.parse(text)
    assert type(t).__name__ == type(j).__name__
    np.testing.assert_array_equal(t.to_array(), j.to_array())


@pytest.mark.parametrize("text", [
    "[1.0,x]", "(3,[0,1],[1.0])", "(3,[5],[1.0])", "{1}", "[1,2",
])
def test_vectors_parse_rejects_what_jax_rejects(text):
    with pytest.raises(ValueError):
        jl.Vectors.parse(text)
    with pytest.raises(ValueError):
        tl.Vectors.parse(text)


def test_blas_and_vectors_match_jax():
    a, b = [1.0, 0.0, 2.0], tl.Vectors.sparse(3, [2], [4.0])
    jb = jl.Vectors.sparse(3, [2], [4.0])
    assert tl.BLAS.dot(a, b) == jl.BLAS.dot(a, jb) == 8.0
    acc = np.zeros(3, np.float32)
    np.testing.assert_array_equal(tl.BLAS.axpy(2.0, b, acc), [0, 0, 8])
    np.testing.assert_array_equal(tl.BLAS.scal(0.5, acc), [0, 0, 4])
    assert tl.Vectors.dense(1, 2) == tl.Vectors.dense([1.0, 2.0])
    assert tl.Vectors.zeros(2) == tl.Vectors.sparse(2, [], [])
    assert repr(b) == repr(jb)


@pytest.mark.parametrize("text", [
    "(1.5,[2.0,3.0])", "(1.0,2.0,3.0)", "0 1 2",
    "(1.0,(5,[0,3],[1.5,-2.0]))",
])
def test_labeled_point_parse_matches_jax(text):
    t, j = tst.LabeledPoint.parse(text), JLP.parse(text)
    assert t.label == j.label
    assert type(t.features).__name__ == type(j.features).__name__
    tf = getattr(t.features, "to_array", lambda: t.features)()
    jf = getattr(j.features, "to_array", lambda: j.features)()
    np.testing.assert_array_equal(tf, jf)

"""The port's compressed wire and host-streamed sparse feed
(``tpu_sgd_torch/io/sparse_wire.py``, ``optimize/streamed_sparse.py``), and
the CSR kernel's plain twin and shape rule (``ops/cuda_kernels.py``), on
the CPU: the twins of ``tests/test_sparse_wire.py``.

Against the JAX package, exact: the spec parser, ``topk_nnz``, the
selection, ``ErrorFeedback`` (accumulator, segments, checkpoint state),
the CSR row gather, the staged components (CSR here against BCOO there),
``plan_sparse_batches`` and the driver's ``nse_cap``.  The device top-k
(``topk_indices``) against ``ErrorFeedback`` step by step.  Trajectories
against the JAX package's sparse streamed run: loss history rtol 1e-4 (the
same samples).  Within the port, bitwise: prefetch A/B and K = 4 against
K = 1 (the pin of ``tests/test_sparse_wire.py:378``), resume and fault
heal (``:449``).  The feed never makes a dense ``(rows, d)`` tensor, and
its wire ships at least 10x fewer bytes than dense f32.
"""

import numpy as np
import pytest
import torch

import tpu_sgd.io.sparse_wire as jsw
from tpu_sgd.ops.gradients import HingeGradient as JHinge
from tpu_sgd.ops.sparse import sparse_data as jsparse_data
from tpu_sgd.optimize.gradient_descent import GradientDescent as JGD
from tpu_sgd_torch.io import sparse_wire as tsw
from tpu_sgd_torch.obs import counters
from tpu_sgd_torch.ops import cuda_kernels as ck
from tpu_sgd_torch.ops.gradients import HingeGradient
from tpu_sgd_torch.ops.sparse import csr_from_triple, sparse_data
from tpu_sgd_torch.optimize import streamed_sparse as tss
from tpu_sgd_torch.optimize.gradient_descent import GradientDescent
from tpu_sgd_torch.reliability import (FaultInjected, RetryPolicy,
                                       corrupt_nth, fail_nth, inject_faults)
from tpu_sgd_torch.reliability import failpoints as fp
from tpu_sgd_torch.utils.checkpoint import CheckpointManager

CPU = "cpu"


# -- wire-format primitives ---------------------------------------------------

@pytest.mark.parametrize("spec", [None, "topk:0.01", "topk:1", "topk",
                                  "topk:", "topk:0", "topk:1.5", "gzip:9",
                                  0.5])
def test_parse_wire_compress_equals_the_jax_parser(spec):
    try:
        want = jsw.parse_wire_compress(spec)
    except ValueError:
        with pytest.raises(ValueError):
            tsw.parse_wire_compress(spec)
        return
    assert tsw.parse_wire_compress(spec) == want


@pytest.mark.parametrize("dim,frac", [(100, 0.01), (1000, 0.013), (10, 1.0),
                                      (47_236, 0.01), (7, 1e-6)])
def test_topk_nnz_equals_the_jax_rule(dim, frac):
    assert tsw.topk_nnz(dim, frac) == jsw.topk_nnz(dim, frac)


def test_topk_select_and_the_device_selection():
    v = np.array([0.1, -5.0, 2.0, 0.0, -3.0], np.float32)
    assert set(tsw.topk_select(v, 2).tolist()) == set(
        jsw.topk_select(v, 2).tolist()) == {1, 4}
    assert set(tsw.topk_select(v, 99).tolist()) == set(range(5))
    got = tsw.topk_indices(torch.from_numpy(v), 2)
    assert got.tolist() == [1, 4]
    # ties go to the lower index, every call alike
    t = torch.tensor([1.0, -2.0, 2.0, 0.5, -2.0, 2.0])
    assert tsw.topk_indices(t, 2).tolist() == [1, 2]
    assert tsw.topk_indices(t, 4).tolist() == [1, 2, 4, 5]


def test_error_feedback_equals_the_jax_class(rng):
    a, b = tsw.ErrorFeedback(32, 0.125), jsw.ErrorFeedback(32, 0.125)
    assert a.k == b.k == 4
    for _ in range(7):
        u = rng.normal(size=32).astype(np.float32)
        ia, va = a.compress(u)
        ib, vb = b.compress(u)
        assert set(ia.tolist()) == set(ib.tolist())
        np.testing.assert_array_equal(va[np.argsort(ia)], vb[np.argsort(ib)])
        np.testing.assert_array_equal(a.acc, b.acc)
    np.testing.assert_array_equal(a.state(), b.state())
    c = tsw.ErrorFeedback(32, 0.125)
    c.load_state(b.state())
    np.testing.assert_array_equal(c.acc, b.acc)
    with pytest.raises(ValueError):
        c.load_state(np.zeros(31))
    with pytest.raises(ValueError):
        a.compress(np.zeros(31, np.float32))


def test_device_topk_update_equals_error_feedback(rng):
    """The compressed step's selection on the accumulator (the device
    rule) ships exactly what ``ErrorFeedback`` ships, and keeps the same
    remainder, update after update."""
    ef = jsw.ErrorFeedback(40, 0.1)
    acc = torch.zeros(40)
    for _ in range(9):
        u = rng.normal(size=40).astype(np.float32)
        idx, vals = ef.compress(u)
        folded = acc + torch.from_numpy(u)
        sel = tsw.topk_indices(folded, ef.k)
        assert set(sel.tolist()) == set(idx.tolist())
        np.testing.assert_array_equal(
            np.sort(folded[sel].numpy()), np.sort(vals))
        acc = folded.clone()
        acc[sel] = 0.0
        np.testing.assert_array_equal(acc.numpy(), ef.acc)


def test_csr_gather_and_staged_components_equal_the_jax_staging():
    Xj, _, _ = jsparse_data(50, 40, nnz_per_row=5, seed=1)
    indptr, cols, vals, (n, d) = jsw.bcoo_to_csr_host(Xj)
    X, _, _ = sparse_data(50, 40, nnz_per_row=5, seed=1)
    tp, tc, tv, shape = tsw.csr_host(X)
    assert shape == (n, d)
    np.testing.assert_array_equal(tp, indptr)
    np.testing.assert_array_equal(tc, cols)
    np.testing.assert_array_equal(tv, vals)
    rows = np.array([7, 3, 7, 0])
    for got, ref in zip(tsw.gather_csr_rows(tp, tc, tv, rows),
                        jsw.gather_csr_rows(indptr, cols, vals, rows)):
        np.testing.assert_array_equal(got, ref)
    data, idx, valid_j = jsw.stage_sparse_batch(indptr, cols, vals, rows,
                                                row_cap=6, nse_cap=24)
    crow, col, val, valid = tsw.stage_sparse_batch(tp, tc, tv, rows, 6, 24)
    assert crow.shape == (7,) and col.shape == val.shape == (24,)
    np.testing.assert_array_equal(valid.numpy(), valid_j)
    nse = 20
    np.testing.assert_array_equal(val[:nse].numpy(), data[:nse])
    np.testing.assert_array_equal(col[:nse].numpy(), idx[:nse, 1])
    row_of = np.repeat(np.arange(6), np.diff(crow.numpy()))
    np.testing.assert_array_equal(row_of[:nse], idx[:nse, 0])
    # padding: zero values at the end of the last row, column 0
    assert np.all(val[nse:].numpy() == 0) and np.all(col[nse:].numpy() == 0)
    assert crow[-1] == 24 and np.all(row_of[nse:] == 5)
    dense = torch.sparse_csr_tensor(crow, col, val, (6, 40)).to_dense()
    ref = np.zeros((6, 40), np.float32)
    np.add.at(ref, (idx[:, 0], idx[:, 1]), data)
    np.testing.assert_array_equal(dense.numpy(), ref)
    with pytest.raises(ValueError, match="capped nse"):
        tsw.stage_sparse_batch(tp, tc, tv, rows, 6, 8)
    with inject_faults({"io.sparse_wire": fail_nth(1)}):
        with pytest.raises(FaultInjected):
            tsw.stage_sparse_batch(tp, tc, tv, rows, 6, 24)


def test_plan_sparse_batches_equals_the_jax_plan():
    X, _, _ = sparse_data(120, 60, nnz_per_row=4, seed=2)
    indptr = tsw.csr_host(X)[0]
    rows = [np.random.default_rng(100 + i).choice(120, size=9,
                                                  replace=False)
            for i in range(1, 13)]
    assert tsw.plan_sparse_batches(indptr, lambda i: rows[i - 1], 12, 9) \
        == jsw.plan_sparse_batches(indptr, lambda i: rows[i - 1], 12, 9)


# -- the streamed sparse driver ------------------------------------------------

def _problem(n=400, d=600, seed=5):
    return sparse_data(n, d, nnz_per_row=8, kind="svm", seed=seed)[:2]


def _jproblem(n=400, d=600, seed=5):
    return jsparse_data(n, d, nnz_per_row=8, kind="svm", seed=seed)[:2]


def _opt(iters=20, k=1, frac=0.3, depth=2, c=0):
    o = (GradientDescent(HingeGradient(), device=CPU)
         .set_num_iterations(iters).set_step_size(0.2)
         .set_mini_batch_fraction(frac).set_convergence_tol(0.0)
         .set_seed(11).set_host_streaming(True)
         .set_ingest_options(prefetch_depth=depth).set_superstep(k))
    if c:
        o.set_residency(c)
    return o


def _jopt(iters=20, k=1, frac=0.3):
    o = (JGD(gradient=JHinge())
         .set_num_iterations(iters).set_step_size(0.2)
         .set_mini_batch_fraction(frac).set_convergence_tol(0.0)
         .set_seed(11).set_host_streaming(True))
    if k > 1:
        o.set_superstep(k)
    return o


def _w0(d=600):
    return np.zeros(d, np.float32)


def _eq(a, b):
    np.testing.assert_array_equal(np.asarray(a[0]), np.asarray(b[0]))
    np.testing.assert_array_equal(a[1], b[1])


def test_nse_cap_and_staged_batches_equal_the_jax_driver(monkeypatch):
    import tpu_sgd.io.sparse_wire as jmod

    caps, staged = {}, {"jax": [], "port": []}
    jplan, tplan = jmod.plan_sparse_batches, tss.plan_sparse_batches
    jstage, tstage = jmod.stage_sparse_batch, tss.stage_sparse_batch

    def rec_plan(name, fn):
        def wrapped(*a, **kw):
            caps[name] = fn(*a, **kw)
            return caps[name]
        return wrapped

    def rec_jstage(indptr, cols, vals, rows, row_cap, nse_cap):
        out = jstage(indptr, cols, vals, rows, row_cap, nse_cap)
        staged["jax"].append((np.asarray(rows).copy(), row_cap, out))
        return out

    def rec_tstage(indptr, cols, vals, rows, row_cap, nse_cap, out=None):
        got = tstage(indptr, cols, vals, rows, row_cap, nse_cap, out=out)
        staged["port"].append((np.asarray(rows).copy(), row_cap,
                               tuple(t.clone() for t in got)))
        return got

    monkeypatch.setattr(jmod, "plan_sparse_batches", rec_plan("jax", jplan))
    monkeypatch.setattr(jmod, "stage_sparse_batch", rec_jstage)
    monkeypatch.setattr(tss, "plan_sparse_batches", rec_plan("port", tplan))
    monkeypatch.setattr(tss, "stage_sparse_batch", rec_tstage)
    Xj, yj = _jproblem()
    X, y = _problem()
    _jopt(iters=6).optimize_with_history((Xj, yj), _w0())
    _opt(iters=6, depth=0).optimize_with_history((X, y), _w0())
    assert caps["jax"] == caps["port"]
    assert len(staged["jax"]) == len(staged["port"]) == 6
    for (rj, capj, (data, idx, vj)), (rt, capt, (crow, col, val, vt)) in \
            zip(staged["jax"], staged["port"]):
        np.testing.assert_array_equal(rj, rt)
        assert capj == capt
        np.testing.assert_array_equal(vt.numpy(), vj)
        nse = int(crow[rt.shape[0]])
        np.testing.assert_array_equal(val[:nse].numpy(), data[:nse])
        np.testing.assert_array_equal(col[:nse].numpy(), idx[:nse, 1])


@pytest.mark.parametrize("k,frac", [(1, 0.3), (4, 0.3), (1, 1.0)])
def test_sparse_streamed_history_matches_the_jax_run(k, frac):
    X, y = _problem()
    Xj, yj = _jproblem()
    w, h = _opt(iters=16, k=k, frac=frac).optimize_with_history((X, y),
                                                                 _w0())
    wj, hj = _jopt(iters=16, k=k, frac=frac).optimize_with_history((Xj, yj),
                                                                   _w0())
    assert len(h) == len(hj) == 16
    np.testing.assert_allclose(h, hj, rtol=1e-4)
    np.testing.assert_allclose(w.numpy(), np.asarray(wj), rtol=2e-4,
                               atol=2e-3)


def test_sparse_streamed_matches_dense_streamed():
    X, y = _problem()
    w_sp, h_sp = _opt().optimize_with_history((X, y), _w0())
    w_d, h_d = _opt().optimize_with_history((X.to_dense().numpy(), y), _w0())
    np.testing.assert_allclose(h_sp, h_d, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(w_sp.numpy(), w_d.numpy(), rtol=1e-4,
                               atol=1e-5)


def test_sparse_streamed_prefetch_ab_and_superstep_bitwise():
    X, y = _problem(seed=6)
    a = _opt().optimize_with_history((X, y), _w0())
    _eq(a, _opt(depth=0).optimize_with_history((X, y), _w0()))
    b = _opt(iters=18, k=4).optimize_with_history((X, y), _w0())
    assert len(b[1]) == 18
    _eq(b, _opt(iters=18, k=1).optimize_with_history((X, y), _w0()))
    _eq(b, _opt(iters=18, k=4).optimize_with_history((X, y), _w0()))


def test_sparse_streamed_resume_and_failpoint_heal_bitwise(tmp_path):
    X, y = _problem(seed=9)
    ref = _opt(iters=16, k=4).optimize_with_history((X, y), _w0())
    ckdir = str(tmp_path / "ck")
    o = _opt(iters=16, k=4)
    o.set_checkpoint(CheckpointManager(ckdir), every=4)
    with inject_faults({"io.sparse_wire": fail_nth(10)}):
        with pytest.raises(FaultInjected):
            o.optimize_with_history((X, y), _w0())
    o2 = _opt(iters=16, k=4)
    o2.set_checkpoint(CheckpointManager(ckdir), every=4)
    _eq(ref, o2.optimize_with_history((X, y), _w0()))
    o3 = _opt(iters=16, k=4)
    o3.set_ingest_options(retry=RetryPolicy(max_attempts=3,
                                            base_backoff_s=0.0))
    with inject_faults({"io.sparse_wire": fail_nth(5),
                        "io.sparse_chunk": corrupt_nth(2)}):
        got = o3.optimize_with_history((X, y), _w0())
        assert fp.triggers("io.sparse_wire") == 1
        assert fp.triggers("io.sparse_chunk") == 1
    _eq(ref, got)


def test_sparse_streamed_never_densifies_and_10x_wire_bytes(monkeypatch):
    X, y = _problem(seed=8)

    def boom(*a, **kw):  # pragma: no cover - the pin
        raise AssertionError("dense chunk materialized on the sparse path")

    monkeypatch.setattr(torch.Tensor, "to_dense", boom)
    counters.enable()
    try:
        counters.reset()
        _, h = _opt(iters=12, k=4).optimize_with_history((X, y), _w0())
        snap = counters.snapshot()
    finally:
        counters.disable()
        counters.reset()
    assert len(h) == 12
    ratios = counters.wire_ratios(snap)
    csr = [r for name, r in ratios.items() if name.endswith(".csr")]
    assert csr and csr[0]["n"] == 3
    assert csr[0]["ratio"] >= 10.0


def test_sparse_streamed_full_batch_residency_and_guards():
    X, y = _problem(n=120, d=200, seed=10)
    a = _opt(iters=6, frac=1.0).optimize_with_history((X, y), _w0(200))
    _eq(a, _opt(iters=6, k=3, frac=1.0).optimize_with_history((X, y),
                                                               _w0(200)))
    _eq(a, _opt(iters=6, k=3, c=2, frac=1.0).optimize_with_history(
        (X, y), _w0(200)))
    with pytest.raises(NotImplementedError, match="bernoulli"):
        _opt().set_sampling("sliced").optimize_with_history((X, y),
                                                            _w0(200))
    o = _opt(iters=4)
    o.set_ingest_options(wire_compress="topk:0.5")
    with pytest.warns(RuntimeWarning, match="already compressed"):
        o.optimize_with_history((X, y), _w0(200))
    o = _opt(iters=4).set_ingest_options(wire_dtype="bfloat16")
    with pytest.warns(RuntimeWarning, match="CSR components"):
        o.optimize_with_history((X, y), _w0(200))
    with pytest.warns(RuntimeWarning, match="superstep driver"):
        _opt(iters=4, k=2, c=2).optimize_with_history((X, y), _w0(200))
    with pytest.raises(NotImplementedError, match="resident_rows"):
        _opt(iters=4).set_host_streaming(True, resident_rows=10) \
            .optimize_with_history((X, y), _w0(200))


def test_predict_streamed_on_sparse_rows():
    from tpu_sgd_torch.models.classification import SVMModel

    X, _ = _problem(n=100, d=50)
    m = SVMModel(np.linspace(-1, 1, 50).astype(np.float32), 0.1,
                 device=CPU)
    np.testing.assert_array_equal(m.predict_streamed(X, 33),
                                  m.predict(X).numpy())


# -- the CSR kernel's plain twin and shape rule --------------------------------

def test_csr_products_plain_twin_equals_the_library_product(rng):
    X, _ = _problem(n=50, d=30)
    w = torch.from_numpy(rng.normal(size=30).astype(np.float32))
    mask = torch.from_numpy(rng.random(50) < 0.5)
    ck.reset_launch_counts()
    np.testing.assert_array_equal(ck.csr_margins(X, w).numpy(),
                                  (X @ w).numpy())
    got = ck.csr_margins(X, w, mask)
    assert torch.all(got[~mask] == 0)
    np.testing.assert_array_equal(got[mask].numpy(), (X @ w)[mask].numpy())
    W = torch.from_numpy(rng.normal(size=(30, 3)).astype(np.float32))
    np.testing.assert_array_equal(ck.csr_margins(X, W).numpy(),
                                  (X @ W).numpy())
    coeff = torch.from_numpy(rng.normal(size=50).astype(np.float32))
    Xt = X.to_dense().T.contiguous().to_sparse_csr()
    np.testing.assert_allclose(ck.csr_grad_sum(Xt, coeff).numpy(),
                               (X.to_dense().T @ coeff).numpy(), rtol=1e-6,
                               atol=1e-6)
    assert ck.csr_launch_counts() == {"csr_margins": 0, "csr_grad_sum": 0}


@pytest.mark.parametrize("case", ["coo", "bf16_values", "mixed_index",
                                  "rhs_rows", "rhs_3d", "too_wide",
                                  "mask_dtype", "mask_length"])
def test_csr_kernel_shape_rule_raises_outside_it(case):
    X = csr_from_triple((np.ones(4, np.float32), np.array([0, 1, 2, 3]),
                         np.array([0, 2, 4])), 5)
    rhs, mask = torch.ones(5), None
    if case == "coo":
        X = X.to_sparse_coo()
    elif case == "bf16_values":
        X = torch.sparse_csr_tensor(X.crow_indices(), X.col_indices(),
                                    X.values().bfloat16(), X.shape)
    elif case == "mixed_index":
        X = torch.sparse_csr_tensor(X.crow_indices().long(),
                                    X.col_indices().int(), X.values(),
                                    X.shape, check_invariants=False)
    elif case == "rhs_rows":
        rhs = torch.ones(4)
    elif case == "rhs_3d":
        rhs = torch.ones(5, 1, 1)
    elif case == "too_wide":
        rhs = torch.ones(5, ck.CSR_MAX_COLUMNS + 1)
    elif case == "mask_dtype":
        mask = torch.ones(2, dtype=torch.int32)
    else:
        mask = torch.ones(3, dtype=torch.bool)
    with pytest.raises((ValueError, TypeError)):
        ck._csr_operands(X, rhs, mask)


def test_csr_kernel_shape_rule_takes_the_main_paths_operands():
    X, _ = _problem(n=20, d=30)
    assert X.crow_indices().dtype == torch.int32
    _, _, vals, rhs, T = ck._csr_operands(X, torch.ones(30, dtype=torch.float64),
                                          torch.ones(20, dtype=torch.bool))
    assert T == 1 and rhs.dtype == torch.float32
    assert ck._csr_operands(X, torch.ones(30, 25), None)[4] == 25


# ---- the SparCML merge (tests/test_store_shard.py:123, :145) ----------------

@pytest.mark.parametrize("crossover", [0.0, 0.05, 0.25, 1.0])
def test_merge_sparse_segments_matches_dense_reference(crossover):
    """An exact sparse sum at every density crossover (the crossover
    changes where the sum densifies, never the result): against the
    float64 sum at the reference test's bound, and bitwise the JAX
    package's merge of the same segments (the same host numpy)."""
    rng = np.random.default_rng(0)
    dim = 200
    segs = []
    for _ in range(7):
        k = int(rng.integers(1, 40))
        idx = rng.choice(dim, size=k, replace=False).astype(np.int32)
        segs.append((idx, rng.normal(size=k).astype(np.float32)))
    ref = np.zeros(dim, np.float64)
    for i, v in segs:
        np.add.at(ref, i, v.astype(np.float64))
    out = tsw.merge_sparse_segments(segs, dim, crossover)
    assert out.dtype == np.float32 and out.shape == (dim,)
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(
        out, jsw.merge_sparse_segments(segs, dim, crossover))


def test_merge_sparse_segments_dedups_and_handles_empties():
    """Duplicate coordinates within and across segments add; no segment
    gives zeros; an empty segment drops out."""
    out = tsw.merge_sparse_segments(
        [(np.asarray([3, 3, 1], np.int32),
          np.asarray([1.0, 2.0, 4.0], np.float32)),
         (np.asarray([3], np.int32), np.asarray([8.0], np.float32))],
        dim=5, density_crossover=0.25)
    np.testing.assert_array_equal(out, np.asarray([0, 4, 0, 11, 0],
                                                  np.float32))
    np.testing.assert_array_equal(
        tsw.merge_sparse_segments([], dim=3, density_crossover=0.25),
        np.zeros(3, np.float32))
    out = tsw.merge_sparse_segments(
        [(np.asarray([], np.int32), np.asarray([], np.float32)),
         (np.asarray([2], np.int32), np.asarray([5.0], np.float32))],
        dim=3, density_crossover=1.0)
    np.testing.assert_array_equal(out, np.asarray([0, 0, 5.0], np.float32))
    # the pair merge is the JAX package's, bitwise
    a = (np.asarray([4, 1, 4], np.int64), np.asarray([0.1, 0.2, 0.3],
                                                     np.float32))
    b = (np.asarray([1, 9], np.int64), np.asarray([0.4, 0.5], np.float32))
    for got, want in zip(tsw._merge_pair(a, b), jsw._merge_pair(a, b)):
        np.testing.assert_array_equal(got, want)

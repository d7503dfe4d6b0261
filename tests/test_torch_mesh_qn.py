"""Parity of the port's quasi-Newton and exact solvers on a data mesh
(``LBFGS.set_mesh``, ``OWLQN.set_mesh``, ``NormalEquations.set_mesh``,
``train(..., mesh=)``) with the JAX package's 8-device CPU mesh.

One gloo world of 8 CPU ranks (``tests/torch_mesh_qn_worker.py``, spawned
once for the module) runs every case on its rows; this process runs the
JAX references on ``tests/conftest.py``'s ``data_mesh()`` on the same
numpy inputs and, for the bitwise checks, the port's one-process
rank-order sums of the same 8 shards.  The twins of
``tests/test_lbfgs.py:72, 94, 101, 153, 217``, ``tests/test_owlqn.py:99``,
``tests/test_normal.py:38`` and ``tests/test_sparse.py:262, 276, 576``.

Tolerances: history lengths exact; full-batch runs at the per-step tier,
history rtol 2e-4 (the reference tests' 1e-4 where they hold the meshed
history to one device's) and weights rtol 2e-4 / atol 2e-3, or the
reference test's own bound where it is tighter; the runs the reference
holds only by their last loss (sparse OWL-QN and multinomial) by that
loss.  Within the port, bitwise: every rank's weights, meshed L-BFGS and
the normal equations against their one-process rank-order references.
"""

import glob
import os
import shutil
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import tpu_sgd as jt
from tpu_sgd.ops.sparse import sparse_data
from tpu_sgd.parallel.mesh import data_mesh as jdata_mesh
from tpu_sgd.utils import linear_data, logistic_data
import tpu_sgd_torch as tst
from tpu_sgd_torch import parallel as par
from tpu_sgd_torch.optimize import normal as tn

WORLD = 8
_HERE = os.path.dirname(os.path.abspath(__file__))
_WORKER = os.path.join(_HERE, "torch_mesh_qn_worker.py")
ROOT = os.path.dirname(_HERE)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _csr_parts(X):
    """CSR components of a row-sorted BCOO matrix."""
    idx = np.asarray(X.indices)
    n = X.shape[0]
    crow = np.concatenate([[0], np.cumsum(np.bincount(idx[:, 0],
                                                      minlength=n))])
    return dict(crow=crow.astype(np.int64), col=idx[:, 1].astype(np.int64),
                val=np.asarray(X.data, np.float32),
                shape=np.array(X.shape))


def _multiclass():
    rng = np.random.default_rng(7)
    n, d, k = 1200, 6, 3
    W = rng.normal(size=(k - 1, d)).astype(np.float32)
    X = rng.normal(size=(n, d)).astype(np.float32)
    logits = np.concatenate([np.zeros((n, 1)), X @ W.T], axis=1)
    return X, logits.argmax(axis=1).astype(np.float32)


def _inputs():
    d, jx = {}, {}
    for n in (4000, 4001):
        X, y, _ = logistic_data(n, 8, seed=5)
        d[f"lb{n}_X"], d[f"lb{n}_y"] = np.asarray(X), np.asarray(y)
    d["lbmc_X"], d["lbmc_y"] = _multiclass()
    for n, seed in ((4096, 3), (4100, 3)):
        X, y, _ = linear_data(n, 10, seed=seed)
        d[f"lbgs{n}_X"], d[f"lbgs{n}_y"] = np.asarray(X), np.asarray(y)
    X, y, _ = linear_data(2048, 8, seed=5)
    d["owgs_X"], d["owgs_y"] = np.asarray(X), np.asarray(y)
    for n in (3000, 3001):
        X, y, _ = linear_data(n, 10, eps=0.05, seed=6)
        d[f"ow{n}_X"], d[f"ow{n}_y"] = np.asarray(X), np.asarray(y)
    X, y, _ = linear_data(4099, 10, eps=0.2, seed=2)
    d["ne_X"], d["ne_y"] = np.asarray(X), np.asarray(y)
    for name, args, kw in (
            ("splb", (1003, 80), dict(nnz_per_row=9, kind="linear", seed=3)),
            ("spow", (960, 40), dict(nnz_per_row=10, kind="logistic",
                                     seed=11)),
            ("spmc", (640, 24), dict(nnz_per_row=6, kind="linear",
                                     seed=37))):
        X, y, _ = sparse_data(*args, **kw)
        y = np.asarray(y)
        if name == "spmc":
            y = ((y > -0.5).astype(np.float32)
                 + (y > 0.5).astype(np.float32))
        jx[name] = X
        d.update({f"{name}_{k}": v for k, v in _csr_parts(X).items()})
        d[name + "_y"] = y
    return d, jx


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The inputs (and the JAX package's BCOO matrices), and every rank's
    outputs from one 8-rank gloo job (retried on a fresh port if its
    launch fails)."""
    tmp = tmp_path_factory.mktemp("torch_mesh_qn")
    inp, jx = _inputs()
    np.savez(tmp / "inputs.npz", **inp)
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    logs = []
    for _ in range(3):
        for d in glob.glob(str(tmp / "*")):
            if os.path.isdir(d):
                shutil.rmtree(d)
        port = _free_port()
        procs = [subprocess.Popen(
            [sys.executable, _WORKER, str(r), str(WORLD), str(port),
             str(tmp)], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for r in range(WORLD)]
        logs = []
        for p in procs:
            try:
                logs.append(p.communicate(timeout=240)[0])
            except subprocess.TimeoutExpired:
                for q in procs:
                    q.kill()
                pytest.fail("a rank of the gloo world timed out (>240 s)")
        if all(p.returncode == 0 for p in procs):
            outs = [dict(np.load(tmp / f"out{r}.npz")) for r in range(WORLD)]
            return inp, jx, outs
    for r, text in enumerate(logs):
        print(f"--- rank {r} ---\n{text[-3000:]}")
    pytest.fail("the 8-rank gloo world failed on 3 ports; see the logs")


def _close(got, ref, rtol=2e-4, atol=2e-3):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=rtol,
                               atol=atol)


def _jrun(opt, X, y, d):
    return opt.set_mesh(jdata_mesh()).optimize_with_history(
        (X, y), np.zeros(d, np.float32))


# ---- the world ----------------------------------------------------------------

def test_every_rank_ran_in_one_world_and_imported_no_jax(world):
    _, _, outs = world
    for r, o in enumerate(outs):
        assert o["rank"].tolist() == [r, WORLD]
        assert o["leaked"].size == 0, o["leaked"]


def test_every_rank_holds_the_same_weights_bitwise(world):
    _, _, outs = world
    keys = [k for k in outs[0] if k.endswith(("_w", "_h", "_b"))]
    assert len(keys) > 25
    for k in keys:
        for o in outs[1:]:
            np.testing.assert_array_equal(o[k], outs[0][k], err_msg=k)


def test_a_rank_that_disagrees_stops_every_rank(world):
    _, _, outs = world
    for o in outs:
        assert "disagree on the quasi-Newton loop" in str(o["disagree"])


# ---- L-BFGS (test_lbfgs.py) ---------------------------------------------------

@pytest.mark.parametrize("n", [4000, 4001])
def test_meshed_lbfgs_matches_the_jax_mesh(world, n):
    """Even rank rows, and a padded last rank (its valid mask in B1)."""
    inp, _, outs = world
    jw, jh = _jrun(jt.LBFGS(jt.LogisticGradient(), jt.SquaredL2Updater(),
                            reg_param=0.01),
                   inp[f"lb{n}_X"], inp[f"lb{n}_y"], 8)
    h = outs[0][f"lb{n}_h"]
    assert len(h) == len(jh)
    np.testing.assert_allclose(h, jh, rtol=1e-4, atol=1e-6)
    _close(outs[0][f"lb{n}_w"], jw, atol=1e-4)


def one_process_lbfgs(X, y, reg=0.01):
    """Meshed L-BFGS's arithmetic in one process: each of the 8 shards'
    padded rows and valid mask, every cost and sweep's sums added in rank
    order (written out here), then the port's own iteration loop."""
    n, d = X.shape
    rows = -(-n // WORLD)
    g = tst.LogisticGradient()
    shards = []
    for s in range(WORLD):
        Xl, yl = par.local_rows(X, y, s, WORLD)
        Xp, yp = torch.zeros((rows, d)), torch.zeros((rows,))
        Xp[:len(Xl)], yp[:len(yl)] = torch.as_tensor(Xl), torch.as_tensor(yl)
        valid = None if n % WORLD == 0 else torch.arange(rows) < len(Xl)
        shards.append((Xp, yp, valid))

    def rank_order(parts):
        tot = parts[0]
        for p in parts[1:]:
            tot = tot + p
        return tot

    def cost1(w):
        parts = []
        for Xp, yp, valid in shards:
            gs, ls, cs = (g.batch_sums(Xp, yp, w) if valid is None
                          else g.batch_sums(Xp, yp, w, mask=valid))
            parts.append(torch.cat([gs, ls.reshape(1), cs.reshape(1)]))
        tot = rank_order(parts)
        return (tot[d] / tot[d + 1] + 0.5 * reg * torch.sum(w * w, dim=-1),
                tot[:d] / tot[d + 1] + reg * w)

    def sweep1(W):
        parts = []
        for Xp, yp, valid in shards:
            ls, cs = g.loss_sweep(Xp, yp, W, mask=valid)
            parts.append(torch.cat([ls, cs.reshape(1)]))
        tot = rank_order(parts)
        T = W.shape[0]
        return tot[:T] / tot[T] + 0.5 * reg * torch.sum(W * W, dim=-1)

    opt = tst.LBFGS(g, tst.SquaredL2Updater(), reg_param=reg, device="cpu")
    w, h = opt._qn_loop(torch.zeros(d), cost1, sweep1, None)
    return w.numpy(), h


@pytest.mark.parametrize("n", [4000, 4001])
def test_meshed_lbfgs_is_the_one_process_rank_order_sum(world, n):
    inp, _, outs = world
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        w, h = one_process_lbfgs(inp[f"lb{n}_X"], inp[f"lb{n}_y"])
    finally:
        torch.set_num_threads(before)
    np.testing.assert_array_equal(outs[0][f"lb{n}_w"], w)
    np.testing.assert_array_equal(outs[0][f"lb{n}_h"], h)


def test_meshed_multinomial_lbfgs_matches_the_jax_mesh(world):
    """Matrix weights through the same shape-generic combine."""
    inp, _, outs = world
    jw, jh = _jrun(jt.LBFGS(jt.MultinomialLogisticGradient(3),
                            jt.SquaredL2Updater(), reg_param=0.001,
                            max_num_iterations=30),
                   inp["lbmc_X"], inp["lbmc_y"], 12)
    assert len(outs[0]["lbmc_h"]) == len(jh)
    np.testing.assert_allclose(outs[0]["lbmc_h"], jh, rtol=2e-4)
    _close(outs[0]["lbmc_w"], jw, atol=1e-4)


@pytest.mark.parametrize("n", [4096, 4100])
def test_meshed_lbfgs_statistics_match_the_jax_mesh(world, n):
    """test_lbfgs.py:153: every rank's totals combined once, then the
    loop unmeshed from them; exact for any row count."""
    inp, _, outs = world
    jw, jh = (jt.LBFGS(jt.LeastSquaresGradient(), jt.SimpleUpdater(),
                       max_num_iterations=12, convergence_tol=0.0)
              .set_mesh(jdata_mesh()).set_sufficient_stats(True)
              .set_gram_options(block_rows=256)
              .optimize_with_history((inp[f"lbgs{n}_X"], inp[f"lbgs{n}_y"]),
                                     np.zeros(10, np.float32)))
    h = outs[0][f"lbgs{n}_h"]
    assert int(outs[0][f"lbgs{n}_n"]) == n
    L = min(len(h), len(jh))  # the reference's flat-loss note
    assert L >= 4
    np.testing.assert_allclose(h[:L], np.asarray(jh)[:L], rtol=1e-4,
                               atol=1e-6)
    _close(outs[0][f"lbgs{n}_w"], jw, rtol=1e-3, atol=1e-4)


def test_meshed_owlqn_statistics_match_the_jax_mesh(world):
    """test_lbfgs.py:217: Lasso least squares from the meshed totals."""
    inp, _, outs = world
    jw, jh = (jt.OWLQN(jt.LeastSquaresGradient(), max_num_iterations=10,
                       convergence_tol=0.0, reg_param=0.002)
              .set_mesh(jdata_mesh()).set_sufficient_stats(True)
              .optimize_with_history((inp["owgs_X"], inp["owgs_y"]),
                                     np.zeros(8, np.float32)))
    h = outs[0]["owgs_h"]
    L = min(len(h), len(jh))
    assert L >= 4
    np.testing.assert_allclose(h[:L], np.asarray(jh)[:L], rtol=1e-4,
                               atol=1e-6)
    _close(outs[0]["owgs_w"], jw, rtol=1e-3, atol=1e-4)


# ---- OWL-QN (test_owlqn.py:99) ------------------------------------------------

@pytest.mark.parametrize("n", [3000, 3001])
def test_meshed_owlqn_matches_the_jax_mesh(world, n):
    inp, _, outs = world
    jw, jh = _jrun(jt.OWLQN(jt.LeastSquaresGradient(), reg_param=0.05),
                   inp[f"ow{n}_X"], inp[f"ow{n}_y"], 10)
    w = outs[0][f"ow{n}_w"]
    assert len(outs[0][f"ow{n}_h"]) == len(jh)
    np.testing.assert_allclose(outs[0][f"ow{n}_h"], jh, rtol=2e-4)
    _close(w, jw, atol=1e-4)
    assert int(((w == 0) != (np.asarray(jw) == 0)).sum()) <= 1


# ---- sparse (test_sparse.py) --------------------------------------------------

def test_meshed_sparse_lbfgs_matches_the_jax_mesh(world):
    """test_sparse.py:262: each rank's CSR row block, the last padded
    with empty rows."""
    inp, jx, outs = world
    jw, jh = _jrun(jt.LBFGS(jt.LeastSquaresGradient(), max_num_iterations=25),
                   jx["splb"], inp["splb_y"], 80)
    h = outs[0]["splb_h"]
    assert len(h) == len(jh)
    np.testing.assert_allclose(h, jh, rtol=2e-4)
    _close(outs[0]["splb_w"], jw, rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("name,make,d", [
    ("spow", lambda: jt.OWLQN(jt.LogisticGradient(), reg_param=0.01,
                              max_num_iterations=30), 40),
    ("spmc", lambda: jt.LBFGS(jt.MultinomialLogisticGradient(3),
                              max_num_iterations=20), 48),
])
def test_meshed_sparse_owlqn_and_multinomial_reach_the_jax_loss(world, name,
                                                                make, d):
    """test_sparse.py:276 and :576, held by their last loss."""
    inp, jx, outs = world
    _, jh = _jrun(make(), jx[name], inp[name + "_y"], d)
    h = outs[0][name + "_h"]
    assert h[-1] < h[0]
    np.testing.assert_allclose(h[-1], jh[-1], rtol=1e-3)


# ---- the normal equations (test_normal.py:38) ---------------------------------

def test_meshed_normal_equations_match_the_jax_mesh(world):
    inp, _, outs = world
    jw = (jt.NormalEquations().set_mesh(jdata_mesh())
          .optimize((inp["ne_X"], inp["ne_y"]), np.zeros(10, np.float32)))
    _close(outs[0]["ne_w"], jw, rtol=1e-4, atol=1e-5)


def test_meshed_normal_equations_are_the_one_process_rank_order_sum(world):
    inp, _, outs = world
    parts = []
    for s in range(WORLD):
        Xl, yl = (torch.as_tensor(a) for a in par.local_rows(
            inp["ne_X"], inp["ne_y"], s, WORLD))
        A, b, yy = tn._gram_sums_wide(Xl, yl)
        parts.append(torch.cat([A.reshape(-1), b, yy.reshape(1),
                                torch.tensor([float(len(Xl))],
                                             dtype=torch.float64)]))
    tot = parts[0]
    for p in parts[1:]:
        tot = tot + p
    d = 10
    A = tot[:d * d].reshape(d, d).float()
    w, _ = tn._solve(A, tot[d * d:d * d + d].float(), tot[-2].float(),
                     tot[-1].float(), 0.0)
    np.testing.assert_array_equal(outs[0]["ne_w"], w.numpy())


# ---- train(..., mesh=) ----------------------------------------------------------

def test_train_with_mesh_for_lbfgs_and_normal_families(world):
    inp, _, outs = world
    o = outs[0]
    jm = jt.LogisticRegressionWithLBFGS.train(
        (inp["lb4001_X"], inp["lb4001_y"]), reg_param=0.01, intercept=True,
        mesh=jdata_mesh())
    _close(o["tr_log_w"], jm.weights, atol=1e-4)
    jm = jt.LinearRegressionWithLBFGS.train(
        (inp["lbgs4100_X"], inp["lbgs4100_y"]), max_num_iterations=12,
        mesh=jdata_mesh(), sufficient_stats=True)
    _close(o["tr_lin_w"], jm.weights, rtol=1e-3, atol=1e-4)
    jm = jt.LinearRegressionWithNormal.train(
        (inp["ne_X"], inp["ne_y"]), intercept=True, mesh=jdata_mesh())
    _close(o["tr_ne_w"], jm.weights, rtol=1e-4, atol=1e-5)
    _close(o["tr_ne_b"], jm.intercept, rtol=1e-4, atol=1e-5)


# ---- in-process, no process group ----------------------------------------------

def test_quasi_newton_set_mesh_takes_a_data_mesh_only():
    mesh = par.Mesh({par.DATA_AXIS: 2})
    two_d = par.Mesh({par.DATA_AXIS: 4, par.MODEL_AXIS: 2})
    for make in (lambda: tst.LBFGS(device="cpu"),
                 lambda: tst.OWLQN(device="cpu"),
                 lambda: tst.NormalEquations(device="cpu")):
        assert make().set_mesh(mesh).mesh is mesh
        assert make().set_mesh(mesh).set_mesh(None).mesh is None
        with pytest.raises(ValueError, match="data-only mesh"):
            make().set_mesh(two_d)
        with pytest.raises(TypeError, match="Mesh"):
            make().set_mesh(object())


@pytest.mark.parametrize("call", [
    lambda X, y, m: tst.LBFGS(device="cpu").set_mesh(m)
    .set_streamed_stats(True).optimize((X, y), np.zeros(3)),
    lambda X, y, m: tst.LBFGS(device="cpu").set_mesh(m)
    .set_host_streaming(True).optimize((X, y), np.zeros(3)),
    lambda X, y, m: tst.OWLQN(device="cpu").set_mesh(m)
    .set_host_streaming(True).optimize((X, y), np.zeros(3)),
    lambda X, y, m: tst.NormalEquations(device="cpu").set_mesh(m)
    .set_host_streaming(True).optimize((X, y), np.zeros(3)),
], ids=["lbfgs_streamed_stats", "lbfgs_host", "owlqn_host", "normal_host"])
def test_the_streamed_routes_on_a_mesh_still_raise_naming_a5(call):
    """The streamed routes on a data mesh are ported (their runs:
    ``tests/test_torch_mesh_streamed.py``), so none raises naming A5 any
    more: without a process group each goes as far as its first
    collective (the gather of the ranks' hosts), which needs one."""
    X, y, _ = linear_data(40, 3, seed=1)
    with pytest.raises(ValueError, match="process group") as e:
        call(np.asarray(X), np.asarray(y), par.Mesh({par.DATA_AXIS: 2}))
    assert "A5" not in str(e.value)


def test_gramdata_input_on_a_mesh_raises_the_reference_message():
    X, y, _ = linear_data(64, 3, seed=1)
    g = tst.GramLeastSquaresGradient.build(np.asarray(X), np.asarray(y),
                                           block_rows=16, device="cpu")
    opt = tst.LBFGS(g, device="cpu").set_mesh(par.Mesh({par.DATA_AXIS: 2}))
    with pytest.raises(NotImplementedError, match="unmeshed quasi-Newton"):
        opt.optimize((g.data, np.asarray(y)), np.zeros(3))

"""Parity of the port's resident meshed training with the JAX package's
8-device CPU mesh: the 2-D ``(data, model)`` mesh
(``tpu_sgd_torch/parallel/model_parallel.py``), sufficient statistics on
the data mesh (``parallel/gram_parallel.py``), and ``set_residency`` and
feature scaling on a mesh.

One gloo world of 8 CPU ranks (``tests/torch_mesh_resident_worker.py``,
spawned once for the module, as ``tests/test_torch_parallel.py`` spawns
its own) trains every case on its rows: on the 4 x 2 mesh a rank passes
the rows of its data block, ``rank // 2``.  This process runs the JAX
references on ``tests/conftest.py``'s 8-device mesh
(``make_mesh(n_data=4, n_model=2)``, ``data_mesh()``) on the same numpy
inputs and, for the bitwise checks, the port's one-process rank-order
sums of the same shards.  The twins of ``tests/test_parallel.py``'s
``Test2DMesh`` and ``:191``, ``:212``, and of ``tests/test_gram.py:368,
397, 443, 460, 1250``.

Tolerances: integers, placements and history lengths exact; runs on the
same samples (full batch, or the JAX package's per-shard samples
injected) at the per-step tier, history rtol 2e-4 and weights rtol 2e-4 /
atol 2e-3, or the reference test's own bound where it is tighter (the 2-D
full-batch twins keep ``Test2DMesh``'s atol 1e-5).  Within the port,
bitwise: every rank's weights, a trivial model axis against the data
mesh, the 2-D run against a one-process sum of the margins in model-rank
order and of the sums in data-rank order, the statistics run against its
one-process rank-order sum, and residency against the superstep driver.
"""

import glob
import os
import shutil
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import tpu_sgd as jt
from tpu_sgd.parallel.mesh import data_mesh as jdata_mesh
from tpu_sgd.parallel.mesh import make_mesh as jmake_mesh
from tpu_sgd.utils import linear_data
import tpu_sgd_torch as tst
from tpu_sgd_torch import parallel as par
from tpu_sgd_torch.ops.gradients import matmul_dtype, mm_acc
from tpu_sgd_torch.optimize import gradient_descent as tgd

WORLD, N_DATA, N_MODEL = 8, 4, 2
SEED = 42
_HERE = os.path.dirname(os.path.abspath(__file__))
_WORKER = os.path.join(_HERE, "torch_mesh_resident_worker.py")
ROOT = os.path.dirname(_HERE)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def jax_samples(kind, n, frac, iters, shards, seed=SEED):
    """The JAX package's per-shard samples of iterations ``1..iters``
    (``fold_in(fold_in(key, i), data_index)``) over ``ceil(n / shards)``
    padded local rows, stacked ``(iters, shards, ...)``."""
    n_local = -(-n // shards)
    m = max(1, round(frac * n_local))
    key = jax.random.PRNGKey(seed)

    def one(i, s):
        k = jax.random.fold_in(jax.random.fold_in(key, i), s)
        if kind == "bernoulli":
            return jax.random.bernoulli(k, frac, (n_local,))
        if kind == "indexed":
            return jax.random.randint(k, (m,), 0, n_local)
        return jax.random.randint(k, (), 0, max(1, n_local - m + 1))

    draw = jax.jit(jax.vmap(one, in_axes=(None, 0)))
    return np.stack([np.asarray(draw(i, np.arange(shards)))
                     for i in range(1, iters + 1)])


def _inputs():
    d = {}
    for name, args in (("par", (512, 16, 0.0, 0.1, 10)),
                       ("uneven", (509, 13, 0.0, 0.1, 11)),
                       ("conv", (512, 16, 0.0, 0.0, 12)),
                       ("route", (2048, 24, 0.0, 0.01, 13)),
                       ("warm", (512, 16, 0.0, 0.1, 23)),
                       ("inj2", (2003, 9, 0.0, 0.1, 2)),
                       ("ro", (1003, 7, 0.0, 0.1, 1)),
                       ("gs", (4096, 24, 0.0, 0.1, 3)),
                       ("gf", (2048, 12, 0.0, 0.1, 4)),
                       ("gp", (2049, 12, 0.0, 0.1, 5))):
        n, dim, b, eps, seed = args
        X, y, w = linear_data(n, dim, intercept=b, eps=eps, seed=seed)
        d[name + "_X"], d[name + "_y"] = np.asarray(X), np.asarray(y)
        if name == "route":
            d["route_w_true"] = np.asarray(w)
    X, y, _ = linear_data(1000, 5, intercept=0.7, eps=0.1, seed=6)
    scale = np.array([0.1, 1.0, 5.0, 30.0, 2.0], np.float32)
    d["fsc_X"] = (np.asarray(X) * scale).astype(np.float32)
    d["fsc_y"] = np.asarray(y)
    for kind in ("bernoulli", "indexed", "sliced"):
        d["inj2_" + kind] = jax_samples(kind, 2003, 0.2, 30, N_DATA)
    d["gs_draws"] = jax_samples("sliced", 4096, 0.2, 25, WORLD, seed=11)
    return d


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The inputs, and every rank's outputs from one 8-rank gloo job (the
    whole job retries on a fresh port if its launch fails)."""
    tmp = tmp_path_factory.mktemp("torch_mesh_resident")
    inp = _inputs()
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
            return inp, outs
    for r, text in enumerate(logs):
        print(f"--- rank {r} ---\n{text[-3000:]}")
    pytest.fail("the 8-rank gloo world failed on 3 ports; see the logs")


def _close(got, ref, rtol=2e-4, atol=2e-3):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=rtol,
                               atol=atol)


def _ls_objective(X, y, w, b=0.0):
    r = X.astype(np.float64) @ np.asarray(w, np.float64) + b - y
    return 0.5 * float(np.mean(r * r))


def _single_thread(fn):
    """``fn()`` on one CPU thread, as the ranks run: the bitwise
    references must add in the ranks' order inside each product too."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return fn()
    finally:
        torch.set_num_threads(before)


# ---- the world ----------------------------------------------------------------

def test_every_rank_ran_in_one_world_and_imported_no_jax(world):
    _, outs = world
    for r, o in enumerate(outs):
        assert o["rank"].tolist() == [r, r // N_MODEL, r % N_MODEL, N_DATA,
                                      N_MODEL, r, WORLD]
        assert o["leaked"].size == 0, o["leaked"]


def test_every_rank_holds_the_same_weights_bitwise(world):
    """The whole weight vector on every rank, the 2-D runs' included; a
    rank's block equals the blocks of its model column."""
    _, outs = world
    keys = [k for k in outs[0] if k.endswith(("_w", "_h", "_std"))
            and not k.startswith("d2_block")]
    assert len(keys) > 40
    for k in keys:
        for o in outs[1:]:
            np.testing.assert_array_equal(o[k], outs[0][k], err_msg=k)
    for r, o in enumerate(outs):
        same = outs[r % N_MODEL]
        np.testing.assert_array_equal(o["d2_block_w"], same["d2_block_w"])
        np.testing.assert_array_equal(o["d2_block_h"], outs[0]["d2_block_h"])


# ---- the 2-D mesh (test_parallel.py Test2DMesh) -------------------------------

def _jax_2d(name, updater, cfg, w0=None):
    from tpu_sgd.parallel.model_parallel import dp_mp_optimize

    def run(inp):
        X, y = inp[name + "_X"], inp[name + "_y"]
        w = np.zeros(X.shape[1], np.float32) if w0 is None else w0
        return dp_mp_optimize(jt.LeastSquaresGradient(), updater, cfg,
                              jmake_mesh(n_data=N_DATA, n_model=N_MODEL),
                              w, X, y)
    return run


@pytest.mark.parametrize("name,updater,knobs", [
    ("par", jt.SimpleUpdater(), dict(step_size=0.3, num_iterations=30)),
    ("uneven", jt.L1Updater(), dict(step_size=0.3, num_iterations=20,
                                    reg_param=0.05)),
])
def test_2d_full_batch_matches_the_jax_2d_mesh(world, name, updater, knobs):
    """n = 512 divides the data axis; n = 509 and d = 13 pad both axes,
    invisibly in the result.  Two library products an iteration, no fused
    kernel (the reference's base path)."""
    inp, outs = world
    cfg = jt.SGDConfig(convergence_tol=0.0, **knobs)
    jw, jh, jn = _jax_2d(name, updater, cfg)(inp)
    o = outs[0]
    iters = knobs["num_iterations"]
    assert int(jn) == iters == len(o[f"d2_{name}_h"])
    assert o[f"d2_{name}_w"].shape == (inp[name + "_X"].shape[1],)
    _close(o[f"d2_{name}_w"], jw, atol=1e-5)
    _close(o[f"d2_{name}_h"], np.asarray(jh)[:iters], atol=1e-5)
    assert int(o[f"d2_{name}_products"]) == 2 * iters
    assert int(o[f"d2_{name}_kernels"]) == 0


def test_2d_l2_reg_and_convergence_stop_at_the_jax_iteration(world):
    """The reg value and the convergence norms combine over the model
    axis: the run stops where the JAX 2-D run stops."""
    inp, outs = world
    cfg = jt.SGDConfig(step_size=0.5, num_iterations=400, reg_param=0.01,
                       convergence_tol=1e-3)
    jw, jh, jn = _jax_2d("conv", jt.SquaredL2Updater(), cfg)(inp)
    assert len(outs[0]["d2_conv_h"]) == int(jn) < 400
    _close(outs[0]["d2_conv_w"], jw, atol=1e-5)


def test_2d_optimizer_route_learns_the_weights(world):
    inp, outs = world
    jw, _ = (jt.GradientDescent(jt.LeastSquaresGradient(),
                                jt.SimpleUpdater())
             .set_step_size(0.5).set_num_iterations(150)
             .set_convergence_tol(0.0)
             .set_mesh(jmake_mesh(n_data=N_DATA, n_model=N_MODEL))
             .optimize_with_history((inp["route_X"], inp["route_y"]),
                                    np.zeros(24, np.float32)))
    _close(outs[0]["d2_route_w"], jw, atol=1e-5)
    np.testing.assert_allclose(outs[0]["d2_route_w"], inp["route_w_true"],
                               atol=0.1)
    jm = jt.LinearRegressionWithSGD.train(
        (inp["route_X"], inp["route_y"]), 150, 0.5, 1.0,
        mesh=jmake_mesh(n_data=N_DATA, n_model=N_MODEL))
    _close(outs[0]["d2_train_w"], jm.weights, atol=1e-5)


def test_2d_warm_start_initial_reg_is_global(world):
    """test_parallel.py:191: iteration 1's loss carries the initial reg
    value of the WHOLE warm-started vector."""
    inp, outs = world
    cfg = jt.SGDConfig(step_size=0.1, num_iterations=5, convergence_tol=0.0,
                       reg_param=0.3)
    w0 = np.full(16, 0.5, np.float32)
    _, jh, _ = _jax_2d("warm", jt.SquaredL2Updater(), cfg, w0)(inp)
    _, h1 = (jt.GradientDescent(jt.LeastSquaresGradient(),
                                jt.SquaredL2Updater(), cfg)
             .optimize_with_history((inp["warm_X"], inp["warm_y"]), w0))
    np.testing.assert_allclose(outs[0]["d2_warm_h"][0], h1[0], rtol=1e-5,
                               atol=1e-6)
    _close(outs[0]["d2_warm_h"], np.asarray(jh)[:5], atol=1e-5)


def test_2d_blocks_and_the_gathered_vector(world):
    """``feature_block`` pads 13 features to 14 (blocks of 7);
    ``dp_mp_run_fn`` returns the rank's block, ``dp_mp_optimize`` the
    whole vector, which is the blocks in model-rank order, and
    ``GradientDescent`` on the same mesh the same."""
    inp, outs = world
    o0, o1 = outs[0], outs[1]
    assert o0["d2_block_width"].tolist() == [7, 13]
    whole = np.concatenate([o0["d2_block_w"], o1["d2_block_w"]])[:13]
    np.testing.assert_array_equal(o0["d2_mpopt_w"], whole)
    np.testing.assert_array_equal(o0["d2_mpopt_w"], o0["d2_uneven_w"])
    np.testing.assert_array_equal(o0["d2_block_h"], o0["d2_uneven_h"])
    assert o1["d2_block_w"][-1] == 0.0  # the padded feature stays 0


@pytest.mark.parametrize("sampling", ["bernoulli", "indexed", "sliced"])
def test_2d_injected_samples_match_the_jax_2d_mesh(world, sampling):
    """Each data shard draws the JAX package's own sample, shared by the
    model ranks of its row."""
    inp, outs = world
    jw, jh = (jt.GradientDescent(jt.LeastSquaresGradient(),
                                 jt.SimpleUpdater())
              .set_step_size(0.5).set_num_iterations(30)
              .set_mini_batch_fraction(0.2).set_sampling(sampling)
              .set_convergence_tol(0.0)
              .set_mesh(jmake_mesh(n_data=N_DATA, n_model=N_MODEL))
              .optimize_with_history((inp["inj2_X"], inp["inj2_y"]),
                                     np.zeros(9, np.float32)))
    th = outs[0][f"d2_inj_{sampling}_h"]
    assert len(th) == len(jh) == 30
    np.testing.assert_allclose(th, jh, rtol=2e-4)
    _close(outs[0][f"d2_inj_{sampling}_w"], jw)


def one_process_2d(X, y, sampling, frac, iters=12, step=0.3, reg=0.02):
    """The 4 x 2 run's arithmetic in one process: each data shard's padded
    rows cut into the two zero-padded feature blocks, each data shard's
    own sample stream; per data shard the partial margins added in
    model-rank order, the pointwise rule, each block's gradient; per block
    the sums added in data-rank order; each block's update, its reg value
    added in model-rank order (least squares, squared L2)."""
    n, d = X.shape
    rows = -(-n // N_DATA)
    b = -(-d // N_MODEL)
    cfg = tst.SGDConfig(step_size=step, num_iterations=iters, reg_param=reg,
                        mini_batch_fraction=frac, convergence_tol=0.0,
                        sampling=sampling)
    g, u = tst.LeastSquaresGradient(), tst.SquaredL2Updater()
    shards = []
    for s in range(N_DATA):
        Xl, yl = par.local_rows(X, y, s, N_DATA)
        Xp = torch.zeros((rows, b * N_MODEL))
        yp = torch.zeros((rows,))
        Xp[:len(Xl), :d], yp[:len(yl)] = (torch.as_tensor(Xl),
                                          torch.as_tensor(yl))
        blocks = [Xp[:, m * b:(m + 1) * b].contiguous()
                  for m in range(N_MODEL)]
        valid = torch.arange(rows) < len(Xl)
        sampler = (None if frac >= 1.0
                   else tgd._make_sampler(cfg, blocks[0], shard=s))
        shards.append((blocks, yp, valid, sampler))
    w = [torch.zeros(b) for _ in range(N_MODEL)]

    def reg_sum(ws):
        vals = [u.compute(wm, torch.zeros_like(wm), 0.0, 1, reg)[1]
                for wm in ws]
        return sum(vals[1:], vals[0])

    reg_val = reg_sum(w)
    hist = []
    mm = matmul_dtype(shards[0][0][0])
    m_rows = max(1, round(frac * rows))
    for i in range(1, iters + 1):
        it = torch.full((1,), i, dtype=torch.int64)
        parts = [[] for _ in range(N_MODEL)]
        for blocks, yp, valid, sampler in shards:
            Xs, ys, mask = blocks, yp, valid
            if sampler is not None:
                sampler.seek(i)
                sample = sampler.draw()
                if sampling == "sliced":
                    s0 = int(sample[0])
                    Xs = [B[s0:s0 + m_rows] for B in blocks]
                    ys, mask = yp[s0:s0 + m_rows], valid[s0:s0 + m_rows]
                else:
                    mask = sample & valid
            partial = [mm_acc(Xs[m], w[m].to(mm)[:, None])[:, 0]
                       for m in range(N_MODEL)]
            margins = partial[0]
            for p in partial[1:]:  # model-rank order
                margins = margins + p
            coeff, losses = g.pointwise(margins, ys)
            mf = mask.to(margins.dtype)
            coeff, losses = coeff * mf, losses * mf
            count = torch.sum(mf)
            for m in range(N_MODEL):
                gm = mm_acc(coeff.to(mm)[None, :], Xs[m])[0]
                parts[m].append(torch.cat([gm, torch.sum(losses).reshape(1),
                                           count.reshape(1)]))
        tots = []
        for m in range(N_MODEL):
            tot = parts[m][0]
            for p in parts[m][1:]:  # data-rank order
                tot = tot + p
            tots.append(tot)
        c = tots[0][b + 1]
        safe = torch.clamp(c, min=1.0)
        loss = tots[0][b] / safe + reg_val
        new = [u.compute(w[m], tots[m][:b] / safe, step, it, reg)
               for m in range(N_MODEL)]
        if bool(c > 0):
            hist.append(loss.to(torch.float32))
            w = [nw for nw, _ in new]
            regs = [nr for _, nr in new]
            reg_val = sum(regs[1:], regs[0])
    return torch.cat(w)[:d].numpy(), torch.stack(hist).numpy()


@pytest.mark.parametrize("sampling", ["full", "bernoulli", "sliced"])
def test_the_2d_run_is_the_one_process_rank_order_sum(world, sampling):
    inp, outs = world
    frac = 1.0 if sampling == "full" else 0.3
    w, h = _single_thread(lambda: one_process_2d(
        inp["ro_X"], inp["ro_y"],
        "bernoulli" if sampling == "full" else sampling, frac))
    np.testing.assert_array_equal(outs[0][f"d2_ro_{sampling}_w"], w)
    np.testing.assert_array_equal(outs[0][f"d2_ro_{sampling}_h"], h)


def test_a_trivial_model_axis_is_the_data_mesh_bitwise(world):
    """test_parallel.py:212: ``make_mesh(8, 1)`` flattens to the data
    mesh, and runs as it, bitwise."""
    _, outs = world
    o = outs[0]
    assert o["flat_view"].tolist() == [["data", "8"]]
    np.testing.assert_array_equal(o["flat_w"], o["one_d_w"])
    np.testing.assert_array_equal(o["flat_h"], o["one_d_h"])


@pytest.mark.parametrize("key,kind,match", [
    ("sparse", "NotImplementedError", "needs dense column blocks"),
    ("multinomial", "NotImplementedError", "vector-weight gradients only"),
    ("listener", "NotImplementedError",
     "single-device and 1-D data meshes"),
    ("host_streaming", "NotImplementedError", "supports 1-D data meshes"),
    ("streamed_stats", "NotImplementedError",
     "compose with a 1-D 'data' mesh"),
    ("lbfgs", "ValueError", "data-only mesh"),
    ("normal", "ValueError", "data-only mesh"),
    ("as_data_mesh", "NotImplementedError", "composes with a 1-D 'data'"),
])
def test_2d_mesh_refuses_what_the_reference_refuses(world, key, kind,
                                                     match):
    _, outs = world
    msg = str(outs[0]["refuse_" + key])
    assert msg.startswith(kind + ":") and match in msg, msg
    assert "ROADMAP" not in msg


# ---- sufficient statistics on the data mesh (test_gram.py) --------------------

def _jgram(flag, knobs, data, d, updater=None, gram_options=None):
    o = (jt.GradientDescent(jt.LeastSquaresGradient(),
                            updater or jt.SimpleUpdater())
         .set_convergence_tol(0.0).set_mesh(jdata_mesh())
         .set_sufficient_stats(flag))
    for k, v in knobs.items():
        getattr(o, "set_" + k)(v)
    if gram_options:
        o.set_gram_options(**gram_options)
    return o.optimize_with_history(data, np.zeros(d, np.float32))


def test_meshed_statistics_follow_the_stock_meshed_run(world):
    """test_gram.py:368: per-rank prefix statistics on the same window
    starts (the JAX package's, injected) track the stock meshed run."""
    _, outs = world
    o = outs[0]
    assert bool(o["gs_engaged"]) and bool(o["gs_cache_hit"])
    for k in ("h", "w"):
        np.testing.assert_allclose(o[f"gs_sliced_True_{k}"],
                                   o[f"gs_sliced_False_{k}"], rtol=5e-4,
                                   atol=5e-4)


@pytest.mark.parametrize("aligned", [False, True])
def test_meshed_statistics_match_the_jax_meshed_statistics(world, aligned):
    inp, outs = world
    knobs = dict(step_size=0.2, num_iterations=25, mini_batch_fraction=0.2,
                 sampling="sliced", seed=11)
    jw, jh = _jgram(True, knobs, (inp["gs_X"], inp["gs_y"]), 24,
                    gram_options=dict(block_rows=64, aligned=True)
                    if aligned else None)
    key = "gs_aligned" if aligned else "gs_sliced_True"
    assert len(outs[0][key + "_h"]) == len(jh) == 25
    np.testing.assert_allclose(outs[0][key + "_h"], jh, rtol=2e-4)
    _close(outs[0][key + "_w"], jw)


def test_meshed_statistics_full_batch_and_the_padded_fallback(world):
    """test_gram.py:397: full batch from the statistics tracks the stock
    meshed run and the JAX one; a row count that pads (2,049) runs the
    stock meshed path instead, bitwise."""
    inp, outs = world
    o = outs[0]
    assert bool(o["gs_full_True_engaged"])
    np.testing.assert_allclose(o["gs_full_True_h"], o["gs_full_False_h"],
                               rtol=5e-4, atol=5e-4)
    jw, jh = _jgram(True, dict(step_size=0.3, num_iterations=15,
                               reg_param=0.01),
                    (inp["gf_X"], inp["gf_y"]), 12, jt.SquaredL2Updater())
    np.testing.assert_allclose(o["gs_full_True_h"], jh, rtol=2e-4)
    _close(o["gs_full_True_w"], jw)
    assert not bool(o["gs_pad_True_engaged"])
    np.testing.assert_array_equal(o["gs_pad_True_h"], o["gs_pad_False_h"])
    np.testing.assert_array_equal(o["gs_pad_True_w"], o["gs_pad_False_w"])


def one_process_gram(X, y, iters=12, frac=0.25, step=0.3):
    """The meshed statistics run in one process: each rank's own build
    and window stream, the window sums added in rank order, then
    ``make_run``'s update (least squares, simple updater)."""
    n, d = X.shape
    cfg = tst.SGDConfig(step_size=step, num_iterations=iters,
                        mini_batch_fraction=frac, convergence_tol=0.0,
                        sampling="sliced")
    u = tst.SimpleUpdater()
    shards = []
    for s in range(WORLD):
        Xl, yl = (torch.as_tensor(a) for a in par.local_rows(X, y, s, WORLD))
        g = tst.GramLeastSquaresGradient.build(Xl, yl, device="cpu")
        shards.append((g, yl, tgd._make_sampler(cfg, g.data, shard=s)))
    w = torch.zeros(d)
    reg = u.compute(w, torch.zeros_like(w), 0.0, 1, 0.0)[1]
    hist = []
    m = max(1, round(frac * shards[0][0].data.shape[0]))
    for i in range(1, iters + 1):
        it = torch.full((1,), i, dtype=torch.int64)
        parts = []
        for g, yl, sampler in shards:
            sampler.seek(i)
            gs, ls, cs = g.window_sums(g.data, yl, w, sampler.draw(), m)
            parts.append(torch.cat([gs, ls.reshape(1), cs.reshape(1)]))
        tot = parts[0]
        for p in parts[1:]:  # rank order
            tot = tot + p
        c = tot[d + 1]
        safe = torch.clamp(c, min=1.0)
        hist.append((tot[d] / safe + reg).to(torch.float32))
        w, reg = u.compute(w, tot[:d] / safe, step, it, 0.0)
    return w.numpy(), torch.stack(hist).numpy()


def test_meshed_statistics_are_the_one_process_rank_order_sum(world):
    inp, outs = world
    w, h = _single_thread(lambda: one_process_gram(inp["gf_X"],
                                                   inp["gf_y"]))
    for key in ("gs_ro", "gs_fn"):
        np.testing.assert_array_equal(outs[0][key + "_w"], w)
        np.testing.assert_array_equal(outs[0][key + "_h"], h)


def test_meshed_statistics_warn_where_they_do_not_apply(world):
    """test_gram.py:443 and :1250: a listener drops the statistics, and
    chunk_iters keeps the per-iteration driver on a mesh; both warn."""
    _, outs = world
    o = outs[0]
    assert any("sufficient_stats is not applied" in m
               for m in o["gs_listener_warns"].tolist())
    assert any("single-device" in m for m in o["gs_chunk_warns"].tolist())
    assert bool(o["gs_chunk_finite"])


# ---- set_residency and feature scaling on a mesh ------------------------------

def test_residency_on_a_mesh_warns_and_is_the_superstep_run(world):
    _, outs = world
    for o in outs:
        assert any("set_residency is single-device" in m
                   for m in o["res_warns"].tolist())
        np.testing.assert_array_equal(o["res_w"], o["sup_w"])
        np.testing.assert_array_equal(o["res_h"], o["sup_h"])
        assert o["res_events"].tolist() == list(range(1, 25))


@pytest.mark.parametrize("name", ["fs", "fs2d"])
def test_feature_scaling_on_a_mesh_matches_the_scaled_single_run(world,
                                                                 name):
    """The scaler's column statistics are every rank's rows' (the same on
    every rank), each rank scales its rows, and the run matches the
    single-device scaled run and the JAX meshed one (full batch)."""
    inp, outs = world
    X, y = inp["fsc_X"], inp["fsc_y"]
    alg = tst.LinearRegressionWithSGD(0.5, 40, 0.0, 1.0, device="cpu")
    alg.set_feature_scaling(True).set_intercept(True)
    alg.optimizer.set_convergence_tol(0.0)
    single = alg.run((X, y))
    _close(outs[0][name + "_w"], single.weights.numpy(), atol=1e-5)
    _close(outs[0][name + "_b"], single.intercept, atol=1e-5)
    jalg = jt.LinearRegressionWithSGD(0.5, 40, 0.0, 1.0)
    jalg.set_feature_scaling(True).set_intercept(True)
    jalg.optimizer.set_convergence_tol(0.0).set_mesh(
        jdata_mesh() if name == "fs" else
        jmake_mesh(n_data=N_DATA, n_model=N_MODEL))
    jm = jalg.run((X, y))
    _close(outs[0][name + "_w"], jm.weights, atol=1e-5)


@pytest.mark.parametrize("key", ["fs_std", "fs_sparse_std"])
def test_meshed_scaler_statistics_are_the_whole_columns(world, key):
    inp, outs = world
    std = np.std(inp["fsc_X"].astype(np.float64), axis=0, ddof=1)
    np.testing.assert_allclose(outs[0][key], std, rtol=1e-6)


# ---- in-process, no process group ----------------------------------------------

def test_pad_features_to_multiple_as_the_jax_package():
    from tpu_sgd.parallel.model_parallel import (
        pad_features_to_multiple as jpad,
    )

    X = np.arange(30, dtype=np.float32).reshape(3, 10)
    w0 = np.ones(10, np.float32)
    for k in (1, 2, 3, 4):
        ours = par.pad_features_to_multiple(X, w0, k)
        ref = jpad(X, w0, k)
        for a, b in zip(ours[:2], ref[:2]):
            np.testing.assert_array_equal(a, b)
        assert ours[2] == ref[2] == 10
        t = par.pad_features_to_multiple(torch.as_tensor(X),
                                         torch.as_tensor(w0), k)
        np.testing.assert_array_equal(t[0].numpy(), ref[0])


def test_the_margin_combined_path_is_the_base_path_on_one_block():
    """With the identity as the combine (one model rank), the 2-D sums
    are the plain sums of the whole X, the mask and the window
    included."""
    from tpu_sgd_torch.ops import cuda_kernels as ck

    X, y, _ = linear_data(300, 6, seed=3)
    X, y = torch.as_tensor(np.asarray(X)), torch.as_tensor(np.asarray(y))
    w = torch.linspace(-1, 1, 6)
    mask = torch.arange(300) % 3 == 0
    g = tst.LogisticGradient()
    ck.reset_launch_counts()
    got = g.batch_sums(X, (y > 0).float(), w, mask,
                       margin_axis_name=lambda t: t)
    ref = ck.fused_gradient_sums_plain(g.pointwise, X, (y > 0).float(), w,
                                       mask)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-5)
    assert ck.model_axis_product_counts() == 2
    start = torch.tensor([17])
    got = g.window_sums(X, y, w, start, 50, margin_axis_name=lambda t: t)
    ref = g.window_sums(X, y, w, 17, 50)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-5)
    mc = tst.MultinomialLogisticGradient(3)
    labels = (torch.arange(300) % 3).float()
    W = torch.linspace(-1, 1, 12)
    got = mc.batch_sums(X, labels, W, mask, margin_axis_name=lambda t: t)
    ref = mc.batch_sums(X, labels, W, mask)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.numpy(), b.numpy())

"""Parity of the port's data parallelism (``tpu_sgd_torch/parallel/``,
``GradientDescent.set_mesh``) with the JAX package's 8-device CPU mesh.

One gloo world of 8 CPU ranks (``tests/torch_parallel_worker.py``, one
process each, spawned once for the module like ``tests/test_multihost.py``)
trains every case on its rows; this process runs the JAX references on
``tests/conftest.py``'s 8-device mesh on the same numpy inputs and, for the
bitwise checks, the port's one-process rank-order sum of the same 8
shards.  The twins of ``tests/test_parallel.py``, the mesh cases of
``test_gradient_descent.py``, ``test_sparse.py``, ``test_superstep.py``
and ``test_multinomial.py:81``.

Tolerances: integers and placements exact; runs on the same samples (full
batch, or the JAX package's per-shard samples injected into the port, as
``tests/test_torch_gram.py`` injects window starts) at the per-step tier,
history rtol 2e-4 and weights rtol 2e-4 / atol 2e-3 (the full-batch twins
of ``test_parallel.py`` keep its atol 1e-5); whole runs on each package's
own samples at the matched objective, <= 1.01x.  Within the port: every
rank's weights bitwise equal, the 8-rank run bitwise the one-process
rank-order sum, the observed driver bitwise the unobserved run at K = 1
and 4, and a stopped run's resume bitwise the uninterrupted one.
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
from tpu_sgd.parallel import data_parallel as jdp
from tpu_sgd.parallel.mesh import data_mesh as jdata_mesh
from tpu_sgd.parallel.mesh import make_mesh as jmake_mesh
import tpu_sgd_torch as tst
from tpu_sgd_torch import parallel as par
from tpu_sgd_torch.optimize import gradient_descent as tgd

WORLD = 8
SEED = 42
_WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "torch_parallel_worker.py")
ROOT = os.path.dirname(os.path.dirname(_WORKER))


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# ---- inputs ------------------------------------------------------------------

def _linear(n, d, seed, eps=0.1):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)).astype(np.float32)
    w = rng.uniform(-1, 1, size=(d,)).astype(np.float32)
    y = (X @ w + eps * rng.normal(size=(n,))).astype(np.float32)
    return X, y


def _logistic(n, d, seed):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)).astype(np.float32)
    w = rng.normal(size=(d,)).astype(np.float32)
    p = 1 / (1 + np.exp(-(X @ w)))
    return X, (rng.uniform(size=n) < p).astype(np.float32)


def _multiclass(n, d, k, seed):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)).astype(np.float32)
    W = rng.normal(size=(k, d)).astype(np.float32)
    logits = X @ W.T
    p = np.exp(logits - logits.max(1, keepdims=True))
    p /= p.sum(1, keepdims=True)
    y = np.array([rng.choice(k, p=r) for r in p], np.float32)
    return X, y


def _sparse(n, d, per_row, seed):
    """CSR components of an SVM-style sparse matrix, labels in {0, 1}."""
    rng = np.random.default_rng(seed)
    cols = np.sort(np.stack([rng.choice(d, per_row, replace=False)
                             for _ in range(n)]), axis=1).astype(np.int64)
    vals = rng.normal(size=(n, per_row)).astype(np.float32)
    w = rng.normal(size=(d,)).astype(np.float32)
    margins = (vals * w[cols]).sum(1)
    y = (margins > 0).astype(np.float32)
    crow = np.arange(0, (n + 1) * per_row, per_row, dtype=np.int64)
    return crow, cols.reshape(-1), vals.reshape(-1), y


def _local_n(n):
    return -(-n // WORLD)


def jax_samples(kind, n, frac, iters, seed=SEED):
    """The JAX package's per-shard samples of iterations ``1..iters``
    (``_sample_key``: ``fold_in(fold_in(key, i), shard)``) over
    ``ceil(n / 8)`` padded local rows, stacked ``(iters, 8, ...)``."""
    n_local = _local_n(n)
    m = max(1, round(frac * n_local))
    key = jax.random.PRNGKey(seed)

    def one(i, s):
        k = jax.random.fold_in(jax.random.fold_in(key, i), s)
        if kind == "bernoulli":
            return jax.random.bernoulli(k, frac, (n_local,))
        if kind == "indexed":
            return jax.random.randint(k, (m,), 0, n_local)
        return jax.random.randint(k, (), 0, max(1, n_local - m + 1))

    shards = jax.jit(jax.vmap(one, in_axes=(None, 0)))
    return np.stack([np.asarray(shards(i, np.arange(WORLD)))
                     for i in range(1, iters + 1)])


def _inputs():
    d = {}
    d["ls_X"], d["ls_y"] = _linear(1024, 12, 0)
    d["uneven_X"], d["uneven_y"] = _linear(1003, 5, 1)
    d["inj_X"], d["inj_y"] = _linear(2003, 8, 2)
    d["smp_X"], d["smp_y"] = _linear(8000, 10, 3)
    d["log_X"], d["log_y"] = _logistic(2048, 6, 4)
    d["mc_X"], d["mc_y"] = _multiclass(2000, 6, 3, 5)
    d["obs_X"], d["obs_y"] = _linear(515, 8, 6)
    crow, col, val, y = _sparse(1003, 80, 9, 7)
    d.update(sp_crow=crow, sp_col=col, sp_val=val, sp_y=y,
             sp_shape=np.array([1003, 80]))
    for kind in ("bernoulli", "indexed", "sliced"):
        d["inj_" + kind] = jax_samples(kind, 2003, 0.2, 30)
    d["sp_draws"] = jax_samples("bernoulli", 1003, 0.5, 20, seed=7)
    d["obs_draws"] = jax_samples("bernoulli", 515, 0.5, 20)
    return d


def _jbcoo(inp):
    from jax.experimental.sparse import BCOO

    n = int(inp["sp_shape"][0])
    rows = np.repeat(np.arange(n), np.diff(inp["sp_crow"]))
    idx = np.stack([rows, inp["sp_col"]], axis=1).astype(np.int32)
    return BCOO((inp["sp_val"], idx), shape=tuple(inp["sp_shape"]))


def _jobs(iters):
    return (jt.GradientDescent(jt.LeastSquaresGradient(),
                               jt.SquaredL2Updater())
            .set_step_size(0.2).set_reg_param(0.01).set_num_iterations(iters)
            .set_mini_batch_fraction(0.5).set_convergence_tol(0.0)
            .set_mesh(jdata_mesh()))


def _jax_checkpoint(inp, path):
    """A meshed JAX run of 10 observed iterations checkpointing every 5."""
    from tpu_sgd.utils.checkpoint import CheckpointManager

    _jobs(10).set_checkpoint(CheckpointManager(path), every=5) \
        .optimize_with_history((inp["obs_X"], inp["obs_y"]),
                               np.zeros(8, np.float32))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The inputs, and every rank's outputs from one 8-rank gloo job (the
    whole job retries on a fresh port if its launch fails)."""
    tmp = tmp_path_factory.mktemp("torch_mesh")
    inp = _inputs()
    np.savez(tmp / "inputs.npz", **inp)
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    logs = []
    for _ in range(3):
        for d in glob.glob(str(tmp / "*")):
            if os.path.isdir(d):
                shutil.rmtree(d)
        for k in (1, 4):
            _jax_checkpoint(inp, str(tmp / f"ckpt_jax_k{k}"))
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
            return inp, outs, tmp
    for r, text in enumerate(logs):
        print(f"--- rank {r} ---\n{text[-3000:]}")
    pytest.fail("the 8-rank gloo world failed on 3 ports; see the logs")


def _close(got, ref, rtol=2e-4, atol=2e-3):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=rtol,
                               atol=atol)


def _ls_objective(X, y, w):
    r = X.astype(np.float64) @ np.asarray(w, np.float64) - y
    return 0.5 * float(np.mean(r * r))


# ---- the world --------------------------------------------------------------

def test_every_rank_ran_in_one_world_and_imported_no_jax(world):
    _, outs, _ = world
    for r, o in enumerate(outs):
        assert o["rank"].tolist() == [r, WORLD, r, WORLD]
        assert o["leaked"].size == 0, o["leaked"]


def test_every_rank_holds_the_same_weights_bitwise(world):
    _, outs, _ = world
    keys = [k for k in outs[0] if k.endswith(("_w", "_h"))
            and not k.startswith("place")]
    assert len(keys) > 30
    for k in keys:
        for o in outs[1:]:
            np.testing.assert_array_equal(o[k], outs[0][k], err_msg=k)


# ---- full batch (test_parallel.py) ------------------------------------------

@pytest.mark.parametrize("name,iters", [("ls", 40), ("uneven", 25)])
def test_full_batch_matches_the_jax_mesh(world, name, iters):
    """n = 1024 divides evenly; n = 1003 is padded on the last shards
    (``local_rows`` + ``shard_dataset`` against ``pad_to_multiple``)."""
    inp, outs, _ = world
    X, y = inp[name + "_X"], inp[name + "_y"]
    cfg = jt.SGDConfig(step_size=0.3, num_iterations=iters,
                       convergence_tol=0.0)
    jw, jh, jn = jdp.dp_optimize(jt.LeastSquaresGradient(),
                                 jt.SimpleUpdater(), cfg, jdata_mesh(),
                                 np.zeros(X.shape[1], np.float32), X, y)
    assert int(jn) == iters == len(outs[0][name + "_h"])
    _close(outs[0][name + "_w"], jw, atol=1e-5)
    _close(outs[0][name + "_h"], np.asarray(jh)[:iters], atol=1e-5)


def test_shard_dataset_places_rows_as_the_jax_mesh(world):
    inp, outs, _ = world
    Xd, yd, vd = jdp.shard_dataset(jdata_mesh(), inp["uneven_X"],
                                   inp["uneven_y"])
    rows = _local_n(1003)
    Xj, yj, vj = (np.asarray(a) for a in (Xd, yd, vd))
    for r, o in enumerate(outs):
        sl = slice(r * rows, (r + 1) * rows)
        np.testing.assert_array_equal(o["place_X"], Xj[sl])
        np.testing.assert_array_equal(o["place_y"], yj[sl])
        np.testing.assert_array_equal(o["place_valid"], vj[sl])
    assert bool(outs[0]["aligned_valid_none"])
    assert jdp.shard_dataset(jdata_mesh(), inp["ls_X"], inp["ls_y"])[2] \
        is None


# ---- the JAX package's samples injected --------------------------------------

@pytest.mark.parametrize("sampling", ["bernoulli", "indexed", "sliced"])
def test_injected_samples_match_the_jax_mesh(world, sampling):
    """Each shard draws the JAX package's own sample (uneven n: the pad
    rows' valid mask folds into every sampler), so the runs differ only by
    summation order."""
    inp, outs, _ = world
    jw, jh = (jt.GradientDescent(jt.LeastSquaresGradient(),
                                 jt.SimpleUpdater())
              .set_step_size(0.5).set_num_iterations(30)
              .set_mini_batch_fraction(0.2).set_sampling(sampling)
              .set_convergence_tol(0.0).set_mesh(jdata_mesh())
              .optimize_with_history((inp["inj_X"], inp["inj_y"]),
                                     np.zeros(8, np.float32)))
    th = outs[0][f"inj_{sampling}_h"]
    assert len(th) == len(jh) == 30
    np.testing.assert_allclose(th, jh, rtol=2e-4)
    _close(outs[0][f"inj_{sampling}_w"], jw)


@pytest.mark.parametrize("sampling", ["bernoulli", "indexed", "sliced"])
def test_own_shard_streams_reach_the_jax_objective(world, sampling):
    """The port's own per-shard streams (other bits than ``jax.random``):
    the whole run's objective within 1.01x of the JAX mesh's."""
    inp, outs, _ = world
    X, y = inp["smp_X"], inp["smp_y"]
    jw, _ = (jt.GradientDescent(jt.LeastSquaresGradient(),
                                jt.SimpleUpdater())
             .set_step_size(0.5).set_num_iterations(200)
             .set_mini_batch_fraction(0.1).set_sampling(sampling)
             .set_convergence_tol(0.0).set_mesh(jdata_mesh())
             .optimize_with_history((X, y), np.zeros(10, np.float32)))
    ours = _ls_objective(X, y, outs[0][f"smp_{sampling}_w"])
    ref = _ls_objective(X, y, jw)
    assert ours <= 1.01 * ref, (ours, ref)


# ---- train(..., mesh=), the 2-D mesh ------------------------------------------

def test_train_with_mesh_matches_the_jax_mesh(world):
    inp, outs, _ = world
    model = jt.LogisticRegressionWithSGD.train(
        (inp["log_X"], inp["log_y"]), 50, 1.0, 1.0, reg_param=0.01,
        mesh=jdata_mesh())
    _close(outs[0]["train_w"], model.weights, atol=1e-5)


def test_2d_mesh_constructs_and_every_route_raises_naming_a5(world):
    """The 4 x 2 mesh constructs (``make_mesh`` and ``MeshConfig``), runs
    (each rank passing its data block's rows, as the JAX 2-D run's result),
    and refuses what the reference refuses on it with the reference's
    message, naming no ROADMAP item: the 2-D routes were the ones that
    raised naming A5 here, and none does now
    (``tests/test_torch_mesh_resident.py`` holds the 2-D runs)."""
    inp, outs, _ = world
    jw = (jt.GradientDescent().set_mesh(jmake_mesh(n_data=4, n_model=2))
          .optimize((inp["ls_X"], inp["ls_y"]), np.zeros(12, np.float32)))
    for o in outs:
        assert o["mesh2d_shape"].tolist() == [4, 2]
        assert o["config2d_shape"].tolist() == [4, 2]
        msg = str(o["mesh2d_raises"])
        assert "needs dense column blocks" in msg and "ROADMAP" not in msg
        np.testing.assert_array_equal(o["mesh2d_w"], outs[0]["mesh2d_w"])
    _close(outs[0]["mesh2d_w"], jw, atol=1e-5)


# ---- sparse, multinomial ----------------------------------------------------

@pytest.mark.parametrize("frac", [1.0, 0.5])
def test_sparse_hinge_l1_matches_the_jax_mesh(world, frac):
    """Each rank's CSR row block (uneven nnz, the last block padded with
    empty rows); at 0.5 the JAX package's masks are injected."""
    inp, outs, _ = world
    jw, jh = (jt.GradientDescent(jt.HingeGradient(), jt.L1Updater())
              .set_step_size(1.0).set_reg_param(0.01).set_num_iterations(20)
              .set_mini_batch_fraction(frac).set_seed(7)
              .set_convergence_tol(0.0).set_mesh(jdata_mesh())
              .optimize_with_history((_jbcoo(inp), inp["sp_y"]),
                                     np.zeros(80, np.float32)))
    th = outs[0][f"sp_{frac}_h"]
    assert len(th) == len(jh) == 20
    np.testing.assert_allclose(th, jh, rtol=2e-4)
    _close(outs[0][f"sp_{frac}_w"], jw)


def test_multinomial_mesh_matches_the_jax_mesh(world):
    inp, outs, _ = world
    jw, jh = (jt.GradientDescent(jt.MultinomialLogisticGradient(3),
                                 jt.SimpleUpdater())
              .set_step_size(0.5).set_num_iterations(30)
              .set_convergence_tol(0.0).set_mesh(jdata_mesh())
              .optimize_with_history((inp["mc_X"], inp["mc_y"]),
                                     np.zeros(12, np.float32)))
    np.testing.assert_allclose(outs[0]["mc_h"], jh, rtol=2e-4)
    _close(outs[0]["mc_w"], jw, atol=2e-5)


# ---- the observed driver (test_superstep.py's mesh cases) --------------------

@pytest.mark.parametrize("k", [1, 4])
def test_observed_mesh_equals_the_unobserved_run_bitwise(world, k):
    _, outs, _ = world
    o = outs[0]
    np.testing.assert_array_equal(o[f"obs_k{k}_w"], o["obs_plain_w"])
    np.testing.assert_array_equal(o[f"obs_k{k}_h"], o["obs_plain_h"])
    assert o[f"obs_k{k}_events"].tolist() == list(range(1, 21))
    assert o[f"obs_k{k}_saved"].tolist() == [5, 10, 15, 20]


@pytest.mark.parametrize("k", [1, 4])
def test_observed_mesh_matches_the_jax_mesh(world, k):
    inp, outs, _ = world
    from tpu_sgd.utils.events import CollectingListener

    lis = CollectingListener()
    jw, jh = _jobs(20).set_listener(lis).optimize_with_history(
        (inp["obs_X"], inp["obs_y"]), np.zeros(8, np.float32))
    assert len(lis.iterations) == 20
    np.testing.assert_allclose(outs[0][f"obs_k{k}_h"], jh, rtol=2e-4)
    _close(outs[0][f"obs_k{k}_w"], jw)


@pytest.mark.parametrize("k,at", [(1, 7), (4, 8)])
def test_observed_mesh_stop_and_resume_is_bitwise(world, k, at):
    """The stop lands at the block boundary; rank 0 wrote the checkpoint
    and every rank resumed from it."""
    _, outs, tmp = world
    o = outs[0]
    assert int(o[f"obs_k{k}_stopped_at"]) == at
    assert os.path.exists(tmp / f"stop_k{k}" / f"ckpt_{at:08d}.npz")
    np.testing.assert_array_equal(o[f"obs_k{k}_resumed_w"], o["obs_plain_w"])
    np.testing.assert_array_equal(o[f"obs_k{k}_resumed_h"], o["obs_plain_h"])


@pytest.mark.parametrize("k,at", [(1, 7), (4, 8)])
def test_a_stop_on_one_rank_stops_every_rank(world, k, at):
    """Only the last rank installs a stop signal and rank 0 writes its
    checkpoints slowly: every rank stops at the same iteration, resumes
    from the checkpoint of that iteration, and ends bitwise the
    uninterrupted run."""
    _, outs, _ = world
    for o in outs:
        assert int(o[f"one_k{k}_stopped_at"]) == at
        assert o[f"one_k{k}_saved"].tolist()[-1] == at
        np.testing.assert_array_equal(o[f"one_k{k}_resumed_w"],
                                      o["obs_plain_w"])
        np.testing.assert_array_equal(o[f"one_k{k}_resumed_h"],
                                      o["obs_plain_h"])


@pytest.mark.parametrize("k", [1, 4])
def test_jax_mesh_checkpoint_resumes_in_the_port(world, k):
    inp, outs, _ = world
    jw, jh = _jobs(20).optimize_with_history(
        (inp["obs_X"], inp["obs_y"]), np.zeros(8, np.float32))
    np.testing.assert_allclose(outs[0][f"from_jax_k{k}_h"], jh, rtol=2e-4)
    _close(outs[0][f"from_jax_k{k}_w"], jw)


def test_port_mesh_checkpoint_resumes_in_jax(world):
    inp, outs, tmp = world
    from tpu_sgd.utils.checkpoint import CheckpointManager

    path = str(tmp / "ckpt_port")
    assert sorted(os.listdir(path)) == ["ckpt_00000005.npz",
                                        "ckpt_00000010.npz"]
    jw, jh = _jobs(20).set_checkpoint(CheckpointManager(path), every=5) \
        .optimize_with_history((inp["obs_X"], inp["obs_y"]),
                               np.zeros(8, np.float32))
    np.testing.assert_allclose(jh, outs[0]["obs_plain_h"], rtol=2e-4)
    _close(jw, outs[0]["obs_plain_w"])


# ---- bitwise against one process ----------------------------------------------

def one_process_rank_order(X, y, sampling, iters, frac=0.3, step=0.3):
    """The meshed run's arithmetic in one process: each of the 8 shards'
    padded rows and own sample stream, the local sums added in rank order
    (written out here, apart from the port's ``rank_order_sum``), then
    ``make_run``'s update (least squares, simple updater)."""
    n, d = X.shape
    rows = _local_n(n)
    cfg = tst.SGDConfig(step_size=step, num_iterations=iters,
                        mini_batch_fraction=frac, convergence_tol=0.0,
                        sampling=sampling)
    g, u = tst.LeastSquaresGradient(), tst.SimpleUpdater()
    shards = []
    for s in range(WORLD):
        Xl, yl = par.local_rows(X, y, s, WORLD)
        Xp = torch.zeros((rows, d))
        yp = torch.zeros((rows,))
        Xp[:len(Xl)], yp[:len(yl)] = torch.as_tensor(Xl), torch.as_tensor(yl)
        valid = torch.arange(rows) < len(Xl)
        shards.append((Xp, yp, valid, tgd._make_sampler(cfg, Xp, shard=s)))
    w = torch.zeros(d)
    reg = torch.zeros(())
    reg.copy_(u.compute(w, torch.zeros_like(w), 0.0, 1, 0.0)[1])
    hist = []
    m = max(1, round(frac * rows))
    for i in range(1, iters + 1):
        it = torch.full((1,), i, dtype=torch.int64)
        parts = []
        for Xp, yp, valid, sampler in shards:
            sampler.seek(i)
            sample = sampler.draw()
            if sampling == "sliced":
                gs, ls, cs = g.window_sums(Xp, yp, w, sample, m, valid=valid)
            else:
                gs, ls, cs = g.batch_sums(Xp, yp, w, sample & valid)
            parts.append(torch.cat([gs, ls.reshape(1), cs.reshape(1)]))
        tot = parts[0]
        for p in parts[1:]:  # rank order, one add at a time
            tot = tot + p
        gsum, lsum, c = tot[:d], tot[d], tot[d + 1]
        safe = torch.clamp(c, min=1.0)
        loss = lsum / safe + reg
        new_w, new_reg = u.compute(w, gsum / safe, step, it, 0.0)
        if bool(c > 0):
            hist.append(loss.to(torch.float32))
            w, reg = new_w, new_reg
    return w.numpy(), torch.stack(hist).numpy()


@pytest.mark.parametrize("sampling", ["bernoulli", "sliced"])
def test_the_8_rank_run_is_the_one_process_rank_order_sum(world, sampling):
    inp, outs, _ = world
    w, h = one_process_rank_order(inp["uneven_X"], inp["uneven_y"],
                                  sampling, 12)
    np.testing.assert_array_equal(outs[0][f"ro_{sampling}_w"], w)
    np.testing.assert_array_equal(outs[0][f"ro_{sampling}_h"], h)


def test_a_superstep_equals_its_single_steps_on_a_mesh(world):
    _, outs, _ = world
    assert all(bool(o["superstep_equals_steps"]) for o in outs)


# ---- in-process, no process group ----------------------------------------------

def test_pad_to_multiple():
    X = np.ones((10, 3), np.float32)
    y = np.ones((10,), np.float32)
    Xp, yp, valid = par.pad_to_multiple(X, y, 8)
    jX, jy, jv = jdp.pad_to_multiple(X, y, 8)
    assert Xp.shape == (16, 3) and yp.shape == (16,)
    np.testing.assert_array_equal(valid, jv)
    np.testing.assert_array_equal(Xp, jX)


@pytest.mark.parametrize("n", [10, 1003, 1024, 3])
def test_local_rows_cut_as_the_jax_mesh_pads(n):
    """Rank r's rows, padded to ``ceil(n / 8)``, are shard r of
    ``pad_to_multiple``; a sparse X is cut the same way."""
    X, y = _linear(n, 4, 9)
    Xp, yp, valid = jdp.pad_to_multiple(X, y, WORLD)
    rows = Xp.shape[0] // WORLD
    Xs = torch.as_tensor(X).to_sparse_csr()
    for r in range(WORLD):
        Xl, yl = par.local_rows(X, y, r, WORLD)
        k = int(valid[r * rows:(r + 1) * rows].sum())
        assert len(Xl) == len(yl) == k
        np.testing.assert_array_equal(Xl, Xp[r * rows:r * rows + k])
        Sl, _ = par.local_rows(Xs, y, r, WORLD)
        np.testing.assert_array_equal(Sl.to_dense().numpy(), Xl)


def _old_seed_for(seed, i):
    """The sampler's seed before the shard fold existed (kept verbatim)."""
    z = (((int(seed) & 0xFFFFFFFF) << 32) | (int(i) & 0xFFFFFFFF))
    z = (z + 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFFFFFF
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
    return z ^ (z >> 31)


def test_the_unmeshed_stream_is_unchanged_and_shards_differ():
    for seed, i in [(42, 0), (42, 1), (7, 123456), (2**40, 2**33)]:
        assert tgd._seed_for(seed, i) == _old_seed_for(seed, i)
    seeds = {tgd._seed_for(42, 5, s) for s in range(WORLD)}
    assert len(seeds) == WORLD and tgd._seed_for(42, 5) not in seeds
    X = torch.zeros((100, 3))
    cfg = tst.SGDConfig(mini_batch_fraction=0.3)
    plain = tgd._make_sampler(cfg, X)
    plain.seek(3)
    gen = torch.Generator().manual_seed(_old_seed_for(42, 3))
    assert torch.equal(plain.draw(), torch.rand(100, generator=gen) < 0.3)
    a, b = (tgd._make_sampler(cfg, X, shard=s) for s in (0, 1))
    a.seek(3), b.seek(3)
    assert not torch.equal(a.draw(), b.draw())


def test_mesh_config_and_the_mesh_description():
    with pytest.raises(ValueError):
        tst.MeshConfig(data=0)
    with pytest.raises(ValueError):
        tst.MeshConfig(data=2, model=0)
    assert tst.MeshConfig(data=4, model=2).n_devices == 8
    with pytest.raises(RuntimeError, match="initialize_distributed"):
        tst.MeshConfig(data=1).build()
    with pytest.raises(RuntimeError, match="initialize_distributed"):
        par.data_mesh()
    m = par.Mesh({par.DATA_AXIS: 8, par.MODEL_AXIS: 1})
    flat = par.as_data_mesh(m)
    assert flat.shape == {par.DATA_AXIS: 8} and flat.size == 8
    assert par.as_data_mesh(flat) is flat and par.as_data_mesh(None) is None
    assert not par.has_model_axis(m)
    m2 = par.Mesh({par.DATA_AXIS: 4, par.MODEL_AXIS: 2})
    assert par.has_model_axis(m2) and m2.n_model == 2
    with pytest.raises(NotImplementedError,
                       match="composes with a 1-D 'data' mesh"):
        par.as_data_mesh(m2)
    with pytest.raises(ValueError):
        par.Mesh({par.MODEL_AXIS: 2})


def test_set_mesh_takes_a_mesh_and_the_others_still_raise():
    """``set_mesh`` takes a ``Mesh`` on every optimizer now; what still
    raises is a non-Mesh, and on the quasi-Newton and exact solvers a 2-D
    mesh (the reference's ``ValueError``), before anything is sent to
    another rank (``tests/test_torch_mesh_qn.py`` holds their runs)."""
    X, y = _linear(40, 3, 1)
    with pytest.raises(TypeError, match="Mesh"):
        tst.GradientDescent(device="cpu").set_mesh(object())
    mesh = par.Mesh({par.DATA_AXIS: 1})
    two_d = par.Mesh({par.DATA_AXIS: 2, par.MODEL_AXIS: 2})
    assert tst.GradientDescent(device="cpu").set_mesh(mesh).mesh is mesh
    assert tst.GradientDescent(device="cpu").set_mesh(two_d).mesh is two_d
    for opt in (tst.LBFGS(device="cpu"), tst.OWLQN(device="cpu"),
                tst.NormalEquations(device="cpu")):
        assert opt.set_mesh(mesh).mesh is mesh
        with pytest.raises(ValueError, match="data-only mesh"):
            opt.set_mesh(two_d)
    with pytest.raises(ValueError, match="data-only mesh"):
        tst.LogisticRegressionWithLBFGS.train((X, (y > 0).astype(
            np.float32)), mesh=two_d, device="cpu")


@pytest.mark.parametrize("knob", [
    lambda o: o.set_host_streaming(True),
    lambda o: o.set_sufficient_stats(True).set_host_streaming(True),
    lambda o: o.set_streamed_stats(True),
    lambda o: o.set_superstep(4).set_residency(2).set_streamed_stats(True),
])
def test_schedules_of_the_second_part_raise_on_a_mesh(knob):
    """Host streaming and streamed statistics on a data mesh are ported
    (their runs: ``tests/test_torch_mesh_streamed.py``), with or without
    the resident knobs (sufficient statistics, residency), so none raises
    naming A5 any more: without a process group each goes as far as its
    first collective (the gather of the ranks' hosts), which needs
    one."""
    X, y = _linear(40, 3, 1)
    opt = tst.GradientDescent(device="cpu").set_mesh(
        par.Mesh({par.DATA_AXIS: 2}))
    knob(opt)
    with pytest.raises(ValueError, match="process group") as e:
        opt.optimize((X, y), np.zeros(3, np.float32))
    assert "A5" not in str(e.value)


def test_feature_scaling_on_a_mesh_raises():
    """Feature scaling on a mesh fits the scaler on every rank's rows
    (``tests/test_torch_mesh_resident.py``), so it needs the process
    group: without one it raises at the fit, before any training, and
    never falls back to this rank's rows alone."""
    X, y = _linear(40, 3, 1)
    alg = tst.LinearRegressionWithSGD(device="cpu").set_feature_scaling(True)
    alg.optimizer.set_mesh(par.Mesh({par.DATA_AXIS: 2}))
    with pytest.raises((RuntimeError, ValueError), match="process group"):
        alg.run((X, y))

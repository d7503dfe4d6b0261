"""Parity of the port's host-streamed training on a data mesh with the
JAX package's 8-device CPU mesh: streamed SGD on the dense and the
compressed top-k wire (``tpu_sgd_torch/optimize/streamed.py``,
``parallel/mesh.py``'s ``combine_topk``), the streamed CostFun's chunk
grids on one host and on several (``optimize/streamed_costfun.py``), the
streamed statistics and totals (``parallel/gram_parallel.py``) and the
streamed normal equations.

One gloo world of 8 CPU ranks (``tests/torch_mesh_streamed_worker.py``,
spawned once for the module) trains every case.  On one host every rank
passes the WHOLE host dataset, mapped from one file the ranks share; on
the mesh that declares two hosts each rank passes its local rows.  This
process runs the JAX references on ``tests/conftest.py``'s 8-device mesh
on the same numpy inputs and, for the bitwise checks, the port's
one-process rank-order sums of the same shares.  Twins of
``tests/test_gradient_descent.py:230, 254, 537``,
``test_sparse_wire.py:128, 165, 230, 258``, ``test_composition.py:220``,
``test_parallel.py:225``, ``test_streamed_costfun.py:201, 226``,
``test_multihost.py:166, 190``, ``test_gram.py:900, 934, 953, 989,
1074``, ``test_lbfgs.py:186`` and ``test_normal.py:96``.

Tolerances: integers, caps, shares and history lengths exact; runs on the
same samples (the host sampler draws the JAX package's samples) at the
per-step tier, history rtol 2e-4 and weights rtol 2e-4 / atol 2e-3, or
the reference test's own bound where it is tighter; the port's f64
totals against the JAX package's f32 at the statistics tier.  Within the
port, bitwise: every rank's results, the one-process rank-order sums,
two runs, prefetch depth 0 against 2, K = 4 against K = 1, a stop and
its resume, and a resumed build.
"""

import glob
import json
import os
import shutil
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import tpu_sgd as jt
from tpu_sgd.parallel.mesh import data_mesh as jdata_mesh
from tpu_sgd.utils import linear_data
from tpu_sgd.utils.checkpoint import CheckpointManager as JCheckpointManager
import tpu_sgd_torch as tst
from tpu_sgd_torch import parallel as par
from tpu_sgd_torch.io.sparse_wire import topk_indices, topk_nnz
from tpu_sgd_torch.optimize.streamed import HostSampler

WORLD = 8
ITERS, STOP_AT = 24, 13
_HERE = os.path.dirname(os.path.abspath(__file__))
_WORKER = os.path.join(_HERE, "torch_mesh_streamed_worker.py")
ROOT = os.path.dirname(_HERE)
MODES = ("bernoulli", "indexed", "sliced", "full")


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _reg(seed, n, d, noise=0.01):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)).astype(np.float32)
    w = rng.normal(size=d).astype(np.float32)
    return X, (X @ w + noise * rng.normal(size=n)).astype(np.float32)


def _binary(rng, n, d):
    X = rng.normal(size=(n, d)).astype(np.float32)
    w = rng.uniform(-1, 1, d).astype(np.float32)
    return X, (X @ w + 0.3 * rng.normal(size=n) > 0).astype(np.float32)


def _inputs():
    d = {}

    def put(name, X, y):
        d[name + "_X"] = np.asarray(X, np.float32)
        d[name + "_y"] = np.asarray(y, np.float32)

    X, y, _ = linear_data(3000, 6, eps=0.05, seed=10)
    put("gd", X, y)
    put("sw", *_reg(1, 384, 20))
    put("ef", *_reg(2, 256, 16))
    put("cg", *_reg(3, 256, 16))
    rng = np.random.default_rng(0)
    put("cf", *_binary(rng, 2048, 12))
    put("cap", *_binary(rng, 700, 8))
    d["cap_w"] = rng.normal(size=8).astype(np.float32)
    r = np.random.default_rng(123)  # tests/multihost_worker.py's dataset
    w_true = r.normal(size=(8,)).astype(np.float32)
    X = r.normal(size=(100, 8)).astype(np.float32)
    y = X @ w_true + 0.1 * r.normal(size=(100,))
    put("mh", X, (y > 0).astype(np.float32))
    put("st", rng.normal(size=(WORLD * 300 + 5, 6)),
        rng.normal(size=WORLD * 300 + 5))
    X = rng.normal(size=(WORLD * 512, 8)).astype(np.float32)
    wt = rng.uniform(-1, 1, 8).astype(np.float32)
    put("gs", X, X @ wt + 0.05 * rng.normal(size=WORLD * 512))
    put("tt", rng.normal(size=(400, 16)), rng.normal(size=400))
    X, y, _ = linear_data(4100, 10, seed=4)
    put("lb", X, y)
    put("ne", rng.normal(size=(2051, 8)), rng.normal(size=2051))
    X, y, _ = linear_data(4096, 8, seed=29)
    put("ne2", X, y)
    return d


def _jgd(mode="bernoulli", frac=0.2, iters=ITERS, step=0.4, k=1, wc=None,
         seed=42):
    o = (jt.GradientDescent().set_step_size(step).set_num_iterations(iters)
         .set_mini_batch_fraction(frac).set_sampling(mode)
         .set_convergence_tol(0.0).set_seed(seed).set_host_streaming(True)
         .set_mesh(jdata_mesh()))
    if k > 1:
        o.set_superstep(k)
    if wc:
        o.set_ingest_options(wire_compress=wc)
    return o


def _jef(sampling="bernoulli"):
    return _jgd(sampling, frac=0.5, step=0.05, seed=7, wc="topk:0.25")


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The inputs, the JAX package's preempted meshed compressed run
    (its checkpoint for the ranks to resume), and every rank's outputs
    from one 8-rank gloo job (retried on a fresh port if its launch
    fails)."""
    from tpu_sgd.reliability import failpoints as jfp

    tmp = tmp_path_factory.mktemp("torch_mesh_streamed")
    inp = _inputs()
    np.savez(tmp / "inputs.npz", **inp)
    np.save(tmp / "gd_X.npy", inp["gd_X"])
    torch.from_numpy(inp["gd_X"]).to(torch.bfloat16).view(
        torch.int16).numpy().tofile(tmp / "gd_X.bf16")
    with jfp.inject_faults({"optimize.streamed.step": jfp.fail_nth(7)}):
        with pytest.raises(jfp.FaultInjected):
            _jef().set_checkpoint(JCheckpointManager(str(tmp / "jax_ck")),
                                  every=5).optimize_with_history(
                (inp["ef_X"], inp["ef_y"]), np.zeros(16, np.float32))
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    logs = []
    for _ in range(3):
        for d in glob.glob(str(tmp / "*")):
            if os.path.isdir(d) and not d.endswith("jax_ck"):
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
            return inp, outs, tmp
    for r, text in enumerate(logs):
        print(f"--- rank {r} ---\n{text[-3000:]}")
    pytest.fail("the 8-rank gloo world failed on 3 ports; see the logs")


def _close(got, ref, rtol=2e-4, atol=2e-3):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=rtol,
                               atol=atol)


def _same(a, b):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _single_thread(fn):
    """``fn()`` on one CPU thread, as the ranks run: the bitwise
    references must add in the ranks' order inside each product too."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return fn()
    finally:
        torch.set_num_threads(before)


def _rank_order(parts):
    total = parts[0]
    for p in parts[1:]:
        total = total + p
    return total


def _shares(sampler, draw, X, y, k):
    """Each rank's ``(X, y, valid)`` share of one global batch, as the
    ranks stage it: padding rows zero (windows, full batch) or row 0
    (gathers), never valid."""
    n, d = X.shape
    share = sampler.share
    out = []
    for r in range(k):
        lo = r * share
        if draw[0] in ("full", "window"):
            count, s0 = ((n, 0) if draw[0] == "full"
                         else (sampler.m, draw[1]))
            a, b = min(lo, count), min(lo + share, count)
            Xs = torch.zeros((share, d))
            ys = torch.zeros((share,))
            Xs[:b - a] = X[s0 + a:s0 + b]
            ys[:b - a] = y[s0 + a:s0 + b]
            v = torch.arange(share) < b - a
        else:
            idx = torch.from_numpy(draw[1][lo:lo + share])
            Xs, ys = X[idx], y[idx]
            v = torch.arange(share) < min(max(draw[2] - lo, 0), share)
        out.append((Xs, ys, v))
    return out


def streamed_rank_order(X, y, cfg, k, topk=None):
    """The meshed streamed run's arithmetic in one process: the global
    sample of iteration ``i``, each rank's share summed by the gradient,
    the sums (or the loss and count, then each rank's top-k segment of
    its error-feedback accumulator) added in rank order, then the
    update.  Least squares, simple updater."""
    g, u = tst.LeastSquaresGradient(), tst.SimpleUpdater()
    X, y = torch.as_tensor(X), torch.as_tensor(y)
    n, d = X.shape
    sampler = HostSampler(cfg, n, 0, k)
    w = torch.zeros(d)
    _, reg0 = u.compute(w, torch.zeros_like(w), 0.0, 1, cfg.reg_param)
    reg = torch.full((), float(reg0))
    efs = [torch.zeros(d) for _ in range(k)]
    hist = []
    for i in range(1, cfg.num_iterations + 1):
        it = torch.full((1,), i, dtype=torch.int64)
        sums = [g.batch_sums(Xs, ys, w, v)
                for Xs, ys, v in _shares(sampler, sampler.draw(i), X, y, k)]
        if topk is None:
            tot = _rank_order([torch.cat([gs, ls.reshape(1), cs.reshape(1)])
                               for gs, ls, cs in sums])
            c = tot[d + 1]
            safe = torch.clamp(c, min=1.0)
            loss = tot[d] / safe + reg
            new_w, new_reg = u.compute(w, tot[:d] / safe, cfg.step_size, it,
                                       cfg.reg_param)
        else:
            tot = _rank_order([torch.cat([ls.reshape(1), cs.reshape(1)])
                               for _, ls, cs in sums])
            c = tot[1]
            safe = torch.clamp(c, min=1.0)
            loss = tot[0] / safe + reg
            ghat = torch.zeros(d)
            new_efs = []
            for (gs, _, _), ef in zip(sums, efs):
                acc = ef + gs / safe
                top = topk_indices(acc, topk_nnz(d, topk))
                ghat.index_put_((top,), ghat.index_select(0, top)
                                + acc.index_select(0, top))
                new_efs.append(acc.index_fill(0, top, 0.0))
            new_w, new_reg = u.compute(w, ghat, cfg.step_size, it,
                                       cfg.reg_param)
        if bool(c > 0):
            hist.append(float(loss))
            w, reg = new_w, new_reg
            if topk is not None:
                efs = new_efs
    return w.numpy(), np.asarray(hist, np.float32)


# ---- the world ----------------------------------------------------------------

def test_every_rank_ran_in_one_world_and_imported_no_jax(world):
    _, outs, _ = world
    for r, o in enumerate(outs):
        assert o["rank"].tolist() == [r, WORLD]
        assert o["spans"].tolist() == [False, True]
        assert o["leaked"].size == 0, o["leaked"]
        # a file map and a read-only memmap enter without a copy
        assert o["maps_wrapped"].tolist() == [True, True]


def test_every_rank_holds_the_same_results_bitwise(world):
    """Weights, histories, the CostFun's sums and the totals on every
    rank; a rank's statistics stack is its own slice's."""
    _, outs, _ = world
    keys = [k for k in outs[0] if k.endswith(("_w", "_h", "_sums",
                                                "_sweep"))
            or k.startswith("tt_")]
    assert len(keys) > 80
    for k in keys:
        for o in outs[1:]:
            np.testing.assert_array_equal(o[k], outs[0][k], err_msg=k)


# ---- streamed SGD on the mesh (test_gradient_descent.py:230) -----------------

@pytest.mark.parametrize("mode", MODES)
def test_meshed_streamed_sgd_matches_the_jax_mesh(world, mode):
    """The same host sampler draws the same global samples; each JAX
    device and each rank sums its share.  History rtol 1e-4 and weights
    rtol 1e-4 / atol 1e-5 (test_gradient_descent.py:230's bound)."""
    inp, outs, _ = world
    samp, frac = ("bernoulli", 1.0) if mode == "full" else (mode, 0.2)
    jw, jh = _jgd(samp, frac).optimize_with_history(
        (inp["gd_X"], inp["gd_y"]), np.zeros(6, np.float32))
    o = outs[0]
    assert len(o[f"sgd_{mode}_h"]) == len(jh) == ITERS
    _close(o[f"sgd_{mode}_h"], jh, rtol=1e-4, atol=0)
    _close(o[f"sgd_{mode}_w"], jw, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("mode", MODES)
def test_meshed_streamed_sgd_is_the_one_process_rank_order_sum(world, mode):
    inp, outs, _ = world
    samp, frac = ("bernoulli", 1.0) if mode == "full" else (mode, 0.2)
    cfg = tst.SGDConfig(step_size=0.4, num_iterations=ITERS,
                        mini_batch_fraction=frac, convergence_tol=0.0,
                        seed=42, sampling=samp)
    w, h = _single_thread(lambda: streamed_rank_order(
        inp["gd_X"], inp["gd_y"], cfg, WORLD))
    _same(outs[0][f"sgd_{mode}_w"], w)
    _same(outs[0][f"sgd_{mode}_h"], h)


@pytest.mark.parametrize("mode", MODES)
def test_meshed_streamed_sgd_repeats_and_fuses_bitwise(world, mode):
    """Two runs, prefetch depth 0 against 2, K = 4 against K = 1."""
    o = world[1][0]
    for other in ("again", "k4", "depth0"):
        _same(o[f"sgd_{mode}_{other}_w"], o[f"sgd_{mode}_w"])
        _same(o[f"sgd_{mode}_{other}_h"], o[f"sgd_{mode}_h"])


def test_meshed_streamed_sgd_bf16_host_map_and_wire(world):
    """A bf16 host map and the bf16 wire stream the same bf16 rows; the
    f32 run is the gradient tier away."""
    o = world[1][0]
    _same(o["sgd_bf16_w"], o["sgd_bf16_wire_w"])
    _same(o["sgd_bf16_h"], o["sgd_bf16_wire_h"])
    _close(o["sgd_bf16_h"], o["sgd_bernoulli_h"], rtol=2e-2, atol=1e-3)


def test_meshed_streamed_listener_stop_and_resume(world):
    """Every rank's listener sees every iteration; a stop raised by the
    last rank's signal alone stops every rank at the same iteration
    (the iteration itself at K = 1, the block's end at K = 4), and the
    resume from rank 0's checkpoint is bitwise the uninterrupted run."""
    for o in world[1]:
        _same(o["sgd_listener_w"], o["sgd_bernoulli_w"])
        assert int(o["sgd_listener_events"]) == ITERS
        assert int(o["sgd_stop1_at"]) == STOP_AT
        assert int(o["sgd_stop4_at"]) == 16
        for k in (1, 4):
            _same(o[f"sgd_resume{k}_w"], o["sgd_bernoulli_w"])
            _same(o[f"sgd_resume{k}_h"], o["sgd_bernoulli_h"])


def test_meshed_streaming_refuses_what_the_reference_refuses(world):
    """test_gradient_descent.py:254 (a 2-D mesh), sparse host streaming
    on a mesh, ``resident_rows`` on a mesh, and a mesh over two hosts,
    each with the JAX package's message; ``set_residency`` warns."""
    o = world[1][0]
    assert "build single-host" in str(o["raise_two_hosts"])
    assert "resident_rows composes with a single device" in str(
        o["raise_resident"])
    assert any("single-device full-batch" in m for m in o["warn_residency"])
    X, y, _ = linear_data(100, 3, seed=10)
    two_d = par.Mesh({par.DATA_AXIS: 4, par.MODEL_AXIS: 2})
    with pytest.raises(NotImplementedError, match="host streaming"):
        tst.GradientDescent(device="cpu").set_host_streaming() \
            .set_mesh(two_d).optimize((X, y), np.zeros(3, np.float32))
    Xs = torch.eye(4).to_sparse_csr()
    with pytest.raises(NotImplementedError, match="single-device"):
        tst.GradientDescent(device="cpu").set_host_streaming() \
            .set_mesh(par.Mesh({par.DATA_AXIS: 2})).optimize(
                (Xs, np.ones(4, np.float32)), np.zeros(4, np.float32))
    split = par.Mesh({par.DATA_AXIS: 2}, hosts=["a", "b"])
    with pytest.raises(NotImplementedError, match="build single-host"):
        tst.GradientDescent(device="cpu").set_host_streaming() \
            .set_mesh(split).optimize((X, y), np.zeros(3, np.float32))
    with pytest.raises(NotImplementedError, match="streamed normal totals"):
        tst.NormalEquations(device="cpu").set_mesh(split) \
            .set_host_streaming(True).optimize((X, y), np.zeros(3))


# ---- the compressed wire (test_sparse_wire.py:230, :258) ---------------------

def test_meshed_compressed_wire_matches_the_jax_mesh(world):
    """Each rank's accumulator its own, the segments gathered and added
    in rank order: the JAX package's all-gather and scatter-add add in
    XLA's order, so the two meet at the per-step tier."""
    inp, outs, _ = world
    jw, jh = _jgd(frac=0.5, iters=60, step=0.05, seed=7,
                  wc="topk:0.5").optimize_with_history(
        (inp["sw_X"], inp["sw_y"]), np.zeros(20, np.float32))
    o = outs[0]
    assert len(o["cw1_h"]) == len(jh) == 60
    _close(o["cw1_h"], jh)
    _close(o["cw1_w"], jw)


def test_meshed_compressed_wire_is_the_rank_order_sum_and_fuses(world):
    inp, outs, _ = world
    o = outs[0]
    cfg = tst.SGDConfig(step_size=0.05, num_iterations=60,
                        mini_batch_fraction=0.5, convergence_tol=0.0,
                        seed=7, sampling="bernoulli")
    w, h = _single_thread(lambda: streamed_rank_order(
        inp["sw_X"], inp["sw_y"], cfg, WORLD, topk=0.5))
    _same(o["cw1_w"], w)
    _same(o["cw1_h"], h)
    for other in ("cw4", "cw_again"):
        _same(o[other + "_w"], o["cw1_w"])
        _same(o[other + "_h"], o["cw1_h"])
    # matched loss against the meshed dense wire (the reference's 2%)
    assert abs(o["cw1_h"][-1] - o["cw_dense_h"][-1]) <= 0.02 * abs(
        o["cw_dense_h"][-1])
    assert len(o["cw_full4_h"]) == 12


def test_meshed_compressed_builders_are_the_streamed_full_batch(world):
    """``dp_compressed_step_fn``, ``dp_compressed_shared_superstep_fn``
    and ``dp_compressed_superstep_fn`` on a rank's rows at full batch: the
    step loop, the K = 4 shared-batch blocks and the K = 4 per-step-batch
    blocks are bitwise one another and the meshed streamed full-batch
    run on the same shares (``cw_full4``); the blocks return the rank's
    (K, d) accumulators."""
    for o in world[1]:
        for key in ("dp_shared", "dp_stacked"):
            _same(o[key + "_w"], o["dp_step_w"])
            _same(o[key + "_h"], o["dp_step_h"])
            _same(o[key + "_ef"], o["dp_step_ef"])
            assert o[key + "_ef_rows"].tolist() == [4, 20]
        _same(o["dp_step_w"], o["cw_full4_w"])
        _same(o["dp_step_h"], o["cw_full4_h"])


@pytest.mark.parametrize("sampling", ["bernoulli", "sliced", "indexed"])
def test_meshed_ef_state_resumes_bitwise_across_preemption(world, sampling):
    """The (n_shards, d) accumulators ride rank 0's checkpoint and come
    back one row a rank: the resumed run is bitwise the uninterrupted
    one, which is the JAX mesh's at the per-step tier."""
    inp, outs, _ = world
    o = outs[0]
    assert "FaultInjected" in str(o[f"ef_crash_{sampling}"])
    _same(o[f"ef_res_{sampling}_w"], o[f"ef_ref_{sampling}_w"])
    _same(o[f"ef_res_{sampling}_h"], o[f"ef_ref_{sampling}_h"])
    if sampling == "bernoulli":
        jw, jh = _jef().optimize_with_history(
            (inp["ef_X"], inp["ef_y"]), np.zeros(16, np.float32))
        _close(o["ef_ref_bernoulli_h"], jh)
        _close(o["ef_ref_bernoulli_w"], jw)


def test_meshed_compressed_checkpoints_cross_packages(world):
    """Each package resumes the other's preempted meshed compressed run
    (its (8, d) accumulator rows included) and lands on its own
    uninterrupted run at the per-step tier."""
    inp, outs, tmp = world
    o = outs[0]
    state = JCheckpointManager(str(tmp / "port_ck")).restore()
    assert np.asarray(state["extras"]["ef"]).shape == (WORLD, 16)
    assert state["iteration"] == 5
    jw_ref, jh_ref = _jef().optimize_with_history(
        (inp["ef_X"], inp["ef_y"]), np.zeros(16, np.float32))
    _close(o["ef_from_jax_h"], jh_ref)
    _close(o["ef_from_jax_w"], jw_ref)
    jw, jh = _jef().set_checkpoint(JCheckpointManager(str(tmp / "port_ck")),
                                   every=5).optimize_with_history(
        (inp["ef_X"], inp["ef_y"]), np.zeros(16, np.float32))
    _close(jh, o["ef_ref_bernoulli_h"])
    _close(jw, o["ef_ref_bernoulli_w"])


def test_grid_meshed_cells(world):
    """test_composition.py:220: meshed x resident warns and runs the
    superstep driver (bitwise); meshed x compressed stays within the
    matched loss of the meshed dense wire; the meshed superstep run
    against the JAX mesh's."""
    inp, outs, _ = world
    o = outs[0]
    assert any("single-device full-batch" in m for m in o["cg_warn"])
    _same(o["cg_resident_w"], o["cg_super_w"])
    _same(o["cg_resident_h"], o["cg_super_h"])
    assert abs(o["cg_comp_h"][-1] - o["cg_dense_h"][-1]) <= 0.01 * abs(
        o["cg_dense_h"][-1])
    jw, jh = _jgd(frac=0.5, iters=12, step=0.1, k=4, seed=7) \
        .optimize_with_history((inp["cg_X"], inp["cg_y"]),
                               np.zeros(16, np.float32))
    _close(o["cg_super_h"], jh)
    _close(o["cg_super_w"], jw)


# ---- the streamed CostFun (test_streamed_costfun.py:201, :226) ---------------

def test_meshed_streamed_lbfgs_and_owlqn_match_the_jax_mesh(world):
    """Each rank's share of each chunk, the sums combined once an
    evaluation (the JAX mesh combines each chunk): history rtol 5e-5,
    weights rtol 5e-4 / atol 5e-5 (the reference test's bound)."""
    inp, outs, _ = world
    from tpu_sgd.ops.gradients import LogisticGradient
    from tpu_sgd.ops.updaters import SquaredL2Updater
    from tpu_sgd.optimize.lbfgs import LBFGS
    from tpu_sgd.optimize.owlqn import OWLQN

    data = (inp["cf_X"], inp["cf_y"])
    jw, jh = LBFGS(LogisticGradient(), SquaredL2Updater(),
                   max_num_iterations=12, convergence_tol=0.0,
                   reg_param=0.01).set_host_streaming(True, batch_rows=512) \
        .set_mesh(jdata_mesh()).optimize_with_history(
            data, np.zeros(12, np.float32))
    o = outs[0]
    assert len(o["cf_lbfgs_h"]) == len(jh)
    _close(o["cf_lbfgs_h"], jh, rtol=5e-5, atol=1e-6)
    _close(o["cf_lbfgs_w"], jw, rtol=5e-4, atol=5e-5)
    _same(o["cf_lbfgs_again_w"], o["cf_lbfgs_w"])
    _same(o["cf_lbfgs_again_h"], o["cf_lbfgs_h"])
    jw, jh = OWLQN(LogisticGradient(), reg_param=0.01, max_num_iterations=8,
                   convergence_tol=0.0).set_host_streaming(
        True, batch_rows=512).set_mesh(jdata_mesh()).optimize_with_history(
            data, np.zeros(12, np.float32))
    assert len(o["cf_owlqn_h"]) == len(jh)
    _close(o["cf_owlqn_h"], jh, rtol=5e-5, atol=1e-6)
    _close(o["cf_owlqn_w"], jw, rtol=5e-4, atol=5e-5)


def _costfun_rank_order(X, y, w, cap, k, W=None):
    """The meshed CostFun's sums in one process: each rank's share of
    each chunk (full shares unmasked, the rest zero-padded and masked),
    added chunk by chunk, then the ranks' sums in rank order."""
    g = tst.LogisticGradient()
    X, y = torch.as_tensor(X), torch.as_tensor(y)
    n, d = X.shape
    share = cap // k
    per_rank = []
    for r in range(k):
        accs = None
        for i in range(-(-n // cap)):
            s = min(i * cap + r * share, n)
            e = min(s + share, n)
            if e - s == share:
                Xc, yc, m = X[s:e], y[s:e], None
            else:
                Xc, yc = torch.zeros((share, d)), torch.zeros((share,))
                Xc[:e - s], yc[:e - s] = X[s:e], y[s:e]
                m = torch.arange(share) < e - s
            out = (g.batch_sums(Xc, yc, w, mask=m) if W is None
                   else g.loss_sweep(Xc, yc, W, mask=m))
            if accs is None:
                accs = [t.clone() for t in out]
            else:
                for a, t in zip(accs, out):
                    a += t
        per_rank.append(torch.cat([t.reshape(-1) for t in accs]))
    return _rank_order(per_rank).numpy()


def test_meshed_costfun_pads_the_cap_and_sums_in_rank_order(world):
    """700 rows at batch_rows=250: the cap pads to 256 (32 a rank), 3
    chunks, the last rank's share of the tail empty; the count is exact
    and the sums are the one-process rank-order sums, bitwise, and the
    JAX package's at its test's bound."""
    from tpu_sgd.ops.gradients import LogisticGradient
    from tpu_sgd.optimize.streamed_costfun import (
        StreamedCostFun as JStreamedCostFun,
    )

    inp, outs, _ = world
    o = outs[0]
    assert o["cap_grid"].tolist() == [256, 32, 3]
    X, y, w = inp["cap_X"], inp["cap_y"], inp["cap_w"]
    jscf = JStreamedCostFun(LogisticGradient(), X, y, batch_rows=250,
                            mesh=jdata_mesh())
    assert jscf.cap == 256 and jscf.n_chunks == 3
    jg, jl, jc = (np.asarray(v) for v in jscf.cost_sums(w))
    assert o["cap_sums"][-1] == jc == 700
    _close(o["cap_sums"][:-2], jg, rtol=2e-5, atol=2e-4)
    _close(o["cap_sums"][-2], jl, rtol=2e-5, atol=2e-4)
    wt = torch.as_tensor(w)
    _same(o["cap_sums"], _single_thread(lambda: _costfun_rank_order(
        X, y, wt, 256, WORLD)))
    _same(o["cap_sweep"], _single_thread(lambda: _costfun_rank_order(
        X, y, wt, 256, WORLD, W=torch.stack([wt, -wt]))))


def _jax_resident_lbfgs(inp, iters):
    from tpu_sgd.ops.gradients import LogisticGradient
    from tpu_sgd.ops.updaters import SquaredL2Updater
    from tpu_sgd.optimize.lbfgs import LBFGS

    return LBFGS(LogisticGradient(), SquaredL2Updater(), reg_param=0.01,
                 max_num_iterations=iters).optimize_with_history(
        (inp["mh_X"], inp["mh_y"]), np.zeros(8, np.float32))


def test_multihost_streamed_costfun_matches_single_process(world):
    """test_multihost.py:166: a mesh declared over two hosts, each rank
    streaming its local rows on the agreed grid (40-row chunks, 5 rows
    a rank, 3 chunks for the longest rank's 13 rows), against the
    single-process resident run."""
    inp, outs, _ = world
    jw, jh = _jax_resident_lbfgs(inp, 8)
    o = outs[0]
    assert o["mh_grid"].tolist() == [5, 5, 3]
    assert len(o["mh_h"]) == len(jh)
    _close(o["mh_w"], jw, rtol=1e-3, atol=1e-4)
    _close(o["mh_h"], jh, rtol=1e-4, atol=1e-6)


def test_multihost_costfun_zero_row_rank(world):
    """test_multihost.py:190: rank 0 holds every row and seven ranks hold
    none; they join every combine with all-invalid chunks, and the job
    ends on the single-process run."""
    inp, outs, _ = world
    jw, jh = _jax_resident_lbfgs(inp, 4)
    o = outs[0]
    assert len(o["mh_zero_h"]) == len(jh)
    _close(o["mh_zero_w"], jw, rtol=1e-3, atol=1e-4)


# ---- the streamed statistics (test_gram.py:900, 934, 953, 989, 1074) ---------

def test_streamed_sharded_stats_match_each_ranks_resident_build(world):
    """Each rank's streamed stack is bitwise the port's resident build of
    its slice's whole blocks (the n % k remainder and the slice's tail
    dropped), and the JAX package's per-shard statistics at its test's
    bound."""
    from tpu_sgd.parallel.gram_parallel import (
        build_streamed_sharded_gram_stats as jbuild,
    )

    inp, outs, _ = world
    X, y = inp["st_X"], inp["st_y"]
    n_local = X.shape[0] // WORLD
    stats, jB, jn = jbuild(jdata_mesh(), X, y, block_rows=64,
                           batch_rows=128)
    jPG, jPb, _, jGt, _, jyy = (np.asarray(s) for s in stats)
    for r, o in enumerate(outs):
        B, n_used = o["st_geom"].tolist()
        assert (B, n_used) == (jB, jn) == (64, (n_local // 64) * 64)
        s = r * n_local
        ref = _single_thread(lambda: tst.GramLeastSquaresGradient.build(
            X[s:s + n_used], y[s:s + n_used], block_rows=64,
            device="cpu")).data
        for leaf in ("PG", "Pb", "Pyy", "G_tot", "b_tot", "yy_tot"):
            _same(o["st_" + leaf], getattr(ref, leaf).numpy())
        _close(o["st_PG"], jPG[r], rtol=1e-5, atol=1e-3)
        _close(o["st_Pb"], jPb[r], rtol=1e-5, atol=1e-4)
        _close(o["st_G_tot"], jGt[r], rtol=1e-5, atol=1e-3)
        _close(o["st_yy_tot"], jyy[r], rtol=1e-5, atol=0)


def test_sharded_streamed_build_resumes_bitwise(world):
    """test_gram.py:1074: a build stopped in each rank's feed keeps its
    finished chunks under shard_<rank>, and the build from the same
    directory (at another chunk size) is bitwise the uninterrupted
    one."""
    for o in world[1]:
        assert "FaultInjected" in str(o["st_stopped"])
        assert int(o["st_parts"]) >= 2  # the meta and a chunk at least
        assert bool(o["st_resumed_equal"])


def test_sharded_build_rejects_a_model_axis():
    """test_gram.py:934: the builders need a 1-D 'data' mesh (the port's
    Mesh cannot lack the data axis: it raises at construction)."""
    from tpu_sgd_torch.parallel.gram_parallel import (
        build_streamed_sharded_gram_stats,
        build_streamed_total_stats,
    )

    X = np.zeros((64, 4), np.float32)
    two_d = par.Mesh({par.DATA_AXIS: 2, par.MODEL_AXIS: 2})
    for build in (build_streamed_sharded_gram_stats,
                  build_streamed_total_stats):
        with pytest.raises(NotImplementedError, match="1-D 'data' mesh"):
            build(two_d, X, X[:, 0], block_rows=16, device="cpu")
    with pytest.raises(ValueError, match="'data' axis"):
        par.Mesh({par.MODEL_AXIS: 2})


def test_streamed_stats_mesh_matches_resident_aligned_dp(world):
    """test_gram.py:953 and :989: the meshed virtual run equals the
    meshed resident aligned run on each rank's rows, bitwise (the same
    statistics and windows), repeats from its cached build, and the
    release frees it; at full batch it is the JAX mesh's run."""
    inp, outs, _ = world
    o = outs[0]
    _same(o["gs_virtual_w"], o["gs_resident_w"])
    _same(o["gs_virtual_h"], o["gs_resident_h"])
    _same(o["gs_virtual_again_h"], o["gs_virtual_h"])
    assert o["gs_virtual_h"][-1] < o["gs_virtual_h"][0]
    assert bool(o["gs_cached"]) and bool(o["gs_released"])
    jw, jh = (jt.GradientDescent().set_step_size(0.3)
              .set_num_iterations(20).set_convergence_tol(0.0)
              .set_mesh(jdata_mesh()).set_gram_options(block_rows=64)
              .set_streamed_stats(True)
              .optimize_with_history((inp["gs_X"], inp["gs_y"]),
                                     np.zeros(8, np.float32)))
    _close(o["gs_full_h"], jh, rtol=1e-5, atol=1e-6)
    _close(o["gs_full_w"], jw, rtol=1e-5, atol=1e-6)


def test_chunk_iters_warning_on_meshed_streamed_stats(world):
    """test_gradient_descent.py:537."""
    assert any("chunk_iters applies" in m
               for m in world[1][0]["gs_chunk_warn"])


def test_streamed_totals_dense_and_compressed_merge(world):
    """test_sparse_wire.py:128: the dense merge gives every rank the same
    f64 totals (G rounded to f32 as the statistics store it), the JAX
    package's at the statistics tier; the compressed merge is within
    1e-6 relative of it; the wire counts what the gather moves, each
    rank's dense f64 carry, and no top-k segment (none crossed)."""
    from tpu_sgd.parallel.gram_parallel import (
        build_streamed_total_stats as jbuild,
    )

    inp, outs, _ = world
    o = outs[0]
    d = 16
    assert o["tt_dtypes"].tolist() == ["torch.float32", "torch.float64"]
    dense, comp = o["tt_dense"], o["tt_comp"]
    np.testing.assert_allclose(comp, dense, rtol=1e-6,
                               atol=1e-6 * np.abs(dense).max())
    j = jbuild(jdata_mesh(), inp["tt_X"], inp["tt_y"], block_rows=32)
    ref = np.concatenate([np.asarray(j.G_tot, np.float64).reshape(-1),
                          np.asarray(j.b_tot), [float(j.yy_tot)]])
    _close(dense, ref, rtol=1e-5, atol=1e-4)
    for snap in json.loads(str(o["tt_wire"])):
        wire = {k: v for k, v in snap.items() if ".wire." in k
                and not k.endswith(".logical")}
        assert [k.split(".wire.")[1] for k in wire] == ["dense-f64"], wire
        (got,) = wire.values()
        assert got == {"n": 1, "bytes": (d * d + d + 1) * 8}
    assert bool(o["tt_resume_equal"]) and bool(o["tt_resume_gone"])


def test_meshed_lbfgs_streamed_stats_matches_stock(world):
    """test_lbfgs.py:186 (and the compressed merge feeding it,
    test_sparse_wire.py:165): every rank streams its slice into totals,
    merged once, then the run goes unmeshed; against the stock
    full-batch run; the build is cached."""
    inp, outs, _ = world
    from tpu_sgd.optimize.lbfgs import LBFGS

    jw, jh = LBFGS(jt.LeastSquaresGradient(), jt.SimpleUpdater(),
                   max_num_iterations=12, convergence_tol=0.0) \
        .optimize_with_history((inp["lb_X"], inp["lb_y"]),
                               np.zeros(10, np.float32))
    o = outs[0]
    L = min(len(jh), len(o["lbs_h"]))
    assert L >= 4
    _close(o["lbs_h"][:L], np.asarray(jh)[:L], rtol=1e-4, atol=1e-6)
    _close(o["lbs_w"], jw, rtol=1e-3, atol=1e-4)
    assert bool(o["lbs_cached"])
    _close(o["lbs_comp_w"], o["lbs_w"], rtol=1e-3, atol=1e-4)
    assert abs(o["lbs_comp_h"][-1] - o["lbs_h"][-1]) <= max(
        0.01 * abs(o["lbs_h"][-1]), 1e-5)


def test_normal_host_streamed_meshed_matches_single(world):
    """test_normal.py:96 (n % 8 != 0: the last rank takes the remainder;
    batch_rows=64 below a slice's 256 rows) and test_parallel.py:225 (a
    trivial model axis), against the single-device streamed solve."""
    from tpu_sgd.optimize.normal import NormalEquations

    inp, outs, _ = world
    o = outs[0]
    for key, name in (("ne_w", "ne"), ("ne_trivial_w", "ne2")):
        X, y = inp[name + "_X"], inp[name + "_y"]
        ref = NormalEquations(reg_param=0.01).set_host_streaming(True) \
            .optimize((X, y), np.zeros(8, np.float32))
        _close(o[key], ref, rtol=1e-5, atol=1e-6)
        port = tst.NormalEquations(reg_param=0.01, device="cpu") \
            .set_host_streaming(True).optimize((X, y),
                                               np.zeros(8, np.float32))
        _close(o[key], port.numpy(), rtol=1e-5, atol=1e-6)

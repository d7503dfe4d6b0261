"""Async elastic multi-replica training in the port (``tpu_sgd_torch/
replica/``): the twins of ``tests/test_replica.py`` on the CPU.

Tolerances, by tier:

* exact — ``shard_rows``' layout against ``pad_to_multiple`` and the JAX
  package's, the staleness contract's decisions against the JAX
  package's, versions and ``pushes_accepted``, checkpoint contents;
* bitwise within the port — a τ=0 run (2 and 4 workers, uneven shards
  with the padding mask, logistic full batch, the convergence early
  exit, healed push/pull faults, a supervised preempt and resume)
  equals the one-process rank-order reference of
  ``tests/torch_replica_reference.py``;
* across frameworks — a τ=0 full-batch run against the JAX package's
  ``ReplicaDriver`` at the gradient tier (weights rtol 2e-4 / atol
  2e-3, history rtol 2e-4); sampled and τ ≥ 1 runs at a matched exact
  objective ≤ 1.01× the JAX package's synchronous meshed run (sample
  bits differ between ``jax.random`` and torch).

The async runs depend on thread scheduling, so they are held to the
invariants the JAX tests use: the staleness bound never violated in the
trace, EF mass conserved on rejection.  Every threaded run joins with a
deadline.
"""

import os
import sys
import threading
import warnings

import jax
import numpy as np
import pytest
import torch

import tpu_sgd_torch as tst
from torch_replica_reference import (ListSink, data, full_objective,
                                     rank_order_reference)
from tpu_sgd_torch.ops import cuda_kernels as ck
from tpu_sgd_torch.reliability import failpoints as fp
from tpu_sgd_torch.reliability.retry import RetryPolicy
from tpu_sgd_torch.replica import (ParameterStore, ReplicaDriver,
                                   ReplicaMembership, ReplicaWorker,
                                   StalenessContract, shard_rows)
from tpu_sgd_torch.utils.checkpoint import CheckpointManager
from tpu_sgd_torch.utils.events import CollectingListener

GRAD_RTOL, GRAD_ATOL, HIST_RTOL = 2e-4, 2e-3, 2e-4
OBJECTIVE_RATIO = 1.01


def _driver(gradient=None, updater=None, *, iters=24, frac=0.5, step=0.3,
            reg=0.1, workers=4, tau=0, tol=0.0, sampling="bernoulli"):
    return (ReplicaDriver(gradient or tst.LeastSquaresGradient(),
                          updater or tst.SquaredL2Updater(), device="cpu")
            .set_step_size(step).set_num_iterations(iters)
            .set_mini_batch_fraction(frac).set_convergence_tol(tol)
            .set_reg_param(reg).set_workers(workers).set_staleness(tau)
            .set_sampling(sampling))


def _jax_sync(X, y, w0, *, iters, frac, step, reg, workers):
    """The JAX package's synchronous meshed run (the JAX twins' reference
    of a matched objective)."""
    from jax.sharding import Mesh

    from tpu_sgd.ops.gradients import LeastSquaresGradient
    from tpu_sgd.ops.updaters import SquaredL2Updater
    from tpu_sgd.optimize.gradient_descent import GradientDescent
    from tpu_sgd.parallel.mesh import DATA_AXIS

    mesh = Mesh(np.asarray(jax.devices()[:workers]), (DATA_AXIS,))
    w, _ = (GradientDescent(LeastSquaresGradient(), SquaredL2Updater())
            .set_step_size(step).set_num_iterations(iters)
            .set_mini_batch_fraction(frac).set_convergence_tol(0.0)
            .set_reg_param(reg).set_mesh(mesh)
            .optimize_with_history((X, y), w0))
    return np.asarray(w)


@pytest.fixture(scope="module")
def async_problem():
    """The async twins' problem and the JAX package's synchronous
    objective on it (160 full-batch iterations, 4 shards)."""
    X, y, w0 = data(n=512, d=10, seed=11)
    w = _jax_sync(X, y, w0, iters=160, frac=1.0, step=0.2, reg=0.01,
                  workers=4)
    return X, y, w0, full_objective(X, y, w, 0.01)


# -- staleness contract and layout ---------------------------------------------


def test_staleness_contract_decisions_equal_the_jax_package():
    """Exact: every (head, basis) decision of the port's contract is the
    JAX package's, at every bound; the same inputs raise."""
    import math

    from tpu_sgd.replica import StalenessContract as JaxContract

    for tau in (0, 1, 2, 4, None, math.inf):
        ours, ref = StalenessContract(tau), JaxContract(tau)
        assert (ours.tau, ours.synchronous, ours.bounded) == (
            ref.tau, ref.synchronous, ref.bounded)
        assert ours.describe() == ref.describe()
        for head in range(8):
            for basis in range(head + 1):
                a, b = ours.check(head, basis), ref.check(head, basis)
                assert (a.admissible, a.staleness) == (b.admissible,
                                                       b.staleness)
    for bad in (-1, 1.5):
        with pytest.raises(ValueError):
            StalenessContract(bad)
    with pytest.raises(ValueError):
        StalenessContract(2).check(3, 5)  # basis ahead of head


@pytest.mark.parametrize("n", [203, 200])
def test_shard_rows_matches_mesh_layout(n):
    """Exact: shard ``i`` holds the rows of ``pad_to_multiple``'s block
    ``i`` (the JAX package's too), from host rows and from a tensor; a
    tensor's blocks are views of it when no padding is needed."""
    from tpu_sgd.replica import shard_rows as jax_shard_rows
    from tpu_sgd_torch.parallel.data_parallel import pad_to_multiple

    X, y, _ = data(n=n, d=5)
    Xp, yp, valid = pad_to_multiple(X, y, 4)
    rows = Xp.shape[0] // 4
    jax_shards = jax_shard_rows(X, y, 4)
    Xt, yt = torch.as_tensor(X), torch.as_tensor(y)
    for src in (shard_rows(X, y, 4), shard_rows(Xt, yt, 4)):
        for s, (Xs, ys, vs) in enumerate(src):
            sl = slice(s * rows, (s + 1) * rows)
            np.testing.assert_array_equal(np.asarray(Xs), Xp[sl])
            np.testing.assert_array_equal(np.asarray(ys), yp[sl])
            np.testing.assert_array_equal(np.asarray(Xs), jax_shards[s][0])
            if n % 4:
                np.testing.assert_array_equal(np.asarray(vs), valid[sl])
            else:
                assert vs is None and jax_shards[s][2] is None
    for s, (Xs, _, _) in enumerate(shard_rows(Xt, yt, 4)):
        if n % 4 == 0:
            assert Xs.untyped_storage().data_ptr() == \
                Xt.untyped_storage().data_ptr()
            assert Xs.data_ptr() == Xt[s * rows].data_ptr()


# -- τ=0: bitwise the one-process rank-order reference ---------------------------


@pytest.mark.parametrize("workers", [2, 4])
def test_tau0_bitwise_vs_rank_order_reference(workers):
    X, y, w0 = data()
    w_ref, h_ref = rank_order_reference(
        tst.LeastSquaresGradient(), tst.SquaredL2Updater(), X, y, w0,
        workers=workers)
    drv = _driver(workers=workers, tau=0)
    w, h = drv.optimize_with_history((X, y), w0)
    np.testing.assert_array_equal(w.numpy(), w_ref)
    np.testing.assert_array_equal(h, h_ref)
    snap = drv.last_store_snapshot
    assert snap["version"] == 24
    assert snap["max_accepted_staleness"] == 0
    assert snap["pushes_accepted"] == 24 * workers


@pytest.mark.parametrize("sampling", ["bernoulli", "sliced", "indexed"])
def test_tau0_bitwise_uneven_shards_and_simple_updater(sampling):
    """n not divisible by the worker count: the padding mask folds into
    each shard's sample exactly as the meshed step folds it."""
    X, y, w0 = data(n=203, d=7, seed=3)
    w_ref, h_ref = rank_order_reference(
        tst.LeastSquaresGradient(), tst.SimpleUpdater(), X, y, w0,
        workers=4, reg=0.0, sampling=sampling)
    drv = _driver(updater=tst.SimpleUpdater(), workers=4, tau=0, reg=0.0,
                  sampling=sampling)
    w, h = drv.optimize_with_history((X, y), w0)
    np.testing.assert_array_equal(w.numpy(), w_ref)
    np.testing.assert_array_equal(h, h_ref)


def test_tau0_bitwise_logistic_full_batch():
    X, y, w0 = data(n=192, d=6, seed=5)
    y = (y > 0).astype(np.float32)
    w_ref, h_ref = rank_order_reference(
        tst.LogisticGradient(), tst.SquaredL2Updater(), X, y, w0,
        workers=2, frac=1.0, iters=15)
    drv = _driver(tst.LogisticGradient(), workers=2, tau=0, frac=1.0,
                  iters=15)
    w, h = drv.optimize_with_history((X, y), w0)
    np.testing.assert_array_equal(w.numpy(), w_ref)
    np.testing.assert_array_equal(h, h_ref)


def test_tau0_convergence_tol_early_exit():
    """The store's observe_step convergence stops at the reference's
    iteration (same norms rule, same tolerance math)."""
    X, y, w0 = data(n=128, d=6, seed=7)
    kw = dict(iters=60, frac=1.0, step=0.5, reg=0.0, workers=2, tol=1e-3)
    w_ref, h_ref = rank_order_reference(
        tst.LeastSquaresGradient(), tst.SimpleUpdater(), X, y, w0, **kw)
    drv = _driver(updater=tst.SimpleUpdater(), tau=0, **kw)
    w, h = drv.optimize_with_history((X, y), w0)
    assert len(h) < 60, "tolerance never fired; test is vacuous"
    np.testing.assert_array_equal(h, h_ref)
    np.testing.assert_array_equal(w.numpy(), w_ref)
    assert drv.last_store_snapshot["converged"]


def test_tau0_full_batch_matches_the_jax_replica_driver():
    """Across frameworks at full batch (no sampling): the gradient tier."""
    from tpu_sgd.ops.gradients import LeastSquaresGradient
    from tpu_sgd.ops.updaters import SquaredL2Updater
    from tpu_sgd.replica import ReplicaDriver as JaxDriver

    X, y, w0 = data(n=256, d=12, seed=2)
    kw = dict(iters=30, frac=1.0, step=0.3, reg=0.1, workers=4)
    jw, jh = (JaxDriver(LeastSquaresGradient(), SquaredL2Updater())
              .set_step_size(0.3).set_num_iterations(30)
              .set_mini_batch_fraction(1.0).set_convergence_tol(0.0)
              .set_reg_param(0.1).set_workers(4).set_staleness(0)
              .optimize_with_history((X, y), w0))
    w, h = _driver(tau=0, **kw).optimize_with_history((X, y), w0)
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=GRAD_RTOL,
                               atol=GRAD_ATOL)
    np.testing.assert_allclose(h, np.asarray(jh), rtol=HIST_RTOL)


# -- τ>0: the bound holds, asserted from the trace ---------------------------------


@pytest.mark.parametrize("tau", [1, 4])
def test_staleness_bound_never_violated_in_trace(tau):
    from tpu_sgd_torch.obs import spans

    X, y, w0 = data()
    sink = ListSink()
    spans.enable_tracing(sink)
    try:
        drv = _driver(workers=4, tau=tau, iters=48, step=0.1)
        drv.optimize_with_history((X, y), w0)
    finally:
        spans.disable_tracing()
    pushes = [p for k, p in sink.records
              if k == "trace_event" and p["name"] == "replica.push"]
    accepted = [p for p in pushes if p["accepted"]]
    assert len(accepted) == 48, "every applied version leaves one record"
    assert max(p["staleness"] for p in accepted) <= tau
    # rejected pushes (if any) were all OVER the bound
    for p in pushes:
        if not p["accepted"]:
            assert p["staleness"] > tau
    snap = drv.last_store_snapshot
    assert snap["max_accepted_staleness"] <= tau
    assert snap["pushes_rejected"] == len(pushes) - len(accepted)
    steps = [p for k, p in sink.records
             if k == "trace_span" and p["name"] == "replica.step"]
    assert {p["worker"] for p in steps} == {"w0", "w1", "w2", "w3"}


def test_unbounded_staleness_accepts_everything():
    X, y, w0 = data()
    drv = _driver(workers=4, tau=None, iters=40, step=0.1)
    drv.optimize_with_history((X, y), w0)
    assert drv.last_store_snapshot["pushes_rejected"] == 0
    assert drv.last_store_snapshot["version"] == 40


# -- reliability: failpoint heal, kill/rejoin ------------------------------------


def test_push_pull_failpoints_heal_bitwise():
    """Transient replica.pull/replica.push faults healed by the worker
    RetryPolicy leave the τ=0 trajectory bitwise (the protocol mutates
    nothing before the failpoint)."""
    X, y, w0 = data()
    w_ref, h_ref = rank_order_reference(
        tst.LeastSquaresGradient(), tst.SquaredL2Updater(), X, y, w0,
        workers=2)
    drv = (_driver(workers=2, tau=0)
           .set_retry(RetryPolicy(max_attempts=4, base_backoff_s=0.001,
                                  seed=5)))
    with fp.inject_faults({
            "replica.pull": fp.fail_prob(0.05, seed=1),
            "replica.push": fp.fail_prob(0.05, seed=2)}):
        w, h = drv.optimize_with_history((X, y), w0)
        assert fp.triggers("replica.pull") > 0
        assert fp.triggers("replica.push") > 0
    np.testing.assert_array_equal(w.numpy(), w_ref)
    np.testing.assert_array_equal(h, h_ref)


@pytest.mark.parametrize("tau", [0, 2])
def test_worker_kill_and_rejoin_converges(tau, async_problem):
    """A worker killed mid-run (one-shot failpoint, no worker retry)
    deregisters — a τ=0 round in flight completes with the survivors —
    rejoins with backoff, and the run still meets the synchronous
    objective (matched, not bitwise: the fleet changed mid-run)."""
    X, y, w0, ref_obj = async_problem
    drv = (_driver(workers=4, tau=tau, iters=160, frac=1.0, step=0.2,
                   reg=0.01)
           .set_rejoin(RetryPolicy(max_attempts=5, base_backoff_s=0.005,
                                   seed=7)))
    with fp.inject_faults({"replica.push": fp.fail_nth(30)}):
        w, h = drv.optimize_with_history((X, y), w0)
    assert len(h) == 160
    membership = drv.last_membership_snapshot
    assert any(r["joins"] > 1 for r in membership.values()), membership
    assert any(r["failures"] > 0 for r in membership.values())
    obj = full_objective(X, y, w.numpy(), 0.01)
    assert obj <= ref_obj * OBJECTIVE_RATIO, (obj, ref_obj)


def test_fatal_worker_error_propagates():
    """An unretryable worker death aborts the run with the real error —
    never a hang."""
    X, y, w0 = data()
    drv = (_driver(workers=2, tau=0, iters=40)
           .set_rejoin(RetryPolicy(max_attempts=2, base_backoff_s=0.001,
                                   seed=1)))
    with fp.inject_faults(
            {"replica.pull": fp.fail_nth(10, exc=ValueError)}):
        with pytest.raises(ValueError):
            drv.optimize_with_history((X, y), w0)


# -- async convergence: matched final loss ---------------------------------------


@pytest.mark.parametrize("tau", [1, 4, None])
def test_async_converges_to_matched_loss(tau, async_problem):
    X, y, w0, ref_obj = async_problem
    drv = _driver(workers=4, tau=tau, iters=160, frac=1.0, step=0.2,
                  reg=0.01)
    w, h = drv.optimize_with_history((X, y), w0)
    assert len(h) == 160
    obj = full_objective(X, y, w.numpy(), 0.01)
    assert obj <= ref_obj * OBJECTIVE_RATIO, (tau, obj, ref_obj)


def test_sampled_tau0_matches_the_jax_objective():
    """A sampled τ=0 run draws torch's samples, not jax.random's: held to
    the JAX package's meshed run by the exact objective."""
    X, y, w0 = data(n=512, d=10, seed=11)
    ref_obj = full_objective(X, y, _jax_sync(
        X, y, w0, iters=80, frac=0.5, step=0.2, reg=0.01, workers=4), 0.01)
    w, _ = _driver(workers=4, tau=0, iters=80, frac=0.5, step=0.2,
                   reg=0.01).optimize_with_history((X, y), w0)
    assert full_objective(X, y, w.numpy(), 0.01) <= ref_obj * \
        OBJECTIVE_RATIO


# -- compressed wire --------------------------------------------------------------


def test_compressed_wire_matched_loss_and_wire_bytes():
    from tpu_sgd_torch.obs import counters as obs_counters
    from tpu_sgd_torch.obs import spans

    X, y, w0 = data(n=512, d=64, seed=13)
    ref_obj = full_objective(X, y, _jax_sync(
        X, y, w0, iters=200, frac=1.0, step=0.2, reg=0.01, workers=2), 0.01)
    drv = (_driver(workers=2, tau=1, iters=200, frac=1.0, step=0.2,
                   reg=0.01)
           .set_wire_compress("topk:0.125"))
    # tracing must be on for the counters' subsystem attribution (the
    # replica.step span tags the worker thread)
    spans.enable_tracing(ListSink())
    obs_counters.enable()
    obs_counters.reset()  # the registry is process-wide
    try:
        w, _ = drv.optimize_with_history((X, y), w0)
        snap = obs_counters.snapshot()
    finally:
        obs_counters.disable()
        spans.disable_tracing()
    obj = full_objective(X, y, w.numpy(), 0.01)
    assert obj <= ref_obj * OBJECTIVE_RATIO, (obj, ref_obj)
    topk = obs_counters.wire_ratios(snap).get("replica.wire.topk")
    assert topk is not None, sorted(snap)
    assert topk["physical_bytes"] > 0
    assert topk["physical_bytes"] < 0.5 * topk["logical_bytes"]


def test_rejected_compressed_push_conserves_ef_mass():
    """Through the store: a stale compressed push is rejected, the worker
    restores its segment, and the accumulator holds the whole update."""
    cfg = tst.SGDConfig(step_size=0.1, num_iterations=50,
                        convergence_tol=0.0, reg_param=0.01)
    store = ParameterStore(tst.SquaredL2Updater(), cfg,
                           np.zeros(16, np.float32), staleness=1,
                           device="cpu")
    store.register_worker("w0", 0)
    store.register_worker("w1", 1)
    ef = store.error_feedback("w0", 0.25)
    update = np.arange(16, dtype=np.float32) - 8.0
    idx, vals = ef.compress(update.copy())
    np.testing.assert_allclose(ef.acc.sum() + vals.sum(), update.sum(),
                               rtol=1e-6)
    g = torch.ones(16)
    for wid in ("w1", "w0"):
        assert store.push(wid, store.version, g, torch.tensor(1.0),
                          torch.tensor(8.0)).accepted
    res = store.push_compressed("w0", 0, idx, vals, 1.0, 8.0)
    assert not res.accepted and res.staleness == 2
    ef.restore_segment(idx, vals)
    np.testing.assert_allclose(ef.acc, update, rtol=1e-6)


def test_compressed_segment_with_a_repeated_index_is_refused():
    cfg = tst.SGDConfig(num_iterations=5)
    store = ParameterStore(tst.SimpleUpdater(), cfg, np.zeros(8, np.float32),
                           staleness=1, device="cpu")
    store.register_worker("w0", 0)
    with pytest.raises(ValueError, match="unique"):
        store.push_compressed("w0", 0, np.asarray([1, 1], np.int32),
                              np.ones(2, np.float32), 1.0, 2.0)
    assert store.version == 0


# -- checkpoint / resume ------------------------------------------------------------


def _pushes(store, rng, d=8):
    """Three dense pushes alternating two workers (the SSP progress bound
    blocks a worker more than τ pushes ahead) and one compressed."""
    ef1 = store.error_feedback("w1", 0.25)
    for wid in ("w0", "w1", "w0"):
        pulled = store.pull(wid)
        g = rng.normal(size=d).astype(np.float32)
        assert store.push(wid, pulled.version, g, np.float32(4.0),
                          np.float32(8.0)).accepted
    idx, vals = ef1.compress(rng.normal(size=d).astype(np.float32))
    assert store.push_compressed("w1", store.version, idx, vals, 4.0,
                                 8.0).accepted


def test_store_checkpoint_roundtrips_version_and_ef_state(tmp_path):
    cfg = tst.SGDConfig(step_size=0.1, num_iterations=50,
                        convergence_tol=0.0, reg_param=0.01)
    mgr = CheckpointManager(os.fspath(tmp_path))
    store = ParameterStore(
        tst.SquaredL2Updater(), cfg, np.zeros(8, np.float32), staleness=2,
        checkpoint_manager=mgr, checkpoint_every=100, config_key="ck",
        device="cpu")
    store.register_worker("w0", 0)
    store.register_worker("w1", 1)
    ef0 = store.error_feedback("w0", 0.25)
    _pushes(store, np.random.default_rng(0))
    store.save_now()
    state = mgr.restore()
    assert state["iteration"] == 4 == store.version
    assert sorted(state["extras"]) == ["ef_w0", "ef_w1"]
    restored = ParameterStore(
        tst.SquaredL2Updater(), cfg, state["weights"], staleness=2,
        config_key="ck", resume_state=state, device="cpu")
    assert restored.version == 4
    np.testing.assert_array_equal(restored.weights.numpy(),
                                  store.weights.numpy())
    np.testing.assert_array_equal(restored.loss_history(),
                                  store.loss_history())
    np.testing.assert_array_equal(
        restored.error_feedback("w0", 0.25).acc, ef0.acc)
    np.testing.assert_array_equal(
        restored.error_feedback("w1", 0.25).acc,
        store.error_feedback("w1", 0.25).acc)


def _jax_store(cfg_kw, mgr, epoch):
    from tpu_sgd.config import SGDConfig
    from tpu_sgd.ops.updaters import SquaredL2Updater
    from tpu_sgd.replica import ParameterStore as JaxStore

    return JaxStore(SquaredL2Updater(), SGDConfig(**cfg_kw),
                    np.zeros(8, np.float32), staleness=2,
                    checkpoint_manager=mgr, checkpoint_every=100,
                    config_key="ck", epoch=epoch)


CKPT_CFG = dict(step_size=0.1, num_iterations=50, convergence_tol=0.0,
                reg_param=0.01)


def test_jax_replica_checkpoint_resumes_in_the_port(tmp_path):
    """A JAX store's epoch-stamped save with ``ef_<worker>`` extras: the
    port's store resumes it at the version, epoch, weights, history and
    accumulators exactly; the port's driver runs on from it to the JAX
    driver's matched objective."""
    from tpu_sgd.ops.gradients import LeastSquaresGradient
    from tpu_sgd.ops.updaters import SquaredL2Updater
    from tpu_sgd.replica import ReplicaDriver as JaxDriver
    from tpu_sgd.utils.checkpoint import CheckpointManager as JaxManager

    jdir, pdir = tmp_path / "jax", tmp_path / "port"
    jstore = _jax_store(CKPT_CFG, JaxManager(os.fspath(jdir)), epoch=1)
    jstore.register_worker("w0", 0)
    jstore.register_worker("w1", 1)
    jstore.error_feedback("w0", 0.25)
    _pushes(jstore, np.random.default_rng(1))
    jstore.save_now()
    assert os.listdir(jdir) == ["ckpt_e0001_00000004.npz"]
    state = CheckpointManager(os.fspath(jdir)).restore()
    ours = ParameterStore(tst.SquaredL2Updater(),
                          tst.SGDConfig(**CKPT_CFG), state["weights"],
                          staleness=2, resume_state=state, device="cpu")
    assert (ours.version, ours.epoch) == (4, 1)
    np.testing.assert_array_equal(ours.weights.numpy(),
                                  np.asarray(jstore.weights))
    np.testing.assert_array_equal(ours.loss_history(),
                                  jstore.loss_history())
    for wid in ("w0", "w1"):
        np.testing.assert_array_equal(
            ours.error_feedback(wid, 0.25).acc,
            jstore.error_feedback(wid, 0.25).acc)
    # both drivers run on from the same save (copied) to 50 versions
    import shutil

    shutil.copytree(jdir, pdir)
    X, y, _ = data(n=128, d=8, seed=4)
    jw, jh = (JaxDriver(LeastSquaresGradient(), SquaredL2Updater())
              .set_step_size(0.1).set_num_iterations(50)
              .set_mini_batch_fraction(1.0).set_convergence_tol(0.0)
              .set_reg_param(0.01).set_workers(2).set_staleness(0)
              .set_wire_compress("topk:0.25")
              .set_checkpoint(JaxManager(os.fspath(jdir)), every=100)
              .optimize_with_history((X, y), np.zeros(8, np.float32)))
    drv = (_driver(workers=2, tau=0, iters=50, frac=1.0, step=0.1,
                   reg=0.01).set_wire_compress("topk:0.25")
           .set_checkpoint(CheckpointManager(os.fspath(pdir)), every=100))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)  # config key
        w, h = drv.optimize_with_history((X, y), np.zeros(8, np.float32))
    assert len(h) == len(jh) == 50
    np.testing.assert_array_equal(h[:4], np.asarray(jh)[:4])
    assert drv.last_store_snapshot["epoch"] == 1
    obj = full_objective(X, y, w.numpy(), 0.01)
    assert obj <= full_objective(X, y, np.asarray(jw), 0.01) * \
        OBJECTIVE_RATIO


def test_port_replica_checkpoint_resumes_in_the_jax_package(tmp_path):
    from tpu_sgd.config import SGDConfig
    from tpu_sgd.ops.gradients import LeastSquaresGradient
    from tpu_sgd.ops.updaters import SquaredL2Updater
    from tpu_sgd.replica import ParameterStore as JaxStore
    from tpu_sgd.replica import ReplicaDriver as JaxDriver
    from tpu_sgd.utils.checkpoint import CheckpointManager as JaxManager

    pdir, jdir = tmp_path / "port", tmp_path / "jax"
    store = ParameterStore(tst.SquaredL2Updater(), tst.SGDConfig(**CKPT_CFG),
                           np.zeros(8, np.float32), staleness=2,
                           checkpoint_manager=CheckpointManager(
                               os.fspath(pdir)),
                           checkpoint_every=100, config_key="ck", epoch=1,
                           device="cpu")
    store.register_worker("w0", 0)
    store.register_worker("w1", 1)
    store.error_feedback("w0", 0.25)
    _pushes(store, np.random.default_rng(2))
    store.save_now()
    assert os.listdir(pdir) == ["ckpt_e0001_00000004.npz"]
    state = JaxManager(os.fspath(pdir)).restore()
    theirs = JaxStore(SquaredL2Updater(), SGDConfig(**CKPT_CFG),
                      state["weights"], staleness=2, resume_state=state)
    assert (theirs.version, theirs.epoch) == (4, 1)
    np.testing.assert_array_equal(np.asarray(theirs.weights),
                                  store.weights.numpy())
    np.testing.assert_array_equal(theirs.loss_history(),
                                  store.loss_history())
    for wid in ("w0", "w1"):
        np.testing.assert_array_equal(
            theirs.error_feedback(wid, 0.25).acc,
            store.error_feedback(wid, 0.25).acc)
    import shutil

    shutil.copytree(pdir, jdir)
    X, y, _ = data(n=128, d=8, seed=4)
    jw, jh = (JaxDriver(LeastSquaresGradient(), SquaredL2Updater())
              .set_step_size(0.1).set_num_iterations(50)
              .set_mini_batch_fraction(1.0).set_convergence_tol(0.0)
              .set_reg_param(0.01).set_workers(2).set_staleness(0)
              .set_wire_compress("topk:0.25")
              .set_checkpoint(JaxManager(os.fspath(jdir)), every=100)
              .optimize_with_history((X, y), np.zeros(8, np.float32)))
    w, h = (_driver(workers=2, tau=0, iters=50, frac=1.0, step=0.1,
                    reg=0.01).set_wire_compress("topk:0.25")
            .set_checkpoint(CheckpointManager(os.fspath(pdir)), every=100)
            .optimize_with_history((X, y), np.zeros(8, np.float32)))
    assert len(jh) == 50
    np.testing.assert_array_equal(np.asarray(jh)[:4], h[:4])
    assert full_objective(X, y, np.asarray(jw), 0.01) <= full_objective(
        X, y, w.numpy(), 0.01) * OBJECTIVE_RATIO


def test_supervised_preempt_resume_bitwise(tmp_path):
    from tpu_sgd_torch.reliability.supervisor import TrainingSupervisor

    X, y, w0 = data()
    w_ref, h_ref = rank_order_reference(
        tst.LeastSquaresGradient(), tst.SquaredL2Updater(), X, y, w0,
        workers=2, iters=40)
    mgr = CheckpointManager(os.fspath(tmp_path))
    drv = _driver(workers=2, tau=0, iters=40)
    sup = TrainingSupervisor(drv, checkpoint_manager=mgr,
                             checkpoint_every=10,
                             install_signal_handlers=False)

    class _PreemptAt(CollectingListener):
        def on_iteration(self, ev):
            super().on_iteration(ev)
            if ev.iteration == 12:
                sup.request_preempt()

    drv.set_listener(_PreemptAt())
    res = sup.run((X, y), w0)
    assert res.status == "preempted"
    assert 0 < res.preempted_at < 40
    assert mgr.restore()["iteration"] == res.preempted_at
    drv.set_listener(None)
    res2 = sup.run((X, y), w0)
    assert res2.completed
    np.testing.assert_array_equal(res2.weights.numpy(), w_ref)
    np.testing.assert_array_equal(res2.loss_history, h_ref)


# -- membership, devices, counters ----------------------------------------------------


def test_membership_records_and_stragglers():
    m = ReplicaMembership()
    rec = m.join("w0", 0)
    m.join("w1", 1)
    assert set(m.active_ids()) == {"w0", "w1"}
    rec.heartbeat.beat()
    assert m.stragglers(stall_after_s=1e-9) == ["w0"]  # w1 never beat
    m.leave("w1", error=RuntimeError("boom"))
    assert m.active_ids() == ["w0"]
    snap = m.snapshot()
    assert snap["w1"]["failures"] == 1
    assert "RuntimeError" in snap["w1"]["last_error"]
    rec2 = m.join("w1", 1)  # rejoin keeps the record identity
    assert rec2.joins == 2
    assert len(m.heartbeats()) == 2


def test_store_and_workers_on_the_cpu_launch_no_kernel():
    """On the CPU every sum takes the plain path; the lock-held counts
    stay 0 and nothing is built."""
    from tpu_sgd_torch.ops import _build

    ck.reset_launch_counts()
    X, y, w0 = data(n=64, d=6)
    for mode in ("bernoulli", "sliced"):
        _driver(workers=2, tau=0, iters=4, sampling=mode) \
            .optimize_with_history((X, y), w0)
    assert not any(ck.launch_counts().values())
    assert not any(ck.kernel_launch_counts().values())
    assert len(_build._loaded) == 0


def test_resident_rounds_follow_the_reference_rule():
    """A fleet that shares a device warns and runs the per-cycle loop
    (bitwise the run without resident rounds); with a device of its own
    for every worker of the round-robin, ``k >= 1`` runs resident (K = 1
    and K >= 2 alike: no mode raises), a repeated device in the list
    still warns; a negative ``k`` raises."""
    X, y, w0 = data(n=64, d=6)
    w_ref, h_ref = _driver(workers=2, iters=6).optimize_with_history(
        (X, y), w0)
    drv = _driver(workers=2, iters=6).set_resident_rounds(3)
    with pytest.warns(RuntimeWarning, match="one device per worker"):
        w, h = drv.optimize_with_history((X, y), w0)
    np.testing.assert_array_equal(w.numpy(), w_ref.numpy())
    np.testing.assert_array_equal(h, h_ref)
    two = [torch.device("cuda", 0), torch.device("cuda", 1)]
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert drv._resident_rounds_for(two) == 3
        assert drv.set_resident_rounds(1)._resident_rounds_for(two) == 1
        assert drv.set_resident_rounds(0)._resident_rounds_for(two) == 0
        assert drv.set_workers(1).set_resident_rounds(2) \
            ._resident_rounds_for([torch.device("cpu")]) == 2
    drv.set_workers(2)
    with pytest.warns(RuntimeWarning, match="one device per worker"):
        assert drv._resident_rounds_for([two[0], two[0], two[1]]) == 0
    with pytest.raises(ValueError):
        drv.set_resident_rounds(-1)


def test_a_worker_on_host_rows_stages_them_once():
    cfg = tst.SGDConfig(num_iterations=3, convergence_tol=0.0)
    X, y, w0 = data(n=32, d=4)
    store = ParameterStore(tst.SimpleUpdater(), cfg, w0, device="cpu")
    worker = ReplicaWorker("w0", 0, store, tst.LeastSquaresGradient(), cfg,
                           X, y, device="cpu")
    assert isinstance(worker._X, torch.Tensor)
    Xt = torch.as_tensor(X)
    kept = ReplicaWorker("w1", 1, store, tst.LeastSquaresGradient(), cfg,
                         Xt, torch.as_tensor(y), device="cpu")
    assert kept._X is Xt


def test_store_lock_discipline_validated_at_runtime():
    """The ParameterStore lock declaration, validated dynamically on a
    live two-worker run with the JAX package's runtime instrumentation
    (the runtime twin of the lexical rule)."""
    from tpu_sgd.analysis.runtime import instrument_object

    _store_lock_run(instrument_object)


def test_store_lock_discipline_validated_by_the_port_runtime():
    """The same run under the port's own ``instrument_object``."""
    from tpu_sgd_torch.analysis.runtime import instrument_object

    _store_lock_run(instrument_object)


def _store_lock_run(instrument_object):
    from tpu_sgd_torch.replica import store as store_mod

    X, y, w0 = data(n=64, d=6)
    cfg = tst.SGDConfig(step_size=0.2, num_iterations=10,
                        mini_batch_fraction=0.5, convergence_tol=0.0,
                        reg_param=0.01)
    store = ParameterStore(tst.SquaredL2Updater(), cfg, w0, staleness=1,
                           device="cpu")
    recorder = instrument_object(
        store, store_mod.GRAFTLINT_LOCKS["ParameterStore"])
    shards = shard_rows(X, y, 2)
    workers = [ReplicaWorker(f"w{s}", s, store, tst.LeastSquaresGradient(),
                             cfg, *shards[s], device="cpu")
               for s in range(2)]
    for s in range(2):
        store.register_worker(f"w{s}", s)
    threads = [threading.Thread(target=w.run) for w in workers]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert store.version == 10
    assert recorder.checked_accesses > 0
    assert recorder.violations == []


def test_launch_counts_are_exact_under_concurrent_increments():
    """8 threads x 10,000 increments through the counting helper, with a
    short switch interval: no increment is lost."""
    ck.reset_launch_counts()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def bump():
            for _ in range(10_000):
                ck.count_launch(ck.fused_gradient_sums, source="window_sums",
                                route="gather")

        threads = [threading.Thread(target=bump) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    try:
        assert ck.launch_counts()["fused_gradient_sums"] == 80_000
        assert ck.kernel_launch_counts()["window_sums"] == 80_000
        assert ck.gradient_route_counts()["gather"] == 80_000
    finally:
        ck.reset_launch_counts()


def test_the_counts_and_the_window_scratch_wait_for_the_one_lock(
        monkeypatch):
    """A count, a reset and the window scratch's get-or-create each wait
    while another thread holds the counts' lock (a window call holds it
    from its scratch lookup until both of its kernels are queued).  The
    scratch is primed with host tensors: this host has no card."""
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: False)
    monkeypatch.setitem(ck._WINDOW_SCRATCH, (0, 4, 12345),
                        (torch.zeros(2, 4), torch.zeros(2), torch.zeros(2)))
    done = []
    calls = (lambda: ck.count_launch(source="fused_sums"),
             ck.reset_launch_counts,
             lambda: ck._window_scratch(0, 4, 2, 12345))
    for call in calls:
        done.clear()
        with ck._COUNTS_LOCK:
            t = threading.Thread(target=lambda: done.append(call()))
            t.start()
            t.join(timeout=0.2)
            assert t.is_alive() and not done, "ran without the lock"
        t.join(timeout=10)
        assert not t.is_alive() and len(done) == 1
    ck.reset_launch_counts()

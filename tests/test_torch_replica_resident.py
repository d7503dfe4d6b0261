"""The replicas' resident worker mode in the port (``ReplicaWorker`` with
``resident_rounds = K >= 1``, ``ReplicaDriver.set_resident_rounds``): the
twins of the JAX package's resident cells (``tests/test_composition.py``,
replica x resident) on the CPU, where a round runs its ``K`` supersteps
eagerly.

Tolerances, by tier:

* across frameworks, full batch (no sampling): the gradient tier —
  weights rtol 2e-4 / atol 2e-3, history rtol 2e-4; history length and
  the store's version exact;
* bitwise within the port — ``K = 1`` against the per-cycle loop on the
  dense and the ``topk:0.25`` wire, a shared-device fleet's fallback
  against the per-cycle run, a killed and rejoined resident worker
  against the fault-free run;
* matched loss — sampled ``K = 2`` (two batches folded a push, a lagging
  trajectory) within 1.01x of the per-cycle run's loss six rounds
  earlier, the JAX package's rule (``tests/test_composition.py``);
* exact — error-feedback mass across a rejected compressed round, launch
  counts under a capture on another thread.

On the card a round is one captured CUDA graph; ``chip_smoke.py`` phase
``replica`` (g) and ``scripts/mesh_nccl_check.py`` (r) hold that half.
"""

import threading
import warnings

import jax
import numpy as np
import pytest
import torch

import tpu_sgd_torch as tst
from torch_replica_reference import data
from tpu_sgd_torch.ops import cuda_kernels as ck
from tpu_sgd_torch.reliability import failpoints as fp
from tpu_sgd_torch.reliability.retry import RetryPolicy
from tpu_sgd_torch.replica import (ParameterStore, ReplicaDriver,
                                   ReplicaWorker, shard_rows)

GRAD_RTOL, GRAD_ATOL, HIST_RTOL = 2e-4, 2e-3, 2e-4
TOL_MATCHED = 0.01
LAG = 6  # rounds of lag the matched-loss rule allows a K = 2 run


def _cfg(*, iters, frac, step=0.3, reg=0.1):
    return tst.SGDConfig(step_size=step, num_iterations=iters,
                         mini_batch_fraction=frac, convergence_tol=0.0,
                         reg_param=reg)


def _port_driver(*, workers, iters, frac, k=0, wc=None):
    drv = (ReplicaDriver(tst.LeastSquaresGradient(), tst.SquaredL2Updater(),
                         device="cpu")
           .set_step_size(0.3).set_num_iterations(iters)
           .set_mini_batch_fraction(frac).set_convergence_tol(0.0)
           .set_reg_param(0.1).set_workers(workers).set_staleness(0)
           .set_resident_rounds(k))
    return drv.set_wire_compress(wc) if wc else drv


def _jax_driver(*, workers, iters, frac, k):
    from tpu_sgd.ops.gradients import LeastSquaresGradient
    from tpu_sgd.ops.updaters import SquaredL2Updater
    from tpu_sgd.replica import ReplicaDriver as JaxDriver

    return (JaxDriver(LeastSquaresGradient(), SquaredL2Updater())
            .set_step_size(0.3).set_num_iterations(iters)
            .set_mini_batch_fraction(frac).set_convergence_tol(0.0)
            .set_reg_param(0.1).set_workers(workers).set_staleness(0)
            .set_resident_rounds(k)
            .set_devices(jax.devices()[:workers]))


def _fleet(X, y, w0, *, workers, iters, frac, k, wc_frac=None, tau=0):
    """``workers`` ``ReplicaWorker``s built directly against one port
    store on the CPU, each with ``resident_rounds=k`` (0: the per-cycle
    loop), run as threads to the end.  Returns ``(weights, history,
    store, workers)``."""
    cfg = _cfg(iters=iters, frac=frac)
    store = ParameterStore(tst.SquaredL2Updater(), cfg, w0, staleness=tau,
                           device="cpu")
    shards = shard_rows(X, y, workers)
    fleet = [ReplicaWorker(f"w{s}", s, store, tst.LeastSquaresGradient(),
                           cfg, *shards[s], device="cpu", wire_frac=wc_frac,
                           resident_rounds=k)
             for s in range(workers)]
    for s in range(workers):
        store.register_worker(f"w{s}", s)
    errors = []

    def main(worker):
        try:
            worker.run()
        except BaseException as e:  # surfaced below
            errors.append(e)
        finally:
            store.deregister_worker(worker.worker_id)

    threads = [threading.Thread(target=main, args=(w,)) for w in fleet]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads), "a worker hung"
    assert not errors, errors
    return store.weights, np.asarray(store.loss_history()), store, fleet


@pytest.mark.parametrize("k", [1, 2])
def test_one_resident_worker_matches_the_jax_resident_driver(k):
    """(a) One worker at τ=0, full batch: the port's resident driver (one
    device, the CPU) against the JAX package's at the same K."""
    X, y, w0 = data(n=256, d=12, seed=4)
    jw, jh = _jax_driver(workers=1, iters=20, frac=1.0,
                         k=k).optimize_with_history((X, y), w0)
    drv = _port_driver(workers=1, iters=20, frac=1.0, k=k)
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # one device a worker: no fallback
        w, h = drv.optimize_with_history((X, y), w0)
    assert len(h) == len(jh) == 20
    assert drv.last_store_snapshot["version"] == 20
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=GRAD_RTOL,
                               atol=GRAD_ATOL)
    np.testing.assert_allclose(h, np.asarray(jh), rtol=HIST_RTOL)


def test_two_direct_resident_workers_match_the_jax_two_device_run():
    """(b) Two ``ReplicaWorker``s built with ``resident_rounds=2`` against
    one port store, τ=0, full batch, against the JAX driver's two-worker
    resident run on two virtual CPU devices."""
    X, y, w0 = data(n=256, d=12, seed=5)
    jw, jh = _jax_driver(workers=2, iters=16, frac=1.0,
                         k=2).optimize_with_history((X, y), w0)
    w, h, store, fleet = _fleet(X, y, w0, workers=2, iters=16, frac=1.0, k=2)
    assert len(h) == len(jh) == 16 and store.version == 16
    assert [wk.cycles for wk in fleet] == [16, 16]
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=GRAD_RTOL,
                               atol=GRAD_ATOL)
    np.testing.assert_allclose(h, np.asarray(jh), rtol=HIST_RTOL)


@pytest.mark.parametrize("wc", [None, "topk:0.25"])
def test_resident_k1_is_bitwise_the_per_cycle_loop(wc):
    """(c) K = 1 pushes what the per-cycle loop pushes: a two-worker fleet
    (sampled, τ=0) and the one-worker driver, on the dense and the
    compressed wire (the mirror of the JAX package's grid cell)."""
    X, y, w0 = data(n=256, d=12, seed=0)
    frac = None if wc is None else float(wc.split(":")[1])
    ref = _fleet(X, y, w0, workers=2, iters=16, frac=0.5, k=0,
                 wc_frac=frac)
    res = _fleet(X, y, w0, workers=2, iters=16, frac=0.5, k=1,
                 wc_frac=frac)
    np.testing.assert_array_equal(res[0].numpy(), ref[0].numpy())
    np.testing.assert_array_equal(res[1], ref[1])
    assert [wk.cycles for wk in res[3]] == [wk.cycles for wk in ref[3]] \
        == [16, 16]
    w_ref, h_ref = _port_driver(workers=1, iters=16, frac=0.5,
                                wc=wc).optimize_with_history((X, y), w0)
    w, h = _port_driver(workers=1, iters=16, frac=0.5, k=1,
                        wc=wc).optimize_with_history((X, y), w0)
    np.testing.assert_array_equal(w.numpy(), w_ref.numpy())
    np.testing.assert_array_equal(h, h_ref)


def test_resident_k2_sampled_meets_the_matched_loss_rule():
    """(d) K = 2 folds two sampled batches into each push: matched loss,
    not bitwise — the final loss within 1.01x of the per-cycle run's
    loss ``LAG`` rounds earlier (the JAX package's rule, 48 rounds)."""
    X, y, w0 = data(n=256, d=12, seed=0)
    _, h48, _, _ = _fleet(X, y, w0, workers=2, iters=48, frac=0.5, k=0)
    _, h2, store, fleet = _fleet(X, y, w0, workers=2, iters=48, frac=0.5,
                                 k=2)
    assert len(h2) == len(h48) == 48 and np.isfinite(h2).all()
    assert [wk.cycles for wk in fleet] == [48, 48]
    assert h2[-1] <= (1 + TOL_MATCHED) * h48[-1 - LAG], (h2[-1],
                                                          h48[-1 - LAG])
    assert not np.array_equal(h2, h48)  # two batches a push: another run


def test_rejected_compressed_resident_round_conserves_ef_mass():
    """(e) A compressed resident round whose push comes back stale (τ=1,
    the store two versions ahead of its basis) is discarded whole: the
    worker restores the extracted segment, so its accumulator holds the
    round's whole batch-mean gradient on top of what it held."""
    X, y, w0 = data(n=64, d=16, seed=1)
    cfg = _cfg(iters=50, frac=1.0)
    store = ParameterStore(tst.SquaredL2Updater(), cfg, w0, staleness=1,
                           device="cpu")
    store.register_worker("w0", 0)
    store.register_worker("w1", 1)
    worker = ReplicaWorker("w0", 0, store, tst.LeastSquaresGradient(), cfg,
                           X, y, device="cpu", wire_frac=0.25,
                           resident_rounds=2)
    worker.ef.acc[:] = np.linspace(-1.0, 1.0, 16, dtype=np.float32)
    before = worker.ef.acc.copy()
    folded = {}
    round_fn = worker._round

    def round_then_advance(weights, version):
        out = folded["sums"] = round_fn(weights, version)
        one = torch.ones(16)
        for wid in ("w1", "w0"):  # accepted pushes move HEAD past τ
            assert store.push(wid, store.version, one, torch.tensor(1.0),
                              torch.tensor(8.0)).accepted
        return out

    worker._round = round_then_advance
    assert worker.run_round()
    assert worker.rejected == 1 and worker.cycles == 1
    G, L, C = folded["sums"]
    gn = G.numpy().reshape(-1) / max(float(C), 1.0)
    np.testing.assert_allclose(worker.ef.acc, before + gn, rtol=1e-6,
                               atol=1e-6)
    assert store.snapshot()["pushes_rejected"] == 1


def test_shared_device_fleet_warns_and_is_bitwise_the_per_cycle_run():
    """(f) Two workers on the one CPU device cannot each own a device:
    the driver warns with the JAX package's words and runs the per-cycle
    loop, bitwise the run without resident rounds, on both wires."""
    X, y, w0 = data(n=128, d=8, seed=3)
    for wc in (None, "topk:0.25"):
        w_ref, h_ref = _port_driver(workers=2, iters=8, frac=0.5,
                                    wc=wc).optimize_with_history((X, y), w0)
        drv = _port_driver(workers=2, iters=8, frac=0.5, k=2, wc=wc)
        with pytest.warns(RuntimeWarning, match="one device per worker"):
            w, h = drv.optimize_with_history((X, y), w0)
        np.testing.assert_array_equal(w.numpy(), w_ref.numpy())
        np.testing.assert_array_equal(h, h_ref)


def test_a_killed_resident_worker_rejoins_bitwise():
    """A resident worker killed at a push (one-shot failpoint, no worker
    retry) leaves its round behind, rejoins with a fresh round, and the
    τ=0 run is bitwise the fault-free one; a worker whose loop ended,
    by death too, holds no round state."""
    X, y, w0 = data(n=128, d=8, seed=6)
    w_ref, h_ref = _port_driver(workers=1, iters=12, frac=0.5,
                                k=1).optimize_with_history((X, y), w0)
    drv = _port_driver(workers=1, iters=12, frac=0.5, k=1).set_rejoin(
        RetryPolicy(max_attempts=5, base_backoff_s=0.001, seed=7))
    with fp.inject_faults({"replica.push": fp.fail_nth(5)}):
        w, h = drv.optimize_with_history((X, y), w0)
        assert fp.triggers("replica.push") > 0
    assert drv.last_membership_snapshot["w0"]["joins"] == 2
    np.testing.assert_array_equal(w.numpy(), w_ref.numpy())
    np.testing.assert_array_equal(h, h_ref)
    cfg = _cfg(iters=4, frac=0.5)
    store = ParameterStore(tst.SquaredL2Updater(), cfg, w0, device="cpu")
    worker = ReplicaWorker("w0", 0, store, tst.LeastSquaresGradient(), cfg,
                           X, y, device="cpu", resident_rounds=1)
    store.register_worker("w0", 0)
    worker._graph_out = (torch.zeros(8),)  # as a capture leaves it
    with fp.inject_faults({"replica.pull": fp.fail_nth(1)}):
        with pytest.raises(fp.FaultInjected):
            worker.run()
    assert worker._graph is None and worker._graph_out is None


def test_capture_records_are_the_capturing_threads_own():
    """While one thread captures, the launches another thread counts stay
    in the counts and out of the capture's record; the capture's own
    launches leave the counts and come back with each replay."""
    ck.reset_launch_counts()
    inside, go = threading.Event(), threading.Event()
    rec = {}

    def capture():
        with ck.captured_launches() as record:
            ck.count_launch(ck.fused_gradient_sums, source="window_sums",
                            route="gather")
            inside.set()
            go.wait(timeout=30)
            ck.count_launch(ck.fused_gradient_sums, source="window_sums",
                            route="gather")
        rec.update(record)

    t = threading.Thread(target=capture)
    t.start()
    assert inside.wait(timeout=30)
    for _ in range(5):  # a peer's eager launches during the capture
        ck.count_launch(ck.fused_window_sums, source="window_sums")
    go.set()
    t.join(timeout=30)
    try:
        assert ck.launch_counts() == {"fused_gradient_sums": 0,
                                      "fused_window_sums": 5,
                                      "fused_window_sums_vpu": 0}
        assert ck.kernel_launch_counts() == {"fused_sums": 0,
                                             "window_sums": 5}
        assert rec["wrappers"]["fused_gradient_sums"] == 2
        assert rec["wrappers"]["fused_window_sums"] == 0
        assert rec["sources"] == {"fused_sums": 0, "window_sums": 2}
        assert rec["routes"]["gather"] == 2
        for _ in range(3):
            ck.add_replayed_launches(rec)
        assert ck.launch_counts()["fused_gradient_sums"] == 6
        assert ck.kernel_launch_counts()["window_sums"] == 11
        assert ck.gradient_route_counts()["gather"] == 6
    finally:
        ck.reset_launch_counts()

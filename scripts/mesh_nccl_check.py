#!/usr/bin/env python3
"""Data parallelism across cards over NCCL: one rank per card.

    python3 scripts/mesh_nccl_check.py            # every visible card
    python3 scripts/mesh_nccl_check.py --ranks 2

Run from the root of the repository on a host with several NVIDIA cards
(``chip_smoke.py`` phase ``mesh`` runs one card: a world of one over NCCL
and 8 gloo ranks sharing it).  Config 4's 10M x 1000 bf16 least squares
is cut into one row block per rank (``chip_smoke.fill_mesh_block``);
rank r, a subprocess of this script, drives card r.  Per sampling mode
(Bernoulli and sliced at frac 0.1, full batch; 20 iterations): every
K-iteration block eager (``gradient_descent.CUDA_GRAPHS = False``), then
three runs on the same tensors, the second capturing its second block
with the NCCL gather inside the CUDA graph and the third replaying both;
all bitwise equal with exact launches, every rank bitwise equal, and,
after the ranks exit, equal bit for bit to the one-process rank-order
sum of the same blocks on card 0 (``chip_smoke.rank_order_reference``).
Then the observed driver at frac 0.1, K = 1 and K = 8 (captured), with a
checkpoint every 5 iterations that rank 0 writes slowly (1 s a save): a
stop raised by the last rank alone at iteration 13 stops every rank at
the same iteration (13; 16, the block boundary, at K = 8), and the
resume from rank 0's checkpoint is bitwise the unobserved run on every
rank.  Then host streaming on the mesh (``chip_smoke.py`` phase ``mesh``
(j), (k)): the parent makes config 4's first ``STREAM_ROWS`` rows in a
memfd (``chip_smoke.shared_host_rows``) that every rank maps; per mode
(Bernoulli and sliced at frac 0.1, full batch) and on the top-k wire
(``topk:0.01``, Bernoulli), ``STREAM_ITERS`` iterations at K = 1 and at
K = 8 (whose per-slot blocks capture the NCCL gather and replay it),
bitwise equal, every rank bitwise equal and, after the ranks exit, equal
to the one-process rank-order sum of the same shares
(``chip_smoke.streamed_rank_order_reference``); a stop raised by the
last rank at 13 and its resume, dense and compressed.  Each rank reports
the replayed run's wall and device ms an iteration and one NCCL combine's
ms.  Prints one JSON line per rank and a summary line;
exits non-zero when a check fails or a rank fails or hangs (a rank dumps
its stacks to its log first).

Then ROADMAP A1's runs across the cards, each reusing what phase ``mesh``
and phase ``replica`` run on one card:

(s) The 2-D ``(data, model)`` mesh, 2 x 2 over NCCL
    (``chip_smoke.mesh_rank_2d``): a block's CUDA graph holds the gathers
    of both axes' communicators; each block run eager, then captured and
    replayed, bitwise; every rank's weights equal and its block its model
    column's; after the ranks exit, bitwise the one-process 2-D
    rank-order sum (``chip_smoke.mesh_2d_checks``); the margin combine
    timed.
(t) Meshed L-BFGS on the 4 data ranks (``chip_smoke.mesh_rank_lbfgs``):
    twice bitwise, B1 launches = cost evaluations a rank, every host
    decision agreed across the ranks (``lbfgs.agree_on_host``), bitwise
    the one-process rank-order reference (``chip_smoke.mesh_lbfgs_checks``).
(u) The streamed CostFun and the streamed statistics over the memfd rows
    (``chip_smoke.mesh_rank_streamed_qn`` / ``mesh_rank_streamed_stats``,
    phase ``mesh`` (l), (m)), held by ``chip_smoke.mesh_streamed_qn_checks``
    against the one-device streamed runs made here: B1 launches = chunks
    x cost evaluations a rank, each rank's stack its resident build, the
    virtual run bitwise its rank-order reference.
(r) In this process, after the ranks exit: replica workers one card each
    (``ReplicaDriver.set_devices`` over every card, one worker a card) on
    config 4's 10M x 1000 bf16 rows on card 0 (each other card gets a
    copy of its worker's rows): per-cycle τ=0, Bernoulli and sliced, 20
    rounds, bitwise the same fleet on card 0 alone with one B1 (B2) launch
    a round on each card; the resident mode (``chip_smoke.resident_checks``:
    K = 1 bitwise per-cycle with one capture a worker and one replay a
    round a worker, K = 2 by the matched-loss rule); τ=2 with the bound
    held in the trace and applied steps/s; B1 on a worker's own card.

Every NCCL group drops its captured graphs (then ``gc.collect()``) before
``destroy_process_group``.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402

import chip_smoke as cs  # noqa: E402

MODES = ("bernoulli", "sliced", "full")
TIMEOUT = 480               # seconds for the ranks
STREAM_ROWS = 1_000_000     # host rows of the streamed runs
STREAM_ITERS = 40           # K = 8: per slot a warm-up, a capture, replays
SLOW_SAVE_S = 1.0           # rank 0's delay before each checkpoint write
MESH_2D = (2, 2)            # (s): (data, model)


def stop_and_resume(torch, tst, mesh, X, y, out_dir) -> dict:
    """The observed driver at ``cs.FRAC`` on this rank's block, K = 1 and
    ``cs.MESH_OBS_K``: a stop that only the last rank's signal raises (at
    ``cs.MESH_OBS_STOP_AT``) and rank 0's checkpoint writes slowed, then
    the resume from the shared directory; both held here, bitwise, to
    the unobserved meshed run."""
    import gc
    import time

    from tpu_sgd_torch.reliability import TrainingPreempted
    from tpu_sgd_torch.utils.checkpoint import CheckpointManager

    class SlowSave(CheckpointManager):
        def save(self, *args, **kwargs):
            time.sleep(SLOW_SAVE_S)
            return super().save(*args, **kwargs)

    def opt(k):
        return (tst.GradientDescent(device=X.device).set_step_size(0.5)
                .set_num_iterations(cs.MESH_ITERS)
                .set_mini_batch_fraction(cs.FRAC).set_convergence_tol(0.0)
                .set_mesh(mesh).set_superstep(k))

    w0 = torch.zeros(X.shape[1], device=X.device)
    ref = opt(1)
    ref_w, ref_h = ref.optimize_with_history((X, y), w0)
    ref.release_graphs()
    last = mesh.rank == mesh.size - 1
    out = {}
    for k in (1, cs.MESH_OBS_K):
        lis = cs._stop_listener(at=cs.MESH_OBS_STOP_AT if last else None)
        path = os.path.join(out_dir, f"ckpt_k{k}")
        mgr = (SlowSave if mesh.rank == 0 else CheckpointManager)(path)
        o = opt(k).set_listener(lis).set_checkpoint(mgr, every=5)
        o.set_stop_signal(lis.stop)
        stopped = None
        try:
            o.optimize_with_history((X, y), w0)
        except TrainingPreempted as e:
            stopped = e.iteration
        o.set_stop_signal(None)
        w, h = o.optimize_with_history((X, y), w0)
        same = bool(torch.equal(w, ref_w)) and np.array_equal(h, ref_h)
        want = -(-cs.MESH_OBS_STOP_AT // k) * k
        cs.check(stopped == want and same,
                 f"rank {mesh.rank} K={k}: stopped at {stopped} (want "
                 f"{want}), resume bitwise {same}")
        out[f"k{k}"] = {"stopped_at": stopped, "resume_bitwise": same}
        o.release_graphs()
        del o
        gc.collect()
    return out


def streamed_runs(torch, tst, mesh, out_dir):
    """Host streaming on the mesh over the parent's memfd rows: each mode
    at K = 1 and K = 8 (bitwise), the top-k wire the same, and the stop
    and resume, dense and compressed.  Returns ``(report, arrays, the
    mapped host rows)``."""
    from tpu_sgd_torch.io.wire import host_tensor

    with open(os.path.join(out_dir, "streamed.json")) as f:
        spec = json.load(f)
    n, d = spec["shape"]
    Xh = torch.from_file(f"/proc/self/fd/{spec['fd']}", shared=True,
                         size=n * d, dtype=torch.bfloat16).view(n, d)
    yh = host_tensor(np.load(os.path.join(out_dir, "y.npy"), mmap_mode="r"))
    w0 = torch.zeros(d, device="cuda")
    report, arrays = {}, {}
    for key, mode, wc in [(m, m, None) for m in MODES] + [
            ("topk", "bernoulli", cs.MESH_TOPK)]:
        frac = cs._mode_frac(mode)
        k1 = cs._stream_mesh_opt(tst, mesh, mode, frac, STREAM_ITERS,
                                 wc=wc).optimize_with_history((Xh, yh), w0)
        k8 = cs._stream_mesh_opt(tst, mesh, mode, frac, STREAM_ITERS, k=8,
                                 wc=wc).optimize_with_history((Xh, yh), w0)
        same = cs._same_run(torch, k1, k8)
        cs.check(same, f"rank {mesh.rank} streamed {key}: K = 8 differs")
        report[key] = {"k8_bitwise": same}
        arrays[f"stream_{key}_w"] = k1[0].cpu().numpy()
        arrays[f"stream_{key}_h"] = k1[1]
    for key, wc in (("stop", None), ("stop_topk", cs.MESH_TOPK)):
        st = cs._stream_stop_resume(torch, tst, mesh, Xh, yh, w0,
                                    os.path.join(out_dir, "ck_" + key), wc)
        cs.check(st["stopped_at"] == cs.MESH_OBS_STOP_AT
                 and st["resumed_bitwise"], f"rank {mesh.rank} {key}: {st}")
        report[key] = st
    return report, arrays, Xh


def rank_main(rank: int, world: int, port: int, out_dir: str) -> int:
    """Rank ``rank``'s runs on card ``rank``.  A rank still running
    ``TIMEOUT - 30`` s in prints every thread's stack to its log and
    exits."""
    import faulthandler
    import gc

    import torch

    import tpu_sgd_torch as tst
    from tpu_sgd_torch import parallel as par
    from tpu_sgd_torch.io.wire import host_tensor
    from tpu_sgd_torch.ops import cuda_kernels as ck
    from tpu_sgd_torch.optimize import gradient_descent as tgd

    faulthandler.dump_traceback_later(TIMEOUT - 30, exit=True)
    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    os.environ["LOCAL_RANK"] = str(rank)
    par.initialize_distributed(f"tcp://127.0.0.1:{port}", world, rank,
                               backend="nccl")
    mesh = par.data_mesh()
    rows = cs.FULL_ROWS // world
    X = torch.empty((rows, cs.FULL_D), dtype=torch.bfloat16, device="cuda")
    y = torch.empty((rows,), dtype=torch.float32, device="cuda")
    cs.fill_mesh_block(torch, X, y, rank)
    report = {"rank": rank, "world": world, "backend": mesh.backend,
              "card": torch.cuda.current_device(), "modes": {}}
    arrays = {}
    for mode in MODES:
        frac = 1.0 if mode == "full" else cs.FRAC
        tgd.CUDA_GRAPHS = False
        try:
            eager = cs._mesh_run(torch, ck, cs._mesh_alg(tst, mode, frac,
                                                         mesh), X, y)
        finally:
            tgd.CUDA_GRAPHS = True
        alg = cs._mesh_alg(tst, mode, frac, mesh)
        runs = [cs._mesh_run(torch, ck, alg, X, y) for _ in range(3)]
        runner = alg.optimizer._run_cache[1].cache["runner"]
        for r in [eager] + runs:
            cs._check_launches(r, mode, f"rank {rank}")
        same = all(cs._same_run(torch, (eager["w"], eager["h"]),
                                (r["w"], r["h"])) for r in runs)
        cs.check(same, f"rank {rank} {mode}: captured differs from eager")
        cs.check(runner.replays == (3 if runner.capture else 0),
                 f"rank {rank} {mode}: {runner.replays} replays")
        prof = cs._run_profile(torch, lambda: alg.run((X, y)), cs.MESH_ITERS)
        report["modes"][mode] = {
            "captured_equals_eager_bitwise": same,
            "eager_ms_per_iteration": eager["ms"],
            "capture_ms": runner.capture_ms,
            **{k: prof[k] for k in ("wall_ms_per_iteration",
                                    "device_ms_per_iteration", "idle_share",
                                    "top_device_ms")}}
        arrays[mode + "_w"] = eager["w"].cpu().numpy()
        arrays[mode + "_h"] = eager["h"]
        print(f"rank {rank}: {mode} done", flush=True)
        # no CUDA graph that holds an NCCL launch outlives its mode
        alg.optimizer.release_graphs()
        del alg, runner, runs, eager
        gc.collect()
    report["observed"] = stop_and_resume(torch, tst, mesh, X, y, out_dir)
    print(f"rank {rank}: observed done", flush=True)
    t_rep, t_arrays = cs.mesh_rank_lbfgs(torch, tst, ck, mesh, X, y)
    report["t"] = t_rep["f"]
    arrays.update(t_arrays)
    print(f"rank {rank}: (t) meshed L-BFGS done", flush=True)
    report["combine_ms"] = cs._combine_ms(torch, par, mesh)["combine_ms"]
    report["streamed"], st_arrays, Xh = streamed_runs(torch, tst, mesh,
                                                      out_dir)
    arrays.update(st_arrays)
    print(f"rank {rank}: streamed done", flush=True)
    del X, y
    torch.cuda.empty_cache()
    labels = {k: host_tensor(np.load(os.path.join(out_dir, f"{k}.npy"),
                                     mmap_mode="r"))
              for k in ("y_ls", "y_log")}
    w0 = torch.zeros(Xh.shape[1], device="cuda")
    report["u"] = {}
    report["u"]["l"], u_arrays = cs.mesh_rank_streamed_qn(
        torch, tst, ck, mesh, Xh, labels["y_log"], w0)
    arrays.update(u_arrays)
    report["u"]["m"], u_arrays = cs.mesh_rank_streamed_stats(
        torch, tst, ck, par, mesh, Xh, labels["y_ls"], w0, out_dir,
        Xh.shape[0])
    arrays.update(u_arrays)
    print(f"rank {rank}: (u) streamed CostFun and statistics done",
          flush=True)
    report["s"], s_arrays = cs.mesh_rank_2d(torch, tst, ck, par,
                                            shape=MESH_2D, capture_check=True)
    arrays.update(s_arrays)
    print(f"rank {rank}: (s) 2-D mesh done", flush=True)
    # no CUDA graph that holds an NCCL launch outlives the group
    gc.collect()
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **arrays)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(report, f)
    par.mesh.barrier(mesh, "cuda")
    print(f"rank {rank}: saved", flush=True)
    torch.distributed.destroy_process_group()
    faulthandler.cancel_dump_traceback_later()
    return 0


def main() -> int:
    if sys.argv[1:2] == ["--rank"]:
        r, w, port, out = sys.argv[2:6]
        return rank_main(int(r), int(w), int(port), out)
    import torch

    if not torch.cuda.is_available():
        print("mesh_nccl_check: needs NVIDIA cards", file=sys.stderr)
        return 1
    import tpu_sgd_torch as tst
    from tpu_sgd_torch.ops import _build
    from tpu_sgd_torch.ops import cuda_kernels as ck

    torch.backends.cuda.matmul.allow_tf32 = False
    world = torch.cuda.device_count()
    if sys.argv[1:2] == ["--ranks"]:
        world = int(sys.argv[2])
    cs.check(world == 2 * 2 and world <= torch.cuda.device_count(),
             f"{world} ranks on {torch.cuda.device_count()} cards: the 2 x 2 "
             "mesh of (s) needs 4")
    print(cs.nvidia_smi_line(), flush=True)
    _build.build_all()
    X, y, w_true = cs.make_full_data(torch, STREAM_ROWS, cs.FULL_D)
    labels = {"y": y.cpu(), "y_ls": y.to(torch.bfloat16).float().cpu(),
              "y_log": cs.logistic_labels(torch, X, w_true).cpu()}
    Xh, fd = cs.shared_host_rows(torch, X)
    del X, y
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        with open(os.path.join(tmp, "streamed.json"), "w") as f:
            json.dump({"fd": fd, "shape": list(Xh.shape)}, f)
        for name, t in labels.items():
            np.save(os.path.join(tmp, f"{name}.npy"), t.numpy())
        job_s = cs.mesh_spawn(world, tmp, TIMEOUT, os.path.abspath(__file__),
                              "--rank", pass_fds=(fd,))
        reports, arrays = [], []
        for r in range(world):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                reports.append(json.load(f))
            with np.load(os.path.join(tmp, f"rank{r}.npz")) as z:
                arrays.append({k: z[k] for k in z.files})
    for rep in reports:
        cs.emit(rep)
        cs.check(rep["backend"] == "nccl" and rep["card"] == rep["rank"],
                 f"rank {rep['rank']}: {rep['backend']} on card "
                 f"{rep['card']}")
    summary = {"job_seconds": job_s,
               **check_reference(torch, tst, reports, arrays, Xh,
                                 labels["y"])}
    summary["s"] = check_2d(torch, tst, reports, arrays)
    summary["u"] = check_streamed_qn(torch, tst, reports, arrays, Xh,
                                     labels)
    del Xh
    os.close(fd)
    torch.cuda.empty_cache()
    summary["r"] = replica_cards(torch, tst, ck, world)
    cs.emit(summary)
    return 0


def check_2d(torch, tst, reports, arrays) -> dict:
    """(s) after the ranks exit: the 10M rows as phase ``mesh`` makes them
    (its 8 fill blocks) on card 0, and ``chip_smoke.mesh_2d_checks``."""
    n, d = cs.FULL_ROWS, cs.FULL_D
    rows = n // cs.MESH_RANKS
    X = torch.empty((n, d), dtype=torch.bfloat16, device="cuda")
    y = torch.empty((n,), dtype=torch.float32, device="cuda")
    for b in range(cs.MESH_RANKS):
        cs.fill_mesh_block(torch, X[b * rows:(b + 1) * rows],
                           y[b * rows:(b + 1) * rows], b)
    out = cs.mesh_2d_checks(torch, tst, X, y, [rep["s"] for rep in reports],
                            arrays, shape=MESH_2D)
    out["captured_equals_eager_bitwise"] = True
    out["eager_vs_replayed_ms_per_iteration_rank0"] = {
        mode: [r["eager_ms_per_iteration"], r["replayed_ms_per_iteration"]]
        for mode, r in reports[0]["s"]["full"].items()}
    del X, y
    torch.cuda.empty_cache()
    return out


def check_streamed_qn(torch, tst, reports, arrays, Xh, labels) -> dict:
    """(u) after the ranks exit: the one-device streamed runs on the same
    host rows (L-BFGS and OWL-QN through the CostFun, L-BFGS from the
    streamed statistics, the streamed normal equations), then
    ``chip_smoke.mesh_streamed_qn_checks``."""
    w0 = torch.zeros(Xh.shape[1], device="cuda")
    rows = cs.STREAMED_OWLQN_ROWS
    _, a_h = tst.LBFGS(
        tst.LogisticGradient(), tst.SquaredL2Updater(), reg_param=1e-4,
        convergence_tol=0.0, max_num_iterations=cs.STREAMED_QN_ITERS) \
        .set_host_streaming(True).optimize_with_history(
            (Xh, labels["y_log"]), w0)
    _, b_h = tst.OWLQN(
        tst.LogisticGradient(), reg_param=1e-4, convergence_tol=0.0,
        max_num_iterations=cs.STREAMED_OWLQN_ITERS) \
        .set_host_streaming(True).optimize_with_history(
            (Xh[:rows], labels["y_log"][:rows]), w0)
    lb = tst.LBFGS(tst.LeastSquaresGradient(), tst.SquaredL2Updater(),
                   max_num_iterations=cs.QN_ITERS, convergence_tol=0.0) \
        .set_streamed_stats(True)
    c_w, _ = lb.optimize_with_history((Xh, labels["y_ls"]), w0)
    lb.release_sufficient_stats()
    e_w = tst.NormalEquations().set_host_streaming(True).optimize(
        (Xh, labels["y_ls"]), w0)
    refs = {"a_history": np.asarray(a_h, np.float32),
            "b_history": np.asarray(b_h, np.float32),
            "c_lbfgs_w": c_w.cpu().numpy(), "e_normal_w": e_w.cpu().numpy()}
    out = cs.mesh_streamed_qn_checks(
        torch, tst, Xh, labels["y_ls"], [rep["u"] for rep in reports],
        arrays, refs)
    r0 = reports[0]["u"]
    out["l"].update(
        cost_evaluations=r0["l"]["runs"][0]["cost_evaluations"],
        chunks=r0["l"]["runs"][0]["chunks"],
        b1_launches_rank0=r0["l"]["runs"][0]["launches"][
            "fused_gradient_sums"],
        ms_per_iteration_by_rank=[rep["u"]["l"]["runs"][1][
            "ms_per_iteration"] for rep in reports])
    out["m"].update(seconds_by_rank=[rep["u"]["m"]["seconds"]
                                     for rep in reports])
    return out


def replica_cards(torch, tst, ck, world) -> dict:
    """(r): replica workers one card each on config 4's 10M rows (on card
    0; each other card gets a copy of its worker's rows): per-cycle τ=0,
    Bernoulli and sliced, bitwise the same fleet on card 0 alone, one
    launch a round on each card; the resident mode by
    ``chip_smoke.resident_checks``; τ=2 by ``chip_smoke.replica_async``;
    B1 timed on a worker's own card."""
    devices = [torch.device("cuda", i) for i in range(world)]
    X, y, _ = cs.make_full_data(torch, cs.FULL_ROWS, cs.FULL_D)
    R = cs.REPLICA_ROUNDS
    each = {f"replica-w{s}": R for s in range(world)}
    out = {"workers": world, "rows": X.shape[0], "per_cycle": {}}
    for mode in ("bernoulli", "sliced"):
        def fleet(devs):
            drv = cs._replica_driver(tst, mode, R).set_workers(world)
            return cs._counted_run(torch, ck, drv.set_devices(devs), X, y, R)

        cards, one = fleet(devices), fleet(devices[:1])
        for run, what in ((cards, "cards"), (one, "card 0")):
            cs._replica_launches(run, mode, world * R, f"(r) {mode} {what}")
        cs.check(cards["by_worker"] == each,
                 f"(r) {mode}: launches by worker (card) "
                 f"{cards['by_worker']}, want {R} each")
        same = (torch.equal(cards["w"], one["w"])
                and np.array_equal(cards["h"], one["h"]))
        cs.check(same, f"(r) {mode}: {world} cards differ from card 0 alone")
        out["per_cycle"][mode] = {
            "bitwise_one_card_fleet": same,
            "launches_by_card": cards["by_worker"],
            "ms_per_round": cards["ms_per_round"],
            "one_card_ms_per_round": one["ms_per_round"]}
    out["resident"], _ = cs.resident_checks(
        torch, ck, tst, X, y, workers=world, devices=devices,
        what="(r) resident")
    tau0 = cs._replica_run(torch, ck, cs._replica_driver(
        tst, "bernoulli", cs.REPLICA_STEPS).set_workers(world)
        .set_devices(devices), X, y, cs.REPLICA_STEPS)
    tau0["objective"] = cs.ls_objective_exact(torch, X, y, tau0["w"])
    out["tau2"] = cs.replica_async(torch, tst, ck, X, y, tau0,
                                   workers=world, devices=devices)
    out["tau2"]["one_card_steps_per_s_pr15"] = 185.0
    # B1 on card 1, at worker 1's shard (a copy on its card)
    rows = X.shape[0] // world
    with torch.cuda.device(1):
        dev = torch.device("cuda", 1)
        Xs = X[rows:2 * rows].to(dev)
        ys = y[rows:2 * rows].to(dev)
        gen = torch.Generator(device=dev).manual_seed(37)
        w = torch.randn(Xs.shape[1], generator=gen, device=dev) / 32.0
        mask = torch.rand(rows, generator=gen, device=dev) < cs.FRAC
        row = cs.b1_row(torch, ck, tst.LeastSquaresGradient().pointwise, Xs,
                        ys, w, mask, f"replica worker 1's {rows:,} rows on "
                        "its own card (cuda:1), 10% mask", 20)
    row["launches"] = out["per_cycle"]["bernoulli"]["launches_by_card"][
        "replica-w1"]
    row["launches_from"] = "(r) the per-cycle Bernoulli run, card 1"
    out["b1_row_card1"] = {k: v for k, v in row.items() if k != "turns"}
    del X, y, Xs, ys
    torch.cuda.empty_cache()
    return out


def check_reference(torch, tst, reports, arrays, Xh, yh) -> dict:
    """Every rank's runs bitwise equal, and equal to the one-process
    rank-order sum of the same blocks (the same streamed shares) on card
    0."""
    world = len(reports)
    for k in arrays[0]:
        if k.startswith("e_block_"):
            continue  # a 2-D rank's weight block: its model column's
        cs.check(all(np.array_equal(a[k], arrays[0][k]) for a in arrays),
                 f"ranks differ in {k}")
    n, d = cs.FULL_ROWS, cs.FULL_D
    rows = n // world
    X = torch.empty((n, d), dtype=torch.bfloat16, device="cuda")
    y = torch.empty((n,), dtype=torch.float32, device="cuda")
    blocks = [(X[b * rows:(b + 1) * rows], y[b * rows:(b + 1) * rows])
              for b in range(world)]
    for b, (Xb, yb) in enumerate(blocks):
        cs.fill_mesh_block(torch, Xb, yb, b)
    bitwise = {}
    for mode in MODES:
        w, h = cs.rank_order_reference(torch, tst, blocks, mode)
        bitwise[mode] = (np.array_equal(arrays[0][mode + "_w"],
                                        w.cpu().numpy())
                         and np.array_equal(arrays[0][mode + "_h"], h))
        cs.check(bitwise[mode], f"{mode}: not the one-process rank-order sum")
    t_same = cs.mesh_lbfgs_checks(torch, tst, [rep["t"] for rep in reports],
                                  arrays[0], blocks)
    agreed = [rep["t"]["host_decisions_agreed"] for rep in reports]
    cs.check(agreed[0] > 0 and len(set(agreed)) == 1,
             f"(t): host decisions agreed by rank {agreed}")
    t_out = {"bitwise_rank_order_sum": t_same,
             "cost_evaluations": reports[0]["t"]["cost_evaluations"],
             "b1_launches_by_rank": [rep["t"]["b1_launches"]
                                     for rep in reports],
             "host_decisions_agreed_by_rank": agreed,
             "ms_per_iteration_by_rank": [rep["t"]["ms_per_iteration"]
                                          for rep in reports]}
    del X, y, blocks
    torch.cuda.empty_cache()
    for key, mode, topk in [(m, m, None) for m in MODES] + [
            ("topk", "bernoulli", float(cs.MESH_TOPK.split(":")[1]))]:
        cfg = cs._stream_mesh_opt(tst, None, mode, cs._mode_frac(mode),
                                  STREAM_ITERS).config
        w, h = cs.streamed_rank_order_reference(torch, tst, Xh, yh, cfg,
                                                world, topk=topk)
        key = "streamed_" + key
        bitwise[key] = (np.array_equal(arrays[0][key.replace(
            "streamed_", "stream_") + "_w"], w.cpu().numpy())
            and np.array_equal(arrays[0][key.replace(
                "streamed_", "stream_") + "_h"], h))
        cs.check(bitwise[key], f"{key}: not the one-process rank-order sum")
    return {"ranks": world, "rows_per_rank": rows,
             "bitwise_rank_order_sum": bitwise, "ranks_bitwise_equal": True,
             "wall_ms_per_iteration": {
                 m: [rep["modes"][m]["wall_ms_per_iteration"]
                     for rep in reports] for m in MODES},
             "device_ms_per_iteration": {
                 m: [rep["modes"][m]["device_ms_per_iteration"]
                     for rep in reports] for m in MODES},
             "combine_ms": [rep["combine_ms"] for rep in reports],
             "observed_stop_and_resume": reports[0]["observed"],
             "streamed": reports[0]["streamed"], "t": t_out}


if __name__ == "__main__":
    sys.exit(main())

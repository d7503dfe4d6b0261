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

Not checked here yet, each to run on a host with several cards (ROADMAP
A, item 1): the 2-D ``(data, model)`` mesh and meshed L-BFGS over NCCL;
the streamed CostFun and statistics on the mesh; replica workers across
cards (``tpu_sgd_torch.replica.ReplicaDriver`` with one card a worker:
each worker's payload hops to the store's card, the pulled weights to
the worker's, and a τ=0 run must stay bitwise the one-card run); and
``set_resident_rounds(k)`` with one card a worker, which raises until
then.
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
TIMEOUT = 300               # seconds for the ranks
STREAM_ROWS = 1_000_000     # host rows of the streamed runs
STREAM_ITERS = 40           # K = 8: per slot a warm-up, a capture, replays
SLOW_SAVE_S = 1.0           # rank 0's delay before each checkpoint write


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
    and resume, dense and compressed.  Returns ``(report, arrays)``."""
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
    return report, arrays


def rank_main(rank: int, world: int, port: int, out_dir: str) -> int:
    """Rank ``rank``'s runs on card ``rank``.  A rank still running
    ``TIMEOUT - 30`` s in prints every thread's stack to its log and
    exits."""
    import faulthandler
    import gc

    import torch

    import tpu_sgd_torch as tst
    from tpu_sgd_torch import parallel as par
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
    report["combine_ms"] = cs._combine_ms(torch, par, mesh)["combine_ms"]
    report["streamed"], st_arrays = streamed_runs(torch, tst, mesh, out_dir)
    arrays.update(st_arrays)
    print(f"rank {rank}: streamed done", flush=True)
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

    torch.backends.cuda.matmul.allow_tf32 = False
    world = torch.cuda.device_count()
    if sys.argv[1:2] == ["--ranks"]:
        world = int(sys.argv[2])
    cs.check(2 <= world <= torch.cuda.device_count(),
             f"{world} ranks on {torch.cuda.device_count()} cards")
    print(cs.nvidia_smi_line(), flush=True)
    _build.build_all()
    X, y, _ = cs.make_full_data(torch, STREAM_ROWS, cs.FULL_D)
    Xh, fd = cs.shared_host_rows(torch, X)
    yh = y.cpu()
    del X, y
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        with open(os.path.join(tmp, "streamed.json"), "w") as f:
            json.dump({"fd": fd, "shape": list(Xh.shape)}, f)
        np.save(os.path.join(tmp, "y.npy"), yh.numpy())
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
    summary = check_reference(torch, tst, reports, arrays, Xh, yh)
    cs.emit({"job_seconds": job_s, **summary})
    return 0


def check_reference(torch, tst, reports, arrays, Xh, yh) -> dict:
    """Every rank's runs bitwise equal, and equal to the one-process
    rank-order sum of the same blocks (the same streamed shares) on card
    0."""
    world = len(reports)
    for k in arrays[0]:
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
             "streamed": reports[0]["streamed"]}


if __name__ == "__main__":
    sys.exit(main())

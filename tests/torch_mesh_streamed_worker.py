"""One rank of the gloo world of ``tests/test_torch_mesh_streamed.py``.

    python tests/torch_mesh_streamed_worker.py RANK WORLD PORT DIR

Reads ``DIR/inputs.npz`` (global datasets, written by the test) and the
JAX package's meshed compressed checkpoint under ``DIR/jax_ck``, trains
each case through ``tpu_sgd_torch`` on the CPU with host streaming on a
data mesh (SGD on the dense and the compressed wire, the streamed
CostFun on one host and on a declared split over two hosts, the
streamed statistics and totals, the streamed normal equations), and
writes ``DIR/out<RANK>.npz``.  On one host every rank passes the WHOLE
host dataset, mapped from one shared file (``np.load(mmap_mode="r")``);
on the declared two-host mesh each rank passes its local rows.  Imports
the port only: neither JAX nor the JAX package.
"""

import faulthandler
import json
import os
import shutil
import sys
import warnings

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = "cpu"
ITERS = 24
STOP_AT = 13


def _warned(fn):
    """``(result, messages of the RuntimeWarnings fn raised)``."""
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        got = fn()
    return got, [str(r.message) for r in rec
                 if issubclass(r.category, RuntimeWarning)]


#: a rank still running this long prints every thread's stack and exits,
#: before the test's 240 s limit for the world (a rank that skipped a
#: collective leaves the others waiting in theirs)
HANG_DUMP_S = 210


def main(rank, world, port, tmp):
    faulthandler.dump_traceback_later(HANG_DUMP_S, exit=True)
    torch.set_num_threads(1)
    sys.path.insert(0, ROOT)
    import tpu_sgd_torch as tst
    from tpu_sgd_torch import parallel as par
    from tpu_sgd_torch.obs import counters
    from tpu_sgd_torch.reliability import TrainingPreempted
    from tpu_sgd_torch.reliability import failpoints as fp
    from tpu_sgd_torch.utils import CollectingListener
    from tpu_sgd_torch.utils.checkpoint import CheckpointManager

    par.initialize_distributed(f"tcp://127.0.0.1:{port}", world, rank,
                               backend="gloo")
    mesh = par.data_mesh()
    two_hosts = par.data_mesh(hosts=[r // (world // 2)
                                     for r in range(world)])
    with np.load(os.path.join(tmp, "inputs.npz")) as z:
        inp = {k: z[k] for k in z.files}
    # the host rows of one host: one file, mapped by every rank
    inp["gd_X"] = np.load(os.path.join(tmp, "gd_X.npy"), mmap_mode="r")
    n_gd, d_gd = inp["gd_X"].shape
    Xb = torch.from_file(os.path.join(tmp, "gd_X.bf16"), shared=True,
                         size=n_gd * d_gd, dtype=torch.bfloat16).view(
                             n_gd, d_gd)
    out = {"rank": np.array([mesh.rank, mesh.size]),
           "spans": np.array([par.mesh_spans_processes(mesh),
                              par.mesh_spans_processes(two_hosts)])}

    def data(name):
        return inp[name + "_X"], inp[name + "_y"]

    def gd(mode="bernoulli", frac=0.2, iters=ITERS, step=0.4, k=1,
           wc=None, seed=42, m=mesh):
        o = (tst.GradientDescent(device=CPU).set_step_size(step)
             .set_num_iterations(iters).set_mini_batch_fraction(frac)
             .set_sampling(mode).set_convergence_tol(0.0).set_seed(seed)
             .set_host_streaming(True).set_superstep(k))
        if wc:
            o.set_ingest_options(wire_compress=wc)
        return o.set_mesh(m) if m is not None else o

    def keep(key, got):
        w, h = got
        out[key + "_w"], out[key + "_h"] = np.asarray(w), np.asarray(h)

    zeros = {name: np.zeros(inp[name + "_X"].shape[1], np.float32)
             for name in ("gd", "sw", "ef", "cg")}

    # ---- streamed SGD on the mesh (test_gradient_descent.py:230) --------
    for mode, frac in (("bernoulli", 0.2), ("indexed", 0.2),
                       ("sliced", 0.2), ("full", 1.0)):
        samp = "bernoulli" if mode == "full" else mode
        keep(f"sgd_{mode}", gd(samp, frac).optimize_with_history(
            data("gd"), zeros["gd"]))
        keep(f"sgd_{mode}_again", gd(samp, frac).optimize_with_history(
            data("gd"), zeros["gd"]))
        keep(f"sgd_{mode}_k4", gd(samp, frac, k=4).optimize_with_history(
            data("gd"), zeros["gd"]))
        o = gd(samp, frac).set_ingest_options(prefetch_depth=0)
        keep(f"sgd_{mode}_depth0", o.optimize_with_history(
            data("gd"), zeros["gd"]))
    # neither map is copied on its way in
    from tpu_sgd_torch.io.wire import host_tensor

    out["maps_wrapped"] = np.array([
        host_tensor(inp["gd_X"]).data_ptr() == inp["gd_X"].ctypes.data,
        host_tensor(Xb).data_ptr() == Xb.data_ptr()])
    # the bf16 host map and the bf16 wire: the same share rules
    keep("sgd_bf16", gd().optimize_with_history((Xb, inp["gd_y"]),
                                                 zeros["gd"]))
    keep("sgd_bf16_wire", gd().set_ingest_options(wire_dtype="bfloat16")
         .optimize_with_history(data("gd"), zeros["gd"]))
    # the listener sees every iteration on every rank
    lis = CollectingListener()
    keep("sgd_listener", gd().set_listener(lis).optimize_with_history(
        data("gd"), zeros["gd"]))
    out["sgd_listener_events"] = np.array(len(lis.iterations))

    # a stop raised by one rank's signal at STOP_AT, and the resume
    ck = os.path.join(tmp, "ck_sgd")
    if rank == 0:
        shutil.rmtree(ck, ignore_errors=True)
    par.mesh.barrier(mesh, CPU)
    seen = {"i": 0}

    class Count(CollectingListener):
        def on_iteration(self, ev):
            seen["i"] = ev.iteration

    for k in (1, 4):
        o = (gd(k=k).set_listener(Count())
             .set_checkpoint(CheckpointManager(f"{ck}{k}"), every=5)
             .set_stop_signal(lambda: rank == world - 1
                              and seen["i"] >= STOP_AT))
        try:
            o.optimize_with_history(data("gd"), zeros["gd"])
            out[f"sgd_stop{k}_at"] = np.array(-1)
        except TrainingPreempted as e:
            out[f"sgd_stop{k}_at"] = np.array(e.iteration)
        seen["i"] = 0
        keep(f"sgd_resume{k}", gd(k=k).set_checkpoint(
            CheckpointManager(f"{ck}{k}"), every=5).optimize_with_history(
                data("gd"), zeros["gd"]))

    # the guards that need a process group
    def raises(fn):
        try:
            fn()
        except Exception as e:  # noqa: BLE001 - the test reads the message
            return np.array(f"{type(e).__name__}: {e}")
        return np.array("")

    out["raise_two_hosts"] = raises(lambda: gd(m=two_hosts)
                                    .optimize_with_history(
                                        data("gd"), zeros["gd"]))
    out["raise_resident"] = raises(lambda: gd("sliced").set_host_streaming(
        True, resident_rows=1000).optimize_with_history(
            data("gd"), zeros["gd"]))
    _, out["warn_residency"] = _warned(lambda: gd(k=4).set_residency(2)
                                       .optimize_with_history(
                                           data("gd"), zeros["gd"]))

    # ---- the compressed wire on the mesh (test_sparse_wire.py:230, :258)
    for k in (1, 4):
        keep(f"cw{k}", gd(iters=60, step=0.05, frac=0.5, k=k, seed=7,
                          wc="topk:0.5").optimize_with_history(
                              data("sw"), zeros["sw"]))
    keep("cw_dense", gd(iters=60, step=0.05, frac=0.5, seed=7)
         .optimize_with_history(data("sw"), zeros["sw"]))
    keep("cw_full4", gd(iters=12, step=0.05, frac=1.0, k=4, seed=7,
                        wc="topk:0.25").optimize_with_history(
                            data("sw"), zeros["sw"]))
    keep("cw_again", gd(iters=60, step=0.05, frac=0.5, seed=7,
                        wc="topk:0.5").optimize_with_history(
                            data("sw"), zeros["sw"]))
    for samp, k in (("bernoulli", 1), ("sliced", 4), ("indexed", 4)):
        def mk(s=samp, kk=k):
            return gd(s, frac=0.5, iters=ITERS, step=0.05, k=kk, seed=7,
                      wc="topk:0.25")

        keep(f"ef_ref_{samp}", mk().optimize_with_history(
            data("ef"), zeros["ef"]))
        d = os.path.join(tmp, f"ck_ef_{samp}_{k}")
        if rank == 0:
            shutil.rmtree(d, ignore_errors=True)
        par.mesh.barrier(mesh, CPU)
        crash = 7 if k == 1 else 3
        with fp.inject_faults({"optimize.streamed.step":
                               fp.fail_nth(crash)}):
            out[f"ef_crash_{samp}"] = raises(
                lambda: mk().set_checkpoint(CheckpointManager(d), every=5)
                .optimize_with_history(data("ef"), zeros["ef"]))
        par.mesh.barrier(mesh, CPU)
        keep(f"ef_res_{samp}", mk().set_checkpoint(CheckpointManager(d),
                                                   every=5)
             .optimize_with_history(data("ef"), zeros["ef"]))
        if samp == "bernoulli":
            # a preempted run for the JAX package to resume
            d2 = os.path.join(tmp, "port_ck")
            if rank == 0:
                shutil.rmtree(d2, ignore_errors=True)
            par.mesh.barrier(mesh, CPU)
            with fp.inject_faults({"optimize.streamed.step":
                                   fp.fail_nth(crash)}):
                raises(lambda: mk().set_checkpoint(
                    CheckpointManager(d2), every=5).optimize_with_history(
                        data("ef"), zeros["ef"]))
            par.mesh.barrier(mesh, CPU)
            # the JAX package's preempted run, resumed here
            d3 = os.path.join(tmp, f"jax_ck_copy{rank}")
            shutil.copytree(os.path.join(tmp, "jax_ck"), d3)
            keep("ef_from_jax", mk().set_checkpoint(
                CheckpointManager(d3), every=5).optimize_with_history(
                    data("ef"), zeros["ef"]))

    # the meshed compressed builders on this rank's rows at full batch
    # (its share of cw_full4's): the step loop, the shared-batch blocks
    # and the per-step-batch blocks
    Xr, yr = (torch.as_tensor(np.ascontiguousarray(a)) for a in
              par.local_rows(inp["sw_X"], inp["sw_y"], rank, world))
    vr = torch.ones(Xr.shape[0], dtype=torch.bool)
    cfg = tst.SGDConfig(step_size=0.05, num_iterations=12,
                        mini_batch_fraction=1.0, convergence_tol=0.0,
                        seed=7)
    g, u = tst.LeastSquaresGradient(), tst.SimpleUpdater()
    reg0 = float(u.compute(torch.zeros(20), torch.zeros(20), 0.0, 1,
                           0.0)[1])
    step = par.dp_compressed_step_fn(g, u, cfg, 0.25, mesh)
    w, ef, reg, hist = torch.zeros(20), torch.zeros(20), \
        torch.full((), reg0), []
    for i in range(1, 13):
        w, ef, loss, reg, _ = step(w, ef, Xr, yr, i, reg, vr)
        hist.append(float(loss))
    keep("dp_step", (w, np.asarray(hist, np.float32)))
    out["dp_step_ef"] = ef.numpy()
    for key, fn, args in (
            ("dp_shared", par.dp_compressed_shared_superstep_fn(
                g, u, cfg, 0.25, 4, mesh), (Xr, yr, vr)),
            ("dp_stacked", par.dp_compressed_superstep_fn(
                g, u, cfg, 0.25, mesh), tuple(
                    torch.stack([t] * 4) for t in (Xr, yr, vr)))):
        w, ef, reg, hist = torch.zeros(20), torch.zeros(20), reg0, []
        for i0 in (1, 5, 9):
            w, ef, leaves = fn(w, ef, reg, i0, *args)
            hist.extend(leaves[1])
            reg = float(leaves[2][-1])
        keep(key, (w, np.asarray(hist, np.float32)))
        out[key + "_ef"] = ef.numpy()
        out[key + "_ef_rows"] = np.asarray(leaves[6]).shape

    # ---- the composition grid's meshed cells (test_composition.py:220)
    def cg(iters, k, c=0, wc=None):
        o = gd(frac=0.5, iters=iters, step=0.1, k=k, seed=7, wc=wc)
        return o.set_residency(c) if c else o

    (w_r, h_r), out["cg_warn"] = _warned(
        lambda: cg(12, 4, c=2).optimize_with_history(data("cg"),
                                                     zeros["cg"]))
    keep("cg_resident", (w_r, h_r))
    keep("cg_super", cg(12, 4).optimize_with_history(data("cg"),
                                                     zeros["cg"]))
    keep("cg_dense", cg(80, 4).optimize_with_history(data("cg"),
                                                     zeros["cg"]))
    keep("cg_comp", cg(80, 4, wc="topk:0.75").optimize_with_history(
        data("cg"), zeros["cg"]))

    # ---- the streamed CostFun (test_streamed_costfun.py:201, :226) ------
    def lbfgs(iters, m=mesh, batch_rows=512):
        return (tst.LBFGS(tst.LogisticGradient(), tst.SquaredL2Updater(),
                          max_num_iterations=iters, convergence_tol=0.0,
                          reg_param=0.01, device=CPU)
                .set_host_streaming(True, batch_rows=batch_rows).set_mesh(m))

    keep("cf_lbfgs", lbfgs(12).optimize_with_history(data("cf"),
                                                     zeros_like(inp, "cf")))
    keep("cf_lbfgs_again", lbfgs(12).optimize_with_history(
        data("cf"), zeros_like(inp, "cf")))
    keep("cf_owlqn", tst.OWLQN(tst.LogisticGradient(), reg_param=0.01,
                               max_num_iterations=8, convergence_tol=0.0,
                               device=CPU)
         .set_host_streaming(True, batch_rows=512).set_mesh(mesh)
         .optimize_with_history(data("cf"), zeros_like(inp, "cf")))
    from tpu_sgd_torch.optimize.streamed_costfun import StreamedCostFun

    scf = StreamedCostFun(tst.LogisticGradient(), *data("cap"),
                          batch_rows=250, mesh=mesh, device=CPU)
    w = torch.as_tensor(inp["cap_w"])
    gs, ls, c = scf.cost_sums(w)
    out["cap_sums"] = np.concatenate([gs.numpy(), [ls.item(), c.item()]])
    out["cap_grid"] = np.array([scf.cap, scf.share, scf.n_chunks])
    out["cap_sweep"] = np.concatenate([t.reshape(-1).numpy() for t in
                                       scf.sweep_sums(torch.stack([w, -w]))])
    # several hosts: each rank its local rows (test_multihost.py:166)
    Xg, yg = data("mh")
    Xl, yl = par.local_rows(Xg, yg, rank, world)
    keep("mh", lbfgs(8, two_hosts, 40).optimize_with_history(
        (Xl, yl), zeros_like(inp, "mh")))
    # a rank with no rows joins every combine (test_multihost.py:190)
    lo = 0 if rank == 0 else Xg.shape[0]
    keep("mh_zero", lbfgs(4, two_hosts, 40).optimize_with_history(
        (Xg[lo:], yg[lo:]), zeros_like(inp, "mh")))
    scf2 = StreamedCostFun(tst.LogisticGradient(), Xl, yl, batch_rows=40,
                           mesh=two_hosts, device=CPU)
    out["mh_grid"] = np.array([scf2.cap, scf2.share, scf2.n_chunks])

    # ---- the streamed statistics (test_gram.py:900, :953, :989, :1074)
    from tpu_sgd_torch.parallel.gram_parallel import (
        build_streamed_sharded_gram_stats,
        build_streamed_total_stats,
    )

    data_st, B, n_used = build_streamed_sharded_gram_stats(
        mesh, *data("st"), block_rows=64, batch_rows=128, device=CPU)
    out["st_geom"] = np.array([B, n_used])
    for leaf in ("PG", "Pb", "Pyy", "G_tot", "b_tot", "yy_tot"):
        out["st_" + leaf] = getattr(data_st, leaf).numpy()
    # resumable: a stop in the feed, then the same directory
    rd = os.path.join(tmp, "st_resume")
    if rank == 0:
        shutil.rmtree(rd, ignore_errors=True)
    par.mesh.barrier(mesh, CPU)
    with fp.inject_faults({"io.prefetch.produce": fp.fail_nth(3)}):
        out["st_stopped"] = raises(lambda: build_streamed_sharded_gram_stats(
            mesh, *data("st"), block_rows=64, batch_rows=64, resume_dir=rd,
            device=CPU))
    out["st_parts"] = np.array(len(os.listdir(os.path.join(
        rd, f"shard_{rank}"))))
    resumed, _, _ = build_streamed_sharded_gram_stats(
        mesh, *data("st"), block_rows=64, batch_rows=64, resume_dir=rd,
        device=CPU)
    out["st_resumed_equal"] = np.array(all(
        torch.equal(getattr(resumed, leaf), getattr(data_st, leaf))
        for leaf in ("PG", "Pb", "Pyy", "G_tot", "b_tot", "yy_tot")))

    def gsd(frac=0.25, mode="sliced"):
        return (tst.GradientDescent(device=CPU).set_step_size(0.3)
                .set_num_iterations(20).set_mini_batch_fraction(frac)
                .set_sampling(mode).set_convergence_tol(0.0).set_seed(9)
                .set_mesh(mesh).set_gram_options(block_rows=64))

    opt_v = gsd().set_streamed_stats(True)
    keep("gs_virtual", opt_v.optimize_with_history(data("gs"),
                                                   zeros_like(inp, "gs")))
    entry = opt_v._streamed_gram_dp_entry
    keep("gs_virtual_again", opt_v.optimize_with_history(
        data("gs"), zeros_like(inp, "gs")))
    out["gs_cached"] = np.array(opt_v._streamed_gram_dp_entry is entry)
    opt_v.release_sufficient_stats()
    out["gs_released"] = np.array(opt_v._streamed_gram_dp_entry is None)
    Xr, yr = par.local_rows(*data("gs"), rank, world)
    keep("gs_resident", gsd().set_sufficient_stats(True)
         .set_gram_options(aligned=True).optimize_with_history(
             (Xr, yr), zeros_like(inp, "gs")))
    keep("gs_full", gsd(frac=1.0).set_streamed_stats(True)
         .optimize_with_history(data("gs"), zeros_like(inp, "gs")))
    # the dropped chunk_iters warns on this route too
    # (test_gradient_descent.py:537)
    _, out["gs_chunk_warn"] = _warned(
        lambda: gsd().set_streamed_stats(True).set_gram_options(
            chunk_iters=4).optimize_with_history(data("gs"),
                                                 zeros_like(inp, "gs")))
    # the totals, dense and compressed (test_sparse_wire.py:128)
    counters.enable()
    counters.reset()
    dense = build_streamed_total_stats(mesh, *data("tt"), block_rows=32,
                                       device=CPU)
    dense_wire = counters.snapshot()
    counters.reset()
    comp = build_streamed_total_stats(mesh, *data("tt"), block_rows=32,
                                      wire_compress="topk:0.05", device=CPU)
    comp_wire = counters.snapshot()
    counters.disable()
    counters.reset()
    for name, t in (("dense", dense), ("comp", comp)):
        out[f"tt_{name}"] = np.concatenate([
            t.G_tot.double().reshape(-1).numpy(), t.b_tot.numpy(),
            t.yy_tot.reshape(1).numpy()])
    out["tt_dtypes"] = np.array([str(dense.G_tot.dtype),
                                 str(dense.b_tot.dtype)])
    out["tt_wire"] = np.array(json.dumps([dense_wire, comp_wire]))
    # a resumed totals build
    rd = os.path.join(tmp, "tt_resume")
    if rank == 0:
        shutil.rmtree(rd, ignore_errors=True)
    par.mesh.barrier(mesh, CPU)
    again = build_streamed_total_stats(mesh, *data("tt"), block_rows=32,
                                       batch_rows=32, resume_dir=rd,
                                       device=CPU)
    out["tt_resume_equal"] = np.array(
        torch.equal(again.G_tot, dense.G_tot)
        and torch.equal(again.b_tot, dense.b_tot))
    out["tt_resume_gone"] = np.array(not os.path.exists(rd))

    # L-BFGS from the totals (test_lbfgs.py:186; test_sparse_wire.py:165)
    def lbs(wc=None):
        o = (tst.LBFGS(tst.LeastSquaresGradient(), tst.SimpleUpdater(),
                       max_num_iterations=12, convergence_tol=0.0,
                       device=CPU).set_mesh(mesh)
             .set_streamed_stats(True, block_rows=128))
        return o.set_ingest_options(wire_compress=wc) if wc else o

    o = lbs()
    keep("lbs", o.optimize_with_history(data("lb"), zeros_like(inp, "lb")))
    entry = o._streamed_gram_entry
    o.optimize_with_history(data("lb"), zeros_like(inp, "lb"))
    out["lbs_cached"] = np.array(o._streamed_gram_entry is entry)
    keep("lbs_comp", lbs("topk:0.1").optimize_with_history(
        data("lb"), zeros_like(inp, "lb")))
    # the normal equations (test_normal.py:96; test_parallel.py:225)
    out["ne_w"] = tst.NormalEquations(reg_param=0.01, device=CPU) \
        .set_mesh(mesh).set_host_streaming(True, batch_rows=64) \
        .optimize(data("ne"), zeros_like(inp, "ne")).numpy()
    flat = par.make_mesh(n_data=world, n_model=1)
    out["ne_trivial_w"] = tst.NormalEquations(reg_param=0.01, device=CPU) \
        .set_mesh(flat).set_host_streaming(True) \
        .optimize(data("ne2"), zeros_like(inp, "ne2")).numpy()

    out["leaked"] = np.array(sorted(
        m for m in sys.modules
        if m.split(".")[0] in ("jax", "jaxlib", "tpu_sgd")), dtype=str)
    np.savez(os.path.join(tmp, f"out{rank}.npz"), **out)
    par.mesh.barrier(mesh, CPU)
    torch.distributed.destroy_process_group()
    faulthandler.cancel_dump_traceback_later()


def zeros_like(inp, name):
    return np.zeros(inp[name + "_X"].shape[1], np.float32)


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])

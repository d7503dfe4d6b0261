"""One rank of the gloo world of ``tests/test_torch_mesh_resident.py``.

    python tests/torch_mesh_resident_worker.py RANK WORLD PORT DIR

Reads ``DIR/inputs.npz`` (global datasets and the JAX package's per-shard
samples, written by the test), trains each case on this rank's rows
through ``tpu_sgd_torch`` on the CPU (the 2-D ``(data, model)`` mesh,
sufficient statistics on the data mesh, residency and feature scaling on
a mesh), and writes ``DIR/out<RANK>.npz``.  Imports the port only:
neither JAX nor the JAX package.
"""

import os
import sys
import warnings

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
CPU = "cpu"
N_DATA, N_MODEL = 4, 2


def _message(fn):
    """The type and message of what ``fn()`` raises ('' when it runs)."""
    try:
        fn()
    except Exception as e:  # noqa: BLE001 - the test reads the type
        return np.array(f"{type(e).__name__}: {e}")
    return np.array("")


def _warned(fn):
    """``(result, messages of the RuntimeWarnings fn raised)``."""
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        got = fn()
    return got, [str(r.message) for r in rec
                 if issubclass(r.category, RuntimeWarning)]


def main(rank, world, port, tmp):
    torch.set_num_threads(1)
    sys.path.insert(0, ROOT)
    import tpu_sgd_torch as tst
    from tpu_sgd_torch import parallel as par
    from tpu_sgd_torch.ops import cuda_kernels as ck
    from tpu_sgd_torch.optimize import gradient_descent as tgd
    from tpu_sgd_torch.utils import CollectingListener
    from torch_parallel_worker import inject

    par.initialize_distributed(f"tcp://127.0.0.1:{port}", world, rank,
                               backend="gloo")
    m2 = par.make_mesh(n_data=N_DATA, n_model=N_MODEL)
    flat = par.make_mesh(n_data=world, n_model=1)
    mesh = par.data_mesh()
    inp = np.load(os.path.join(tmp, "inputs.npz"))
    di = rank // N_MODEL
    out = {"rank": np.array([rank, m2.rank, m2.model_index, m2.size,
                             m2.n_model, flat.rank, flat.size])}

    def rows2(name):  # this rank's rows on the 2-D mesh: its data block
        return par.local_rows(inp[name + "_X"], inp[name + "_y"], di,
                              N_DATA)

    def rows1(name):
        return par.local_rows(inp[name + "_X"], inp[name + "_y"], rank,
                              world)

    def gd(m, gradient=None, updater=None, **knobs):
        o = tst.GradientDescent(gradient, updater, device=CPU)
        o.set_convergence_tol(0.0).set_mesh(m)
        for k, v in knobs.items():
            getattr(o, "set_" + k)(*(v if isinstance(v, tuple) else (v,)))
        return o

    # ---- the 2-D mesh: test_parallel.py's Test2DMesh -------------------
    for name, upd, knobs in (
            ("par", tst.SimpleUpdater(), dict(step_size=0.3,
                                              num_iterations=30)),
            ("uneven", tst.L1Updater(), dict(step_size=0.3, reg_param=0.05,
                                             num_iterations=20)),
            ("conv", tst.SquaredL2Updater(), dict(
                step_size=0.5, reg_param=0.01, num_iterations=400)),
            ("route", tst.SimpleUpdater(), dict(step_size=0.5,
                                                num_iterations=150))):
        o = gd(m2, tst.LeastSquaresGradient(), upd, **knobs)
        if name == "conv":
            o.set_convergence_tol(1e-3)
        Xl, yl = rows2(name)
        ck.reset_launch_counts()
        w, h = o.optimize_with_history((Xl, yl),
                                       np.zeros(Xl.shape[1], np.float32))
        out[f"d2_{name}_w"], out[f"d2_{name}_h"] = w.numpy(), h
        out[f"d2_{name}_products"] = np.array(ck.model_axis_product_counts())
        out[f"d2_{name}_kernels"] = np.array(
            sum(ck.launch_counts().values()))
    Xl, yl = rows2("warm")
    w, h = gd(m2, tst.LeastSquaresGradient(), tst.SquaredL2Updater(),
              step_size=0.1, reg_param=0.3, num_iterations=5) \
        .optimize_with_history((Xl, yl), np.full(16, 0.5, np.float32))
    out["d2_warm_h"] = h
    # the rank's block of the run (model column: same block) and the
    # whole vector gathered on every rank
    Xs, ys, valid = par.shard_dataset(
        par.Mesh({par.DATA_AXIS: N_DATA}, m2.group), *rows2("uneven"),
        device=CPU)
    Xb, wb, d = par.feature_block(m2, Xs, torch.zeros(13))
    cfg = tst.SGDConfig(step_size=0.3, num_iterations=20, reg_param=0.05,
                        convergence_tol=0.0)
    run = par.dp_mp_run_fn(tst.LeastSquaresGradient(), tst.L1Updater(), cfg,
                           m2)
    wb, hb, nb = run(wb, Xb, ys, valid)
    out["d2_block_w"], out["d2_block_h"] = wb.numpy(), hb[:int(nb)].numpy()
    out["d2_block_width"] = np.array([Xb.shape[1], d])
    w, h, n = par.dp_mp_optimize(tst.LeastSquaresGradient(), tst.L1Updater(),
                                 cfg, m2, np.zeros(13, np.float32),
                                 *rows2("uneven"), device=CPU)
    out["d2_mpopt_w"], out["d2_mpopt_h"] = w.numpy(), h[:int(n)].numpy()

    # the JAX package's per-data-shard samples injected (model ranks of
    # one data row share the draws)
    for samp in ("bernoulli", "indexed", "sliced"):
        undo = inject(tgd, inp["inj2_" + samp][:, di])
        try:
            w, h = gd(m2, step_size=0.5, num_iterations=30,
                      mini_batch_fraction=0.2, sampling=samp) \
                .optimize_with_history(rows2("inj2"),
                                       np.zeros(9, np.float32))
        finally:
            undo()
        out[f"d2_inj_{samp}_w"], out[f"d2_inj_{samp}_h"] = w.numpy(), h

    # the port's own streams: against a one-process 2-D rank-order sum
    for samp in ("full", "bernoulli", "sliced"):
        frac = 1.0 if samp == "full" else 0.3
        w, h = gd(m2, tst.LeastSquaresGradient(), tst.SquaredL2Updater(),
                  step_size=0.3, reg_param=0.02, num_iterations=12,
                  mini_batch_fraction=frac,
                  sampling="bernoulli" if samp == "full" else samp) \
            .optimize_with_history(rows2("ro"), np.zeros(7, np.float32))
        out[f"d2_ro_{samp}_w"], out[f"d2_ro_{samp}_h"] = w.numpy(), h

    # a trivial model axis is the data mesh, bitwise
    for name, m in (("flat", flat), ("one_d", mesh)):
        w, h = gd(m, step_size=0.3, num_iterations=25, reg_param=0.01,
                  mini_batch_fraction=0.5).optimize_with_history(
            rows1("ro"), np.zeros(7, np.float32))
        out[f"{name}_w"], out[f"{name}_h"] = w.numpy(), h

    # what the reference refuses on a 2-D mesh, with its message
    Xl, yl = rows2("par")
    w0 = np.zeros(16, np.float32)
    Xsp = torch.as_tensor(Xl).to_sparse_csr()
    for key, fn in (
            ("sparse", lambda: gd(m2).optimize((Xsp, yl), w0)),
            ("multinomial", lambda: gd(
                m2, tst.MultinomialLogisticGradient(3)).optimize(
                (Xl, np.zeros_like(yl)), np.zeros(32, np.float32))),
            ("listener", lambda: gd(m2).set_listener(
                CollectingListener()).optimize((Xl, yl), w0)),
            ("host_streaming", lambda: gd(m2).set_host_streaming(True)
             .optimize((Xl, yl), w0)),
            ("streamed_stats", lambda: gd(m2).set_streamed_stats(True)
             .optimize((Xl, yl), w0)),
            ("lbfgs", lambda: tst.LBFGS(device=CPU).set_mesh(m2)),
            ("normal", lambda: tst.NormalEquations(device=CPU)
             .set_mesh(m2))):
        out["refuse_" + key] = _message(fn)
    out["refuse_as_data_mesh"] = _message(lambda: par.as_data_mesh(m2))
    out["flat_view"] = np.array(list(par.as_data_mesh(flat).shape.items()),
                                dtype=str)
    # train(..., mesh=) on the 2-D mesh (the SGD family)
    model = tst.LinearRegressionWithSGD.train(
        rows2("route"), 150, 0.5, 1.0, mesh=m2, device=CPU)
    out["d2_train_w"] = model.weights.numpy()

    # ---- sufficient statistics on the data mesh (test_gram.py) ----------
    def gram_opt(flag, **knobs):
        o = gd(mesh, tst.LeastSquaresGradient(), knobs.pop("updater", None),
               **knobs)
        return o.set_sufficient_stats(flag)

    Xr, yr = (torch.as_tensor(a) for a in rows1("gs"))
    undo = inject(tgd, inp["gs_draws"][:, rank])
    try:
        for flag in (False, True):
            o = gram_opt(flag, step_size=0.2, num_iterations=25,
                         mini_batch_fraction=0.2, sampling="sliced", seed=11)
            w, h = o.optimize_with_history((Xr, yr),
                                           np.zeros(24, np.float32))
            out[f"gs_sliced_{flag}_w"], out[f"gs_sliced_{flag}_h"] = (
                w.numpy(), h)
        out["gs_engaged"] = np.array(o._gram_dp_entry is not None)
        # the identity cache: the same tensors again reuse the build
        stats0 = o._gram_dp_entry[3]
        o.optimize_with_history((Xr, yr), np.zeros(24, np.float32))
        out["gs_cache_hit"] = np.array(o._gram_dp_entry[3] is stats0)
        o = gram_opt(True, step_size=0.2, num_iterations=25,
                     mini_batch_fraction=0.2, sampling="sliced", seed=11,
                     gram_options=(64, True))
        w, h = o.optimize_with_history(rows1("gs"), np.zeros(24, np.float32))
        out["gs_aligned_w"], out["gs_aligned_h"] = w.numpy(), h
    finally:
        undo()
    for flag in (False, True):
        o = gram_opt(flag, updater=tst.SquaredL2Updater(), step_size=0.3,
                     num_iterations=15, reg_param=0.01)
        w, h = o.optimize_with_history(rows1("gf"), np.zeros(12, np.float32))
        out[f"gs_full_{flag}_w"], out[f"gs_full_{flag}_h"] = w.numpy(), h
        out[f"gs_full_{flag}_engaged"] = np.array(
            o._gram_dp_entry is not None)
    for flag in (False, True):
        o = gram_opt(flag, updater=tst.SquaredL2Updater(), step_size=0.3,
                     num_iterations=8, reg_param=0.01)
        w, h = o.optimize_with_history(rows1("gp"), np.zeros(12, np.float32))
        out[f"gs_pad_{flag}_w"], out[f"gs_pad_{flag}_h"] = w.numpy(), h
        out[f"gs_pad_{flag}_engaged"] = np.array(
            o._gram_dp_entry is not None)
    # the port's own window streams, against the one-process rank-order
    # sum; the functional runner on the same statistics
    o = gram_opt(True, step_size=0.3, num_iterations=12,
                 mini_batch_fraction=0.25, sampling="sliced")
    Xr, yr = rows1("gf")
    w, h = o.optimize_with_history((Xr, yr), np.zeros(12, np.float32))
    out["gs_ro_w"], out["gs_ro_h"] = w.numpy(), h
    gram = o._gram_dp_entry[3]
    cfg = tst.SGDConfig(step_size=0.3, num_iterations=12,
                        mini_batch_fraction=0.25, sampling="sliced",
                        convergence_tol=0.0)
    w, h, n = par.dp_gram_run_fn(tst.SimpleUpdater(), cfg, mesh)(
        torch.zeros(12), gram.data, torch.as_tensor(yr))
    out["gs_fn_w"], out["gs_fn_h"] = w.numpy(), h[:int(n)].numpy()
    # the warnings: a listener drops the statistics; chunk_iters on a mesh
    _, msgs = _warned(lambda: gram_opt(True, num_iterations=2).set_listener(
        CollectingListener()).optimize_with_history(
        rows1("gf"), np.zeros(12, np.float32)))
    out["gs_listener_warns"] = np.array(msgs, dtype=str)
    (w, h), msgs = _warned(lambda: gram_opt(
        True, step_size=0.2, num_iterations=5, mini_batch_fraction=0.25,
        sampling="sliced", gram_options=(64, True, None, 8))
        .optimize_with_history(rows1("gf"), np.zeros(12, np.float32)))
    out["gs_chunk_warns"] = np.array(msgs, dtype=str)
    out["gs_chunk_finite"] = np.array(bool(torch.all(torch.isfinite(w))))

    # ---- set_residency on a mesh: warns, runs the superstep driver ------
    def observed(**knobs):
        lis = CollectingListener()
        o = gd(mesh, tst.LeastSquaresGradient(), tst.SquaredL2Updater(),
               step_size=0.2, reg_param=0.01, num_iterations=24,
               mini_batch_fraction=0.5, superstep=4, **knobs)
        return o.set_listener(lis).optimize_with_history(
            rows1("gf"), np.zeros(12, np.float32)), lis

    ((w, h), lis), msgs = _warned(lambda: observed(residency=3))
    out["res_w"], out["res_h"] = w.numpy(), h
    out["res_warns"] = np.array(msgs, dtype=str)
    out["res_events"] = np.array([e.iteration for e in lis.iterations])
    (w, h), lis = observed()
    out["sup_w"], out["sup_h"] = w.numpy(), h

    # ---- feature scaling on a mesh --------------------------------------
    for name, m, rows in (("fs", mesh, rows1), ("fs2d", m2, rows2)):
        alg = tst.LinearRegressionWithSGD(0.5, 40, 0.0, 1.0, device=CPU)
        alg.set_feature_scaling(True).set_intercept(True)
        alg.optimizer.set_convergence_tol(0.0).set_mesh(m)
        model = alg.run(rows("fsc"))
        out[f"{name}_w"] = model.weights.numpy()
        out[f"{name}_b"] = np.array(model.intercept)
    Xr, yr = rows1("fsc")
    scaler = tst.feature.StandardScaler().fit(Xr, mesh=mesh)
    out["fs_std"] = scaler.std.numpy()
    Xc = torch.as_tensor(Xr).to_sparse_csr()
    out["fs_sparse_std"] = tst.feature.StandardScaler().fit(
        Xc, mesh=mesh).std.numpy()

    out["leaked"] = np.array(sorted(
        m for m in sys.modules
        if m.split(".")[0] in ("jax", "jaxlib", "tpu_sgd")), dtype=str)
    np.savez(os.path.join(tmp, f"out{rank}.npz"), **out)
    par.mesh.barrier(mesh, CPU)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])

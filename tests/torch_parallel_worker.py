"""One rank of the gloo world of ``tests/test_torch_parallel.py``.

    python tests/torch_parallel_worker.py RANK WORLD PORT DIR

Reads ``DIR/inputs.npz`` (global datasets and the JAX package's per-shard
samples, written by the test), trains each case data-parallel on this
rank's rows through ``tpu_sgd_torch`` on the CPU, and writes
``DIR/out<RANK>.npz``.  Imports the port only: neither JAX nor the JAX
package.
"""

import os
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = "cpu"


class Injected:
    """A sample stream replaying given draws (iteration ``i`` -> row
    ``i - 1``), in place of the port's sampler."""

    def __init__(self, draws):
        self.draws = draws
        self.i = 1
        self.gen = None

    def seek(self, i):
        self.i = int(i)

    def draw(self):
        d = self.draws[self.i - 1]
        self.i += 1
        if d.ndim == 0:  # a window start
            return torch.tensor([int(d)])
        return torch.as_tensor(d.astype(np.int64) if d.dtype != bool else d)


def inject(tgd, draws):
    """Patch the optimizer's sampler factory to replay ``draws`` (None at
    full batch, as the real factory); returns the undo."""
    real = tgd._make_sampler

    def fake(cfg, X, shard=None):
        return None if cfg.mini_batch_fraction >= 1.0 else Injected(draws)

    tgd._make_sampler = fake
    return lambda: setattr(tgd, "_make_sampler", real)


def csr(inp, prefix):
    return torch.sparse_csr_tensor(
        torch.as_tensor(inp[prefix + "crow"]),
        torch.as_tensor(inp[prefix + "col"]),
        torch.as_tensor(inp[prefix + "val"]),
        size=tuple(int(v) for v in inp[prefix + "shape"]))


def main(rank, world, port, tmp):
    torch.set_num_threads(1)
    sys.path.insert(0, ROOT)
    import tpu_sgd_torch as tst
    from tpu_sgd_torch import parallel as par
    from tpu_sgd_torch.optimize import gradient_descent as tgd
    from tpu_sgd_torch.reliability.supervisor import TrainingPreempted
    from tpu_sgd_torch.utils import CollectingListener
    from tpu_sgd_torch.utils.checkpoint import CheckpointManager

    par.initialize_distributed(f"tcp://127.0.0.1:{port}", world, rank,
                               backend="gloo")
    par.initialize_distributed()  # idempotent: a second call is a no-op
    mesh = par.data_mesh()
    inp = np.load(os.path.join(tmp, "inputs.npz"))
    out = {"rank": np.array([par.process_index(), par.process_count(),
                             mesh.rank, mesh.size])}

    def local(name):
        return par.local_rows(inp[name + "_X"], inp[name + "_y"], rank, world)

    def local2d(name, m):  # a 2-D mesh's rank passes its data block's rows
        return par.local_rows(inp[name + "_X"], inp[name + "_y"], m.rank,
                              m.size)

    def gd(gradient=None, updater=None, **knobs):
        o = tst.GradientDescent(gradient, updater, device=CPU)
        o.set_convergence_tol(0.0).set_mesh(mesh)
        for k, v in knobs.items():
            getattr(o, "set_" + k)(v)
        return o

    # full batch through dp_optimize, even and uneven n
    for name, iters in (("ls", 40), ("uneven", 25)):
        Xl, yl = local(name)
        cfg = tst.SGDConfig(step_size=0.3, num_iterations=iters,
                            convergence_tol=0.0)
        w, h, n = par.dp_optimize(tst.LeastSquaresGradient(),
                                  tst.SimpleUpdater(), cfg, mesh,
                                  np.zeros(Xl.shape[1], np.float32), Xl, yl,
                                  device=CPU)
        out[name + "_w"], out[name + "_h"] = w.numpy(), h[:int(n)].numpy()

    # where shard_dataset puts the rows
    Xs, ys, valid = par.shard_dataset(mesh, *local("uneven"), device=CPU)
    out["place_X"], out["place_y"] = Xs.numpy(), ys.numpy()
    out["place_valid"] = valid.numpy()
    out["aligned_valid_none"] = np.array(
        par.shard_dataset(mesh, *local("ls"), device=CPU)[2] is None)

    # the JAX package's per-shard samples injected
    for samp in ("bernoulli", "indexed", "sliced"):
        undo = inject(tgd, inp["inj_" + samp][:, rank])
        try:
            w, h = gd(step_size=0.5, num_iterations=30,
                      mini_batch_fraction=0.2, sampling=samp) \
                .optimize_with_history(local("inj"), np.zeros(8, np.float32))
        finally:
            undo()
        out["inj_%s_w" % samp], out["inj_%s_h" % samp] = w.numpy(), h

    # the port's own shard streams, whole runs
    for samp in ("bernoulli", "indexed", "sliced"):
        w, h = gd(step_size=0.5, num_iterations=200, mini_batch_fraction=0.1,
                  sampling=samp).optimize_with_history(
            local("smp"), np.zeros(10, np.float32))
        out["smp_%s_w" % samp] = w.numpy()

    # train(..., mesh=) and the 2-D mesh
    model = tst.LogisticRegressionWithSGD.train(
        local("log"), 50, 1.0, 1.0, reg_param=0.01, mesh=mesh, device=CPU)
    out["train_w"] = model.weights.numpy()
    m2 = par.make_mesh(n_data=4, n_model=2)
    out["mesh2d_shape"] = np.array([m2.shape["data"], m2.shape["model"]])
    out["config2d_shape"] = np.array(list(
        tst.MeshConfig(data=4, model=2).build().shape.values()))
    Xl, yl = local2d("ls", m2)
    out["mesh2d_w"] = tst.GradientDescent(device=CPU).set_mesh(m2).optimize(
        (Xl, yl), np.zeros(12, np.float32)).numpy()
    try:
        tst.GradientDescent(device=CPU).set_mesh(m2).optimize(
            (torch.as_tensor(Xl).to_sparse_csr(), yl),
            np.zeros(12, np.float32))
        out["mesh2d_raises"] = np.array("")
    except NotImplementedError as e:
        out["mesh2d_raises"] = np.array(str(e))

    # sparse hinge + L1, full batch and the JAX package's masks at 0.5
    Xsp = csr(inp, "sp_")
    Xl, yl = par.local_rows(Xsp, inp["sp_y"], rank, world)
    for frac in (1.0, 0.5):
        undo = inject(tgd, inp["sp_draws"][:, rank])
        try:
            w, h = gd(tst.HingeGradient(), tst.L1Updater(), step_size=1.0,
                      reg_param=0.01, num_iterations=20,
                      mini_batch_fraction=frac, seed=7) \
                .optimize_with_history((Xl, yl), np.zeros(80, np.float32))
        finally:
            undo()
        out["sp_%s_w" % frac], out["sp_%s_h" % frac] = w.numpy(), h

    # multinomial (matrix weights through the same combine)
    w, h = gd(tst.MultinomialLogisticGradient(3), step_size=0.5,
              num_iterations=30).optimize_with_history(
        local("mc"), np.zeros(12, np.float32))
    out["mc_w"], out["mc_h"] = w.numpy(), h

    # the observed driver: listener, superstep, checkpoint, stop, resume
    undo = inject(tgd, inp["obs_draws"][:, rank])
    try:
        observed(out, inp, tmp, (rank, world), local, gd, tst,
                 CollectingListener, CheckpointManager, TrainingPreempted)
    finally:
        undo()

    # the port's own streams, against a one-process rank-order sum
    for samp in ("bernoulli", "sliced"):
        w, h = gd(step_size=0.3, num_iterations=12, mini_batch_fraction=0.3,
                  sampling=samp).optimize_with_history(
            local("uneven"), np.zeros(5, np.float32))
        out["ro_%s_w" % samp], out["ro_%s_h" % samp] = w.numpy(), h

    # a K-step superstep equals K single steps, bitwise
    Xs, ys, valid = par.shard_dataset(mesh, *local("uneven"), device=CPU)
    cfg = tst.SGDConfig(step_size=0.3, num_iterations=8,
                        mini_batch_fraction=0.3, convergence_tol=0.0)
    g, u = tst.LeastSquaresGradient(), tst.SimpleUpdater()
    w = torch.zeros(5)
    sw, ys4 = par.data_parallel.dp_shared_superstep_fn(g, u, cfg, 4, mesh)(
        w, 0.0, 3, Xs, ys, valid)
    step = par.data_parallel.dp_step_fn(g, u, cfg, mesh)
    reg = torch.zeros(())
    losses = []
    for i in range(3, 7):
        w, loss, reg, _ = step(w, Xs, ys, i, reg, valid)
        losses.append(float(loss))
    out["superstep_equals_steps"] = np.array(
        torch.equal(sw, w) and np.array_equal(
            ys4[1], np.asarray(losses, np.float32)))

    out["leaked"] = np.array(sorted(
        m for m in sys.modules
        if m.split(".")[0] in ("jax", "jaxlib", "tpu_sgd")), dtype=str)
    np.savez(os.path.join(tmp, f"out{rank}.npz"), **out)
    par.mesh.barrier(mesh, CPU)
    torch.distributed.destroy_process_group()


def observed(out, inp, tmp, ranks, local, gd, tst, Listener, Manager,
             Preempted):
    rank, world = ranks
    data = local("obs")
    w0 = np.zeros(8, np.float32)

    def opt(k=1, iters=20):
        return gd(tst.LeastSquaresGradient(), tst.SquaredL2Updater(),
                  step_size=0.2, reg_param=0.01, num_iterations=iters,
                  mini_batch_fraction=0.5, superstep=k)

    w, h = opt().optimize_with_history(data, w0)
    out["obs_plain_w"], out["obs_plain_h"] = w.numpy(), h
    for k in (1, 4):
        lis = Listener()
        mgr = Manager(os.path.join(tmp, f"ckpt_k{k}"), keep=100)
        w, h = opt(k).set_listener(lis).set_checkpoint(mgr, every=5) \
            .optimize_with_history(data, w0)
        out[f"obs_k{k}_w"], out[f"obs_k{k}_h"] = w.numpy(), h
        out[f"obs_k{k}_events"] = np.array(
            [e.iteration for e in lis.iterations])
        out[f"obs_k{k}_saved"] = np.array(sorted(
            int(f[5:13]) for f in os.listdir(mgr.directory)
            if f.startswith("ckpt_") and f.endswith(".npz")))

        # a stop at the block boundary after iteration 7, then the resume
        class StopAfter:
            def __init__(self):
                self.polls = 0

            def __call__(self):
                self.polls += 1
                return self.polls * k >= 7

        stop_dir = os.path.join(tmp, f"stop_k{k}")
        o = opt(k).set_checkpoint(Manager(stop_dir), every=100)
        o.set_stop_signal(StopAfter())
        try:
            o.optimize_with_history(data, w0)
            out[f"obs_k{k}_stopped_at"] = np.array(-1)
        except Preempted as e:
            out[f"obs_k{k}_stopped_at"] = np.array(e.iteration)
        o.set_stop_signal(None)
        w, h = o.optimize_with_history(data, w0)
        out[f"obs_k{k}_resumed_w"], out[f"obs_k{k}_resumed_h"] = w.numpy(), h

        # the same stop raised by the last rank alone (the others install
        # no signal), with rank 0's checkpoint writes slowed
        class SlowSave(Manager):
            def save(self, *args, **kwargs):
                time.sleep(0.2)
                return super().save(*args, **kwargs)

        one_dir = os.path.join(tmp, f"one_stop_k{k}")
        o = opt(k).set_checkpoint(
            (SlowSave if rank == 0 else Manager)(one_dir), every=5)
        o.set_stop_signal(StopAfter() if rank == world - 1 else None)
        try:
            o.optimize_with_history(data, w0)
            out[f"one_k{k}_stopped_at"] = np.array(-1)
        except Preempted as e:
            out[f"one_k{k}_stopped_at"] = np.array(e.iteration)
        out[f"one_k{k}_saved"] = np.array(sorted(
            int(f[5:13]) for f in os.listdir(one_dir)
            if f.startswith("ckpt_") and f.endswith(".npz")))
        o.set_stop_signal(None)
        w, h = o.optimize_with_history(data, w0)
        out[f"one_k{k}_resumed_w"], out[f"one_k{k}_resumed_h"] = w.numpy(), h

    # resume the JAX package's meshed checkpoint at 10, and leave one
    for k in (1, 4):
        w, h = opt(k).set_checkpoint(Manager(os.path.join(
            tmp, f"ckpt_jax_k{k}")), every=5).optimize_with_history(data, w0)
        out[f"from_jax_k{k}_w"], out[f"from_jax_k{k}_h"] = w.numpy(), h
    opt(1, iters=10).set_checkpoint(Manager(os.path.join(
        tmp, "ckpt_port")), every=5).optimize_with_history(data, w0)


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])

"""One rank of the gloo world of ``tests/test_torch_mesh_qn.py``.

    python tests/torch_mesh_qn_worker.py RANK WORLD PORT DIR

Reads ``DIR/inputs.npz`` (global datasets, written by the test), runs
L-BFGS, OWL-QN and the normal equations data-parallel on this rank's rows
through ``tpu_sgd_torch`` on the CPU, dense, sparse and multinomial, with
and without the meshed sufficient statistics, and writes
``DIR/out<RANK>.npz``.  Imports the port only: neither JAX nor the JAX
package.
"""

import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = "cpu"


def main(rank, world, port, tmp):
    torch.set_num_threads(1)
    sys.path.insert(0, ROOT)
    import tpu_sgd_torch as tst
    from tpu_sgd_torch import parallel as par
    from tpu_sgd_torch.optimize.lbfgs import agree_on_host

    par.initialize_distributed(f"tcp://127.0.0.1:{port}", world, rank,
                               backend="gloo")
    mesh = par.data_mesh()
    inp = np.load(os.path.join(tmp, "inputs.npz"))
    out = {"rank": np.array([mesh.rank, mesh.size])}

    def local(name):
        X = inp[name + "_X"] if name + "_X" in inp else csr(name)
        return par.local_rows(X, inp[name + "_y"], rank, world)

    def csr(name):
        return torch.sparse_csr_tensor(
            torch.as_tensor(inp[name + "_crow"]),
            torch.as_tensor(inp[name + "_col"]),
            torch.as_tensor(inp[name + "_val"]),
            size=tuple(int(v) for v in inp[name + "_shape"]))

    def run(key, opt, name, d):
        w, h = opt.set_mesh(mesh).optimize_with_history(
            local(name), np.zeros(d, np.float32))
        out[key + "_w"], out[key + "_h"] = w.numpy(), h

    # L-BFGS: even and padded rank rows (test_lbfgs.py:72)
    for n in (4000, 4001):
        run(f"lb{n}", tst.LBFGS(tst.LogisticGradient(),
                                tst.SquaredL2Updater(), reg_param=0.01,
                                device=CPU), f"lb{n}", 8)
    # multinomial (test_lbfgs.py:101)
    run("lbmc", tst.LBFGS(tst.MultinomialLogisticGradient(3),
                          tst.SquaredL2Updater(), reg_param=0.001,
                          max_num_iterations=30, device=CPU), "lbmc", 12)
    # the meshed statistics substitution (test_lbfgs.py:153, :217)
    for n in (4096, 4100):
        opt = tst.LBFGS(tst.LeastSquaresGradient(), tst.SimpleUpdater(),
                        max_num_iterations=12, convergence_tol=0.0,
                        device=CPU).set_sufficient_stats(True) \
            .set_gram_options(block_rows=256)
        run(f"lbgs{n}", opt, f"lbgs{n}", 10)
        out[f"lbgs{n}_n"] = np.array(opt._gram_entry[2].data.shape[0])
    run("owgs", tst.OWLQN(tst.LeastSquaresGradient(), max_num_iterations=10,
                          convergence_tol=0.0, reg_param=0.002, device=CPU)
        .set_sufficient_stats(True), "owgs", 8)
    # OWL-QN (test_owlqn.py:99)
    for n in (3000, 3001):
        run(f"ow{n}", tst.OWLQN(tst.LeastSquaresGradient(), reg_param=0.05,
                                device=CPU), f"ow{n}", 10)
    # sparse (test_sparse.py:262, :276, :576)
    run("splb", tst.LBFGS(tst.LeastSquaresGradient(), max_num_iterations=25,
                          device=CPU), "splb", 80)
    run("spow", tst.OWLQN(tst.LogisticGradient(), reg_param=0.01,
                          max_num_iterations=30, device=CPU), "spow", 40)
    run("spmc", tst.LBFGS(tst.MultinomialLogisticGradient(3),
                          max_num_iterations=20, device=CPU), "spmc", 48)
    # the normal equations (test_normal.py:38)
    w = tst.NormalEquations(device=CPU).set_mesh(mesh).optimize(
        local("ne"), np.zeros(10, np.float32))
    out["ne_w"] = w.numpy()
    # train(..., mesh=) for the L-BFGS and normal-equation families
    out["tr_log_w"] = tst.LogisticRegressionWithLBFGS.train(
        local("lb4001"), reg_param=0.01, intercept=True, mesh=mesh,
        device=CPU).weights.numpy()
    out["tr_lin_w"] = tst.LinearRegressionWithLBFGS.train(
        local("lbgs4100"), max_num_iterations=12, mesh=mesh,
        sufficient_stats=True, device=CPU).weights.numpy()
    model = tst.LinearRegressionWithNormal.train(
        local("ne"), intercept=True, mesh=mesh, device=CPU)
    out["tr_ne_w"] = model.weights.numpy()
    out["tr_ne_b"] = np.array(model.intercept)
    # the host decisions must agree: a rank that disagrees stops them all
    try:
        agree_on_host(mesh, (float(rank == 3),), CPU)
        out["disagree"] = np.array("")
    except RuntimeError as e:
        out["disagree"] = np.array(str(e))
    agree_on_host(mesh, (1.5, float("nan")), CPU)

    out["leaked"] = np.array(sorted(
        m for m in sys.modules
        if m.split(".")[0] in ("jax", "jaxlib", "tpu_sgd")), dtype=str)
    np.savez(os.path.join(tmp, f"out{rank}.npz"), **out)
    par.mesh.barrier(mesh, CPU)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])

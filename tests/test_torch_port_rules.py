"""Rules of the PyTorch port, checked on a machine without a card:
``tpu_sgd_torch`` imports neither JAX nor the JAX package; entry points
run on CUDA unless asked for the CPU, and raise without it; nothing is
compiled at import; the CPU path launches no kernel; ``chip_smoke.py``
fails without a card and outside the repository."""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import tpu_sgd_torch as tst
from tpu_sgd_torch.ops import cuda_kernels as ck

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _python(code, cwd=ROOT):
    env = dict(os.environ, PYTHONPATH=ROOT)
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_import_pulls_in_no_jax_and_no_tpu_sgd():
    """A fresh process: this one has already imported JAX."""
    out = _python(
        "import sys, tpu_sgd_torch, tpu_sgd_torch.ops.cuda_kernels, "
        "tpu_sgd_torch.ops._build, tpu_sgd_torch.interop, "
        "tpu_sgd_torch.ops.sparse, tpu_sgd_torch.linalg, "
        "tpu_sgd_torch.models.streaming, tpu_sgd_torch.utils.mlutils, "
        "tpu_sgd_torch.optimize.lbfgs, tpu_sgd_torch.optimize.owlqn, "
        "tpu_sgd_torch.optimize.normal, tpu_sgd_torch.optimize.oracle, "
        "tpu_sgd_torch.evaluation, tpu_sgd_torch.feature, "
        "tpu_sgd_torch.stat, tpu_sgd_torch.utils.persistence, "
        "tpu_sgd_torch.ops.gram, tpu_sgd_torch.optimize.gram_driver, "
        "tpu_sgd_torch.optimize.resident_driver, tpu_sgd_torch.obs.spans, "
        "tpu_sgd_torch.obs.counters, tpu_sgd_torch.io.integrity, "
        "tpu_sgd_torch.reliability, tpu_sgd_torch.reliability.failpoints, "
        "tpu_sgd_torch.reliability.retry, "
        "tpu_sgd_torch.reliability.supervisor, tpu_sgd_torch.utils, "
        "tpu_sgd_torch.utils.events, tpu_sgd_torch.utils.checkpoint, "
        "tpu_sgd_torch.io, tpu_sgd_torch.io.wire, "
        "tpu_sgd_torch.io.chunking, tpu_sgd_torch.io.prefetch, "
        "tpu_sgd_torch.io.sparse_wire, tpu_sgd_torch.optimize.streamed, "
        "tpu_sgd_torch.optimize.streamed_sparse, "
        "tpu_sgd_torch.optimize.streamed_costfun, "
        "tpu_sgd_torch.utils.native, tpu_sgd_torch.parallel, "
        "tpu_sgd_torch.parallel.mesh, tpu_sgd_torch.parallel.distributed, "
        "tpu_sgd_torch.parallel.data_parallel, "
        "tpu_sgd_torch.parallel.sparse_parallel\n"
        "bad = sorted(m for m in sys.modules "
        "if m.split('.')[0] in ('jax', 'jaxlib', 'tpu_sgd'))\n"
        "print(bad)")
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_import_builds_nothing():
    """Importing every module starts no compiler (nvcc, or the C++
    compiler of the native LIBSVM parser) and loads no library."""
    out = _python(
        "import subprocess\n"
        "def refuse(*a, **k): raise AssertionError('started %r' % (a,))\n"
        "subprocess.Popen = refuse\n"
        "import tpu_sgd_torch\n"
        "from tpu_sgd_torch.ops import _build, cuda_kernels, sparse\n"
        "from tpu_sgd_torch.models import streaming\n"
        "from tpu_sgd_torch.optimize import lbfgs, owlqn, normal, oracle\n"
        "from tpu_sgd_torch.optimize import gram_driver\n"
        "from tpu_sgd_torch.ops import gram\n"
        "from tpu_sgd_torch import evaluation, feature, stat\n"
        "from tpu_sgd_torch.utils import persistence\n"
        "from tpu_sgd_torch.optimize import resident_driver\n"
        "from tpu_sgd_torch.obs import spans, counters\n"
        "from tpu_sgd_torch.io import integrity\n"
        "from tpu_sgd_torch.reliability import failpoints, retry, supervisor\n"
        "from tpu_sgd_torch.utils import events, checkpoint\n"
        "from tpu_sgd_torch.io import wire, chunking, prefetch, sparse_wire\n"
        "from tpu_sgd_torch.optimize import streamed, streamed_sparse\n"
        "from tpu_sgd_torch.optimize import streamed_costfun\n"
        "from tpu_sgd_torch.utils import mlutils, native\n"
        "from tpu_sgd_torch.parallel import mesh, distributed\n"
        "from tpu_sgd_torch.parallel import data_parallel, sparse_parallel\n"
        "print(len(_build._loaded), native._lib, mlutils.last_reader)")
    assert out.returncode == 0, out.stderr
    # no CUDA library loaded, the LIBSVM parser neither loaded nor built
    # (a build would have started the compiler), no file read
    assert out.stdout.strip() == "0 None None"


def test_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the rule is for hosts "
                    "without one")
    X, y, _ = tst.linear_data(20, 3, seed=0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tst.resolve_device(None)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tst.LinearRegressionWithSGD.train((X, y), 5)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tst.GradientDescent().optimize((X, y), np.zeros(3))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tst.glm_model_from_numpy(tst.LinearRegressionModel, np.zeros(3), 0.0)
    assert tst.resolve_device("cpu") == torch.device("cpu")


@pytest.mark.parametrize("make", [
    lambda: tst.LBFGS(), lambda: tst.OWLQN(), lambda: tst.NormalEquations()])
def test_quasi_newton_and_normal_raise_without_cuda(make):
    """The solvers' default device is the card, as every entry point's."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the rule is for hosts "
                    "without one")
    X, y, _ = tst.linear_data(20, 3, seed=0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make().optimize((X, y), np.zeros(3, np.float32))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tst.LogisticRegressionWithLBFGS.train((X, (y > 0).astype(
            np.float32)))


def test_cpu_path_launches_no_kernel():
    ck.reset_launch_counts()
    X, y, _ = tst.linear_data(400, 4, seed=1)
    for sampling in ("bernoulli", "sliced", "indexed"):
        tst.LinearRegressionWithSGD.train((X, y), 5, 0.5, 0.2,
                                          sampling=sampling, device="cpu")
    opt = tst.GradientDescent(
        ck.FusedGradient(tst.LeastSquaresGradient(), tile_m=40,
                         window_kernel="vpu"), device="cpu")
    opt.set_sampling("sliced").set_mini_batch_fraction(0.2)
    opt.set_num_iterations(5).optimize((X, y), np.zeros(4))
    tst.LinearRegressionWithSGD.train((X, y), 5, 0.5, 0.2, sampling="sliced",
                                      sufficient_stats=True, device="cpu")
    tst.GradientDescent(tst.ChunkedGradient(tst.LeastSquaresGradient(), 16),
                        device="cpu").set_sampling("sliced") \
        .set_mini_batch_fraction(0.2).set_num_iterations(3) \
        .optimize((X, y), np.zeros(4))
    assert ck.launch_counts() == {"fused_gradient_sums": 0,
                                  "fused_window_sums": 0,
                                  "fused_window_sums_vpu": 0}


def test_cpu_streamed_and_sparse_paths_launch_no_kernel():
    ck.reset_launch_counts()
    X, y, _ = tst.linear_data(400, 4, seed=1)
    for sampling in ("bernoulli", "sliced", "indexed"):
        tst.GradientDescent(device="cpu").set_host_streaming(True) \
            .set_sampling(sampling).set_mini_batch_fraction(0.2) \
            .set_num_iterations(4).set_superstep(2) \
            .optimize((X, y), np.zeros(4))
    Xs, ys, _ = tst.sparse_data(60, 30, nnz_per_row=4, kind="svm", seed=2)
    for streamed in (False, True):
        tst.GradientDescent(tst.HingeGradient(), device="cpu") \
            .set_host_streaming(streamed).set_mini_batch_fraction(0.5) \
            .set_num_iterations(3).optimize((Xs, ys), np.zeros(30))
    assert ck.launch_counts() == {"fused_gradient_sums": 0,
                                  "fused_window_sums": 0,
                                  "fused_window_sums_vpu": 0}
    assert ck.csr_launch_counts() == {"csr_margins": 0, "csr_grad_sum": 0}
    assert ck.kernel_launch_counts() == {"fused_sums": 0, "window_sums": 0}


def test_every_kernel_source_is_built_and_none_at_import():
    from tpu_sgd_torch.ops import _build

    assert _build.SOURCES == ("fused_sums", "window_sums", "csr_products")
    for name in _build.SOURCES:
        assert (_build.CSRC / f"{name}.cu").exists()
    src = (_build.CSRC / "csr_products.cu").read_text()
    assert "atomicAdd" not in src  # the CSR kernel adds in a fixed order


def test_streamed_path_on_a_mesh_raises_naming_a5():
    from tpu_sgd_torch.optimize.streamed import optimize_host_streamed

    X, y, _ = tst.linear_data(20, 3, seed=0)
    with pytest.raises(NotImplementedError, match="A5"):
        optimize_host_streamed(tst.LeastSquaresGradient(),
                               tst.SimpleUpdater(), tst.SGDConfig(), X, y,
                               np.zeros(3), device="cpu", mesh=object())
    from tpu_sgd_torch.parallel import DATA_AXIS, Mesh

    with pytest.raises(NotImplementedError, match="A5"):
        tst.GradientDescent(device="cpu").set_host_streaming(True) \
            .set_mesh(Mesh({DATA_AXIS: 2})).optimize((X, y), np.zeros(3))


def test_streamed_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the rule is for hosts "
                    "without one")
    X, y, _ = tst.linear_data(20, 3, seed=0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tst.GradientDescent().set_host_streaming(True).optimize(
            (X, y), np.zeros(3))


def test_chip_smoke_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_chip_smoke_fails_outside_the_repository(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300,
                         env={k: v for k, v in os.environ.items()
                              if k != "PYTHONPATH"})
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


_SERVING_MODULES = (
    "tpu_sgd_torch.serve", "tpu_sgd_torch.serve.batcher",
    "tpu_sgd_torch.serve.engine", "tpu_sgd_torch.serve.metrics",
    "tpu_sgd_torch.serve.registry", "tpu_sgd_torch.tenant",
    "tpu_sgd_torch.tenant.engine", "tpu_sgd_torch.tenant.serve",
    "tpu_sgd_torch.tenant.slab", "tpu_sgd_torch.tenant.store",
    "tpu_sgd_torch.ops.bucketed", "tpu_sgd_torch.obs.timeseries",
    "tpu_sgd_torch.reliability.health")


def test_serving_imports_pull_in_no_jax_and_build_nothing():
    """A fresh process imports the serving and tenant planes: no JAX, no
    JAX package, no compiler started, no library loaded, no thread."""
    out = _python(
        "import subprocess, sys, threading\n"
        "def refuse(*a, **k): raise AssertionError('started %r' % (a,))\n"
        "subprocess.Popen = refuse\n"
        f"import importlib\nfor m in {_SERVING_MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "from tpu_sgd_torch.ops import _build\n"
        "bad = sorted(m for m in sys.modules "
        "if m.split('.')[0] in ('jax', 'jaxlib', 'tpu_sgd'))\n"
        "print(bad, len(_build._loaded), threading.active_count())")
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[] 0 1"


def test_serving_entry_points_raise_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the rule is for hosts "
                    "without one")
    from tpu_sgd_torch.serve import ModelRegistry, PredictEngine, Server
    from tpu_sgd_torch.tenant import TenantModelStore, WeightSlab

    model = tst.LinearRegressionModel(np.zeros(3), 0.0, device="cpu")
    for make in (lambda: PredictEngine(),
                 lambda: Server(model),
                 lambda: ModelRegistry(str(tmp_path), tst.
                                       LinearRegressionModel),
                 lambda: TenantModelStore(str(tmp_path / "t"), capacity=2,
                                          d=3),
                 lambda: WeightSlab(2, 3)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
    # a model elsewhere than the engine's device is refused, never moved
    with pytest.raises(ValueError, match="serves on"):
        Server(model, device="meta")


def test_cpu_serving_launches_no_kernel(tmp_path):
    from tpu_sgd_torch.serve import PredictEngine, Server
    from tpu_sgd_torch.tenant import TenantModelStore, TenantPredictEngine

    ck.reset_launch_counts()
    rng = np.random.default_rng(0)
    d = 8
    model = tst.LogisticRegressionModel(rng.normal(size=d), 0.1,
                                        device="cpu")
    X = rng.normal(size=(20, d)).astype(np.float32)
    Xs = torch.from_numpy(np.where(X > 1.0, X, 0.0)).to_sparse_csr()
    engine = PredictEngine(device="cpu")
    engine.predict_batch(model, X)
    engine.predict_batch(model, Xs)
    with Server(model, max_latency_s=0.002, device="cpu") as server:
        server.predict(X[0], timeout=30)
    store = TenantModelStore(str(tmp_path), capacity=2, d=d, device="cpu")
    for t in range(3):
        store.publish(t, rng.normal(size=d))
    TenantPredictEngine(store).predict_batch([0, 1, 0], X[:3])
    assert ck.launch_counts() == {"fused_gradient_sums": 0,
                                  "fused_window_sums": 0,
                                  "fused_window_sums_vpu": 0}
    assert ck.csr_launch_counts() == {"csr_margins": 0, "csr_grad_sum": 0}
    assert ck.kernel_launch_counts() == {"fused_sums": 0, "window_sums": 0}

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
        "tpu_sgd_torch.parallel.sparse_parallel, tpu_sgd_torch.plan\n"
        "bad = sorted(m for m in sys.modules "
        "if m.split('.')[0] in ('jax', 'jaxlib', 'tpu_sgd'))\n"
        "print(bad)")
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_the_meshed_modules_import_no_jax_and_build_nothing():
    """``parallel.model_parallel`` and ``parallel.gram_parallel`` (the 2-D
    mesh and the meshed statistics): a fresh process imports them without
    JAX or the JAX package, starting no compiler and loading no kernel
    library."""
    out = _python(
        "import subprocess, sys\n"
        "def refuse(*a, **k): raise AssertionError('started %r' % (a,))\n"
        "subprocess.Popen = refuse\n"
        "from tpu_sgd_torch.parallel import model_parallel, gram_parallel\n"
        "from tpu_sgd_torch.ops import _build\n"
        "bad = sorted(m for m in sys.modules "
        "if m.split('.')[0] in ('jax', 'jaxlib', 'tpu_sgd'))\n"
        "print(bad, len(_build._loaded))")
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[] 0"


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


def test_planner_budget_raises_without_cuda():
    """The planner budgets the card: ``device_budget()``, ``plan()``
    without ``free_hbm`` and the models' zero-flag planning raise without
    one, and never budget the CPU in its place; ``device="cpu"`` is the
    cost model's fallback."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the rule is for hosts "
                    "without one")
    from tpu_sgd_torch import plan as tplan

    with pytest.raises(RuntimeError, match="device='cpu'"):
        tplan.device_budget()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tplan.plan(1000, 10)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tst.LogisticRegressionWithLBFGS.train(
            (np.zeros((4, 2), np.float32), np.zeros(4, np.float32)))
    assert tplan.device_budget("cpu") == (
        tplan.DEFAULT_COST_MODEL.hbm_bytes
        * tplan.DEFAULT_COST_MODEL.hbm_safety, "fallback")
    assert tplan.plan(1000, 10, free_hbm=1e9).estimates[
        "budget_source"] == "caller"


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


#: the modules of the streamed routes on a mesh (ROADMAP A5's last part)
_STREAMED_MESH_MODULES = (
    "parallel/mesh.py", "parallel/data_parallel.py",
    "parallel/gram_parallel.py", "parallel/__init__.py",
    "optimize/streamed.py", "optimize/streamed_costfun.py",
    "optimize/gradient_descent.py", "optimize/lbfgs.py",
    "optimize/owlqn.py", "optimize/normal.py", "io/sparse_wire.py")


def test_streamed_path_on_a_mesh_raises_naming_a5():
    """No A5 raise is left: no module of the streamed routes names ROADMAP
    A5 or calls ``_not_ported``; ``mesh=`` takes a ``Mesh`` (a
    ``TypeError`` otherwise), and a mesh declared over two hosts raises
    the JAX package's single-host message before any collective."""
    from tpu_sgd_torch.optimize.streamed import optimize_host_streamed
    from tpu_sgd_torch.parallel import DATA_AXIS, Mesh

    pkg = os.path.join(ROOT, "tpu_sgd_torch")
    for rel in _STREAMED_MESH_MODULES:
        with open(os.path.join(pkg, rel)) as f:
            src = f.read()
        assert "A5" not in src and "_not_ported(" not in src, rel
    X, y, _ = tst.linear_data(20, 3, seed=0)
    with pytest.raises(TypeError, match="Mesh"):
        optimize_host_streamed(tst.LeastSquaresGradient(),
                               tst.SimpleUpdater(), tst.SGDConfig(), X, y,
                               np.zeros(3), device="cpu", mesh=object())
    split = Mesh({DATA_AXIS: 2}, hosts=("a", "b"))
    with pytest.raises(NotImplementedError, match="build single-host"):
        tst.GradientDescent(device="cpu").set_host_streaming(True) \
            .set_mesh(split).optimize((X, y), np.zeros(3))
    with pytest.raises(NotImplementedError, match="build single-host"):
        optimize_host_streamed(tst.LeastSquaresGradient(),
                               tst.SimpleUpdater(), tst.SGDConfig(), X, y,
                               np.zeros(3), device="cpu", mesh=split)


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


# -- the replicas (ROADMAP A11's replica part) ------------------------------------

_REPLICA_MODULES = (
    "tpu_sgd_torch.replica", "tpu_sgd_torch.replica.staleness",
    "tpu_sgd_torch.replica.membership", "tpu_sgd_torch.replica.store",
    "tpu_sgd_torch.replica.worker", "tpu_sgd_torch.replica.ha",
    "tpu_sgd_torch.replica.shard", "tpu_sgd_torch.replica.driver",
    "tpu_sgd_torch.obs", "tpu_sgd_torch.obs.flightrec",
)


def test_replica_imports_pull_in_no_jax_and_build_nothing():
    """A fresh process imports the replica package and the flight
    recorder: no JAX, no JAX package, no compiler, no library, no
    thread."""
    out = _python(
        "import subprocess, sys, threading\n"
        "def refuse(*a, **k): raise AssertionError('started %r' % (a,))\n"
        "subprocess.Popen = refuse\n"
        f"import importlib\nfor m in {_REPLICA_MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "from tpu_sgd_torch.ops import _build\n"
        "bad = sorted(m for m in sys.modules "
        "if m.split('.')[0] in ('jax', 'jaxlib', 'tpu_sgd'))\n"
        "print(bad, len(_build._loaded), threading.active_count())")
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[] 0 1"


def test_no_port_module_imports_jax_or_the_jax_package():
    """Every module of ``tpu_sgd_torch``, read as source: no import of
    ``jax``, ``jaxlib`` or ``tpu_sgd``, at any depth of the file."""
    import ast

    bad = []
    for dirpath, _, files in os.walk(os.path.join(ROOT, "tpu_sgd_torch")):
        for name in files:
            if not name.endswith(".py"):
                continue
            path = os.path.join(dirpath, name)
            with open(path) as f:
                tree = ast.parse(f.read(), path)
            for node in ast.walk(tree):
                if isinstance(node, ast.Import):
                    roots = [a.name.split(".")[0] for a in node.names]
                elif isinstance(node, ast.ImportFrom) and node.level == 0:
                    roots = [(node.module or "").split(".")[0]]
                else:
                    continue
                bad += [(os.path.relpath(path, ROOT), r) for r in roots
                        if r in ("jax", "jaxlib", "tpu_sgd")]
    assert bad == []


def test_every_declared_site_is_called_in_its_module():
    """Each hook site of ``failpoints.HOOK_SITES`` has its
    ``failpoint("<name>")`` call, and each of ``CORRUPT_SITES`` its
    ``corruptpoint("<name>"`` call, in the module the registry names; the
    replica sites are the JAX package's."""
    from tpu_sgd.reliability.failpoints import HOOK_SITES as JAX_SITES
    from tpu_sgd_torch.reliability import failpoints as fp

    for table, call in ((fp.HOOK_SITES, "failpoint"),
                        (fp.CORRUPT_SITES, "corruptpoint")):
        for site, path in table.items():
            assert path.startswith("tpu_sgd_torch/"), (site, path)
            with open(os.path.join(ROOT, path)) as f:
                assert f'{call}("{site}"' in f.read(), (site, path)
    replica = {s for s in JAX_SITES if s.startswith("replica.")}
    assert replica == {s for s in {**fp.HOOK_SITES, **fp.CORRUPT_SITES}
                       if s.startswith("replica.")}
    for site in replica:
        port = {**fp.HOOK_SITES, **fp.CORRUPT_SITES}[site]
        assert port == JAX_SITES[site].replace("tpu_sgd/", "tpu_sgd_torch/")


def test_the_lock_rules_are_clean_on_the_replica_modules():
    """The JAX package's lexical, framework-free lock rules
    (lock-discipline, lock-order, cond-discipline, failpoint-coverage)
    over the whole port: the replica package, the flight recorder, the
    detectors, the facade and every other module."""
    env = dict(os.environ, PYTHONPATH=ROOT, JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, "-m", "tpu_sgd.analysis.lint", "--disable",
         "shape-trap,donation-safety,eager-in-loop,host-sync,"
         "callback-discipline,carry-stability,memo-key,obs-discipline,"
         "contract-drift", "tpu_sgd_torch"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    said = out.stdout + out.stderr  # the summary goes to stderr
    assert out.returncode == 0, said
    n_files = sum(f.endswith(".py") for _, _, fs in os.walk(
        os.path.join(ROOT, "tpu_sgd_torch")) for f in fs)
    assert n_files == 85, n_files
    assert "clean" in said and f"{n_files} file(s), 4 rule(s)" in said, said


_OBS_MODULES = (
    "tpu_sgd_torch.obs", "tpu_sgd_torch.obs.counters",
    "tpu_sgd_torch.obs.detect", "tpu_sgd_torch.obs.flightrec",
    "tpu_sgd_torch.obs.report", "tpu_sgd_torch.obs.spans",
    "tpu_sgd_torch.obs.timeseries", "tpu_sgd_torch.obs.watch",
)


def test_obs_imports_pull_in_no_jax_and_build_nothing():
    """A fresh process imports the observability layer and each of its
    modules: no JAX, no JAX package, no compiler, no library, no thread,
    and no counting hook installed."""
    out = _python(
        "import subprocess, sys, threading\n"
        "def refuse(*a, **k): raise AssertionError('started %r' % (a,))\n"
        "subprocess.Popen = refuse\n"
        f"import importlib\nfor m in {_OBS_MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "import torch\n"
        "from tpu_sgd_torch.obs import counters\n"
        "from tpu_sgd_torch.ops import _build\n"
        "bad = sorted(m for m in sys.modules "
        "if m.split('.')[0] in ('jax', 'jaxlib', 'tpu_sgd'))\n"
        "hooked = [n for n in counters.SYNC_METHODS "
        "if hasattr(getattr(torch.Tensor, n), '__wrapped__')]\n"
        "print(bad, len(_build._loaded), threading.active_count(), "
        "hooked, counters._PATCHES)")
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[] 0 1 [] None"


@pytest.mark.parametrize("cli", ["report", "watch"])
def test_obs_clis_answer_help_without_a_card(cli):
    out = subprocess.run(
        [sys.executable, "-m", f"tpu_sgd_torch.obs.{cli}", "--help"],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT),
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert f"python -m tpu_sgd_torch.obs.{cli}" in out.stdout
    assert "jax" not in out.stderr.lower()


def test_obs_enable_disable_leaves_every_patched_attribute_as_it_was():
    """``obs.enable()`` hooks ``torch.Tensor``'s read methods and the
    port's funnels; ``obs.disable()`` puts back exactly what was there
    (an inherited method is inherited again, not copied onto the
    class), twice over and with the layer's twins stacked in between."""
    from tpu_sgd_torch import obs
    from tpu_sgd_torch.io.prefetch import PinnedRing
    from tpu_sgd_torch.obs import counters
    from tpu_sgd_torch.ops import _build, bucketed
    from tpu_sgd_torch.optimize import gradient_descent

    owners = {"Tensor": torch.Tensor, "ck": ck, "_build": _build,
              "bucketed": bucketed, "PinnedRing": PinnedRing,
              "gd": gradient_descent}
    names = {"Tensor": counters.SYNC_METHODS, "gd": ("_fetch_rows",),
             "ck": ("count_launch", "add_replayed_launches",
                    "captured_launches"),
             "_build": ("_start",), "bucketed": ("_padded",),
             "PinnedRing": ("send",)}

    def state():
        return {(o, n): (getattr(owners[o], n), n in vars(owners[o]))
                for o in owners for n in names[o]}

    before = state()
    for _ in range(2):
        obs.enable()
        during = state()
        assert all(during[k][0] is not before[k][0] for k in before)
        assert len(counters._PATCHES) == len(before)
        obs.disable()
        after = state()
        assert all(after[k][0] is before[k][0] and after[k][1] == before[k][1]
                   for k in before), [k for k in before
                                      if after[k] != before[k]]
    assert counters._PATCHES is None and not counters.is_enabled()


def test_replica_driver_runs_on_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the rule is for hosts "
                    "without one")
    from tpu_sgd_torch.replica import ParameterStore, ReplicaDriver

    X = np.ones((8, 3), np.float32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ReplicaDriver().optimize_with_history((X, X[:, 0]), np.zeros(3))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ParameterStore(tst.SimpleUpdater(), tst.SGDConfig(), np.zeros(3))
    assert ReplicaDriver(device="cpu").resolved_devices() == [
        torch.device("cpu")]
    assert ReplicaDriver().set_devices(["cpu"]).resolved_devices() == [
        torch.device("cpu")]

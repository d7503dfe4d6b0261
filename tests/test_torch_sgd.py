"""Parity of the port's SGD core (``tpu_sgd_torch.optimize``) with the JAX
package on the CPU.

Tolerances:
  * one step at full batch (the same numpy ``valid`` mask on both sides):
    weights rtol 1e-5, loss and reg rtol 1e-5, count exact;
  * full-batch runs: the same loss-history length and convergence
    iteration (``convergence_tol=3e-3``: every run below converges well
    before its budget, with margin on both sides of the threshold), weights
    rtol 1e-4;
  * sampled runs (frac 0.1): the two packages draw different samples
    (torch.Generator vs jax.random), so only the final full-data objective
    is compared: <= 1.01x JAX's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_sgd.config import SGDConfig as JConfig
from tpu_sgd.ops import gradients as jg
from tpu_sgd.ops import updaters as ju
from tpu_sgd.optimize import gradient_descent as jgd
from tpu_sgd_torch.config import SGDConfig
from tpu_sgd_torch.ops import gradients as tg
from tpu_sgd_torch.ops import updaters as tu
from tpu_sgd_torch.optimize import gradient_descent as tgd
from tpu_sgd_torch.utils.mlutils import linear_data, logistic_data, svm_data

PAIRS = {
    "least_squares-simple": (jg.LeastSquaresGradient, ju.SimpleUpdater,
                             tg.LeastSquaresGradient, tu.SimpleUpdater,
                             linear_data, 0.0),
    "logistic-squared_l2": (jg.LogisticGradient, ju.SquaredL2Updater,
                            tg.LogisticGradient, tu.SquaredL2Updater,
                            logistic_data, 0.01),
    "hinge-l1": (jg.HingeGradient, ju.L1Updater, tg.HingeGradient,
                 tu.L1Updater, svm_data, 0.01),
}


def _optimizers(pair, **cfg):
    JG, JU, TG, TU, _, reg = PAIRS[pair]
    j = jgd.GradientDescent(JG(), JU(), JConfig(reg_param=reg, **cfg))
    t = tgd.GradientDescent(TG(), TU(), SGDConfig(reg_param=reg, **cfg),
                            device="cpu")
    return j, t


@pytest.mark.parametrize("pair", sorted(PAIRS))
def test_make_step_matches_jax(pair):
    JG, JU, TG, TU, gen, reg = PAIRS[pair]
    X, y, _ = gen(500, 12, seed=3)
    valid = np.random.default_rng(4).uniform(size=500) < 0.7
    w = (np.random.default_rng(5).normal(size=12) * 0.3).astype(np.float32)
    cfg = dict(step_size=0.7, reg_param=reg)
    jstep = jgd.make_step(JG(), JU(), JConfig(**cfg))
    tstep = tgd.make_step(TG(), TU(), SGDConfig(**cfg))
    for i in (1, 2, 9):
        jw, jl, jr, jc = jstep(jnp.asarray(w), jnp.asarray(X), jnp.asarray(y),
                               i, jnp.float32(0.25), jnp.asarray(valid))
        tw, tl, tr, tc = tstep(torch.from_numpy(w), torch.from_numpy(X),
                               torch.from_numpy(y), i, torch.tensor(0.25),
                               torch.from_numpy(valid))
        np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
        np.testing.assert_allclose(float(tr), float(jr), rtol=1e-5,
                                   atol=1e-7)
        assert float(tc) == float(jc) == valid.sum()


@pytest.mark.parametrize("pair", sorted(PAIRS))
def test_full_batch_runs_match_jax(pair):
    X, y, _ = PAIRS[pair][4](2000, 10, seed=1)
    j, t = _optimizers(pair, step_size=0.5, num_iterations=300,
                       convergence_tol=3e-3)
    w0 = np.zeros(10, np.float32)
    jw, jh = j.optimize_with_history((X, y), w0)
    tw, th = t.optimize_with_history((X, y), w0)
    assert len(th) == len(jh) < 300  # same convergence iteration
    np.testing.assert_allclose(th, jh, rtol=1e-4)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-4,
                               atol=1e-6)


@pytest.mark.parametrize("sampling", ["bernoulli", "sliced", "indexed"])
def test_sampled_runs_reach_jax_objective(sampling):
    X, y, _ = linear_data(4000, 10, eps=1.0, seed=2)
    j, t = _optimizers("least_squares-simple", step_size=0.5,
                       num_iterations=200, mini_batch_fraction=0.1,
                       sampling=sampling, convergence_tol=0.0)
    w0 = np.zeros(10, np.float32)
    jw = np.asarray(j.optimize((X, y), w0), np.float64)
    tw = t.optimize((X, y), w0).double().numpy()

    def objective(w):
        return 0.5 * np.mean((X @ w - y) ** 2)

    assert np.all(np.isfinite(t.loss_history))
    assert len(t.loss_history) == 200
    assert objective(tw) <= 1.01 * objective(jw)


def test_sampling_depends_only_on_seed_and_iteration():
    X, y, _ = linear_data(1000, 6, seed=6)
    runs = []
    for seed in (7, 7, 8):
        opt = tgd.GradientDescent(device="cpu").set_mini_batch_fraction(0.1)
        opt.set_seed(seed).set_convergence_tol(0.0).set_num_iterations(5)
        runs.append(opt.optimize_with_history((X, y), np.zeros(6))[1])
    np.testing.assert_array_equal(runs[0], runs[1])
    assert not np.array_equal(runs[0], runs[2])


def test_empty_batch_skips_the_update():
    """A sample with no rows records no loss and leaves the weights and
    reg value unchanged, as in the JAX package."""
    X, y, _ = linear_data(50, 4, seed=7)
    step = tgd.make_step(tg.LeastSquaresGradient(), tu.L1Updater(),
                         SGDConfig(reg_param=0.1))
    w = torch.ones(4)
    none = torch.zeros(50, dtype=torch.bool)
    new_w, _, new_reg, c = step(w, torch.from_numpy(X), torch.from_numpy(y),
                                3, torch.tensor(0.4), none)
    assert float(c) == 0.0
    torch.testing.assert_close(new_w, w)
    assert float(new_reg) == pytest.approx(0.4)

    opt = tgd.GradientDescent(device="cpu").set_mini_batch_fraction(0.01)
    opt.set_num_iterations(40).set_convergence_tol(0.0)
    with pytest.warns(RuntimeWarning, match="too small"):
        w, hist = opt.optimize_with_history((X[:20], y[:20]), np.zeros(4))
    assert 0 < len(hist) < 40  # empty samples recorded nothing
    assert np.all(np.isfinite(w.numpy()))


def test_check_numerics_raises_on_divergence():
    X, y, _ = linear_data(200, 5, seed=8)
    opt = tgd.GradientDescent(device="cpu").set_step_size(50.0)
    opt.set_num_iterations(60).set_check_numerics(True)
    with pytest.raises(FloatingPointError, match="non-finite loss"):
        opt.optimize((X * 100, y), np.zeros(5))


def test_wrong_initial_weights_length_raises():
    X, y, _ = linear_data(20, 5, seed=9)
    with pytest.raises(ValueError, match="initial_weights has length 4"):
        tgd.GradientDescent(device="cpu").optimize((X, y), np.zeros(4))


def test_run_mini_batch_sgd_matches_optimizer():
    X, y, _ = linear_data(300, 5, seed=10)
    w, hist = tgd.run_mini_batch_sgd(
        (X, y), tg.LeastSquaresGradient(), tu.SimpleUpdater(), 0.5, 30, 0.0,
        1.0, np.zeros(5, np.float32), device="cpu")
    jw, jhist = jgd.run_mini_batch_sgd(
        (X, y), jg.LeastSquaresGradient(), ju.SimpleUpdater(), 0.5, 30, 0.0,
        1.0, np.zeros(5, np.float32))
    assert len(hist) == len(jhist)
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=1e-4,
                               atol=1e-6)


def test_config_validation_matches_jax():
    for bad in (dict(sampling="strided"), dict(mini_batch_fraction=0.0),
                dict(num_iterations=0), dict(step_size=0.0),
                dict(reg_param=-1.0), dict(convergence_tol=2.0)):
        with pytest.raises(ValueError):
            JConfig(**bad)
        with pytest.raises(ValueError):
            SGDConfig(**bad)
    import dataclasses

    assert dataclasses.asdict(SGDConfig()) == dataclasses.asdict(JConfig())


def _mesh_raises(opt):
    """A 1-D data mesh is taken (meshed SGD runs: ``test_torch_parallel``),
    and so is a 2-D mesh with a sharded 'model' axis (its runs:
    ``test_torch_mesh_resident``); on it host streaming raises at the run
    with the JAX package's message, and what is not a mesh raises at
    once."""
    from tpu_sgd_torch.parallel import DATA_AXIS, MODEL_AXIS, Mesh

    assert opt.set_mesh(Mesh({DATA_AXIS: 1})) is opt
    opt.set_mesh(Mesh({DATA_AXIS: 4, MODEL_AXIS: 2}))
    X, y, _ = linear_data(40, 3, seed=2)
    with pytest.raises(NotImplementedError, match=r"supports 1-D data"):
        opt.set_host_streaming(True).optimize((X, y),
                                              np.zeros(3, np.float32))
    opt.set_host_streaming(False)
    with pytest.raises(TypeError):
        opt.set_mesh(object())


def _streamed_stats_runs(opt, build_rows=None):
    X, y, _ = linear_data(500, 4, eps=0.1, seed=2)
    opt.set_step_size(0.2).set_num_iterations(8)
    assert opt.set_streamed_stats(True, block_rows=32) is opt
    _, hist = opt.optimize_with_history((X, y), np.zeros(4, np.float32))
    assert hist.shape == (8,) and hist[-1] < hist[0]
    assert opt._streamed_gram_entry[3][:2] == (32, build_rows)


def _batch_rows_applies(opt):
    # batch_rows: the streamed build's chunk
    assert opt.set_gram_options(None, None, 64) is opt
    assert opt.gram_batch_rows == 64
    _streamed_stats_runs(opt, build_rows=64)


@pytest.mark.parametrize("case", [
    pytest.param(_mesh_raises, id="set_mesh-args0"),
    pytest.param(_batch_rows_applies, id="set_gram_options-args2"),
    pytest.param(_streamed_stats_runs, id="set_streamed_stats-args3"),
])
def test_later_slice_setters_raise(case):
    """``set_mesh`` takes a data mesh and a 2-D one (host streaming on the
    2-D one raises the JAX package's refusal); the streamed statistics'
    setters apply and run."""
    case(tgd.GradientDescent(device="cpu"))

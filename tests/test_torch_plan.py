"""Twins of ``tests/test_plan.py`` for the port's execution planner
(``tpu_sgd_torch/plan.py``), on the CPU (``device="cpu"``).

Both packages decide under the same constants: the JAX package's
``CostModel()`` fields are passed into the port's ``CostModel`` (the
port's own defaults are the H100's, and differ).  Exact parity: the
schedule and every ``Plan`` field, the reason text (the one parenthetical
tag in the JAX package's compressed-wire note aside) and every
warning; ``estimates`` agree to rtol 1e-12 (host arithmetic only).  A
seeded grid holds ``plan``, ``plan_quasi_newton`` and every ``choose_*``
to the JAX package's; the hook twins drive the port's models end to end.
Whole runs: the same schedule and plan line, weights at the gradient tier
(rtol 2e-4 / atol 2e-3) for full batch, objective within 1.01x for
sampled runs.
"""

import dataclasses
import logging
import math
import re
import warnings

import numpy as np
import pytest
import torch

import tpu_sgd.plan as jplan
import tpu_sgd_torch as tst
import tpu_sgd_torch.plan as tplan
from tpu_sgd_torch.plan import (CostModel, Plan, SCHEDULES,
                                choose_block_rows, device_budget, plan,
                                plan_for)

GB = 1e9
CPU = "cpu"

#: the JAX package's constants in the port's CostModel
JCM = CostModel(**{f.name: getattr(jplan.CostModel(), f.name)
                   for f in dataclasses.fields(jplan.CostModel)
                   if f.name != "calibration_report"})
#: the budget the JAX package probes on this host (its fallback)
JFREE = jplan.device_budget()[0]

_TAG = re.compile(r" \([A-Z]+ \d+\)")


def _same_value(a, b) -> bool:
    if isinstance(a, float) or isinstance(b, float):
        if math.isinf(a) or math.isinf(b):
            return a == b
        return math.isclose(a, b, rel_tol=1e-12, abs_tol=0.0)
    return a == b


def assert_same_plan(t, j):
    """Every Plan field exact, the reason exact (the JAX package's
    parenthetical tag aside), every estimate to rtol 1e-12."""
    assert t.schedule == j.schedule
    assert t.reason == _TAG.sub("", j.reason)
    for f in ("block_rows", "batch_rows", "aligned", "resident_rows",
              "chunk_iters", "wire_dtype", "prefetch_depth", "superstep",
              "residency", "wire_compress", "replicas", "store_shards"):
        assert getattr(t, f) == getattr(j, f), f
    assert set(t.estimates) == set(j.estimates)
    for k, v in j.estimates.items():
        assert _same_value(t.estimates[k], v), (k, t.estimates[k], v)


def _warned(fn):
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        try:
            out = fn()
        except ValueError as e:
            out = e
    return out, [str(r.message) for r in rec]


def both_warned(*args, **kw):
    """``plan`` in both packages under the JAX package's constants:
    ``(the port's plan, its warnings)`` after checking that the plan, the
    warnings and any error are the JAX package's."""
    kw.setdefault("free_hbm", JFREE)
    t, tw = _warned(lambda: plan(*args, cost_model=JCM, **kw))
    j, jw = _warned(lambda: jplan.plan(*args, **kw))
    assert tw == jw
    if isinstance(j, ValueError):
        assert isinstance(t, ValueError) and str(t) == str(j)
        raise t
    assert_same_plan(t, j)
    return t, tw


def both(*args, **kw):
    return both_warned(*args, **kw)[0]


# ---- pure decision boundaries --------------------------------------------

def test_plan_module_attribute_not_shadowed():
    import types

    import tpu_sgd_torch.plan as m

    assert isinstance(tst.plan, types.ModuleType)
    assert isinstance(m, types.ModuleType) and callable(m.plan)
    for name in ("CostModel", "Plan", "device_budget", "plan_for",
                 "plan_quasi_newton"):
        assert getattr(tst, name) is getattr(m, name)


def test_resident_gram_for_big_least_squares_full_batch():
    p = both(3_000_000, 1000, itemsize=2, gram_able=True,
             mini_batch_fraction=1.0, num_iterations=5000, free_hbm=12 * GB)
    assert p.schedule == "resident_gram"
    assert not p.aligned
    assert p.estimates["build_amortize_iters"] < 5000


def test_short_run_amortization_keeps_stock():
    p = both(3_000_000, 1000, itemsize=2, gram_able=True,
             mini_batch_fraction=1.0, num_iterations=50, free_hbm=12 * GB)
    assert p.schedule == "resident_stock"
    assert "amortize" in p.reason


def test_small_problem_keeps_stock():
    p = both(100_000, 100, gram_able=True, num_iterations=100,
             free_hbm=12 * GB)
    assert p.schedule == "resident_stock"


def test_non_least_squares_never_grams():
    p = both(3_000_000, 1000, itemsize=2, gram_able=False,
             num_iterations=10_000, free_hbm=12 * GB)
    assert p.schedule == "resident_stock"


def test_bernoulli_sampling_is_honored():
    p = both(3_000_000, 1000, itemsize=2, gram_able=True,
             sampling="bernoulli", mini_batch_fraction=0.1,
             num_iterations=10_000, free_hbm=12 * GB)
    assert p.schedule == "resident_stock" and "sampling" in p.reason


def test_sliced_sampling_qualifies_gram():
    p = both(3_000_000, 1000, itemsize=2, gram_able=True, sampling="sliced",
             mini_batch_fraction=0.1, num_iterations=10_000,
             free_hbm=12 * GB)
    assert p.schedule == "resident_gram"


def test_beyond_hbm_least_squares_goes_virtual_gram():
    p = both(10_000_000, 1000, itemsize=2, gram_able=True,
             sampling="sliced", mini_batch_fraction=0.1,
             num_iterations=1000, free_hbm=12 * GB)
    assert p.schedule == "streamed_virtual_gram"
    assert p.aligned and "ALIGNED" in p.reason
    assert p.estimates["stack_bytes"] < 12 * GB


def test_beyond_hbm_non_gram_partial_residency():
    p = both(10_000_000, 1000, itemsize=2, gram_able=False,
             sampling="sliced", mini_batch_fraction=0.1,
             num_iterations=1000, free_hbm=12 * GB)
    assert p.schedule == "partial_residency" and p.resident_rows > 0
    assert p.estimates["resident_window_p"] >= 0.05


def test_beyond_hbm_bernoulli_streams():
    p = both(10_000_000, 1000, itemsize=2, gram_able=False,
             sampling="bernoulli", mini_batch_fraction=0.1,
             num_iterations=1000, free_hbm=12 * GB)
    assert p.schedule == "host_streamed"


def test_beyond_hbm_meshed_goes_virtual_gram():
    kw = dict(itemsize=2, sampling="sliced", mini_batch_fraction=0.1,
              num_iterations=1000, n_devices=8, free_hbm=12 * GB)
    assert both(80_000_000, 1000, gram_able=True, **kw).schedule == \
        "streamed_virtual_gram"
    assert both(80_000_000, 1000, gram_able=False, **kw).schedule == \
        "host_streamed"


def test_mesh_divides_rows_for_fit():
    kw = dict(itemsize=2, gram_able=False, num_iterations=100,
              free_hbm=12 * GB)
    assert both(10_000_000, 1000, **kw).schedule == "host_streamed"
    assert both(10_000_000, 1000, n_devices=8, **kw).schedule == \
        "resident_stock"


def test_device_committed_data_never_streams():
    p = both(10_000_000, 1000, itemsize=2, gram_able=False,
             num_iterations=100, free_hbm=12 * GB, host_resident_ok=False)
    assert p.schedule == "resident_stock" and "device-committed" in p.reason


def test_huge_d_disqualifies_gram():
    assert both(1_000_000, 100_000, itemsize=2, gram_able=True,
                num_iterations=10_000, free_hbm=12 * GB).schedule == \
        "host_streamed"
    assert both(10_000, 20_000, itemsize=2, gram_able=True,
                num_iterations=10_000, free_hbm=12 * GB).schedule == \
        "resident_stock"


def test_force_overrides_with_warning():
    p, rec = both_warned(3_000_000, 1000, itemsize=2, gram_able=True,
                         mini_batch_fraction=1.0, num_iterations=50,
                         free_hbm=12 * GB, force="resident_gram")
    assert p.schedule == "resident_gram" and "forced by caller" in p.reason
    assert any("NET LOSS" in m for m in rec)


def test_force_rejects_unknown_schedule():
    with pytest.raises(ValueError, match="unknown schedule"):
        both(1000, 10, force="warp_drive")


def test_choose_block_rows_doubles_to_fit():
    for budget in (0.2 * GB, 4 * GB, 1e6):
        assert choose_block_rows(1_000_000, 1000, budget) == \
            jplan.choose_block_rows(1_000_000, 1000, budget)
    assert choose_block_rows(1_000_000, 1000, 4 * GB) == 4096
    assert choose_block_rows(1_000_000, 1000, 0.2 * GB) > 4096
    assert choose_block_rows(1_000_000, 1000, 1e6) is None


def test_estimates_are_recorded():
    p = both(3_000_000, 1000, itemsize=2, gram_able=True,
             num_iterations=5000, free_hbm=12 * GB)
    for key in ("n", "d", "free_hbm", "stock_iter_s", "gram_iter_s",
                "gram_build_s", "build_amortize_iters", "fits_resident"):
        assert key in p.estimates, key


def test_device_budget_returns_positive():
    free, source = device_budget(CPU)
    assert free > 0 and source == "fallback"
    assert free == tplan.DEFAULT_COST_MODEL.hbm_bytes * 0.8
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            device_budget()


# ---- plan_for probing -----------------------------------------------------

def test_plan_for_probes_optimizer(rng):
    X = rng.normal(size=(512, 8)).astype(np.float32)
    y = rng.normal(size=(512,)).astype(np.float32)
    opt = tst.GradientDescent(device=CPU)
    p = plan_for(opt, X, y)
    assert p is not None and p.schedule == "resident_stock"
    assert p.estimates["budget_source"] == "fallback"
    p.apply(opt)
    assert opt.last_plan is p
    # a CUDA tensor counts as committed; a CPU tensor is host data
    p2 = plan_for(opt, torch.from_numpy(X), y)
    assert p2.schedule == "resident_stock"


def test_plan_for_skips_sparse_and_non_gd(rng):
    from tpu_sgd_torch.ops.sparse import sparse_data

    Xs, ys, _ = sparse_data(64, 32, nnz_per_row=4, seed=0)
    assert plan_for(tst.GradientDescent(device=CPU), Xs, ys) is None
    X = rng.normal(size=(64, 8)).astype(np.float32)
    y = rng.normal(size=(64,)).astype(np.float32)
    assert plan_for(tst.LBFGS(device=CPU), X, y) is None


def test_apply_clears_previous_schedule(rng):
    opt = tst.GradientDescent(device=CPU).set_host_streaming(
        True, resident_rows=100)
    Plan("resident_stock", "test").apply(opt)
    assert not opt.host_streaming and opt.streaming_resident_rows == 0
    Plan("resident_gram", "test", block_rows=64).apply(opt)
    assert opt.sufficient_stats and opt.gram_block_rows == 64
    Plan("streamed_virtual_gram", "test", block_rows=32,
         aligned=True).apply(opt)
    assert opt.streamed_stats and not opt.sufficient_stats


def test_apply_always_resets_plan_owned_knobs(rng):
    from tpu_sgd_torch.ops.gram import DEFAULT_BLOCK_ROWS

    opt = tst.GradientDescent(device=CPU)
    Plan("streamed_virtual_gram", "small-data plan", block_rows=32,
         batch_rows=64, aligned=True).apply(opt)
    assert opt.gram_batch_rows == 64
    assert opt.gram_block_rows == 32 and opt.gram_aligned
    Plan("resident_stock", "new-data plan").apply(opt)
    assert opt.gram_batch_rows is None
    assert opt.gram_block_rows == DEFAULT_BLOCK_ROWS
    assert not opt.gram_aligned


def test_apply_preserves_user_set_gram_knobs(rng):
    opt = tst.GradientDescent(device=CPU).set_gram_options(batch_rows=256)
    Plan("resident_gram", "auto plan", block_rows=4096).apply(opt)
    assert opt.gram_batch_rows == 256 and opt.gram_block_rows == 4096
    opt2 = tst.GradientDescent(device=CPU).set_gram_options(
        block_rows=64, aligned=True)
    Plan("streamed_virtual_gram", "auto plan", block_rows=4096,
         batch_rows=8192, aligned=False).apply(opt2)
    assert opt2.gram_block_rows == 64 and opt2.gram_aligned
    assert opt2.gram_batch_rows == 8192


def test_knob_setter_keeps_replanning_alive(rng, caplog):
    X = rng.normal(size=(2048, 16)).astype(np.float32)
    w = rng.uniform(-1, 1, 16).astype(np.float32)
    y = (X @ w + 0.05 * rng.normal(size=2048)).astype(np.float32)
    alg = tst.LinearRegressionWithSGD(device=CPU)
    alg.optimizer.set_step_size(1.0)
    alg.run((X, y))
    assert alg.optimizer.last_plan is not None
    alg.optimizer.set_gram_options(batch_rows=256)
    assert alg.optimizer._plan_key is None
    assert alg.optimizer.last_plan is not None
    with caplog.at_level(logging.INFO, logger="tpu_sgd_torch.plan"):
        alg.run((X, y))
    assert any(r.message.startswith("plan: ") for r in caplog.records)
    assert alg.optimizer._plan_key is not None
    assert alg.optimizer.gram_batch_rows == 256


def test_force_resident_beyond_hbm_warns():
    p, rec = both_warned(10_000_000, 1000, itemsize=2, gram_able=True,
                         mini_batch_fraction=1.0, num_iterations=100_000,
                         free_hbm=12 * GB, force="resident_gram")
    assert p.schedule == "resident_gram"
    assert any("does not fit" in m for m in rec)
    p, rec = both_warned(10_000_000, 1000, itemsize=2, gram_able=False,
                         mini_batch_fraction=1.0, num_iterations=100,
                         free_hbm=12 * GB, force="resident_stock")
    assert p.schedule == "resident_stock"
    assert any("does not fit" in m for m in rec)


# ---- wired into the model layer ------------------------------------------

def test_train_zero_flags_plans_and_logs(rng, caplog):
    X = rng.normal(size=(2048, 16)).astype(np.float32)
    w = rng.uniform(-1, 1, 16).astype(np.float32)
    y = (X @ w + 0.05 * rng.normal(size=2048)).astype(np.float32)
    with caplog.at_level(logging.INFO, logger="tpu_sgd_torch.plan"):
        model = tst.LinearRegressionWithSGD.train(
            (X, y), num_iterations=100, step_size=1.0, device=CPU)
    assert any(r.message.startswith("plan: ") for r in caplog.records)
    assert float(np.linalg.norm(model.weights.numpy() - w)) < 0.1


def test_train_schedule_off_keeps_legacy_path(rng):
    X = rng.normal(size=(256, 8)).astype(np.float32)
    y = rng.normal(size=(256,)).astype(np.float32)
    alg = tst.LinearRegressionWithSGD(0.2, 10, device=CPU)
    alg.set_schedule("off")
    alg.run((X, y))
    assert alg.optimizer.last_plan is None


def test_train_manual_flags_win_over_auto(rng):
    X = rng.normal(size=(2048, 8)).astype(np.float32)
    w = rng.uniform(-1, 1, 8).astype(np.float32)
    y = (X @ w).astype(np.float32)
    alg = tst.LinearRegressionWithSGD(1.0, 100, device=CPU)
    alg.optimizer.set_sufficient_stats(True)
    model = alg.run((X, y))
    assert alg.optimizer.last_plan is None
    assert alg.optimizer.sufficient_stats
    assert np.linalg.norm(model.weights.numpy() - w) < 0.1


def test_forced_streamed_virtual_gram_trains(rng):
    n, d = 4096, 12
    X = rng.normal(size=(n, d)).astype(np.float32)
    w = rng.uniform(-1, 1, d).astype(np.float32)
    y = (X @ w + 0.01 * rng.normal(size=n)).astype(np.float32)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        alg = tst.LinearRegressionWithSGD(0.3, 60, None, 0.25, device=CPU)
        alg.optimizer.set_sampling("sliced")
        model = alg.set_schedule("streamed_virtual_gram").run((X, y))
    assert alg.optimizer.streamed_stats
    assert np.linalg.norm(model.weights.numpy() - w) < 0.1


def test_forced_schedule_validates_name():
    with pytest.raises(ValueError, match="schedule must be one of"):
        tst.LinearRegressionWithSGD.train(
            (np.zeros((4, 2), np.float32), np.zeros(4, np.float32)),
            schedule="warp_drive", device=CPU)


def test_set_streamed_stats_guards(rng):
    from tpu_sgd_torch.parallel import DATA_AXIS, MODEL_AXIS, Mesh

    X = rng.normal(size=(256, 8)).astype(np.float32)
    y = rng.normal(size=(256,)).astype(np.float32)
    w0 = np.zeros((8,), np.float32)
    with pytest.raises(NotImplementedError, match="least squares"):
        tst.GradientDescent(tst.LogisticGradient(), device=CPU) \
            .set_streamed_stats(True).optimize((X, np.abs(np.sign(y))), w0)
    with pytest.raises(NotImplementedError, match="1-D 'data' mesh"):
        tst.GradientDescent(device=CPU).set_streamed_stats(True) \
            .set_mesh(Mesh({DATA_AXIS: 4, MODEL_AXIS: 2})) \
            .optimize((X, y), w0)
    with pytest.raises(ValueError, match="alternative"):
        tst.GradientDescent(device=CPU).set_streamed_stats(True) \
            .set_host_streaming(True).optimize((X, y), w0)
    with pytest.raises(NotImplementedError, match="sliced"):
        tst.GradientDescent(device=CPU).set_streamed_stats(True) \
            .set_mini_batch_fraction(0.5).optimize((X, y), w0)


def test_streamed_stats_matches_manual_virtual_run(rng):
    n, d = 2048, 8
    X = rng.normal(size=(n, d)).astype(np.float32)
    w = rng.uniform(-1, 1, d).astype(np.float32)
    y = (X @ w + 0.05 * rng.normal(size=n)).astype(np.float32)

    def mk():
        return (tst.GradientDescent(updater=tst.SimpleUpdater(), device=CPU)
                .set_step_size(0.3).set_num_iterations(25)
                .set_mini_batch_fraction(0.25).set_sampling("sliced")
                .set_convergence_tol(0.0).set_seed(5))

    w1, h1 = mk().set_streamed_stats(True, block_rows=256) \
        .optimize_with_history((X, y), np.zeros(d, np.float32))
    g = tst.GramLeastSquaresGradient.build_streamed(X, y, block_rows=256,
                                                    device=CPU)
    opt2 = mk()
    opt2.set_gradient(g)
    w2, h2 = opt2.optimize_with_history((g.data, y[:g.data.shape[0]]),
                                        np.zeros(d, np.float32))
    np.testing.assert_allclose(w1.numpy(), w2.numpy(), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(h1, h2, rtol=1e-6, atol=1e-7)


def test_schedule_names_stable():
    assert SCHEDULES == ("resident_stock", "resident_gram",
                         "partial_residency", "host_streamed",
                         "streamed_virtual_gram")
    assert SCHEDULES == jplan.SCHEDULES
    assert tplan.QN_SCHEDULES == jplan.QN_SCHEDULES


def test_gram_options_rebuild_on_change(rng):
    X = rng.normal(size=(1024, 8)).astype(np.float32)
    w = rng.uniform(-1, 1, 8).astype(np.float32)
    y = (X @ w).astype(np.float32)
    opt = (tst.GradientDescent(device=CPU).set_num_iterations(5)
           .set_sufficient_stats(True).set_gram_options(block_rows=128))
    opt.optimize((X, y), np.zeros(8, np.float32))
    g1 = opt._gram_entry[2]
    assert g1.data.block_rows == 128
    opt.set_gram_options(block_rows=256)
    opt.optimize((X, y), np.zeros(8, np.float32))
    g2 = opt._gram_entry[2]
    assert g2 is not g1 and g2.data.block_rows == 256


def test_second_run_replans_on_new_dataset(rng, caplog):
    X1 = rng.normal(size=(256, 8)).astype(np.float32)
    y1 = rng.normal(size=(256,)).astype(np.float32)
    X2 = rng.normal(size=(512, 8)).astype(np.float32)
    y2 = rng.normal(size=(512,)).astype(np.float32)
    alg = tst.LinearRegressionWithSGD(0.2, 5, device=CPU)
    with caplog.at_level(logging.INFO, logger="tpu_sgd_torch.plan"):
        alg.run((X1, y1))
        first = alg.optimizer.last_plan
        alg.run((X2, y2))
        second = alg.optimizer.last_plan
    assert first is not None and second is not None and second is not first
    assert sum(r.message.startswith("plan: ")
               for r in caplog.records) == 2


# ---- quasi-Newton planning ------------------------------------------------

class _ShapeOnly:
    """Shape and dtype only: huge logical datasets cost nothing here."""

    def __init__(self, shape, dtype=np.float32):
        self.shape = shape
        self.dtype = np.dtype(dtype)


def qn_both_warned(opts, X, **kw):
    """``plan_quasi_newton`` in both packages on optimizers ``opts =
    (port, jax)``: ``(the port's plan, its warnings)`` after checking that
    plans, warnings and errors are the same."""
    t_opt, j_opt = opts
    t, tw = _warned(lambda: tplan.plan_quasi_newton(
        t_opt, X, None, cost_model=JCM, **kw))
    j, jw = _warned(lambda: jplan.plan_quasi_newton(j_opt, X, None, **kw))
    assert tw == jw
    if isinstance(j, ValueError):
        assert isinstance(t, ValueError) and str(t) == str(j)
        raise t
    if j is None:
        assert t is None
    else:
        assert_same_plan(t, j)
    return t, tw


def qn_both(opts, X, **kw):
    return qn_both_warned(opts, X, **kw)[0]


def _lbfgs(gradient=None, **kw):
    from tpu_sgd import LBFGS as JLBFGS
    from tpu_sgd.ops import gradients as jg

    jgrad = None if gradient is None else getattr(jg, gradient)()
    tgrad = None if gradient is None else getattr(tst, gradient)()
    return (tst.LBFGS(tgrad, device=CPU, **kw), JLBFGS(jgrad, **kw))


def test_plan_quasi_newton_boundaries():
    big = _ShapeOnly((3_000_000, 1000), np.float16)
    p = qn_both(_lbfgs(), big, free_hbm=12 * GB)
    assert p.schedule == "resident_gram"
    small = _ShapeOnly((10_000, 50))
    p = qn_both(_lbfgs(), small, free_hbm=12 * GB)
    assert p.schedule == "resident_stock" and "amortize" in p.reason
    huge = _ShapeOnly((100_000_000, 1000), np.float16)
    p = qn_both(_lbfgs(), huge, free_hbm=12 * GB)
    assert p.schedule == "streamed_virtual_gram"
    huge_d = _ShapeOnly((1_000_000, 100_000), np.float16)
    p = qn_both(_lbfgs(), huge_d, free_hbm=12 * GB)
    assert "no schedule fits" in p.reason
    p = qn_both(_lbfgs("LogisticGradient"), big, free_hbm=12 * GB)
    assert "no fixed-size statistics" in p.reason
    p = qn_both(_lbfgs("LogisticGradient"), huge, free_hbm=12 * GB)
    assert p.schedule == "host_streamed" and "treeAggregate" in p.reason
    assert 2 * p.batch_rows * 1000 * 2 <= 12 * GB
    with pytest.raises(ValueError, match="does not exist behind"):
        qn_both(_lbfgs(), big, free_hbm=12 * GB, force="partial_residency")
    p, rec = qn_both_warned(_lbfgs(max_num_iterations=3), big,
                            free_hbm=12 * GB, force="resident_gram")
    assert p.schedule == "resident_gram"
    assert any("NET LOSS" in m for m in rec)


def test_train_auto_plans_host_streamed_costfun(rng, caplog, monkeypatch):
    monkeypatch.setattr(tplan, "device_budget",
                        lambda *a, **k: (8e3, "test"))
    X = rng.normal(size=(512, 8)).astype(np.float32)
    w = rng.uniform(-1, 1, 8).astype(np.float32)
    y = (X @ w > 0).astype(np.float32)
    with caplog.at_level(logging.INFO, logger="tpu_sgd_torch.plan"):
        alg = tst.LogisticRegressionWithLBFGS(device=CPU)
        model = alg.run((X, y))
    msgs = [r.message for r in caplog.records
            if r.message.startswith("plan: ")]
    assert msgs and "host_streamed" in msgs[0]
    assert alg.optimizer.host_streaming
    assert alg.optimizer.stream_batch_rows is not None
    assert float((model.predict(X).numpy() == y).mean()) > 0.9


def test_stale_plan_flags_reset_on_unplannable_input(rng, monkeypatch):
    from tpu_sgd_torch.ops.sparse import sparse_data

    monkeypatch.setattr(tplan, "device_budget",
                        lambda *a, **k: (8e3, "test"))
    X = rng.normal(size=(512, 8)).astype(np.float32)
    w = rng.uniform(-1, 1, 8).astype(np.float32)
    y = (X @ w > 0).astype(np.float32)
    alg = tst.LogisticRegressionWithLBFGS(max_num_iterations=5, device=CPU)
    alg.run((X, y))
    assert alg.optimizer.host_streaming
    Xs, ys, _ = sparse_data(64, 8, nnz_per_row=3, seed=0)
    ys = np.abs(np.sign(np.asarray(ys)))
    model = alg.run((Xs, ys))
    assert not alg.optimizer.host_streaming
    assert model is not None


def test_force_gram_rejected_for_non_ls_gradient():
    big = _ShapeOnly((3_000_000, 1000), np.float16)
    for force in ("resident_gram", "streamed_virtual_gram"):
        with pytest.raises(ValueError, match="LogisticGradient"):
            qn_both(_lbfgs("LogisticGradient"), big, free_hbm=12 * GB,
                    force=force)


def test_meshed_coercion_defers_device_commit(rng):
    """The port's twin of the JAX package's deferred commit: a meshed
    quasi-Newton run streams host rows where they lie (the streamed
    CostFun keeps them on the host), and the resident coercion takes int
    labels and f64 features to f32 on the run's device."""
    from tpu_sgd_torch.optimize.lbfgs import _coerce_inputs
    from tpu_sgd_torch.optimize.streamed_costfun import StreamedCostFun

    X = rng.normal(size=(64, 4)).astype(np.float64)
    y = rng.integers(0, 2, 64)
    w0 = np.zeros(4, np.float32)
    Xc, yc, wc = _coerce_inputs(X, y, w0, torch.device(CPU))
    assert Xc.dtype == yc.dtype == wc.dtype == torch.float32
    scf = StreamedCostFun(tst.LogisticGradient(), X.astype(np.float32),
                          y.astype(np.float32), batch_rows=16, device=CPU)
    assert scf.X.device.type == "cpu" and scf.X.dtype == torch.float32


def test_plan_quasi_newton_meshed_boundaries():
    from tpu_sgd import data_mesh as jdata_mesh
    from tpu_sgd import make_mesh as jmake_mesh
    from tpu_sgd_torch.parallel import DATA_AXIS, MODEL_AXIS, Mesh

    tmesh, jmesh = Mesh({DATA_AXIS: 8}), jdata_mesh()

    def meshed(gradient=None):
        t, j = _lbfgs(gradient)
        t.mesh = tmesh
        return t, j.set_mesh(jmesh)

    mid = _ShapeOnly((40_000_000, 1000), np.float16)
    assert qn_both(_lbfgs(), mid, free_hbm=12 * GB).schedule == \
        "streamed_virtual_gram"
    eight = qn_both(meshed(), mid, free_hbm=12 * GB)
    assert eight.schedule == "resident_gram"
    assert "per-shard totals" in eight.reason
    huge = _ShapeOnly((800_000_000, 1000), np.float16)
    p = qn_both(meshed(), huge, free_hbm=12 * GB)
    assert p.schedule == "streamed_virtual_gram" and "EXACT totals" in p.reason
    p = qn_both(meshed("LogisticGradient"), huge, free_hbm=12 * GB)
    assert p.schedule == "host_streamed" and p.batch_rows is not None
    t, j = _lbfgs()
    t.mesh = Mesh({DATA_AXIS: 4, MODEL_AXIS: 2})
    j.mesh = jmake_mesh(n_data=4, n_model=2)
    assert qn_both((t, j), mid, free_hbm=12 * GB) is None


def test_plan_quasi_newton_keeps_device_data_resident(monkeypatch):
    """Data already on the card never streams behind a quasi-Newton
    optimizer either (``plan``'s rule; the JAX package's quasi-Newton
    planner has no such input)."""
    huge = _ShapeOnly((100_000_000, 1000), np.float16)
    monkeypatch.setattr(tplan, "_on_card", lambda X: True)
    for grad in (None, "LogisticGradient"):
        t, _ = _lbfgs(grad)
        p = tplan.plan_quasi_newton(t, huge, None, cost_model=JCM,
                                    free_hbm=12 * GB)
        assert p.schedule == "resident_stock"
        assert p.reason.startswith("data is already device-committed")


def test_lbfgs_train_auto_plans_and_forced_gram(rng, caplog):
    X = rng.normal(size=(2048, 12)).astype(np.float32)
    w = rng.uniform(-1, 1, 12).astype(np.float32)
    y = (X @ w + 0.01 * rng.normal(size=2048)).astype(np.float32)
    alg = tst.LinearRegressionWithLBFGS(device=CPU)
    with caplog.at_level(logging.INFO, logger="tpu_sgd_torch.plan"):
        m0 = alg.run((X, y))
    assert alg.optimizer.last_plan.schedule == "resident_stock"
    assert not alg.optimizer.sufficient_stats
    assert any(r.message.startswith("plan: ") for r in caplog.records)
    alg2 = tst.LinearRegressionWithLBFGS(device=CPU) \
        .set_schedule("resident_gram")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        m1 = alg2.run((X, y))
    assert alg2.optimizer.sufficient_stats
    assert alg2.optimizer._gram_entry is not None
    np.testing.assert_allclose(m1.weights.numpy(), m0.weights.numpy(),
                               rtol=1e-3, atol=1e-4)


def test_owlqn_forced_gram_plans(rng):
    X = rng.normal(size=(1024, 10)).astype(np.float32)
    w = rng.uniform(-1, 1, 10).astype(np.float32)
    y = (X @ w).astype(np.float32)
    alg = tst.LassoWithOWLQN(reg_param=1e-4, device=CPU) \
        .set_schedule("resident_gram")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        m = alg.run((X, y))
    assert alg.optimizer.sufficient_stats
    assert alg.optimizer._gram_entry is not None
    assert np.all(np.isfinite(m.weights.numpy()))


def test_manual_flag_after_auto_plan_wins(rng):
    X1 = rng.normal(size=(256, 8)).astype(np.float32)
    y1 = rng.normal(size=(256,)).astype(np.float32)
    X2 = rng.normal(size=(300, 8)).astype(np.float32)
    y2 = rng.normal(size=(300,)).astype(np.float32)
    alg = tst.LinearRegressionWithSGD(0.2, 5, device=CPU)
    alg.run((X1, y1))
    assert alg.optimizer.last_plan is not None
    alg.optimizer.set_sufficient_stats(True)
    assert alg.optimizer.last_plan is None
    alg.run((X2, y2))
    assert alg.optimizer.sufficient_stats
    assert alg.optimizer.last_plan is None


def test_forced_schedule_on_unplanned_input_raises_clearly(rng):
    from tpu_sgd_torch.ops.sparse import sparse_data

    Xs, ys, _ = sparse_data(64, 16, nnz_per_row=4, seed=0)
    with pytest.raises(ValueError, match="cannot be applied here"):
        tst.LinearRegressionWithSGD.train((Xs, ys), num_iterations=3,
                                          schedule="host_streamed",
                                          device=CPU)


def test_forced_partial_residency_messages():
    with pytest.raises(ValueError, match="already fits"):
        both(1000, 8, sampling="sliced", mini_batch_fraction=0.1,
             free_hbm=1 * GB, force="partial_residency")
    with pytest.raises(ValueError, match="sliced sampling"):
        both(10_000_000, 1000, itemsize=2, sampling="bernoulli",
             mini_batch_fraction=0.1, free_hbm=1 * GB,
             force="partial_residency")


def test_repeat_runs_skip_replanning(rng, caplog):
    X = rng.normal(size=(256, 8)).astype(np.float32)
    y = rng.normal(size=(256,)).astype(np.float32)
    alg = tst.LinearRegressionWithSGD(0.2, 5, device=CPU)
    with caplog.at_level(logging.INFO, logger="tpu_sgd_torch.plan"):
        for _ in range(4):
            alg.run((X, y))
    assert sum(r.message.startswith("plan: ")
               for r in caplog.records) == 1


def test_device_budget_probe_shapes(monkeypatch):
    """On a CUDA device the budget is (free + reserved - allocated) ×
    hbm_safety from the driver's and the allocator's readings; on the
    CPU the cost model's fallback."""
    monkeypatch.setattr(tplan, "resolve_device",
                        lambda d=None: torch.device("cuda", 0))
    monkeypatch.setattr(tplan, "_cuda_memory",
                        lambda dev: (10e9, 3e9, 1e9))
    free, source = device_budget()
    assert source == "memory_stats"
    assert free == pytest.approx(12e9 * 0.8)
    free, _ = device_budget(cost_model=CostModel(hbm_safety=0.5))
    assert free == pytest.approx(6e9)
    monkeypatch.setattr(tplan, "_cuda_memory", lambda dev: (0, 0, 1e9))
    assert device_budget()[0] == 0.0
    monkeypatch.undo()
    free, source = device_budget(CPU)
    assert source == "fallback" and free > 0


def test_lbfgs_streamed_stats_matches_manual_virtual_flow(rng):
    n, d = 2048, 10
    X = rng.normal(size=(n, d)).astype(np.float32)
    w = rng.uniform(-1, 1, d).astype(np.float32)
    y = (X @ w + 0.01 * rng.normal(size=n)).astype(np.float32)
    w0 = np.zeros((d,), np.float32)
    opt1 = tst.LBFGS(max_num_iterations=10, device=CPU).set_streamed_stats(
        True, block_rows=256)
    w1, h1 = opt1.optimize_with_history((X, y), w0)
    assert opt1._streamed_gram_entry is not None
    g = tst.GramLeastSquaresGradient.build_streamed(X, y, block_rows=256,
                                                    device=CPU)
    opt2 = tst.LBFGS(g, max_num_iterations=10, device=CPU)
    w2, h2 = opt2.optimize_with_history((g.data, y[:g.data.shape[0]]), w0)
    np.testing.assert_array_equal(w1.numpy(), w2.numpy())
    np.testing.assert_array_equal(h1, h2)
    entry = opt1._streamed_gram_entry
    opt1.optimize_with_history((X, y), w0)
    assert opt1._streamed_gram_entry is entry
    opt1.release_sufficient_stats()
    assert opt1._streamed_gram_entry is None
    ow = tst.OWLQN(reg_param=1e-4, max_num_iterations=8,
                   device=CPU).set_streamed_stats(True, block_rows=256)
    w3, h3 = ow.optimize_with_history((X, y), w0)
    assert ow._streamed_gram_entry is not None
    assert np.all(np.isfinite(w3.numpy())) and h3[-1] <= h3[0]


def test_lbfgs_streamed_stats_guards(rng):
    from tpu_sgd_torch.parallel import DATA_AXIS, MODEL_AXIS, Mesh

    X = rng.normal(size=(128, 6)).astype(np.float32)
    y = rng.normal(size=(128,)).astype(np.float32)
    w0 = np.zeros((6,), np.float32)
    with pytest.raises(NotImplementedError, match="least squares"):
        tst.LBFGS(tst.LogisticGradient(), device=CPU) \
            .set_streamed_stats(True) \
            .optimize_with_history((X, np.abs(np.sign(y))), w0)
    with pytest.raises(ValueError, match="data-only mesh"):
        tst.LBFGS(device=CPU).set_mesh(Mesh({DATA_AXIS: 4, MODEL_AXIS: 2}))


def test_choose_streamed_build_budgets_chunk():
    from tpu_sgd_torch.plan import _stack_bytes, choose_streamed_build

    got = choose_streamed_build(100_000_000, 1000, 2, 12 * GB)
    assert got == jplan.choose_streamed_build(100_000_000, 1000, 2, 12 * GB)
    B, batch = got
    assert _stack_bytes(100_000_000, B, 1000) + 2 * batch * (1000 * 2 + 4) \
        <= 12 * GB
    assert batch >= B
    assert choose_streamed_build(1_000_000, 100_000, 2, 12 * GB) == \
        (None, None)


def test_forced_gram_infeasible_budget_warns():
    p, rec = both_warned(1_000_000, 100_000, itemsize=2, gram_able=True,
                         sampling="sliced", mini_batch_fraction=0.1,
                         num_iterations=1000, free_hbm=12 * GB,
                         force="streamed_virtual_gram")
    assert p.schedule == "streamed_virtual_gram" and p.block_rows is None
    assert any("NO feasible block size" in m for m in rec)


def test_plan_batch_rows_plumbs_to_optimizer():
    p = both(10_000_000, 1000, itemsize=2, gram_able=True, sampling="sliced",
             mini_batch_fraction=0.1, num_iterations=1000, free_hbm=12 * GB)
    assert p.schedule == "streamed_virtual_gram"
    opt = p.apply(tst.GradientDescent(device=CPU))
    assert opt.gram_batch_rows == p.batch_rows >= p.block_rows
    assert opt.gram_block_rows == p.block_rows


def test_manual_setter_clears_planned_sibling_flags(rng):
    opt = tst.GradientDescent(device=CPU)
    Plan("host_streamed", "auto plan").apply(opt)
    assert opt.host_streaming
    opt.set_streamed_stats(True)
    assert not opt.host_streaming and opt.streamed_stats
    lb = tst.LBFGS(tst.LeastSquaresGradient(), max_num_iterations=3,
                   device=CPU)
    lb.host_streaming = True
    lb.last_plan = Plan("host_streamed", "auto plan")
    lb.set_streamed_stats(True, block_rows=32)
    assert not lb.host_streaming
    X = rng.normal(size=(256, 6)).astype(np.float32)
    y = rng.normal(size=(256,)).astype(np.float32)
    w, h = lb.optimize_with_history((X, y), np.zeros(6, np.float32))
    assert np.all(np.isfinite(w.numpy()))
    lb2 = tst.LBFGS(device=CPU).set_host_streaming(True)
    with pytest.raises(ValueError, match="alternative"):
        lb2.set_streamed_stats(True).optimize_with_history(
            (X, y), np.zeros(6, np.float32))


def test_meshed_resident_gram_skips_stack_feasibility():
    from tpu_sgd import data_mesh as jdata_mesh
    from tpu_sgd_torch.parallel import DATA_AXIS, Mesh

    t, j = _lbfgs()
    t.mesh = Mesh({DATA_AXIS: 8})
    j.set_mesh(jdata_mesh())
    tight = _ShapeOnly((47_500_000, 1000), np.float16)
    assert qn_both((t, j), tight, free_hbm=12 * GB).schedule == \
        "resident_gram"


# ---- self-calibration -------------------------------------------------------

def test_cost_model_calibrate_probe():
    """What cannot depend on the host's load: overrides win, a clamped
    feed falls back, the report is left out of equality, and the rates
    are positive and inside their windows (a rejected probe keeps the
    default, which is)."""
    cm = CostModel.calibrate(device=CPU, copy_mb=4, feed_mb=4)
    assert 1.0 <= cm.hbm_gb_s <= 20_000
    assert 1e-3 <= cm.host_feed_gb_s <= 1_000
    assert cm.hbm_bytes == CostModel().hbm_bytes
    for key in ("hbm_raw_gb_s", "hbm_slope_s", "hbm_fell_back",
                "feed_raw_gb_s", "feed_slope_s", "feed_fell_back"):
        assert key in cm.calibration_report
    cm2 = CostModel.calibrate(device=CPU, copy_mb=4, feed_mb=4,
                              hbm_safety=0.5)
    assert cm2.hbm_safety == 0.5
    cm3 = CostModel.calibrate(device=CPU, copy_mb=4, feed_mb=4,
                              host_feed_gb_s=50.0)
    assert cm3.host_feed_gb_s == 50.0 and cm3.hbm_gb_s > 0
    cm4 = CostModel.calibrate(device=CPU, copy_mb=4, feed_mb=0.003)
    assert cm4.host_feed_gb_s == CostModel().host_feed_gb_s
    assert cm4.calibration_report["feed_fell_back"] is True
    assert CostModel(calibration_report={"x": 1}) == CostModel()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            CostModel.calibrate()


def test_fed_cost_model_flips_streaming_boundary():
    kw = dict(itemsize=2, gram_able=True, sampling="sliced",
              mini_batch_fraction=0.1, num_iterations=20, free_hbm=12 * GB)
    slow = both(10_000_000, 1000, **kw)
    assert slow.schedule == "streamed_virtual_gram"
    fast_cm = dataclasses.replace(JCM, host_feed_gb_s=50.0)
    fast = plan(10_000_000, 1000, cost_model=fast_cm, **kw)
    assert_same_plan(fast, jplan.plan(
        10_000_000, 1000, cost_model=jplan.CostModel(host_feed_gb_s=50.0),
        **kw))
    assert fast.schedule == "partial_residency"
    assert fast.estimates["streamed_iter_s"] < \
        slow.estimates["streamed_iter_s"] / 100


def test_host_streamed_plan_does_not_leak_stream_chunk_into_gram_knob():
    opt = tst.LBFGS(tst.LeastSquaresGradient(), tst.SquaredL2Updater(),
                    device=CPU)
    Plan("host_streamed", "test", batch_rows=6_400_000) \
        .apply_quasi_newton(opt)
    assert opt.host_streaming
    assert opt.stream_batch_rows == 6_400_000
    assert opt.gram_batch_rows is None
    Plan("streamed_virtual_gram", "test", block_rows=256, batch_rows=4096,
         aligned=True).apply_quasi_newton(opt)
    assert opt.streamed_stats and not opt.host_streaming
    assert opt.stream_batch_rows is None
    assert opt.gram_batch_rows == 4096


def test_manual_schedule_after_plan_resets_plan_owned_knobs():
    from tpu_sgd_torch.ops.gram import DEFAULT_BLOCK_ROWS

    opt = tst.GradientDescent(device=CPU)
    Plan("streamed_virtual_gram", "test", block_rows=512, batch_rows=4096,
         aligned=True).apply(opt)
    assert opt.gram_block_rows == 512 and opt.gram_batch_rows == 4096
    opt.set_streamed_stats(True)
    assert opt.gram_block_rows == DEFAULT_BLOCK_ROWS
    assert opt.gram_batch_rows is None
    assert opt.gram_aligned is False and opt.gram_chunk_iters is None
    opt2 = tst.GradientDescent(device=CPU).set_gram_options(block_rows=128)
    Plan("streamed_virtual_gram", "t", block_rows=512,
         batch_rows=4096).apply(opt2)
    assert opt2.gram_block_rows == 128
    opt2.set_sufficient_stats(True)
    assert opt2.gram_block_rows == 128 and opt2.gram_batch_rows is None


def test_set_gram_options_validates_before_applying():
    from tpu_sgd_torch.ops.gram import DEFAULT_BLOCK_ROWS

    for opt in (tst.GradientDescent(device=CPU), tst.LBFGS(device=CPU)):
        with pytest.raises(ValueError, match="batch_rows must be positive"):
            opt.set_gram_options(block_rows=4096, batch_rows=0)
        assert opt.gram_block_rows == DEFAULT_BLOCK_ROWS
        assert "block_rows" not in opt._user_gram_opts


# ---- the choosers' twins (replica, store, residency, superstep, wire,
# ---- slab) -------------------------------------------------------------------

def test_choose_replicas_scaling():
    cases = [dict(n=1000, d=16, n_devices=8),
             dict(n=10_000_000, d=1000, n_devices=1),
             dict(n=10_000_000, d=1000, n_devices=8),
             dict(n=10_000_000, d=1000, n_devices=2),
             dict(n=10_000_000, d=1000, n_devices=8, cap=3),
             dict(n=100_000, d=1000, n_devices=8)]
    got = [tplan.choose_replicas(cost_model=JCM, **c) for c in cases]
    assert got == [jplan.choose_replicas(**c) for c in cases]
    assert got[0] == 0 and got[1] == 0 and 2 <= got[2] <= 8
    assert got[3] <= 2 and got[4] <= 3 and got[2] >= got[5]
    assert Plan(schedule="resident", reason="r").replicas == 0
    p = both(10_000_000, 1000, n_devices=8)
    assert p.replicas == got[2] == p.estimates["replicas"]
    assert both(4096, 16, n_devices=8).replicas == 0


def test_choose_store_shards_small_model_stays_unsharded():
    for c in (dict(n=256, d=12, n_devices=8),
              dict(n=2000, d=20_000_000, n_devices=1)):
        assert tplan.choose_store_shards(cost_model=JCM, **c) == \
            jplan.choose_store_shards(**c) == 1


def test_choose_store_shards_wide_model_shards_and_clamps():
    s8 = tplan.choose_store_shards(2_000_000, 20_000_000, n_devices=8,
                                   cost_model=JCM)
    s4 = tplan.choose_store_shards(2_000_000, 20_000_000, n_devices=4,
                                   cost_model=JCM)
    assert s8 == jplan.choose_store_shards(2_000_000, 20_000_000,
                                           n_devices=8)
    assert s4 == jplan.choose_store_shards(2_000_000, 20_000_000,
                                           n_devices=4)
    assert 1 < s8 <= 8 and 1 < s4 <= 4 and s4 <= s8


def test_choose_replicas_grows_with_store_shards():
    w1 = tplan.choose_replicas(2000, 20_000_000, n_devices=8,
                               cost_model=JCM)
    w4 = tplan.choose_replicas(2000, 20_000_000, n_devices=8,
                               store_shards=4, cost_model=JCM)
    assert (w1, w4) == (
        jplan.choose_replicas(2000, 20_000_000, n_devices=8),
        jplan.choose_replicas(2000, 20_000_000, n_devices=8,
                              store_shards=4))
    assert w4 > w1 >= 2


def test_plan_exposes_store_shards():
    assert tplan.DEFAULT_COST_MODEL.sparse_merge_density == 0.25
    assert both(256, 12, n_devices=8).store_shards == 1
    wide = both(2_000_000, 20_000_000, n_devices=8)
    assert wide.store_shards > 1
    assert wide.estimates["store_shards"] == wide.store_shards


def test_choose_residency_crossover_rule():
    cases = [((4,), dict(checkpoint_every=10)),
             ((4,), dict(checkpoint_every=7)),
             ((1,), dict(checkpoint_every=100)),
             ((4,), dict(checkpoint_every=100, preempt_latency_iters=9)),
             ((2,), dict(checkpoint_every=10 ** 6, cap=16))]
    got = [tplan.choose_residency(*a, **k) for a, k in cases]
    assert got == [jplan.choose_residency(*a, **k) for a, k in cases]
    assert got == [2, 0, 0, 2, 16]


def test_choose_superstep_amortizes_and_respects_budget():
    cm = dataclasses.replace(JCM, dispatch_overhead_s=8e-4,
                             superstep_dispatch_frac=0.05)
    jcm = jplan.CostModel(dispatch_overhead_s=8e-4,
                          superstep_dispatch_frac=0.05)
    batch = 5000 * (16 * 4 + 5.0)
    cases = [(5000, 16, 4, 2e-3, 1e9), (10 ** 6, 1000, 4, 26.0, 1e9),
             (5000, 16, 4, 2e-3, 100.0), (5000, 16, 4, 2e-3, 2 * batch * 3)]
    got = [tplan.choose_superstep(*c, cm) for c in cases]
    assert got == [jplan.choose_superstep(*c, jcm) for c in cases]
    assert got == [8, 1, 1, 3]


def test_choose_wire_compress_cost_model():
    fast = dataclasses.replace(JCM, allreduce_gb_s=1000.0)
    cases = [(10_000_000, 1, JCM), (1000, 8, JCM), (2_000_000, 8, JCM),
             (2_000_000, 8, fast)]
    got = [tplan.choose_wire_compress(*c) for c in cases]
    jfast = jplan.CostModel(allreduce_gb_s=1000.0)
    want = [jplan.choose_wire_compress(10_000_000, 1),
            jplan.choose_wire_compress(1000, 8),
            jplan.choose_wire_compress(2_000_000, 8),
            jplan.choose_wire_compress(2_000_000, 8, jfast)]
    assert got == want == [None, None, "topk:0.01", None]


def test_choose_slab_capacity():
    cases = [((10000, 64), dict(free_hbm=16e9)),
             ((10000, 64), dict(free_hbm=16e9, working_set=300)),
             ((8, 4), dict(free_hbm=16e9)),
             ((1 << 20, 1 << 20), dict(free_hbm=16e9)),
             ((10 ** 9, 4), dict(free_hbm=1e12, cap=4096))]
    got = [tplan.choose_slab_capacity(*a, cost_model=JCM, **k)
           for a, k in cases]
    assert got == [jplan.choose_slab_capacity(*a, **k) for a, k in cases]
    assert got == [1024, 512, 1, 2048, 4096]
    # the tenant store's thrash error names this function
    import inspect

    from tpu_sgd_torch.tenant import store as tstore

    assert "plan.choose_slab_capacity" in inspect.getsource(tstore)
    assert callable(tst.plan.choose_slab_capacity)


def test_plan_wire_compress_and_residency_knob_plumbing():
    cm = dataclasses.replace(JCM, allreduce_gb_s=0.001,
                             compress_overhead_s=1e-7)
    p = plan(2_000_000, 4096, itemsize=4, sampling="bernoulli",
             mini_batch_fraction=0.5, num_iterations=100, n_devices=8,
             free_hbm=1e9, cost_model=cm)
    assert_same_plan(p, jplan.plan(
        2_000_000, 4096, itemsize=4, sampling="bernoulli",
        mini_batch_fraction=0.5, num_iterations=100, n_devices=8,
        free_hbm=1e9, cost_model=jplan.CostModel(
            allreduce_gb_s=0.001, compress_overhead_s=1e-7)))
    assert p.wire_compress == "topk:0.01"
    o = tst.GradientDescent(device=CPU)
    tplan.apply_gram_knobs(o, p)
    assert o.ingest_wire_compress == p.wire_compress
    tplan.reset_plan_owned_gram_knobs(o)
    assert o.ingest_wire_compress is None
    o2 = tst.GradientDescent(device=CPU).set_ingest_options(
        wire_compress="topk:0.2").set_residency(6).set_superstep(16)
    Plan("host_streamed", "t", superstep=4, residency=2,
         wire_compress="topk:0.01").apply(o2)
    assert (o2.ingest_wire_compress, o2.resident_cadence, o2.superstep) == \
        ("topk:0.2", 6, 16)
    o3 = tst.GradientDescent(device=CPU)
    Plan("host_streamed", "t", superstep=8, residency=4).apply(o3)
    assert (o3.superstep, o3.resident_cadence) == (8, 4)
    Plan("resident_stock", "t").apply(o3)
    assert (o3.superstep, o3.resident_cadence) == (1, 0)


# ---- the seeded parity grid -------------------------------------------------

def _grid_cases(count: int, seed: int = 17):
    """Seeded cases over every argument of ``plan``, plus the boundary
    cases: a dataset exactly at the budget, one byte over, a build that
    amortizes exactly at the run length, and the partial-residency gain
    at its floor."""
    r = np.random.default_rng(seed)
    out = []
    for _ in range(count):
        d = int(r.choice([8, 64, 500, 1000, 4096, 47_236, 100_000]))
        n = int(10 ** r.uniform(3, 8.5))
        out.append(dict(
            n=n, d=d, itemsize=int(r.choice([2, 4, 8])),
            gram_able=bool(r.integers(2)),
            sampling=str(r.choice(["bernoulli", "indexed", "sliced"])),
            mini_batch_fraction=float(r.choice(
                [1.0, 0.5, 0.1, 0.01, float(r.uniform(0.001, 1.0))])),
            num_iterations=int(r.choice([1, 20, 100, 1000, 100_000])),
            n_devices=int(r.choice([1, 1, 2, 4, 8])),
            free_hbm=float(10 ** r.uniform(5, 11)),
            host_resident_ok=bool(r.integers(4)),
            force=(None if r.integers(3) else str(r.choice(SCHEDULES))),
            checkpoint_every=int(r.choice([1, 5, 10, 64, 1000]))))
    # boundaries: fit exactly at the budget and one byte over it
    for n, d, it in ((1_000_000, 1000, 2), (3_000_000, 1000, 2),
                     (200_000, 16, 4)):
        exact = n * d * it + n * 4.0
        for free in (exact, exact - 1.0):
            for gram in (False, True):
                out.append(dict(n=n, d=d, itemsize=it, gram_able=gram,
                                sampling="sliced", mini_batch_fraction=0.1,
                                num_iterations=1000, free_hbm=free))
    # the build amortizing exactly at (and one short of) the run length
    base = jplan.plan(3_000_000, 1000, itemsize=2, gram_able=True,
                      mini_batch_fraction=1.0, num_iterations=10 ** 9,
                      free_hbm=12 * GB)
    amort = base.estimates["build_amortize_iters"]
    for it in (math.ceil(amort), math.floor(amort)):
        out.append(dict(n=3_000_000, d=1000, itemsize=2, gram_able=True,
                        mini_batch_fraction=1.0, num_iterations=it,
                        free_hbm=12 * GB))
    # partial residency at its minimum gain, and a window that just fits
    for free in (2.0e9, 2.1e9, 2.2e9, 20e9 * 0.05 + 4e7):
        out.append(dict(n=10_000_000, d=1000, itemsize=2, gram_able=False,
                        sampling="sliced", mini_batch_fraction=0.1,
                        num_iterations=1000, free_hbm=free))
    # full-batch streams with residency at the checkpoint cadences
    for ce in (1, 3, 4, 10, 64):
        out.append(dict(n=200_000, d=16, itemsize=4, sampling="bernoulli",
                        mini_batch_fraction=1.0, num_iterations=1000,
                        free_hbm=8e6, checkpoint_every=ce))
    return out


GRID = _grid_cases(220)


@pytest.mark.parametrize("case", GRID, ids=[f"g{i}" for i in range(len(GRID))])
def test_plan_grid_matches_the_jax_package(case):
    try:
        both(case.pop("n"), case.pop("d"), **case)
    except ValueError as e:  # forced partial residency: the same error
        assert "partial_residency cannot be forced" in str(e)


def _qn_grid(count: int, seed: int = 23):
    r = np.random.default_rng(seed)
    out = []
    for _ in range(count):
        out.append(dict(
            n=int(10 ** r.uniform(3, 9)),
            d=int(r.choice([8, 100, 1000, 4096, 100_000])),
            dtype=str(r.choice(["float16", "float32", "float64", "int32"])),
            gradient=r.choice([None, "LogisticGradient", "HingeGradient"]),
            iters=int(r.choice([1, 3, 20, 100, 1000])),
            mesh=int(r.choice([1, 1, 4, 8])),
            free_hbm=float(10 ** r.uniform(6, 11)),
            force=(None if r.integers(3) else str(r.choice(
                jplan.QN_SCHEDULES)))))
    return out


QN_GRID = _qn_grid(60)


@pytest.mark.parametrize("case", QN_GRID,
                         ids=[f"q{i}" for i in range(len(QN_GRID))])
def test_plan_quasi_newton_grid_matches_the_jax_package(case):
    from tpu_sgd import data_mesh as jdata_mesh
    from tpu_sgd_torch.parallel import DATA_AXIS, Mesh

    t, j = _lbfgs(case["gradient"], max_num_iterations=case["iters"])
    if case["mesh"] > 1:
        t.mesh = Mesh({DATA_AXIS: case["mesh"]})
        import jax

        j.set_mesh(jdata_mesh(jax.devices()[:case["mesh"]]))
    X = _ShapeOnly((case["n"], case["d"]), case["dtype"])
    try:
        qn_both((t, j), X, free_hbm=case["free_hbm"], force=case["force"])
    except ValueError as e:
        assert "cannot apply" in str(e)


@pytest.mark.parametrize("seed", range(6))
def test_choosers_grid_matches_the_jax_package(seed):
    r = np.random.default_rng(100 + seed)
    for _ in range(40):
        n = int(10 ** r.uniform(2, 9))
        d = int(10 ** r.uniform(0.5, 7.5))
        it = int(r.choice([2, 4]))
        nd = int(r.choice([1, 2, 4, 8, 16]))
        frac = float(r.uniform(0.001, 1.0))
        budget = float(10 ** r.uniform(4, 11))
        assert tplan.choose_replicas(n, d, it, nd, frac, JCM) == \
            jplan.choose_replicas(n, d, it, nd, frac)
        s = int(r.integers(1, 9))
        assert tplan.choose_replicas(n, d, it, nd, frac, JCM,
                                     store_shards=s) == \
            jplan.choose_replicas(n, d, it, nd, frac, store_shards=s)
        w = int(r.integers(1, 9))
        assert tplan.choose_store_shards(n, d, it, nd, w, frac, JCM) == \
            jplan.choose_store_shards(n, d, it, nd, w, frac)
        rc = int(r.integers(4))
        assert tplan.choose_wire_compress(d, nd, JCM, rc) == \
            jplan.choose_wire_compress(d, nd, resident_cadence=rc)
        k, ce = int(r.integers(1, 70)), int(r.integers(1, 500))
        assert tplan.choose_residency(k, ce) == jplan.choose_residency(k, ce)
        iter_s = float(10 ** r.uniform(-6, 1))
        stage = float(r.choice([math.inf, budget]))
        assert tplan.choose_superstep(n, d, it, iter_s, stage, JCM) == \
            jplan.choose_superstep(n, d, it, iter_s, stage)
        assert choose_block_rows(n, d, budget) == \
            jplan.choose_block_rows(n, d, budget)
        assert tplan.choose_streamed_build(n, d, it, budget) == \
            jplan.choose_streamed_build(n, d, it, budget)
        assert tplan._stack_bytes(n, max(1, n // 7), d) == \
            jplan._stack_bytes(n, max(1, n // 7), d)
        tn, hot = int(10 ** r.uniform(0, 7)), float(r.uniform(0.01, 1))
        ws = None if r.integers(2) else int(r.integers(1, 5000))
        assert tplan.choose_slab_capacity(tn, d, it, budget, ws, hot,
                                          JCM) == \
            jplan.choose_slab_capacity(tn, d, it, budget, ws, hot)


# ---- the port's own constants -------------------------------------------------

def test_measured_defaults_are_the_cards_not_copies():
    """The measured fields' defaults come from the H100; the policy
    fractions keep the JAX package's values."""
    t, j = tplan.CostModel(), jplan.CostModel()
    for f in ("hbm_gb_s", "mxu_f32_flops", "build_overhead_s",
              "gram_iter_overhead_s", "host_feed_gb_s", "hbm_bytes",
              "dispatch_overhead_s", "allreduce_gb_s",
              "compress_overhead_s"):
        assert getattr(t, f) != getattr(j, f), f
        # a cost may be 0 (K = 8 saved nothing on the card); a rate not
        assert getattr(t, f) > 0 or f == "dispatch_overhead_s", f
    assert t.dispatch_overhead_s >= 0
    for f in ("hbm_safety", "min_resident_gain", "superstep_dispatch_frac",
              "wire_compress_frac", "sparse_merge_density"):
        assert getattr(t, f) == getattr(j, f), f


# ---- hook twins -----------------------------------------------------------------

def test_normal_auto_streams_beyond_budget(rng, monkeypatch, caplog):
    monkeypatch.setattr(tplan, "device_budget",
                        lambda *a, **k: (8e3, "test"))
    n, d = 1024, 8
    X = rng.normal(size=(n, d)).astype(np.float32)
    y = rng.normal(size=(n,)).astype(np.float32)
    w0 = np.zeros(d, np.float32)
    with caplog.at_level(logging.INFO, logger="tpu_sgd_torch.plan"):
        w_auto = tst.NormalEquations(reg_param=0.01, device=CPU).optimize(
            (X, y), w0)
    assert any("normal host_streamed" in r.message for r in caplog.records)
    w_forced = tst.NormalEquations(reg_param=0.01, device=CPU) \
        .set_host_streaming(False).optimize((X, y), w0)
    np.testing.assert_allclose(w_auto.numpy(), w_forced.numpy(), rtol=1e-4,
                               atol=1e-5)
    # a tensor on the run's device is not placed, and small data stays
    monkeypatch.undo()
    caplog.clear()
    with caplog.at_level(logging.INFO, logger="tpu_sgd_torch.plan"):
        tst.NormalEquations(device=CPU).optimize((X, y), w0)
    assert not caplog.records


def test_normal_auto_placement_logs_like_the_jax_package(rng, monkeypatch,
                                                         caplog):
    from tpu_sgd.optimize.normal import NormalEquations as JNormal

    monkeypatch.setattr(tplan, "device_budget",
                        lambda *a, **k: (8e3, "test"))
    monkeypatch.setattr(jplan, "device_budget",
                        lambda *a, **k: (8e3, "test"))
    X = rng.normal(size=(512, 6)).astype(np.float32)
    y = rng.normal(size=(512,)).astype(np.float32)
    w0 = np.zeros(6, np.float32)
    with caplog.at_level(logging.INFO):
        tw = tst.NormalEquations(device=CPU).optimize((X, y), w0)
        jw = JNormal().optimize((X, y), w0)
    lines = {r.name: r.message for r in caplog.records
             if "normal host_streamed" in r.message}
    assert lines["tpu_sgd_torch.plan"] == lines["tpu_sgd.plan"]
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=2e-4,
                               atol=2e-3)


def test_multinomial_intercept_honors_schedule_contract(rng):
    X = rng.normal(size=(200, 4)).astype(np.float32)
    y = (rng.integers(0, 3, size=200)).astype(np.float32)
    alg = tst.LogisticRegressionWithLBFGS(max_num_iterations=3, device=CPU)
    alg.set_num_classes(3).set_intercept(True)
    alg.set_schedule("resident_gram")
    with pytest.raises(ValueError):
        alg.run((X, y))
    # the zero-flag run on the same branch plans
    alg2 = tst.LogisticRegressionWithLBFGS(max_num_iterations=3, device=CPU)
    alg2.set_num_classes(3).set_intercept(True).run((X, y))
    assert alg2.optimizer.last_plan.schedule == "resident_stock"


def test_plan_for_without_a_card_never_budgets_the_cpu(rng):
    """``device=None`` is the card: without one the budget, ``plan``
    and ``plan_for`` raise; they never budget the CPU in its place."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    X = rng.normal(size=(64, 4)).astype(np.float32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        plan_for(tst.GradientDescent(), X, X[:, 0])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tplan.plan_quasi_newton(tst.LBFGS(), X, X[:, 0])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tplan.choose_slab_capacity(100, 8)
    assert plan(64, 4, device=CPU).estimates["budget_source"] == "fallback"


# ---- whole zero-flag runs in both packages ----------------------------------

def _both_budgets(monkeypatch, free=12.8e9):
    """One budget and one set of constants for both packages, so the plan
    lines can be equal."""
    monkeypatch.setattr(tplan, "DEFAULT_COST_MODEL", JCM)
    monkeypatch.setattr(tplan, "device_budget",
                        lambda *a, **k: (free, "memory_stats"))
    monkeypatch.setattr(jplan, "device_budget",
                        lambda *a, **k: (free, "memory_stats"))


def _plan_lines(caplog):
    return {r.name: r.message for r in caplog.records
            if r.message.startswith("plan: ")}


def _zero_flag(caplog, tcall, jcall):
    with caplog.at_level(logging.INFO):
        t = tcall()
        j = jcall()
    lines = _plan_lines(caplog)
    assert lines["tpu_sgd_torch.plan"] == lines["tpu_sgd.plan"]
    return t, j


def test_zero_flag_full_batch_sgd_matches_the_jax_package(monkeypatch,
                                                          caplog):
    import tpu_sgd.models as jm
    from tpu_sgd_torch.utils.mlutils import linear_data

    _both_budgets(monkeypatch)
    X, y, _ = linear_data(2000, 10, seed=31)
    t, j = _zero_flag(
        caplog,
        lambda: tst.LinearRegressionWithSGD.train((X, y), 40, 0.5,
                                                  device=CPU),
        lambda: jm.LinearRegressionWithSGD.train((X, y), 40, 0.5))
    np.testing.assert_allclose(t.weights.numpy(), np.asarray(j.weights),
                               rtol=2e-4, atol=2e-3)


def test_zero_flag_sampled_sgd_matches_the_jax_objective(monkeypatch,
                                                         caplog):
    import tpu_sgd.models as jm
    from tpu_sgd_torch.utils.mlutils import logistic_data

    _both_budgets(monkeypatch)
    X, y, _ = logistic_data(4000, 8, seed=32)
    t, j = _zero_flag(
        caplog,
        lambda: tst.LogisticRegressionWithSGD.train((X, y), 80, 1.0, 0.1,
                                                    device=CPU),
        lambda: jm.LogisticRegressionWithSGD.train((X, y), 80, 1.0, 0.1))

    def objective(w):
        m = X @ np.asarray(w, np.float64)
        return float(np.mean(np.logaddexp(0.0, m) - y * m))

    assert objective(t.weights.numpy()) <= 1.01 * objective(j.weights)


def test_zero_flag_lbfgs_matches_the_jax_package(monkeypatch, caplog):
    import tpu_sgd.models as jm
    from tpu_sgd_torch.utils.mlutils import linear_data

    _both_budgets(monkeypatch)
    X, y, _ = linear_data(3000, 12, seed=33)
    t, j = _zero_flag(
        caplog,
        lambda: tst.LinearRegressionWithLBFGS.train((X, y), device=CPU),
        lambda: jm.LinearRegressionWithLBFGS.train((X, y)))
    np.testing.assert_allclose(t.weights.numpy(), np.asarray(j.weights),
                               rtol=2e-4, atol=2e-3)


def test_zero_flag_beyond_budget_streams_like_the_jax_package(monkeypatch,
                                                              caplog):
    """A budget below the data: both packages stream the same way (the
    host_streamed schedule, K and all), and land on the same weights."""
    import tpu_sgd.models as jm
    from tpu_sgd_torch.utils.mlutils import linear_data

    _both_budgets(monkeypatch, free=50e3)
    X, y, _ = linear_data(2000, 10, seed=34)
    t, j = _zero_flag(
        caplog,
        lambda: tst.LinearRegressionWithSGD.train((X, y), 20, 0.5,
                                                  device=CPU),
        lambda: jm.LinearRegressionWithSGD.train((X, y), 20, 0.5))
    assert "host_streamed" in _plan_lines(caplog)["tpu_sgd_torch.plan"]
    np.testing.assert_allclose(t.weights.numpy(), np.asarray(j.weights),
                               rtol=2e-4, atol=2e-3)

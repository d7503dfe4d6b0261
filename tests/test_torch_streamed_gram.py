"""Parity of the port's streamed statistics (``tpu_sgd_torch/ops/gram.py``:
``build_streamed``, ``_streamed_totals`` and their resume checkpoints; the
optimizers' ``set_streamed_stats``; ``NormalEquations.set_host_streaming``)
with the JAX package on the CPU: the single-device twins of the streamed
cases of ``tests/test_gram.py``, ``tests/test_normal.py`` and
``tests/test_io.py``, with the same numpy inputs on both sides.

Tolerances:
  * within the port, bitwise: the streamed stack equals the resident
    ``build`` over the same whole blocks for any ``batch_rows`` (f32, and
    bf16 data on its own wire); a resumed build equals an uninterrupted
    one (prefix and totals); ``pipeline=False`` equals ``pipeline=True`` on
    an f32 wire; the streamed totals equal the resident totals;
  * against the JAX package's streamed build, which carries f32 across
    chunks where the port carries f64: the resident-build tolerance of
    ``tests/test_torch_gram.py``, rtol 1e-5 / atol 1e-3 (``Pb`` atol
    1e-4);
  * chunk grids and counts exact; SGD runs rtol 1e-4 against the JAX
    run on the same windows; L-BFGS and OWL-QN runs bitwise against the
    port's resident statistics, and against the JAX run the first three
    entries at the loss tier (rtol 2e-4) and the objective within 1.01x
    (the JAX package's f32 statistics jitter near the optimum); the
    normal solve rtol 1e-4 / atol 1e-5, as the JAX file holds its
    streamed solve to its resident one.

The meshed and compressed cases are twinned in
``tests/test_torch_mesh_streamed.py``.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_sgd as jt
from tpu_sgd.io import plan_chunks as jplan_chunks
from tpu_sgd.ops import gram as jgram
from tpu_sgd.optimize import normal as jn
import tpu_sgd_torch as tst
from tpu_sgd_torch.io import plan_chunks
from tpu_sgd_torch.ops import gram as tgram
from tpu_sgd_torch.optimize import normal as tn
from tpu_sgd_torch.reliability import failpoints as fp

CPU = "cpu"
TGram = tgram.GramLeastSquaresGradient
JGram = jgram.GramLeastSquaresGradient
LEAVES = ("PG", "Pb", "Pyy", "G_tot", "b_tot", "yy_tot")


@pytest.fixture
def rng():
    return np.random.default_rng(11)


def _data(rng, n=1000, d=12, noise=0.05):
    X = rng.normal(size=(n, d)).astype(np.float32)
    w = rng.uniform(-1, 1, d).astype(np.float32)
    y = (X @ w + noise * rng.normal(size=n)).astype(np.float32)
    return X, y


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _bitwise(a, b):
    for leaf in LEAVES:
        assert torch.equal(getattr(a.data, leaf), getattr(b.data, leaf)), leaf


def _streamed(X, y, **kw):
    return TGram.build_streamed(X, y, device=CPU, **kw)


class _Stop(RuntimeError):
    pass


def _dies_at(monkeypatch, name, k):
    """Make the module function ``gram.<name>`` raise on its k-th call."""
    real = getattr(tgram, name)
    calls = {"n": 0}

    def dying(*args, **kw):
        calls["n"] += 1
        if calls["n"] == k:
            raise _Stop("stopped in the build")
        return real(*args, **kw)

    monkeypatch.setattr(tgram, name, dying)
    return lambda: monkeypatch.setattr(tgram, name, real)


# ---- the streamed prefix build ---------------------------------------------

@pytest.mark.parametrize("batch_rows", [None, 64, 200, 448, 4096])
def test_build_streamed_matches_resident_build(rng, batch_rows):
    """The streamed stack is the resident build's over the whole blocks,
    bit for bit, whatever the chunk; the JAX package's streamed stack
    agrees to the resident-build tolerance."""
    X, y = _data(rng)
    gs = _streamed(X, y, block_rows=64, batch_rows=batch_rows)
    n_use = (1000 // 64) * 64  # 960
    g0 = TGram.build(X[:n_use], y[:n_use], block_rows=64, device=CPU)
    assert gs.data.X is None
    assert gs.data.shape == (n_use, 12) and gs.data.block_rows == 64
    _bitwise(gs, g0)
    js = JGram.build_streamed(X, y, block_rows=64, batch_rows=batch_rows)
    np.testing.assert_allclose(_np(gs.data.PG), np.asarray(js.data.PG),
                               rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(_np(gs.data.Pb), np.asarray(js.data.Pb),
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(_np(gs.data.G_tot), np.asarray(js.data.G_tot),
                               rtol=1e-5, atol=1e-3)


def test_build_streamed_bf16_data_and_wire(rng):
    """bf16 rows (a CPU tensor) and f32 rows on a bf16 wire both equal the
    resident build over the bf16 rows; the logical dtype is the data's."""
    X, y = _data(rng, n=700, d=6)
    Xb = torch.as_tensor(X).to(torch.bfloat16)
    ref = TGram.build(Xb[:640], y[:640], block_rows=64, device=CPU)
    for src, kw in ((Xb, {}), (X, {"wire_dtype": "bfloat16"})):
        g = _streamed(src, y, block_rows=64, batch_rows=192, **kw)
        _bitwise(g, ref)
    assert _streamed(Xb, y, block_rows=64).data.dtype == torch.bfloat16
    assert _streamed(X, y, block_rows=64,
                     wire_dtype="bfloat16").data.dtype == torch.float32


def test_aligned_window_math_vs_numpy(rng):
    X = rng.normal(size=(512, 8)).astype(np.float32)
    w = rng.uniform(-1, 1, 8).astype(np.float32)
    y = (X @ w + 0.1 * rng.normal(size=512)).astype(np.float32)
    gram = _streamed(X, y, block_rows=64)
    m, start = 130, 70  # 2 blocks from block 1: rows [64, 192)
    g1, l1, c1 = gram.window_sums(gram.data, torch.as_tensor(y),
                                  torch.as_tensor(w), start, m)
    jg_ = JGram.build_streamed(X, y, block_rows=64)
    jg1, jl1, jc1 = jg_.window_sums(jg_.data, jnp.asarray(y), jnp.asarray(w),
                                    jnp.int32(start), m)
    rows = slice(64, 192)
    r = X[rows] @ w - y[rows]
    np.testing.assert_allclose(_np(g1), X[rows].T @ r, rtol=1e-4, atol=1e-2)
    np.testing.assert_allclose(_np(g1), np.asarray(jg1), rtol=2e-4,
                               atol=2e-3)
    assert float(l1) == pytest.approx(0.5 * float(r @ r), rel=1e-4)
    assert float(l1) == pytest.approx(float(jl1), rel=2e-4)
    assert float(c1) == float(jc1) == 128


@pytest.mark.parametrize("pipeline", [True, False])
def test_build_streamed_resumable_bitwise(rng, tmp_path, monkeypatch,
                                          pipeline):
    """A build stopped in its 3rd chunk resumes from its parts (the prefix
    rows and the f64 carry) to the uninterrupted build's bits, and cleans
    its parts up."""
    n, d, B = 1000, 6, 32
    X = rng.normal(size=(n, d)).astype(np.float32)
    y = rng.normal(size=(n,)).astype(np.float32)
    kw = dict(block_rows=B, batch_rows=128, pipeline=pipeline)
    ref = _streamed(X, y, **kw)
    resume_dir = str(tmp_path / "ckpt")
    restore = _dies_at(monkeypatch, "_chunk_prefix", 3)
    with pytest.raises(_Stop):
        _streamed(X, y, resume_dir=resume_dir, **kw)
    restore()
    with open(os.path.join(resume_dir, "meta.json")) as f:
        meta = json.load(f)
    assert meta["high_water_rows"] == 2 * 128  # two chunks persisted
    assert meta["carry_dtype"] == "float64"
    resumed = _streamed(X, y, resume_dir=resume_dir, **kw)
    _bitwise(resumed, ref)
    assert not os.path.exists(resume_dir)


def test_build_streamed_resume_after_a_feed_fault(rng, tmp_path):
    """A fault in the prefetch worker (the ``io.prefetch.produce``
    failpoint, the way the card run stops a build) stops the build after
    the chunks before it; the resume is bitwise."""
    X, y = _data(rng, n=1024, d=5)
    kw = dict(block_rows=32, batch_rows=128)
    ref = _streamed(X, y, **kw)
    resume_dir = str(tmp_path / "ckpt")
    with fp.inject_faults({"io.prefetch.produce": fp.fail_nth(4)}):
        with pytest.raises(fp.FaultInjected):
            _streamed(X, y, resume_dir=resume_dir, **kw)
    with open(os.path.join(resume_dir, "meta.json")) as f:
        assert json.load(f)["high_water_rows"] == 3 * 128
    _bitwise(_streamed(X, y, resume_dir=resume_dir, **kw), ref)


def test_build_streamed_resume_rejects_mismatched_geometry(rng, tmp_path):
    X = rng.normal(size=(256, 4)).astype(np.float32)
    y = rng.normal(size=(256,)).astype(np.float32)
    resume_dir = str(tmp_path / "ckpt")
    ck = tgram._PrefixBuildCheckpoint(resume_dir, n_used=256, d=4, B=32,
                                      sd_name="float32", chunk=64)
    z = torch.zeros
    ck.save_part(0, (z((2, 4, 4)), z((2, 4), dtype=torch.float64),
                     z((2,), dtype=torch.float64)),
                 (z((4, 4), dtype=torch.float64), z((4,), dtype=torch.float64),
                  z((), dtype=torch.float64)), high_water_rows=64)
    with pytest.raises(ValueError, match="different build"):
        _streamed(X, y, block_rows=16, resume_dir=resume_dir)


def test_build_streamed_resume_rejects_different_dataset(rng, tmp_path,
                                                         monkeypatch):
    n, d, B = 512, 5, 32
    XA = rng.normal(size=(n, d)).astype(np.float32)
    XB = rng.normal(size=(n, d)).astype(np.float32)  # same shape and dtype
    y = rng.normal(size=(n,)).astype(np.float32)
    resume_dir = str(tmp_path / "ckpt")
    restore = _dies_at(monkeypatch, "_chunk_prefix", 2)
    with pytest.raises(_Stop):
        _streamed(XA, y, block_rows=B, batch_rows=64, resume_dir=resume_dir)
    restore()
    with pytest.raises(ValueError, match="different build"):
        _streamed(XB, y, block_rows=B, batch_rows=64, resume_dir=resume_dir)


def test_build_streamed_refuses_a_resume_dir_of_the_jax_package(rng,
                                                                tmp_path):
    """A JAX build's parts carry f32 prefix rows and no carry dtype: the
    port refuses to resume from them."""
    X, y = _data(rng, n=512, d=5)
    resume_dir = str(tmp_path / "ckpt")
    real = jgram._chunk_prefix
    calls = {"n": 0}

    def dying(*args):
        calls["n"] += 1
        if calls["n"] == 2:
            raise RuntimeError("stopped")
        return real(*args)

    jgram._chunk_prefix = dying
    try:
        with pytest.raises(RuntimeError, match="stopped"):
            JGram.build_streamed(X, y, block_rows=32, batch_rows=64,
                                 resume_dir=resume_dir)
    finally:
        jgram._chunk_prefix = real
    with pytest.raises(ValueError, match="records no carry dtype"):
        _streamed(X, y, block_rows=32, batch_rows=64, resume_dir=resume_dir)


def test_build_rejects_bad_rank_and_streamed_int_features(rng):
    with pytest.raises(ValueError, match="non-empty"):
        TGram.build(np.zeros((8,), np.float32), np.zeros((8,), np.float32),
                    device=CPU)
    with pytest.raises(ValueError, match="non-empty"):
        _streamed(np.zeros((8,), np.float32), np.zeros((8,), np.float32))
    with pytest.raises(ValueError, match="non-empty"):
        _streamed(np.zeros((0, 3), np.float32), np.zeros((0,), np.float32))
    # int features through the streamed builder: f32 statistics
    Xi = rng.integers(0, 3, size=(256, 6)).astype(np.int32)
    yi = rng.normal(size=256).astype(np.float32)
    g = _streamed(Xi, yi, block_rows=64)
    assert g.data.dtype == torch.float32
    assert g.data.PG.dtype == torch.float32
    _bitwise(g, TGram.build(Xi, yi, block_rows=64, device=CPU))
    jg_ = JGram.build_streamed(Xi, yi, block_rows=64)
    np.testing.assert_allclose(_np(g.data.PG), np.asarray(jg_.data.PG),
                               rtol=1e-5, atol=1e-3)


# ---- the streamed totals ----------------------------------------------------

@pytest.mark.parametrize("B,chunk", [(128, 256), (128, 1024), (100, 300)])
def test_streamed_totals_equal_the_resident_totals(rng, B, chunk):
    """Every row counts (the ragged last block too); bitwise the resident
    totals and the plain feed's, and the JAX package's to the
    resident-build tolerance."""
    X, y = _data(rng, n=1500, d=6)
    got = TGram._streamed_totals(X, y, B, torch.float32, chunk, device=CPU)
    ref = TGram._total_stats(torch.as_tensor(X), torch.as_tensor(y), B=B,
                             stats_dtype=torch.float32)
    plain = TGram._streamed_totals(X, y, B, torch.float32, chunk,
                                   device=CPU, pipeline=False)
    for a, b, c in zip(got, ref, plain):
        assert torch.equal(a, b) and torch.equal(a, c)
    jgot = JGram._streamed_totals(X, y, B, jnp.float32, chunk)
    np.testing.assert_allclose(_np(got[0]), np.asarray(jgot[0]), rtol=1e-5,
                               atol=1e-3)
    np.testing.assert_allclose(_np(got[1]), np.asarray(jgot[1]), rtol=1e-5,
                               atol=1e-4)
    assert float(got[2]) == pytest.approx(float(jgot[2]), rel=1e-5)


def test_streamed_totals_resumable_bitwise(rng, tmp_path, monkeypatch):
    """A totals pass stopped mid-way resumes from its carry checkpoint to
    the same bits."""
    n, d = 1500, 6
    X = rng.normal(size=(n, d)).astype(np.float32)
    y = rng.normal(size=(n,)).astype(np.float32)
    sd = torch.float32
    ref = TGram._streamed_totals(X, y, 128, sd, 256, device=CPU)
    resume_dir = str(tmp_path / "totals")
    restore = _dies_at(monkeypatch, "_acc_totals", 3)
    with pytest.raises(_Stop):
        TGram._streamed_totals(X, y, 128, sd, 256, device=CPU,
                               resume_dir=resume_dir, checkpoint_every=1)
    restore()
    assert os.path.exists(os.path.join(resume_dir, "totals.npz"))
    got = TGram._streamed_totals(X, y, 128, sd, 256, device=CPU,
                                 resume_dir=resume_dir)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    assert not os.path.exists(resume_dir)  # finalized


def test_streamed_totals_resume_rejects_different_dataset(rng, tmp_path,
                                                          monkeypatch):
    n, d = 800, 5
    XA = rng.normal(size=(n, d)).astype(np.float32)
    XB = rng.normal(size=(n, d)).astype(np.float32)
    y = rng.normal(size=(n,)).astype(np.float32)
    resume_dir = str(tmp_path / "totals")
    restore = _dies_at(monkeypatch, "_acc_totals", 2)
    with pytest.raises(_Stop):
        TGram._streamed_totals(XA, y, 64, torch.float32, 128, device=CPU,
                               resume_dir=resume_dir, checkpoint_every=1)
    restore()
    with pytest.raises(ValueError, match="different build"):
        TGram._streamed_totals(XB, y, 64, torch.float32, 128, device=CPU,
                               resume_dir=resume_dir)


def test_streamed_totals_chunking_equals_the_jax_policy():
    for args in ((4100, 8192, 512), (100_000, 8192, 500), (10, 8192, None),
                 (1_000_000, 8192, None), (5000, 64, 130)):
        assert tgram.streamed_totals_chunking(*args) == \
            jgram.streamed_totals_chunking(*args)


# ---- the normal equations ---------------------------------------------------

def test_normal_host_streamed_matches_resident(rng):
    """The solve from host-streamed totals matches the resident solve and
    the JAX package's streamed solve; the 4-row tail is a sub-block."""
    n, d = 4100, 12
    B, chunk = tgram.streamed_totals_chunking(n, 8192, 512)
    assert (B, chunk) == (512, 512)
    assert n % chunk != 0 and n % chunk < B
    X, y = _data(rng, n=n, d=d)
    w0 = np.zeros(d, np.float32)
    w_res = tn.NormalEquations(reg_param=0.01, device=CPU).optimize(
        (X, y), w0)
    opt = tn.NormalEquations(reg_param=0.01, device=CPU).set_host_streaming(
        True, batch_rows=512)
    w_str = opt.optimize((X, y), w0)
    j_str = jn.NormalEquations(reg_param=0.01).set_host_streaming(
        True, batch_rows=512).optimize((X, y), w0)
    np.testing.assert_allclose(_np(w_str), _np(w_res), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(_np(w_str), np.asarray(j_str), rtol=1e-4,
                               atol=1e-5)
    assert opt.loss_history.shape == (1,)
    B2, chunk2 = tgram.streamed_totals_chunking(100_000, 8192, 500)
    assert B2 == 500 and chunk2 == 500


def test_normal_host_streaming_batch_rows_validation(rng):
    with pytest.raises(ValueError, match="batch_rows must be positive"):
        tn.NormalEquations(device=CPU).set_host_streaming(True, batch_rows=0)
    X, y = _data(rng, n=64, d=3)
    with pytest.raises(ValueError, match="initial_weights has length"):
        tn.NormalEquations(device=CPU).set_host_streaming(True).optimize(
            (X, y), np.zeros(4, np.float32))
    # None is AUTO placement: these few rows fit the budget, so resident
    opt = tn.NormalEquations(device=CPU).set_host_streaming(None)
    assert opt.host_streaming is None
    np.testing.assert_allclose(
        _np(opt.optimize((X, y), np.zeros(3, np.float32))),
        _np(tn.NormalEquations(device=CPU).optimize(
            (X, y), np.zeros(3, np.float32))), rtol=0, atol=0)


def test_normal_streamed_resume_dir_end_to_end(rng, tmp_path):
    """``resume_dir`` threads through the public solver, a no-op on an
    uninterrupted pass."""
    n, d = 1200, 7
    X = rng.normal(size=(n, d)).astype(np.float32)
    y = rng.normal(size=(n,)).astype(np.float32)
    w0 = np.zeros(d, np.float32)
    w_plain = tn.NormalEquations(reg_param=0.01, device=CPU) \
        .set_host_streaming(True, batch_rows=256).optimize((X, y), w0)
    w_ckpt = tn.NormalEquations(reg_param=0.01, device=CPU) \
        .set_host_streaming(True, batch_rows=256,
                            resume_dir=str(tmp_path / "nrm")) \
        .optimize((X, y), w0)
    assert torch.equal(w_ckpt, w_plain)
    assert not os.path.exists(tmp_path / "nrm")


def test_normal_streamed_resume_after_a_feed_fault(rng, tmp_path):
    """The card run's resume of the totals: a fault in the feed stops the
    pass after a save, and the resumed solve is bitwise."""
    X, y = _data(rng, n=2048, d=5)
    w0 = np.zeros(5, np.float32)

    def solve(**kw):
        return tn.NormalEquations(reg_param=0.01, device=CPU) \
            .set_host_streaming(True, batch_rows=128, **kw) \
            .optimize((X, y), w0)

    ref = solve()
    resume_dir = str(tmp_path / "nrm")
    with fp.inject_faults({"io.prefetch.produce": fp.fail_nth(7)}):
        with pytest.raises(fp.FaultInjected):
            solve(resume_dir=resume_dir)
    assert os.path.exists(os.path.join(resume_dir, "totals.npz"))
    assert torch.equal(solve(resume_dir=resume_dir), ref)


# ---- the ingest pipeline of the streamed builds -----------------------------

def test_plan_chunks_honors_streamed_totals_caps():
    B, chunk = tgram.streamed_totals_chunking(100_000, 8192, 500)
    assert B <= 500 and chunk <= 500  # the cap is exact
    plan = plan_chunks(100_000, chunk, round_to=B)
    chunks = list(plan)
    assert all(c.rows == plan.chunk_rows <= 500 for c in chunks)
    assert chunks[-1].stop == 100_000
    assert plan.chunk_rows % B == 0
    jchunks = list(jplan_chunks(100_000, chunk, round_to=B))
    assert [(c.start, c.stop, c.rows) for c in chunks] == \
        [(c.start, c.stop, c.rows) for c in jchunks]


def test_streamed_build_resume_rejects_wire_change(rng, tmp_path,
                                                   monkeypatch):
    """A build stopped under one wire refuses to resume under another."""
    X, y = _data(rng, n=512, d=5)
    resume_dir = str(tmp_path / "ckpt")
    restore = _dies_at(monkeypatch, "_chunk_prefix", 2)
    with pytest.raises(_Stop):
        _streamed(X, y, block_rows=32, batch_rows=64, resume_dir=resume_dir)
    restore()
    with pytest.raises(ValueError, match="different build"):
        _streamed(X, y, block_rows=32, batch_rows=64, resume_dir=resume_dir,
                  wire_dtype="bfloat16")


def test_streamed_stats_pipeline_off_matches_on(rng):
    """``set_streamed_stats`` trains bitwise the same through the
    pipelined and the plain feed (f32 wire), and as the JAX package's run
    to the trajectory tier."""
    X, y = _data(rng, n=1024, d=8)

    def run(pipeline, depth=2):
        opt = (tst.GradientDescent(device=CPU).set_num_iterations(10)
               .set_step_size(0.2).set_streamed_stats(True, block_rows=64))
        opt.set_ingest_options(pipeline=pipeline, prefetch_depth=depth)
        return opt.optimize_with_history((X, y), np.zeros(8, np.float32))

    w1, h1 = run(True)
    w0, h0 = run(False)
    w2, h2 = run(True, depth=0)
    assert torch.equal(w1, w0) and np.array_equal(h1, h0)
    assert torch.equal(w1, w2) and np.array_equal(h1, h2)
    jw, jh = jt.GradientDescent().set_num_iterations(10).set_step_size(0.2) \
        .set_streamed_stats(True, block_rows=64).optimize_with_history(
            (X, y), np.zeros(8, np.float32))
    np.testing.assert_allclose(h1, np.asarray(jh), rtol=1e-4)
    np.testing.assert_allclose(_np(w1), np.asarray(jw), rtol=5e-4, atol=5e-4)


# ---- the optimizers' front doors --------------------------------------------

def test_gd_streamed_stats_equals_resident_aligned(rng, monkeypatch):
    """Sliced ``set_streamed_stats`` is the resident aligned statistics run
    over the whole blocks, bit for bit (the same seed draws the same
    windows), and cached per ``(X, y)``."""
    X, y = _data(rng, n=2100, d=8)
    n_use = (2100 // 64) * 64

    def opt():
        return (tst.GradientDescent(device=CPU).set_num_iterations(12)
                .set_step_size(0.3).set_mini_batch_fraction(0.25)
                .set_sampling("sliced").set_seed(5))

    o = opt().set_streamed_stats(True, block_rows=64) \
        .set_gram_options(batch_rows=256)
    w_s, h_s = o.optimize_with_history((X, y), np.zeros(8, np.float32))
    entry = o._streamed_gram_entry
    o.optimize_with_history((X, y), np.zeros(8, np.float32))
    assert o._streamed_gram_entry is entry
    r = opt().set_sufficient_stats(True).set_gram_options(block_rows=64,
                                                          aligned=True)
    w_r, h_r = r.optimize_with_history(
        (torch.as_tensor(X[:n_use]), torch.as_tensor(y[:n_use])),
        np.zeros(8, np.float32))
    assert torch.equal(w_s, w_r) and np.array_equal(h_s, h_r)
    o.release_sufficient_stats()
    assert o._streamed_gram_entry is None


def test_lbfgs_and_owlqn_streamed_stats_match_jax(rng):
    """L-BFGS and OWL-QN from streamed statistics are the runs from the
    resident statistics of the whole blocks, bit for bit; against the JAX
    package: the descent (the first three entries) at the loss tier, rtol
    2e-4, and the objective matched within 1.01x.  Further on the JAX
    package's f32 statistics leave a loss that jitters by ~2e-4 near the
    optimum, where the port's f64 sums do not (ops/gram.py)."""
    X, y = _data(rng, n=1500, d=10)
    n_use = (1500 // 64) * 64
    w0 = np.zeros(10, np.float32)
    for tcls, jcls in ((tst.LBFGS, jt.LBFGS), (tst.OWLQN, jt.OWLQN)):
        kw = dict(max_num_iterations=10, convergence_tol=0.0, reg_param=1e-3)
        tw, th = tcls(device=CPU, **kw).set_streamed_stats(
            True, block_rows=64).optimize_with_history((X, y), w0)
        rw, rh = tcls(device=CPU, **kw).set_sufficient_stats(True) \
            .set_gram_options(block_rows=64).optimize_with_history(
                (torch.as_tensor(X[:n_use]), torch.as_tensor(y[:n_use])), w0)
        assert torch.equal(tw, rw) and np.array_equal(th, rh)
        jw, jh = jcls(**kw).set_streamed_stats(
            True, block_rows=64).optimize_with_history((X, y), w0)
        np.testing.assert_allclose(th[:3], np.asarray(jh)[:3], rtol=2e-4)
        assert th[-1] <= 1.01 * float(np.asarray(jh)[-1])


def test_streamed_stats_guards(rng):
    X, y = _data(rng, n=256, d=4)
    w0 = np.zeros(4, np.float32)
    Xs, ys, _ = tst.sparse_data(64, 4, nnz_per_row=2, seed=0)
    for make in (lambda: tst.GradientDescent(device=CPU),
                 lambda: tst.LBFGS(device=CPU)):
        with pytest.raises(NotImplementedError, match="dense rows"):
            make().set_streamed_stats(True).optimize_with_history(
                (Xs, ys), w0)
        with pytest.raises(ValueError, match="alternative"):
            make().set_streamed_stats(True).set_host_streaming(True) \
                .optimize_with_history((X, y), w0)
        with pytest.raises(NotImplementedError, match="least squares only"):
            make().set_gradient(tst.LogisticGradient()) \
                .set_streamed_stats(True).optimize_with_history((X, y), w0)
    with pytest.raises(NotImplementedError, match="sliced sampling"):
        tst.GradientDescent(device=CPU).set_streamed_stats(True) \
            .set_mini_batch_fraction(0.5).optimize_with_history((X, y), w0)
    with pytest.raises(ValueError, match="block_rows must be positive"):
        tst.GradientDescent(device=CPU).set_streamed_stats(True, block_rows=0)
    # the compressed merge of meshed totals (tests/test_torch_mesh_streamed
    # .py runs it): the knob is kept, and a bad spec raises
    assert tst.LBFGS(device=CPU).set_ingest_options(
        wire_compress="topk:0.1").ingest_wire_compress == "topk:0.1"
    with pytest.raises(ValueError, match="topk"):
        tst.LBFGS(device=CPU).set_ingest_options(wire_compress="gzip:9")
    opt = tst.LBFGS(device=CPU).set_ingest_options(
        wire_dtype="bfloat16", prefetch_depth=0, pipeline=False)
    assert (opt.ingest_wire_dtype, opt.ingest_prefetch_depth,
            opt.ingest_pipeline) == ("bfloat16", 0, False)
    with pytest.raises(ValueError, match="prefetch_depth"):
        opt.set_ingest_options(prefetch_depth=-1)
    with pytest.raises(TypeError, match="RetryPolicy"):
        opt.set_ingest_options(retry="yes")
    from tpu_sgd_torch import plan as tplan

    assert tplan._GRAM_KNOBS["batch_rows"] == ("gram_batch_rows", True)


def test_a_stopped_build_frees_its_stack_at_once(rng, monkeypatch):
    """A build stopped by a fault in its feed frees its stack and staging
    as soon as the error is handled, without waiting for the garbage
    collector (on the card, a resumed build would otherwise hold two
    stacks)."""
    import gc
    import weakref

    X, y = _data(rng, n=1024, d=5)
    seen = []
    real = tgram._chunk_prefix

    def spy(stacks, *args):
        seen.append(weakref.ref(stacks[0]))
        return real(stacks, *args)

    monkeypatch.setattr(tgram, "_chunk_prefix", spy)
    gc.disable()
    try:
        with fp.inject_faults({"io.prefetch.produce": fp.fail_nth(3)}):
            try:
                _streamed(X, y, block_rows=32, batch_rows=128)
            except fp.FaultInjected:
                stopped = True
            else:
                stopped = False
        assert stopped and len(seen) == 2
        assert seen[0]() is None
    finally:
        gc.enable()

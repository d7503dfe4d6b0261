"""Parity of the port's host-streamed CostFun (``tpu_sgd_torch/optimize/
streamed_costfun.py``) and the quasi-Newton optimizers' host-streamed
evaluators with the JAX package on the CPU: the single-device twins of
``tests/test_streamed_costfun.py``, with the same numpy inputs on both
sides.

Tolerances:
  * chunked sums against the JAX package's chunked sums and the port's
    one-pass sums: the gradient tier, rtol 2e-4 / atol 2e-3; counts exact;
  * whole-run histories against the JAX package's host-streamed run: rtol
    1e-4 over the common prefix (the JAX file's rule: once the loss is flat
    at machine precision the Armijo accept can flip on last-ulp
    differences, so one run may stop before the other), which must cover
    the descent; weights rtol 5e-4 / atol 5e-4, as the JAX file holds them
    to its resident run;
  * within the port, bitwise: two evaluations of the same weights, and the
    chunk grid's integers.

The meshed cases (``mesh=``) are twinned in
``tests/test_torch_mesh_streamed.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_sgd.ops import gradients as jg
from tpu_sgd.ops import updaters as ju
from tpu_sgd.optimize import lbfgs as jl
from tpu_sgd.optimize import owlqn as jo
from tpu_sgd.optimize import streamed_costfun as jscf
import tpu_sgd_torch as tst
from tpu_sgd_torch.ops import cuda_kernels as ck
from tpu_sgd_torch.ops import gradients as tg
from tpu_sgd_torch.ops import updaters as tu
from tpu_sgd_torch.optimize import lbfgs as tl
from tpu_sgd_torch.optimize import owlqn as to
from tpu_sgd_torch.optimize import streamed_costfun as tscf

CPU = "cpu"
GRADS = {"least_squares": (jg.LeastSquaresGradient, tg.LeastSquaresGradient),
         "logistic": (jg.LogisticGradient, tg.LogisticGradient),
         "hinge": (jg.HingeGradient, tg.HingeGradient)}


@pytest.fixture
def rng():
    return np.random.default_rng(7)


def _binary_data(rng, n=2048, d=12):
    X = rng.normal(size=(n, d)).astype(np.float32)
    w = rng.uniform(-1, 1, d).astype(np.float32)
    y = (X @ w + 0.3 * rng.normal(size=n) > 0).astype(np.float32)
    return X, y


def _ls_data(rng, n=2048, d=12):
    X = rng.normal(size=(n, d)).astype(np.float32)
    w = rng.uniform(-1, 1, d).astype(np.float32)
    y = (X @ w + 0.05 * rng.normal(size=n)).astype(np.float32)
    return X, y


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _tight(got, ref):
    np.testing.assert_allclose(_np(got), _np(ref), rtol=2e-4, atol=2e-3)


def _same_histories(h, h_ref, min_len):
    L = min(len(h), len(h_ref))
    assert L >= min_len
    np.testing.assert_allclose(np.asarray(h)[:L], np.asarray(h_ref)[:L],
                               rtol=1e-4)


# ---- sum-level equivalence -------------------------------------------------

@pytest.mark.parametrize("family", sorted(GRADS))
def test_chunked_sums_match_one_pass(rng, family):
    """cost / loss / sweep sums over a grid whose tail is ragged equal the
    JAX package's chunked sums and the port's one pass."""
    jgrad, tgrad = (c() for c in GRADS[family])
    X, y = _binary_data(rng, n=1000, d=8)
    w = rng.normal(size=(8,)).astype(np.float32)
    W = np.stack([w, 0.5 * w, np.zeros_like(w)]).astype(np.float32)
    jsc = jscf.StreamedCostFun(jgrad, X, y, batch_rows=192)
    tsc = tscf.StreamedCostFun(tgrad, X, y, batch_rows=192, device=CPU)
    assert (tsc.n_chunks, tsc.cap) == (jsc.n_chunks, jsc.cap) == (6, 192)
    got = tsc.cost_sums(w)
    one = tgrad.batch_sums(*(torch.as_tensor(a) for a in (X, y, w)))
    for a, b, c in zip(got, jsc.cost_sums(w), one):
        _tight(a, b)
        _tight(a, c)
    assert float(got[2]) == 1000
    ls, c2 = tsc.loss_sums(w)
    _tight(ls, one[1])
    assert float(c2) == 1000
    sw, c3 = tsc.sweep_sums(torch.as_tensor(W))
    _tight(sw, jsc.sweep_sums(jnp.asarray(W))[0])
    _tight(sw, tgrad.loss_sweep(*(torch.as_tensor(a) for a in (X, y, W)))[0])
    assert float(c3) == 1000
    # a second evaluation repeats the first bit for bit
    for a, b in zip(got, tsc.cost_sums(w)):
        assert torch.equal(a, b)


def test_default_batch_rows_scales_with_row_bytes():
    for args in ((1000, 4), (1000, 2), (10_000_000, 4), (7, 8)):
        assert tscf.default_stream_batch_rows(*args) == \
            jscf.default_stream_batch_rows(*args)
    assert tscf.default_stream_batch_rows(1000, 4) == 64000
    assert tscf.default_stream_batch_rows(1000, 2) == 128000
    assert tscf.default_stream_batch_rows(10_000_000, 4) == 1024  # floor


def test_tail_takes_the_masked_launch_and_full_chunks_do_not(rng,
                                                            monkeypatch):
    """The chunk rule: full chunks call ``batch_sums`` unmasked, the
    zero-padded tail with its valid mask; the tail's host buffers are made
    once (kept by its host row span)."""
    X, y = _binary_data(rng, n=500, d=4)
    g = tg.LogisticGradient()
    seen = []
    real = tg.LogisticGradient.batch_sums

    def spy(self, Xc, yc, w, mask=None, **kw):
        seen.append((tuple(Xc.shape), None if mask is None
                     else int(mask.sum())))
        return real(self, Xc, yc, w, mask, **kw)

    monkeypatch.setattr(tg.LogisticGradient, "batch_sums", spy)
    sc = tscf.StreamedCostFun(g, X, y, batch_rows=128, device=CPU)
    sc.cost_sums(np.zeros(4, np.float32))
    assert seen == [((128, 4), None)] * 3 + [((128, 4), 116)]
    tail = sc._pads[(384, 500)]
    sc.cost_sums(np.zeros(4, np.float32))
    assert sc._pads == {(384, 500): tail}
    assert bool(torch.all(tail[0][116:] == 0))


# ---- trajectory parity: L-BFGS ---------------------------------------------

@pytest.mark.parametrize("family,updater", [
    ("logistic", "l2"), ("hinge", "l2"), ("least_squares", "simple")])
def test_lbfgs_host_streamed_matches_resident(rng, family, updater):
    """The host-streamed run follows the JAX package's host-streamed run
    and the port's resident one."""
    jgrad, tgrad = GRADS[family]
    jup, tup = {"l2": (ju.SquaredL2Updater, tu.SquaredL2Updater),
                "simple": (ju.SimpleUpdater, tu.SimpleUpdater)}[updater]
    X, y = (_ls_data(rng) if family == "least_squares"
            else _binary_data(rng))
    w0 = np.zeros((X.shape[1],), np.float32)
    kw = dict(max_num_iterations=15, convergence_tol=0.0, reg_param=0.01)
    jw, jh = jl.LBFGS(jgrad(), jup(), **kw).set_host_streaming(
        True, batch_rows=300).optimize_with_history((X, y), w0)
    tw, th = tl.LBFGS(tgrad(), tup(), device=CPU, **kw).set_host_streaming(
        True, batch_rows=300).optimize_with_history((X, y), w0)
    rw, rh = tl.LBFGS(tgrad(), tup(), device=CPU, **kw) \
        .optimize_with_history((X, y), w0)
    _same_histories(th, jh, 8)
    _same_histories(th, rh, 8)
    np.testing.assert_allclose(_np(tw), _np(jw), rtol=5e-4, atol=5e-4)
    np.testing.assert_allclose(_np(tw), _np(rw), rtol=5e-4, atol=5e-4)


def test_lbfgs_host_streamed_multinomial(rng):
    """Flat multinomial matrix weights: the chunked sweep feeds the same
    ladder as the JAX package's."""
    n, d, K = 1536, 10, 4
    X = rng.normal(size=(n, d)).astype(np.float32)
    Wt = rng.normal(size=(K - 1, d)).astype(np.float32)
    logits = np.concatenate([np.zeros((n, 1)), X @ Wt.T], axis=1)
    y = logits.argmax(axis=1).astype(np.float32)
    w0 = np.zeros(((K - 1) * d,), np.float32)
    kw = dict(max_num_iterations=10, convergence_tol=0.0, reg_param=0.01)
    jw, jh = jl.LBFGS(jg.MultinomialLogisticGradient(K),
                      ju.SquaredL2Updater(), **kw).set_host_streaming(
        True, batch_rows=500).optimize_with_history((X, y), w0)
    tw, th = tl.LBFGS(tg.MultinomialLogisticGradient(K),
                      tu.SquaredL2Updater(), device=CPU, **kw) \
        .set_host_streaming(True, batch_rows=500) \
        .optimize_with_history((X, y), w0)
    assert len(th) == len(jh)
    np.testing.assert_allclose(th, np.asarray(jh), rtol=1e-4)
    np.testing.assert_allclose(_np(tw), _np(jw), rtol=5e-4, atol=5e-4)


def test_lbfgs_host_streamed_sequential_fallback(rng):
    """A gradient without ``loss_sweep`` warns and takes sequential
    trials through the chunked loss, as in the JAX package."""

    class JNoSweep(jg.LogisticGradient):
        pass

    class TNoSweep(tg.LogisticGradient):
        pass

    JNoSweep.loss_sweep = property()  # hides the attribute
    TNoSweep.loss_sweep = property()
    X, y = _binary_data(rng, n=800, d=6)
    w0 = np.zeros((6,), np.float32)
    kw = dict(max_num_iterations=8, convergence_tol=0.0, reg_param=0.01)
    with pytest.warns(RuntimeWarning, match="SEQUENTIAL"):
        jw, jh = jl.LBFGS(JNoSweep(), ju.SquaredL2Updater(), **kw) \
            .set_host_streaming(True, batch_rows=300) \
            .optimize_with_history((X, y), w0)
    with pytest.warns(RuntimeWarning, match="SEQUENTIAL"):
        tw, th = tl.LBFGS(TNoSweep(), tu.SquaredL2Updater(), device=CPU,
                          **kw).set_host_streaming(True, batch_rows=300) \
            .optimize_with_history((X, y), w0)
    assert len(th) == len(jh)
    np.testing.assert_allclose(th, np.asarray(jh), rtol=1e-4)
    np.testing.assert_allclose(_np(tw), _np(jw), rtol=5e-4, atol=5e-4)
    with pytest.raises(NotImplementedError, match="no loss_sweep"):
        tscf.StreamedCostFun(TNoSweep(), X, y, device=CPU).sweep_sums(
            np.zeros((2, 6), np.float32))


# ---- trajectory parity: OWL-QN ---------------------------------------------

def test_owlqn_host_streamed_matches_resident(rng):
    X, y = _binary_data(rng)
    w0 = np.zeros((X.shape[1],), np.float32)
    kw = dict(max_num_iterations=12, convergence_tol=0.0, reg_param=0.005)
    jw, jh = jo.OWLQN(jg.LogisticGradient(), **kw).set_host_streaming(
        True, batch_rows=300).optimize_with_history((X, y), w0)
    tw, th = to.OWLQN(tg.LogisticGradient(), device=CPU, **kw) \
        .set_host_streaming(True, batch_rows=300) \
        .optimize_with_history((X, y), w0)
    rw, rh = to.OWLQN(tg.LogisticGradient(), device=CPU, **kw) \
        .optimize_with_history((X, y), w0)
    assert len(th) == len(jh) == len(rh)
    np.testing.assert_allclose(th, np.asarray(jh), rtol=1e-4)
    np.testing.assert_allclose(th, rh, rtol=1e-4)
    np.testing.assert_allclose(_np(tw), _np(jw), rtol=5e-4, atol=5e-4)
    # L1 zeros the same coordinates on every path
    assert int((tw == 0).sum()) == int((np.asarray(jw) == 0).sum()) \
        == int((rw == 0).sum())


# ---- guards ----------------------------------------------------------------

def test_host_streaming_guards(rng):
    X, y = _ls_data(rng, n=256, d=8)
    w0 = np.zeros((8,), np.float32)
    Xs, ys, _ = tst.sparse_data(64, 8, nnz_per_row=3, seed=0)
    with pytest.raises(NotImplementedError, match="dense rows"):
        tl.LBFGS(device=CPU).set_host_streaming(True).optimize_with_history(
            (Xs, ys), w0)
    g = tst.GramLeastSquaresGradient.build(X, y, block_rows=64, device=CPU)
    with pytest.raises(ValueError, match="statistics"):
        tl.LBFGS(g, device=CPU).set_host_streaming(True) \
            .optimize_with_history((g.data, y), w0)
    with pytest.raises(ValueError, match="alternative"):
        tl.LBFGS(device=CPU).set_host_streaming(True) \
            .set_streamed_stats(True).optimize_with_history((X, y), w0)
    with pytest.raises(ValueError, match="device-resident"):
        tl.LBFGS(device=CPU).set_host_streaming(True) \
            .set_sufficient_stats(True).optimize_with_history((X, y), w0)
    with pytest.raises(ValueError, match="batch_rows must be positive"):
        tl.LBFGS(device=CPU).set_host_streaming(True, batch_rows=0)
    with pytest.raises(TypeError, match="Mesh"):
        tscf.StreamedCostFun(tg.LogisticGradient(), X, y, mesh=object(),
                             device=CPU)
    with pytest.raises(ValueError, match="non-empty"):
        tscf.StreamedCostFun(tg.LogisticGradient(), X[0], y, device=CPU)


def test_streamed_costfun_identity_cache(rng):
    """Repeated runs on the same arrays reuse the CostFun (and its staging
    ring); another gradient or ``release_sufficient_stats`` drops it."""
    X, y = _binary_data(rng, n=512, d=8)
    w0 = np.zeros((8,), np.float32)
    opt = tl.LBFGS(tg.LogisticGradient(), tu.SquaredL2Updater(),
                   max_num_iterations=3, convergence_tol=0.0, device=CPU) \
        .set_host_streaming(True, batch_rows=256)
    w1, h1 = opt.optimize_with_history((X, y), w0)
    entry = opt._stream_costfun_entry
    assert entry is not None
    w2, h2 = opt.optimize_with_history((X, y), w0)
    assert opt._stream_costfun_entry is entry  # reused, not rebuilt
    assert torch.equal(w1, w2) and np.array_equal(h1, h2)
    opt.set_gradient(tg.HingeGradient()).optimize_with_history((X, y), w0)
    assert opt._stream_costfun_entry is not entry
    opt.release_sufficient_stats()
    assert opt._stream_costfun_entry is None


def test_empty_input_falls_through(rng):
    w0 = np.zeros((4,), np.float32)
    X = np.zeros((0, 4), np.float32)
    y = np.zeros((0,), np.float32)
    for opt in (tl.LBFGS(device=CPU), to.OWLQN(device=CPU)):
        w, h = opt.set_host_streaming(True).optimize_with_history((X, y), w0)
        assert h.shape == (0,)
    jw, jh = jl.LBFGS().set_host_streaming(True).optimize_with_history(
        (X, y), w0)
    assert np.asarray(jh).shape == (0,)


def test_cpu_host_streamed_runs_launch_no_kernel(rng):
    """On the CPU every chunk takes B1's plain version."""
    X, y = _binary_data(rng, n=600, d=6)
    ck.reset_launch_counts()
    tl.LBFGS(tg.LogisticGradient(), max_num_iterations=3, device=CPU) \
        .set_host_streaming(True, batch_rows=128) \
        .optimize_with_history((X, y), np.zeros(6, np.float32))
    assert ck.launch_counts()["fused_gradient_sums"] == 0


def test_bf16_and_int_host_rows(rng):
    """A CPU bf16 tensor streams at bf16 (the resident run on the same
    tensor is the reference); int rows arrive as f32."""
    X, y = _binary_data(rng, n=700, d=6)
    Xb = torch.as_tensor(X).to(torch.bfloat16)
    w = rng.normal(size=(6,)).astype(np.float32)
    g = tg.LogisticGradient()
    got = tscf.StreamedCostFun(g, Xb, y, batch_rows=256,
                               device=CPU).cost_sums(w)
    ref = g.batch_sums(Xb, torch.as_tensor(y), torch.as_tensor(w))
    for a, b in zip(got, ref):
        _tight(a, b)
    Xi = rng.integers(-3, 4, size=(300, 5)).astype(np.int32)
    sc = tscf.StreamedCostFun(g, Xi, y[:300], batch_rows=128, device=CPU)
    assert sc._ring.host[0]["x"].dtype == torch.float32
    ref = g.batch_sums(torch.as_tensor(Xi, dtype=torch.float32),
                       torch.as_tensor(y[:300]), torch.zeros(5))
    for a, b in zip(sc.cost_sums(np.zeros(5, np.float32)), ref):
        _tight(a, b)

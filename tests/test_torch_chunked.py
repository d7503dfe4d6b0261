"""Parity of the port's ``ChunkedGradient`` (``tpu_sgd_torch/ops/
gradients.py``) with the JAX package's on the CPU: the twins of
``tests/test_chunked.py``, with the same numpy inputs on both sides and the
window starts given to both packages.

Tolerances (as in the JAX file): window sums grad rtol 2e-5 / atol 2e-4,
loss rtol 2e-5, counts exact; whole sliced runs (the JAX package's window
starts injected into the port) weights rtol 1e-4 / atol 1e-5, history
rtol 1e-4 / atol 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_sgd.ops import gradients as jg
from tpu_sgd.ops import updaters as ju
from tpu_sgd.optimize import gradient_descent as jgd
from tpu_sgd_torch.ops import gradients as tg
from tpu_sgd_torch.ops import sparse as ts
from tpu_sgd_torch.ops import updaters as tu
from tpu_sgd_torch.optimize import gradient_descent as tgd

FAMILIES = {"least_squares": (jg.LeastSquaresGradient,
                              tg.LeastSquaresGradient),
            "logistic": (jg.LogisticGradient, tg.LogisticGradient),
            "hinge": (jg.HingeGradient, tg.HingeGradient)}


def _data(rng, n=5000, d=32):
    X = rng.normal(size=(n, d)).astype(np.float32)
    w = rng.normal(size=(d,)).astype(np.float32)
    y = (X @ w > 0).astype(np.float32)
    return X, y, w


def _t(*arrays):
    return [torch.as_tensor(a) for a in arrays]


def _window_close(got, ref, m=None):
    np.testing.assert_allclose(np.asarray(got[0]), np.asarray(ref[0]),
                               rtol=2e-5, atol=2e-4)
    assert float(got[1]) == pytest.approx(float(ref[1]), rel=2e-5)
    assert float(got[2]) == float(ref[2])
    if m is not None:
        assert float(got[2]) == m


def jax_window_starts(seed, n, m, iterations):
    """The JAX package's sliced window starts of iterations ``1..N`` on one
    device (``fold_in(PRNGKey(seed), i)``, then ``randint``, as its
    ``_make_local_sums`` draws them)."""
    key = jax.random.PRNGKey(seed)
    return [int(jax.random.randint(jax.random.fold_in(key, i), (), 0,
                                   max(1, n - m + 1)))
            for i in range(1, iterations + 1)]


def inject_starts(monkeypatch, starts):
    """Make the port draw ``starts`` in order, one per iteration, in place
    of its own window stream."""
    it = iter(starts)
    monkeypatch.setattr(
        tgd, "_window_start",
        lambda gen, n, m, device: torch.tensor([next(it)], device=device))


@pytest.mark.parametrize("family", sorted(FAMILIES))
@pytest.mark.parametrize("m,chunk", [(1000, 256), (1000, 1000), (999, 256),
                                     (100, 4096)])
def test_window_sums_parity(rng, family, m, chunk):
    X, y, w = _data(rng)
    JG, TG = FAMILIES[family]
    ref = jg.ChunkedGradient(JG(), chunk_rows=chunk).window_sums(
        jnp.asarray(X), jnp.asarray(y), jnp.asarray(w), jnp.int32(123), m)
    Xt, yt, wt = _t(X, y, w)
    chunked = tg.ChunkedGradient(TG(), chunk_rows=chunk)
    got = chunked.window_sums(Xt, yt, wt, torch.tensor([123]), m)
    _window_close(got, ref, m)
    # and the port's own stock window
    _window_close(got, TG().window_sums(Xt, yt, wt, 123, m), m)


def test_window_sums_with_valid_mask(rng):
    X, y, w = _data(rng, n=2000)
    keep = np.arange(2000) % 3 != 0
    ref = jg.ChunkedGradient(jg.LeastSquaresGradient(), 128).window_sums(
        jnp.asarray(X), jnp.asarray(y), jnp.asarray(w), jnp.int32(40), 700,
        valid=jnp.asarray(keep.astype(np.float32)))
    Xt, yt, wt = _t(X, y, w)
    got = tg.ChunkedGradient(tg.LeastSquaresGradient(), 128).window_sums(
        Xt, yt, wt, torch.tensor([40]), 700, valid=torch.as_tensor(keep))
    _window_close(got, ref)


def test_delegation_surface(rng):
    X, y, w = _data(rng, n=500)
    Xt, yt, wt = _t(X, y, w)
    base = tg.LogisticGradient()
    chunked = tg.ChunkedGradient(base, chunk_rows=64)
    assert chunked.family == "logistic"
    for a, b in zip(chunked.batch_sums(Xt, yt, wt),
                    base.batch_sums(Xt, yt, wt)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert chunked.weight_dim(32) == 32
    grad, loss = chunked.compute(Xt[0], float(y[0]), wt)
    grad0, loss0 = base.compute(Xt[0], float(y[0]), wt)
    np.testing.assert_array_equal(grad.numpy(), grad0.numpy())
    W = torch.stack([wt, 0.5 * wt])
    s1, _ = chunked.loss_sweep(Xt, yt, W)
    s0, _ = base.loss_sweep(Xt, yt, W)
    np.testing.assert_array_equal(s1.numpy(), s0.numpy())
    # the JAX wrapper's delegated sums, at the tight tier
    jsum = jg.ChunkedGradient(jg.LogisticGradient(), 64).batch_sums(
        jnp.asarray(X), jnp.asarray(y), jnp.asarray(w))
    np.testing.assert_allclose(
        chunked.batch_sums(Xt, yt, wt)[0].numpy(), np.asarray(jsum[0]),
        rtol=2e-4, atol=2e-3)


@pytest.mark.parametrize("start", [4000, -7])
def test_out_of_range_start_clamps_like_stock(rng, start):
    """A start past n - m clamps ONCE to the stock window (per-block
    clamping would re-read overlapping tail rows); a negative start clips
    to row 0, as the JAX wrapper's ``jnp.clip`` does."""
    X, y, w = _data(rng, n=5000)
    ref = jg.ChunkedGradient(jg.LeastSquaresGradient(), 1024).window_sums(
        jnp.asarray(X), jnp.asarray(y), jnp.asarray(w), jnp.int32(start),
        3000)
    Xt, yt, wt = _t(X, y, w)
    got = tg.ChunkedGradient(tg.LeastSquaresGradient(), 1024).window_sums(
        Xt, yt, wt, torch.tensor([start]), 3000)
    _window_close(got, ref, 3000)


def test_bad_chunk_rejected():
    with pytest.raises(ValueError, match="chunk_rows"):
        tg.ChunkedGradient(tg.LeastSquaresGradient(), chunk_rows=0)


def test_sparse_window_raises(rng):
    X, y, w = _data(rng, n=64, d=8)
    Xs = ts.to_csr(torch.as_tensor(X))
    with pytest.raises(NotImplementedError, match="dense row layout"):
        tg.ChunkedGradient(tg.LeastSquaresGradient(), 16).window_sums(
            Xs, torch.as_tensor(y), torch.as_tensor(w), 0, 32)


def test_block_count_of_a_window(rng, monkeypatch):
    """Each block is one base window call: a 1000-row window in 256-row
    blocks is 3 full blocks and a 232-row remainder, at consecutive
    starts."""
    X, y, w = _data(rng, n=2000, d=8)
    base = tg.LeastSquaresGradient()
    calls = []
    inner = base.window_sums

    def record(X, y, weights, start, m, valid=None):
        calls.append((int(start), m))
        return inner(X, y, weights, start, m, valid=valid)

    monkeypatch.setattr(base, "window_sums", record)
    tg.ChunkedGradient(base, 256).window_sums(*_t(X, y, w), 500, 1000)
    assert calls == [(500, 256), (756, 256), (1012, 256), (1268, 232)]


def test_full_driver_trajectory_matches(rng, monkeypatch):
    """The same sliced SGD run through the chunked gradient in both
    packages, the JAX package's window starts injected into the port; and
    the port's chunked run against its own stock run."""
    n, d, iters, frac = 8192, 16, 12, 0.25
    X = rng.normal(size=(n, d)).astype(np.float32)
    w_true = rng.normal(size=(d,)).astype(np.float32)
    y = (X @ w_true + 0.01 * rng.normal(size=n)).astype(np.float32)

    jopt = (jgd.GradientDescent(
        jg.ChunkedGradient(jg.LeastSquaresGradient(), chunk_rows=1024),
        ju.SimpleUpdater())
        .set_step_size(0.5).set_num_iterations(iters)
        .set_mini_batch_fraction(frac).set_sampling("sliced"))
    jw = np.asarray(jopt.optimize((X, y), np.zeros(d, np.float32)))
    jh = np.asarray(jopt.loss_history)

    def run(gradient):
        opt = (tgd.GradientDescent(gradient, tu.SimpleUpdater(),
                                   device="cpu")
               .set_step_size(0.5).set_num_iterations(iters)
               .set_mini_batch_fraction(frac).set_sampling("sliced"))
        w = opt.optimize((X, y), np.zeros(d, np.float32))
        return w.numpy(), np.asarray(opt.loss_history)

    chunked = tg.ChunkedGradient(tg.LeastSquaresGradient(), chunk_rows=1024)
    w_own, h_own = run(chunked)
    w_stock, h_stock = run(tg.LeastSquaresGradient())
    np.testing.assert_allclose(w_own, w_stock, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(h_own, h_stock, rtol=1e-4, atol=1e-6)

    starts = jax_window_starts(42, n, round(frac * n), iters)
    inject_starts(monkeypatch, starts)
    w_inj, h_inj = run(chunked)
    np.testing.assert_allclose(w_inj, jw, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(h_inj, jh, rtol=1e-4, atol=1e-6)
    assert len(set(starts)) > 1  # the injected windows move

"""Rows that are not whole 16-byte units on the port's main path, on the
CPU: ``train(..., intercept=True)`` appends a bias column, so config 4's
10M x 1000 bf16 trains as 10M x 1001 (2,002-byte rows) and config 1 as
101 f32; on the card those rows go to ``csrc/window_sums.cu`` through
their 16-byte aligned supersets.  Here the kernel module's CPU path at
such widths against the JAX package's Pallas kernels (interpret mode),
and whole intercept runs of the port against the JAX package's, both
drawing the JAX package's samples.

Tolerances: the kernel sums at ``tests/test_torch_gather_kernel.py``'s
tiers (f32 grad rtol 2e-4 / atol 2e-3, loss rtol 2e-4; bf16 max |dg| <=
4e-3 * max |g|, loss rtol 1e-3; counts exact).  Whole runs (ROADMAP's
tiers): f32 with the same samples is the same arithmetic in another
summation order, so weights and intercept rtol 1e-4 (atol 1e-5); bf16
rounds w and the coefficients to bf16 on both sides, so a coefficient on
a rounding boundary can move one ulp: the matched objective, <= 1.01x the
JAX package's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_sgd.models as jm
import tpu_sgd_torch.models as tm
from tpu_sgd.ops import gradients as jg
from tpu_sgd.ops import pallas_kernels as jpk
from tpu_sgd_torch.ops import cuda_kernels as ck
from tpu_sgd_torch.ops import gradients as tg
from tpu_sgd_torch.optimize import gradient_descent as tgd
from tpu_sgd_torch.utils.mlutils import linear_data

SEED = 42  # SGDConfig's default seed, in both packages


def _problem(n, d, seed, bf16):
    r = np.random.default_rng(seed)
    X = r.normal(size=(n, d)).astype(np.float32)
    y = r.normal(size=(n,)).astype(np.float32)
    w = (r.normal(size=(d,)) / np.sqrt(d)).astype(np.float32)
    jX = jnp.asarray(X, jnp.bfloat16) if bf16 else jnp.asarray(X)
    tX = torch.from_numpy(X)
    if bf16:
        tX = tX.to(torch.bfloat16)
    return jX, tX, y, w


def _assert_sums(got, ref, bf16):
    g, l, c = (np.asarray(torch.as_tensor(t).double()) for t in got)
    gr, lr, cr = (np.asarray(t, np.float64) for t in ref)
    if bf16:
        assert np.max(np.abs(g - gr)) <= 4e-3 * np.max(np.abs(gr)) + 1e-6
        np.testing.assert_allclose(l, lr, rtol=1e-3, atol=1e-6)
    else:
        np.testing.assert_allclose(g, gr, rtol=2e-4, atol=2e-3)
        np.testing.assert_allclose(l, lr, rtol=2e-4, atol=1e-9)
    assert float(c) == float(cr)


@pytest.mark.parametrize("masked", [False, True], ids=["all", "mask"])
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("d", [37, 101, 123])
def test_gradient_sums_at_odd_widths_match_pallas(d, bf16, masked):
    """B1's CPU path against the Pallas masked kernel at widths whose rows
    are not whole 16-byte units (101: config 1 with its intercept, 123:
    a9a)."""
    n = 517
    jX, tX, y, w = _problem(n, d, d, bf16)
    mask = np.random.default_rng(d + 1).uniform(size=n) < 0.3
    jm_ = jnp.asarray(mask) if masked else None
    tm_ = torch.from_numpy(mask) if masked else None
    pw_j, pw_t = jg.LeastSquaresGradient().pointwise, \
        tg.LeastSquaresGradient().pointwise
    ref = jpk.fused_gradient_sums(pw_j, jX, jnp.asarray(y), jnp.asarray(w),
                                  jm_, tile_m=128, interpret=True)
    got = ck.fused_gradient_sums(pw_t, tX, torch.from_numpy(y),
                                 torch.from_numpy(w), tm_)
    _assert_sums(got, ref, bf16)


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_window_sums_at_an_odd_width_match_pallas(bf16):
    """B2's CPU path on a 1001-wide X (config 4's width with its
    intercept) against the Pallas window kernel, one row a tile."""
    n, d, s, m = 96, 1001, 29, 33
    jX, tX, y, w = _problem(n, d, 3, bf16)
    pw_j, pw_t = jg.LogisticGradient().pointwise, \
        tg.LogisticGradient().pointwise
    yb = (y > 0).astype(np.float32)
    ref = jpk.fused_window_sums(pw_j, jX, jnp.asarray(yb), jnp.asarray(w),
                                jnp.asarray(s, jnp.int32), m, tile_m=1,
                                interpret=True)
    got = ck.fused_window_sums(pw_t, tX, torch.from_numpy(yb),
                               torch.from_numpy(w), torch.tensor([s]), m,
                               tile_m=1)
    _assert_sums(got, ref, bf16)
    assert float(got[2]) == m


def _jax_samples(sampling, n, frac, iterations):
    """The JAX package's samples of iterations ``1..N`` on one device
    (``fold_in(PRNGKey(seed), i)``, then ``bernoulli`` or ``randint``, as
    its ``_make_mask`` and ``_make_local_sums`` draw them)."""
    key = jax.random.PRNGKey(SEED)
    m = max(1, round(frac * n))
    out = []
    for i in range(1, iterations + 1):
        k = jax.random.fold_in(key, i)
        if sampling == "bernoulli":
            out.append(torch.from_numpy(np.array(
                jax.random.bernoulli(k, frac, (n,)))))
        else:
            out.append(torch.tensor([int(jax.random.randint(
                k, (), 0, max(1, n - m + 1)))]))
    return out


def _inject(monkeypatch, samples):
    """Make the port's sampler draw ``samples`` in order, one an
    iteration, in place of its own stream."""
    make = tgd._make_sampler

    def sampler(cfg, X, shard=None):
        s = make(cfg, X, shard)
        if s is not None:
            # draw() moves the stream to the next iteration first
            s._draw = lambda gen: samples[s._next - 2]
        return s

    monkeypatch.setattr(tgd, "_make_sampler", sampler)


@pytest.mark.parametrize("sampling", ["bernoulli", "sliced"])
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_intercept_training_matches_jax(monkeypatch, bf16, sampling):
    """``LinearRegressionWithSGD.train(..., intercept=True)`` at 2000 x 37
    (38 with the bias column: 152 f32 or 76 bf16 bytes a row), frac 0.1,
    the JAX package's samples drawn by both."""
    n, d, iters, frac = 2000, 37, 60, 0.1
    X, y, _ = linear_data(n, d, intercept=0.7, eps=0.1, seed=21)
    jX = jnp.asarray(X, jnp.bfloat16) if bf16 else X
    tX = torch.from_numpy(X).to(torch.bfloat16) if bf16 else X
    _inject(monkeypatch, _jax_samples(sampling, n, frac, iters))
    kw = dict(intercept=True, sampling=sampling, schedule="off")
    j = jm.LinearRegressionWithSGD.train((jX, y), iters, 0.5, frac, **kw)
    t = tm.LinearRegressionWithSGD.train((tX, y), iters, 0.5, frac,
                                         device="cpu", **kw)
    jw, tw = np.asarray(j.weights, np.float64), t.weights.double().numpy()

    def objective(w, b):
        return 0.5 * np.mean((X.astype(np.float64) @ w + b - y) ** 2)

    if bf16:
        assert objective(tw, t.intercept) <= 1.01 * objective(
            jw, j.intercept)
    else:
        np.testing.assert_allclose(tw, jw, rtol=1e-4, atol=1e-5)
        assert t.intercept == pytest.approx(j.intercept, rel=1e-4,
                                            abs=1e-5)
    assert t.intercept == pytest.approx(0.7, abs=0.05)

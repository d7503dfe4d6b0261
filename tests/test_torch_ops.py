"""Parity of the PyTorch port's ops (``tpu_sgd_torch.ops``) with the JAX
package on the CPU.

Inputs are made with numpy from fixed seeds and handed to both packages.
On the CPU the port's kernel wrappers take their plain PyTorch versions;
the JAX side runs its Pallas kernels in interpret mode, as
tests/test_pallas.py does.

Tolerances:
  * updaters: rtol 1e-6 (the same f32 arithmetic);
  * f32 sums: grad rtol 2e-4 / atol 2e-3, loss rtol 2e-4 (the
    tests/test_pallas.py bounds); counts exact;
  * bf16 sums: both sides round w and coeff to bf16 at the same points,
    but their f32 margins are summed in other orders, so a coefficient on
    a bf16 rounding boundary can move one bf16 ulp (2^-8): max |dg| <=
    4e-3 * max |g|, loss rtol 1e-3; counts exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_sgd.ops import gradients as jg
from tpu_sgd.ops import pallas_kernels as jpk
from tpu_sgd.ops import updaters as ju
from tpu_sgd_torch.ops import cuda_kernels as ck
from tpu_sgd_torch.ops import gradients as tg
from tpu_sgd_torch.ops import updaters as tu

FAMILIES = {
    "least_squares": (jg.LeastSquaresGradient, tg.LeastSquaresGradient),
    "logistic": (jg.LogisticGradient, tg.LogisticGradient),
    "hinge": (jg.HingeGradient, tg.HingeGradient),
}
UPDATERS = {
    "simple": (ju.SimpleUpdater, tu.SimpleUpdater),
    "l1": (ju.L1Updater, tu.L1Updater),
    "squared_l2": (ju.SquaredL2Updater, tu.SquaredL2Updater),
}


def _data(n=300, d=24, seed=0, classify=False):
    r = np.random.default_rng(seed)
    X = r.normal(size=(n, d)).astype(np.float32)
    if classify:
        y = (r.uniform(size=(n,)) < 0.5).astype(np.float32)
    else:
        y = r.normal(size=(n,)).astype(np.float32)
    w = (r.normal(size=(d,)) / np.sqrt(d)).astype(np.float32)
    return X, y, w


def _both(family, n=300, d=24, seed=0, bf16=False):
    """(jax gradient, port gradient, jax X, port X, y, w)."""
    jcls, tcls = FAMILIES[family]
    X, y, w = _data(n, d, seed, classify=family != "least_squares")
    jX = jnp.asarray(X, jnp.bfloat16) if bf16 else jnp.asarray(X)
    tX = torch.from_numpy(X)
    if bf16:
        tX = tX.to(torch.bfloat16)
    return jcls(), tcls(), jX, tX, y, w


def assert_sums(got, ref, bf16=False):
    g, l, c = (np.asarray(torch.as_tensor(t).double()) for t in got)
    gr, lr, cr = (np.asarray(t, np.float64) for t in ref)
    if bf16:
        assert np.max(np.abs(g - gr)) <= 4e-3 * np.max(np.abs(gr)) + 1e-6
        np.testing.assert_allclose(l, lr, rtol=1e-3)
    else:
        np.testing.assert_allclose(g, gr, rtol=2e-4, atol=2e-3)
        np.testing.assert_allclose(l, lr, rtol=2e-4)
    assert float(c) == float(cr)


@pytest.mark.parametrize("name", sorted(UPDATERS))
def test_updaters_match_jax(name):
    jcls, tcls = UPDATERS[name]
    r = np.random.default_rng(1)
    w = r.normal(size=(40,)).astype(np.float32)
    g = r.normal(size=(40,)).astype(np.float32)
    for it, reg in ((1, 0.0), (3, 0.1), (17, 0.5)):
        jw, jreg = jcls().compute(jnp.asarray(w), jnp.asarray(g), 0.7, it,
                                  reg)
        tw, treg = tcls().compute(torch.from_numpy(w), torch.from_numpy(g),
                                  0.7, it, reg)
        np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-6,
                                   atol=1e-7)
        np.testing.assert_allclose(float(treg), float(jreg), rtol=1e-6)


def test_l1_prox_zeroes_small_weights():
    w = torch.tensor([0.05, -0.05, 2.0])
    new_w, reg_val = tu.L1Updater().compute(w, torch.zeros(3), 1.0, 1, 0.1)
    assert new_w.tolist()[:2] == [0.0, 0.0]
    assert new_w[2].item() == pytest.approx(1.9)
    assert float(reg_val) == pytest.approx(0.19)


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("use_mask", [False, True], ids=["all", "mask"])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_batch_sums_match_jax(family, use_mask, bf16):
    jgr, tgr, jX, tX, y, w = _both(family, n=333, seed=2, bf16=bf16)
    mask = (np.random.default_rng(3).uniform(size=(333,)) < 0.3
            if use_mask else None)
    ref = jgr.batch_sums(jX, jnp.asarray(y), jnp.asarray(w),
                         None if mask is None else jnp.asarray(mask))
    got = tgr.batch_sums(tX, torch.from_numpy(y), torch.from_numpy(w),
                         None if mask is None else torch.from_numpy(mask))
    assert_sums(got, ref, bf16)


@pytest.mark.parametrize("start", [0, 117, 250, 251, 400, -7],
                         ids=["zero", "mid", "edge", "past_edge", "far",
                              "negative"])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_window_sums_match_jax(family, start):
    """Random, edge and out-of-range starts clamp like lax.dynamic_slice;
    the port's start may stay a tensor."""
    jgr, tgr, jX, tX, y, w = _both(family, n=300, seed=4)
    m = 50
    ref = jgr.window_sums(jX, jnp.asarray(y), jnp.asarray(w),
                          jnp.asarray(start, jnp.int32), m)
    got = tgr.window_sums(tX, torch.from_numpy(y), torch.from_numpy(w),
                          torch.tensor([start]), m)
    assert_sums(got, ref)


@pytest.mark.parametrize("use_mask", [False, True], ids=["all", "mask"])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_fused_gradient_sums_match_pallas(family, use_mask):
    """Ragged rows (333, not a tile multiple) with and without a mask."""
    jgr, tgr, jX, tX, y, w = _both(family, n=333, d=16, seed=5)
    mask = (np.random.default_rng(6).uniform(size=(333,)) < 0.3
            if use_mask else None)
    ref = jpk.fused_gradient_sums(
        jgr.pointwise, jX, jnp.asarray(y), jnp.asarray(w),
        None if mask is None else jnp.asarray(mask), tile_m=128,
        interpret=True)
    got = ck.fused_gradient_sums(
        tgr.pointwise, tX, torch.from_numpy(y), torch.from_numpy(w),
        None if mask is None else torch.from_numpy(mask))
    assert_sums(got, ref)
    if use_mask:
        assert float(got[2]) == mask.sum()


@pytest.mark.parametrize("kernel", ["fused_window_sums",
                                    "fused_window_sums_vpu"])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_fused_window_sums_match_pallas(family, kernel):
    jgr, tgr, jX, tX, y, w = _both(family, n=1024, d=16, seed=7)
    ref = getattr(jpk, kernel)(
        jgr.pointwise, jX, jnp.asarray(y), jnp.asarray(w),
        jnp.asarray(2, jnp.int32), 3, tile_m=128, interpret=True)
    got = getattr(ck, kernel)(
        tgr.pointwise, tX, torch.from_numpy(y), torch.from_numpy(w),
        torch.tensor([2]), 3, tile_m=128)
    assert_sums(got, ref)
    assert float(got[2]) == 3 * 128


def test_fused_window_sums_rejects_ragged_rows():
    _, tgr, _, tX, y, w = _both("least_squares", n=1000, d=8)
    with pytest.raises(ValueError, match="multiple of the tile size"):
        ck.fused_window_sums(tgr.pointwise, tX, torch.from_numpy(y),
                             torch.from_numpy(w), 0, 2, tile_m=128)


@pytest.mark.parametrize("window_kernel", ["mxu", "vpu"])
@pytest.mark.parametrize("start,m", [(300, 2 * 128 + 50), (640, 3 * 128),
                                     (5, 60), (1000, 256)],
                         ids=["floored_with_rest", "aligned", "short_window",
                              "clamped"])
def test_fused_gradient_routing_matches_pallas_gradient(start, m,
                                                        window_kernel):
    """Tile-floored windows (and the base route for short windows) agree
    with PallasGradient's routing."""
    jgr, tgr, jX, tX, y, w = _both("least_squares", n=1024, d=16, seed=8)
    jp = jpk.PallasGradient(jgr, tile_m=128, interpret=True,
                            window_kernel=window_kernel)
    tp = ck.FusedGradient(tgr, tile_m=128, window_kernel=window_kernel)
    ref = jp.window_sums(jX, jnp.asarray(y), jnp.asarray(w),
                         jnp.asarray(start, jnp.int32), m)
    got = tp.window_sums(tX, torch.from_numpy(y), torch.from_numpy(w),
                         torch.tensor([start]), m)
    assert_sums(got, ref)
    ref_b = jp.batch_sums(jX, jnp.asarray(y), jnp.asarray(w))
    assert_sums(tp.batch_sums(tX, torch.from_numpy(y), torch.from_numpy(w)),
                ref_b)


def test_fused_gradient_rejects_unknown_window_kernel():
    with pytest.raises(ValueError, match="window_kernel"):
        ck.FusedGradient(tg.LeastSquaresGradient(), window_kernel="tma")


def test_check_tile_smem_raises_past_shared_memory():
    ck._check_tile_smem(torch.empty(0, 47_237))  # RCV1 width + bias fits
    with pytest.raises(ValueError, match=r"d <= \d+"):
        ck._check_tile_smem(torch.empty(0, 60_000))


def test_custom_pointwise_takes_the_plain_path():
    """A Gradient with its own rule (family None) computes with plain
    torch and matches the built-in rule it copies."""

    class Custom(tg.Gradient):
        def pointwise(self, margin, label):
            diff = margin - label
            return diff, 0.5 * diff * diff

    _, tgr, _, tX, y, w = _both("least_squares", seed=9)
    args = (tX, torch.from_numpy(y), torch.from_numpy(w))
    for a, b in zip(Custom().batch_sums(*args), tgr.batch_sums(*args)):
        torch.testing.assert_close(a, b)
    with pytest.raises(ValueError, match="compiles in"):
        ck._family_of(Custom().pointwise)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_single_example_compute_matches_jax(family):
    jgr, tgr, jX, tX, y, w = _both(family, n=3, d=8, seed=10)
    for i in range(3):
        jg_, jl = jgr.compute(jX[i], jnp.asarray(y[i]), jnp.asarray(w))
        tg_, tl = tgr.compute(tX[i], float(y[i]), torch.from_numpy(w))
        np.testing.assert_allclose(tg_.numpy(), np.asarray(jg_), rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5,
                                   atol=1e-6)

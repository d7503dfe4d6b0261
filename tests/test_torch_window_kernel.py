"""The window kernel's host side (``tpu_sgd_torch/ops/cuda_kernels.py``)
on the CPU: the stage planner of ``csrc/window_sums.cu`` and its route by
shape, the per-source launch counters on the CPU path, and the plain
window sums against the JAX package's Pallas window kernels (interpret
mode) at the lengths where the kernel's stages begin and end, and at
clamped starts.

Tolerances are those of tests/test_torch_ops.py: f32 grad rtol 2e-4 /
atol 2e-3, loss rtol 2e-4; bf16 (both sides round w and coeff to bf16, but
sum their f32 margins in other orders, so a coefficient on a rounding
boundary can move one bf16 ulp) max |dg| <= 4e-3 * max |g|, loss rtol
1e-3; counts exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_sgd_torch as tst
from tpu_sgd.ops import gradients as jg
from tpu_sgd.ops import pallas_kernels as jpk
from tpu_sgd_torch.ops import cuda_kernels as ck
from tpu_sgd_torch.ops import gradients as tg
from tpu_sgd_torch.ops.gradients import _clamp_start

FAMILIES = {
    "least_squares": (jg.LeastSquaresGradient, tg.LeastSquaresGradient),
    "logistic": (jg.LogisticGradient, tg.LogisticGradient),
    "hinge": (jg.HingeGradient, tg.HingeGradient),
}

# (d, dtype, route): widths whose 3 stages of 4 rows fit beside w and the
# sums go to window_sums.cu, rows of whole 16-byte units back to back in a
# stage, any other row in a slot of window_row_pitch bytes
ROUTES = [
    (24, torch.float32, "window_sums"),
    (24, torch.bfloat16, "window_sums"),
    (100, torch.float32, "window_sums"),
    (100, torch.bfloat16, "window_sums"),     # 200-byte rows
    (1000, torch.float32, "window_sums"),
    (1000, torch.bfloat16, "window_sums"),
    (4096, torch.float32, "window_sums"),
    (4096, torch.bfloat16, "window_sums"),
    (4124, torch.float32, "window_sums"),     # the widest f32 row
    (4128, torch.float32, "fused_sums"),
    (7216, torch.bfloat16, "window_sums"),    # the widest bf16 row
    (7224, torch.bfloat16, "fused_sums"),
    (8192, torch.bfloat16, "fused_sums"),
    (47237, torch.float32, "fused_sums"),     # odd widths
    (47237, torch.bfloat16, "fused_sums"),
    (7, torch.float32, "window_sums"),
    (101, torch.float32, "window_sums"),      # config 1 with its intercept
    (123, torch.float32, "window_sums"),      # a9a
    (1001, torch.bfloat16, "window_sums"),    # config 4 with its intercept
    (4121, torch.float32, "window_sums"),     # the widest odd f32 row
    (4122, torch.float32, "fused_sums"),
    (7209, torch.bfloat16, "window_sums"),    # the widest odd bf16 row
    (7210, torch.bfloat16, "fused_sums"),
]


def _itemsize(dtype):
    return torch.empty((), dtype=dtype).element_size()


@pytest.mark.parametrize("d,dtype,route", ROUTES,
                         ids=[f"{d}-{str(t)[6:]}" for d, t, _ in ROUTES])
def test_stage_planner_fits_and_routes(d, dtype, route):
    plan = ck.window_stage_plan(d, _itemsize(dtype), True)
    assert ck.window_plan_for(torch.empty(0, d, dtype=dtype)) == plan
    if route == "fused_sums":
        assert plan is None
        return
    row = d * _itemsize(dtype)
    pitch = ck.window_row_pitch(d, _itemsize(dtype), True)
    # an odd row's slot holds it after a lead of up to 16 - itemsize bytes
    assert pitch == row if row % 16 == 0 else (
        row + 16 - _itemsize(dtype) <= pitch < row + 32)
    assert plan.stage_rows >= 4 and plan.stage_rows in ck.WINDOW_STAGE_ROWS
    assert ck.WINDOW_MIN_STAGES <= plan.stages <= ck.WINDOW_MAX_STAGES
    assert plan.stage_bytes == plan.stage_rows * pitch
    assert plan.stage_bytes % 16 == 0
    assert plan.smem_bytes == plan.stages * (
        plan.stage_bytes + ck.WINDOW_LABEL_BYTES) + 8 * ck.window_padded_d(
            d, _itemsize(dtype))
    assert plan.smem_bytes + ck._WINDOW_STATIC_SMEM <= ck.SMEM_PER_BLOCK
    assert plan.blocks_per_sm * (
        plan.smem_bytes + ck._WINDOW_STATIC_SMEM
        + ck._SMEM_RESERVED_PER_BLOCK) <= ck.SMEM_PER_SM
    assert plan.cluster == ck.WINDOW_CLUSTER
    assert plan.blocks_per_sm == (2 if d <= ck.WINDOW_TWO_BLOCK_MAX_D else 1)


def test_stage_planner_sizes_the_ring():
    """d = 1000 bf16 (the main path): two blocks an SM, each with 3 stages
    of 16 rows (96 KB in flight a block); d = 1000 f32 keeps 3 stages with
    8 rows; d = 4096 f32, one block an SM, drops to 4 rows."""
    plan = ck.window_stage_plan(1000, 2, True)
    assert (plan.stage_rows, plan.stages, plan.blocks_per_sm) == (16, 3, 2)
    assert plan.smem_bytes == 3 * (16 * 2000 + 112) + 8000
    plan = ck.window_stage_plan(1000, 4, True)
    assert (plan.stage_rows, plan.stages, plan.blocks_per_sm) == (8, 3, 2)
    plan = ck.window_stage_plan(4096, 4, True)
    assert (plan.stage_rows, plan.stages, plan.blocks_per_sm) == (4, 3, 1)
    plan = ck.window_stage_plan(24, 4, True)
    assert (plan.stage_rows, plan.stages, plan.blocks_per_sm) == (16, 8, 2)


def test_misaligned_base_goes_to_the_ring():
    X = torch.zeros(64, 1000, dtype=torch.bfloat16)
    assert ck.window_plan_for(X) == ck.window_stage_plan(1000, 2, True)
    # a view 4 bytes past an aligned base: its rows' supersets, a slot of
    # 24 * 4 + 16 bytes each
    view = torch.zeros(65, 24)[1:].view(-1)[1:25].reshape(1, 24)
    plan = ck.window_plan_for(view)
    assert plan == ck.window_stage_plan(24, 4, aligned_base=False)
    assert plan.stage_bytes == plan.stage_rows * (24 * 4 + 16)
    assert ck.window_plan_for(torch.zeros(8, 24, dtype=torch.float64)) is None


def test_cpu_path_counts_no_kernel_launch():
    """The plain versions run on CPU tensors; neither CUDA source counts."""
    ck.reset_launch_counts()
    X, y, _ = tst.linear_data(512, 24, seed=3)
    Xt, yt = torch.from_numpy(X), torch.from_numpy(y)
    w = torch.zeros(24)
    g = tg.LeastSquaresGradient()
    ck.fused_window_sums(g.pointwise, Xt, yt, w, 3, 100, tile_m=1)
    ck.fused_window_sums_vpu(g.pointwise, Xt, yt, w, 1, 2, tile_m=128)
    ck.fused_gradient_sums(g.pointwise, Xt, yt, w)
    g.window_sums(Xt, yt, w, torch.tensor([7]), 65)
    tst.GradientDescent(tst.ChunkedGradient(g, 16), device="cpu") \
        .set_sampling("sliced").set_mini_batch_fraction(0.2) \
        .set_num_iterations(3).optimize((X, y), np.zeros(24))
    assert ck.kernel_launch_counts() == {"fused_sums": 0, "window_sums": 0}
    assert ck.launch_counts() == {"fused_gradient_sums": 0,
                                  "fused_window_sums": 0,
                                  "fused_window_sums_vpu": 0}


def test_reset_clears_the_source_counts():
    ck.KERNEL_LAUNCHES["window_sums"] = 5
    ck.fused_window_sums.launches = 2
    ck.reset_launch_counts()
    assert ck.kernel_launch_counts() == {"fused_sums": 0, "window_sums": 0}
    assert ck.fused_window_sums.launches == 0


def _problem(family, n, d, seed, bf16):
    r = np.random.default_rng(seed)
    X = r.normal(size=(n, d)).astype(np.float32)
    if family == "least_squares":
        y = r.normal(size=(n,)).astype(np.float32)
    else:
        y = (r.uniform(size=(n,)) < 0.5).astype(np.float32)
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
        np.testing.assert_allclose(l, lr, rtol=1e-3)
    else:
        np.testing.assert_allclose(g, gr, rtol=2e-4, atol=2e-3)
        np.testing.assert_allclose(l, lr, rtol=2e-4)
    assert float(c) == float(cr)


# window lengths around the kernel's stages (4 and 16 rows): 1, R - 1, R,
# R + 1, two stages and one row
LENGTHS = [1, 3, 4, 5, 15, 16, 17, 33]


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("m", LENGTHS)
def test_plain_window_matches_pallas_at_stage_lengths(m, bf16):
    """One row a tile (``Gradient.window_sums``'s ``tile_m=1``), start 37."""
    n, d = 96, 24
    jX, tX, y, w = _problem("least_squares", n, d, 11 + m, bf16)
    jgr, tgr = jg.LeastSquaresGradient(), tg.LeastSquaresGradient()
    ref = jpk.fused_window_sums(jgr.pointwise, jX, jnp.asarray(y),
                                jnp.asarray(w), jnp.asarray(37, jnp.int32),
                                m, tile_m=1, interpret=True)
    got = ck.fused_window_sums_plain(tgr.pointwise, tX, torch.from_numpy(y),
                                     torch.from_numpy(w), 37, m, 1)
    _assert_sums(got, ref, bf16)
    assert float(got[2]) == m


@pytest.mark.parametrize("kernel", ["fused_window_sums",
                                    "fused_window_sums_vpu"])
@pytest.mark.parametrize("start", [-3, -40, 90, 500],
                         ids=["neg_small", "neg_far", "past_end", "far"])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_clamped_starts_match_pallas(family, start, kernel):
    """The port clamps the start as lax.dynamic_slice does (negative from
    the end, then into [0, n - m]); the JAX kernel takes an in-bounds
    start, so it gets the clamped one."""
    n, d, m = 96, 24, 17
    jX, tX, y, w = _problem(family, n, d, 5, False)
    jcls, tcls = FAMILIES[family]
    s = _clamp_start(start, n, m)
    ref = getattr(jpk, kernel)(jcls().pointwise, jX, jnp.asarray(y),
                               jnp.asarray(w), jnp.asarray(s, jnp.int32), m,
                               tile_m=1, interpret=True)
    got = getattr(ck, kernel)(tcls().pointwise, tX, torch.from_numpy(y),
                              torch.from_numpy(w), torch.tensor([start]), m,
                              tile_m=1)
    _assert_sums(got, ref, False)


@pytest.mark.parametrize("m", [1, 16, 17])
def test_plain_window_valid_matches_masked_pallas(m):
    """``valid`` (by absolute row) against the JAX masked kernel on the
    same rows."""
    n, d, s = 96, 24, 40
    jX, tX, y, w = _problem("logistic", n, d, 9, False)
    valid = np.random.default_rng(10).uniform(size=(n,)) < 0.5
    jgr, tgr = jg.LogisticGradient(), tg.LogisticGradient()
    ref = jpk.fused_gradient_sums(
        jgr.pointwise, jX[s:s + m], jnp.asarray(y[s:s + m]), jnp.asarray(w),
        jnp.asarray(valid[s:s + m]), tile_m=128, interpret=True)
    got = ck.fused_window_sums(tgr.pointwise, tX, torch.from_numpy(y),
                               torch.from_numpy(w), torch.tensor([s]), m,
                               tile_m=1, valid=torch.from_numpy(valid))
    _assert_sums(got, ref, False)
    assert float(got[2]) == valid[s:s + m].sum()

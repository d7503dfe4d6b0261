"""B1's routes on the card and the gather entry's host side
(``tpu_sgd_torch/ops/cuda_kernels.py``), on the CPU: which kernel a
``fused_gradient_sums`` call of each width, type and alignment launches,
the numpy mirror of ``csrc/window_sums.cu``'s ring grid
(``cuda_kernels.ring_grid``) and one here of the gather entry's dealing of
live rows into tiles, and the CPU path of
``fused_gradient_sums`` against the JAX package's Pallas kernel (interpret
mode) at the mask densities the gather entry treats apart.

Tolerances are those of tests/test_torch_ops.py: f32 grad rtol 2e-4 /
atol 2e-3, loss rtol 2e-4; bf16 (both sides round w and coeff to bf16, but
sum their f32 margins in other orders, so a coefficient on a rounding
boundary can move one bf16 ulp) max |dg| <= 4e-3 * max |g|, loss rtol
1e-3; counts exact.
"""

from typing import NamedTuple

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_sgd.ops import gradients as jg
from tpu_sgd.ops import pallas_kernels as jpk
from tpu_sgd_torch.ops import cuda_kernels as ck
from tpu_sgd_torch.ops import gradients as tg

FAMILIES = {
    "least_squares": (jg.LeastSquaresGradient, tg.LeastSquaresGradient),
    "logistic": (jg.LogisticGradient, tg.LogisticGradient),
    "hinge": (jg.HingeGradient, tg.HingeGradient),
}

# (d, dtype, masked route, unmasked route)
ROUTES = [
    (24, torch.float32, "gather", "window"),
    (24, torch.bfloat16, "gather", "window"),
    (1000, torch.bfloat16, "gather", "window"),   # config 4's width
    (1000, torch.float32, "gather", "window"),
    # 2,002-byte rows (config 4 with its intercept): each row through its
    # 16-byte aligned superset
    (1001, torch.bfloat16, "gather", "window"),
    (2048, torch.bfloat16, "gather", "window"),
    (4096, torch.float32, "gather", "window"),
    (7216, torch.bfloat16, "gather", "window"),
    (7216, torch.float32, "fused_sums", "fused_sums"),   # no ring fits
    (8200, torch.bfloat16, "fused_sums", "fused_sums"),  # > WINDOW_MAX_D
    (47237, torch.float32, "fused_sums", "fused_sums"),
]


@pytest.mark.parametrize("masked", [True, False], ids=["mask", "all"])
@pytest.mark.parametrize("d,dtype,gather,window", ROUTES,
                         ids=[f"{d}-{str(t)[6:]}" for d, t, _, _ in ROUTES])
def test_route_by_width_and_type(d, dtype, gather, window, masked):
    X = torch.empty(2, d, dtype=dtype)
    assert ck.gradient_sums_route(X, masked) == (gather if masked
                                                 else window)
    has_plan = ck.window_stage_plan(d, X.element_size(), True) is not None
    assert has_plan == (gather != "fused_sums")


@pytest.mark.parametrize("masked", [True, False], ids=["mask", "all"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_misaligned_base_goes_to_the_ring(dtype, masked):
    """A view one element past an aligned base: each row lands through its
    16-byte aligned superset, so the call stays on window_sums.cu, with
    the plan of rows that are not whole units."""
    base = torch.zeros(3 * 1000 + 1, dtype=dtype)
    route = "gather" if masked else "window"
    assert ck.gradient_sums_route(base[:3000].view(3, 1000), masked) == route
    X = base[1:].view(3, 1000)
    assert ck.gradient_sums_route(X, masked) == route
    assert ck.window_plan_for(X) == ck.window_stage_plan(
        1000, X.element_size(), aligned_base=False)


# A numpy mirror of csrc/window_sums.cu's two producers, in the kernel's
# order: which rows each block's tiles hold, and (gather) the bulk copies
# that fill them.

#: rows of the mask the gather entry's producer warp reads a step (one
#: 16-byte load of 16 flags a lane)
STEP_ROWS = 512


def _share(rows: int, blocks: int, b: int) -> tuple:
    return rows * b // blocks, rows * (b + 1) // blocks


def window_tiles(rows: int, plan: ck.StagePlan, blocks: int) -> list:
    """The window entry's tiles: for each block, its share of rows ``[0,
    rows)`` (offsets from the window's first row) in tiles of
    ``plan.stage_rows``, the last one partial."""
    R = plan.stage_rows
    out = []
    for b in range(blocks):
        lo, hi = _share(rows, blocks, b)
        out.append([np.arange(r, min(r + R, hi)) for r in range(lo, hi, R)])
    return out


class GatherTile(NamedTuple):
    """One tile the gather entry deals: its rows in slot order, and the
    bulk copies that fill it, ``(first row, first slot, rows)`` each, in
    the order the producer issues them."""

    rows: np.ndarray
    copies: tuple


def gather_tiles(mask, plan: ck.StagePlan, blocks: int,
                 address: int = 0) -> list:
    """The gather entry's tiles, as its producer warp deals them (numpy,
    in the kernel's order): for each block, the live rows of its share of
    ``mask`` in tiles of ``plan.stage_rows``, every tile full but the
    share's last, which is partial or empty.  ``address`` is the mask's
    device address modulo 16: the producer's 16-byte flag loads begin at
    the aligned unit holding the share's first flag, so it moves the
    steps' bounds (never the tiles)."""
    mask = np.asarray(mask, dtype=bool)
    n = mask.size
    R = plan.stage_rows
    lanes = np.arange(32)
    out = []
    for b in range(blocks):
        b_begin, b_end = _share(n, blocks, b)
        first = b_begin - (address + b_begin) % 16
        tiles, rows, copies = [], [], []
        dealt = 0
        for c0 in range(first, b_end, STEP_ROWS):
            r0 = c0 + 16 * lanes
            k = np.arange(16)
            r = r0[:, None] + k[None, :]
            inside = (r >= b_begin) & (r < b_end)
            live = np.zeros_like(inside)
            live[inside] = mask[r[inside]]
            cnt = live.sum(axis=1)
            total = int(cnt.sum())
            q0 = dealt + np.cumsum(cnt) - cnt
            order = np.cumsum(live, axis=1) - live  # rank within the lane
            t = dealt // R
            while t * R < dealt + total:
                lo = t * R
                for lane in lanes:
                    run = None
                    for kk in np.flatnonzero(live[lane]):
                        o = q0[lane] + order[lane, kk]
                        if not lo <= o < lo + R:
                            continue
                        row = int(r0[lane] + kk)
                        rows.append((o - lo, row))
                        if run is not None and row == run[0] + run[2]:
                            run[2] += 1
                        else:
                            if run is not None:
                                copies.append(tuple(run))
                            run = [row, int(o - lo), 1]
                    if run is not None:
                        copies.append(tuple(run))
                if lo + R <= dealt + total:
                    tiles.append(_gather_tile(rows, copies))
                    rows, copies = [], []
                t += 1
            dealt += total
        tiles.append(_gather_tile(rows, copies))
        out.append(tiles)
    return out


def _gather_tile(rows, copies) -> GatherTile:
    by_slot = np.array([r for _, r in sorted(rows)], dtype=np.int64)
    return GatherTile(by_slot, tuple(copies))


PLANS = {
    "1000-bf16": ck.window_stage_plan(1000, 2, True),   # R = 16
    "1000-f32": ck.window_stage_plan(1000, 4, True),    # R = 8
    "4096-f32": ck.window_stage_plan(4096, 4, True),    # R = 4
}


def _mask(kind, n, blocks, seed):
    r = np.random.default_rng(seed)
    if kind == "empty":
        return np.zeros(n, bool)
    if kind == "full":
        return np.ones(n, bool)
    if kind == "prefix":
        m = np.zeros(n, bool)
        m[:n // 8] = True
        return m
    if kind == "one_row":
        m = np.zeros(n, bool)
        m[n // 3] = True
        return m
    if kind == "share_edges":
        # live rows only at each block's share boundaries
        m = np.zeros(n, bool)
        for b in range(1, blocks):
            e = n * b // blocks
            m[e - 1] = m[e] = True
        return m
    return r.uniform(size=n) < float(kind)


MASKS = ["empty", "one_row", "0.001", "0.1", "0.3", "full", "prefix",
         "share_edges"]


@pytest.mark.parametrize("address", [0, 7])
@pytest.mark.parametrize("kind", MASKS)
@pytest.mark.parametrize("plan_id", sorted(PLANS))
def test_gather_deals_every_live_row_once_in_order(plan_id, kind, address):
    """Every live row is dealt once, in row order, into tiles of R rows
    (all full but each share's last, which is partial or empty); each
    bulk copy fills consecutive slots from consecutive live rows, and no
    dropped row is read."""
    plan = PLANS[plan_id]
    n = 5_003
    blocks = ck.ring_grid(n, plan, sms=8)
    mask = _mask(kind, n, blocks, seed=len(kind) + address)
    tiles = gather_tiles(mask, plan, blocks, address)
    assert len(tiles) == blocks
    dealt = np.concatenate([t.rows for b in tiles for t in b])
    np.testing.assert_array_equal(dealt, np.flatnonzero(mask))
    R = plan.stage_rows
    for b, share in enumerate(tiles):
        lo, hi = n * b // blocks, n * (b + 1) // blocks
        assert all(t.rows.size == R for t in share[:-1])
        assert share[-1].rows.size < R
        assert sum(t.rows.size for t in share) == mask[lo:hi].sum()
        for t in share:
            slots = np.zeros(t.rows.size, int)
            for row, slot, count in t.copies:
                assert count >= 1 and mask[row:row + count].all()
                np.testing.assert_array_equal(
                    t.rows[slot:slot + count], np.arange(row, row + count))
                slots[slot:slot + count] += 1
            assert (slots == 1).all()


@pytest.mark.parametrize("plan_id", sorted(PLANS))
@pytest.mark.parametrize("n", [1, 15, 16, 17, 5_003, 20_000])
def test_all_true_gather_deals_the_window_tiles(plan_id, n):
    """With every row live, the gather entry's split and tiles are the
    window entry's over ``[0, n)`` (less the empty tile that ends a share
    whose rows are a multiple of R), so the two give the same bits."""
    plan = PLANS[plan_id]
    blocks = ck.ring_grid(n, plan, sms=132)
    window = window_tiles(n, plan, blocks)
    gather = gather_tiles(np.ones(n, bool), plan, blocks, address=3)
    for w_share, g_share in zip(window, gather, strict=True):
        g_rows = [t.rows for t in g_share if t.rows.size]
        assert len(g_rows) == len(w_share)
        for a, b in zip(g_rows, w_share):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("rows", [0, 1, 16, 17, 2_000, 128_000, 1_250_000,
                                  10_000_000])
def test_ring_grid_caps(rows):
    """As many clusters as the card holds (132 SMs, two blocks an SM for
    d = 1000 bf16, clusters of 2), none beyond the rows' tiles, at least
    one."""
    plan = PLANS["1000-bf16"]
    blocks = ck.ring_grid(rows, plan, sms=132)
    tiles = -(-rows // plan.stage_rows)
    assert blocks % plan.cluster == 0
    assert plan.cluster <= blocks <= 132 * plan.blocks_per_sm
    if tiles > 132 * plan.blocks_per_sm:
        assert blocks == 132 * plan.blocks_per_sm
    else:
        assert blocks == max(plan.cluster,
                             -(-tiles // plan.cluster) * plan.cluster)
    assert ck.ring_grid(rows, plan, sms=132, max_clusters=5) <= 10


# A numpy mirror of the producers' copies of rows that are not whole
# 16-byte units (the kernel's ALIGNED = false instances), and of the
# consumers' reads: each row lands through its 16-byte aligned superset
# (aligned_span) into its own slot of window_row_pitch bytes.


class RowSpan(NamedTuple):
    """One row's bulk copy: the superset's first address and bytes, the
    row's lead (its address mod 16: bytes of the superset before it), and
    the slot's offset in its stage."""

    address: int
    base: int
    lead: int
    nbytes: int
    slot: int


def row_span(address: int, row_bytes: int, slot: int) -> RowSpan:
    base = address & ~15
    lead = address - base
    return RowSpan(address, base, lead, -(-(lead + row_bytes) // 16) * 16,
                   slot)


def window_spans(x0: int, d: int, itemsize: int, rows: int,
                 plan: ck.StagePlan, blocks: int) -> list:
    """The window entry's copies, tile by tile (the rows of
    ``window_tiles``; X's first row at address ``x0``): row k of a tile
    into slot k."""
    row, pitch = d * itemsize, plan.stage_bytes // plan.stage_rows
    return [[row_span(x0 + int(r) * row, row, k * pitch)
             for k, r in enumerate(tile)]
            for share in window_tiles(rows, plan, blocks) for tile in share]


def gather_spans(x0: int, d: int, itemsize: int, mask,
                 plan: ck.StagePlan, blocks: int) -> list:
    """The gather entry's copies, tile by tile: its runs of consecutive
    live rows (``gather_tiles``) a row at a time, each into its slot."""
    row, pitch = d * itemsize, plan.stage_bytes // plan.stage_rows
    out = []
    for share in gather_tiles(mask, plan, blocks):
        for tile in share:
            out.append([row_span(x0 + (first + e) * row, row,
                                 (slot + e) * pitch)
                        for first, slot, count in tile.copies
                        for e in range(count)])
    return out


# (d, itemsize, base offset from a 16-byte unit): rows that are not whole
# units, the widest of each type with a plan, and whole-unit rows on a
# base one element off alignment
UNALIGNED = [(7, 4, 0), (101, 4, 0), (101, 4, 4), (123, 4, 12),
             (4121, 4, 8), (100, 2, 0), (785, 2, 2), (1001, 2, 0),
             (1001, 2, 14), (4097, 2, 6), (7209, 2, 10), (1000, 2, 2),
             (24, 4, 4)]


def _check_spans(tiles, d, itemsize, plan, window):
    """Every copy legal (16-byte aligned, whole units), holding exactly its
    row's units in its own slot; the window entry's consumers' lead, from
    the tile's first row's address and the row's index, equal to the
    producer's (the gather entry's consumers read the lead its producer
    stores); every read of a stage's last row inside the stage and its
    label area."""
    row = d * itemsize
    pitch = plan.stage_bytes // plan.stage_rows
    vec = 16 // itemsize
    nvec = -(-d // vec)
    nchunk = -(-d // 4)
    for tile in tiles:
        assert len(tile) <= plan.stage_rows
        x0 = tile[0].address if tile else 0
        for k, sp in enumerate(tile):
            assert sp.base % 16 == 0 and sp.nbytes % 16 == 0
            assert 0 <= sp.lead < 16 and sp.lead % itemsize == 0
            assert sp.lead + row <= sp.nbytes <= pitch
            # only the units that hold bytes of the row: no page beyond
            assert sp.base // 16 == sp.address // 16
            assert (sp.base + sp.nbytes - 1) // 16 \
                == (sp.address + row - 1) // 16
            assert sp.slot % 16 == 0 and sp.slot + pitch <= plan.stage_bytes
            if window:
                assert (x0 + k * row) % 16 == sp.lead
        # the margins read units c and c + 1 of a slot for c < nvec, the
        # column pass 8-byte words j + lead // 8 and the next (bf16) or
        # units j and j + 1 (f32), j < nchunk: all inside the stage's
        # rows and labels, whatever the lead
        last = (plan.stage_rows - 1) * pitch
        reach = max(16 * (nvec + 1),
                    8 * (nchunk + 15 // 8 + 1) if itemsize == 2
                    else 16 * (nchunk + 1))
        assert last + reach <= plan.stage_bytes + ck.WINDOW_LABEL_BYTES
    # adjacent rows share at most the unit they meet in
    flat = sorted((sp for t in tiles for sp in t), key=lambda s: s.address)
    for a, b in zip(flat, flat[1:]):
        if b.address == a.address + row:
            assert b.base >= a.base + a.nbytes - 16


@pytest.mark.parametrize("d,itemsize,offset", UNALIGNED,
                         ids=[f"{d}-{i}-{o}" for d, i, o in UNALIGNED])
def test_unaligned_pitch_is_the_supersets_bound(d, itemsize, offset):
    """The planner's slot (``window_row_pitch``) is the least multiple of
    16 that holds a row's superset at every lead an element-aligned base
    gives, and the plan's stages are sized with it (``window_stage_plan``,
    the source's ``row_pitch`` and ``ring_smem``)."""
    row = d * itemsize
    aligned = row % 16 == 0 and offset == 0
    pitch = ck.window_row_pitch(d, itemsize, offset == 0)
    worst = max(row_span(lead, row, 0).nbytes
                for lead in range(0, 16, itemsize))
    assert pitch == (row if aligned else worst)
    plan = ck.window_stage_plan(d, itemsize, offset == 0)
    assert plan is not None
    assert plan.stage_bytes == plan.stage_rows * pitch
    pd = ck.window_padded_d(d, itemsize)
    assert pd % (16 // itemsize) == 0 and d <= pd < d + 16 // itemsize
    assert plan.smem_bytes == plan.stages * (
        plan.stage_bytes + ck.WINDOW_LABEL_BYTES) + 8 * pd
    assert plan.blocks_per_sm * (
        plan.smem_bytes + ck._WINDOW_STATIC_SMEM
        + ck._SMEM_RESERVED_PER_BLOCK) <= ck.SMEM_PER_SM


@pytest.mark.parametrize("d,itemsize,offset", UNALIGNED,
                         ids=[f"{d}-{i}-{o}" for d, i, o in UNALIGNED])
def test_window_producer_spans(d, itemsize, offset):
    """The window entry's copy of every row of its tiles, at rows of any
    width on an element-aligned base (a 512-byte aligned allocation plus
    ``offset``)."""
    plan = ck.window_stage_plan(d, itemsize, offset == 0)
    n = 1_003
    blocks = ck.ring_grid(n, plan, sms=4)
    x0 = 4096 * 512 + offset
    tiles = window_spans(x0, d, itemsize, n, plan, blocks)
    assert sum(len(t) for t in tiles) == n
    assert [sp.address for t in tiles for sp in t] == [
        x0 + r * d * itemsize for r in range(n)]
    _check_spans(tiles, d, itemsize, plan, window=True)


@pytest.mark.parametrize("kind", ["0.1", "full", "share_edges"])
@pytest.mark.parametrize("d,itemsize,offset", UNALIGNED,
                         ids=[f"{d}-{i}-{o}" for d, i, o in UNALIGNED])
def test_gather_producer_spans(d, itemsize, offset, kind):
    """The gather entry's copies: every live row once, a row at a time,
    into the slot it is dealt to, with its lead."""
    plan = ck.window_stage_plan(d, itemsize, offset == 0)
    n = 1_003
    blocks = ck.ring_grid(n, plan, sms=4)
    mask = _mask(kind, n, blocks, seed=d)
    x0 = 4096 * 512 + offset
    tiles = gather_spans(x0, d, itemsize, mask, plan, blocks)
    got = sorted(sp.address for t in tiles for sp in t)
    assert got == [x0 + int(r) * d * itemsize for r in np.flatnonzero(mask)]
    for t in tiles:
        assert len({sp.slot for sp in t}) == len(t)
    _check_spans([t for t in tiles if t], d, itemsize, plan, window=False)


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
        np.testing.assert_allclose(l, lr, rtol=1e-3, atol=1e-6)
    else:
        np.testing.assert_allclose(g, gr, rtol=2e-4, atol=2e-3)
        np.testing.assert_allclose(l, lr, rtol=2e-4, atol=1e-9)
    assert float(c) == float(cr)


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("density", ["zero", "one_row", "0.1", "all"])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_masked_sums_match_pallas_by_density(family, density, bf16):
    """The CPU path of ``fused_gradient_sums`` against the Pallas masked
    kernel in interpret mode, at 0 live rows (count 0, zero gradient), one
    live row, 10% and every row; counts exact."""
    n, d = 333, 24
    jX, tX, y, w = _problem(family, n, d, 21, bf16)
    r = np.random.default_rng(22)
    mask = {"zero": np.zeros(n, bool),
            "one_row": np.arange(n) == 200,
            "0.1": r.uniform(size=n) < 0.1,
            "all": np.ones(n, bool)}[density]
    jcls, tcls = FAMILIES[family]
    ref = jpk.fused_gradient_sums(jcls().pointwise, jX, jnp.asarray(y),
                                  jnp.asarray(w), jnp.asarray(mask),
                                  tile_m=128, interpret=True)
    got = ck.fused_gradient_sums(tcls().pointwise, tX, torch.from_numpy(y),
                                 torch.from_numpy(w), torch.from_numpy(mask))
    _assert_sums(got, ref, bf16)
    assert float(got[2]) == mask.sum()
    if density == "zero":
        assert not bool(got[0].any()) and float(got[1]) == 0.0


def test_route_counts_move_to_the_replays():
    """``fused_gradient_sums``'s launches by route follow the capture and
    replay rule of the other counts, and a reset zeroes them."""
    ck.reset_launch_counts()
    ck.count_launch(route="gather")  # an eager launch before
    with ck.captured_launches() as record:
        for _ in range(2):
            ck.count_launch(route="window")
    assert ck.gradient_route_counts() == {"gather": 1, "window": 0,
                                          "fused_sums": 0}
    assert record["routes"] == {"gather": 0, "window": 2, "fused_sums": 0}
    ck.add_replayed_launches(record)
    ck.add_replayed_launches(record)
    assert ck.gradient_route_counts() == {"gather": 1, "window": 4,
                                          "fused_sums": 0}
    ck.reset_launch_counts()
    assert ck.gradient_route_counts() == {"gather": 0, "window": 0,
                                          "fused_sums": 0}

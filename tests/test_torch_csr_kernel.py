"""The CSR kernel's host side (``tpu_sgd_torch/ops/cuda_kernels.py``) on the
CPU: the merge-path split of ``csrc/csr_products.cu`` (:func:`csr_split`,
:func:`csr_path_rows`) against a walk of the path item by item, and a
numpy walk of the kernel's order of additions (walkers, the scan of their
tails, the blocks' carries and the second pass) against the plain twin
``csr_matmul_plain`` and the JAX package's BCOO products.

Inputs are numpy CSR triples made from a seed.  Shapes: empty rows, a
matrix without entries, rows of 1, 31, 32 and 33 entries, a row longer
than three blocks' shares (at a share of 256 items and at the kernel's own
``CSR_BLOCK_ITEMS``), and many rows of one to three entries (a transposed
CSR's tail); T in {1, 2, 25, 30, 1024}; no mask, a mask that keeps every
row, and a Bernoulli mask.  The walk takes int64 numpy arrays whatever the
tensor's index dtype; int32 and int64 indices are held to it on the card
(``chip_smoke.py`` phase ``kernels``).  The split is also taken of an
int64 CSR whose row holds more than 2^31 entries.

The walk (``cuda_kernels.csr_walk``) is the kernel's order bit for bit:
``chip_smoke.py`` holds the card to it.  Tolerances: the walk against the
plain twin within 1e-5 of the product's largest magnitude, the twin
evaluated in f64 (in f32 the twin's own sequential sums drift by 1e-5 of
scale over the longest row); against the JAX package's BCOO products at
the gradient tier of tests/test_torch_ops.py (rtol 2e-4, atol 2e-3); the
split exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_sgd.ops.sparse as js
from tpu_sgd.ops import gradients as jg
from tpu_sgd_torch.ops import cuda_kernels as ck
from tpu_sgd_torch.ops import sparse as ts

SMALL = 256  # a block share that gives small matrices many blocks


def _lengths(name):
    """Row lengths of one test structure and its block share."""
    rng = np.random.default_rng(len(name))
    if name == "mixed":
        fixed = [0, 1, 31, 32, 33, 0, 0, 3 * SMALL + 232, 2, 75]
        lens = np.concatenate([fixed, rng.integers(0, 40, size=30)])
        return lens, SMALL
    if name == "no-entries":
        return np.zeros(50, np.int64), SMALL
    if name == "short-rows":
        return rng.integers(1, 4, size=600), SMALL
    if name == "long-row":  # at the kernel's two shares
        fixed = [5, 3 * ck.CSR_MASKED_BLOCK_ITEMS + 100, 0, 1, 31, 32, 33]
        return np.concatenate([fixed, rng.integers(0, 80, size=50)]), None
    raise ValueError(name)


STRUCTURES = ("mixed", "no-entries", "short-rows", "long-row")


def _triple(name, seed=0, masked=False):
    """``(crow, col, val, k, S)``: distinct sorted columns a row."""
    lens, S = _lengths(name)
    S = S or (ck.CSR_MASKED_BLOCK_ITEMS if masked else ck.CSR_BLOCK_ITEMS)
    k = max(64, int(lens.max()) + 64)
    rng = np.random.default_rng(seed)
    cols = [np.sort(rng.choice(k, size=int(n), replace=False)) for n in lens]
    col = np.concatenate(cols + [np.zeros(0, np.int64)]).astype(np.int64)
    val = rng.normal(size=col.size).astype(np.float32)
    crow = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
    return crow, col, val, k, S


def _path(crow):
    """The merge path item by item: ``(row, entry)`` of each item, entry -1
    for a row's end mark."""
    items = []
    for r in range(crow.size - 1):
        items += [(r, e) for e in range(crow[r], crow[r + 1])]
        items.append((r, -1))
    return items


def _coords(crow, diag):
    """Where the path stands after ``diag`` items: (row, entry)."""
    items = _path(crow)
    rows = crow.size - 1
    if diag >= len(items):
        return rows, int(crow[-1])
    r, e = items[diag]
    return r, (e if e >= 0 else int(crow[r + 1]))


# -- the split ----------------------------------------------------------------

@pytest.mark.parametrize("name", STRUCTURES)
def test_split_covers_every_entry_once_in_order(name):
    crow, _, _, _, S = _triple(name)
    rows, nnz = crow.size - 1, int(crow[-1])
    sp = ck.csr_split(crow, S)
    grid = ck.csr_grid(rows, nnz, S)
    assert grid == -(-(rows + nnz) // S) and sp.head_row.size == grid
    assert (sp.first_row[0], sp.first_entry[0]) == (0, 0)
    assert (sp.first_row[-1], sp.first_entry[-1]) == (rows, nnz)
    # each block takes S path items (the last the rest), rows and entries
    # in order, so the blocks' entry ranges tile [0, nnz) once
    items = np.diff(sp.first_row) + np.diff(sp.first_entry)
    assert np.all(items[:-1] == S) and 0 < items[-1] <= S
    assert np.all(np.diff(sp.first_row) >= 0)
    assert np.all(np.diff(sp.first_entry) >= 0)
    covered = np.concatenate([np.arange(a, b) for a, b in
                              zip(sp.first_entry[:-1], sp.first_entry[1:])])
    assert np.array_equal(covered, np.arange(nnz))
    # and inside a block, the walkers' shares tile the block's items
    for T in (1, 2, 30):
        W, _ = ck.csr_walker_lanes(T)
        walkers = ck.CSR_BLOCK_THREADS // W
        per = S // walkers
        for b in range(grid):
            d0, d1 = b * S, min(b * S + S, rows + nnz)
            dw = np.minimum(d0 + np.arange(walkers + 1) * per, d1)
            assert dw[0] == d0 and dw[-1] == d1
            r = ck.csr_path_rows(crow, dw)
            assert np.all(np.diff(r) >= 0)
            assert r[0] == sp.first_row[b] and r[-1] == sp.first_row[b + 1]


@pytest.mark.parametrize("name", STRUCTURES)
def test_each_block_starts_where_the_path_walk_stands(name):
    crow, _, _, _, S = _triple(name)
    sp = ck.csr_split(crow, S)
    rows = crow.size - 1
    for b in range(sp.head_row.size + 1):
        diag = min(b * S, rows + int(crow[-1]))
        assert (sp.first_row[b], sp.first_entry[b]) == _coords(crow, diag)
        # the row found is the one a binary search of crow gives for the
        # block's first entry, unless an end mark or an empty row comes first
        r, e = sp.first_row[b], sp.first_entry[b]
        assert crow[min(r, rows)] <= e
        assert r == rows or e <= crow[r + 1]


@pytest.mark.parametrize("name", STRUCTURES)
def test_carries_name_the_right_rows(name):
    crow, _, _, _, S = _triple(name)
    rows, nnz = crow.size - 1, int(crow[-1])
    sp = ck.csr_split(crow, S)
    items = _path(crow)
    for b in range(sp.head_row.size):
        d0, d1 = b * S, min(b * S + S, rows + nnz)
        mine = items[d0:d1]
        ends = {r for r, e in mine if e < 0}
        before = {r for r, e in items[:d0] if e >= 0}
        # the head: the row whose entries began before the block and whose
        # end mark is in it
        heads = [r for r in ends if r in before]
        assert sp.head_row[b] == (heads[0] if heads else -1)
        assert len(heads) <= 1
        # the tail: the row the block ends inside
        assert sp.tail_row[b] == (items[d1][0] if d1 < len(items) else rows)
    # pass 2 adds, for each head, the tails of the blocks from the one
    # holding the row's first entry: exactly the blocks before the head's
    # that hold entries of the row
    for b, r in enumerate(sp.head_row):
        if r < 0:
            continue
        first = (crow[r] + r) // S
        holders = [c for c in range(b) if any(
            rr == r and e >= 0 for rr, e in items[c * S:(c + 1) * S])]
        assert holders == list(range(first, b))
        assert all(sp.tail_row[c] == r for c in holders)


def test_split_of_a_row_past_32_bits():
    """An int64 CSR whose middle row holds more than 2^31 entries: the
    kernel keeps a block's row ends as 32-bit offsets from its first entry
    (each at most the share) and only whether its first row began before
    it; the block where the long row ends, more than 2^31 entries past the
    row's start, carries its part as a head, and every block the row
    crosses before it ends inside it."""
    S = ck.CSR_BLOCK_ITEMS
    L = (-(-2**31 // S) + 2) * S - 9  # row 1's end mark ends its block
    crow = np.cumsum([0, 7, L, 3]).astype(np.int64)
    rows, nnz = 3, int(crow[-1])
    sp = ck.csr_split(crow, S)
    grid = sp.head_row.size
    assert grid == ck.csr_grid(rows, nnz, S) == -(-(rows + nnz) // S)
    end_block = (int(crow[2]) + 1) // S  # the block of row 1's end mark
    assert (int(crow[2]) + 1) % S == S - 1
    assert list(np.flatnonzero(sp.head_row >= 0)) == [end_block]
    assert sp.head_row[end_block] == 1
    assert sp.first_entry[end_block] - crow[1] > 2**31
    assert np.all(sp.tail_row[:end_block] == 1)
    assert np.all(sp.first_row[1:end_block + 1] == 1)
    # each block's row ends before its last row, from its first entry
    for b in (0, 1, end_block - 1, end_block, grid - 1):
        r0, r1 = sp.first_row[b], sp.first_row[b + 1]
        ends = crow[r0 + 1:r1 + 1] - sp.first_entry[b]
        assert np.all((0 <= ends) & (ends <= S))
    # pass 2 adds the tails of blocks 0 .. end_block - 1: the row's first
    # entry, path item crow[1] + 1, lies in block 0
    assert (crow[1] + 1) // S == 0


def test_split_of_a_matrix_without_rows():
    sp = ck.csr_split(np.zeros(1, np.int64))
    assert ck.csr_grid(0, 0) == 0 and sp.head_row.size == 0
    assert list(sp.first_row) == [0] and list(sp.first_entry) == [0]


@pytest.mark.parametrize("T", [1, 2, 3, 4, 5, 16, 17, 25, 30, 32, 33, 64,
                               65, 500, 513, 1024])
def test_walker_lanes_cover_the_columns(T):
    W, C = ck.csr_walker_lanes(T)
    assert W in (1, 2, 4, 8, 16, 32) and C in (1, 2, 4, 8, 16, 32)
    assert W * C >= T and (W == 32 or W >= T) and (C == 1 or W * C < 2 * T)
    walkers = ck.CSR_BLOCK_THREADS // W
    assert ck.CSR_BLOCK_ITEMS % walkers == 0
    # the block's static shared memory: the walkers' tails, their keys and
    # first rows, the window of row ends and mask bytes, the block's rows
    window = 4 * 512 + 513 + 2 * 8 + 8 + 4
    smem = 4 * walkers * W * C + 8 * walkers + 4 * (walkers + 1) + window
    assert smem <= 48 * 1024
    if W == 1:
        # the staged products, and under a mask the keep bytes
        assert 4 * ck.CSR_BLOCK_ITEMS + smem <= 48 * 1024
        assert 5 * ck.CSR_MASKED_BLOCK_ITEMS <= 40 * 1024
    assert ck.CSR_MASKED_BLOCK_ITEMS % ck.CSR_BLOCK_THREADS == 0
    assert ck.csr_carry_floats(7, T) == 7 * (2 * T + 2)


@pytest.mark.parametrize("masked", [False, True])
def test_block_share_follows_from_shapes(masked):
    big = ck.CSR_MASKED_MIN_BLOCKS * ck.CSR_MASKED_BLOCK_ITEMS
    for rows, nnz in ((10, 100), (697_641, 52_323_075), (71_276, 5_300_000),
                      (1, big - 1), (1, big)):
        share = ck.csr_block_items(masked, rows, nnz)
        wide = masked and rows + nnz > big - ck.CSR_MASKED_BLOCK_ITEMS
        assert share == (ck.CSR_MASKED_BLOCK_ITEMS if wide
                         else ck.CSR_BLOCK_ITEMS)
    # the RCV1-scale mask takes the wide share, a streamed batch does not
    assert ck.csr_block_items(True, 697_641, 52_323_075) == \
        ck.CSR_MASKED_BLOCK_ITEMS
    assert ck.csr_block_items(True, 71_276, 5_300_000) == ck.CSR_BLOCK_ITEMS


def test_walker_lanes_refuse_columns_outside_the_rule():
    for T in (0, ck.CSR_MAX_COLUMNS + 1):
        with pytest.raises(ValueError):
            ck.csr_walker_lanes(T)


# -- the kernel's order of additions ------------------------------------------

COLUMNS = (1, 2, 25, 30, 1024)
MASKS = ("none", "all", "bernoulli")


def _mask(kind, rows, seed=3):
    if kind == "none":
        return None
    if kind == "all":
        return np.ones(rows, bool)
    return np.random.default_rng(seed).random(rows) < 0.4


def _rhs(k, T, seed=1):
    return np.random.default_rng(seed).normal(size=(k, T)).astype(np.float32)


def _port_csr(crow, col, val, k):
    return torch.sparse_csr_tensor(
        torch.from_numpy(crow), torch.from_numpy(col),
        torch.from_numpy(val), size=(crow.size - 1, k))


def _close_of_scale(got, ref, rtol):
    scale = float(np.abs(ref).max()) if ref.size else 0.0
    assert not np.isnan(got).any()
    np.testing.assert_allclose(got, ref, rtol=0, atol=rtol * scale + 1e-30)


@pytest.mark.parametrize("mask_kind", MASKS)
@pytest.mark.parametrize("T", COLUMNS)
@pytest.mark.parametrize("name", STRUCTURES)
def test_kernel_order_matches_the_plain_twin(name, T, mask_kind):
    crow, col, val, k, S = _triple(name, masked=mask_kind != "none")
    rows = crow.size - 1
    rhs = _rhs(k, T)
    mask = _mask(mask_kind, rows)
    got = ck.csr_walk(crow, col, val, rhs, mask, S)
    tmask = None if mask is None else torch.from_numpy(mask)
    # the plain twin at f64 (f64 values accumulate in f64): in f32 its own
    # sequential sums drift by 1e-5 of scale over the 23,140-entry row
    X64 = _port_csr(crow, col, val.astype(np.float64), k)
    ref = ck.csr_matmul_plain(X64, torch.from_numpy(rhs), tmask).numpy()
    _close_of_scale(got, ref, 1e-5)
    if mask is not None:
        assert np.all(got[~mask] == 0)


def _bcoo(crow, col, val, k):
    return js.csr_to_bcoo((val, col.astype(np.int32), crow), k,
                          dtype=jnp.float32)


@pytest.mark.parametrize("mask_kind", ("none", "bernoulli"))
@pytest.mark.parametrize("T", COLUMNS)
@pytest.mark.parametrize("name", STRUCTURES)
def test_kernel_order_matches_jax_margins(name, T, mask_kind):
    crow, col, val, k, S = _triple(name, masked=mask_kind != "none")
    rows = crow.size - 1
    rhs = _rhs(k, T)
    mask = _mask(mask_kind, rows)
    got = ck.csr_walk(crow, col, val, rhs, mask, S)
    weights = rhs[:, 0] if T == 1 else rhs.T
    ref = np.asarray(jg.margins_of(_bcoo(crow, col, val, k),
                                   jnp.asarray(weights))).reshape(rows, T)
    if mask is not None:
        ref = np.where(mask[:, None], ref, 0.0)
    np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-3)


@pytest.mark.parametrize("T", COLUMNS)
@pytest.mark.parametrize("name", STRUCTURES)
def test_kernel_order_matches_jax_gradient_sum(name, T):
    """The gradient runs on the transposed CSR, as the port builds it
    (``ops/sparse.py`` ``transpose_csr``): its Zipf-like long rows are the
    columns many rows share."""
    crow, col, val, k, _ = _triple(name)
    rows = crow.size - 1
    Xt = ts.transpose_csr(_port_csr(crow, col, val, k))
    coeff = _rhs(rows, T, seed=5)
    S = SMALL
    got = ck.csr_walk(Xt.crow_indices().numpy(), Xt.col_indices().numpy(),
                      Xt.values().numpy(), coeff, None, S)
    ref = np.asarray(jg.grad_sum_of(
        jnp.asarray(coeff[:, 0] if T == 1 else coeff),
        _bcoo(crow, col, val, k))).reshape(T, k).T
    np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-3)
    Xt64 = torch.sparse_csr_tensor(Xt.crow_indices(), Xt.col_indices(),
                                   Xt.values().double(), size=Xt.shape)
    plain = ck.csr_matmul_plain(Xt64, torch.from_numpy(coeff)).numpy()
    _close_of_scale(got, plain, 1e-5)

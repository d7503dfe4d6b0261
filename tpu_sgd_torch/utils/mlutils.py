"""Data loading and generation, copied from ``tpu_sgd/utils/mlutils.py`` so
the port depends on nothing of the JAX package.

``load_libsvm_file`` parses 1-based LIBSVM text (one file, a directory of
part files, or a glob) into dense arrays or a CSR triple;
``save_as_libsvm_file`` writes it back, from dense or sparse features;
``append_bias`` appends a 1.0 column; ``k_fold`` and ``train_test_split``
split dense or sparse data.  Each file is parsed by the native C++ parser
(``utils/native``, compiled at first use), and by the Python one only where
the JAX package's ``_parse_one`` turns to it: when the native parse raises
(no compiler, or a file it refuses, where the Python parser then raises
its own error).  :data:`last_reader` names the reader of the last file.

The generators make the same seeds, the same draws and the same arrays as
the originals; ``rcv1_like_data`` returns its matrix as a CSR tensor on
the CPU.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import torch

from tpu_sgd_torch.ops.sparse import (
    csr_from_triple,
    host_entries,
    is_sparse,
    take_rows,
)


def append_bias(X):
    """Append a 1.0 bias column (``MLUtils.appendBias``) in X's dtype and
    place; a tensor stays a tensor, int features become float32."""
    if isinstance(X, torch.Tensor):
        ones = torch.ones((X.shape[0], 1), dtype=X.dtype, device=X.device)
        return torch.cat([X, ones], dim=1)
    X = np.asarray(X)
    dtype = X.dtype if np.issubdtype(X.dtype, np.floating) else np.float32
    return np.concatenate([X.astype(dtype, copy=False),
                           np.ones((X.shape[0], 1), dtype)], axis=1)


def _parse_libsvm_python(path: str):
    labels, rows, cols, vals = [], [], [], []
    max_idx = 0
    with open(path, "r") as f:
        for line in f:
            line = line.split("#", 1)[0].strip()
            if not line:
                continue
            parts = line.split()
            labels.append(float(parts[0]))
            r = len(labels) - 1
            for tok in parts[1:]:
                idx, val = tok.split(":")
                j = int(idx) - 1  # 1-based on disk
                if j < 0:
                    raise ValueError(f"invalid 0 index in libsvm file {path}")
                rows.append(r)
                cols.append(j)
                vals.append(float(val))
                max_idx = max(max_idx, j + 1)
    return (
        np.asarray(labels, np.float32),
        np.asarray(rows, np.int64),
        np.asarray(cols, np.int64),
        np.asarray(vals, np.float32),
        max_idx,
    )


#: the reader of the last file parsed: ``"native"`` or ``"python"``
last_reader: Optional[str] = None


def _parse_one(path: str):
    global last_reader
    from tpu_sgd_torch.utils.native import parse_libsvm

    try:
        out = parse_libsvm(path)
        last_reader = "native"
    except Exception:
        last_reader = "python"
        out = _parse_libsvm_python(path)
    return out


def _resolve_input_paths(path: str):
    """Expand ``path`` as ``sc.textFile`` does: a directory reads its part
    files (sorted; markers like _SUCCESS and hidden files skipped), a glob
    pattern expands, a plain path is one file.  Raises FileNotFoundError
    when nothing matches."""
    import glob as _glob

    def _is_data_file(p):
        base = os.path.basename(p)
        return (not base.startswith((".", "_"))) and os.path.isfile(p)

    if os.path.isdir(path):
        files = sorted(
            os.path.join(path, f)
            for f in os.listdir(path)
            if _is_data_file(os.path.join(path, f))
        )
    elif os.path.exists(path):
        # a literal path wins over its reading as a glob, so a filename
        # that merely contains glob characters is never shadowed
        files = [path]
    elif any(c in path for c in "*?["):
        files = sorted(p for p in _glob.glob(path) if _is_data_file(p))
    else:
        files = []
    if not files:
        raise FileNotFoundError(f"no input files match {path!r}")
    return files


def load_libsvm_file(
    path: str,
    num_features: Optional[int] = None,
    dense: bool = True,
    dtype=np.float32,
):
    """Load LIBSVM-format data.

    ``path`` may be one file, a directory of part files, or a glob; rows
    concatenate in sorted-filename order.  ``num_features`` defaults to
    the largest index seen.  ``dense=True`` returns ``(X, y)`` with X a
    dense array; ``dense=False`` returns a CSR triple ``((data, indices,
    indptr), y, num_features)`` (``ops.sparse.csr_from_triple`` makes a
    tensor of it).  A feature index repeated on one line raises
    ``ValueError``."""
    files = _resolve_input_paths(path)
    if len(files) == 1:
        labels, rows, cols, vals, max_idx = _parse_one(files[0])
    else:
        parts = [_parse_one(f) for f in files]
        offsets = np.cumsum([0] + [p[0].shape[0] for p in parts[:-1]])
        labels = np.concatenate([p[0] for p in parts])
        rows = np.concatenate(
            [p[1] + off for p, off in zip(parts, offsets)]
        )
        cols = np.concatenate([p[2] for p in parts])
        vals = np.concatenate([p[3] for p in parts])
        max_idx = max(p[4] for p in parts)
    d = num_features if num_features is not None else max_idx
    n = labels.shape[0]
    if rows.size:
        order0 = np.lexsort((cols, rows))
        rs, cs = rows[order0], cols[order0]
        dup = (rs[1:] == rs[:-1]) & (cs[1:] == cs[:-1])
        if dup.any():
            # the dense path would keep the last value while the CSR path
            # keeps both (summing in products): one file, two matrices
            j = int(np.nonzero(dup)[0][0])
            raise ValueError(
                f"duplicate feature index {int(cs[j]) + 1} on data line "
                f"{int(rs[j]) + 1} (LIBSVM rows need unique indices)"
            )
    if dense:
        X = np.zeros((n, d), dtype)
        X[rows, cols] = vals
        return X, labels
    order = order0 if rows.size else np.zeros((0,), np.int64)
    rows, cols, vals = rows[order], cols[order], vals[order]
    indptr = np.zeros((n + 1,), np.int64)
    np.add.at(indptr, rows + 1, 1)
    indptr = np.cumsum(indptr)
    return (vals.astype(dtype), cols, indptr), labels, d


def _save_partitioned(path: str, n_items: int, num_partitions: int,
                      write_slice) -> None:
    """The ``saveAsTextFile`` directory layout: refuse an existing output
    path, write ``part-NNNNN`` slices by even row bounds, then the
    ``_SUCCESS`` marker.  ``write_slice(part_path, lo, hi)`` writes one
    part file."""
    if os.path.exists(path):
        # a rewrite with fewer partitions would leave stale part files
        # that the directory loader mixes in
        raise FileExistsError(
            f"output path {path!r} already exists; remove it first "
            "(saveAsTextFile semantics)"
        )
    os.makedirs(path)
    bounds = np.linspace(0, n_items, num_partitions + 1).astype(int)
    for p in range(num_partitions):
        write_slice(
            os.path.join(path, f"part-{p:05d}"),
            int(bounds[p]), int(bounds[p + 1]),
        )
    open(os.path.join(path, "_SUCCESS"), "w").close()


def save_as_libsvm_file(path: str, X, y, num_partitions: int = 1) -> None:
    """Write ``(X, y)`` as 1-based LIBSVM text; zero entries are dropped.
    ``X`` may be dense (array or tensor) or sparse (any layout): sparse
    rows are written from their entry lists, never densified.

    ``num_partitions > 1`` writes ``path`` as a directory of part-NNNNN
    files plus a ``_SUCCESS`` marker, which ``load_libsvm_file(path)``
    reads back."""
    y = np.asarray(y)
    if num_partitions > 1:
        _save_partitioned(
            path, y.shape[0], num_partitions,
            lambda p, lo, hi: save_as_libsvm_file(
                p, _take_rows(X, np.arange(lo, hi)), y[lo:hi]),
        )
        return
    if is_sparse(X):
        rows, cols, vals = host_entries(X)  # row-major sorted
        n, d = X.shape
        # coalesce duplicate entries (they sum) and drop stored zeros, as
        # the dense branch writes each nonzero once
        key = rows.astype(np.int64) * d + cols
        uniq, inv = np.unique(key, return_inverse=True)
        summed = np.zeros(uniq.shape, np.float64)
        np.add.at(summed, inv, vals)
        keep = summed != 0.0
        uniq, summed = uniq[keep], summed[keep]
        rows, cols = uniq // d, (uniq % d).astype(np.int64)
        starts = np.searchsorted(rows, np.arange(n))
        ends = np.searchsorted(rows, np.arange(n), side="right")
        cols_l, vals_l = cols.tolist(), summed.tolist()
        y_l = y.tolist()
        with open(path, "w") as f:
            for i in range(n):
                feats = " ".join(
                    f"{cols_l[k] + 1}:{vals_l[k]:.9g}"
                    for k in range(starts[i], ends[i])
                )
                f.write(f"{y_l[i]:.9g} {feats}\n")
        return
    X = X.cpu().numpy() if isinstance(X, torch.Tensor) else np.asarray(X)
    with open(path, "w") as f:
        for i in range(X.shape[0]):
            nz = np.nonzero(X[i])[0]
            feats = " ".join(f"{j + 1}:{X[i, j]:.9g}" for j in nz)
            f.write(f"{y[i]:.9g} {feats}\n")


def load_labeled_points(path: str):
    """Read ``LabeledPoint`` text lines (``MLUtils.loadLabeledPoints``:
    ``(label,[f0,f1,...])`` and ``(label,(size,[indices],[values]))``)
    from one file, a directory of part files, or a glob.  Returns a list
    of ``LabeledPoint``; ``models.to_arrays`` or any ``train()`` takes
    it."""
    from tpu_sgd_torch.models.labeled_point import LabeledPoint

    points = []
    for p in _resolve_input_paths(path):
        with open(p) as f:
            for line in f:
                line = line.strip()
                if line:
                    points.append(LabeledPoint.parse(line))
    return points


def save_labeled_points(path: str, points, num_partitions: int = 1) -> None:
    """Write ``LabeledPoint``s in the reference's text form, read back by
    :func:`load_labeled_points`: dense ``(label,[f0,f1,...])``, sparse
    ``(label,(size,[i0,...],[v0,...]))``.  ``num_partitions > 1`` writes
    the part-file directory layout."""
    from tpu_sgd_torch.linalg import SparseVector

    points = list(points)
    if num_partitions > 1:
        _save_partitioned(
            path, len(points), num_partitions,
            lambda p, lo, hi: save_labeled_points(p, points[lo:hi]),
        )
        return
    with open(path, "w") as f:
        for lp in points:
            feats = lp.features
            if isinstance(feats, SparseVector):
                idx = ",".join(str(int(i)) for i in feats.indices)
                val = ",".join(f"{float(v):.9g}" for v in feats.values)
                f.write(f"({lp.label:.9g},({feats.size},[{idx}],[{val}]))\n")
            else:
                arr = np.asarray(
                    feats.to_array() if hasattr(feats, "to_array") else feats
                ).ravel()
                body = ",".join(f"{float(v):.9g}" for v in arr)
                f.write(f"({lp.label:.9g},[{body}])\n")


def _take_rows(X, idx):
    """Rows ``idx`` of dense or sparse ``X``, bounds checked for both (a
    negative index would otherwise select a tail row)."""
    if is_sparse(X):
        return take_rows(X, idx)
    idx = np.asarray(idx)
    n = X.shape[0]
    if idx.size and (idx.min() < 0 or idx.max() >= n):
        raise IndexError(
            f"row indices must lie in [0, {n}); got range "
            f"[{idx.min()}, {idx.max()}]"
        )
    if isinstance(X, torch.Tensor):
        return X[torch.as_tensor(idx, dtype=torch.int64, device=X.device)]
    return np.asarray(X)[idx]


def _num_rows(X) -> int:
    return int(X.shape[0]) if isinstance(X, torch.Tensor) \
        else int(np.asarray(X).shape[0])


def k_fold(X, y, num_folds: int, seed: int = 42):
    """Yield ``(train, validation)`` splits (``MLUtils.kFold``): a seeded
    shuffle cut into ``num_folds`` disjoint validation folds, each paired
    with the rest as training data.  Dense or sparse features."""
    n = _num_rows(X)
    if num_folds < 2:
        raise ValueError("num_folds must be >= 2")
    perm = np.random.default_rng(seed).permutation(n)
    folds = np.array_split(perm, num_folds)
    y = np.asarray(y)
    for i in range(num_folds):
        val_idx = folds[i]
        train_idx = np.concatenate([folds[j] for j in range(num_folds) if j != i])
        yield (
            (_take_rows(X, train_idx), y[train_idx]),
            (_take_rows(X, val_idx), y[val_idx]),
        )


def train_test_split(X, y, test_fraction: float = 0.2, seed: int = 42):
    """Seeded shuffle split (the analogue of ``RDD.randomSplit``); dense or
    sparse features."""
    n = _num_rows(X)
    perm = np.random.default_rng(seed).permutation(n)
    n_test = int(round(test_fraction * n))
    te, tr = perm[:n_test], perm[n_test:]
    y = np.asarray(y)
    return (_take_rows(X, tr), y[tr]), (_take_rows(X, te), y[te])


def linear_data(
    n: int,
    d: int,
    intercept: float = 0.0,
    weights: Optional[np.ndarray] = None,
    eps: float = 0.1,
    seed: int = 42,
    dtype=np.float32,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """y = X.w + b + N(0, eps); returns (X, y, true_weights)."""
    rng = np.random.default_rng(seed)
    w = (
        np.asarray(weights, dtype)
        if weights is not None
        else rng.uniform(-1.0, 1.0, size=(d,)).astype(dtype)
    )
    X = rng.normal(size=(n, d)).astype(dtype)
    y = (X @ w + intercept + eps * rng.normal(size=(n,))).astype(dtype)
    return X, y, w


def logistic_data(
    n: int,
    d: int,
    weights: Optional[np.ndarray] = None,
    intercept: float = 0.0,
    seed: int = 42,
    dtype=np.float32,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Labels in {0,1} drawn from sigmoid(X.w + b); returns (X, y, w)."""
    rng = np.random.default_rng(seed)
    w = (
        np.asarray(weights, dtype)
        if weights is not None
        else rng.uniform(-1.0, 1.0, size=(d,)).astype(dtype)
    )
    X = rng.normal(size=(n, d)).astype(dtype)
    p = 1.0 / (1.0 + np.exp(-(X @ w + intercept)))
    y = (rng.uniform(size=(n,)) < p).astype(dtype)
    return X, y, w


def a9a_like_data(
    n: int,
    seed: int = 42,
    dtype=np.float32,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Synthetic stand-in with the real a9a's structure: 123 binary
    features as the Adult dataset's one-hot groups, exactly 14 active per
    row, labels from a logistic model over the binary design.  Returns
    ``(X, y, w_true)`` with X dense {0,1}."""
    groups = [8, 16, 7, 14, 6, 5, 2, 41, 5, 5, 4, 4, 3, 3]
    assert sum(groups) == 123
    rng = np.random.default_rng(seed)
    d = 123
    w = rng.normal(scale=0.8, size=(d,)).astype(dtype)
    X = np.zeros((n, d), dtype)
    offset = 0
    for g in groups:
        probs = rng.dirichlet(np.full((g,), 0.5))
        choice = rng.choice(g, size=(n,), p=probs)
        X[np.arange(n), offset + choice] = 1.0
        offset += g
    margin = X @ w - float(np.mean(X @ w))  # roughly balanced classes
    p_pos = 1.0 / (1.0 + np.exp(-margin))
    y = (rng.uniform(size=(n,)) < p_pos).astype(dtype)
    return X, y, w


def svm_data(
    n: int,
    d: int,
    weights: Optional[np.ndarray] = None,
    intercept: float = 0.0,
    noise: float = 0.1,
    seed: int = 42,
    dtype=np.float32,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Labels in {0,1} by sign of noisy margin (parity with
    SVMDataGenerator's sign(x.w + noise))."""
    rng = np.random.default_rng(seed)
    w = (
        np.asarray(weights, dtype)
        if weights is not None
        else rng.uniform(-1.0, 1.0, size=(d,)).astype(dtype)
    )
    X = rng.normal(size=(n, d)).astype(dtype)
    margin = X @ w + intercept + noise * rng.normal(size=(n,))
    y = (margin > 0).astype(dtype)
    return X, y, w


def rcv1_like_data(
    n: int,
    d: int = 47_236,
    nnz_per_row: int = 75,
    seed: int = 42,
):
    """Synthetic stand-in with the real RCV1's structure: ``d`` features
    (47,236 by default) with Zipf document frequencies, ``nnz_per_row``
    distinct nonzeros per row, positive lognormal values, unit-length rows,
    labels from a sparse linear model thresholded at the median margin.
    The same numpy draws as the JAX version; returns ``(X: CSR on the CPU,
    y, w_true)``."""
    rng = np.random.default_rng(seed)
    pop = 1.0 / np.arange(1, d + 1) ** 0.9
    pop /= pop.sum()
    w = np.zeros((d,), np.float32)
    active = rng.choice(d, size=max(8, d // 100), replace=False, p=pop)
    w[active] = rng.normal(scale=1.5, size=active.shape).astype(np.float32)

    # weighted sampling without replacement per row by Gumbel top-k, in
    # row chunks that bound the noise matrix to ~512 MB
    log_pop = np.log(pop).astype(np.float32)
    cols = np.empty((n, nnz_per_row), np.int32)
    vals = np.empty((n, nnz_per_row), np.float32)
    chunk = max(1, min(n, (1 << 27) // max(d, 1)))
    for lo in range(0, n, chunk):
        hi = min(lo + chunk, n)
        u = rng.random(size=(hi - lo, d), dtype=np.float32)
        np.clip(u, np.finfo(np.float32).tiny, 1.0 - 1e-7, out=u)
        gumbel = -np.log(-np.log(u))
        keys = log_pop[None, :] + gumbel
        top = np.argpartition(keys, d - nnz_per_row, axis=1)[:, -nnz_per_row:]
        cols[lo:hi] = np.sort(top, axis=1).astype(np.int32)
        v = rng.lognormal(
            mean=0.0, sigma=0.5, size=(hi - lo, nnz_per_row)
        ).astype(np.float32)
        vals[lo:hi] = v / np.linalg.norm(v, axis=1, keepdims=True)
    indptr = np.arange(n + 1, dtype=np.int64) * nnz_per_row
    X = csr_from_triple((vals.reshape(-1), cols.reshape(-1), indptr), d)
    margins = np.einsum("ij,ij->i", vals, w[cols])
    y = (margins + 0.05 * rng.normal(size=n) > np.median(margins)).astype(
        np.float32
    )
    return X, y, w

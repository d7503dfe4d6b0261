"""The dataset element type: the port of ``tpu_sgd/models/labeled_point.py``.

``LabeledPoint(label, features)`` keeps the reference's record type for API
parity; ``to_arrays`` turns a collection of points into the columnar
``(X, y)`` form the optimizer consumes.  Features may be raw arrays or
``linalg`` Dense/SparseVector records; any sparse record makes the whole
collection one CSR matrix, trained undensified.
"""

from __future__ import annotations

from typing import Iterable, NamedTuple, Tuple, Union

import numpy as np

from tpu_sgd_torch.linalg import DenseVector, SparseVector, Vectors


class LabeledPoint(NamedTuple):
    label: float
    features: Union[np.ndarray, DenseVector, SparseVector]

    @staticmethod
    def parse(s: str) -> "LabeledPoint":
        """Parse the reference's text forms: dense ``"(label,[f0,f1,...])"``,
        ``"(label,f0,f1,...)"`` or ``"label f0 f1 ..."``, or sparse
        ``"(label,(size,[i0,i1,...],[v0,v1,...]))"``, which yields a
        ``linalg.SparseVector`` record."""
        s = s.strip()
        if s.startswith("("):
            label_str, feat_str = s[1:-1].split(",", 1)
            feat_str = feat_str.strip()
            if feat_str.startswith(("[", "(")):
                feats = Vectors.parse(feat_str)
                if isinstance(feats, DenseVector):
                    feats = feats.to_array()
            else:  # bracket-less tuple form "(label,f0,f1,...)"
                feats = np.asarray(
                    [float(t) for t in feat_str.split(",") if t.strip()],
                    np.float32,
                )
            return LabeledPoint(float(label_str), feats)
        parts = s.split()
        return LabeledPoint(
            float(parts[0]), np.asarray([float(p) for p in parts[1:]], np.float32)
        )


def to_arrays(points: Iterable[LabeledPoint]) -> Tuple:
    """Collection of LabeledPoints -> columnar ``(X, y)``: ``X`` float32
    numpy, or a CSR tensor on the CPU when any record is sparse (a
    SparseVector or a 1-D torch sparse tensor; dense rows then contribute
    their nonzeros)."""
    from tpu_sgd_torch.ops.sparse import csr_from_triple, is_sparse

    pts = list(points)
    if not pts:
        return np.zeros((0, 0), np.float32), np.zeros((0,), np.float32)
    y = np.asarray([p.label for p in pts], np.float32)
    if any(isinstance(p.features, SparseVector) or is_sparse(p.features)
           for p in pts):
        cols_list, vals_list = [], []
        d = 0
        for p in pts:
            f = p.features
            if is_sparse(f):
                f = f.to_sparse_coo().coalesce().cpu()
                f = SparseVector(f.shape[0], f.indices()[0].numpy(),
                                 f.values().numpy())
            if isinstance(f, SparseVector):
                order = np.argsort(f.indices)
                c = np.asarray(f.indices)[order].astype(np.int32)
                v = np.asarray(f.values)[order].astype(np.float32)
                d = max(d, f.size)
            else:
                arr = (
                    f.to_array()
                    if isinstance(f, DenseVector)
                    else np.asarray(f, np.float32)
                )
                c = np.nonzero(arr)[0].astype(np.int32)
                v = arr[c].astype(np.float32)
                d = max(d, arr.shape[0])
            cols_list.append(c)
            vals_list.append(v)
        indptr = np.concatenate(
            [[0], np.cumsum([len(c) for c in cols_list])]
        )
        cols = np.concatenate(cols_list)
        vals = np.concatenate(vals_list)
        return csr_from_triple((vals, cols, indptr), d), y
    X = np.stack([
        p.features.to_array()
        if isinstance(p.features, DenseVector)
        else np.asarray(p.features, np.float32)
        for p in pts
    ])
    return X, y

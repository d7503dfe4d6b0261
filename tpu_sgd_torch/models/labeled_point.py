"""The dataset element type: the port of ``tpu_sgd/models/labeled_point.py``
(numpy only).

``LabeledPoint(label, features)`` keeps the reference's record type for API
parity; ``to_arrays`` turns a collection of points into the columnar
``(X, y)`` float32 form the optimizer consumes.  Dense features only: the
``linalg`` vector records and sparse rows wait for ROADMAP A6.
"""

from __future__ import annotations

from typing import Iterable, NamedTuple, Tuple

import numpy as np


class LabeledPoint(NamedTuple):
    label: float
    features: np.ndarray

    @staticmethod
    def parse(s: str) -> "LabeledPoint":
        """Parse the reference's dense text forms: ``"(label,[f0,f1,...])"``,
        ``"(label,f0,f1,...)"`` or ``"label f0 f1 ..."``."""
        s = s.strip()
        if s.startswith("("):
            label_str, feat_str = s[1:-1].split(",", 1)
            feat_str = feat_str.strip()
            if feat_str.startswith("("):
                raise NotImplementedError(
                    "sparse feature records are not ported yet (ROADMAP A6)"
                )
            feat_str = feat_str.strip("[]")
            feats = np.asarray(
                [float(t) for t in feat_str.split(",") if t.strip()],
                np.float32,
            )
            return LabeledPoint(float(label_str), feats)
        parts = s.split()
        return LabeledPoint(
            float(parts[0]), np.asarray([float(p) for p in parts[1:]], np.float32)
        )


def to_arrays(points: Iterable[LabeledPoint]) -> Tuple[np.ndarray, np.ndarray]:
    """Collection of LabeledPoints -> columnar ``(X, y)`` float32 form."""
    pts = list(points)
    if not pts:
        return np.zeros((0, 0), np.float32), np.zeros((0,), np.float32)
    y = np.asarray([p.label for p in pts], np.float32)
    X = np.stack([np.asarray(p.features, np.float32) for p in pts])
    return X, y

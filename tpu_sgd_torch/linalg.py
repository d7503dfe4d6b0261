"""Vector records and BLAS-level shims: the port of ``tpu_sgd/linalg.py``,
copied (numpy only, nothing imported from the JAX package).

Dense and sparse vector records for loaders and API parity
(``Vectors.parse`` reads the reference's text forms), plus host-side
``dot`` / ``axpy`` / ``scal``.  The training path never calls them: it
works on whole tensors.
"""

from __future__ import annotations

from typing import Sequence, Union

import numpy as np


class DenseVector:
    __slots__ = ("values",)

    def __init__(self, values):
        self.values = np.asarray(values, np.float32)

    @property
    def size(self) -> int:
        return self.values.shape[0]

    def to_array(self) -> np.ndarray:
        return self.values

    def dot(self, other) -> float:
        return float(self.values @ _values_of(other, self.size))

    def __repr__(self):
        return f"DenseVector({self.values.tolist()})"

    def __eq__(self, other):
        return isinstance(other, (DenseVector, SparseVector)) and np.array_equal(
            self.to_array(), _values_of(other, self.size)
        )


class SparseVector:
    __slots__ = ("size", "indices", "values")

    def __init__(self, size: int, indices: Sequence[int], values: Sequence[float]):
        self.size = int(size)
        self.indices = np.asarray(indices, np.int64)
        self.values = np.asarray(values, np.float32)
        if self.size < 0:
            raise ValueError(f"size must be non-negative, got {self.size}")
        if self.indices.shape != self.values.shape:
            raise ValueError("indices and values must have the same length")
        if self.indices.size and (
            self.indices.min() < 0 or self.indices.max() >= self.size
        ):
            # reference parity: SparseVector rejects out-of-range indices
            # rather than silently wrapping (numpy) or dropping (BCOO)
            raise ValueError(
                f"indices must be in [0, {self.size}); got "
                f"[{self.indices.min()}, {self.indices.max()}]"
            )

    def to_array(self) -> np.ndarray:
        out = np.zeros((self.size,), np.float32)
        out[self.indices] = self.values
        return out

    def dot(self, other) -> float:
        return float(self.to_array() @ _values_of(other, self.size))

    def __repr__(self):
        return f"SparseVector({self.size}, {self.indices.tolist()}, {self.values.tolist()})"

    def __eq__(self, other):
        return isinstance(other, (DenseVector, SparseVector)) and np.array_equal(
            self.to_array(), _values_of(other, self.size)
        )


Vector = Union[DenseVector, SparseVector, np.ndarray]


def _values_of(v: Vector, size: int) -> np.ndarray:
    if isinstance(v, (DenseVector, SparseVector)):
        return v.to_array()
    return np.asarray(v, np.float32)


class Vectors:
    """Factory namespace, parity with the reference's ``Vectors`` object."""

    @staticmethod
    def dense(*values) -> DenseVector:
        if len(values) == 1 and isinstance(values[0], (list, tuple, np.ndarray)):
            return DenseVector(values[0])
        return DenseVector(values)

    @staticmethod
    def sparse(size: int, indices, values) -> SparseVector:
        return SparseVector(size, indices, values)

    @staticmethod
    def zeros(size: int) -> DenseVector:
        return DenseVector(np.zeros((size,), np.float32))

    @staticmethod
    def parse(s: str) -> Vector:
        """Parse the reference's vector text forms ([U] Vectors.parse):
        dense "[v0,v1,...]" or sparse "(size,[i0,...],[v0,...])"."""
        s = s.strip()
        if s.startswith("["):
            if not s.endswith("]"):
                raise ValueError(f"unterminated vector text {s!r}")
            body = s[1:-1].strip()
            # float() per token so corrupt text raises instead of being
            # silently truncated (np.fromstring stops at the first bad
            # token without error)
            vals = [float(t) for t in body.split(",") if t.strip()] \
                if body else []
            return DenseVector(np.asarray(vals, np.float32))
        if s.startswith("("):
            size_str, rest = s[1:-1].split(",", 1)
            li, ri = rest.index("["), rest.index("]")
            idx_str = rest[li + 1:ri]
            val_part = rest[ri + 1:]
            vals_str = val_part[val_part.index("[") + 1:val_part.index("]")]
            # strict token-wise parse, like the dense branch: fromstring
            # silently TRUNCATES at the first corrupt token, loading
            # wrong shorter vectors from a damaged file with no error
            idx = np.asarray(
                [int(t) for t in idx_str.split(",") if t.strip()],
                np.int64,
            )
            vals = np.asarray(
                [float(t) for t in vals_str.split(",") if t.strip()],
                np.float32,
            )
            if idx.shape[0] != vals.shape[0]:
                raise ValueError(
                    f"sparse vector text has {idx.shape[0]} indices but "
                    f"{vals.shape[0]} values: {s!r}"
                )
            return SparseVector(int(size_str), idx, vals)
        raise ValueError(f"cannot parse vector text {s!r}")


class BLAS:
    """Level-1 shims (host-side; device code uses torch directly)."""

    @staticmethod
    def dot(x: Vector, y: Vector) -> float:
        size = getattr(x, "size", None)
        if size is None:  # a falsy-or would send size-0 vectors to len()
            size = len(x)
        xv = _values_of(x, size)
        # empty @ empty is already 0.0; empty @ non-empty must keep
        # raising (a silent 0.0 would mask the caller's shape bug)
        return float(xv @ _values_of(y, xv.shape[0]))

    @staticmethod
    def axpy(a: float, x: Vector, y: np.ndarray) -> np.ndarray:
        """y += a * x in place on a numpy accumulator; returns y."""
        xv = _values_of(x, y.shape[0])
        y += a * xv
        return y

    @staticmethod
    def scal(a: float, x: np.ndarray) -> np.ndarray:
        x *= a
        return x

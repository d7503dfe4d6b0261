"""Synthetic data generators (numpy), copied from ``tpu_sgd/utils/mlutils.py``
so the port depends on nothing of the JAX package.  Same seeds, same draws,
same arrays as the originals.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


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

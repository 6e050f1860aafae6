"""Synthetic data generators following the paper's §IV procedure.

"the x_i's and w were sampled from the [-1,1] uniform distribution;
 y_i = sgn(w^T x_i), and the sign of each y_i was randomly flipped with
 probability 0.1.  The features were standardized to have unit variance."
"""
from __future__ import annotations

import numpy as np


def make_svm_data(n: int, m: int, *, flip=0.1, seed=0, standardize=True):
    """Dense synthetic binary classification data (paper, part 1)."""
    rng = np.random.default_rng(seed)
    X = rng.uniform(-1.0, 1.0, size=(n, m))
    w = rng.uniform(-1.0, 1.0, size=(m,))
    y = np.sign(X @ w)
    y[y == 0] = 1.0
    flips = rng.random(n) < flip
    y = np.where(flips, -y, y)
    if standardize:
        X = X / X.std(axis=0, keepdims=True)
    return X.astype(np.float32), y.astype(np.float32)


def make_sparse_svm_data(n: int, m: int, *, density=0.01, flip=0.1, seed=0):
    """Sparse variant used by the weak-scaling experiments (r = 1%, 5%).

    Returned dense (the block algorithms of this slice work on dense
    tiles; the sparsity only affects the spectrum / scaling behaviour,
    which is what the paper's weak-scaling experiment studies).
    """
    rng = np.random.default_rng(seed)
    X = rng.uniform(-1.0, 1.0, size=(n, m))
    mask = rng.random((n, m)) < density
    X = X * mask
    w = rng.uniform(-1.0, 1.0, size=(m,))
    z = X @ w
    y = np.sign(z)
    y[y == 0] = 1.0
    flips = rng.random(n) < flip
    y = np.where(flips, -y, y)
    std = X.std(axis=0, keepdims=True)
    std[std == 0] = 1.0
    X = X / std
    return X.astype(np.float32), y.astype(np.float32)

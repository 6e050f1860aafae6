"""Host-side sparse (CSR) containers for news20-scale instances.

The paper's headline experiments (news20, real-sim, the weak-scaling runs
at 1-5% density) are sparse; materialising them dense caps the port far
below paper scale (a dense news20 grid would need about 108 GB).  This
module provides the numpy CSR container the sparse execution path is
built on:

  * :class:`CSRMatrix` -- indptr/indices/data triplet with just enough
    linear algebra (``X @ w``, ``X.T @ alpha``) for the solver's
    objective / duality-gap bookkeeping, computed with torch gather and
    ``index_add_`` on the device of the vector, so it never densifies;
  * ``csr_from_dense`` -- conversion for tests and small instances;
  * ``make_sparse_svm_csr`` -- the paper's §IV sparse synthetic generator
    emitting CSR directly (per-row index sampling), so a news20-profile
    instance costs O(nnz) host memory instead of O(n*m).

The host arrays, and therefore the padded-ELL cells cut from them
(``core/partition.py``), are bit-identical to the reference's for the same
inputs and seed.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class _CSRTransposed:
    """View returned by ``CSRMatrix.T``: supports only ``.T @ alpha``."""

    csr: "CSRMatrix"

    @property
    def shape(self):
        n, m = self.csr.shape
        return (m, n)

    def __matmul__(self, alpha):
        return self.csr.rmatvec(alpha)


@dataclasses.dataclass(frozen=True)
class CSRMatrix:
    """Compressed sparse rows, numpy-backed.

    ``indptr`` (n+1,) int64, ``indices`` (nnz,) int32 column ids,
    ``data`` (nnz,) float32, ``shape`` = (n, m).  Duck-types the two
    matrix products the solver's outer loop needs (``X @ w`` and
    ``X.T @ alpha``), returning float32 tensors on the device of the
    vector.
    """

    indptr: np.ndarray
    indices: np.ndarray
    data: np.ndarray
    shape: tuple

    def __post_init__(self):
        n = self.shape[0]
        if self.indptr.shape != (n + 1,):
            raise ValueError(
                f"indptr shape {self.indptr.shape} != ({n + 1},)")
        if self.indices.shape != self.data.shape:
            raise ValueError("indices and data must have the same length")

    @property
    def nnz(self) -> int:
        return int(self.indices.shape[0])

    @property
    def density(self) -> float:
        n, m = self.shape
        return self.nnz / float(max(n * m, 1))

    def row_nnz(self) -> np.ndarray:
        """(n,) number of stored entries per row."""
        return np.diff(self.indptr).astype(np.int64)

    def row_ids(self) -> np.ndarray:
        """(nnz,) COO row index of every stored entry."""
        return np.repeat(
            np.arange(self.shape[0], dtype=np.int64), self.row_nnz())

    def _device_coo(self, device: torch.device):
        """Cached ``(data, indices, row_ids)`` tensors on ``device`` for the
        two matvecs -- the outer loop evaluates the objective every
        outer iteration, and at news20 scale re-repeating /
        re-transferring ~10M-entry arrays per call would dominate the
        bookkeeping."""
        cache = self.__dict__.setdefault("_coo_cache", {})
        key = str(device)
        if key not in cache:
            cache[key] = (
                torch.as_tensor(self.data, dtype=torch.float32,
                                device=device),
                torch.as_tensor(self.indices.astype(np.int64),
                                device=device),
                torch.as_tensor(self.row_ids(), device=device))
        return cache[key]

    def toarray(self) -> np.ndarray:
        """Densify (small instances / reference solves only)."""
        n, m = self.shape
        X = np.zeros((n, m), dtype=np.float32)
        X[self.row_ids(), self.indices] = self.data
        return X

    # ---- the two products the solver's outer loop needs ------------------
    def matvec(self, w) -> torch.Tensor:
        """X @ w -> (n,) float32 tensor on the device of ``w``."""
        w = torch.as_tensor(w, dtype=torch.float32)
        data, indices, rows = self._device_coo(w.device)
        contrib = data * w[indices]
        return torch.zeros((self.shape[0],), dtype=contrib.dtype,
                           device=w.device).index_add_(0, rows, contrib)

    def rmatvec(self, alpha) -> torch.Tensor:
        """X.T @ alpha -> (m,) float32 tensor on the device of ``alpha``."""
        alpha = torch.as_tensor(alpha, dtype=torch.float32)
        data, indices, rows = self._device_coo(alpha.device)
        contrib = data * alpha[rows]
        return torch.zeros((self.shape[1],), dtype=contrib.dtype,
                           device=alpha.device).index_add_(0, indices,
                                                           contrib)

    def __matmul__(self, w):
        return self.matvec(w)

    @property
    def T(self):
        return _CSRTransposed(self)


def csr_from_dense(X) -> CSRMatrix:
    """Dense (n, m) array -> :class:`CSRMatrix` (row-major nonzeros)."""
    X = np.asarray(X, dtype=np.float32)
    n, m = X.shape
    rows, cols = np.nonzero(X)
    order = np.lexsort((cols, rows))     # row-major
    rows, cols = rows[order], cols[order]
    indptr = np.zeros((n + 1,), dtype=np.int64)
    np.add.at(indptr, rows + 1, 1)
    indptr = np.cumsum(indptr)
    return CSRMatrix(indptr=indptr, indices=cols.astype(np.int32),
                     data=X[rows, cols].astype(np.float32), shape=(n, m))


def make_sparse_svm_csr(n: int, m: int, *, density=0.01, flip=0.1, seed=0,
                        standardize=True) -> tuple:
    """Sparse synthetic SVM instance emitted directly as CSR.

    Follows the paper's §IV recipe (uniform [-1, 1] entries and planted
    ``w``, labels ``sgn(w^T x)`` with 10% flips, unit-variance columns)
    but never materialises the dense matrix: per-row nonzero counts are
    Binomial(m, density) (min 1 so every observation has a label signal)
    and standardisation uses the exact column moments of the sparse
    entries (zeros included), which matches the dense generator's
    ``X / X.std(axis=0)``.

    Returns ``(CSRMatrix, y)`` with y in {-1, +1} float32.
    """
    rng = np.random.default_rng(seed)
    counts = np.maximum(rng.binomial(m, density, size=n), 1)
    indptr = np.zeros((n + 1,), dtype=np.int64)
    indptr[1:] = np.cumsum(counts)
    nnz = int(indptr[-1])
    indices = np.empty((nnz,), dtype=np.int32)
    for i in range(n):
        indices[indptr[i]:indptr[i + 1]] = np.sort(
            rng.choice(m, size=counts[i], replace=False))
    data = rng.uniform(-1.0, 1.0, size=nnz).astype(np.float32)

    w = rng.uniform(-1.0, 1.0, size=m).astype(np.float32)
    rows = np.repeat(np.arange(n, dtype=np.int64), counts)
    z = np.zeros((n,), dtype=np.float64)
    np.add.at(z, rows, data.astype(np.float64) * w[indices])
    y = np.sign(z)
    y[y == 0] = 1.0
    flips = rng.random(n) < flip
    y = np.where(flips, -y, y).astype(np.float32)

    if standardize:
        # column std over ALL n entries (zeros included), population form
        s1 = np.zeros((m,), dtype=np.float64)
        s2 = np.zeros((m,), dtype=np.float64)
        np.add.at(s1, indices, data.astype(np.float64))
        np.add.at(s2, indices, data.astype(np.float64) ** 2)
        var = s2 / n - (s1 / n) ** 2
        std = np.sqrt(np.maximum(var, 0.0))
        std[std == 0] = 1.0
        data = (data / std[indices]).astype(np.float32)

    return CSRMatrix(indptr=indptr, indices=indices, data=data,
                     shape=(n, m)), y

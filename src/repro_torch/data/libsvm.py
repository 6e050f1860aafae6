"""Minimal LIBSVM-format text reader/writer (realsim / news20 style files).

No third-party deps; tolerant of 0- or 1-based feature indices.
``load_libsvm_csr`` streams straight into :class:`~repro_torch.data.sparse.
CSRMatrix` -- O(nnz) host memory, never a dense matrix -- which is how
news20-sized files enter the sparse block pipeline.
"""
from __future__ import annotations

import numpy as np

from .sparse import CSRMatrix


def load_libsvm_csr(path: str, n_features: int | None = None):
    """Stream a libsvm text file into (CSRMatrix, y) without densifying.

    One pass over the file accumulating flat index/value arrays; the
    dense matrix is never materialised, so peak memory is O(nnz).
    """
    indptr, cols, vals, ys = [0], [], [], []
    with open(path, "r") as fh:
        for line in fh:
            parts = line.split()
            if not parts:
                continue
            ys.append(float(parts[0]))
            for tok in parts[1:]:
                c, v = tok.split(":")
                cols.append(int(c))
                vals.append(float(v))
            indptr.append(len(cols))
    if not cols:
        raise ValueError(f"{path}: no features parsed")
    cols = np.asarray(cols, dtype=np.int64)
    base = int(cols.min())    # 1-based files -> shift to 0
    cols -= base
    m = n_features or int(cols.max() + 1)
    y = np.asarray(ys, dtype=np.float32)
    y = np.where(y > 0, 1.0, -1.0).astype(np.float32)
    csr = CSRMatrix(indptr=np.asarray(indptr, dtype=np.int64),
                    indices=cols.astype(np.int32),
                    data=np.asarray(vals, dtype=np.float32),
                    shape=(len(ys), m))
    return csr, y


def load_libsvm(path: str, n_features: int | None = None):
    """Parse a libsvm text file into dense (X, y) float32 arrays."""
    csr, y = load_libsvm_csr(path, n_features)
    return csr.toarray(), y


def save_libsvm(path: str, X, y):
    with open(path, "w") as fh:
        for xi, yi in zip(np.asarray(X), np.asarray(y)):
            nz = np.nonzero(xi)[0]
            feats = " ".join(f"{j + 1}:{xi[j]:.6g}" for j in nz)
            fh.write(f"{int(yi)} {feats}\n")

"""Doubly distributed P x Q partitioning of the training matrix.

The paper stores block ``x_[p,q]`` (observations p, features q) on worker
(p, q) of a K = P*Q node cluster.  This module provides:

  * ``DoublyPartitioned`` -- a padded, block-major view of (X, y) shaped
    ``(P, Q, n_p, m_q)`` used by the single-device grid engine, where the
    P x Q cells are leading batch axes and the kernels take all cells of
    one outer step in one launch;
  * helpers to scatter/gather the global primal/dual vectors to/from blocks.

Padding: rows are padded with x = 0 and mask = 0 so they contribute nothing
to objectives/gradients; columns are padded with zero features (harmless --
the corresponding w coordinates stay 0 under every update rule because the
data column is identically zero, and the regularizer only shrinks them).

The padded-ELL sparse cell format (``SparseDoublyPartitioned``,
``partition_sparse``) keeps per-cell memory at O(nnz): each (p, q) cell is
a ``(n_p, k)`` pair of block-local column ids and values, ``k`` the
largest per-cell-row nonzero count.  ``ell_gather`` / ``ell_scatter_add``
are the two products every sparse cell program uses, batched over the
cells with plain torch gather / scatter-add (they are not TPU kernels in
the reference either).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .util import DTYPE, as_tensor, resolve_device


def _ceil_to(x: int, k: int) -> int:
    return (x + k - 1) // k * k


@dataclasses.dataclass(frozen=True)
class DoublyPartitioned:
    """Block-major view of the training set."""

    x_blocks: torch.Tensor  # (P, Q, n_p, m_q), contiguous
    y_blocks: torch.Tensor  # (P, n_p)
    mask: torch.Tensor      # (P, n_p)   1.0 = real row, 0.0 = padding
    n: int                  # true number of observations
    m: int                  # true number of features
    P: int
    Q: int

    @property
    def n_p(self) -> int:
        return self.x_blocks.shape[2]

    @property
    def m_q(self) -> int:
        return self.x_blocks.shape[3]

    @property
    def device(self) -> torch.device:
        return self.x_blocks.device

    # ---- global <-> block conversions -------------------------------------
    def w_to_blocks(self, w):
        """(m,) -> (Q, m_q), zero-padding the tail."""
        w = as_tensor(w, self.device)
        wp = torch.zeros(self.Q * self.m_q, dtype=w.dtype, device=self.device)
        wp[: self.m] = w
        return wp.reshape(self.Q, self.m_q)

    def w_from_blocks(self, w_blocks):
        """(Q, m_q) -> (m,)."""
        return w_blocks.reshape(-1)[: self.m]

    def alpha_to_blocks(self, alpha):
        alpha = as_tensor(alpha, self.device)
        ap = torch.zeros(self.P * self.n_p, dtype=alpha.dtype,
                         device=self.device)
        ap[: self.n] = alpha
        return ap.reshape(self.P, self.n_p)

    def alpha_from_blocks(self, alpha_blocks):
        return alpha_blocks.reshape(-1)[: self.n]

    def dense(self):
        """Reassemble the (possibly padded) dense matrix (n, m) and labels."""
        Xp = self.x_blocks.permute(0, 2, 1, 3).reshape(
            self.P * self.n_p, self.Q * self.m_q)
        return Xp[: self.n, : self.m], self.y_blocks.reshape(-1)[: self.n]


def partition(X, y, P: int, Q: int, *, m_multiple: int | None = None,
              device="cuda") -> DoublyPartitioned:
    """Split (X, y) into the P x Q doubly distributed block grid on
    ``device``.

    ``m_multiple`` pads the feature dimension to a multiple of that value
    instead of just Q.  The solver framework passes P*Q so that RADiSA's
    P sub-blocks divide every feature block.

    ``x_blocks`` is made contiguous after the block transpose: the
    kernels index a cell's rows with the row stride ``m_q``.
    """
    device = resolve_device(device)
    X = as_tensor(X, device)
    y = as_tensor(y, device)
    if m_multiple is not None and m_multiple % Q:
        raise ValueError(f"m_multiple={m_multiple} not a multiple of Q={Q}")
    n, m = X.shape
    n_pad, m_pad = _ceil_to(n, P), _ceil_to(m, m_multiple or Q)
    n_p, m_q = n_pad // P, m_pad // Q

    Xp = torch.zeros((n_pad, m_pad), dtype=DTYPE, device=device)
    Xp[:n, :m] = X
    yp = torch.zeros((n_pad,), dtype=DTYPE, device=device)
    yp[:n] = y
    mask = torch.zeros((n_pad,), dtype=DTYPE, device=device)
    mask[:n] = 1.0

    x_blocks = Xp.reshape(P, n_p, Q, m_q).permute(0, 2, 1, 3).contiguous()
    y_blocks = yp.reshape(P, n_p)
    mask_blocks = mask.reshape(P, n_p)
    return DoublyPartitioned(x_blocks, y_blocks, mask_blocks, n, m, P, Q)


# ---------------------------------------------------------------------------
# blocked matrix-vector products (plain matmuls, outside any kernel)
# ---------------------------------------------------------------------------

def rows_times_blocks(v, x_blocks):
    """``v (P, n_p)``, ``x_blocks (P, Q, n_p, m_q)`` -> ``(P, Q, m_q)``:
    every cell's v_p^T x_[p,q].  A broadcast batched matmul over the
    cells, so the blocks are read in place (an einsum would first copy
    them into another layout).  With a tenant axis: ``v (P, T, n_p)``,
    ``x_blocks (P, Q, T, n_p, m_q)`` -> ``(P, Q, T, m_q)``."""
    return torch.matmul(v.unsqueeze(1).unsqueeze(-2), x_blocks).squeeze(-2)


def cells_times_blocks(v, x_blocks):
    """``v (P, Q[, T], n_p)`` -- one vector per cell -- times that cell's
    block: ``(P, Q[, T], m_q)``, read in place."""
    return torch.matmul(v.unsqueeze(-2), x_blocks).squeeze(-2)


def blocks_times_cols(x_blocks, w_blocks):
    """``x_blocks (P, Q, n_p, m_q)``, ``w_blocks (Q, m_q)`` ->
    ``(P, Q, n_p)``: every cell's x_[p,q] w_q, read in place.  With a
    tenant axis: ``(P, Q, T, n_p, m_q)``, ``(Q, T, m_q)`` ->
    ``(P, Q, T, n_p)``."""
    return torch.matmul(x_blocks,
                        w_blocks.unsqueeze(0).unsqueeze(-1)).squeeze(-1)


# ---------------------------------------------------------------------------
# sparse (padded ELL) cell format
# ---------------------------------------------------------------------------

def ell_gather(w, cols, vals):
    """Row inner products of ELL cells with dense vectors.

    ``cols``/``vals`` ``(..., n_p, k)``; ``w (..., m_q)`` broadcastable to
    the cells' leading axes (``(Q, m_q)`` for a ``(P, Q, n_p, k)`` grid)
    -> ``(..., n_p)``: each row's x_i . w as a gather of w at the row's
    column ids.  Padding slots (col=0, val=0) read w[0] and contribute
    nothing.  The single definition of the gather every sparse cell
    program uses.
    """
    lead = cols.shape[:-2]
    wb = w.expand(*lead, w.shape[-1])
    got = torch.gather(wb, -1, cols.reshape(*lead, -1).long())
    return (vals * got.reshape(cols.shape)).sum(-1)


def ell_scatter_add(m_q: int, cols, vals, coef):
    """Column accumulation of ELL cells: sum_i coef[i] * x_i -> ``(..., m_q)``.

    ``cols``/``vals`` ``(..., n_p, k)``; ``coef (..., n_p)`` broadcastable
    to the cells' leading axes (``(P, 1, n_p)`` for a row-partition
    vector on a ``(P, Q, n_p, k)`` grid).  Scatter-ADD, so the duplicate
    index-0 padding slots (val=0) are inert.  The single definition of
    the scatter every sparse cell program uses.
    """
    lead = cols.shape[:-2]
    src = vals * coef.unsqueeze(-1)
    out = torch.zeros((*lead, m_q), dtype=vals.dtype, device=vals.device)
    return out.scatter_add_(-1, cols.reshape(*lead, -1).long(),
                            src.reshape(*lead, -1))


def _ell_blocks(csr, y, P: int, Q: int, m_pad: int, k_multiple: int):
    """Host-side: bucket CSR rows into the P x Q grid as padded ELL cells.

    For every (p, q) cell each local row stores at most ``k`` entries as
    (block-local column id, value); ``k`` is the max per-cell-row nonzero
    count over the WHOLE grid, rounded up to ``k_multiple``.  Padding
    slots use (col=0, val=0.0): every consumer either gathers (x0 reads
    are harmless) or scatter-ADDs (zero increments are inert), so the
    duplicate index-0 slots never change a result.

    Returns numpy ``cols (P, Q, n_p, k) int32``, ``vals (..., k) f32``,
    ``y_blocks (P, n_p)``, ``mask (P, n_p)``.
    """
    n = csr.shape[0]
    n_pad = _ceil_to(n, P)
    n_p, m_q = n_pad // P, m_pad // Q

    # per (row, q) nonzero count -> global k
    q_of = np.minimum(csr.indices // m_q, Q - 1)
    row = csr.row_ids()
    pair = row * Q + q_of
    counts = np.bincount(pair, minlength=n * Q)
    k_max = int(counts.max()) if counts.size else 0
    k = max(_ceil_to(max(k_max, 1), k_multiple), k_multiple)

    cols = np.zeros((P, Q, n_p, k), dtype=np.int32)
    vals = np.zeros((P, Q, n_p, k), dtype=np.float32)
    # ELL slot of each entry = its rank within its (row, q) group, in CSR
    # entry order inside every group (a stable sort, which rows in order
    # with their columns ascending -- the usual CSR -- do not need)
    starts = np.cumsum(counts) - counts
    if np.any(pair[1:] < pair[:-1]):
        perm = np.argsort(pair, kind="stable")
        ranks = np.empty((csr.nnz,), dtype=np.int64)
        ranks[perm] = np.arange(csr.nnz, dtype=np.int64) - starts[pair[perm]]
    else:
        ranks = np.arange(csr.nnz, dtype=np.int64) - starts[pair]
    # flat slot ((p * Q + q) * n_p + local row) * k + rank, p = row // n_p
    slot = ((row // n_p * Q + q_of) * n_p + row % n_p) * k + ranks
    cols.reshape(-1)[slot] = (csr.indices - q_of * m_q).astype(np.int32)
    vals.reshape(-1)[slot] = csr.data.astype(np.float32)

    yp = np.zeros((n_pad,), dtype=np.float32)
    yp[:n] = np.asarray(y, dtype=np.float32)
    maskp = np.zeros((n_pad,), dtype=np.float32)
    maskp[:n] = 1.0
    return cols, vals, yp.reshape(P, n_p), maskp.reshape(P, n_p)


@dataclasses.dataclass(frozen=True)
class SparseDoublyPartitioned:
    """Block-major padded-ELL view of a sparse training set, on a device.

    The per-(p, q) cell is ``cols[p, q] (n_p, k) int32`` (block-local
    column ids in [0, m_q)) + ``vals[p, q] (n_p, k) f32``; block memory
    scales with the nonzero count (k ~= max cell-row nnz), not with m_q.
    """

    cols: torch.Tensor      # (P, Q, n_p, k) int32, block-local columns
    vals: torch.Tensor      # (P, Q, n_p, k) f32
    y_blocks: torch.Tensor  # (P, n_p)
    mask: torch.Tensor      # (P, n_p)   1.0 = real row, 0.0 = padding
    n: int                  # true number of observations
    m: int                  # true number of features
    m_q: int                # padded feature-block width
    P: int
    Q: int

    @property
    def n_p(self) -> int:
        return self.cols.shape[2]

    @property
    def k(self) -> int:
        return self.cols.shape[3]

    @property
    def device(self) -> torch.device:
        return self.cols.device

    # ---- global <-> block conversions (same padding rule as dense) --------
    w_to_blocks = DoublyPartitioned.w_to_blocks
    w_from_blocks = DoublyPartitioned.w_from_blocks
    alpha_to_blocks = DoublyPartitioned.alpha_to_blocks
    alpha_from_blocks = DoublyPartitioned.alpha_from_blocks

    def dense(self):
        """Reassemble the dense (n, m) matrix and labels as numpy arrays
        (tests only)."""
        Pn, Qn, n_p, k = self.cols.shape
        X = np.zeros((Pn * n_p, Qn * self.m_q), dtype=np.float32)
        cols = self.cols.cpu().numpy()
        vals = self.vals.cpu().numpy()
        p, q, r, _ = np.meshgrid(np.arange(Pn), np.arange(Qn),
                                 np.arange(n_p), np.arange(k),
                                 indexing="ij")
        np.add.at(X, (p * n_p + r, q * self.m_q + cols), vals)
        y = self.y_blocks.cpu().numpy().reshape(-1)
        return X[: self.n, : self.m], y[: self.n]


def partition_sparse(X, y, P: int, Q: int, *, m_multiple: int | None = None,
                     k_multiple: int = 8,
                     device="cuda") -> SparseDoublyPartitioned:
    """Split (X, y) into the sparse P x Q padded-ELL block grid on
    ``device``.

    ``X`` may be a :class:`~repro_torch.data.sparse.CSRMatrix` (never
    densified) or a dense array / tensor (converted row-wise on the
    host).  The padding rule matches ``partition(..., m_multiple=...)``
    exactly, so sparse and dense runs see the same logical blocks.
    """
    from repro_torch.data.sparse import CSRMatrix, csr_from_dense
    device = resolve_device(device)
    if not isinstance(X, CSRMatrix):
        if isinstance(X, torch.Tensor):
            X = X.detach().cpu().numpy()
        X = csr_from_dense(np.asarray(X))
    if isinstance(y, torch.Tensor):
        y = y.detach().cpu().numpy()
    if m_multiple is not None and m_multiple % Q:
        raise ValueError(f"m_multiple={m_multiple} not a multiple of Q={Q}")
    n, m = X.shape
    m_pad = _ceil_to(m, m_multiple or Q)
    cols, vals, y_blocks, mask = _ell_blocks(X, y, P, Q, m_pad, k_multiple)
    return SparseDoublyPartitioned(
        cols=torch.from_numpy(cols).to(device),
        vals=torch.from_numpy(vals).to(device),
        y_blocks=torch.from_numpy(y_blocks).to(device),
        mask=torch.from_numpy(mask).to(device),
        n=n, m=m, m_q=m_pad // Q, P=P, Q=Q)

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

This is the dense half; the padded-ELL sparse cell format is not ported
yet (ROADMAP queue A, sparse path).
"""
from __future__ import annotations

import dataclasses

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
    them into another layout)."""
    return torch.matmul(v[:, None, None, :], x_blocks).squeeze(2)


def blocks_times_cols(x_blocks, w_blocks):
    """``x_blocks (P, Q, n_p, m_q)``, ``w_blocks (Q, m_q)`` ->
    ``(P, Q, n_p)``: every cell's x_[p,q] w_q, read in place."""
    return torch.matmul(x_blocks, w_blocks[None, :, :, None]).squeeze(3)

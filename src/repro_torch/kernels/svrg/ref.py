"""Plain PyTorch version of the RADiSA/SVRG inner-loop kernel.

The same batched function as ``csrc/svrg_inner.cu``: a Python loop over
the L steps, vectorised over the cells, which it indexes as the kernel
does (flat cell ``c = (p*Q + q)*T + t``, rows and ``lo`` by ``p*T + t``)
with the step's scalars in float32 per cell.  The CPU tests run it, the
chip check compares the kernel with it on the card, and
``ops.svrg_inner`` takes it only for tensors that lie on the CPU.
"""
from __future__ import annotations

import torch

from .._launch import cell_index, per_cell


def _grad(loss, z, y):
    if loss == "hinge":
        return torch.where(y * z < 1.0, -y, torch.zeros_like(y))
    if loss == "squared":
        return 2.0 * (z - y)
    raise ValueError(loss)


def svrg_inner_plain(x, y, mask, z_anchor, w_anchor, mu, idx, *, lam, eta,
                     loss: str = "hinge", lo=None):
    """x: (P, Q, n_p, m_x); y, mask, z_anchor: (P, n_p); w_anchor, mu:
    (P, Q, m_sub); idx: (P, Q, L) int32 minibatch order per cell;
    ``lo`` (P,) int32 column offsets of each row partition's window
    ``[lo, lo + m_sub)`` into the m_x columns (None: the window starts
    at column 0).  With a tenant axis: x (P, Q, T, n_p, m_x); rows
    (P, T, n_p); w_anchor, mu (P, Q, T, m_sub); idx (P, Q, T, L); lo
    (P, T).  ``lam`` and ``eta`` are numbers or tensors broadcastable to
    the cell grid.  Returns w (P, Q[, T], m_sub).
    """
    tenant = x.dim() == 5
    P, Qc = x.shape[:2]
    T = x.shape[2] if tenant else 1
    n_p, m_x = x.shape[-2:]
    m_sub = w_anchor.shape[-1]
    lead = (P, Qc, T) if tenant else (P, Qc)
    dev = x.device
    cell, row, _ = cell_index(P, Qc, T, dev)
    xf = x.reshape(-1, n_p, m_x)
    yf, mf, zf = (v.reshape(P * T, n_p)[row] for v in (y, mask, z_anchor))
    wa = w_anchor.reshape(-1, m_sub)
    muf = mu.reshape(-1, m_sub)
    idxf = idx.reshape(cell.numel(), -1).long()
    cols = torch.arange(m_sub, device=dev)[None, :]
    if lo is not None:
        cols = lo.reshape(P * T)[row].long()[:, None] + cols   # (C, m_sub)
    lam_c = per_cell(lam, lead, dev)[:, None]
    eta_c = per_cell(eta, lead, dev)[:, None]
    w = wa.clone()
    for h in range(idxf.shape[1]):
        j = idxf[:, h]                                  # (C,)
        xj = xf[cell[:, None], j[:, None], cols]        # (C, m_sub)
        yj, mj, zj = yf[cell, j], mf[cell, j], zf[cell, j]
        z = zj + (xj * (w - wa)).sum(-1)
        gd = _grad(loss, z, yj) - _grad(loss, zj, yj)
        g = gd.unsqueeze(-1) * xj * mj.unsqueeze(-1) + muf \
            + lam_c * (w - wa)
        w = w - eta_c * g
    return w.reshape(*lead, m_sub)

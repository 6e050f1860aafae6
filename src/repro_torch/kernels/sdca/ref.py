"""Plain PyTorch version of the local SDCA epoch kernel (hinge / squared).

The same batched function as ``csrc/sdca_epoch.cu``: a Python loop over
the steps, vectorised over the cells, which it indexes as the kernel does
(flat cell ``c = (p*Q + q)*T + t``, rows by ``p*T + t``, ``w0`` by
``q*T + t``) and whose scalars it forms as the kernel does (float32
``lam``, ``n``, ``beta`` per cell, ``lam * n`` in float32).  The CPU
tests run it, the chip check compares the kernel with it on the card, and
``ops.sdca_epoch`` takes it only for tensors that lie on the CPU.
"""
from __future__ import annotations

import torch

from .._launch import cell_index, per_cell


def sdca_epoch_plain(x, y, mask, alpha0, w0, idx, *, lam, n, Q,
                     loss: str = "hinge", beta=None):
    """x: (P, Q, n_p, m_q); y, mask, alpha0: (P, n_p); w0: (Q, m_q);
    idx: (P, steps) int32 coordinate order, shared by the cells of a row
    partition.  With a tenant axis: x (P, Q, T, n_p, m_q); y, mask,
    alpha0 (P, T, n_p); w0 (Q, T, m_q); idx (P, T, steps).

    ``lam``, ``n`` and ``beta`` are numbers or tensors broadcastable to
    the cell grid ((P, Q) or (P, Q, T)).  ``beta`` replaces the
    ||x_i||^2 denominator when given (the paper's step_mode="beta").
    Returns (dalpha, w_final) of shapes (P, Q[, T], n_p) / (P, Q[, T],
    m_q) in float32.
    """
    if loss not in ("hinge", "squared"):
        raise ValueError(loss)
    tenant = x.dim() == 5
    P, Qc = x.shape[:2]
    T = x.shape[2] if tenant else 1
    n_p, m_q = x.shape[-2:]
    lead = (P, Qc, T) if tenant else (P, Qc)
    dev = x.device
    cell, row, col = cell_index(P, Qc, T, dev)
    xf = x.reshape(-1, n_p, m_q)
    yf, mf, af = (v.reshape(P * T, n_p)[row] for v in (y, mask, alpha0))
    idxf = idx.reshape(P * T, -1)[row].long()
    w = w0.reshape(Qc * T, m_q)[col]
    lam_c, n_c = per_cell(lam, lead, dev), per_cell(n, lead, dev)
    lam_n = lam_c * n_c
    beta_c = None if beta is None else per_cell(beta, lead, dev)
    dalpha = torch.zeros((cell.numel(), n_p), dtype=x.dtype, device=dev)
    for h in range(idxf.shape[1]):
        i = idxf[:, h]                             # (C,)
        xi = xf[cell, i]                           # (C, m_q)
        yi, mi = yf[cell, i], mf[cell, i]
        zloc = (xi * w).sum(-1)
        a_i = af[cell, i] + dalpha[cell, i]
        denom = (xi * xi).sum(-1) if beta_c is None else beta_c
        denom = torch.clamp(denom, min=1e-12)
        if loss == "hinge":
            d = (yi / Q - zloc) * lam_c * n_c / denom
            pos = yi > 0
            lo = torch.where(pos, 0.0, -1.0)
            hi = torch.where(pos, 1.0, 0.0)
            d = torch.minimum(torch.maximum(a_i + d, lo), hi) - a_i
        else:
            num = yi / Q - a_i / (2.0 * Q) - zloc
            den = 1.0 / (2.0 * Q) + denom / lam_n
            d = num / torch.clamp(den, min=1e-12)
        d = d * mi                                 # padded rows never move
        w = w + (d / lam_n).unsqueeze(-1) * xi
        dalpha[cell, i] += d
    return dalpha.reshape(*lead, n_p), w.reshape(*lead, m_q)

"""Plain PyTorch version of the local SDCA epoch kernel (hinge / squared).

The same batched function as ``csrc/sdca_epoch.cu``: a Python loop over
the steps, vectorised over the P x Q cells.  The CPU tests run it, the
chip check compares the kernel with it on the card, and ``ops.sdca_epoch``
takes it only for tensors that lie on the CPU.
"""
from __future__ import annotations

import torch


def sdca_epoch_plain(x, y, mask, alpha0, w0, idx, *, lam, n, Q,
                     loss: str = "hinge", beta=None):
    """x: (P, Q, n_p, m_q); y, mask, alpha0: (P, n_p); w0: (Q, m_q);
    idx: (P, steps) int32 coordinate order, shared by the cells of a row
    partition.

    ``beta`` (runtime scalar) replaces the ||x_i||^2 denominator when
    given (the paper's step_mode="beta").  Returns (dalpha (P, Q, n_p),
    w_final (P, Q, m_q)) in float32.
    """
    if loss not in ("hinge", "squared"):
        raise ValueError(loss)
    P, Qc, n_p, m_q = x.shape
    steps = idx.shape[1]
    w = w0.unsqueeze(0).expand(P, Qc, m_q).clone()
    dalpha = torch.zeros((P, Qc, n_p), dtype=x.dtype, device=x.device)
    pa = torch.arange(P, device=x.device)
    idx = idx.long()
    for h in range(steps):
        i = idx[:, h]                              # (P,)
        xi = x[pa, :, i]                           # (P, Q, m_q)
        yi = y[pa, i].unsqueeze(1)                 # (P, 1)
        mi = mask[pa, i].unsqueeze(1)
        zloc = (xi * w).sum(-1)                    # (P, Q)
        a_i = alpha0[pa, i].unsqueeze(1) + dalpha[pa, :, i]
        if beta is None:
            denom = (xi * xi).sum(-1)
        else:
            denom = torch.full_like(zloc, float(beta))
        denom = torch.clamp(denom, min=1e-12)
        if loss == "hinge":
            d = (yi / Q - zloc) * lam * n / denom
            pos = yi > 0
            lo = torch.where(pos, 0.0, -1.0)
            hi = torch.where(pos, 1.0, 0.0)
            d = torch.minimum(torch.maximum(a_i + d, lo), hi) - a_i
        else:
            num = yi / Q - a_i / (2.0 * Q) - zloc
            den = 1.0 / (2.0 * Q) + denom / (lam * n)
            d = num / torch.clamp(den, min=1e-12)
        d = d * mi                                 # padded rows never move
        w = w + (d / (lam * n)).unsqueeze(-1) * xi
        dalpha[pa, :, i] += d
    return dalpha, w

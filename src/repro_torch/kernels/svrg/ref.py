"""Plain PyTorch version of the RADiSA/SVRG inner-loop kernel.

The same batched function as ``csrc/svrg_inner.cu``: a Python loop over
the L steps, vectorised over the P x Q cells.  The CPU tests run it, the
chip check compares the kernel with it on the card, and
``ops.svrg_inner`` takes it only for tensors that lie on the CPU.
"""
from __future__ import annotations

import torch


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
    at column 0).  Returns w (P, Q, m_sub).
    """
    P, Qc, n_p, m_x = x.shape
    m_sub = w_anchor.shape[-1]
    L = idx.shape[-1]
    pa = torch.arange(P, device=x.device)[:, None]
    qa = torch.arange(Qc, device=x.device)[None, :]
    cols = torch.arange(m_sub, device=x.device)
    if lo is not None:
        cols = lo.long()[:, None, None] + cols          # (P, 1, m_sub)
    else:
        cols = cols.expand(1, 1, m_sub)
    yq = y[:, None, :].expand(P, Qc, n_p)
    mq = mask[:, None, :].expand(P, Qc, n_p)
    zq = z_anchor[:, None, :].expand(P, Qc, n_p)
    idx = idx.long()
    w = w_anchor.clone()
    for h in range(L):
        j = idx[:, :, h]                                # (P, Q)
        xj = x[pa[..., None], qa[..., None], j[..., None], cols]
        yj, mj, zj = yq[pa, qa, j], mq[pa, qa, j], zq[pa, qa, j]
        z = zj + (xj * (w - w_anchor)).sum(-1)
        gd = _grad(loss, z, yj) - _grad(loss, zj, yj)
        g = gd.unsqueeze(-1) * xj * mj.unsqueeze(-1) + mu \
            + lam * (w - w_anchor)
        w = w - eta * g
    return w

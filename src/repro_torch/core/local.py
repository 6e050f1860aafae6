"""Cell-local solvers of the grid engine, batched over the P x Q cells.

The counterparts of the reference's per-cell functions see ALL cells of
one outer step at once: ``x`` of shape (P, Q, n_p, m_q), labels/mask
(P, n_p) indexed by the row partition, primal slices indexed by the
feature partition.  The coordinate order is an argument (see
``indices.py``), never sampled here.

Both take a ``backend`` knob ("kernel" | "ref"):

  * ``backend="kernel"`` goes through ``repro_torch.kernels``: the
    hand-written CUDA kernel for tensors on a CUDA device (one launch for
    all cells), its plain PyTorch version only for tensors on the CPU.
    The kernels cover hinge and squared losses; logistic raises (use
    backend="ref");
  * ``backend="ref"`` runs the plain per-step loop below, written against
    the ``Loss`` objects, for every loss.
"""
from __future__ import annotations

import torch

from .losses import Loss

KERNEL_LOSSES = ("hinge", "squared")
LOCAL_BACKENDS = ("kernel", "ref")


def _check_kernel_loss(loss: Loss):
    if loss.name not in KERNEL_LOSSES:
        raise NotImplementedError(
            f"local_backend='kernel' supports losses {KERNEL_LOSSES}, not "
            f"{loss.name!r}; use local_backend='ref' for {loss.name}")


# ----------------------------------------------------------------------------
# Local SDCA (Algorithm 2): one epoch of randomized dual coordinate ascent on
# the local block, with the conjugate term scaled by 1/Q.
# ----------------------------------------------------------------------------

def local_sdca(loss: Loss, x, y, mask, alpha0, w0, *, lam, n, Q, idx,
               step_mode: str = "exact", beta=None, backend: str = "kernel"):
    """Run ``idx.shape[1]`` SDCA coordinate updates on every local block.

    Args:
      x: (P, Q, n_p, m_q) data blocks.
      y, mask: (P, n_p) labels and row-validity mask.
      alpha0: (P, n_p) the shared dual blocks alpha_[p, .].
      w0: (Q, m_q) the shared primal blocks w_[., q].
      lam, n: global regularization and *global* observation count.
      Q: number of feature partitions (scales the conjugate by 1/Q).
      idx: (P, steps) int32 coordinate order per row partition (shared
        across q so every feature block visits the same observation
        sequence, matching the paper's per-partition sampling).
      step_mode: "exact" uses ||x_i||^2; "beta" uses the paper's step-size
        parameter ``beta`` (they use beta = lam / t).
      backend: "kernel" | "ref".

    Returns:
      delta_alpha: (P, Q, n_p) accumulated dual change of every cell.
    """
    use_beta = step_mode == "beta"

    if backend == "kernel":
        _check_kernel_loss(loss)
        from repro_torch.kernels.sdca import sdca_epoch
        dalpha, _ = sdca_epoch(x, y, mask, alpha0, w0, idx, lam=lam, n=n,
                               Q=Q, loss=loss.name,
                               beta=(beta if use_beta else None))
        return dalpha
    if backend != "ref":
        raise ValueError(f"unknown local backend {backend!r}")

    P, Qc, n_p, m_q = x.shape
    x_sq = torch.sum(x * x, dim=-1)                # (P, Q, n_p)
    w = w0.unsqueeze(0).expand(P, Qc, m_q).clone()
    dalpha = torch.zeros((P, Qc, n_p), dtype=x.dtype, device=x.device)
    pa = torch.arange(P, device=x.device)
    idx = idx.long()
    for h in range(idx.shape[1]):
        i = idx[:, h]
        xi = x[pa, :, i]                           # (P, Q, m_q)
        zloc = (xi * w).sum(-1)       # local contribution to x_i . w
        a_i = alpha0[pa, i].unsqueeze(1) + dalpha[pa, :, i]
        d = loss.sdca_delta(a_i, x_sq[pa, :, i], zloc, y[pa, i].unsqueeze(1),
                            lam, n, Q, beta=(beta if use_beta else None))
        d = d * mask[pa, i].unsqueeze(1)           # padded rows never move
        w = w + (d / (lam * n)).unsqueeze(-1) * xi
        dalpha[pa, :, i] += d
    # the local w is dropped: D3CA recomputes w from the primal-dual map
    return dalpha


# ----------------------------------------------------------------------------
# Local RADiSA inner loop (Algorithm 3 steps 6-10): L SVRG steps on the
# assigned sub-block of coordinates.
# ----------------------------------------------------------------------------

def local_svrg(loss: Loss, x, y, mask, z_anchor, w_anchor_sub, mu_sub,
               *, lam, eta, idx, lo=None, backend: str = "kernel"):
    """L SVRG steps on one feature sub-block of every cell.

    The stochastic partial gradient uses the anchor inner products
    ``z_anchor[j] = x_j^T w_tilde`` (computed once, doubly distributed) and
    corrects locally:  x_j^T w  ~=  z_anchor[j] + x_j[sub]^T (w - w_tilde[sub]).

    Args:
      x: (P, Q, n_p, m_q) the FULL blocks; each sampled row's
        ``[lo[p] : lo[p] + m_sub]`` columns are read in place -- the
        (n_p, m_sub) column slice is never materialised.
      z_anchor: (P, n_p) full inner products at the anchor point w_tilde.
      w_anchor_sub: (P, Q, m_sub) anchor coordinates of each cell's
        sub-block.
      mu_sub: (P, Q, m_sub) coordinates of the full anchor gradient of F
        (includes the lam*w_tilde term).
      eta: learning rate eta_t.
      idx: (P, Q, L) int32 minibatch order per cell.
      lo: (P,) int32 window offsets, or None when the window is the whole
        block (RADiSA-avg).
      backend: "kernel" | "ref".

    Returns:
      w_sub: (P, Q, m_sub) updated sub-blocks.
    """
    if backend == "kernel":
        _check_kernel_loss(loss)
        from repro_torch.kernels.svrg import svrg_inner
        return svrg_inner(x, y, mask, z_anchor, w_anchor_sub, mu_sub, idx,
                          lam=lam, eta=eta, loss=loss.name, lo=lo)
    if backend != "ref":
        raise ValueError(f"unknown local backend {backend!r}")

    P, Qc, n_p, _ = x.shape
    m_sub = w_anchor_sub.shape[-1]
    pa = torch.arange(P, device=x.device)[:, None]
    qa = torch.arange(Qc, device=x.device)[None, :]
    cols = torch.arange(m_sub, device=x.device).expand(1, 1, m_sub)
    if lo is not None:
        cols = lo.long()[:, None, None] + cols
    idx = idx.long()
    w = w_anchor_sub.clone()
    for h in range(idx.shape[-1]):
        j = idx[:, :, h]                           # (P, Q)
        xj = x[pa[..., None], qa[..., None], j[..., None], cols]
        yj = y[pa, j]
        zj = z_anchor[pa, j]
        z = zj + (xj * (w - w_anchor_sub)).sum(-1)
        g_new = loss.grad(z, yj)
        g_old = loss.grad(zj, yj)
        # SVRG direction on the sub-block; the regularizer is corrected from
        # the anchor to the current point exactly (it is quadratic).
        g = (g_new - g_old).unsqueeze(-1) * xj * mask[pa, j].unsqueeze(-1) \
            + mu_sub + lam * (w - w_anchor_sub)
        w = w - eta * g
    return w

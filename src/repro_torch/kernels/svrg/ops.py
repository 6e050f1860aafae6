"""Public wrapper of the RADiSA/SVRG inner-loop kernel."""
from __future__ import annotations

import torch

from .. import _build
from .._launch import (block_threads, cell_params, check_loss, check_smem,
                       check_tensor, is_per_cell, scalar_arg)
from .ref import svrg_inner_plain


def svrg_inner(x, y, mask, z_anchor, w_anchor, mu, idx, *, lam, eta,
               loss: str = "hinge", lo=None):
    """L SVRG steps on one feature sub-block of every cell of a P x Q
    grid, in one launch.

    Batched shapes: ``x (P, Q, n_p, m_x)`` float32 contiguous -- the FULL
    blocks; ``y, mask, z_anchor (P, n_p)``; ``w_anchor, mu
    (P, Q, m_sub)`` -- the anchor and the anchor gradient already cut to
    each cell's window; ``idx (P, Q, L)`` int32 with ``0 <= idx < n_p``
    (the caller's contract); ``lo (P,)`` int32 -- the window
    ``[lo[p], lo[p] + m_sub)`` of the m_x columns that the cells of row
    partition p work on, read in place (no slice of x is materialised),
    with ``0 <= lo[p]`` and ``lo[p] + m_sub <= m_x`` (the caller's
    contract too; checked only on the CPU, where it costs no device
    synchronisation); ``None`` means column 0.  With a tenant axis after
    the grid axes: ``x (P, Q, T, n_p, m_x)``, rows ``(P, T, n_p)``,
    ``w_anchor, mu (P, Q, T, m_sub)``, ``idx (P, Q, T, L)``, ``lo (P,
    T)``.  The unbatched shapes of one cell -- ``x (n_p, m_x)``, vectors
    ``(n_p,)``, ``w_anchor, mu (m_sub,)``, ``idx (L,)``, ``lo`` an int
    or None -- are accepted too.

    ``lam`` and ``eta`` are numbers, or tensors broadcastable to the cell
    grid ``(P, Q[, T])`` (per tenant or per cell), which reach the kernel
    as its per-cell ``cell_params``.  Returns the updated sub-block
    iterate ``(P, Q[, T], m_sub)`` (or ``(m_sub,)``).  A CUDA tensor
    launches the CUDA kernel or raises; the plain PyTorch version runs
    only for tensors that lie on the CPU.
    """
    loss_id = check_loss(loss, "the svrg_inner kernel")
    unbatched = isinstance(x, torch.Tensor) and x.dim() == 2
    if unbatched:
        x, y, mask, z_anchor, w_anchor, mu, idx = (
            x[None, None], y[None], mask[None], z_anchor[None],
            w_anchor[None, None], mu[None, None], idx[None, None])
        if lo is not None:
            lo = torch.tensor([int(lo)], dtype=torch.int32, device=x.device)
    if not isinstance(x, torch.Tensor) or x.dim() not in (4, 5):
        raise ValueError("x must be (P, Q, n_p, m_x), (P, Q, T, n_p, m_x) "
                         "or (n_p, m_x)")
    P, Qc = x.shape[:2]
    ten = tuple(x.shape[2:-2])                     # (T,) or ()
    n_p, m_x = x.shape[-2:]
    dev, f32 = x.device, torch.float32
    check_tensor("x", x, (P, Qc, *ten, n_p, m_x), f32, dev)
    check_tensor("y", y, (P, *ten, n_p), f32, dev)
    check_tensor("mask", mask, (P, *ten, n_p), f32, dev)
    check_tensor("z_anchor", z_anchor, (P, *ten, n_p), f32, dev)
    if w_anchor.dim() != 3 + len(ten):
        raise ValueError(f"w_anchor must be (P, Q, {'T, ' if ten else ''}"
                         f"m_sub), got {tuple(w_anchor.shape)}")
    m_sub = w_anchor.shape[-1]
    check_tensor("w_anchor", w_anchor, (P, Qc, *ten, m_sub), f32, dev)
    check_tensor("mu", mu, (P, Qc, *ten, m_sub), f32, dev)
    if idx.dim() != 3 + len(ten):
        raise ValueError(f"idx must be (P, Q, {'T, ' if ten else ''}L), "
                         f"got {tuple(idx.shape)}")
    check_tensor("idx", idx, (P, Qc, *ten, idx.shape[-1]), torch.int32, dev)
    if lo is not None:
        check_tensor("lo", lo, (P, *ten), torch.int32, dev)
    if m_sub > m_x or (lo is None and m_sub != m_x):
        raise ValueError(f"window of {m_sub} columns does not match blocks "
                         f"of {m_x} columns (lo={'given' if lo is not None else None})")

    if dev.type == "cpu":
        if lo is not None and (int(lo.min()) < 0
                               or int(lo.max()) + m_sub > m_x):
            raise ValueError("window [lo, lo + m_sub) leaves the block")
        w = svrg_inner_plain(x, y, mask, z_anchor, w_anchor, mu, idx,
                             lam=lam, eta=eta, loss=loss, lo=lo)
    elif dev.type == "cuda":
        w = _launch(x, y, mask, z_anchor, w_anchor, mu, idx, lo, lam=lam,
                    eta=eta, loss_id=loss_id)
    else:
        raise NotImplementedError(f"svrg_inner has no path for {dev}")
    return w[0, 0] if unbatched else w


#: number of CUDA kernel launches made by this wrapper (and nothing else)
#: -- one per call, whatever the number of tenants
svrg_inner.launches = 0


def _launch(x, y, mask, z_anchor, w_anchor, mu, idx, lo, *, lam, eta,
            loss_id):
    P, Qc = x.shape[:2]
    lead = tuple(x.shape[:-2])                     # (P, Q[, T])
    T = x.shape[2] if x.dim() == 5 else 1
    n_p, m_x = x.shape[-2:]
    m_sub = w_anchor.shape[-1]
    check_smem(5 * m_sub * 4, f"svrg_inner with m_sub={m_sub}")
    lib = _build.load_library()
    w = torch.empty((*lead, m_sub), dtype=x.dtype, device=x.device)
    params = (cell_params(lead, x.device, lam, eta)
              if is_per_cell(lam, eta) else None)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.svrg_inner_launch(
            x.data_ptr(), y.data_ptr(), mask.data_ptr(), z_anchor.data_ptr(),
            w_anchor.data_ptr(), mu.data_ptr(), idx.data_ptr(),
            lo.data_ptr() if lo is not None else None, w.data_ptr(),
            P, Qc, T, n_p, m_x, m_sub, idx.shape[-1], scalar_arg(lam),
            scalar_arg(eta),
            params.data_ptr() if params is not None else None, loss_id,
            block_threads(m_sub), stream)
    _build.check_launch(lib, code, "svrg_inner")
    svrg_inner.launches += 1
    return w

"""Public wrapper of the RADiSA/SVRG inner-loop kernel."""
from __future__ import annotations

import torch

from .. import _build
from .._launch import (block_threads, check_loss, check_smem, check_tensor)
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
    synchronisation); ``None`` means column 0.  The unbatched shapes of one cell --
    ``x (n_p, m_x)``, vectors ``(n_p,)``, ``w_anchor, mu (m_sub,)``,
    ``idx (L,)``, ``lo`` an int or None -- are accepted too.

    Returns the updated sub-block iterate ``(P, Q, m_sub)`` (or
    ``(m_sub,)``).  A CUDA tensor launches the CUDA kernel or raises; the
    plain PyTorch version runs only for tensors that lie on the CPU.
    """
    loss_id = check_loss(loss, "the svrg_inner kernel")
    unbatched = isinstance(x, torch.Tensor) and x.dim() == 2
    if unbatched:
        x, y, mask, z_anchor, w_anchor, mu, idx = (
            x[None, None], y[None], mask[None], z_anchor[None],
            w_anchor[None, None], mu[None, None], idx[None, None])
        if lo is not None:
            lo = torch.tensor([int(lo)], dtype=torch.int32, device=x.device)
    if not isinstance(x, torch.Tensor) or x.dim() != 4:
        raise ValueError("x must be (P, Q, n_p, m_x) or (n_p, m_x)")
    P, Qc, n_p, m_x = x.shape
    dev, f32 = x.device, torch.float32
    check_tensor("x", x, (P, Qc, n_p, m_x), f32, dev)
    check_tensor("y", y, (P, n_p), f32, dev)
    check_tensor("mask", mask, (P, n_p), f32, dev)
    check_tensor("z_anchor", z_anchor, (P, n_p), f32, dev)
    if w_anchor.dim() != 3:
        raise ValueError("w_anchor must be (P, Q, m_sub), got "
                         f"{tuple(w_anchor.shape)}")
    m_sub = w_anchor.shape[2]
    check_tensor("w_anchor", w_anchor, (P, Qc, m_sub), f32, dev)
    check_tensor("mu", mu, (P, Qc, m_sub), f32, dev)
    if idx.dim() != 3:
        raise ValueError(f"idx must be (P, Q, L), got {tuple(idx.shape)}")
    check_tensor("idx", idx, (P, Qc, idx.shape[2]), torch.int32, dev)
    if lo is not None:
        check_tensor("lo", lo, (P,), torch.int32, dev)
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
svrg_inner.launches = 0


def _launch(x, y, mask, z_anchor, w_anchor, mu, idx, lo, *, lam, eta,
            loss_id):
    P, Qc, n_p, m_x = x.shape
    m_sub = w_anchor.shape[2]
    check_smem(5 * m_sub * 4, f"svrg_inner with m_sub={m_sub}")
    lib = _build.load_library()
    w = torch.empty((P, Qc, m_sub), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.svrg_inner_launch(
            x.data_ptr(), y.data_ptr(), mask.data_ptr(), z_anchor.data_ptr(),
            w_anchor.data_ptr(), mu.data_ptr(), idx.data_ptr(),
            lo.data_ptr() if lo is not None else None, w.data_ptr(),
            P, Qc, n_p, m_x, m_sub, idx.shape[2], float(lam), float(eta),
            None, loss_id, block_threads(m_sub), stream)
    _build.check_launch(lib, code, "svrg_inner")
    svrg_inner.launches += 1
    return w

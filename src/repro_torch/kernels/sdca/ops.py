"""Public wrapper of the local SDCA epoch kernel."""
from __future__ import annotations

import torch

from .. import _build
from .._launch import (block_threads, check_loss, check_smem, check_tensor)
from .ref import sdca_epoch_plain


def sdca_epoch(x, y, mask, alpha0, w0, idx, *, lam, n, Q,
               loss: str = "hinge", beta=None):
    """One local SDCA epoch on every cell of a P x Q grid, in one launch.

    Batched shapes: ``x (P, Q, n_p, m_q)`` float32 contiguous;
    ``y, mask, alpha0 (P, n_p)`` (indexed by the row partition p);
    ``w0 (Q, m_q)`` (indexed by the feature partition q);
    ``idx (P, steps)`` int32 with ``0 <= idx < n_p`` (the caller's
    contract; not checked per launch).  The unbatched shapes of one cell
    -- ``x (n_p, m_q)``, vectors ``(n_p,)``, ``w0 (m_q,)``,
    ``idx (steps,)`` -- are accepted too.

    ``Q`` is the number of feature partitions that scales the conjugate
    term; ``beta`` (a runtime scalar or None) selects the paper's
    step_mode="beta" denominator.  Returns ``(dalpha, w_final)`` of
    shapes ``(P, Q, n_p)`` / ``(P, Q, m_q)`` (or ``(n_p,)`` / ``(m_q,)``).

    A CUDA tensor launches the CUDA kernel or raises; the plain PyTorch
    version runs only for tensors that lie on the CPU.
    """
    loss_id = check_loss(loss, "the sdca_epoch kernel")
    unbatched = isinstance(x, torch.Tensor) and x.dim() == 2
    if unbatched:
        x, y, mask, alpha0, w0, idx = (
            x[None, None], y[None], mask[None], alpha0[None], w0[None],
            idx[None])
    if not isinstance(x, torch.Tensor) or x.dim() != 4:
        raise ValueError("x must be (P, Q, n_p, m_q) or (n_p, m_q)")
    P, Qc, n_p, m_q = x.shape
    dev, f32 = x.device, torch.float32
    check_tensor("x", x, (P, Qc, n_p, m_q), f32, dev)
    check_tensor("y", y, (P, n_p), f32, dev)
    check_tensor("mask", mask, (P, n_p), f32, dev)
    check_tensor("alpha0", alpha0, (P, n_p), f32, dev)
    check_tensor("w0", w0, (Qc, m_q), f32, dev)
    if idx.dim() != 2:
        raise ValueError(f"idx must be (P, steps), got {tuple(idx.shape)}")
    check_tensor("idx", idx, (P, idx.shape[1]), torch.int32, dev)

    if dev.type == "cpu":
        dalpha, w_fin = sdca_epoch_plain(x, y, mask, alpha0, w0, idx,
                                         lam=lam, n=n, Q=Q, loss=loss,
                                         beta=beta)
    elif dev.type == "cuda":
        dalpha, w_fin = _launch(x, y, mask, alpha0, w0, idx, lam=lam, n=n,
                                Q=Q, loss_id=loss_id, beta=beta)
    else:
        raise NotImplementedError(f"sdca_epoch has no path for {dev}")
    if unbatched:
        return dalpha[0, 0], w_fin[0, 0]
    return dalpha, w_fin


#: number of CUDA kernel launches made by this wrapper (and nothing else)
sdca_epoch.launches = 0


def _launch(x, y, mask, alpha0, w0, idx, *, lam, n, Q, loss_id, beta):
    P, Qc, n_p, m_q = x.shape
    check_smem(3 * m_q * 4, f"sdca_epoch with m_q={m_q}")
    lib = _build.load_library()
    dalpha = torch.zeros((P, Qc, n_p), dtype=x.dtype, device=x.device)
    w_fin = torch.empty((P, Qc, m_q), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.sdca_epoch_launch(
            x.data_ptr(), y.data_ptr(), mask.data_ptr(), alpha0.data_ptr(),
            w0.data_ptr(), idx.data_ptr(), dalpha.data_ptr(),
            w_fin.data_ptr(), P, Qc, n_p, m_q, idx.shape[1],
            float(lam), float(n), float(Q), float(beta if beta is not None else 0.0),
            int(beta is not None), None, loss_id, block_threads(m_q), stream)
    _build.check_launch(lib, code, "sdca_epoch")
    sdca_epoch.launches += 1
    return dalpha, w_fin

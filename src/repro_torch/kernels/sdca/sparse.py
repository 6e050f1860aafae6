"""Local SDCA epoch on padded-ELL sparse blocks: the public wrapper of
``csrc/sdca_epoch_sparse.cu`` and its plain PyTorch version.

The plain version is the same batched function as the kernel: a Python
loop over the steps, vectorised over the P x Q cells.  The CPU tests run
it, the chip check compares the kernel with it on the card, and
``sdca_epoch_sparse`` takes it only for tensors that lie on the CPU.
"""
from __future__ import annotations

import torch

from .. import _build
from .._launch import check_loss, check_smem, check_tensor, ell_threads


def sdca_epoch_sparse(cols, vals, y, mask, alpha0, w0, idx, *, lam, n, Q,
                      loss: str = "hinge", beta=None):
    """One local SDCA epoch on every padded-ELL cell of a P x Q grid, in
    one launch.

    Batched shapes: ``cols (P, Q, n_p, k)`` int32 and ``vals (P, Q, n_p,
    k)`` float32, contiguous -- block-local column ids and values, padding
    slots (col 0, val 0); ``y, mask, alpha0 (P, n_p)``; ``w0 (Q, m_q)``;
    ``idx (P, steps)`` int32.  The caller's contract, not checked per
    launch: ``0 <= idx < n_p`` and ``0 <= cols < m_q``.  The unbatched
    shapes of one cell -- ``cols, vals (n_p, k)``, vectors ``(n_p,)``,
    ``w0 (m_q,)``, ``idx (steps,)`` -- are accepted too.

    ``Q`` is the number of feature partitions that scales the conjugate
    term; ``beta`` (a runtime scalar or None) selects the paper's
    step_mode="beta" denominator.  Returns ``(dalpha, w_final)`` of
    shapes ``(P, Q, n_p)`` / ``(P, Q, m_q)`` (or ``(n_p,)`` / ``(m_q,)``).

    A CUDA tensor launches the CUDA kernel or raises; the plain PyTorch
    version runs only for tensors that lie on the CPU.
    """
    loss_id = check_loss(loss, "the sdca_epoch_sparse kernel")
    unbatched = isinstance(cols, torch.Tensor) and cols.dim() == 2
    if unbatched:
        cols, vals, y, mask, alpha0, w0, idx = (
            cols[None, None], vals[None, None], y[None], mask[None],
            alpha0[None], w0[None], idx[None])
    if not isinstance(cols, torch.Tensor) or cols.dim() != 4:
        raise ValueError("cols must be (P, Q, n_p, k) or (n_p, k)")
    P, Qc, n_p, k = cols.shape
    dev, f32 = cols.device, torch.float32
    check_tensor("cols", cols, (P, Qc, n_p, k), torch.int32, dev)
    check_tensor("vals", vals, (P, Qc, n_p, k), f32, dev)
    check_tensor("y", y, (P, n_p), f32, dev)
    check_tensor("mask", mask, (P, n_p), f32, dev)
    check_tensor("alpha0", alpha0, (P, n_p), f32, dev)
    if w0.dim() != 2:
        raise ValueError(f"w0 must be (Q, m_q), got {tuple(w0.shape)}")
    check_tensor("w0", w0, (Qc, w0.shape[1]), f32, dev)
    if idx.dim() != 2:
        raise ValueError(f"idx must be (P, steps), got {tuple(idx.shape)}")
    check_tensor("idx", idx, (P, idx.shape[1]), torch.int32, dev)

    if dev.type == "cpu":
        dalpha, w_fin = sdca_epoch_sparse_plain(
            cols, vals, y, mask, alpha0, w0, idx, lam=lam, n=n, Q=Q,
            loss=loss, beta=beta)
    elif dev.type == "cuda":
        dalpha, w_fin = _launch(cols, vals, y, mask, alpha0, w0, idx,
                                lam=lam, n=n, Q=Q, loss_id=loss_id,
                                beta=beta)
    else:
        raise NotImplementedError(f"sdca_epoch_sparse has no path for {dev}")
    if unbatched:
        return dalpha[0, 0], w_fin[0, 0]
    return dalpha, w_fin


#: number of CUDA kernel launches made by this wrapper (and nothing else)
sdca_epoch_sparse.launches = 0


def _launch(cols, vals, y, mask, alpha0, w0, idx, *, lam, n, Q, loss_id,
            beta):
    P, Qc, n_p, k = cols.shape
    m_q = w0.shape[1]
    # only the two ELL row buffers live in shared memory; w stays in
    # device memory (the w_final output), whatever m_q
    check_smem(2 * k * 8, f"sdca_epoch_sparse with k={k}")
    lib = _build.load_library()
    dalpha = torch.zeros((P, Qc, n_p), dtype=vals.dtype, device=vals.device)
    w_fin = torch.empty((P, Qc, m_q), dtype=vals.dtype, device=vals.device)
    with torch.cuda.device(vals.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.sdca_epoch_sparse_launch(
            cols.data_ptr(), vals.data_ptr(), y.data_ptr(), mask.data_ptr(),
            alpha0.data_ptr(), w0.data_ptr(), idx.data_ptr(),
            dalpha.data_ptr(), w_fin.data_ptr(), P, Qc, n_p, k, m_q,
            idx.shape[1], float(lam), float(n), float(Q),
            float(beta if beta is not None else 0.0), int(beta is not None),
            None, loss_id, ell_threads(k), stream)
    _build.check_launch(lib, code, "sdca_epoch_sparse")
    sdca_epoch_sparse.launches += 1
    return dalpha, w_fin


def sdca_epoch_sparse_plain(cols, vals, y, mask, alpha0, w0, idx, *, lam, n,
                            Q, loss: str = "hinge", beta=None):
    """cols, vals: (P, Q, n_p, k); y, mask, alpha0: (P, n_p); w0: (Q, m_q);
    idx: (P, steps) int32 coordinate order, shared by the cells of a row
    partition.

    Per step: z = sum(vals * w[cols]) (gather), the closed-form dual
    step, w[cols] += d / (lam n) * vals (scatter-add, so the duplicate
    col-0 padding slots add zero), dalpha[i] += d.  ``beta`` (runtime
    scalar) replaces the ||x_i||^2 denominator when given.  Returns
    (dalpha (P, Q, n_p), w_final (P, Q, m_q)) in float32.
    """
    if loss not in ("hinge", "squared"):
        raise ValueError(loss)
    P, Qc, n_p, k = cols.shape
    m_q = w0.shape[-1]
    w = w0.unsqueeze(0).expand(P, Qc, m_q).clone()
    dalpha = torch.zeros((P, Qc, n_p), dtype=vals.dtype, device=vals.device)
    pa = torch.arange(P, device=vals.device)
    idx = idx.long()
    for h in range(idx.shape[1]):
        i = idx[:, h]                              # (P,)
        ci = cols[pa, :, i].long()                 # (P, Q, k)
        vi = vals[pa, :, i]
        yi = y[pa, i].unsqueeze(1)                 # (P, 1)
        mi = mask[pa, i].unsqueeze(1)
        zloc = (vi * torch.gather(w, 2, ci)).sum(-1)   # (P, Q)
        a_i = alpha0[pa, i].unsqueeze(1) + dalpha[pa, :, i]
        if beta is None:
            denom = (vi * vi).sum(-1)
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
        w.scatter_add_(2, ci, (d / (lam * n)).unsqueeze(-1) * vi)
        dalpha[pa, :, i] += d
    return dalpha, w

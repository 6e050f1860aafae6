"""RADiSA / SFK inner loop on padded-ELL sparse blocks: the public wrapper
of ``csrc/svrg_inner_sparse.cu`` and its plain PyTorch version.

The plain version is the same batched function as the kernel: a Python
loop over the L steps, vectorised over the P x Q cells.  The CPU tests
run it, the chip check compares the kernel with it on the card, and
``svrg_inner_sparse`` takes it only for tensors that lie on the CPU.
"""
from __future__ import annotations

import torch

from .. import _build
from .._launch import check_loss, check_smem, check_tensor, ell_threads
from .ref import _grad


def svrg_inner_sparse(cols, vals, y, mask, z_anchor, w_anchor, mu, idx, *,
                      lam, eta, loss: str = "hinge", lo=None):
    """L SVRG steps on one feature sub-block window of every padded-ELL
    cell of a P x Q grid, in one launch.

    Batched shapes: ``cols (P, Q, n_p, k)`` int32 and ``vals`` float32,
    contiguous -- the FULL blocks, block-local column ids; ``y, mask,
    z_anchor (P, n_p)``; ``w_anchor, mu (P, Q, m_sub)`` -- the anchor and
    the anchor gradient cut to each cell's window; ``idx (P, Q, L)``
    int32 with ``0 <= idx < n_p`` (the caller's contract); ``lo (P,)``
    int32 -- the window ``[lo[p], lo[p] + m_sub)`` of block-local columns
    the cells of row partition p work on, chosen inside the kernel by
    masking ``cols - lo`` (entries outside it are skipped, so any ``lo``
    is safe); ``None`` means column 0.  The unbatched shapes of one cell
    -- ``cols, vals (n_p, k)``, vectors ``(n_p,)``, ``w_anchor, mu
    (m_sub,)``, ``idx (L,)``, ``lo`` an int or None -- are accepted too.

    Returns the updated window iterate ``(P, Q, m_sub)`` (or
    ``(m_sub,)``).  A CUDA tensor launches the CUDA kernel or raises; the
    plain PyTorch version runs only for tensors that lie on the CPU.
    """
    loss_id = check_loss(loss, "the svrg_inner_sparse kernel")
    unbatched = isinstance(cols, torch.Tensor) and cols.dim() == 2
    if unbatched:
        cols, vals, y, mask, z_anchor, w_anchor, mu, idx = (
            cols[None, None], vals[None, None], y[None], mask[None],
            z_anchor[None], w_anchor[None, None], mu[None, None],
            idx[None, None])
        if lo is not None:
            lo = torch.tensor([int(lo)], dtype=torch.int32,
                              device=cols.device)
    if not isinstance(cols, torch.Tensor) or cols.dim() != 4:
        raise ValueError("cols must be (P, Q, n_p, k) or (n_p, k)")
    P, Qc, n_p, k = cols.shape
    dev, f32 = cols.device, torch.float32
    check_tensor("cols", cols, (P, Qc, n_p, k), torch.int32, dev)
    check_tensor("vals", vals, (P, Qc, n_p, k), f32, dev)
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

    if dev.type == "cpu":
        w = svrg_inner_sparse_plain(cols, vals, y, mask, z_anchor, w_anchor,
                                    mu, idx, lam=lam, eta=eta, loss=loss,
                                    lo=lo)
    elif dev.type == "cuda":
        w = _launch(cols, vals, y, mask, z_anchor, w_anchor, mu, idx, lo,
                    lam=lam, eta=eta, loss_id=loss_id)
    else:
        raise NotImplementedError(f"svrg_inner_sparse has no path for {dev}")
    return w[0, 0] if unbatched else w


#: number of CUDA kernel launches made by this wrapper (and nothing else)
svrg_inner_sparse.launches = 0


def _launch(cols, vals, y, mask, z_anchor, w_anchor, mu, idx, lo, *, lam,
            eta, loss_id):
    P, Qc, n_p, k = cols.shape
    m_sub = w_anchor.shape[2]
    # only the two ELL row buffers live in shared memory; the window
    # vectors stay in device memory, whatever m_sub
    check_smem(2 * k * 8, f"svrg_inner_sparse with k={k}")
    lib = _build.load_library()
    w = torch.empty((P, Qc, m_sub), dtype=vals.dtype, device=vals.device)
    g = torch.zeros((P, Qc, m_sub), dtype=vals.dtype, device=vals.device)
    with torch.cuda.device(vals.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.svrg_inner_sparse_launch(
            cols.data_ptr(), vals.data_ptr(), y.data_ptr(), mask.data_ptr(),
            z_anchor.data_ptr(), w_anchor.data_ptr(), mu.data_ptr(),
            idx.data_ptr(), lo.data_ptr() if lo is not None else None,
            w.data_ptr(), g.data_ptr(), P, Qc, n_p, k, m_sub, idx.shape[2],
            float(lam), float(eta), None, loss_id,
            ell_threads(k, m_sub, max_warps=32), stream)
    _build.check_launch(lib, code, "svrg_inner_sparse")
    svrg_inner_sparse.launches += 1
    return w


def svrg_inner_sparse_plain(cols, vals, y, mask, z_anchor, w_anchor, mu, idx,
                            *, lam, eta, loss: str = "hinge", lo=None):
    """cols, vals: (P, Q, n_p, k) FULL blocks; y, mask, z_anchor: (P, n_p);
    w_anchor, mu: (P, Q, m_sub); idx: (P, Q, L) int32 minibatch order per
    cell; ``lo`` (P,) int32 window offsets (None: column 0).

    Per step: rel = cols - lo selects the in-window entries of row j;
    z = z_anchor[j] + sum(vals * sel * (w - w~)[rel]); the loss-gradient
    difference times the row is scatter-added into a zero window vector
    g_sparse, and w = w - eta * (g_sparse + mu + lam * (w - w~)).
    Returns w (P, Q, m_sub).
    """
    P, Qc = cols.shape[:2]
    m_sub = w_anchor.shape[-1]
    pa = torch.arange(P, device=vals.device)[:, None]
    qa = torch.arange(Qc, device=vals.device)[None, :]
    off = 0 if lo is None else lo.long()[:, None, None]
    idx = idx.long()
    w = w_anchor.clone()
    for h in range(idx.shape[-1]):
        j = idx[:, :, h]                                # (P, Q)
        rel = cols[pa, qa, j].long() - off              # (P, Q, k)
        vj = vals[pa, qa, j]
        yj, mj, zj = y[pa, j], mask[pa, j], z_anchor[pa, j]
        sel = ((rel >= 0) & (rel < m_sub)).to(vj.dtype)
        relc = rel.clamp(0, m_sub - 1)
        diff = w - w_anchor
        z = zj + (vj * sel * torch.gather(diff, 2, relc)).sum(-1)
        gscale = (_grad(loss, z, yj) - _grad(loss, zj, yj)) * mj
        g_sparse = torch.zeros_like(w).scatter_add_(
            2, relc, gscale.unsqueeze(-1) * vj * sel)
        w = w - eta * (g_sparse + mu + lam * diff)
    return w

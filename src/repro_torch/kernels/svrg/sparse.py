"""RADiSA / SFK inner loop on padded-ELL sparse blocks: the public wrapper
of ``csrc/svrg_inner_sparse.cu`` and its plain PyTorch version.

Two routes, chosen by :func:`svrg_sparse_route` from the window width and
the ELL row width alone: ``"cluster"`` -- one thread-block cluster of
``CLUSTER_SIZE`` CTAs per cell, each holding a slice of the window on chip
for the whole launch -- wherever the slice fits; ``"block"`` -- one block
per cell, the window in device memory -- for wider windows (RADiSA's
``avg`` variant at news20 width).  Both round every element of the dense
pass alike.

The plain version is the same batched function as the kernel: a Python
loop over the L steps, vectorised over the P x Q cells.  The CPU tests
run it, the chip check compares the kernel with it on the card, and
``svrg_inner_sparse`` takes it only for tensors that lie on the CPU.
"""
from __future__ import annotations

import torch

from .. import _build
from .._launch import (MAX_DYNAMIC_SMEM, cell_index, cell_params,
                       check_loss, check_smem, check_tensor, ell_threads,
                       is_per_cell, per_cell, scalar_arg)
from .ref import _grad

#: the cluster route's geometry, owned here and passed to the launch, which
#: refuses any other cluster size or thread count than the kernel is
#: compiled for: CTAs per cell (the portable cluster size), threads of a
#: CTA, and the most window columns a thread holds in registers
CLUSTER_SIZE = 8
CLUSTER_THREADS = 256
CLUSTER_MAX_PER_THREAD = 64
ROUTES = ("cluster", "block")


def cluster_slice(m_sub: int) -> int:
    """Window columns one CTA of the cluster route owns."""
    return -(-m_sub // CLUSTER_SIZE)


def cluster_smem(m_sub: int, k: int) -> int:
    """Dynamic shared memory of one cluster CTA, in the kernel's layout:
    its slice (padded to a whole number of 4-column runs) of w - w~ and of
    the scatter scratch, then two ELL rows (column ids and values)."""
    return 8 * (-(-cluster_slice(m_sub) // 4) * 4) + 2 * k * 8


def svrg_sparse_route(m_sub: int, k: int) -> str:
    """The kernel a CUDA call takes, by shape alone: ``"cluster"`` when a
    window slice of ``ceil(m_sub / CLUSTER_SIZE)`` columns fits the
    registers of one CTA (``CLUSTER_THREADS * CLUSTER_MAX_PER_THREAD``)
    and, with two ELL rows of ``k`` slots, its shared memory; else
    ``"block"``."""
    fits = (cluster_slice(m_sub) <= CLUSTER_THREADS * CLUSTER_MAX_PER_THREAD
            and cluster_smem(m_sub, k) <= MAX_DYNAMIC_SMEM)
    return "cluster" if fits else "block"


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
    is safe); ``None`` means column 0.  With a tenant axis after the grid
    axes: ``cols, vals (P, Q, T, n_p, k)``, rows ``(P, T, n_p)``,
    ``w_anchor, mu (P, Q, T, m_sub)``, ``idx (P, Q, T, L)``, ``lo (P,
    T)``.  The unbatched shapes of one cell -- ``cols, vals (n_p, k)``,
    vectors ``(n_p,)``, ``w_anchor, mu (m_sub,)``, ``idx (L,)``, ``lo``
    an int or None -- are accepted too.

    ``lam`` and ``eta`` are numbers, or tensors broadcastable to the cell
    grid ``(P, Q[, T])`` (per tenant or per cell), which reach the kernel
    as its per-cell ``cell_params``.  Returns the updated window iterate
    ``(P, Q[, T], m_sub)`` (or ``(m_sub,)``).  A CUDA tensor launches the
    route's CUDA kernel (:func:`svrg_sparse_route`) or raises; the plain
    PyTorch version runs only for tensors that lie on the CPU.
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
    if not isinstance(cols, torch.Tensor) or cols.dim() not in (4, 5):
        raise ValueError("cols must be (P, Q, n_p, k), (P, Q, T, n_p, k) "
                         "or (n_p, k)")
    P, Qc = cols.shape[:2]
    ten = tuple(cols.shape[2:-2])                  # (T,) or ()
    n_p, k = cols.shape[-2:]
    dev, f32 = cols.device, torch.float32
    check_tensor("cols", cols, (P, Qc, *ten, n_p, k), torch.int32, dev)
    check_tensor("vals", vals, (P, Qc, *ten, n_p, k), f32, dev)
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

    if dev.type == "cpu":
        w = svrg_inner_sparse_plain(cols, vals, y, mask, z_anchor, w_anchor,
                                    mu, idx, lam=lam, eta=eta, loss=loss,
                                    lo=lo)
    elif dev.type == "cuda":
        w = _launch(cols, vals, y, mask, z_anchor, w_anchor, mu, idx, lo,
                    lam=lam, eta=eta, loss_id=loss_id,
                    route=svrg_sparse_route(m_sub, k))
    else:
        raise NotImplementedError(f"svrg_inner_sparse has no path for {dev}")
    return w[0, 0] if unbatched else w


#: number of CUDA kernel launches made by this wrapper (and nothing else),
#: in all and per route -- one per call, whatever the number of tenants
svrg_inner_sparse.launches = 0
svrg_inner_sparse.launches_by_route = dict.fromkeys(ROUTES, 0)


def _launch(cols, vals, y, mask, z_anchor, w_anchor, mu, idx, lo, *, lam,
            eta, loss_id, route):
    """Launch the kernel of ``route`` on checked CUDA arguments.  The
    wrapper passes :func:`svrg_sparse_route`'s choice; ``chip_smoke.py``
    also passes ``"block"`` for a window the cluster route takes, to time
    the route that the main path took before."""
    P, Qc = cols.shape[:2]
    lead = tuple(cols.shape[:-2])                  # (P, Q[, T])
    T = cols.shape[2] if cols.dim() == 5 else 1
    n_p, k = cols.shape[-2:]
    m_sub = w_anchor.shape[-1]
    L = idx.shape[-1]
    lib = _build.load_library()
    w = torch.empty((*lead, m_sub), dtype=vals.dtype, device=vals.device)
    params = (cell_params(lead, vals.device, lam, eta)
              if is_per_cell(lam, eta) else None)
    ptrs = (cols.data_ptr(), vals.data_ptr(), y.data_ptr(), mask.data_ptr(),
            z_anchor.data_ptr(), w_anchor.data_ptr(), mu.data_ptr(),
            idx.data_ptr(), lo.data_ptr() if lo is not None else None,
            w.data_ptr())
    scalars = (scalar_arg(lam), scalar_arg(eta),
               params.data_ptr() if params is not None else None)
    with torch.cuda.device(vals.device):
        stream = torch.cuda.current_stream().cuda_stream
        if route == "cluster":
            code = lib.svrg_inner_sparse_cluster_launch(
                *ptrs, P, Qc, T, n_p, k, m_sub, L, *scalars, loss_id,
                CLUSTER_SIZE, CLUSTER_THREADS, cluster_slice(m_sub),
                cluster_smem(m_sub, k), stream)
        else:
            # only the two ELL row buffers live in shared memory; the
            # window vectors stay in device memory, whatever m_sub
            check_smem(2 * k * 8, f"svrg_inner_sparse with k={k}")
            g = torch.zeros((*lead, m_sub), dtype=vals.dtype,
                            device=vals.device)
            code = lib.svrg_inner_sparse_launch(
                *ptrs, g.data_ptr(), P, Qc, T, n_p, k, m_sub, L, *scalars,
                loss_id, ell_threads(k, m_sub, max_warps=32), stream)
    _build.check_launch(lib, code, f"svrg_inner_sparse ({route} route)")
    svrg_inner_sparse.launches += 1
    svrg_inner_sparse.launches_by_route[route] += 1
    return w


def svrg_inner_sparse_plain(cols, vals, y, mask, z_anchor, w_anchor, mu, idx,
                            *, lam, eta, loss: str = "hinge", lo=None):
    """cols, vals: (P, Q, n_p, k) FULL blocks; y, mask, z_anchor: (P, n_p);
    w_anchor, mu: (P, Q, m_sub); idx: (P, Q, L) int32 minibatch order per
    cell; ``lo`` (P,) int32 window offsets (None: column 0).  With a
    tenant axis: cols, vals (P, Q, T, n_p, k); rows (P, T, n_p);
    w_anchor, mu (P, Q, T, m_sub); idx (P, Q, T, L); lo (P, T).  ``lam``
    and ``eta`` are numbers or tensors broadcastable to the cell grid.

    Per step: rel = cols - lo selects the in-window entries of row j;
    z = z_anchor[j] + sum(vals * sel * (w - w~)[rel]); the loss-gradient
    difference times the row is scatter-added into a zero window vector
    g_sparse, and w = w - eta * (g_sparse + mu + lam * (w - w~)).
    Returns w (P, Q[, T], m_sub).
    """
    tenant = cols.dim() == 5
    P, Qc = cols.shape[:2]
    T = cols.shape[2] if tenant else 1
    n_p, k = cols.shape[-2:]
    m_sub = w_anchor.shape[-1]
    lead = (P, Qc, T) if tenant else (P, Qc)
    dev = vals.device
    cell, row, _ = cell_index(P, Qc, T, dev)
    cf, vf = cols.reshape(-1, n_p, k), vals.reshape(-1, n_p, k)
    yf, mf, zf = (v.reshape(P * T, n_p)[row] for v in (y, mask, z_anchor))
    wa = w_anchor.reshape(-1, m_sub)
    muf = mu.reshape(-1, m_sub)
    idxf = idx.reshape(cell.numel(), -1).long()
    off = 0 if lo is None else lo.reshape(P * T)[row].long()[:, None]
    lam_c = per_cell(lam, lead, dev)[:, None]
    eta_c = per_cell(eta, lead, dev)[:, None]
    w = wa.clone()
    for h in range(idxf.shape[1]):
        j = idxf[:, h]                                  # (C,)
        rel = cf[cell, j].long() - off                  # (C, k)
        vj = vf[cell, j]
        yj, mj, zj = yf[cell, j], mf[cell, j], zf[cell, j]
        sel = ((rel >= 0) & (rel < m_sub)).to(vj.dtype)
        relc = rel.clamp(0, m_sub - 1)
        diff = w - wa
        z = zj + (vj * sel * torch.gather(diff, 1, relc)).sum(-1)
        gscale = (_grad(loss, z, yj) - _grad(loss, zj, yj)) * mj
        g_sparse = torch.zeros_like(w).scatter_add_(
            1, relc, gscale.unsqueeze(-1) * vj * sel)
        w = w - eta_c * (g_sparse + muf + lam_c * diff)
    return w.reshape(*lead, m_sub)

"""Public wrapper of the RADiSA/SVRG inner-loop kernel.

Two routes, chosen by :func:`svrg_route` from the window width and the
step count alone: ``"ring"`` (``csrc/svrg_inner_ring.cu``) -- one CTA of
:func:`svrg_ring_warps` warps per cell, the window's w, w~ and mu in
registers, the cell's order and a ring of rows (bulk copies) in shared
memory -- wherever the window fits the registers and the order and the
ring the shared memory, which covers the main path's RADiSA cells;
``"block"`` (``csrc/svrg_inner.cu``) -- one block per cell, w, w~ and mu
in shared memory, the next row by 4-byte copies -- for the rest.  Both
update each column with the same expression; they sum each row's inner
product in other orders.
"""
from __future__ import annotations

import torch

from .. import _build
from .._launch import (MAX_DYNAMIC_SMEM, block_threads, cell_params,
                       check_loss, check_smem, check_tensor, is_per_cell,
                       scalar_arg)
from .ref import svrg_inner_plain

ROUTES = ("ring", "block")
#: the ring route's geometry, owned here and passed to the launch, which
#: refuses any other than the kernel is compiled for: the warps of a cell,
#: the window columns a thread may hold in registers (4, 8 or 16 on one
#: warp; 8 or 16 on four, which take only windows over 512 columns), and
#: the rows in flight (slots of the shared-memory ring)
RING_WARPS = (1, 4)
RING_PER_THREAD = (4, 8, 16)
RING_SLOTS = 8
RING_MAX_WINDOW = 32 * RING_WARPS[-1] * RING_PER_THREAD[-1]
#: (widest window, warps a cell), first match: windows up to 512 columns
#: on one warp, no barrier a step (at the RADiSA cells' 429 columns one
#: warp beat four on the card, PERF.md); wider ones on four warps
RING_TABLE = ((32 * RING_PER_THREAD[-1], 1), (RING_MAX_WINDOW, 4))


def svrg_ring_warps(m_sub: int) -> int:
    """Warps a cell of the ring route, from the window width alone
    (``RING_TABLE``; the widest entry for wider windows)."""
    for widest, warps in RING_TABLE:
        if m_sub <= widest:
            return warps
    return RING_TABLE[-1][1]


def svrg_ring_per_thread(m_sub: int, warps: int) -> int:
    """Window columns a thread holds: the fewest the kernel is compiled
    for that cover the window (the most, for a wider window)."""
    for e in RING_PER_THREAD:
        if m_sub <= 32 * warps * e:
            return e
    return RING_PER_THREAD[-1]


def svrg_ring_smem(L: int, warps: int, per_thread: int) -> int:
    """Dynamic shared memory of one ring CTA, in the kernel's layout: the
    cell's ``L`` indices (rounded up to a multiple of 4), then
    ``RING_SLOTS`` slots of ``32 * warps * per_thread + 8`` floats of row (a window
    copied from the 16-byte boundary at or before its first column) and
    12 of scalars (three 16-byte chunks: label, mask, anchor margin)."""
    return 4 * (-(-L // 4) * 4 + RING_SLOTS * (32 * warps * per_thread + 20))


def svrg_route(m_sub: int, L: int) -> str:
    """The kernel a CUDA call takes, by shape alone: ``"ring"`` when the
    window fits the registers of one CTA (``RING_MAX_WINDOW`` columns)
    and the order and the ring of rows its shared memory; else
    ``"block"``."""
    if not 1 <= m_sub <= RING_MAX_WINDOW or L < 0:
        return "block"
    warps = svrg_ring_warps(m_sub)
    smem = svrg_ring_smem(L, warps, svrg_ring_per_thread(m_sub, warps))
    return "ring" if smem <= MAX_DYNAMIC_SMEM else "block"


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
    only for tensors that lie on the CPU.  On the card the route is
    :func:`svrg_route`'s.
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
                    eta=eta, loss_id=loss_id,
                    route=svrg_route(m_sub, idx.shape[-1]))
    else:
        raise NotImplementedError(f"svrg_inner has no path for {dev}")
    return w[0, 0] if unbatched else w


#: number of CUDA kernel launches made by this wrapper (and nothing else),
#: in all and per route -- one per call, whatever the number of tenants
svrg_inner.launches = 0
svrg_inner.launches_by_route = dict.fromkeys(ROUTES, 0)


def _launch(x, y, mask, z_anchor, w_anchor, mu, idx, lo, *, lam, eta,
            loss_id, route):
    """Launch one route.  The wrapper passes :func:`svrg_route`'s choice;
    only ``chip_smoke.py`` calls it directly, with ``route="block"`` at a
    main-path shape, to time the route the ring route replaced."""
    if route not in ROUTES:
        raise ValueError(f"unknown svrg_inner route {route!r}")
    P, Qc = x.shape[:2]
    lead = tuple(x.shape[:-2])                     # (P, Q[, T])
    T = x.shape[2] if x.dim() == 5 else 1
    n_p, m_x = x.shape[-2:]
    m_sub = w_anchor.shape[-1]
    L = idx.shape[-1]
    if route == "block":
        check_smem(5 * m_sub * 4, f"svrg_inner with m_sub={m_sub}")
    lib = _build.load_library()
    w = torch.empty((*lead, m_sub), dtype=x.dtype, device=x.device)
    params = (cell_params(lead, x.device, lam, eta)
              if is_per_cell(lam, eta) else None)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        ptrs = (x.data_ptr(), y.data_ptr(), mask.data_ptr(),
                z_anchor.data_ptr(), w_anchor.data_ptr(), mu.data_ptr(),
                idx.data_ptr(), lo.data_ptr() if lo is not None else None,
                w.data_ptr())
        scalars = (scalar_arg(lam), scalar_arg(eta),
                   params.data_ptr() if params is not None else None)
        if route == "ring":
            warps = svrg_ring_warps(m_sub)
            e = svrg_ring_per_thread(m_sub, warps)
            code = lib.svrg_inner_ring_launch(
                *ptrs, P, Qc, T, n_p, m_x, m_sub, L, *scalars, loss_id,
                warps, e, RING_SLOTS, svrg_ring_smem(L, warps, e), stream)
        else:
            code = lib.svrg_inner_launch(
                *ptrs, P, Qc, T, n_p, m_x, m_sub, L, *scalars, loss_id,
                block_threads(m_sub), stream)
    _build.check_launch(lib, code, f"svrg_inner ({route})")
    svrg_inner.launches += 1
    svrg_inner.launches_by_route[route] += 1
    return w

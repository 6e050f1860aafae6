"""Public wrapper of the local SDCA epoch kernel.

Two routes, chosen by :func:`sdca_route` from the block shape alone:
``"cluster"`` (``csrc/sdca_epoch_cluster.cu``) -- one thread-block
cluster of :func:`sdca_cluster_size` CTAs per cell, each holding a slice
of w in registers and the epoch's order, dual deltas and next rows in
shared memory -- wherever the slice fits a CTA's registers and the rest
its shared memory, which covers every main-path shape (the D3CA cells and
the serial-SDCA epochs for f*); ``"block"`` (``csrc/sdca_epoch.cu``) --
one block per cell, w and two rows in shared memory -- for the rest.  Both compute the
same function; they sum each row's inner product in other orders.
"""
from __future__ import annotations

import torch

from .. import _build
from .._launch import (MAX_DYNAMIC_SMEM, block_threads, cell_params,
                       check_loss, check_smem, check_tensor, is_per_cell,
                       scalar_arg)
from .ref import sdca_epoch_plain

ROUTES = ("cluster", "block")
#: the cluster route's geometry, owned here and passed to the launch, which
#: refuses any other than the kernel is compiled for: the cluster sizes,
#: threads of a CTA, the columns of w a thread may hold in registers, and
#: the rows in flight (slots of the shared-memory ring)
CLUSTER_SIZES = (1, 16)
CLUSTER_THREADS = 128
CLUSTER_PER_THREAD = (4, 6, 8, 12, 16, 24, 32)
CLUSTER_RING = 8
CLUSTER_MAX_SLICE = CLUSTER_THREADS * CLUSTER_PER_THREAD[-1]
#: (widest m_q, CTAs per cell), first match: rows up to 4096 columns stay
#: on one CTA (no exchange between CTAs: at the D3CA cells' 3003 columns
#: one CTA beat 2 and 4 on the card); wider rows are cut over 16, which
#: beat 8 at the serial-SDCA epochs' 12 000 columns (PERF.md)
CLUSTER_TABLE = ((CLUSTER_MAX_SLICE, 1), (16 * CLUSTER_MAX_SLICE, 16))


def sdca_cluster_size(m_q: int) -> int:
    """CTAs per cell of the cluster route, from the row width alone
    (``CLUSTER_TABLE``; the widest entry for rows wider than the table)."""
    for widest, g in CLUSTER_TABLE:
        if m_q <= widest:
            return g
    return CLUSTER_TABLE[-1][1]


def sdca_cluster_slice(m_q: int) -> int:
    """Columns of w one CTA of the cluster route owns."""
    return max(1, -(-m_q // sdca_cluster_size(m_q)))


def sdca_cluster_per_thread(slice_: int) -> int:
    """Columns a thread holds: the fewest the kernel is compiled for that
    cover the slice (the most, for a slice wider than a CTA holds)."""
    for e in CLUSTER_PER_THREAD:
        if slice_ <= CLUSTER_THREADS * e:
            return e
    return CLUSTER_PER_THREAD[-1]


def sdca_cluster_smem(n_p: int, steps: int, per_thread: int) -> int:
    """Dynamic shared memory of one cluster CTA, in the kernel's layout:
    the n_p dual deltas and the epoch's ``steps`` indices (rounded up to
    a multiple of 4), ``CLUSTER_RING`` row slots of ``CLUSTER_THREADS *
    per_thread + 8`` floats (a slice copied from the 16-byte boundary at
    or before its first column), and 4 floats
    (label, mask, alpha0, padding) for each of ``2 * CLUSTER_RING``
    steps."""
    return 4 * (-(-(n_p + steps) // 4) * 4
                + CLUSTER_RING * (CLUSTER_THREADS * per_thread + 8)
                + 2 * CLUSTER_RING * 4)


def sdca_route(n_p: int, m_q: int, steps: int) -> str:
    """The kernel a CUDA call takes, by shape alone: ``"cluster"`` when a
    slice of w fits the registers of a CTA (``CLUSTER_MAX_SLICE``
    columns) and the dual deltas, the order and the ring of rows its
    shared memory; else ``"block"``."""
    sl = sdca_cluster_slice(m_q) if m_q >= 1 else 0
    fits = (n_p >= 1 and 1 <= sl <= CLUSTER_MAX_SLICE
            and sdca_cluster_smem(n_p, steps, sdca_cluster_per_thread(sl))
            <= MAX_DYNAMIC_SMEM)
    return "cluster" if fits else "block"


def sdca_epoch(x, y, mask, alpha0, w0, idx, *, lam, n, Q,
               loss: str = "hinge", beta=None):
    """One local SDCA epoch on every cell of a P x Q grid, in one launch.

    Batched shapes: ``x (P, Q, n_p, m_q)`` float32 contiguous;
    ``y, mask, alpha0 (P, n_p)`` (indexed by the row partition p);
    ``w0 (Q, m_q)`` (indexed by the feature partition q);
    ``idx (P, steps)`` int32 with ``0 <= idx < n_p`` (the caller's
    contract; not checked per launch).  With a tenant axis after the grid
    axes -- T problems of one shape in one launch -- ``x (P, Q, T, n_p,
    m_q)``, ``y, mask, alpha0 (P, T, n_p)``, ``w0 (Q, T, m_q)`` and
    ``idx (P, T, steps)``.  The unbatched shapes of one cell -- ``x
    (n_p, m_q)``, vectors ``(n_p,)``, ``w0 (m_q,)``, ``idx (steps,)`` --
    are accepted too.

    ``lam`` and ``n`` (the regularizer and the global observation count)
    and ``beta`` are numbers, or tensors broadcastable to the cell grid
    ``(P, Q[, T])`` -- a per-tenant ``(T,)`` vector, or one value per
    cell -- which reach the kernel as its per-cell ``cell_params``.
    ``Q`` is the number of feature partitions that scales the conjugate
    term; ``beta`` (None or given) selects the paper's step_mode="beta"
    denominator.  Returns ``(dalpha, w_final)`` of shapes ``(P, Q[, T],
    n_p)`` / ``(P, Q[, T], m_q)`` (or ``(n_p,)`` / ``(m_q,)``).

    A CUDA tensor launches the route's CUDA kernel (:func:`sdca_route`)
    or raises; the plain PyTorch version runs only for tensors that lie on
    the CPU.
    """
    loss_id = check_loss(loss, "the sdca_epoch kernel")
    unbatched = isinstance(x, torch.Tensor) and x.dim() == 2
    if unbatched:
        x, y, mask, alpha0, w0, idx = (
            x[None, None], y[None], mask[None], alpha0[None], w0[None],
            idx[None])
    if not isinstance(x, torch.Tensor) or x.dim() not in (4, 5):
        raise ValueError("x must be (P, Q, n_p, m_q), (P, Q, T, n_p, m_q) "
                         "or (n_p, m_q)")
    P, Qc = x.shape[:2]
    ten = tuple(x.shape[2:-2])                     # (T,) or ()
    n_p, m_q = x.shape[-2:]
    dev, f32 = x.device, torch.float32
    check_tensor("x", x, (P, Qc, *ten, n_p, m_q), f32, dev)
    check_tensor("y", y, (P, *ten, n_p), f32, dev)
    check_tensor("mask", mask, (P, *ten, n_p), f32, dev)
    check_tensor("alpha0", alpha0, (P, *ten, n_p), f32, dev)
    check_tensor("w0", w0, (Qc, *ten, m_q), f32, dev)
    if idx.dim() != 2 + len(ten):
        raise ValueError(f"idx must be (P, {'T, ' if ten else ''}steps), "
                         f"got {tuple(idx.shape)}")
    check_tensor("idx", idx, (P, *ten, idx.shape[-1]), torch.int32, dev)

    if dev.type == "cpu":
        dalpha, w_fin = sdca_epoch_plain(x, y, mask, alpha0, w0, idx,
                                         lam=lam, n=n, Q=Q, loss=loss,
                                         beta=beta)
    elif dev.type == "cuda":
        dalpha, w_fin = _launch(x, y, mask, alpha0, w0, idx, lam=lam, n=n,
                                Q=Q, loss_id=loss_id, beta=beta,
                                route=sdca_route(n_p, m_q, idx.shape[-1]))
    else:
        raise NotImplementedError(f"sdca_epoch has no path for {dev}")
    if unbatched:
        return dalpha[0, 0], w_fin[0, 0]
    return dalpha, w_fin


#: number of CUDA kernel launches made by this wrapper (and nothing else),
#: in all, per route, and per cluster size of the cluster route -- one per
#: call, whatever the number of tenants
sdca_epoch.launches = 0
sdca_epoch.launches_by_route = dict.fromkeys(ROUTES, 0)
sdca_epoch.launches_by_cluster = dict.fromkeys(CLUSTER_SIZES, 0)


def _launch(x, y, mask, alpha0, w0, idx, *, lam, n, Q, loss_id, beta,
            route):
    """Launch one route.  Only ``chip_smoke.py`` calls it directly, with
    ``route="block"`` at a main-path shape, to time the route the cluster
    route replaced."""
    P, Qc = x.shape[:2]
    lead = tuple(x.shape[:-2])                     # (P, Q[, T])
    T = x.shape[2] if x.dim() == 5 else 1
    n_p, m_q = x.shape[-2:]
    steps = idx.shape[-1]
    if route not in ROUTES:
        raise ValueError(f"unknown sdca_epoch route {route!r}")
    if route == "block":
        check_smem(3 * m_q * 4, f"sdca_epoch with m_q={m_q}")
    lib = _build.load_library()
    alloc = torch.zeros if route == "block" else torch.empty
    dalpha = alloc((*lead, n_p), dtype=x.dtype, device=x.device)
    w_fin = torch.empty((*lead, m_q), dtype=x.dtype, device=x.device)
    use_beta = beta is not None
    params = None
    if is_per_cell(lam, n, beta):
        params = cell_params(lead, x.device, lam, n,
                             beta if use_beta else 0.0)
    scalars = (scalar_arg(lam), scalar_arg(n), float(Q),
               scalar_arg(beta if use_beta else 0.0), int(use_beta))
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        ptrs = (x.data_ptr(), y.data_ptr(), mask.data_ptr(),
                alpha0.data_ptr(), w0.data_ptr(), idx.data_ptr(),
                dalpha.data_ptr(), w_fin.data_ptr())
        pp = params.data_ptr() if params is not None else None
        if route == "cluster":
            g = sdca_cluster_size(m_q)
            sl = sdca_cluster_slice(m_q)
            e = sdca_cluster_per_thread(sl)
            code = lib.sdca_epoch_cluster_launch(
                *ptrs, P, Qc, T, n_p, m_q, steps, *scalars, pp,
                loss_id, g, CLUSTER_THREADS, e, sl,
                sdca_cluster_smem(n_p, steps, e), stream)
        else:
            code = lib.sdca_epoch_launch(
                *ptrs, P, Qc, T, n_p, m_q, steps, *scalars, pp,
                loss_id, block_threads(m_q), stream)
    _build.check_launch(lib, code, f"sdca_epoch ({route})")
    sdca_epoch.launches += 1
    sdca_epoch.launches_by_route[route] += 1
    if route == "cluster":
        sdca_epoch.launches_by_cluster[g] += 1
    return dalpha, w_fin

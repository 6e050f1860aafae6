"""Local SDCA epoch on padded-ELL sparse blocks: the public wrapper of
``csrc/sdca_epoch_sparse_ahead.cu`` / ``csrc/sdca_epoch_sparse.cu`` and
its plain PyTorch version.

Two routes, chosen by :func:`sdca_sparse_route` from the block shape
alone: ``"lookahead"`` (``csrc/sdca_epoch_sparse_ahead.cu``) -- a cluster
of ``AHEAD_CLUSTER`` CTAs a cell sharing its columns, in each one warp
stepping the chain while helper warps prepare each row's record, the
order and the dual deltas in shared memory, the ELL rows by bulk copies
into a ring, the gather of w ``AHEAD_DEPTH`` steps ahead of the dual step
with the missed scatters added back through row overlaps -- wherever an
ELL row is a whole number of 16-byte words and the rest fits the shared
memory, which covers the main path's news20 cells;
``"block"`` (``csrc/sdca_epoch_sparse.cu``) -- one block per cell, the
gather on every step's critical path -- for the rest.  Both compute the
same function; they form each step's margin in other orders.

The plain version is the same batched function as the kernel: a Python
loop over the steps, vectorised over the P x Q cells.  The CPU tests run
it, the chip check compares the kernel with it on the card, and
``sdca_epoch_sparse`` takes it only for tensors that lie on the CPU.
"""
from __future__ import annotations

import torch

from .. import _build
from .._launch import (MAX_DYNAMIC_SMEM, cell_index, cell_params,
                       check_loss, check_smem, check_tensor, ell_threads,
                       is_per_cell, per_cell, scalar_arg)

ROUTES = ("lookahead", "block")
#: the lookahead route's geometry, owned here and passed to the launch,
#: which refuses any other than the kernel is compiled for: the lookahead
#: depth D and the cluster size G (CTAs a cell, each owning a share of
#: the columns; both measured fastest at the news20 cells, PERF.md), the
#: (column, value) pairs of a row an owner lane keeps in its list, the ELL
#: rows in flight (each with its record) and the threads of a CTA (a
#: stepper warp, 6 helper warps, a producer warp)
AHEAD_DEPTH = 2
AHEAD_CLUSTER = 4
AHEAD_CAP = 6
AHEAD_RING = 16
AHEAD_THREADS = 32 * (1 + 6 + 1)


def ahead_record_bytes(k: int) -> int:
    """Shared memory of one row record: each of the 32 owner lanes' pair
    count, 8 scalars (overflow count, ||x||^2, label, mask, alpha0, up to
    3 overlaps), each lane's list of ``AHEAD_CAP`` (column, value) pairs,
    and the overflow list (``k`` rounded up to 8 pairs)."""
    return 4 * 32 + 4 * 8 + 8 * 32 * AHEAD_CAP + 8 * (-(-k // 8) * 8)


def ahead_smem(n_p: int, k: int, steps: int) -> int:
    """Dynamic shared memory of one lookahead CTA, in the kernel's layout:
    the ``steps`` indices and the ``n_p`` dual deltas (each rounded up to
    a multiple of 4), then ``AHEAD_RING`` row slots of ``8 k + 48`` bytes
    (k column ids, k values, three 16-byte chunks holding the row's label,
    mask and alpha0) and as many row records."""
    return (4 * (-(-steps // 4) * 4 + -(-n_p // 4) * 4)
            + AHEAD_RING * (8 * k + 48 + ahead_record_bytes(k)))


def sdca_sparse_route(n_p: int, k: int, steps: int) -> str:
    """The kernel a CUDA call takes, by shape alone: ``"lookahead"`` when
    an ELL row is a whole number of 16-byte words (``k`` a positive
    multiple of 4: one bulk copy a row) and the order, the dual deltas,
    the ring of rows and their records fit a CTA's shared memory; else
    ``"block"``."""
    fits = (n_p >= 1 and steps >= 0 and k >= 4 and k % 4 == 0
            and ahead_smem(n_p, k, steps) <= MAX_DYNAMIC_SMEM)
    return "lookahead" if fits else "block"


def check_bulk_alignment(cols, vals):
    """The lookahead route copies each ELL row by one bulk copy, which
    needs 16-byte aligned rows: raise for a contiguous view that starts
    off a 16-byte boundary (fresh tensors start on one)."""
    for name, t in (("cols", cols), ("vals", vals)):
        if t.data_ptr() % 16:
            raise ValueError(
                f"{name} starts at a 16-byte misaligned address "
                f"({t.data_ptr()}); the lookahead route of "
                "sdca_epoch_sparse copies its rows in bulk -- pass a "
                "fresh contiguous tensor")


def sdca_epoch_sparse(cols, vals, y, mask, alpha0, w0, idx, *, lam, n, Q,
                      loss: str = "hinge", beta=None):
    """One local SDCA epoch on every padded-ELL cell of a P x Q grid, in
    one launch.

    Batched shapes: ``cols (P, Q, n_p, k)`` int32 and ``vals (P, Q, n_p,
    k)`` float32, contiguous -- block-local column ids and values, padding
    slots (col 0, val 0); ``y, mask, alpha0 (P, n_p)``; ``w0 (Q, m_q)``;
    ``idx (P, steps)`` int32.  With a tenant axis after the grid axes:
    ``cols, vals (P, Q, T, n_p, k)``, ``y, mask, alpha0 (P, T, n_p)``,
    ``w0 (Q, T, m_q)``, ``idx (P, T, steps)``.  The caller's contract,
    not checked per launch: ``0 <= idx < n_p`` and ``0 <= cols < m_q``.
    The unbatched shapes of one cell -- ``cols, vals (n_p, k)``, vectors
    ``(n_p,)``, ``w0 (m_q,)``, ``idx (steps,)`` -- are accepted too.

    ``lam``, ``n`` and ``beta`` are numbers, or tensors broadcastable to
    the cell grid ``(P, Q[, T])`` (per tenant or per cell), which reach
    the kernel as its per-cell ``cell_params``.  ``Q`` is the number of
    feature partitions that scales the conjugate term; ``beta`` (None or
    given) selects the paper's step_mode="beta" denominator.  Returns
    ``(dalpha, w_final)`` of shapes ``(P, Q[, T], n_p)`` / ``(P, Q[, T],
    m_q)`` (or ``(n_p,)`` / ``(m_q,)``).

    A CUDA tensor launches the route's CUDA kernel
    (:func:`sdca_sparse_route`) or raises; the plain PyTorch version runs
    only for tensors that lie on the CPU.
    """
    loss_id = check_loss(loss, "the sdca_epoch_sparse kernel")
    unbatched = isinstance(cols, torch.Tensor) and cols.dim() == 2
    if unbatched:
        cols, vals, y, mask, alpha0, w0, idx = (
            cols[None, None], vals[None, None], y[None], mask[None],
            alpha0[None], w0[None], idx[None])
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
    check_tensor("alpha0", alpha0, (P, *ten, n_p), f32, dev)
    if w0.dim() != 2 + len(ten):
        raise ValueError(f"w0 must be (Q, {'T, ' if ten else ''}m_q), got "
                         f"{tuple(w0.shape)}")
    check_tensor("w0", w0, (Qc, *ten, w0.shape[-1]), f32, dev)
    if idx.dim() != 2 + len(ten):
        raise ValueError(f"idx must be (P, {'T, ' if ten else ''}steps), "
                         f"got {tuple(idx.shape)}")
    check_tensor("idx", idx, (P, *ten, idx.shape[-1]), torch.int32, dev)

    if dev.type == "cpu":
        dalpha, w_fin = sdca_epoch_sparse_plain(
            cols, vals, y, mask, alpha0, w0, idx, lam=lam, n=n, Q=Q,
            loss=loss, beta=beta)
    elif dev.type == "cuda":
        dalpha, w_fin = _launch(
            cols, vals, y, mask, alpha0, w0, idx, lam=lam, n=n, Q=Q,
            loss_id=loss_id, beta=beta,
            route=sdca_sparse_route(n_p, k, idx.shape[-1]))
    else:
        raise NotImplementedError(f"sdca_epoch_sparse has no path for {dev}")
    if unbatched:
        return dalpha[0, 0], w_fin[0, 0]
    return dalpha, w_fin


#: number of CUDA kernel launches made by this wrapper (and nothing else),
#: in all and per route -- one per call, whatever the number of tenants
sdca_epoch_sparse.launches = 0
sdca_epoch_sparse.launches_by_route = dict.fromkeys(ROUTES, 0)


def _launch(cols, vals, y, mask, alpha0, w0, idx, *, lam, n, Q, loss_id,
            beta, route):
    """Launch one route.  The wrapper passes :func:`sdca_sparse_route`'s
    choice; only ``chip_smoke.py`` calls it directly, with
    ``route="block"`` at a main-path shape, to time the route the
    lookahead route replaced."""
    if route not in ROUTES:
        raise ValueError(f"unknown sdca_epoch_sparse route {route!r}")
    P, Qc = cols.shape[:2]
    lead = tuple(cols.shape[:-2])                  # (P, Q[, T])
    T = cols.shape[2] if cols.dim() == 5 else 1
    n_p, k = cols.shape[-2:]
    m_q = w0.shape[-1]
    steps = idx.shape[-1]
    if route == "block":
        # only the two ELL row buffers live in shared memory; w stays in
        # device memory (the w_final output), whatever m_q
        check_smem(2 * k * 8, f"sdca_epoch_sparse with k={k}")
    else:
        check_bulk_alignment(cols, vals)
    lib = _build.load_library()
    alloc = torch.zeros if route == "block" else torch.empty
    dalpha = alloc((*lead, n_p), dtype=vals.dtype, device=vals.device)
    w_fin = torch.empty((*lead, m_q), dtype=vals.dtype, device=vals.device)
    use_beta = beta is not None
    params = (cell_params(lead, vals.device, lam, n,
                          beta if use_beta else 0.0)
              if is_per_cell(lam, n, beta) else None)
    with torch.cuda.device(vals.device):
        stream = torch.cuda.current_stream().cuda_stream
        args = (cols.data_ptr(), vals.data_ptr(), y.data_ptr(),
                mask.data_ptr(), alpha0.data_ptr(), w0.data_ptr(),
                idx.data_ptr(), dalpha.data_ptr(), w_fin.data_ptr(), P, Qc,
                T, n_p, k, m_q, steps, scalar_arg(lam), scalar_arg(n),
                float(Q), scalar_arg(beta if use_beta else 0.0),
                int(use_beta),
                params.data_ptr() if params is not None else None, loss_id)
        if route == "lookahead":
            code = lib.sdca_epoch_sparse_ahead_launch(
                *args, AHEAD_DEPTH, AHEAD_CLUSTER, AHEAD_THREADS,
                ahead_smem(n_p, k, steps), stream)
        else:
            code = lib.sdca_epoch_sparse_launch(*args, ell_threads(k),
                                                stream)
    _build.check_launch(lib, code, f"sdca_epoch_sparse ({route})")
    sdca_epoch_sparse.launches += 1
    sdca_epoch_sparse.launches_by_route[route] += 1
    return dalpha, w_fin


def sdca_epoch_sparse_plain(cols, vals, y, mask, alpha0, w0, idx, *, lam, n,
                            Q, loss: str = "hinge", beta=None):
    """cols, vals: (P, Q, n_p, k); y, mask, alpha0: (P, n_p); w0: (Q, m_q);
    idx: (P, steps) int32 coordinate order, shared by the cells of a row
    partition.  With a tenant axis: cols, vals (P, Q, T, n_p, k); y,
    mask, alpha0 (P, T, n_p); w0 (Q, T, m_q); idx (P, T, steps).

    Per step: z = sum(vals * w[cols]) (gather), the closed-form dual
    step, w[cols] += d / (lam n) * vals (scatter-add, so the duplicate
    col-0 padding slots add zero), dalpha[i] += d.  ``lam``, ``n`` and
    ``beta`` are numbers or tensors broadcastable to the cell grid, formed
    in float32 per cell as the kernel forms them; ``beta`` replaces the
    ||x_i||^2 denominator when given.  Returns (dalpha (P, Q[, T], n_p),
    w_final (P, Q[, T], m_q)) in float32.
    """
    if loss not in ("hinge", "squared"):
        raise ValueError(loss)
    tenant = cols.dim() == 5
    P, Qc = cols.shape[:2]
    T = cols.shape[2] if tenant else 1
    n_p, k = cols.shape[-2:]
    m_q = w0.shape[-1]
    lead = (P, Qc, T) if tenant else (P, Qc)
    dev = vals.device
    cell, row, col = cell_index(P, Qc, T, dev)
    cf, vf = cols.reshape(-1, n_p, k), vals.reshape(-1, n_p, k)
    yf, mf, af = (v.reshape(P * T, n_p)[row] for v in (y, mask, alpha0))
    idxf = idx.reshape(P * T, -1)[row].long()
    w = w0.reshape(Qc * T, m_q)[col]
    lam_c, n_c = per_cell(lam, lead, dev), per_cell(n, lead, dev)
    lam_n = lam_c * n_c
    beta_c = None if beta is None else per_cell(beta, lead, dev)
    dalpha = torch.zeros((cell.numel(), n_p), dtype=vals.dtype, device=dev)
    for h in range(idxf.shape[1]):
        i = idxf[:, h]                             # (C,)
        ci = cf[cell, i].long()                    # (C, k)
        vi = vf[cell, i]
        yi, mi = yf[cell, i], mf[cell, i]
        zloc = (vi * torch.gather(w, 1, ci)).sum(-1)
        a_i = af[cell, i] + dalpha[cell, i]
        denom = (vi * vi).sum(-1) if beta_c is None else beta_c
        denom = torch.clamp(denom, min=1e-12)
        if loss == "hinge":
            d = (yi / Q - zloc) * lam_c * n_c / denom
            pos = yi > 0
            lo = torch.where(pos, 0.0, -1.0)
            hi = torch.where(pos, 1.0, 0.0)
            d = torch.minimum(torch.maximum(a_i + d, lo), hi) - a_i
        else:
            num = yi / Q - a_i / (2.0 * Q) - zloc
            den = 1.0 / (2.0 * Q) + denom / lam_n
            d = num / torch.clamp(den, min=1e-12)
        d = d * mi                                 # padded rows never move
        w.scatter_add_(1, ci, (d / lam_n).unsqueeze(-1) * vi)
        dalpha[cell, i] += d
    return dalpha.reshape(*lead, n_p), w.reshape(*lead, m_q)

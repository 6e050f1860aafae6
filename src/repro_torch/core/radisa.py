"""RADiSA -- RAndom Distributed Stochastic Algorithm (Algorithm 3).

Primal SGD x CD hybrid with SVRG variance reduction in the doubly
distributed setting.  The cell-local inner loop is ``local.local_svrg``
(the CUDA SVRG kernel or the plain loop, selected by ``local_backend``),
or ``local.local_svrg_sparse`` on padded-ELL cells, where the anchor pass
becomes ``partition.ell_gather`` / ``ell_scatter_add``.
The algorithm is ONE :class:`~repro_torch.core.engines.CellProgram` whose
CommSchedule names the paper's communication pattern (per outer
iteration)::

    CommSchedule().psum("z", axis="model")     # 1. anchor pass: row inner
                                               #    products need every
                                               #    feature block
                  .psum("grad", axis="data")   # 2. full gradient: column
                                               #    blocks need every
                                               #    observation partition
                  # 3. L local SVRG steps -- NO communication
                  .psum("dw", axis="data")     # 4. concatenate disjoint
                                               #    sub-block deltas
                  # (variant="avg" declares pmean("w_avg") instead of "dw")

``variant="avg"`` implements RADiSA-avg: sub-blocks fully overlap (every
cell updates the whole local feature block) and solutions are averaged.

RADiSA pre-splits each feature block into P sub-blocks, so P must divide
m_q.  The program constructors fail loudly instead of silently truncating feature
columns; the unified ``Solver`` API pads the feature dimension to a
multiple of P*Q up front, so the constraint never binds there.
``radisa_simulated`` repartitions with inert zero-column padding when
handed a non-dividing grid directly.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .comm import CommSchedule
from .engines import (CELL, COL, ROW, CellProgram, EngineProgram,
                      bind_mesh_program, cached_build, drive_with_callback,
                      grid_bind_state, grid_program)
from .indices import GeneratorIndexSource
from .local import local_svrg, local_svrg_sparse
from .losses import Loss, get_loss
from .partition import (DoublyPartitioned, SparseDoublyPartitioned,
                        blocks_times_cols, ell_gather, ell_scatter_add,
                        partition, rows_times_blocks)


@dataclasses.dataclass(frozen=True)
class RADiSAConfig:
    lam: float = 1e-3
    L: Optional[int] = None          # batch size (inner steps); default n_p
    gamma: float = 1.0               # step size constant
    outer_iters: int = 20
    variant: str = "block"           # "block" | "avg"
    seed: int = 0

    def eta(self, t) -> float:
        # paper: eta_t = gamma / (1 + sqrt(t - 1)), in float32 like every
        # other runtime scalar of the step
        root = np.sqrt(np.maximum(np.float32(t) - np.float32(1.0),
                                  np.float32(0.0)))
        return float(np.float32(self.gamma) / (np.float32(1.0) + root))


def radisa_schedule(variant: str = "block") -> CommSchedule:
    """RADiSA's reduction points; the recombine op depends on the
    variant (disjoint sub-block deltas vs full-block average)."""
    sched = (CommSchedule()
             .psum("z", axis="model")
             .psum("grad", axis="data"))
    if variant == "avg":
        return sched.pmean("w_avg", axis="data")
    return sched.psum("dw", axis="data")


def _check_subblocks(m_q: int, Pn: int, avg: bool):
    if not avg and m_q % Pn:
        raise ValueError(
            f"RADiSA pre-splits each feature block into P={Pn} sub-blocks, "
            f"but P does not divide m_q={m_q}; truncating would silently "
            f"drop the trailing {m_q % Pn} feature columns of every block. "
            "Pad the feature dimension to a multiple of P*Q first -- the "
            "unified Solver API does this via "
            "partition(..., m_multiple=P*Q) -- or use variant='avg'.")


# ----------------------------------------------------------------------------
# the anchor pass and the sub-block windows, shared with SFK (core/sfk.py)
# ----------------------------------------------------------------------------

def blocks_times_w(x_parts, w, sparse: bool):
    """Every cell's x_[p,q] w_q -> ``(P, Q, n_p)``: a batched matvec over
    dense blocks ``(x,)`` or a gather over ELL cells ``(cols, vals)``."""
    return ell_gather(w, *x_parts) if sparse else blocks_times_cols(*x_parts, w)


def rows_times_x(v, x_parts, m_q: int, sparse: bool):
    """Every cell's v_p^T x_[p,q] -> ``(P, Q, m_q)`` for ``v (P, n_p)``: a
    batched matvec over dense blocks or a scatter-add over ELL cells
    (with a tenant axis ``v (P, T, n_p)`` -> ``(P, Q, T, m_q)``)."""
    if sparse:
        return ell_scatter_add(m_q, *x_parts, v.unsqueeze(1))
    return rows_times_blocks(v, *x_parts)


def _cells_of_rows(a, Qn: int):
    """A row-partition array ``(P, [T,] k)`` seen by every cell:
    ``(P, Q, [T,] k)``, expanded (no copy)."""
    return a.unsqueeze(1).expand(a.shape[0], Qn, *a.shape[1:])


def cut_windows(w, mu, perm, m_sub: int):
    """Sub-block ``perm[p]`` of every feature block for row partition p:
    returns ``lo (P,) int32``, the window columns ``win (P, m_sub)`` and
    each cell's window of ``w`` and ``mu`` ``(P, Q, m_sub)``.  With a
    tenant axis: ``w, mu (Q, T, m_q)``, ``perm (P, T)`` -> ``lo (P, T)``,
    ``win (P, T, m_sub)`` and windows ``(P, Q, T, m_sub)``."""
    lo = (perm * m_sub).to(torch.int32)
    win = lo.long()[..., None] + torch.arange(m_sub, device=w.device)
    ix = _cells_of_rows(win, w.shape[0])
    Pn = perm.shape[0]

    def cut(v):
        return torch.gather(v.unsqueeze(0).expand(Pn, *v.shape), -1, ix)
    return lo, win, cut(w), cut(mu)


def paste_windows(win, delta_sub, m_q: int):
    """Each cell's window change ``(P, Q[, T], m_sub)`` placed at its
    columns ``win (P[, T], m_sub)`` of a zero ``(P, Q[, T], m_q)``."""
    delta = torch.zeros((*delta_sub.shape[:-1], m_q), dtype=delta_sub.dtype,
                        device=delta_sub.device)
    return delta.scatter_(-1, _cells_of_rows(win, delta_sub.shape[1]),
                          delta_sub)


def primal_payload_shapes(schedule: CommSchedule, per_problem: bool = False):
    """The per-cell payload shapes of a primal (RADiSA / SFK) step: the
    anchor products ``z`` have a row block's shape, every other
    collective (the gradient, the recombined deltas or solutions) a
    feature block's.  Blocked data ``(*x_parts, y (P, [T,] n_p), mask)``
    (``per_problem``: followed by ``lam (T,)`` and ``n (T,)``), state ``w
    (Q, [T,] m_q)``."""
    y_at = -4 if per_problem else -2

    def payload_shapes(data, w):
        rows, cols = tuple(data[y_at].shape[1:]), tuple(w.shape[1:])
        return {name: rows if name == "z" else cols
                for name in schedule.names}
    return payload_shapes


def radisa_cell_program(loss: Loss, cfg: RADiSAConfig, *, n: int, m_q: int,
                        index_source, local_backend: str = "kernel",
                        sparse: bool = False,
                        per_problem: bool = False) -> CellProgram:
    """The ONE RADiSA program.

    Blocked data: ``(x (P, Q, n_p, m_q), y (P, n_p), mask (P, n_p))``, or
    with ``sparse=True`` ``(cols, vals (P, Q, n_p, k), y, mask)``;
    blocked state: ``w (Q, m_q)``.  ``index_source`` supplies the shared
    sub-block permutation (``radisa_perm(t) -> (P,)``) and the minibatch
    order of every cell (``svrg_rows(t) -> (P, Q, L)``).  The sub-block
    window of a cell is read in place by the local solver (a dense
    block's columns, or the in-window entries of an ELL row); no column
    slice of the block is materialised.

    ``per_problem=True`` is the fleet path: every array carries a tenant
    axis T after its grid axes (``w (Q, T, m_q)``, orders ``(P, Q, T,
    L)``, permutations ``(P, T)``), and the data tuple ends with
    per-tenant ``lam (T,)`` and ``n (T,)`` float32 tensors: ``mu = grad /
    n_t + lam_t * w`` and the local loop's ``lam_t`` are per tenant."""
    lam = cfg.lam
    avg = cfg.variant == "avg"
    local = local_svrg_sparse if sparse else local_svrg

    def cell(comm, t, data, state):
        if per_problem:
            *data, lam_t, n_t = data
            lam_b, n_b = lam_t[:, None], n_t[:, None]   # against (Q, T, m_q)
        else:
            lam_t = lam_b = lam
            n_b = n
        *x_parts, y, mask = data
        w = state
        Pn = comm.axis_size("data")
        Qn = comm.axis_size("model")
        m_sub = m_q if avg else m_q // Pn
        eta = cfg.eta(t)
        # (1) anchor inner products, reduced across feature blocks
        z = comm("z", blocks_times_w(x_parts, w, sparse))    # (P, n_p)
        # (2) full gradient of F at the anchor, reduced across rows
        gz = loss.grad(z, y) * mask
        mu = (comm("grad", rows_times_x(gz, x_parts, m_q, sparse)) / n_b
              + lam_b * w)                                   # (Q, m_q)
        # (3) sub-block assignment (shared permutation) + local SVRG
        idx = index_source.svrg_rows(t)                      # (P, Q, L)
        if avg:
            # one anchor per row partition HELD (P on the grid engine, the
            # rank's one on a process grid); Pn stays the global P
            held = y.shape[0]
            lo = None
            w_anchor = w.unsqueeze(0).expand(held, *w.shape).contiguous()
            mu_sub = mu.unsqueeze(0).expand(held, *mu.shape).contiguous()
        else:
            lo, win, w_anchor, mu_sub = cut_windows(
                w, mu, index_source.radisa_perm(t), m_sub)
        w_new = local(loss, *x_parts, y, mask, z, w_anchor, mu_sub,
                      lam=lam_t, eta=eta, idx=idx, lo=lo,
                      backend=local_backend)
        # (4) recombine
        if avg:
            # RADiSA-avg: average the P overlapping solutions per block
            return comm("w_avg", w_new)
        return w + comm("dw", paste_windows(win, w_new - w_anchor, m_q))

    return CellProgram(radisa_schedule(cfg.variant), cell,
                       state_specs=("model",),
                       payload_shapes=primal_payload_shapes(
                           radisa_schedule(cfg.variant), per_problem))


# ----------------------------------------------------------------------------
# single-device grid engine
# ----------------------------------------------------------------------------

def radisa_simulated_program(loss: Loss, data, cfg: RADiSAConfig, *,
                             local_backend: str = "kernel", w0=None,
                             index_source=None, compression=None,
                             topology=None, cache=None) -> EngineProgram:
    """Grid engine.  State: w_blocks (Q, m_q), or ``(w_blocks, ef)``
    under ``compression`` / ``topology`` (see
    :func:`~repro_torch.core.engines.grid_program`).

    ``data`` may be a dense :class:`DoublyPartitioned` or a sparse
    :class:`SparseDoublyPartitioned` (padded-ELL cells).  Requires
    P | m_q (pre-pad with ``partition(..., m_multiple=P*Q)``).
    ``index_source=None`` draws the permutations and minibatch orders
    from a ``torch.Generator`` seeded from ``cfg.seed`` on the data's
    device."""
    sparse = isinstance(data, SparseDoublyPartitioned)
    Pn, Qn = data.P, data.Q
    dev = data.device
    _check_subblocks(data.m_q, Pn, cfg.variant == "avg")
    if index_source is None:
        index_source = GeneratorIndexSource(
            cfg.seed, P=Pn, Q=Qn, n_p=data.n_p, L=cfg.L or data.n_p,
            device=dev)
    cellprog = radisa_cell_program(loss, cfg, n=data.n, m_q=data.m_q,
                                   index_source=index_source,
                                   local_backend=local_backend,
                                   sparse=sparse)
    x_parts = (data.cols, data.vals) if sparse else (data.x_blocks,)
    gdata = (*x_parts, data.y_blocks, data.mask)
    step = cached_build(cache, "step",
                        lambda: grid_program(cellprog, Pn, Qn,
                                             compression=compression,
                                             topology=topology, device=dev))
    w_init = (torch.zeros((Qn, data.m_q), device=dev) if w0 is None
              else data.w_to_blocks(w0))
    return bind_primal_program(cellprog, step, data, gdata, w_init,
                               compression=compression, topology=topology,
                               cache=cache)


def bind_primal_program(cellprog, step, data, gdata, w_init, *,
                        compression, topology, cache=None) -> EngineProgram:
    """The EngineProgram of a primal solver whose state is ``w_blocks``
    (RADiSA, SFK), with its comm state, wire accounting and
    collective-free timing twin (``local_step``, memoized in ``cache``
    under ``"local"``) bound."""
    full0, unwrap, acct = grid_bind_state(
        cellprog, gdata, w_init, Pn=data.P, Qn=data.Q,
        compression=compression, topology=topology, device=data.device)
    local = cached_build(cache, "local",
                         lambda: grid_program(cellprog, data.P, data.Q,
                                              comm_local=True,
                                              device=data.device))
    return EngineProgram(
        state=full0,
        step=lambda t, s: step(t, gdata, s),
        w_of=lambda s: data.w_from_blocks(unwrap(s)),
        comm_bytes=acct,
        ef_of=(lambda s: s[1]) if full0 is not w_init else None,
        local_step=lambda t, s: local(t, gdata, unwrap(s)))


def primal_shard_map_program(make_cell: str, cell_kw: dict, data, grid, *,
                             w0, index_source, staleness: int = 0,
                             compression=None, overlap: bool = False,
                             topology=None) -> EngineProgram:
    """The mesh program of a primal solver whose state is ``w_blocks``
    (RADiSA, SFK) on process grid ``grid``: rank (p, q) holds block (p,
    q) of ``data`` (the grid engine's blocked view, on the host)."""
    sparse = isinstance(data, SparseDoublyPartitioned)
    x_parts = (data.cols, data.vals) if sparse else (data.x_blocks,)
    w_init = (torch.zeros((data.Q, data.m_q)) if w0 is None
              else data.w_to_blocks(w0))
    return bind_mesh_program(
        grid, make_cell=make_cell,
        cell_kw=dict(cell_kw, n=data.n, m_q=data.m_q, sparse=sparse),
        index_source=index_source,
        data=(*x_parts, data.y_blocks, data.mask),
        data_specs=(CELL,) * len(x_parts) + (ROW, ROW),
        state0=w_init, state_specs=COL,
        w_of=data.w_from_blocks, staleness=staleness,
        compression=compression, overlap=overlap, topology=topology)


def radisa_shard_map_program(loss: Loss, data, cfg: RADiSAConfig, grid, *,
                             local_backend: str = "kernel", w0=None,
                             index_source=None, staleness: int = 0,
                             compression=None, overlap: bool = False,
                             topology=None) -> EngineProgram:
    """Mesh engines: the RADiSA program (either variant) on process grid
    ``grid``, one block per rank; the knobs as in
    :func:`repro_torch.core.d3ca.d3ca_shard_map_program`.  Requires P |
    m_q unless ``variant="avg"``."""
    _check_subblocks(data.m_q, data.P, cfg.variant == "avg")
    if index_source is None:
        index_source = GeneratorIndexSource(
            cfg.seed, P=data.P, Q=data.Q, n_p=data.n_p,
            L=cfg.L or data.n_p, device=data.device)
    return primal_shard_map_program(
        "repro_torch.core.radisa:radisa_cell_program",
        dict(loss=loss, cfg=cfg, local_backend=local_backend), data, grid,
        w0=w0, index_source=index_source, staleness=staleness,
        compression=compression, overlap=overlap, topology=topology)


def radisa_simulated(loss_name: str, data, cfg: RADiSAConfig, callback=None,
                     local_backend: str = "kernel", index_source=None):
    loss = get_loss(loss_name)
    Pn, Qn = data.P, data.Q
    if (data.m_q % Pn and cfg.variant != "avg"
            and isinstance(data, DoublyPartitioned)):
        # RADiSA pre-splits each feature block into P sub-blocks; repartition
        # with extra (inert, all-zero) column padding so that P | m_q.
        # (Sparse cells are not re-cut here: the program raises instead.)
        X, y = data.dense()
        padded = partition(X, y, Pn, Qn, m_multiple=Pn * Qn,
                           device=data.device)
        return radisa_simulated(loss_name, padded, cfg, callback=callback,
                                local_backend=local_backend,
                                index_source=index_source)

    prog = radisa_simulated_program(loss, data, cfg,
                                    local_backend=local_backend,
                                    index_source=index_source)
    state = drive_with_callback(prog, cfg.outer_iters, callback)
    return prog.w_of(state)

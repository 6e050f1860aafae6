"""D3CA -- Doubly Distributed Dual Coordinate Ascent (Algorithm 1).

The cell-local solver is ``local.local_sdca`` (the CUDA SDCA kernel or
the plain loop, selected by ``local_backend``).  The algorithm
contributes ONE :class:`~repro_torch.core.engines.CellProgram` -- the
step math plus a CommSchedule declaring its two reductions::

    CommSchedule().pmean("dalpha", axis="model")   # step 6 dual average
                  .psum("w_contrib", axis="data")  # step 9 primal-dual map

``d3ca_simulated_program`` binds it to the single-device grid engine, on
dense blocks or on padded-ELL sparse cells (``local.local_sdca_sparse``,
and step 9's primal-dual map as ``partition.ell_scatter_add``);
``d3ca_shard_map_program`` binds it to a process grid, one block per rank
(the mesh engines); ``d3ca_simulated`` is a thin convenience wrapper.
The outer loop lives once in ``engines.drive`` / ``solver.Solver.solve``.
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
from .local import local_sdca, local_sdca_sparse
from .losses import Loss, get_loss
from .partition import (SparseDoublyPartitioned, ell_scatter_add,
                        rows_times_blocks)


@dataclasses.dataclass(frozen=True)
class D3CAConfig:
    lam: float = 1e-2
    local_steps: Optional[int] = None   # H; default = one local epoch (n_p)
    step_mode: str = "exact"            # "exact" | "beta" (paper's lam/t)
    outer_iters: int = 20
    seed: int = 0


def d3ca_schedule() -> CommSchedule:
    """D3CA's two reduction points, as named in the paper."""
    return (CommSchedule()
            .pmean("dalpha", axis="model")
            .psum("w_contrib", axis="data"))


def d3ca_cell_program(loss: Loss, cfg: D3CAConfig, *, n: int,
                      index_source, local_backend: str = "kernel",
                      sparse: bool = False, m_q: Optional[int] = None,
                      gated: bool = False,
                      per_problem: bool = False) -> CellProgram:
    """The ONE D3CA program.

    Blocked data: ``(x (P, Q, n_p, m_q), y (P, n_p), mask (P, n_p))``, or
    with ``sparse=True`` ``(cols, vals (P, Q, n_p, k), y, mask)``.
    Blocked state: ``(alpha (P, n_p), w (Q, m_q))``.  ``index_source``
    supplies the coordinate order of every outer iteration
    (``sdca_rows(t) -> (P, steps)``, one order per row partition).

    ``gated=True`` appends a per-row activity gate ``gate (P, n_p)`` to
    the data tuple: the local SDCA epoch masks its coordinate updates by
    ``mask * gate``, so rows gated off never move their dual, while the
    step-9 primal-dual map still sums EVERY row's alpha (the model stays
    exact for the whole dataset).  A gate of all ones is bit-identical to
    the ungated program.  This is the incremental online-update path:
    warm-started passes that move only the rows of new observations.

    ``per_problem=True`` is the fleet path: every array carries a tenant
    axis T right after its grid axes (``x (P, Q, T, n_p, m_q)``, ``alpha
    (P, T, n_p)``, ``w (Q, T, m_q)``, orders ``(P, T, steps)``), and the
    data tuple ends with per-tenant ``lam (T,)`` and ``n (T,)`` float32
    tensors that replace ``cfg.lam`` and ``n``: ``beta = lam_t / t`` and
    step 9's ``lam_t * n_t`` are per tenant, and the local epoch gets
    them as per-tenant scalars (the kernels' ``cell_params``).
    """
    lam = cfg.lam
    if sparse and m_q is None:
        raise ValueError("sparse D3CA cells need m_q for the scatter-add")

    def cell(comm, t, data, state):
        if per_problem:
            *data, lam_t, n_t = data
            beta = lam_t / t                   # float32, per tenant
            lam_n = (lam_t * n_t)[:, None]     # against w (Q, T, m_q)
        else:
            lam_t, n_t = lam, n
            # float32 like every other runtime scalar of the step
            beta = float(np.float32(lam) / np.float32(t))
            lam_n = lam * n
        if gated:
            *data, gate = data
        *x_parts, y, mask = data
        step_mask = mask * gate if gated else mask
        a, w = state
        Pn = comm.axis_size("data")
        Qn = comm.axis_size("model")
        idx = index_source.sdca_rows(t)        # coordinate order per p
        local = local_sdca_sparse if sparse else local_sdca
        dalpha = local(loss, *x_parts, y, step_mask, a, w, lam=lam_t, n=n_t,
                       Q=Qn, idx=idx, step_mode=cfg.step_mode, beta=beta,
                       backend=local_backend)
        # step 6: alpha_[p,.] += (1/P) mean_q dalpha[p, q]
        a_new = a + comm("dalpha", dalpha) / Pn
        # step 9: w_[., q] = (1/(lam n)) sum_p alpha_[p,q]^T x_[p,q]
        am = a_new * mask
        contrib = (ell_scatter_add(m_q, *x_parts, am.unsqueeze(1)) if sparse
                   else rows_times_blocks(am, *x_parts))
        w_new = comm("w_contrib", contrib) / lam_n
        return a_new, w_new

    def payload_shapes(data, state):
        a, w = state                     # (P, [T,] n_p), (Q, [T,] m_q)
        return {"dalpha": tuple(a.shape[1:]), "w_contrib": tuple(w.shape[1:])}

    return CellProgram(d3ca_schedule(), cell,
                       state_specs=(("data",), ("model",)),
                       payload_shapes=payload_shapes)


# ----------------------------------------------------------------------------
# single-device grid engine
# ----------------------------------------------------------------------------

def d3ca_simulated_program(loss: Loss, data, cfg: D3CAConfig, *,
                           local_backend: str = "kernel",
                           w0=None, alpha0=None, index_source=None,
                           compression=None, topology=None,
                           row_gate=None, cache=None) -> EngineProgram:
    """Grid engine.  State: (alpha (P, n_p), w_blocks (Q, m_q)), or
    ``(that, ef)`` under ``compression`` / ``topology`` (see
    :func:`~repro_torch.core.engines.grid_program`).

    ``data`` may be a dense :class:`DoublyPartitioned` or a sparse
    :class:`SparseDoublyPartitioned` (padded-ELL cells).
    ``compression`` (a CompressionPolicy or spec) routes both collectives
    through their codecs; ``topology`` (``"pods=G[:codec]"``) reduces
    ``w_contrib`` over pods.
    ``index_source=None`` draws the coordinate orders from a
    ``torch.Generator`` seeded from ``cfg.seed`` on the data's device.
    ``row_gate`` ((n,) of 0/1) builds the gated incremental program: dual
    updates are restricted to gated-on rows (see
    :func:`d3ca_cell_program`)."""
    sparse = isinstance(data, SparseDoublyPartitioned)
    Pn, Qn = data.P, data.Q
    dev = data.device
    if index_source is None:
        index_source = GeneratorIndexSource(
            cfg.seed, P=Pn, Q=Qn, n_p=data.n_p,
            steps=cfg.local_steps or data.n_p, device=dev)
    cellprog = d3ca_cell_program(loss, cfg, n=data.n,
                                 index_source=index_source,
                                 local_backend=local_backend,
                                 sparse=sparse, m_q=data.m_q,
                                 gated=row_gate is not None)
    x_parts = (data.cols, data.vals) if sparse else (data.x_blocks,)
    gate_parts = (() if row_gate is None
                  else (data.alpha_to_blocks(row_gate),))
    gdata = (*x_parts, data.y_blocks, data.mask, *gate_parts)
    step = cached_build(cache, "step",
                        lambda: grid_program(cellprog, Pn, Qn,
                                             compression=compression,
                                             topology=topology, device=dev))
    local = cached_build(cache, "local",
                         lambda: grid_program(cellprog, Pn, Qn,
                                              comm_local=True, device=dev))

    alpha_init = (torch.zeros((Pn, data.n_p), device=dev) if alpha0 is None
                  else data.alpha_to_blocks(alpha0))
    w_init = (torch.zeros((Qn, data.m_q), device=dev) if w0 is None
              else data.w_to_blocks(w0))
    state0 = (alpha_init, w_init)
    full0, unwrap, acct = grid_bind_state(
        cellprog, gdata, state0, Pn=Pn, Qn=Qn, compression=compression,
        topology=topology, device=dev)
    return EngineProgram(
        state=full0,
        step=lambda t, s: step(t, gdata, s),
        w_of=lambda s: data.w_from_blocks(unwrap(s)[1]),
        alpha_of=lambda s: data.alpha_from_blocks(unwrap(s)[0] * data.mask),
        comm_bytes=acct,
        ef_of=(lambda s: s[1]) if full0 is not state0 else None,
        local_step=lambda t, s: local(t, gdata, unwrap(s)))


# ----------------------------------------------------------------------------
# mesh engines: one block per rank of a process grid
# ----------------------------------------------------------------------------

def d3ca_shard_map_program(loss: Loss, data, cfg: D3CAConfig, grid, *,
                           local_backend: str = "kernel", w0=None,
                           alpha0=None, index_source=None,
                           staleness: int = 0, compression=None,
                           overlap: bool = False, topology=None,
                           row_gate=None) -> EngineProgram:
    """Mesh engines: the D3CA program on process grid ``grid``
    (``repro_torch.launch.mesh``), rank (p, q) holding block (p, q) of
    ``data`` -- the grid engine's blocked view of the problem on the host,
    dense or sparse.  ``staleness=tau > 0`` delays every reduction by tau
    steps (``overlap=True``: dispatched asynchronously and awaited when
    consumed); ``compression`` / ``topology`` / ``row_gate`` as on the
    grid engine.  ``index_source=None`` makes the grid engine's default
    source, which every rank draws on its own device and cuts to its
    cell, so the mesh solve consumes the grid engine's orders."""
    sparse = isinstance(data, SparseDoublyPartitioned)
    if index_source is None:
        index_source = GeneratorIndexSource(
            cfg.seed, P=data.P, Q=data.Q, n_p=data.n_p,
            steps=cfg.local_steps or data.n_p, device=data.device)
    x_parts = (data.cols, data.vals) if sparse else (data.x_blocks,)
    gate_parts = (() if row_gate is None
                  else (data.alpha_to_blocks(row_gate),))
    alpha_init = (torch.zeros((data.P, data.n_p)) if alpha0 is None
                  else data.alpha_to_blocks(alpha0))
    w_init = (torch.zeros((data.Q, data.m_q)) if w0 is None
              else data.w_to_blocks(w0))
    return bind_mesh_program(
        grid, make_cell="repro_torch.core.d3ca:d3ca_cell_program",
        cell_kw=dict(loss=loss, cfg=cfg, n=data.n,
                     local_backend=local_backend, sparse=sparse,
                     m_q=data.m_q, gated=row_gate is not None),
        index_source=index_source,
        data=(*x_parts, data.y_blocks, data.mask, *gate_parts),
        data_specs=(CELL,) * len(x_parts) + (ROW,) * (2 + len(gate_parts)),
        state0=(alpha_init, w_init), state_specs=(ROW, COL),
        w_of=lambda st: data.w_from_blocks(st[1]),
        alpha_of=lambda st: data.alpha_from_blocks(st[0] * data.mask),
        staleness=staleness, compression=compression, overlap=overlap,
        topology=topology)


def d3ca_simulated(loss_name: str, data, cfg: D3CAConfig,
                   callback=None, local_backend: str = "kernel",
                   index_source=None):
    """Run D3CA on the block grid. Returns (w, alpha)."""
    prog = d3ca_simulated_program(get_loss(loss_name), data, cfg,
                                  local_backend=local_backend,
                                  index_source=index_source)
    state = drive_with_callback(prog, cfg.outer_iters, callback,
                                pass_alpha=True)
    return prog.w_of(state), prog.alpha_of(state)

"""Block-splitting ADMM baseline (Parikh & Boyd 2014) for doubly
distributed data.

The paper compares D3CA/RADiSA against the block-splitting ADMM -- the only
prior doubly distributed optimizer.  This is the graph-form
consensus/exchange splitting specialized to

    min_w  (1/n) sum_i f_i(x_i . w) + lam ||w||^2

with the data split into the same P x Q block grid.  Introducing partial
predictions s_pq = A_pq w_q, the augmented Lagrangian alternates:

  1. *exchange* (rows; one reduction over the "model" axis):
       v_p   = sum_q (A_pq w_q - u_pq)
       z_p   = prox_{(Q/(rho)) f_p}(v_p)          (elementwise prox of the loss)
       s_pq  = c_pq + (z_p - v_p) / Q
  2. *ridge solve* (columns; one reduction over the "data" axis):
       (2 lam/rho I + sum_p A_pq^T A_pq) w_q = sum_p A_pq^T (s_pq + u_pq)
     The normal matrix is factorized (Cholesky) ONCE at setup and cached,
     exactly as the paper caches the factorization.
  3. dual ascent: u_pq += s_pq - A_pq w_q.

The per-step math is ONE :class:`~repro_torch.core.engines.CellProgram`
with the two reductions declared as named collectives::

    CommSchedule().psum("v", axis="model")    # exchange (rows)
                  .psum("rhs", axis="data")   # ridge right-hand side

All three loss proxes are provided (hinge / squared / logistic-Newton).
ADMM has no stochastic local solver and no kernel: its inner solve is the
cached factor's back-substitution (``torch.cholesky_solve``), so the
``local_backend`` knob of the solver framework is accepted and ignored.
``admm_shard_map_program`` binds the same program to a process grid: each
rank's Gram matrix is summed over its column of the grid and factored on
the rank once, at setup (``admm_setup_distributed``).
"""
from __future__ import annotations

import dataclasses

import torch

from .comm import CommSchedule
from .comm import ProcessWire
from .engines import (CELL, COL, ROW, CellProgram, EngineProgram,
                      bind_mesh_program, cached_build, drive_with_callback,
                      grid_bind_state, grid_program)
from .losses import Loss, get_loss
from .partition import (SparseDoublyPartitioned, cells_times_blocks,
                        ell_scatter_add)
from .radisa import blocks_times_w


@dataclasses.dataclass(frozen=True)
class ADMMConfig:
    lam: float = 1e-2
    rho: float = 1e-2      # paper sets rho = lam
    outer_iters: int = 50


# ---------------------------------------------------------------------------
# elementwise proxes of c * f(., y)
# ---------------------------------------------------------------------------

def prox_loss(loss_name: str, v, y, c):
    """prox_{c f(., y)}(v) = argmin_z c f(z, y) + 0.5 (z - v)^2; ``c`` is a
    number or a tensor that broadcasts against ``v``."""
    if loss_name == "hinge":
        yv = y * v
        return torch.where(yv >= 1.0, v,
                           torch.where(yv <= 1.0 - c, v + c * y, y))
    if loss_name == "squared":
        return (v + 2.0 * c * y) / (1.0 + 2.0 * c)
    if loss_name == "logistic":
        z = v
        for _ in range(12):
            g = z - v - c * y * torch.sigmoid(-y * z)
            gp = 1.0 + c * (y * y) * torch.sigmoid(-y * z) \
                * torch.sigmoid(y * z)
            z = z - g / gp
        return z
    raise ValueError(loss_name)


def admm_schedule() -> CommSchedule:
    """ADMM's two reduction points (exchange rows, ridge rhs columns)."""
    return (CommSchedule()
            .psum("v", axis="model")
            .psum("rhs", axis="data"))


def admm_cell_program(loss_name: str, cfg: ADMMConfig, *, n: int, m_q: int,
                      sparse: bool = False,
                      per_problem: bool = False) -> CellProgram:
    """The ONE ADMM program.

    Blocked data: ``(x (P, Q, n_p, m_q), y (P, n_p), mask (P, n_p), chol
    (Q, m_q, m_q))`` -- ``chol`` the lower Cholesky factor of each column
    block's normal matrix -- or with ``sparse=True`` ``(cols, vals (P, Q,
    n_p, k), y, mask, chol)``.  Blocked state: ``(s (P, Q, n_p), u (P, Q,
    n_p), w (Q, m_q))``.

    ``per_problem=True`` is the fleet path: every array carries a tenant
    axis T after its grid axes (``chol (Q, T, m_q, m_q)``, ``s, u (P, Q,
    T, n_p)``, ``w (Q, T, m_q)``) and the data tuple ends with a
    per-tenant ``n (T,)`` float32 tensor; per-tenant ``lam`` needs no
    scalar, it only enters through each tenant's factor.
    """

    def cell(comm, t, data, state):
        if per_problem:
            *data, n_t = data
            n_t = n_t[:, None]                 # against (P, T, n_p)
        else:
            n_t = n
        *x_parts, y, mask, chol = data
        if sparse:
            def colsum(b):
                return ell_scatter_add(m_q, *x_parts, b)
        else:
            def colsum(b):
                return cells_times_blocks(b, *x_parts)
        s, u, w = state
        Qn = comm.axis_size("model")
        c_prox = Qn / (cfg.rho * n_t)  # f_p carries the global 1/n factor
        cvec = blocks_times_w(x_parts, w, sparse) - u
        v = comm("v", cvec)
        z = prox_loss(loss_name, v, y, c_prox)
        z = torch.where(mask > 0, z, v)        # padded rows: identity
        s_new = cvec + ((z - v) / Qn).unsqueeze(1)
        rhs = comm("rhs", colsum(s_new + u))
        w_new = torch.cholesky_solve(rhs.unsqueeze(-1), chol).squeeze(-1)
        u_new = u + s_new - blocks_times_w(x_parts, w_new, sparse)
        return s_new, u_new, w_new

    def payload_shapes(data, state):
        s, _, w = state              # (P, Q, [T,] n_p), _, (Q, [T,] m_q)
        return {"v": tuple(s.shape[2:]), "rhs": tuple(w.shape[1:])}

    return CellProgram(admm_schedule(), cell,
                       state_specs=(("data", "model"), ("data", "model"),
                                    ("model",)),
                       payload_shapes=payload_shapes)


# ---------------------------------------------------------------------------
# single-device grid engine
# ---------------------------------------------------------------------------

def admm_gram(x_parts, m_q: int, sparse: bool) -> torch.Tensor:
    """``(Q', m_q, m_q)``: each column block's sum over its cells of
    A_pq^T A_pq, from blocked ``x_parts`` (dense ``(x,)`` or ELL ``(cols,
    vals)``, ``(P', Q', ...)``).  The dense gram is each cell's own
    product summed over the data axis -- what the reference's mesh setup
    computes (a psum of per-cell grams), so the grid engine and a process
    grid sum the same cell grams and differ only in the order of that
    short sum.  The sum runs in place, one row of cells at a time, so no
    ``(P', Q', m_q, m_q)`` array is made.  The sparse gram is a
    scatter-add of each ELL row's outer products (padding slots are (0,
    0.0) and add nothing)."""
    if not sparse:
        x, = x_parts
        gram = torch.matmul(x[0].transpose(-1, -2), x[0])
        for xp in x[1:]:
            gram += torch.matmul(xp.transpose(-1, -2), xp)
        return gram
    cols, vals = x_parts
    Qn = cols.shape[1]
    cols = cols.long()
    flat = (cols[..., :, None] * m_q + cols[..., None, :])
    outer = vals[..., :, None] * vals[..., None, :]
    # (P', Q', n_p, k, k) -> one row per column block q
    flat = flat.permute(1, 0, 2, 3, 4).reshape(Qn, -1)
    outer = outer.permute(1, 0, 2, 3, 4).reshape(Qn, -1)
    gram = torch.zeros((Qn, m_q * m_q), dtype=vals.dtype,
                       device=vals.device).scatter_add_(1, flat, outer)
    return gram.reshape(Qn, m_q, m_q)


def admm_factor(gram, cfg: ADMMConfig) -> torch.Tensor:
    """The lower Cholesky factor of (lam / rho) I + gram, per block."""
    eye = torch.eye(gram.shape[-1], dtype=gram.dtype, device=gram.device)
    return torch.linalg.cholesky(gram + (cfg.lam / cfg.rho) * eye)


def admm_setup_simulated(data, cfg: ADMMConfig) -> torch.Tensor:
    """The per-column-block Cholesky factors ``(Q, m_q, m_q)`` (lower) of
    M_q = (lam / rho) I + sum_p A_pq^T A_pq, computed once per build.
    ``data`` may be dense or sparse."""
    sparse = isinstance(data, SparseDoublyPartitioned)
    x_parts = (data.cols, data.vals) if sparse else (data.x_blocks,)
    return admm_factor(admm_gram(x_parts, data.m_q, sparse), cfg)


def admm_setup_distributed(ctx, data, *, cfg: ADMMConfig, m_q: int,
                           sparse: bool):
    """A rank's setup on a process grid: its cell's A_pq^T A_pq summed
    over its column of the grid (an all-reduce over the "data" group),
    then factored once on the rank.  Returns the data tuple with the
    rank's ``chol (1, m_q, m_q)`` appended."""
    *x_parts, y, mask = data
    gram = ProcessWire(ctx).all_reduce(admm_gram(x_parts, m_q, sparse),
                                       "data")
    return (*x_parts, y, mask, admm_factor(gram, cfg))


def admm_simulated_program(loss: Loss, data, cfg: ADMMConfig, *,
                           chol=None, w0=None, compression=None,
                           topology=None, cache=None) -> EngineProgram:
    """Grid engine.  State: ``(s (P, Q, n_p), u (P, Q, n_p), w_blocks (Q,
    m_q))``, or ``(that, ef)`` under ``compression`` / ``topology`` (see
    :func:`~repro_torch.core.engines.grid_program`).  The Cholesky setup
    runs at build time unless ``chol`` is given.  ``data`` may be dense
    or sparse (padded-ELL cells)."""
    sparse = isinstance(data, SparseDoublyPartitioned)
    Pn, Qn = data.P, data.Q
    dev = data.device
    if chol is None:
        chol = admm_setup_simulated(data, cfg)
    cellprog = admm_cell_program(loss.name, cfg, n=data.n, m_q=data.m_q,
                                 sparse=sparse)
    x_parts = (data.cols, data.vals) if sparse else (data.x_blocks,)
    gdata = (*x_parts, data.y_blocks, data.mask, chol)
    step = cached_build(cache, "step",
                        lambda: grid_program(cellprog, Pn, Qn,
                                             compression=compression,
                                             topology=topology, device=dev))
    local = cached_build(cache, "local",
                         lambda: grid_program(cellprog, Pn, Qn,
                                              comm_local=True, device=dev))
    w_init = (torch.zeros((Qn, data.m_q), device=dev) if w0 is None
              else data.w_to_blocks(w0))
    zeros_su = torch.zeros((Pn, Qn, data.n_p), device=dev)
    state0 = (zeros_su, zeros_su.clone(), w_init)
    full0, unwrap, acct = grid_bind_state(
        cellprog, gdata, state0, Pn=Pn, Qn=Qn, compression=compression,
        topology=topology, device=dev)
    return EngineProgram(
        state=full0,
        step=lambda t, st: step(t, gdata, st),
        w_of=lambda st: data.w_from_blocks(unwrap(st)[2]),
        comm_bytes=acct,
        ef_of=(lambda st: st[1]) if full0 is not state0 else None,
        local_step=lambda t, st: local(t, gdata, unwrap(st)))


def admm_shard_map_program(loss: Loss, data, cfg: ADMMConfig, grid, *,
                           w0=None, staleness: int = 0, compression=None,
                           overlap: bool = False,
                           topology=None) -> EngineProgram:
    """Mesh engines: the ADMM program on process grid ``grid``
    (``repro_torch.launch.mesh``), one block per rank.  ``data`` is the
    grid engine's blocked view of the problem on the host (dense or
    sparse); each rank factors its column block's normal matrix at setup
    (:func:`admm_setup_distributed`).  ``staleness=tau > 0`` delays every
    reduction by tau steps (``overlap=True``: dispatched asynchronously);
    ``compression`` and ``topology`` as on the grid engine."""
    sparse = isinstance(data, SparseDoublyPartitioned)
    Pn, Qn = data.P, data.Q
    x_parts = (data.cols, data.vals) if sparse else (data.x_blocks,)
    w_init = (torch.zeros((Qn, data.m_q)) if w0 is None
              else data.w_to_blocks(w0))
    zeros_su = torch.zeros((Pn, Qn, data.n_p))
    return bind_mesh_program(
        grid, make_cell="repro_torch.core.admm:admm_cell_program",
        cell_kw=dict(loss_name=loss.name, cfg=cfg, n=data.n, m_q=data.m_q,
                     sparse=sparse),
        index_source=None,
        data=(*x_parts, data.y_blocks, data.mask),
        data_specs=(CELL,) * len(x_parts) + (ROW, ROW),
        state0=(zeros_su, zeros_su.clone(), w_init),
        state_specs=(CELL, CELL, COL),
        w_of=lambda st: data.w_from_blocks(st[2]),
        setup="repro_torch.core.admm:admm_setup_distributed",
        setup_kw=dict(cfg=cfg, m_q=data.m_q, sparse=sparse),
        staleness=staleness, compression=compression, overlap=overlap,
        topology=topology)


def admm_simulated(loss_name: str, data, cfg: ADMMConfig, callback=None,
                   chol=None):
    """Run ADMM on the block grid.  Returns the final w."""
    prog = admm_simulated_program(get_loss(loss_name), data, cfg, chol=chol)
    state = drive_with_callback(prog, cfg.outer_iters, callback)
    return prog.w_of(state)

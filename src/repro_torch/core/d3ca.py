"""D3CA -- Doubly Distributed Dual Coordinate Ascent (Algorithm 1).

The cell-local solver is ``local.local_sdca`` (the CUDA SDCA kernel or
the plain loop, selected by ``local_backend``).  The algorithm
contributes ONE :class:`~repro_torch.core.engines.CellProgram` -- the
step math plus a CommSchedule declaring its two reductions::

    CommSchedule().pmean("dalpha", axis="model")   # step 6 dual average
                  .psum("w_contrib", axis="data")  # step 9 primal-dual map

``d3ca_simulated_program`` binds it to the single-device grid engine;
``d3ca_simulated`` is a thin convenience wrapper.  The outer loop lives
once in ``engines.drive`` / ``solver.Solver.solve``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .comm import CommSchedule
from .engines import (CellProgram, EngineProgram, cached_build,
                      drive_with_callback, grid_program)
from .indices import GeneratorIndexSource
from .local import local_sdca
from .losses import Loss, get_loss
from .partition import DoublyPartitioned, rows_times_blocks


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
                      index_source, local_backend: str = "kernel"
                      ) -> CellProgram:
    """The ONE D3CA program.

    Blocked data: ``(x (P, Q, n_p, m_q), y (P, n_p), mask (P, n_p))``.
    Blocked state: ``(alpha (P, n_p), w (Q, m_q))``.  ``index_source``
    supplies the coordinate order of every outer iteration
    (``sdca_rows(t) -> (P, steps)``, one order per row partition).
    """
    lam = cfg.lam

    def cell(comm, t, data, state):
        x, y, mask = data
        a, w = state
        Pn = comm.axis_size("data")
        Qn = comm.axis_size("model")
        # float32 like every other runtime scalar of the step
        beta = float(np.float32(lam) / np.float32(t))
        idx = index_source.sdca_rows(t)        # coordinate order per p
        dalpha = local_sdca(loss, x, y, mask, a, w, lam=lam, n=n, Q=Qn,
                            idx=idx, step_mode=cfg.step_mode, beta=beta,
                            backend=local_backend)
        # step 6: alpha_[p,.] += (1/P) mean_q dalpha[p, q]
        a_new = a + comm("dalpha", dalpha) / Pn
        # step 9: w_[., q] = (1/(lam n)) sum_p alpha_[p,q]^T x_[p,q]
        am = a_new * mask
        contrib = rows_times_blocks(am, x)
        w_new = comm("w_contrib", contrib) / (lam * n)
        return a_new, w_new

    return CellProgram(d3ca_schedule(), cell)


# ----------------------------------------------------------------------------
# single-device grid engine
# ----------------------------------------------------------------------------

def d3ca_simulated_program(loss: Loss, data: DoublyPartitioned,
                           cfg: D3CAConfig, *, local_backend: str = "kernel",
                           w0=None, alpha0=None, index_source=None,
                           cache=None) -> EngineProgram:
    """Grid engine.  State: (alpha (P, n_p), w_blocks (Q, m_q)).

    ``index_source=None`` draws the coordinate orders from a
    ``torch.Generator`` seeded from ``cfg.seed`` on the data's device."""
    Pn, Qn = data.P, data.Q
    dev = data.device
    if index_source is None:
        index_source = GeneratorIndexSource(
            cfg.seed, P=Pn, Q=Qn, n_p=data.n_p,
            steps=cfg.local_steps or data.n_p, device=dev)
    cellprog = d3ca_cell_program(loss, cfg, n=data.n,
                                 index_source=index_source,
                                 local_backend=local_backend)
    gdata = (data.x_blocks, data.y_blocks, data.mask)
    step = cached_build(cache, "step",
                        lambda: grid_program(cellprog, Pn, Qn, device=dev))

    alpha_init = (torch.zeros((Pn, data.n_p), device=dev) if alpha0 is None
                  else data.alpha_to_blocks(alpha0))
    w_init = (torch.zeros((Qn, data.m_q), device=dev) if w0 is None
              else data.w_to_blocks(w0))
    return EngineProgram(
        state=(alpha_init, w_init),
        step=lambda t, s: step(t, gdata, s),
        w_of=lambda s: data.w_from_blocks(s[1]),
        alpha_of=lambda s: data.alpha_from_blocks(s[0] * data.mask))


def d3ca_simulated(loss_name: str, data: DoublyPartitioned, cfg: D3CAConfig,
                   callback=None, local_backend: str = "kernel",
                   index_source=None):
    """Run D3CA on the block grid. Returns (w, alpha)."""
    prog = d3ca_simulated_program(get_loss(loss_name), data, cfg,
                                  local_backend=local_backend,
                                  index_source=index_source)
    state = drive_with_callback(prog, cfg.outer_iters, callback,
                                pass_alpha=True)
    return prog.w_of(state), prog.alpha_of(state)

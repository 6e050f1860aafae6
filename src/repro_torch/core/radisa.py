"""RADiSA -- RAndom Distributed Stochastic Algorithm (Algorithm 3).

Primal SGD x CD hybrid with SVRG variance reduction in the doubly
distributed setting.  The cell-local inner loop is ``local.local_svrg``
(the CUDA SVRG kernel or the plain loop, selected by ``local_backend``).
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
from .engines import (CellProgram, EngineProgram, cached_build,
                      drive_with_callback, grid_program)
from .indices import GeneratorIndexSource
from .local import local_svrg
from .losses import Loss, get_loss
from .partition import (DoublyPartitioned, blocks_times_cols, partition,
                        rows_times_blocks)


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


def radisa_cell_program(loss: Loss, cfg: RADiSAConfig, *, n: int, m_q: int,
                        index_source, local_backend: str = "kernel"
                        ) -> CellProgram:
    """The ONE RADiSA program.

    Blocked data: ``(x (P, Q, n_p, m_q), y (P, n_p), mask (P, n_p))``;
    blocked state: ``w (Q, m_q)``.  ``index_source`` supplies the shared
    sub-block permutation (``radisa_perm(t) -> (P,)``) and the minibatch
    order of every cell (``svrg_rows(t) -> (P, Q, L)``).  The sub-block
    window of a cell is read in place by the local solver; no column
    slice of the block is materialised."""
    lam = cfg.lam
    avg = cfg.variant == "avg"

    def cell(comm, t, data, state):
        x, y, mask = data
        w = state
        Pn = comm.axis_size("data")
        Qn = comm.axis_size("model")
        m_sub = m_q if avg else m_q // Pn
        eta = cfg.eta(t)
        # (1) anchor inner products, reduced across feature blocks
        z_local = blocks_times_cols(x, w)
        z = comm("z", z_local)                               # (P, n_p)
        # (2) full gradient of F at the anchor, reduced across rows
        gz = loss.grad(z, y) * mask
        gcol = rows_times_blocks(gz, x)
        mu = comm("grad", gcol) / n + lam * w                # (Q, m_q)
        # (3) sub-block assignment (shared permutation) + local SVRG
        idx = index_source.svrg_rows(t)                      # (P, Q, L)
        if avg:
            lo = None
            w_anchor = w.unsqueeze(0).expand(Pn, Qn, m_q).contiguous()
            mu_sub = mu.unsqueeze(0).expand(Pn, Qn, m_q).contiguous()
        else:
            perm = index_source.radisa_perm(t)               # (P,)
            lo = (perm * m_sub).to(torch.int32)       # assigned sub-blocks
            cols = lo.long()[:, None] + torch.arange(m_sub, device=w.device)
            # (Q, P, m_sub) -> (P, Q, m_sub): each cell's window of w, mu
            w_anchor = w[:, cols].transpose(0, 1).contiguous()
            mu_sub = mu[:, cols].transpose(0, 1).contiguous()
        w_new = local_svrg(loss, x, y, mask, z, w_anchor, mu_sub, lam=lam,
                           eta=eta, idx=idx, lo=lo, backend=local_backend)
        # (4) recombine
        if avg:
            # RADiSA-avg: average the P overlapping solutions per block
            return comm("w_avg", w_new)
        delta = torch.zeros((Pn, Qn, m_q), dtype=w.dtype, device=w.device)
        delta.scatter_(2, cols[:, None, :].expand(Pn, Qn, m_sub),
                       w_new - w_anchor)
        return w + comm("dw", delta)

    return CellProgram(radisa_schedule(cfg.variant), cell)


# ----------------------------------------------------------------------------
# single-device grid engine
# ----------------------------------------------------------------------------

def radisa_simulated_program(loss: Loss, data: DoublyPartitioned,
                             cfg: RADiSAConfig, *,
                             local_backend: str = "kernel", w0=None,
                             index_source=None, cache=None) -> EngineProgram:
    """Grid engine.  State: w_blocks (Q, m_q).

    Requires P | m_q (pre-pad with ``partition(..., m_multiple=P*Q)``).
    ``index_source=None`` draws the permutations and minibatch orders
    from a ``torch.Generator`` seeded from ``cfg.seed`` on the data's
    device."""
    Pn, Qn = data.P, data.Q
    dev = data.device
    _check_subblocks(data.m_q, Pn, cfg.variant == "avg")
    if index_source is None:
        index_source = GeneratorIndexSource(
            cfg.seed, P=Pn, Q=Qn, n_p=data.n_p, L=cfg.L or data.n_p,
            device=dev)
    cellprog = radisa_cell_program(loss, cfg, n=data.n, m_q=data.m_q,
                                   index_source=index_source,
                                   local_backend=local_backend)
    gdata = (data.x_blocks, data.y_blocks, data.mask)
    step = cached_build(cache, "step",
                        lambda: grid_program(cellprog, Pn, Qn, device=dev))
    w_init = (torch.zeros((Qn, data.m_q), device=dev) if w0 is None
              else data.w_to_blocks(w0))
    return EngineProgram(
        state=w_init,
        step=lambda t, s: step(t, gdata, s),
        w_of=lambda s: data.w_from_blocks(s))


def radisa_simulated(loss_name: str, data: DoublyPartitioned,
                     cfg: RADiSAConfig, callback=None,
                     local_backend: str = "kernel", index_source=None):
    loss = get_loss(loss_name)
    Pn, Qn = data.P, data.Q
    if data.m_q % Pn and cfg.variant != "avg":
        # RADiSA pre-splits each feature block into P sub-blocks; repartition
        # with extra (inert, all-zero) column padding so that P | m_q.
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

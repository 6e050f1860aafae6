"""SFK -- the stochastic Fang--Klabjan scheme (arXiv 1803.11287).

Fang & Klabjan's follow-up to the source paper targets the streaming
regime: a full anchor-gradient pass over every row per outer iteration
(RADiSA) is wasted work when observations keep arriving.  Their scheme
keeps the doubly distributed P x Q layout but makes the outer iteration
stochastic in the observations.  Per outer iteration t, each cell (p, q):

  1. takes the row subsample ``S_p(t)`` (Bernoulli ``sample_frac``, drawn
     per (t, p) only, so all Q feature blocks of one row partition agree
     on the subset) from the index source's ``sfk_sample(t)`` stream;
  2. anchor inner products ``z = psum_q x_b @ w_b`` (every row, exact);
  3. minibatch anchor gradient ``mu = psum_p g(z)|_S @ x_b / (n * s)``
     -- dividing by the *expected* sample count ``n * sample_frac`` keeps
     the estimate unbiased;
  4. L local SVRG steps on a disjoint feature sub-block (RADiSA's shared
     permutation) with the row mask restricted to ``S_p(t)``;
  5. disjoint sub-block deltas are concatenated by ``psum_p``.

It is ONE :class:`~repro_torch.core.engines.CellProgram` with RADiSA's
CommSchedule shape::

    CommSchedule().psum("z", axis="model")
                  .psum("grad", axis="data")
                  .psum("dw", axis="data")

on dense blocks or padded-ELL sparse cells, through the same SVRG kernels
as RADiSA (sampling only edits the row mask).  Like the reference, this
implements the *scheme*, not a line-by-line transcription of their
pseudocode (the source paper's bibliography carries only its abstract).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .comm import CommSchedule
from .engines import (CellProgram, EngineProgram, cached_build,
                      drive_with_callback, grid_program)
from .indices import GeneratorIndexSource
from .local import local_svrg, local_svrg_sparse
from .losses import Loss, get_loss
from .partition import SparseDoublyPartitioned
from .radisa import (_check_subblocks, bind_primal_program, blocks_times_w,
                     cut_windows, paste_windows, primal_payload_shapes,
                     primal_shard_map_program, rows_times_x)


@dataclasses.dataclass(frozen=True)
class SFKConfig:
    """Knobs of the stochastic Fang--Klabjan solver.

    Attributes:
      lam: global L2 regularization strength.
      L: inner SVRG steps per outer iteration (default: n_p).
      gamma: step-size constant; eta_t = gamma / (1 + sqrt(t - 1)).
      sample_frac: per-round Bernoulli row-sampling probability in
        (0, 1]; 1.0 degenerates to a full-gradient RADiSA-style round.
      outer_iters: outer iterations T.
      seed: seed of the default index source (sampling, sub-block
        permutation and the inner-loop row draws).
    """
    lam: float = 1e-3
    L: int | None = None
    gamma: float = 1.0
    sample_frac: float = 0.5
    outer_iters: int = 20
    seed: int = 0

    def __post_init__(self):
        if not 0.0 < self.sample_frac <= 1.0:
            raise ValueError(f"sample_frac={self.sample_frac} must be in "
                             "(0, 1]")

    def eta(self, t) -> float:
        # eta_t = gamma / (1 + sqrt(t - 1)), in float32 like every other
        # runtime scalar of the step
        root = np.sqrt(np.maximum(np.float32(t) - np.float32(1.0),
                                  np.float32(0.0)))
        return float(np.float32(self.gamma) / (np.float32(1.0) + root))


def sfk_schedule() -> CommSchedule:
    """SFK's three reduction points (same shape as RADiSA's: the
    sampling scheme changes what feeds the wire, not the wire)."""
    return (CommSchedule()
            .psum("z", axis="model")
            .psum("grad", axis="data")
            .psum("dw", axis="data"))


def sfk_cell_program(loss: Loss, cfg: SFKConfig, *, n: int, m_q: int,
                     index_source, local_backend: str = "kernel",
                     sparse: bool = False,
                     per_problem: bool = False) -> CellProgram:
    """The ONE SFK program.

    Blocked data: ``(x (P, Q, n_p, m_q), y (P, n_p), mask (P, n_p))``, or
    with ``sparse=True`` ``(cols, vals (P, Q, n_p, k), y, mask)``;
    blocked state: ``w (Q, m_q)``.  ``index_source`` supplies the row
    sample (``sfk_sample(t) -> (P, n_p)``), the sub-block permutation and
    the minibatch orders.  Requires P | m_q (the Solver API pads the
    feature dimension to a multiple of P*Q).

    ``per_problem=True`` is the fleet path: every array carries a tenant
    axis T after its grid axes, and the data tuple ends with per-tenant
    ``lam (T,)`` and ``n (T,)`` float32 tensors: the anchor gradient
    divides by ``n_t * sample_frac`` and the local loop takes ``lam_t``.
    """
    lam = cfg.lam
    local = local_svrg_sparse if sparse else local_svrg

    def cell(comm, t, data, state):
        if per_problem:
            *data, lam_t, n_t = data
            lam_b = lam_t[:, None]                  # against (Q, T, m_q)
            n_s = (n_t * cfg.sample_frac)[:, None]
        else:
            lam_t = lam_b = lam
            n_s = n * cfg.sample_frac
        *x_parts, y, mask = data
        w = state
        Pn = comm.axis_size("data")
        m_sub = m_q // Pn
        eta = cfg.eta(t)
        # (1) row subsample S_p(t), shared by every feature block of p
        smask = mask * index_source.sfk_sample(t)
        # (2) anchor inner products (exact, every row)
        z = comm("z", blocks_times_w(x_parts, w, sparse))    # (P, n_p)
        # (3) unbiased minibatch anchor gradient over the sample
        gz = loss.grad(z, y) * smask
        mu = (comm("grad", rows_times_x(gz, x_parts, m_q, sparse))
              / n_s + lam_b * w)                             # (Q, m_q)
        # (4) disjoint sub-block assignment + local inner loop on S_p(t)
        lo, win, w_anchor, mu_sub = cut_windows(
            w, mu, index_source.radisa_perm(t), m_sub)
        w_new = local(loss, *x_parts, y, smask, z, w_anchor, mu_sub,
                      lam=lam_t, eta=eta, idx=index_source.svrg_rows(t),
                      lo=lo, backend=local_backend)
        # (5) concatenate disjoint sub-block deltas
        return w + comm("dw", paste_windows(win, w_new - w_anchor, m_q))

    return CellProgram(sfk_schedule(), cell, state_specs=("model",),
                       payload_shapes=primal_payload_shapes(sfk_schedule(),
                                                            per_problem))


# ----------------------------------------------------------------------------
# single-device grid engine
# ----------------------------------------------------------------------------

def sfk_simulated_program(loss: Loss, data, cfg: SFKConfig, *,
                          local_backend: str = "kernel", w0=None,
                          index_source=None, compression=None,
                          topology=None, cache=None) -> EngineProgram:
    """Grid engine.  State: w_blocks (Q, m_q), or ``(w_blocks, ef)``
    under ``compression`` / ``topology`` (see
    :func:`~repro_torch.core.engines.grid_program`).

    ``data`` may be a dense :class:`DoublyPartitioned` or a sparse
    :class:`SparseDoublyPartitioned`.  Requires P | m_q (pre-pad with
    ``partition(..., m_multiple=P*Q)``).  ``index_source=None`` draws
    the samples, permutations and minibatch orders from a
    ``torch.Generator`` seeded from ``cfg.seed`` on the data's device."""
    sparse = isinstance(data, SparseDoublyPartitioned)
    Pn, Qn = data.P, data.Q
    dev = data.device
    _check_subblocks(data.m_q, Pn, False)
    if index_source is None:
        index_source = GeneratorIndexSource(
            cfg.seed, P=Pn, Q=Qn, n_p=data.n_p, L=cfg.L or data.n_p,
            sample_frac=cfg.sample_frac, device=dev)
    cellprog = sfk_cell_program(loss, cfg, n=data.n, m_q=data.m_q,
                                index_source=index_source,
                                local_backend=local_backend, sparse=sparse)
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


def sfk_shard_map_program(loss: Loss, data, cfg: SFKConfig, grid, *,
                          local_backend: str = "kernel", w0=None,
                          index_source=None, staleness: int = 0,
                          compression=None, overlap: bool = False,
                          topology=None) -> EngineProgram:
    """Mesh engines: the SFK program on process grid ``grid``, one block
    per rank; the knobs as in
    :func:`repro_torch.core.d3ca.d3ca_shard_map_program`.  Requires P |
    m_q."""
    _check_subblocks(data.m_q, data.P, False)
    if index_source is None:
        index_source = GeneratorIndexSource(
            cfg.seed, P=data.P, Q=data.Q, n_p=data.n_p,
            L=cfg.L or data.n_p, sample_frac=cfg.sample_frac,
            device=data.device)
    return primal_shard_map_program(
        "repro_torch.core.sfk:sfk_cell_program",
        dict(loss=loss, cfg=cfg, local_backend=local_backend), data, grid,
        w0=w0, index_source=index_source, staleness=staleness,
        compression=compression, overlap=overlap, topology=topology)


def sfk_simulated(loss_name: str, data, cfg: SFKConfig, callback=None,
                  local_backend: str = "kernel", index_source=None):
    """Convenience wrapper around the grid engine.  Returns the final w."""
    prog = sfk_simulated_program(get_loss(loss_name), data, cfg,
                                 local_backend=local_backend,
                                 index_source=index_source)
    state = drive_with_callback(prog, cfg.outer_iters, callback)
    return prog.w_of(state)

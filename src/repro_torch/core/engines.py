"""Engine executors for the unified solver framework (``core/solver.py``).

An *engine* is how the P x Q block grid of the paper is executed.  Each
solver contributes ONE :class:`CellProgram` -- its step math plus a
:class:`~repro_torch.core.comm.CommSchedule` declaring every cross-cell
reduction as a named collective.  This slice has one engine:

  * ``"simulated"`` -- :func:`grid_program`: the grid is the leading
    (P, Q) axes of blocked tensors on one device, the declared
    collectives are reductions over those axes, and the cell-local
    kernels take all cells of one outer step in one launch.

The mesh engines of the reference (shard_map, async, overlap) are not
ported yet (ROADMAP queue A, multi-device engines).

The executor produces an :class:`EngineProgram` -- initial state, outer
step, extractors for the global primal (and dual) iterates.  Everything
else (the outer loop, history, early stopping, warm starts) lives once
in the shared outer loop (``drive`` / ``Solver.solve``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from .comm import CommSchedule, SyncComm


@dataclasses.dataclass
class EngineProgram:
    """One algorithm bound to one engine: state + step + extractors.

    The uniform handle ``Solver.program`` returns and ``drive`` runs.

    Attributes:
      state: the initial engine state (blocked iterates).
      step: ``(t, state) -> state`` advancing one outer iteration; ``t``
        is the 1-based iteration counter.
      w_of: ``state -> (m,)`` -- the assembled global primal iterate
        (trimmed of any grid padding).
      alpha_of: ``state -> (n,)`` global dual, or None for primal-only
        solvers.
    """

    state: Any
    step: Callable[[int, Any], Any]
    w_of: Callable[[Any], torch.Tensor]
    alpha_of: Optional[Callable[[Any], torch.Tensor]] = None


def drive(prog: EngineProgram, outer_iters: int, observe=None):
    """Run the outer loop.  ``observe(t, state) -> bool`` is called after
    every step; returning True stops early.  Returns
    (final state, iterations run, stopped_early)."""
    state = prog.state
    done = 0
    for t in range(1, outer_iters + 1):
        state = prog.step(t, state)
        done = t
        if observe is not None and observe(t, state):
            return state, done, True
    return state, done, False


def drive_with_callback(prog: EngineProgram, outer_iters: int, callback=None,
                        pass_alpha: bool = False):
    """Outer loop of the ``*_simulated`` wrappers: relay each iterate to
    ``callback(t, w[, alpha])``, ignoring its return value (these
    callbacks never early-stop).  Returns the final state."""
    observe = None
    if callback is not None:
        def observe(t, state):
            if pass_alpha:
                callback(t, prog.w_of(state), prog.alpha_of(state))
            else:
                callback(t, prog.w_of(state))
            return False
    state, _, _ = drive(prog, outer_iters, observe)
    return state


@dataclasses.dataclass(frozen=True)
class CellProgram:
    """One solver's step math plus its communication contract.

    ``cell(comm, t, data, state) -> state`` operates on BLOCKED tensors --
    every per-cell array of the reference carries the grid axes it varies
    over as leading axes, in (data, model) order -- and performs every
    cross-cell reduction through the :class:`~repro_torch.core.comm.Comm`
    it is handed, never with an inline sum over a grid axis.
    """

    schedule: CommSchedule
    cell: Callable[..., Any]


def cached_build(cache, key, build):
    """Memoize ``build()`` under ``key`` in ``cache`` (a plain dict owned
    by the caller); ``cache=None`` just calls ``build()``."""
    if cache is None:
        return build()
    if key not in cache:
        cache[key] = build()
    return cache[key]


def grid_program(cellprog: CellProgram, Pn: int, Qn: int, *, device="cpu"):
    """Single-device grid executor.  Returns ``step(t, data, state) ->
    state`` where ``data``/``state`` are blocked: the P x Q grid is the
    leading axes of the operands and the declared collectives run as
    reductions over them, through a fresh :class:`SyncComm` per step whose
    exactly-once contract is checked after the step."""
    sizes = {"data": Pn, "model": Qn}
    sched = cellprog.schedule

    def step(t, data, state):
        comm = SyncComm(sched, sizes, device=device)
        out = cellprog.cell(comm, t, data, state)
        comm.finalize()
        return out

    return step

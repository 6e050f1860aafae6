"""Unified solver framework: one API over D3CA / RADiSA.

The paper's doubly distributed optimizers share one P x Q execution
story.  This module provides that story once:

  * a :class:`Solver` base class with a registry --
    ``get_solver("d3ca" | "radisa")`` returns the solver class;
  * knobs threaded end-to-end:
      - ``device="cuda" | "cpu"`` -- where the grid lives.  The default
        is the card; without one the solver raises rather than carrying
        on on the CPU, which has to be asked for by name;
      - ``local_backend="kernel" | "ref"`` -- the hand-written CUDA
        kernels (their plain PyTorch versions for tensors on the CPU) vs
        the plain per-step loop of ``core/local.py``;
      - ``index_source`` -- where the random coordinate orders come from
        (``core/indices.py``); ``None`` draws them from a
        ``torch.Generator`` seeded from the config;
  * a shared outer loop: objective / duality-gap history, early
    stopping, warm starts from a previous ``w`` / ``alpha``.

This slice of the port covers the single-device grid engine
(``engine="simulated"``) on dense blocks.  Every other knob of the
reference's ``Solver`` -- the mesh engines, ``block_format="sparse"``,
``staleness``, ``compression``, ``topology``, row gates and
``Solver.update``, tracer / registry / monitor, and the solvers ``sfk``
and ``admm`` -- raises ``NotImplementedError`` naming the ROADMAP queue
item that brings it; nothing is silently ignored.

Example::

    from repro_torch.core import D3CAConfig, get_solver

    solver = get_solver("d3ca")()            # device="cuda", "kernel"
    res = solver.solve("hinge", X, y, P=7, Q=4,
                       cfg=D3CAConfig(lam=1e-2, outer_iters=20),
                       f_star=f_star, tol=1e-2)
    res.w, res.history[-1]["objective"], res.converged
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Type

from .d3ca import D3CAConfig, d3ca_simulated_program
from .engines import EngineProgram, drive
from .local import LOCAL_BACKENDS
from .losses import get_loss
from .partition import partition
from .radisa import RADiSAConfig, radisa_simulated_program
from .reference import rel_opt
from .util import as_tensor, resolve_device

ENGINES = ("simulated",)
BLOCK_FORMATS = ("dense",)

#: what the reference offers and this slice does not (solver knobs, CLI
#: flags by their argparse dest, solver names), with the title of the
#: ROADMAP queue-A item that ports it
_ITEMS = {
    "mesh": "'Multi-device engines'",
    "sparse": "'Sparse path'",
    "comm": "'Comm policies on the grid engine'",
    "online": "'Row gate, online service, scorer, checkpoints'",
    "obs": "'Observability'",
    "fleet": "'Fleet'",
    "sfk": "'RADiSA, then SFK'",
    "admm": "'ADMM'",
}
NOT_PORTED = {
    "engine": _ITEMS["mesh"], "mesh": _ITEMS["mesh"],
    "force_host_devices": _ITEMS["mesh"],
    "block_format": _ITEMS["sparse"], "dataset": _ITEMS["sparse"],
    "libsvm_path": _ITEMS["sparse"],
    "staleness": _ITEMS["comm"], "compression": _ITEMS["comm"],
    "topology": _ITEMS["comm"],
    "program_cache": _ITEMS["online"], "row_gate": _ITEMS["online"],
    "update": _ITEMS["online"],
    "tracer": _ITEMS["obs"], "registry": _ITEMS["obs"],
    "monitor": _ITEMS["obs"], "trace": _ITEMS["obs"],
    "metrics": _ITEMS["obs"], "listen": _ITEMS["obs"],
    "health": _ITEMS["obs"], "flight_recorder": _ITEMS["obs"],
    "problems": _ITEMS["fleet"],
    "sfk": _ITEMS["sfk"], "admm": _ITEMS["admm"],
}


def not_ported_message(knob: str, shown: Optional[str] = None) -> str:
    return (f"{shown or knob} is not ported to repro_torch yet; it arrives "
            f"with ROADMAP queue A, {NOT_PORTED[knob]}")


def not_ported(knob: str, value=None) -> NotImplementedError:
    shown = knob if value is None else f"{knob}={value!r}"
    return NotImplementedError(not_ported_message(knob, shown))


@dataclasses.dataclass
class SolveResult:
    """Outcome of :meth:`Solver.solve`."""

    w: Any                          # (m,) global primal iterate
    alpha: Optional[Any]            # (n,) global dual iterate (D3CA only)
    history: List[Dict[str, float]]  # per-iter: iter, time_s, objective,
    #                                  [duality_gap], [rel_opt]
    iters: int                      # outer iterations actually run
    converged: bool                 # True iff early stopping triggered
    solver: str
    engine: str
    local_backend: str
    block_format: str = "dense"
    device: str = "cuda"


def _unpack_warm_start(warm_start):
    if warm_start is None:
        return None, None
    if isinstance(warm_start, SolveResult):
        return warm_start.w, warm_start.alpha
    if isinstance(warm_start, (tuple, list)):
        w0 = warm_start[0] if len(warm_start) > 0 else None
        alpha0 = warm_start[1] if len(warm_start) > 1 else None
        return w0, alpha0
    return warm_start, None         # bare w


class Solver:
    """Base class: one doubly distributed optimizer on the grid engine.

    Subclasses bind the algorithm (config class + the ``EngineProgram``
    constructor); everything about *running* a solve -- data placement and
    padding, the outer loop, history, early stopping, warm starts --
    lives here, once.
    """

    name: str = ""
    config_cls: Type = None
    has_dual: bool = False

    def __init__(self, engine: str = "simulated",
                 local_backend: str = "kernel", block_format: str = "dense",
                 staleness: int = 0, compression=None, topology=None,
                 program_cache: bool = False, *, device="cuda",
                 index_source=None):
        if engine not in ENGINES:
            raise not_ported("engine", engine)
        if local_backend not in LOCAL_BACKENDS:
            raise ValueError(f"local_backend={local_backend!r}; expected one "
                             f"of {LOCAL_BACKENDS}")
        if block_format not in BLOCK_FORMATS:
            raise not_ported("block_format", block_format)
        if int(staleness) != 0:
            raise not_ported("staleness", staleness)
        if compression is not None:
            raise not_ported("compression", compression)
        if topology is not None:
            raise not_ported("topology", topology)
        if program_cache:
            raise not_ported("program_cache", program_cache)
        self.engine = engine
        self.local_backend = local_backend
        self.block_format = block_format
        #: raises here, at construction, when the card is asked for and
        #: there is none
        self.device = resolve_device(device)
        self.index_source = index_source

    # ---- subclass hook ----------------------------------------------------
    def _simulated_program(self, loss, data, cfg, w0, alpha0
                           ) -> EngineProgram:
        raise NotImplementedError

    # ---- program construction --------------------------------------------
    def program(self, loss_name: str, X, y, *, P: int = None, Q: int = None,
                cfg=None, mesh=None, warm_start=None,
                row_gate=None) -> EngineProgram:
        """Bind the solver to data on the configured device/backend.

        Pads the feature dimension to a multiple of P*Q so RADiSA's P
        sub-blocks always divide m_q.

        Args:
          loss_name: a key of :data:`repro_torch.core.losses.LOSSES`.
          X, y: the (n, m) training matrix and (n,) labels (numpy arrays
            or tensors; moved to the solver's device).
          P, Q: observation/feature partition counts.
          cfg: the solver's config dataclass (``config_cls()`` default).
          warm_start: a :class:`SolveResult`, a ``(w, alpha)`` tuple, or
            a bare ``w`` to initialize the iterates from.

        Returns:
          An :class:`EngineProgram` ready for :func:`engines.drive`.
        """
        if mesh is not None:
            raise not_ported("mesh")
        if row_gate is not None:
            raise not_ported("row_gate")
        loss = get_loss(loss_name)
        cfg = cfg if cfg is not None else self.config_cls()
        w0, alpha0 = _unpack_warm_start(warm_start)
        if P is None or Q is None:
            raise ValueError("engine='simulated' needs P and Q")
        data = partition(X, y, P, Q, m_multiple=P * Q, device=self.device)
        return self._simulated_program(loss, data, cfg, w0, alpha0)

    # ---- the shared outer loop --------------------------------------------
    def solve(self, loss_name: str, X, y, *, P: int = None, Q: int = None,
              cfg=None, mesh=None, warm_start=None,
              tol: Optional[float] = None, f_star: Optional[float] = None,
              record_history: bool = True,
              callback: Optional[Callable] = None,
              tracer=None, registry=None, monitor=None,
              row_gate=None) -> SolveResult:
        """Run the solver.

        Early stopping (when ``tol`` is given) uses, in order of
        preference: relative optimality vs ``f_star``; the duality gap
        (dual solvers); the relative objective change between iterates.
        ``callback(t, w, alpha)`` fires every iteration.

        Args:
          loss_name, X, y, P, Q, cfg, warm_start: see :meth:`program`.
          tol: early-stopping tolerance (None disables early stopping).
          f_star: reference optimum enabling the ``rel_opt`` history
            field and rel-opt early stopping.
          record_history: collect per-iteration history entries.
          callback: ``callback(t, w, alpha)`` per outer iteration.

        Returns:
          A :class:`SolveResult` whose ``w`` / ``alpha`` are tensors on
          the solver's device.
        """
        for knob, val in (("tracer", tracer), ("registry", registry),
                          ("monitor", monitor)):
            if val is not None:
                raise not_ported(knob)
        cfg = cfg if cfg is not None else self.config_cls()
        res = self._solve_stage(
            loss_name, X, y, P=P, Q=Q, cfg=cfg, mesh=mesh,
            warm_start=warm_start, tol=tol, f_star=f_star,
            record_history=record_history, callback=callback,
            row_gate=row_gate)
        return res

    def update(self, *args, **kwargs):
        raise not_ported("update")

    def _solve_stage(self, loss_name: str, X, y, *, P, Q, cfg, mesh,
                     warm_start, tol, f_star, record_history, callback,
                     row_gate) -> SolveResult:
        """One program build + outer loop."""
        loss = get_loss(loss_name)
        # the objective is evaluated on the device, against the same
        # tensors the blocks were cut from
        X = as_tensor(X, self.device)
        y = as_tensor(y, self.device)
        prog = self.program(loss_name, X, y, P=P, Q=Q, cfg=cfg, mesh=mesh,
                            warm_start=warm_start, row_gate=row_gate)
        lam = cfg.lam
        history: List[Dict[str, float]] = []
        need_obs = (record_history or callback is not None
                    or tol is not None)
        prev_f = [None]
        t0 = time.perf_counter()

        def observe(t, state):
            if not need_obs:
                return False
            w = prog.w_of(state)
            alpha = prog.alpha_of(state) if prog.alpha_of else None
            f = float(loss.objective(X, y, w, lam))
            entry = {"iter": t, "time_s": time.perf_counter() - t0,
                     "objective": f}
            if alpha is not None:
                entry["duality_gap"] = float(
                    f - loss.dual_objective(X, y, alpha, lam))
            if f_star is not None:
                entry["rel_opt"] = float(rel_opt(f, f_star))
            if record_history:
                history.append(entry)
            if callback is not None:
                callback(t, w, alpha)
            stop = False
            if tol is not None:
                if f_star is not None:
                    stop = entry["rel_opt"] < tol
                elif "duality_gap" in entry:
                    stop = entry["duality_gap"] < tol
                elif prev_f[0] is not None:
                    stop = abs(f - prev_f[0]) <= tol * max(1.0, abs(f))
            prev_f[0] = f
            return stop

        state, iters, stopped = drive(prog, cfg.outer_iters, observe)
        return SolveResult(
            w=prog.w_of(state),
            alpha=prog.alpha_of(state) if prog.alpha_of else None,
            history=history, iters=iters, converged=stopped,
            solver=self.name, engine=self.engine,
            local_backend=self.local_backend,
            block_format=self.block_format, device=str(self.device))


# ---------------------------------------------------------------------------
# the solvers
# ---------------------------------------------------------------------------

_REGISTRY: Dict[str, Type[Solver]] = {}


def register_solver(cls: Type[Solver]) -> Type[Solver]:
    """Class decorator adding a :class:`Solver` subclass to the registry
    under its ``name`` attribute.  Returns the class unchanged, so it
    stacks with other decorators."""
    _REGISTRY[cls.name] = cls
    return cls


def get_solver(name: str) -> Type[Solver]:
    """Look up a solver class by name; instantiate with
    ``get_solver(name)(local_backend=..., device=...)``.

    Raises:
      NotImplementedError: for a solver of the reference that is not
        ported yet (``sfk``, ``admm``).
      KeyError: for any other unregistered name (the message lists what
        IS registered).
    """
    if name not in _REGISTRY and name in NOT_PORTED:
        raise not_ported(name)
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown solver {name!r}; available: "
                       f"{available_solvers()}") from None


def available_solvers():
    """Sorted names of every registered solver (``["d3ca", "radisa"]``)."""
    return sorted(_REGISTRY)


@register_solver
class D3CASolver(Solver):
    name = "d3ca"
    config_cls = D3CAConfig
    has_dual = True

    def _simulated_program(self, loss, data, cfg, w0, alpha0):
        return d3ca_simulated_program(loss, data, cfg,
                                      local_backend=self.local_backend,
                                      w0=w0, alpha0=alpha0,
                                      index_source=self.index_source)


@register_solver
class RADiSASolver(Solver):
    name = "radisa"
    config_cls = RADiSAConfig

    def _simulated_program(self, loss, data, cfg, w0, alpha0):
        return radisa_simulated_program(loss, data, cfg,
                                        local_backend=self.local_backend,
                                        w0=w0,
                                        index_source=self.index_source)

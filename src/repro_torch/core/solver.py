"""Unified solver framework: one API over D3CA / RADiSA / SFK / ADMM.

The paper's doubly distributed optimizers share one P x Q execution
story.  This module provides that story once:

  * a :class:`Solver` base class with a registry --
    ``get_solver("d3ca" | "radisa" | "sfk" | "admm")`` returns the solver
    class;
  * knobs threaded end-to-end:
      - ``engine="simulated" | "shard_map" | "sync" | "async" |
        "overlap"`` -- the single-device grid engine, or a process grid
        of P x Q ranks, one block each (``repro_torch.launch.mesh``):
        synchronous reductions (``"shard_map"``, alias ``"sync"``),
        reductions applied ``staleness`` = tau steps late (``"async"``)
        or dispatched asynchronously with the same delays
        (``"overlap"``); tau = 0 on either is ``"shard_map"`` bit for
        bit;
      - ``device="cuda" | "cpu"`` -- where the grid lives (every rank of
        a process grid on the card(s), or on the CPU).  The default is
        the card; without one the solver raises rather than carrying on
        on the CPU, which has to be asked for by name;
      - ``local_backend="kernel" | "ref"`` -- the hand-written CUDA
        kernels (their plain PyTorch versions for tensors on the CPU) vs
        the plain per-step loop of ``core/local.py`` (ADMM, whose inner
        solve is a cached Cholesky, accepts the knob and ignores it);
      - ``block_format="dense" | "sparse"`` -- per-cell (n_p, m_q) tiles
        or padded-ELL cells (memory ~ nnz).  ``"sparse"`` takes a
        :class:`~repro_torch.data.sparse.CSRMatrix` (or a dense array,
        converted row-wise) and never densifies it; ``"dense"``
        densifies a CSR input;
      - ``index_source`` -- where the random coordinate orders come from
        (``core/indices.py``); ``None`` draws them from a
        ``torch.Generator`` seeded from the config;
      - ``compression=...`` -- a codec spec / CompressionPolicy mapping
        the solver's declared collectives to codecs (``"int8"``,
        ``"fp8"``, ``"topk:0.1"``, or per collective
        ``"w_contrib=int8,dalpha=identity"``) with error feedback; None
        builds the exact uncompressed program, and the identity codec is
        bit-identical to it.  ``"adaptive..."`` specs build a
        :class:`~repro_torch.core.compress.CompressionSchedule`: staged
        codecs switched by the observed ``rel_opt`` slope, each stage a
        warm-started program build;
      - ``topology="pods=G[:codec]"`` -- hierarchical reductions over the
        data axis: full precision within each of G pods (contiguous row
        partitions), the codec (with error feedback) across pods;
      - ``program_cache=True`` -- reuse the built step across program
        builds of one key (always on inside :meth:`Solver.update`;
        bypassed under compression or topology, whose programs carry
        per-build residuals);
      - ``row_gate`` -- the incremental online-update path: dual updates
        restricted to gated-on rows (D3CA only, ``supports_row_gate``);
        :meth:`Solver.update` builds the gate from the touched rows;
      - ``tracer`` / ``registry`` / ``monitor`` (per call, see
        :meth:`Solver.solve`) -- spans, metrics and health polling; a
        tracer or a registry takes the timed path, which calibrates the
        local / comm split of the program and waits for the device after
        every step, with bitwise the same iterates;
  * a shared outer loop: objective / duality-gap history (with the
    cumulative exact ``comm_bytes``), early stopping, warm starts from a
    previous ``w`` / ``alpha``.

Many problems of one shape solve together through
``repro_torch.fleet.FleetSolver`` (on the grid engine or the synchronous
mesh).  ``staleness > 0`` needs the async / overlap engines and is
refused with the reference's ``ValueError`` elsewhere.  A knob the
reference offers and the port does not yet would raise
``NotImplementedError`` naming the ROADMAP queue item that brings it
(``NOT_PORTED``, empty since re-sharding a restored checkpoint was
ported); nothing is silently ignored.

Example::

    from repro_torch.core import D3CAConfig, get_solver

    solver = get_solver("d3ca")()            # device="cuda", "kernel"
    res = solver.solve("hinge", X, y, P=7, Q=4,
                       cfg=D3CAConfig(lam=1e-2, outer_iters=20),
                       f_star=f_star, tol=1e-2)
    res.w, res.history[-1]["objective"], res.converged

    # news20-scale sparse data: CSR in, padded-ELL cells on the card
    csr, y = make_sparse_svm_csr(19996, 1355191, density=3.4e-4)
    res = get_solver("radisa")(block_format="sparse").solve(
        "hinge", csr, y, P=7, Q=4, cfg=RADiSAConfig(lam=1e-4))
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Type

import numpy as np
import torch

from ..data.sparse import CSRMatrix
from ..obs.phases import bench_codecs, calibrate_phases
from ..obs.trace import as_tracer
from .admm import (ADMMConfig, admm_shard_map_program,
                   admm_simulated_program)
from .comm_model import as_topology
from .compress import CompressionSchedule, as_compression
from .d3ca import D3CAConfig, d3ca_shard_map_program, d3ca_simulated_program
from .engines import EngineProgram, drive
from .local import LOCAL_BACKENDS
from .losses import get_loss
from .partition import partition, partition_sparse
from .radisa import (RADiSAConfig, radisa_shard_map_program,
                     radisa_simulated_program)
from .reference import rel_opt
from .sfk import SFKConfig, sfk_shard_map_program, sfk_simulated_program
from .util import DTYPE, as_tensor, resolve_device

ENGINES = ("simulated", "shard_map", "async", "overlap")
#: "sync" names the synchronous mesh policy explicitly (the CommSchedule
#: terminology); it is the same engine as "shard_map"
ENGINE_ALIASES = {"sync": "shard_map"}
BLOCK_FORMATS = ("dense", "sparse")

#: what the reference offers and the port does not (knobs, and CLI flags
#: by their argparse dest), with the title of the ROADMAP queue-A item
#: that ports it -- nothing since ``restore_tree(shardings=)`` (item 13c)
NOT_PORTED: dict = {}


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
    staleness: int = 0
    compression: Optional[str] = None   # canonical policy/schedule spec
    topology: Optional[str] = None      # canonical topology spec, or None
    #: exact per-step wire accounting of the declared collectives (see
    #: repro_torch.core.compress.wire_accounting); history entries carry
    #: the cumulative "comm_bytes" derived from it
    comm_bytes: Optional[Dict] = None


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
    supports_row_gate: bool = False

    def __init__(self, engine: str = "simulated",
                 local_backend: str = "kernel", block_format: str = "dense",
                 staleness: int = 0, compression=None, topology=None,
                 program_cache: bool = False, *, device="cuda",
                 index_source=None):
        engine = ENGINE_ALIASES.get(engine, engine)
        if engine not in ENGINES:
            raise ValueError(f"engine={engine!r}; expected one of {ENGINES}")
        if local_backend not in LOCAL_BACKENDS:
            raise ValueError(f"local_backend={local_backend!r}; expected one "
                             f"of {LOCAL_BACKENDS}")
        if block_format not in BLOCK_FORMATS:
            raise ValueError(f"block_format={block_format!r}; expected one "
                             f"of {BLOCK_FORMATS}")
        staleness = int(staleness)
        if staleness < 0:
            raise ValueError(f"staleness={staleness} must be >= 0 (the "
                             "reduction delay tau of the async/overlap "
                             "engines)")
        if staleness > 0 and engine not in ("async", "overlap"):
            raise ValueError(
                f"staleness={staleness} needs engine='async' or "
                f"engine='overlap'; the {engine!r} engine applies every "
                "reduction synchronously.  Pass engine='async' or "
                "engine='overlap' (staleness=0 on either reproduces "
                "'shard_map' exactly).")
        self.engine = engine
        self.local_backend = local_backend
        self.block_format = block_format
        self.staleness = staleness
        #: normalized CompressionPolicy or CompressionSchedule (None = no
        #: compression machinery at all: the exact uncompressed program),
        #: validated against the solver's CommSchedule at program build
        self.compression = as_compression(compression)
        #: hierarchical reduction topology (None = flat reductions)
        self.topology = as_topology(topology)
        #: current CompressionSchedule stage (policies are per stage)
        self._stage = 0
        #: raises here, at construction, when the card is asked for and
        #: there is none
        self.device = resolve_device(device)
        self.index_source = index_source
        #: reuse the built step across program builds with constant
        #: shapes (always on inside :meth:`update`, where shapes are
        #: constant by design).  Keyed on (solver, engine, loss,
        #: cfg-minus-outer_iters, backend, format, gate-ness, shapes,
        #: grid); bypassed under compression / topology, whose programs
        #: carry per-build error-feedback residuals.
        self.program_cache = bool(program_cache)
        self._prog_cache: Dict = {}

    @property
    def compression_spec(self) -> Optional[str]:
        return self.compression.spec if self.compression is not None else None

    @property
    def active_policy(self):
        """The CompressionPolicy the *current* program runs under: the
        schedule's current stage, or the fixed policy, or None."""
        if isinstance(self.compression, CompressionSchedule):
            return self.compression.stages[self._stage]
        return self.compression

    @property
    def topology_spec(self) -> Optional[str]:
        return self.topology.spec if self.topology is not None else None

    # ---- subclass hook ----------------------------------------------------
    def _simulated_program(self, loss, data, cfg, w0, alpha0,
                           cache=None) -> EngineProgram:
        raise NotImplementedError

    def _comm_kw(self):
        """The communication knobs every ``*_simulated_program`` takes."""
        return {"compression": self.active_policy,
                "topology": self.topology}

    def _shard_map_program(self, loss, data, cfg, w0, alpha0,
                           grid) -> EngineProgram:
        raise NotImplementedError

    def _mesh_kw(self):
        """The engine knobs every ``*_shard_map_program`` takes."""
        return {"staleness": self.staleness,
                "overlap": self.engine == "overlap", **self._comm_kw()}

    def _build_cache(self, loss_name, cfg, X, P, Q, gated: bool):
        """The per-key dict in which the ``*_simulated_program``
        functions memoize their steps, or None when caching is off or
        unsafe (compression and topology programs carry per-build
        error-feedback residuals; a process grid builds its ranks'
        programs anew for every session)."""
        if not self.program_cache or self.engine != "simulated":
            return None
        if self.active_policy is not None or self.topology is not None:
            return None
        key = (self.name, self.engine, loss_name,
               dataclasses.replace(cfg, outer_iters=0),
               self.local_backend, self.block_format, gated,
               tuple(X.shape), P, Q)
        return self._prog_cache.setdefault(key, {})

    # ---- program construction --------------------------------------------
    def program(self, loss_name: str, X, y, *, P: int = None, Q: int = None,
                cfg=None, mesh=None, warm_start=None,
                row_gate=None) -> EngineProgram:
        """Bind the solver to data on the configured device/backend.

        Pads the feature dimension to a multiple of P*Q so RADiSA's P
        sub-blocks always divide m_q.  ``block_format="sparse"`` cuts
        padded-ELL cells from a :class:`CSRMatrix` ``X`` and never
        materialises the dense matrix (a dense ``X`` is converted row by
        row); ``block_format="dense"`` densifies a CSR input.

        Args:
          loss_name: a key of :data:`repro_torch.core.losses.LOSSES`.
          X, y: the (n, m) training matrix and (n,) labels (numpy arrays,
            tensors or, for X, a :class:`CSRMatrix`; the blocks are made
            on the solver's device).
          P, Q: observation/feature partition counts (required unless a
            ``mesh`` is given).
          cfg: the solver's config dataclass (``config_cls()`` default).
          mesh: a :class:`repro_torch.launch.mesh.ProcessGrid` for the
            mesh engines; by default the memoized grid of P x Q ranks on
            the solver's device (``process_grid``).
          warm_start: a :class:`SolveResult`, a ``(w, alpha)`` tuple, or
            a bare ``w`` to initialize the iterates from.
          row_gate: optional (n,) 0/1 per-row activity gate restricting
            dual updates to gated-on rows -- the incremental
            online-update path.  Only solvers with ``supports_row_gate``
            accept it.

        Returns:
          An :class:`EngineProgram` ready for :func:`engines.drive`.

        Raises:
          ValueError: on a missing grid spec, a mesh / grid mismatch, an
            unsupported ``row_gate`` or a topology whose pod count does
            not divide P.
        """
        loss = get_loss(loss_name)
        cfg = cfg if cfg is not None else self.config_cls()
        if row_gate is not None and not self.supports_row_gate:
            raise ValueError(
                f"solver {self.name!r} has no incremental row-gate path; "
                "gated warm-started passes are a dual-solver feature "
                "(use 'd3ca')")
        gate_kw = {} if row_gate is None else {"row_gate": row_gate}
        cache = self._build_cache(loss_name, cfg, X, P, Q,
                                  row_gate is not None)
        w0, alpha0 = _unpack_warm_start(warm_start)
        grid = None
        if self.engine == "simulated":
            if mesh is not None:
                raise ValueError("engine='simulated' runs on one device; "
                                 "mesh= needs engine='shard_map', 'async' "
                                 "or 'overlap'")
            if P is None or Q is None:
                raise ValueError("engine='simulated' needs P and Q")
        else:
            grid = self._grid(mesh, P, Q)
            P, Q = grid.P, grid.Q
        pods = self.topology.pods if self.topology is not None else 1
        if pods > 1 and P % pods:
            raise ValueError(f"topology pods={pods} must divide P={P}")
        # the mesh engines cut the blocks on the host and hand each rank
        # its own; the grid engine cuts them on its device
        where = self.device if grid is None else "cpu"
        if self.block_format == "sparse":
            data = partition_sparse(X, y, P, Q, m_multiple=P * Q,
                                    device=where)
        else:
            if isinstance(X, CSRMatrix):
                X = X.toarray()   # CSR input under block_format="dense"
            data = partition(X, y, P, Q, m_multiple=P * Q, device=where)
        if grid is not None:
            return self._shard_map_program(loss, data, cfg, w0, alpha0,
                                           grid, **gate_kw)
        return self._simulated_program(loss, data, cfg, w0, alpha0,
                                       cache=cache, **gate_kw)

    def _grid(self, mesh, P, Q):
        """The process grid of a mesh engine: ``mesh`` (checked against P
        and Q) or the memoized P x Q grid on the solver's device."""
        from ..launch.mesh import grid_for
        return grid_for(mesh, P, Q, device=self.device, engine=self.engine)

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

        Under an adaptive :class:`CompressionSchedule` the solve runs as
        a sequence of warm-started stages -- one program build per codec
        stage, advanced when the convergence metric's log10 slope
        flattens below the schedule's ``slope_tol`` -- and the merged
        history tags every entry with ``stage`` and ``codec``.

        Args:
          loss_name, X, y, P, Q, cfg, warm_start: see :meth:`program`.
          tol: early-stopping tolerance (None disables early stopping).
          f_star: reference optimum enabling the ``rel_opt`` history
            field and rel-opt early stopping.
          record_history: collect per-iteration history entries.
          callback: ``callback(t, w, alpha)`` per outer iteration.
          tracer: a :class:`repro_torch.obs.Tracer`; the solve emits the
            spans ``solve > data_prep / calibrate / outer_iter > step /
            observe``, and ``local_solve`` plus one ``comm/<name>`` per
            declared collective inside every measured step.
          registry: a :class:`repro_torch.obs.Registry` receiving the
            ``solver/*`` metrics (``iters``, ``objective``,
            ``duality_gap``, ``rel_opt``, ``step_s``, ``local_s``,
            ``comm_s``, ``host_s``, ``comm_bytes``) and, under a stateful
            codec, ``compress/ef_norm/<name>`` and
            ``compress/codec_s/<name>``, labelled ``{solver, engine}``.
            A tracer or a registry switches the solve to its timed path:
            the phase split is calibrated on the program (``2 * (1 +
            3)`` extra steps from the initial state), every step waits for
            the device, and the history gains ``step_s`` / ``local_s`` /
            ``comm_s`` / ``host_s``; the iterates are bitwise those of
            the untimed solve.
          monitor: a :class:`repro_torch.obs.HealthMonitor` polled once per
            outer iteration.
          row_gate: see :meth:`program`.

        Returns:
          A :class:`SolveResult` whose ``w`` / ``alpha`` are tensors on
          the solver's device.
        """
        cfg = cfg if cfg is not None else self.config_cls()
        common = dict(P=P, Q=Q, mesh=mesh, tol=tol, f_star=f_star,
                      record_history=record_history, callback=callback,
                      tracer=tracer, registry=registry, monitor=monitor,
                      row_gate=row_gate)
        sched = self.compression
        if not isinstance(sched, CompressionSchedule):
            res, _ = self._solve_stage(loss_name, X, y, cfg=cfg,
                                       warm_start=warm_start, **common)
            return res
        history: List[Dict[str, float]] = []
        warm = warm_start
        iters_done = 0
        time_off, bytes_off = 0.0, 0
        res = None
        try:
            for si in range(len(sched.stages)):
                remaining = cfg.outer_iters - iters_done
                if remaining <= 0:
                    break
                self._stage = si
                last = si == len(sched.stages) - 1
                res, advanced = self._solve_stage(
                    loss_name, X, y,
                    cfg=dataclasses.replace(cfg, outer_iters=remaining),
                    warm_start=warm, advance=None if last else sched,
                    iter_offset=iters_done, time_offset=time_off,
                    bytes_offset=bytes_off, stage=si, **common)
                history.extend(res.history)
                iters_done += res.iters
                if res.history:
                    time_off = res.history[-1]["time_s"]
                    bytes_off = res.history[-1].get("comm_bytes", bytes_off)
                warm = res
                if res.converged or not advanced:
                    break
        finally:
            self._stage = 0
        return dataclasses.replace(res, history=history, iters=iters_done,
                                   compression=sched.spec)

    def update(self, loss_name: str, X, y, *, touched, warm_start,
               P: int = None, Q: int = None, cfg=None, mesh=None,
               passes: int = 1, tracer=None, registry=None, monitor=None,
               record_history: bool = True) -> SolveResult:
        """Incremental-update entry point for the online service.

        Runs ``passes`` warm-started outer iterations in which dual
        updates are restricted to the ``touched`` rows; every other row's
        alpha is frozen, but the primal-dual map still sums the full
        dual, so the returned ``w`` is exact for the whole buffer.  The
        gate is built on the solver's device, and the program cache is
        on for the call: the observation buffer has a constant shape by
        design.

        Args:
          loss_name, X, y, P, Q, cfg: see :meth:`solve`.  ``X`` is the
            full observation buffer (a tensor, ideally already on the
            solver's device, or a :class:`CSRMatrix` under
            ``block_format="sparse"``).
          touched: integer row indices that may move their dual.
          warm_start: the previous iterates (required -- an incremental
            update without a warm start is just a truncated cold solve).
          passes: warm-started outer iterations over the touched rows.

        Returns:
          A :class:`SolveResult` whose ``w``/``alpha`` fold the new
          observations into the previous model.

        Raises:
          ValueError: when this solver has no row-gate path
            (``supports_row_gate`` is False) or ``warm_start`` is None.
        """
        if warm_start is None:
            raise ValueError("incremental update needs warm_start=(w, "
                             "alpha); for a cold model run solve()")
        rows = torch.as_tensor(np.asarray(touched, dtype=np.int64),
                               device=self.device)
        gate = torch.zeros((X.shape[0],), dtype=DTYPE, device=self.device)
        gate[rows] = 1.0
        cfg = cfg if cfg is not None else self.config_cls()
        cfg = dataclasses.replace(cfg, outer_iters=int(passes))
        prev_cache = self.program_cache
        self.program_cache = True
        try:
            return self.solve(loss_name, X, y, P=P, Q=Q, cfg=cfg, mesh=mesh,
                              warm_start=warm_start, row_gate=gate,
                              tracer=tracer, registry=registry,
                              monitor=monitor,
                              record_history=record_history)
        finally:
            self.program_cache = prev_cache

    def _solve_stage(self, loss_name: str, X, y, *, P, Q, cfg, mesh,
                     warm_start, tol, f_star, record_history, callback,
                     tracer, registry, monitor, row_gate, advance=None,
                     iter_offset: int = 0, time_offset: float = 0.0,
                     bytes_offset: int = 0, stage: Optional[int] = None):
        """One program build + outer loop.  Returns ``(result,
        advanced)`` where ``advanced`` reports an adaptive-schedule stage
        switch (``advance.should_advance`` fired on the observed
        convergence metric; the result is then a warm-start point, not a
        converged solve).  A tracer or a registry takes the timed path
        (see :meth:`solve`); without both the loop is the untimed one."""
        tr = as_tracer(tracer)
        with tr.span("solve", loss=loss_name, solver=self.name,
                     engine=self.engine):
            reg = registry
            timed = tr.enabled or reg is not None
            loss = get_loss(loss_name)
            policy = self.active_policy
            labels = {"solver": self.name, "engine": self.engine}
            with tr.span("data_prep"):
                # the objective is evaluated on the device, against the same
                # data the blocks were cut from (a CSR matrix stays one: its
                # products run on the device of the vector)
                if not isinstance(X, CSRMatrix):
                    X = as_tensor(X, self.device)
                y = as_tensor(y, self.device)
                prog = self.program(loss_name, X, y, P=P, Q=Q, cfg=cfg,
                                    mesh=mesh, warm_start=warm_start,
                                    row_gate=row_gate)
            split = None
            if timed:
                with tr.span("calibrate"):
                    split = calibrate_phases(prog)
                if policy is not None:
                    # the codec codes the cells this process holds: all
                    # of them on the grid engine, one on a process grid
                    cells = (P, Q) if self.engine == "simulated" else (1, 1)
                    codec_s = bench_codecs(policy, prog.comm_bytes or {},
                                           grid=cells, device=self.device)
                    for cname, secs in codec_s.items():
                        if reg is not None:
                            reg.gauge(f"compress/codec_s/{cname}",
                                      **labels).set(secs)
                    if codec_s:
                        tr.instant("codec_bench", **codec_s)
            lam = cfg.lam
            history: List[Dict[str, float]] = []
            need_obs = (record_history or callback is not None
                        or tol is not None or advance is not None)
            prev_f = [None]
            advanced = [False]
            metric_vals: List[float] = []
            bytes_per_step = (prog.comm_bytes or {}).get("bytes_per_step")
            t0 = time.perf_counter()
            last_phase: Dict[str, float] = {}

            def on_step(t, t_begin, step_s):
                last_phase.clear()
                last_phase["step_s"] = step_s
                if split is not None:
                    att = split.attribute(step_s)
                    last_phase["local_s"] = att["local_s"]
                    last_phase["comm_s"] = att["comm_s"]
                    for key in ("comm_exposed_s", "comm_hidden_s"):
                        if key in att:
                            last_phase[key] = att[key]
                    tr.record("local_solve", t_begin, att["local_s"], iter=t)
                    off = t_begin + att["local_s"]
                    for name, secs in att["collectives"].items():
                        tr.record(f"comm/{name}", off, secs, iter=t)
                        off += secs
                if reg is not None:
                    reg.histogram("solver/step_s", **labels).observe(step_s)
                    if split is not None:
                        reg.histogram("solver/local_s", **labels).observe(
                            last_phase["local_s"])
                        reg.histogram("solver/comm_s", **labels).observe(
                            last_phase["comm_s"])
                        if "comm_exposed_s" in last_phase:
                            reg.histogram("solver/comm_exposed_s",
                                          **labels).observe(
                                last_phase["comm_exposed_s"])
                    if bytes_per_step is not None:
                        reg.counter("solver/comm_bytes", **labels).inc(
                            bytes_per_step)

            def observe(t, state):
                if not need_obs:
                    return False
                th0 = time.perf_counter()
                w = prog.w_of(state)
                alpha = prog.alpha_of(state) if prog.alpha_of else None
                f = float(loss.objective(X, y, w, lam))
                entry = {"iter": t + iter_offset,
                         "time_s": time.perf_counter() - t0 + time_offset,
                         "objective": f}
                if stage is not None:
                    entry["stage"] = stage
                    entry["codec"] = (policy.spec if policy is not None
                                      else None)
                if timed:
                    entry.update(last_phase)
                if bytes_per_step is not None:
                    # cumulative bytes-on-wire after t outer steps (every
                    # declared collective runs once per step)
                    entry["comm_bytes"] = bytes_offset + bytes_per_step * t
                if alpha is not None:
                    entry["duality_gap"] = float(
                        f - loss.dual_objective(X, y, alpha, lam))
                if f_star is not None:
                    entry["rel_opt"] = float(rel_opt(f, f_star))
                if timed:
                    # the objective / gap / rel_opt evaluation: host phase
                    entry["host_s"] = time.perf_counter() - th0
                if reg is not None:
                    record_metrics(reg, labels, entry, prog, state)
                    if self.staleness > 0:
                        # filled FIFO slots / ring capacity (the rings are
                        # seeded full at t = 1, so occupancy ramps once)
                        reg.gauge("async/ring_occupancy", **labels).set(
                            min(t, self.staleness) / self.staleness)
                if record_history:
                    history.append(entry)
                if callback is not None:
                    callback(t + iter_offset, w, alpha)
                stop = False
                if tol is not None:
                    if f_star is not None:
                        stop = entry["rel_opt"] < tol
                    elif "duality_gap" in entry:
                        stop = entry["duality_gap"] < tol
                    elif prev_f[0] is not None:
                        stop = abs(f - prev_f[0]) <= tol * max(1.0, abs(f))
                prev_f[0] = f
                if advance is not None and not stop:
                    metric_vals.append(entry.get("rel_opt", f))
                    if advance.should_advance(metric_vals):
                        advanced[0] = True
                        stop = True
                return stop

            state, iters, stopped = drive(
                prog, cfg.outer_iters, observe,
                tracer=tr if tr.enabled else None,
                on_step=on_step if timed else None, monitor=monitor)
            res = SolveResult(
                w=prog.w_of(state),
                alpha=prog.alpha_of(state) if prog.alpha_of else None,
                history=history, iters=iters,
                converged=stopped and not advanced[0],
                solver=self.name, engine=self.engine,
                local_backend=self.local_backend,
                block_format=self.block_format, device=str(self.device),
                staleness=self.staleness,
                compression=policy.spec if policy is not None else None,
                topology=self.topology_spec, comm_bytes=prog.comm_bytes)
            if prog.close is not None:
                prog.close()     # a process grid's session: collect
            return res, advanced[0]


def record_metrics(reg, labels, entry, prog, state):
    """One observed iteration into the registry: ``solver/iters``, the
    objective / gap / rel_opt gauges, the ``host_s`` histogram and the
    error-feedback norms, every value a Python float."""
    reg.counter("solver/iters", **labels).inc()
    reg.gauge("solver/objective", **labels).set(entry["objective"])
    if "duality_gap" in entry:
        reg.gauge("solver/duality_gap", **labels).set(entry["duality_gap"])
    if "rel_opt" in entry:
        reg.gauge("solver/rel_opt", **labels).set(entry["rel_opt"])
    if "host_s" in entry:
        reg.histogram("solver/host_s", **labels).observe(entry["host_s"])
    if prog.ef_of is not None:
        for cname, buf in prog.ef_of(state).items():
            reg.gauge(f"compress/ef_norm/{cname}", **labels).set(
                float(torch.linalg.vector_norm(buf)))


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
      KeyError: for an unregistered name (the message lists what IS
        registered).
    """
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown solver {name!r}; available: "
                       f"{available_solvers()}") from None


def available_solvers():
    """Sorted names of every registered solver
    (``["admm", "d3ca", "radisa", "sfk"]``)."""
    return sorted(_REGISTRY)


@register_solver
class D3CASolver(Solver):
    name = "d3ca"
    config_cls = D3CAConfig
    has_dual = True
    supports_row_gate = True                   # incremental online updates

    def _simulated_program(self, loss, data, cfg, w0, alpha0,
                           row_gate=None, cache=None):
        return d3ca_simulated_program(loss, data, cfg,
                                      local_backend=self.local_backend,
                                      w0=w0, alpha0=alpha0,
                                      index_source=self.index_source,
                                      row_gate=row_gate, cache=cache,
                                      **self._comm_kw())

    def _shard_map_program(self, loss, data, cfg, w0, alpha0, grid,
                           row_gate=None):
        return d3ca_shard_map_program(loss, data, cfg, grid,
                                      local_backend=self.local_backend,
                                      w0=w0, alpha0=alpha0,
                                      index_source=self.index_source,
                                      row_gate=row_gate, **self._mesh_kw())


@register_solver
class RADiSASolver(Solver):
    name = "radisa"
    config_cls = RADiSAConfig

    def _simulated_program(self, loss, data, cfg, w0, alpha0, cache=None):
        return radisa_simulated_program(loss, data, cfg,
                                        local_backend=self.local_backend,
                                        w0=w0,
                                        index_source=self.index_source,
                                        cache=cache, **self._comm_kw())

    def _shard_map_program(self, loss, data, cfg, w0, alpha0, grid):
        return radisa_shard_map_program(loss, data, cfg, grid,
                                        local_backend=self.local_backend,
                                        w0=w0,
                                        index_source=self.index_source,
                                        **self._mesh_kw())


@register_solver
class SFKSolver(Solver):
    """Stochastic Fang--Klabjan sampling scheme (arXiv 1803.11287): a
    primal solver whose outer iteration subsamples the observations --
    minibatch anchor gradients plus variance-reduced local steps on the
    sampled rows only (see :mod:`repro_torch.core.sfk`)."""
    name = "sfk"
    config_cls = SFKConfig

    def _simulated_program(self, loss, data, cfg, w0, alpha0, cache=None):
        return sfk_simulated_program(loss, data, cfg,
                                     local_backend=self.local_backend,
                                     w0=w0, index_source=self.index_source,
                                     cache=cache, **self._comm_kw())

    def _shard_map_program(self, loss, data, cfg, w0, alpha0, grid):
        return sfk_shard_map_program(loss, data, cfg, grid,
                                     local_backend=self.local_backend,
                                     w0=w0, index_source=self.index_source,
                                     **self._mesh_kw())


@register_solver
class ADMMSolver(Solver):
    """Block-splitting ADMM, the paper's baseline (see
    :mod:`repro_torch.core.admm`).  Its inner solve is a cached Cholesky:
    ``local_backend`` is accepted and ignored, and it draws no indices."""
    name = "admm"
    config_cls = ADMMConfig

    def _simulated_program(self, loss, data, cfg, w0, alpha0, cache=None):
        return admm_simulated_program(loss, data, cfg, w0=w0, cache=cache,
                                      **self._comm_kw())

    def _shard_map_program(self, loss, data, cfg, w0, alpha0, grid):
        return admm_shard_map_program(loss, data, cfg, grid, w0=w0,
                                      **self._mesh_kw())

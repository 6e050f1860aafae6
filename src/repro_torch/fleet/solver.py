"""FleetSolver: T tenants, one program, per-tenant results.

Packs a shape bucket of :class:`~repro_torch.fleet.batch.FleetProblem`\\ s
into tenant-major tensors (:func:`~repro_torch.fleet.batch.stack_grid`:
the tenant axis right after the grid axes of every array), builds the
solver's ``per_problem=True`` cell program behind
:func:`~repro_torch.fleet.batch.fleet_cell_program`'s ``active`` mask,
and drives it through the *existing* executors: the single-device grid
(:func:`~repro_torch.core.engines.grid_program`, ``engine="simulated"``)
or a process grid of P x Q ranks, one block of every tenant per rank
(:func:`~repro_torch.core.engines.bind_mesh_program`,
``engine="shard_map"``, alias ``"sync"``).  One outer step of the batch
reduces every collective once and launches each solver kernel once for
all T x P x Q cells -- on the mesh, once per rank for its T cells --,
each cell with its tenant's ``lam``, ``n`` (and D3CA's ``beta``) as
per-cell scalars.

Per-tenant semantics preserved relative to a solo
:meth:`repro_torch.core.solver.Solver.solve` of the same problem:

  * block extents, padding and every index draw are identical (the
    bucket key uses the framework's natural padded shapes, and each
    tenant draws from its own index source, seeded by its own ``seed``;
    a rank of the mesh draws its cell of every tenant's streams);
  * ``lam_t`` / ``n_t`` ride through the data tuple as float32 tensors
    instead of Python numbers, so per-tenant results are bit-identical
    to the solo solve exactly when the products the solo path forms in
    double precision (``lam * n``, ``n * sample_frac``, ``rho * n``) are
    powers of two, and agree to float tolerance otherwise;
  * converged tenants are frozen *exactly* (state carried through
    ``torch.where``) at segment boundaries (every ``check_every`` outer
    iterations), and warm starts accept the same
    ``SolveResult | (w, alpha) | w`` forms as the solo API.

On the mesh every tenant is partitioned on the host, as a solo mesh
solve is, and each rank receives its cell of the stacked blocks once per
batch; the ``active`` mask reaches the ranks by the grid's DATA command
when it changes (at a segment boundary); ADMM factors each tenant's
normal matrix on the ranks with that tenant's ``lam``
(:func:`~repro_torch.fleet.batch.admm_setup_tenants`).  The async and
overlap engines, staleness, compression and topology carry per-build
state with no tenant axis and are rejected with ``ValueError``, as in
the reference.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.admm import admm_setup_simulated
from repro_torch.core.engines import bind_mesh_program, grid_program
from repro_torch.core.indices import GeneratorIndexSource, TenantIndexSource
from repro_torch.core.local import LOCAL_BACKENDS
from repro_torch.core.losses import get_loss
from repro_torch.core.partition import (SparseDoublyPartitioned, partition,
                                        partition_sparse)
from repro_torch.core.radisa import _check_subblocks
from repro_torch.core.reference import rel_opt
from repro_torch.core.solver import (BLOCK_FORMATS, ENGINE_ALIASES,
                                     SolveResult, _unpack_warm_start,
                                     get_solver)
from repro_torch.core.util import as_tensor, resolve_device
from repro_torch.data.sparse import CSRMatrix
from repro_torch.launch.mesh import grid_for
from repro_torch.obs.trace import as_tracer

from .batch import (FleetProblem, bucket_key, stack_grid,
                    tenant_cell_program)

#: engines the fleet path supports (``"sync"`` aliases ``"shard_map"``)
FLEET_ENGINES = ("simulated", "shard_map")
FLEET_SOLVERS = ("d3ca", "radisa", "sfk", "admm")
BLOCKS, ROWS, COLS, TENANTS = ("data", "model"), ("data",), ("model",), ()


@dataclasses.dataclass
class FleetProgram:
    """One packed batch, ready to drive: ``step(t, active, state)``
    advances every tenant whose ``active`` entry is 1 by one outer
    iteration (``active`` a (T,) float tensor on the device);
    ``unpack(state) -> (ws, alphas | None)`` gives each tenant's global
    iterates; ``close()``, set on a process grid's program, ends the
    grid's session (``solve_batch`` calls it when the batch is done)."""

    step: Callable[[int, torch.Tensor, Any], Any]
    state: Any
    unpack: Callable[[Any], Any]
    n_tenants: int
    close: Optional[Callable[[], Any]] = None


class FleetSolver:
    """Batched multi-tenant solves over one P x Q grid.

    Args:
      solver: one of ``d3ca | radisa | sfk | admm``.
      engine: ``simulated`` (the single-device grid) or ``shard_map`` /
        ``sync`` (a process grid of P x Q ranks, one block of every
        tenant per rank).
      local_backend, block_format, device: as in
        :class:`repro_torch.core.solver.Solver`; the default device is the
        card, and without one the constructor raises.
      staleness, compression, topology, overlap: rejected (see the module
        docstring).
      mesh: the :class:`repro_torch.launch.mesh.ProcessGrid` of the mesh
        engine; by default the memoized P x Q grid on the solver's device
        (``process_grid``).
    """

    def __init__(self, solver: str = "d3ca", engine: str = "simulated",
                 local_backend: str = "kernel", block_format: str = "dense",
                 staleness: int = 0, compression=None, topology=None,
                 overlap: bool = False, *, device="cuda", mesh=None):
        if solver not in FLEET_SOLVERS:
            raise ValueError(f"solver={solver!r}; expected one of "
                             f"{FLEET_SOLVERS}")
        engine = ENGINE_ALIASES.get(engine, engine)
        if engine not in FLEET_ENGINES:
            raise ValueError(
                f"engine={engine!r}: the fleet path runs the simulated "
                f"grid or the synchronous mesh ({FLEET_ENGINES}); "
                "async/overlap programs carry per-build ring state that "
                "cannot hold a tenant axis")
        if staleness:
            raise ValueError("fleet solves are synchronous; staleness="
                             f"{staleness} is not supported")
        if compression is not None or topology is not None or overlap:
            raise ValueError("fleet solves do not support compression, "
                             "topology or overlap: their error-feedback/"
                             "ring buffers are per-build device state "
                             "with no tenant axis")
        if mesh is not None and engine == "simulated":
            raise ValueError("engine='simulated' runs on one device; mesh= "
                             "needs engine='shard_map'")
        if local_backend not in LOCAL_BACKENDS:
            raise ValueError(f"local_backend={local_backend!r}; expected "
                             f"one of {LOCAL_BACKENDS}")
        if block_format not in BLOCK_FORMATS:
            raise ValueError(f"block_format={block_format!r}; expected "
                             f"one of {BLOCK_FORMATS}")
        self.solver = solver
        self.engine = engine
        self.local_backend = local_backend
        self.block_format = block_format
        #: raises here, at construction, when the card is asked for and
        #: there is none
        self.device = resolve_device(device)
        self.mesh = mesh

    # ------------------------------------------------------------------
    # shared pieces
    # ------------------------------------------------------------------

    def _config(self, cfg):
        return cfg if cfg is not None else get_solver(self.solver).config_cls()

    @staticmethod
    def _repad_k(part: SparseDoublyPartitioned, k: int):
        """Zero-pad a sparse part's ELL slot axis to a common k.

        Padding slots are (col=0, val=0.0): every consumer gathers (reads
        of w[0] scaled by 0.0) or scatter-ADDs (zero increments), so a
        larger k never changes a result bit.
        """
        if part.k == k:
            return part
        pad = (0, k - part.k)
        return dataclasses.replace(
            part, cols=torch.nn.functional.pad(part.cols, pad),
            vals=torch.nn.functional.pad(part.vals, pad))

    def _index_source(self, problems, cfg, P, Q, n_p):
        """Each tenant's own source (its ``index_source``, or a generator
        seeded from its ``seed`` as a solo solve of it would build one),
        stacked on the tenant axis."""
        return TenantIndexSource([
            p.index_source if p.index_source is not None
            else GeneratorIndexSource(
                p.seed, P=P, Q=Q, n_p=n_p,
                steps=getattr(cfg, "local_steps", None) or n_p,
                L=getattr(cfg, "L", None) or n_p,
                sample_frac=getattr(cfg, "sample_frac", 0.5),
                device=self.device)
            for p in problems])

    # ------------------------------------------------------------------
    # grid packing
    # ------------------------------------------------------------------

    def program(self, problems: Sequence[FleetProblem], *, P: int, Q: int,
                cfg=None, warm_starts: Optional[Sequence] = None
                ) -> FleetProgram:
        """Pack one shape bucket into a :class:`FleetProgram`: every tenant
        partitioned as its solo solve would be (on the solver's device for
        the grid engine, on the host for the mesh), the blocks stacked once
        (tenant axis after the grid axes), the per-tenant scalars ``lam
        (T,)`` / ``n (T,)`` and -- for ADMM -- each tenant's Cholesky
        factors alongside (on the mesh, made by the ranks at setup)."""
        problems = list(problems)
        keys = {bucket_key(p, P, Q) for p in problems}
        if len(keys) != 1:
            raise ValueError(
                f"a fleet batch got {len(keys)} shape buckets "
                f"{sorted(keys)}; pack one bucket per batch "
                "(FleetScheduler does this)")
        cfg = self._config(cfg)
        loss = get_loss(problems[0].loss_name)
        T = len(problems)
        warm = list(warm_starts) if warm_starts is not None else [None] * T
        if len(warm) != T:
            raise ValueError(f"warm_starts has {len(warm)} entries for "
                             f"{T} problems")
        w0s, a0s = zip(*[_unpack_warm_start(w) for w in warm])
        grid = (grid_for(self.mesh, P, Q, device=self.device,
                         engine=self.engine)
                if self.engine == "shard_map" else None)
        # the mesh cuts the blocks on the host and hands each rank its own
        dev = self.device if grid is None else torch.device("cpu")
        sparse = self.block_format == "sparse"
        if sparse:
            parts = [partition_sparse(p.X, p.y, P, Q, m_multiple=P * Q,
                                      device=dev) for p in problems]
            kmax = max(pt.k for pt in parts)
            parts = [self._repad_k(pt, kmax) for pt in parts]
            x_st = (stack_grid([pt.cols for pt in parts], BLOCKS),
                    stack_grid([pt.vals for pt in parts], BLOCKS))
        else:
            parts = [partition(p.X.toarray() if isinstance(p.X, CSRMatrix)
                               else p.X, p.y, P, Q, m_multiple=P * Q,
                               device=dev) for p in problems]
            x_st = (stack_grid([pt.x_blocks for pt in parts], BLOCKS),)
        y_st = stack_grid([pt.y_blocks for pt in parts], ROWS)
        mask_st = stack_grid([pt.mask for pt in parts], ROWS)
        lam_arr = torch.tensor([float(p.lam) for p in problems],
                               dtype=torch.float32, device=dev)
        n_arr = torch.tensor([float(pt.n) for pt in parts],
                             dtype=torch.float32, device=dev)
        n_p, m_q = parts[0].n_p, parts[0].m_q
        if self.solver in ("radisa", "sfk"):
            _check_subblocks(m_q, P, self.solver == "radisa"
                             and cfg.variant == "avg")
        w_st = stack_grid([torch.zeros((Q, m_q), device=dev) if w is None
                           else pt.w_to_blocks(w)
                           for pt, w in zip(parts, w0s)], COLS)
        source = (None if self.solver == "admm" else
                  self._index_source(problems, cfg, P, Q, n_p))
        cell_kw = dict(solver=self.solver, loss=loss, cfg=cfg, n=parts[0].n,
                       m_q=m_q, sparse=sparse,
                       local_backend=self.local_backend)
        x_specs = (BLOCKS,) * len(x_st)
        if self.solver == "d3ca":
            data_core = (*x_st, y_st, mask_st, lam_arr, n_arr)
            specs = (*x_specs, ROWS, ROWS, TENANTS, TENANTS)
            a_st = stack_grid([torch.zeros((P, n_p), device=dev)
                               if a is None else pt.alpha_to_blocks(a)
                               for pt, a in zip(parts, a0s)], ROWS)
            state, state_specs = (a_st, w_st), (ROWS, COLS)
        elif self.solver == "admm":
            zeros_su = torch.zeros((P, Q, T, n_p), device=dev)
            state = (zeros_su, zeros_su.clone(), w_st)
            state_specs = (BLOCKS, BLOCKS, COLS)
            if grid is None:
                chol_st = stack_grid([admm_setup_simulated(
                    pt, dataclasses.replace(cfg, lam=p.lam))
                    for pt, p in zip(parts, problems)], COLS)
                data_core = (*x_st, y_st, mask_st, chol_st, n_arr)
            else:
                # the factors are made on the ranks (admm_setup_tenants)
                data_core = (*x_st, y_st, mask_st, n_arr)
                specs = (*x_specs, ROWS, ROWS, TENANTS)
        else:
            data_core = (*x_st, y_st, mask_st, lam_arr, n_arr)
            specs = (*x_specs, ROWS, ROWS, TENANTS, TENANTS)
            state, state_specs = w_st, COLS
        # the per-tenant blocks are in the stacked tensors now: keep only
        # what unpacking needs
        sizes = [(pt.n, pt.m) for pt in parts]
        del parts

        def unpack_blocks(w_b, am):
            ws = [w_b[:, i].reshape(-1)[:m] for i, (_, m) in enumerate(sizes)]
            if am is None:
                return ws, None
            return ws, [am[:, i].reshape(-1)[:n]
                        for i, (n, _) in enumerate(sizes)]

        def w_blocks(st):
            return st[1] if self.solver == "d3ca" else (
                st[2] if self.solver == "admm" else st)

        if grid is None:
            gstep = grid_program(tenant_cell_program(index_source=source,
                                                     **cell_kw),
                                 P, Q, device=dev)

            def unpack(st):
                return unpack_blocks(
                    w_blocks(st),
                    st[0] * mask_st if self.solver == "d3ca" else None)

            return FleetProgram(
                step=lambda t, active, st: gstep(t, (active, *data_core),
                                                 st),
                state=state, unpack=unpack, n_tenants=T)

        active0 = torch.ones((T,))
        setup = {}
        if self.solver == "admm":
            setup = dict(setup="repro_torch.fleet.batch:admm_setup_tenants",
                         setup_kw=dict(cfg=cfg, m_q=m_q, sparse=sparse,
                                       lams=[float(p.lam) for p in problems]))
        prog = bind_mesh_program(
            grid, make_cell="repro_torch.fleet.batch:tenant_cell_program",
            cell_kw=cell_kw, index_source=source,
            data=(active0, *data_core), data_specs=(TENANTS, *specs),
            data_names=("active",), state0=state, state_specs=state_specs,
            w_of=w_blocks,
            alpha_of=((lambda st: st[0] * mask_st)
                      if self.solver == "d3ca" else None), **setup)
        # what the ranks' ``active`` holds: sent again only when it changes
        sent = {"obj": None, "value": active0}

        def step(t, active, st):
            if active is not sent["obj"]:
                host = active.detach().to("cpu", copy=True)
                if not torch.equal(host, sent["value"]):
                    prog.set_data("active", host)
                sent.update(obj=active, value=host)
            return prog.step(t, st)

        def unpack(st):
            return unpack_blocks(prog.w_of(st), prog.alpha_of(st)
                                 if prog.alpha_of is not None else None)

        return FleetProgram(step=step, state=prog.state, unpack=unpack,
                            n_tenants=T, close=prog.close)

    # ------------------------------------------------------------------
    # the batched drive loop
    # ------------------------------------------------------------------

    def solve_batch(self, problems: Sequence[FleetProblem], *,
                    P: int, Q: int, cfg=None,
                    tol: Optional[float] = None, check_every: int = 5,
                    warm_starts: Optional[Sequence] = None,
                    record_history: bool = True,
                    tracer=None, registry=None) -> List[SolveResult]:
        """Solve every problem of one shape bucket in a single batched run.

        Args:
          problems: tenants of ONE shape bucket (same loss, same padded
            shapes -- :func:`~repro_torch.fleet.batch.bucket_key`); mixed
            shapes go through
            :class:`~repro_torch.fleet.scheduler.FleetScheduler`.
          P, Q: the block grid.
          cfg: the shared solver config; its ``lam`` (and ``seed``) are
            overridden per tenant by each problem's values.
          tol: per-tenant early stopping, evaluated every
            ``check_every`` outer iterations with the solo ``Solver.solve``'s
            metric preference (rel_opt vs ``f_star``, duality gap,
            relative objective change).  Converged tenants freeze
            exactly; the batch stops early when all are frozen.
          check_every: segment length between convergence checks.
          warm_starts: optional per-tenant ``SolveResult | (w, alpha) |
            w`` (None entries cold-start).
          record_history: collect per-tenant history entries at segment
            boundaries.
          tracer / registry: :mod:`repro_torch.obs` hooks -- spans
            ``fleet/pack`` (program build), ``fleet/step`` (each segment
            of outer steps between convergence checks) and
            ``fleet/unpack``; gauges ``fleet/tenants``, ``fleet/active``
            and per-tenant ``fleet/rel_opt``.  Neither waits for the
            device: a ``fleet/step`` span covers the launches of its
            segment, and the objective evaluation that follows it waits.

        Returns:
          One :class:`~repro_torch.core.solver.SolveResult` per problem,
          in input order, its ``w`` / ``alpha`` tensors on the device.
        """
        problems = list(problems)
        if not problems:
            return []
        tr = as_tracer(tracer)
        reg = registry
        labels = {"solver": self.solver, "engine": self.engine}
        cfg = self._config(cfg)
        loss = get_loss(problems[0].loss_name)
        check_every = max(1, int(check_every))
        T, dev = len(problems), self.device
        with tr.span("fleet/pack", tenants=T, **labels):
            # as a solo ``Solver.solve`` does: each tenant's data goes to
            # the device once, is partitioned there, and the objective is
            # evaluated on it (a CSR matrix stays one)
            problems = [dataclasses.replace(
                p, X=p.X if isinstance(p.X, CSRMatrix)
                else as_tensor(p.X, dev), y=as_tensor(p.y, dev))
                for p in problems]
            prog = self.program(problems, P=P, Q=Q, cfg=cfg,
                                warm_starts=warm_starts)
        if reg is not None:
            reg.gauge("fleet/tenants", **labels).set(T)
        Xs = [p.X for p in problems]
        ys = [p.y for p in problems]

        # on the host: the segment's mask is made from it once per
        # segment, so reading it never waits for the device
        active = np.ones((T,), np.float32)
        conv = [False] * T
        iters = [0] * T
        hist: List[List[Dict[str, float]]] = [[] for _ in range(T)]
        prev_f: List[Optional[float]] = [None] * T
        state = prog.state
        outer = cfg.outer_iters
        # with no early stopping and no history there is nothing to
        # observe between segments: run the whole batch in one stretch
        observe = tol is not None or record_history
        t = 0
        t0 = time.perf_counter()
        while t < outer:
            seg_end = outer if not observe else min(t + check_every, outer)
            act = torch.tensor(active, device=dev)      # a copy
            with tr.span("fleet/step", t0=t + 1, t1=seg_end, **labels):
                while t < seg_end:
                    t += 1
                    state = prog.step(t, act, state)
            for i in range(T):
                if not conv[i]:
                    iters[i] = t
            if not observe:
                continue
            with tr.span("fleet/unpack", **labels):
                ws, alphas = prog.unpack(state)
            now = time.perf_counter() - t0
            for i, p in enumerate(problems):
                if conv[i]:
                    continue        # frozen: state is bit-preserved
                f = float(loss.objective(Xs[i], ys[i], ws[i], p.lam))
                entry = {"iter": t, "time_s": now, "objective": f}
                if alphas is not None:
                    entry["duality_gap"] = float(
                        f - loss.dual_objective(Xs[i], ys[i], alphas[i],
                                                p.lam))
                if p.f_star is not None:
                    entry["rel_opt"] = float(rel_opt(f, p.f_star))
                    if reg is not None:
                        reg.gauge("fleet/rel_opt", tenant=p.tenant_id,
                                  **labels).set(entry["rel_opt"])
                if record_history:
                    hist[i].append(entry)
                stop = False
                if tol is not None:
                    if "rel_opt" in entry:
                        stop = entry["rel_opt"] < tol
                    elif "duality_gap" in entry:
                        stop = entry["duality_gap"] < tol
                    elif prev_f[i] is not None:
                        stop = abs(f - prev_f[i]) <= tol * max(1.0, abs(f))
                prev_f[i] = f
                if stop:
                    conv[i] = True
                    active[i] = 0.0
            if reg is not None:
                reg.gauge("fleet/active", **labels).set(float(active.sum()))
            if tol is not None and not active.any():
                break

        ws, alphas = prog.unpack(state)
        if prog.close is not None:
            prog.close()        # a process grid's session: collect
        return [SolveResult(
            w=ws[i], alpha=alphas[i] if alphas is not None else None,
            history=hist[i], iters=iters[i], converged=conv[i],
            solver=self.solver, engine=self.engine,
            local_backend=self.local_backend,
            block_format=self.block_format, device=str(dev))
            for i in range(T)]

"""FleetSolver: T tenants, one program, per-tenant results.

Packs a shape bucket of :class:`~repro_torch.fleet.batch.FleetProblem`\\ s
into tenant-major tensors (:func:`~repro_torch.fleet.batch.stack_grid`:
the tenant axis right after the grid axes of every array), builds the
solver's ``per_problem=True`` cell program behind
:func:`~repro_torch.fleet.batch.fleet_cell_program`'s ``active`` mask,
and drives it through the *existing* grid executor
(:func:`~repro_torch.core.engines.grid_program`).  One outer step of the
batch reduces every collective once and launches each solver kernel once
for all T x P x Q cells, each cell with its tenant's ``lam``, ``n`` (and
D3CA's ``beta``) as per-cell scalars.

Per-tenant semantics preserved relative to a solo
:meth:`repro_torch.core.solver.Solver.solve` of the same problem:

  * block extents, padding and every index draw are identical (the
    bucket key uses the framework's natural padded shapes, and each
    tenant draws from its own index source, seeded by its own ``seed``);
  * ``lam_t`` / ``n_t`` ride through the data tuple as float32 tensors
    instead of Python numbers, so per-tenant results are bit-identical
    to the solo solve exactly when the products the solo path forms in
    double precision (``lam * n``, ``n * sample_frac``, ``rho * n``) are
    powers of two, and agree to float tolerance otherwise;
  * converged tenants are frozen *exactly* (state carried through
    ``torch.where``) at segment boundaries (every ``check_every`` outer
    iterations), and warm starts accept the same
    ``SolveResult | (w, alpha) | w`` forms as the solo API.

The fleet runs on the single-device grid engine (``engine="simulated"``).
The synchronous mesh of the reference (``"shard_map"`` / ``"sync"``) is
not ported for fleets yet (ROADMAP queue A item 12b, the mesh halves of
the multi-device engines); the async and
overlap engines, staleness, compression and topology carry per-build
state with no tenant axis and are rejected with ``ValueError``, as in the
reference.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch

from repro_torch.core.admm import admm_cell_program, admm_setup_simulated
from repro_torch.core.d3ca import d3ca_cell_program
from repro_torch.core.engines import grid_program
from repro_torch.core.indices import GeneratorIndexSource, TenantIndexSource
from repro_torch.core.local import LOCAL_BACKENDS
from repro_torch.core.losses import get_loss
from repro_torch.core.partition import (SparseDoublyPartitioned, partition,
                                        partition_sparse)
from repro_torch.core.radisa import _check_subblocks, radisa_cell_program
from repro_torch.core.reference import rel_opt
from repro_torch.core.sfk import sfk_cell_program
from repro_torch.core.solver import (BLOCK_FORMATS, SolveResult,
                                     _unpack_warm_start, get_solver,
                                     not_ported)
from repro_torch.core.util import as_tensor, resolve_device
from repro_torch.data.sparse import CSRMatrix
from repro_torch.obs.trace import as_tracer

from .batch import FleetProblem, bucket_key, fleet_cell_program, stack_grid

#: engines the fleet path runs on in the port
FLEET_ENGINES = ("simulated",)
FLEET_SOLVERS = ("d3ca", "radisa", "sfk", "admm")
#: the reference's synchronous mesh engine (and its alias): not ported for
#: fleets
MESH_ENGINES = ("shard_map", "sync")
BLOCKS, ROWS, COLS = ("data", "model"), ("data",), ("model",)


@dataclasses.dataclass
class FleetProgram:
    """One packed batch, ready to drive: ``step(t, active, state)``
    advances every tenant whose ``active`` entry is 1 by one outer
    iteration (``active`` a (T,) float tensor on the device);
    ``unpack(state) -> (ws, alphas | None)`` gives each tenant's global
    iterates."""

    step: Callable[[int, torch.Tensor, Any], Any]
    state: Any
    unpack: Callable[[Any], Any]
    n_tenants: int


class FleetSolver:
    """Batched multi-tenant solves over one P x Q grid.

    Args:
      solver: one of ``d3ca | radisa | sfk | admm``.
      engine: ``simulated`` (the single-device grid).
      local_backend, block_format, device: as in
        :class:`repro_torch.core.solver.Solver`; the default device is the
        card, and without one the constructor raises.
      staleness, compression, topology, overlap: rejected (see the module
        docstring).
    """

    def __init__(self, solver: str = "d3ca", engine: str = "simulated",
                 local_backend: str = "kernel", block_format: str = "dense",
                 staleness: int = 0, compression=None, topology=None,
                 overlap: bool = False, *, device="cuda"):
        if solver not in FLEET_SOLVERS:
            raise ValueError(f"solver={solver!r}; expected one of "
                             f"{FLEET_SOLVERS}")
        if engine not in FLEET_ENGINES + MESH_ENGINES:
            raise ValueError(
                f"engine={engine!r}: the fleet path runs the simulated "
                "grid or the synchronous mesh; async/overlap programs "
                "carry per-build ring state that cannot hold a tenant axis")
        if staleness:
            raise ValueError("fleet solves are synchronous; staleness="
                             f"{staleness} is not supported")
        if compression is not None or topology is not None or overlap:
            raise ValueError("fleet solves do not support compression, "
                             "topology or overlap: their error-feedback/"
                             "ring buffers are per-build device state "
                             "with no tenant axis")
        if engine in MESH_ENGINES:
            raise not_ported("engine", engine)
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

    def _cell_program(self, loss, cfg, source, *, n, m_q, P, sparse):
        kw = dict(n=n, m_q=m_q, index_source=source,
                  local_backend=self.local_backend, sparse=sparse,
                  per_problem=True)
        if self.solver == "d3ca":
            return d3ca_cell_program(loss, cfg, **kw)
        if self.solver == "radisa":
            _check_subblocks(m_q, P, cfg.variant == "avg")
            return radisa_cell_program(loss, cfg, **kw)
        if self.solver == "sfk":
            _check_subblocks(m_q, P, False)
            return sfk_cell_program(loss, cfg, **kw)
        return admm_cell_program(loss.name, cfg, n=n, m_q=m_q,
                                 sparse=sparse, per_problem=True)

    # ------------------------------------------------------------------
    # grid packing
    # ------------------------------------------------------------------

    def program(self, problems: Sequence[FleetProblem], *, P: int, Q: int,
                cfg=None, warm_starts: Optional[Sequence] = None
                ) -> FleetProgram:
        """Pack one shape bucket into a :class:`FleetProgram` on the
        solver's device: every tenant partitioned as its solo solve would
        be, the blocks stacked once (tenant axis after the grid axes), the
        per-tenant scalars ``lam (T,)`` / ``n (T,)`` and -- for ADMM --
        each tenant's Cholesky factors alongside."""
        problems = list(problems)
        keys = {bucket_key(p, P, Q) for p in problems}
        if len(keys) != 1:
            raise ValueError(
                f"a fleet batch got {len(keys)} shape buckets "
                f"{sorted(keys)}; pack one bucket per batch "
                "(FleetScheduler does this)")
        cfg = self._config(cfg)
        loss = get_loss(problems[0].loss_name)
        T, dev = len(problems), self.device
        warm = list(warm_starts) if warm_starts is not None else [None] * T
        if len(warm) != T:
            raise ValueError(f"warm_starts has {len(warm)} entries for "
                             f"{T} problems")
        w0s, a0s = zip(*[_unpack_warm_start(w) for w in warm])
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
        w_st = stack_grid([torch.zeros((Q, m_q), device=dev) if w is None
                           else pt.w_to_blocks(w)
                           for pt, w in zip(parts, w0s)], COLS)
        base = self._cell_program(
            loss, cfg, self._index_source(problems, cfg, P, Q, n_p),
            n=parts[0].n, m_q=m_q, P=P, sparse=sparse)
        if self.solver == "d3ca":
            data_core = (*x_st, y_st, mask_st, lam_arr, n_arr)
            a_st = stack_grid([torch.zeros((P, n_p), device=dev)
                               if a is None else pt.alpha_to_blocks(a)
                               for pt, a in zip(parts, a0s)], ROWS)
            state = (a_st, w_st)
        elif self.solver == "admm":
            chol_st = stack_grid([admm_setup_simulated(
                pt, dataclasses.replace(cfg, lam=p.lam))
                for pt, p in zip(parts, problems)], COLS)
            data_core = (*x_st, y_st, mask_st, chol_st, n_arr)
            zeros_su = torch.zeros((P, Q, T, n_p), device=dev)
            state = (zeros_su, zeros_su.clone(), w_st)
        else:
            data_core = (*x_st, y_st, mask_st, lam_arr, n_arr)
            state = w_st
        # the per-tenant blocks are in the stacked tensors now: keep only
        # what unpacking needs
        sizes = [(pt.n, pt.m) for pt in parts]
        del parts
        gstep = grid_program(fleet_cell_program(base), P, Q, device=dev)

        def unpack(st):
            w_b = st[1] if self.solver == "d3ca" else (
                st[2] if self.solver == "admm" else st)
            ws = [w_b[:, i].reshape(-1)[:m] for i, (_, m) in enumerate(sizes)]
            if self.solver != "d3ca":
                return ws, None
            am = st[0] * mask_st
            return ws, [am[:, i].reshape(-1)[:n]
                        for i, (n, _) in enumerate(sizes)]

        return FleetProgram(
            step=lambda t, active, st: gstep(t, (active, *data_core), st),
            state=state, unpack=unpack, n_tenants=T)

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

        active = torch.ones((T,), dtype=torch.float32, device=dev)
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
            with tr.span("fleet/step", t0=t + 1, t1=seg_end, **labels):
                while t < seg_end:
                    t += 1
                    state = prog.step(t, active, state)
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
                # counted on the host: reading ``active`` back would wait
                # for the device
                reg.gauge("fleet/active", **labels).set(
                    float(T - sum(conv)))
            if tol is not None and all(conv):
                break

        ws, alphas = prog.unpack(state)
        return [SolveResult(
            w=ws[i], alpha=alphas[i] if alphas is not None else None,
            history=hist[i], iters=iters[i], converged=conv[i],
            solver=self.solver, engine=self.engine,
            local_backend=self.local_backend,
            block_format=self.block_format, device=str(dev))
            for i in range(T)]

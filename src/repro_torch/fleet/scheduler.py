"""FleetScheduler: admission, shape bucketing, per-tenant unpacking.

The scheduler is the multi-tenant front door: tenants ``submit()``
problems of any shape; ``run()`` groups the queue into shape buckets
(:func:`~repro_torch.fleet.batch.bucket_key`), caps each batch at
``max_tenants``, drives every batch through one
:class:`~repro_torch.fleet.solver.FleetSolver` call, and hands back
results keyed by tenant id.  A per-tenant warm-start registry carries
each tenant's last iterates into its next submission (same semantics as
passing ``warm_start=previous_result`` to the solo API).
"""
from __future__ import annotations

import collections
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.core.solver import SolveResult

from .batch import FleetProblem, bucket_key
from .solver import FleetSolver


class FleetScheduler:
    """Admission queue + bucketed batched execution.

    Args:
      P, Q: the block grid every batch runs on.
      solver, engine, local_backend, block_format, device: forwarded to
        :class:`FleetSolver` (the default device is the card); on the
        mesh engines every bucket runs on the memoized P x Q process
        grid, and the buckets and the warm registry work as on the grid
        engine.
      cfg: shared solver config template (per-tenant ``lam`` / ``seed``
        come from each problem).
      tol, check_every: per-tenant convergence policy (see
        :meth:`FleetSolver.solve_batch`).
      max_tenants: cap on tenants per batched solve; a larger bucket is
        split into chunks of this size (None = unbounded).
      warm_registry: keep each tenant's last result and warm-start its
        next submission from it.
      on_result: optional callback ``on_result(tenant_id, result)``
        fired per tenant as each batch completes.
      tracer, registry: :mod:`repro_torch.obs` hooks, forwarded per
        batch; the scheduler adds per-bucket ``fleet/bucket_tenants``
        gauges.
      monitor: a :class:`repro_torch.obs.HealthMonitor`, polled once per
        drained batch.
    """

    def __init__(self, *, P: int, Q: int, solver: str = "d3ca",
                 engine: str = "simulated", local_backend: str = "kernel",
                 block_format: str = "dense", cfg=None,
                 tol: Optional[float] = None, check_every: int = 5,
                 max_tenants: Optional[int] = None,
                 warm_registry: bool = True,
                 on_result: Optional[Callable[[str, SolveResult], None]]
                 = None,
                 tracer=None, registry=None, monitor=None, device="cuda"):
        self.P, self.Q = P, Q
        self.fleet = FleetSolver(solver=solver, engine=engine,
                                 local_backend=local_backend,
                                 block_format=block_format, device=device)
        self.cfg = cfg
        self.tol = tol
        self.check_every = check_every
        self.max_tenants = max_tenants
        self.warm_registry = warm_registry
        self.on_result = on_result
        self.tracer = tracer
        self.registry = registry
        self.monitor = monitor
        self._queue: List[FleetProblem] = []
        self._warm: Dict[str, SolveResult] = {}

    # ------------------------------------------------------------------

    def submit(self, problem: FleetProblem) -> str:
        """Queue one tenant's problem; returns its tenant id."""
        self._queue.append(problem)
        return problem.tenant_id

    def pending(self) -> int:
        return len(self._queue)

    def buckets(self) -> Dict[Tuple, List[FleetProblem]]:
        """The queued problems grouped by shape bucket (insertion
        order preserved within each bucket)."""
        groups: Dict[Tuple, List[FleetProblem]] = collections.OrderedDict()
        for p in self._queue:
            groups.setdefault(bucket_key(p, self.P, self.Q), []).append(p)
        return groups

    def warm_start_of(self, tenant_id: str) -> Optional[SolveResult]:
        return self._warm.get(tenant_id)

    # ------------------------------------------------------------------

    def _chunks(self, probs: Sequence[FleetProblem]):
        cap = self.max_tenants
        if cap is None or cap >= len(probs):
            yield list(probs)
            return
        for lo in range(0, len(probs), cap):
            yield list(probs[lo:lo + cap])

    def run(self) -> Dict[str, SolveResult]:
        """Drain the queue: one batched solve per (bucket, chunk).

        Returns results keyed by tenant id, in bucket order and, within a
        bucket, in submission order.
        """
        results: Dict[str, SolveResult] = collections.OrderedDict()
        groups = self.buckets()
        self._queue = []
        for key, probs in groups.items():
            if self.registry is not None:
                self.registry.gauge(
                    "fleet/bucket_tenants", bucket="/".join(map(str, key)),
                    solver=self.fleet.solver,
                    engine=self.fleet.engine).set(len(probs))
            for chunk in self._chunks(probs):
                warm = ([self._warm.get(p.tenant_id) for p in chunk]
                        if self.warm_registry else None)
                batch = self.fleet.solve_batch(
                    chunk, P=self.P, Q=self.Q, cfg=self.cfg,
                    tol=self.tol, check_every=self.check_every,
                    warm_starts=warm, tracer=self.tracer,
                    registry=self.registry)
                for p, res in zip(chunk, batch):
                    if self.warm_registry:
                        self._warm[p.tenant_id] = res
                    results[p.tenant_id] = res
                    if self.on_result is not None:
                        self.on_result(p.tenant_id, res)
                if self.monitor is not None:
                    self.monitor.poll()
        return results

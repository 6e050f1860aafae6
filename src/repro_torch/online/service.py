"""The online learning service: stream observations into warm-started
doubly distributed solves behind the live scorer (counterpart of
``repro/online/service.py``).

Request lifecycle::

    submit() ──▶ AdmissionQueue ──▶ run_pending():
                   (shed on full)     GridStore.insert   (on the device)
                                      Solver.update      (gated,
                                                          warm-started)
                                      SnapshotBook.publish
                                      LinearScorer.update_weights
    score() ──▶ LinearScorer (current snapshot; staleness accounted)

``Solver.update`` runs ``passes`` warm-started outer iterations of gated
D3CA in which only the rows the new batch landed on may move their dual,
on the window where it lies (the store keeps it on the service's
device).  Scoring never blocks on training: the scorer reads the last
*published* weights, swapped in by one atomic reference assignment, and
the gap between "what the scorer serves" and "what the stream has seen"
is exported as the staleness gauge and the version lag.

The update is asynchronous on the card: the service waits for its work
to finish before it reads the update's time and publishes, so that
``online/update_s`` and the snapshot's ``trained_at`` (the staleness
zero point) count the work and not its launch.

``compression`` and ``topology`` go into every update's solve verbatim,
as the reference threads them (the solver rebuilds its program under a
codec, so each update starts from zero error feedback), and ``staleness``
too (the solver refuses it on the grid engine with the reference's
``ValueError``).  The telemetry is the reference's: spans
``online/ingest|update|swap|score``, health polls after every publish,
ingest and scoring call, and the service's registry handed to every
update (the solver's timed path, with its calibration).

**On the mesh engines** (``OnlineConfig(engine="shard_map" | "sync" |
"async" | "overlap")``) every update is a solve on a process grid of P x
Q ranks: ``mesh=`` (a :class:`repro_torch.launch.mesh.ProcessGrid`) or,
without one, the memoized grid of the config's P x Q on the service's
device.  As in the reference, every update partitions the window afresh
on the host and opens a session, which hands every rank its block of the
window: the window is not kept resident on the ranks between updates.
With ``mesh=`` the live scorer runs on the same grid (its weight blocks
resident on the ranks, ``serve/scoring.py``), and a score call runs
between two commands of an update in flight rather than after it.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from ..core.solver import get_solver
from ..core.util import resolve_device
from ..obs import Registry, as_tracer
from ..serve.scoring import LinearScorer
from .queue import AdmissionQueue
from .snapshot import SnapshotBook
from .store import GridStore


@dataclasses.dataclass(frozen=True)
class OnlineConfig:
    """Static configuration of an :class:`OnlineSolverService`.

    Attributes:
      m: feature dimension of the stream.
      capacity: observation window (GridStore rows; rounded up so P
        divides it).
      P, Q: solver grid.
      loss: loss name (see ``repro_torch.core.losses``).
      solver: registry name; must support row gating (``d3ca``).
      engine / local_backend / block_format / staleness / compression /
        topology: the usual solver knobs, threaded verbatim (``engine``:
        ``simulated``, or a mesh engine ``shard_map | sync | async |
        overlap``).
      solver_cfg: optional solver config (its ``outer_iters`` is
        overridden by ``passes`` for each update).
      passes: warm-started outer iterations per drained batch.
      queue_capacity: admission bound in pending observation rows.
      max_update_rows: cap on rows drained into one update pass.
    """
    m: int
    capacity: int = 512
    P: int = 2
    Q: int = 2
    loss: str = "hinge"
    solver: str = "d3ca"
    engine: str = "simulated"
    local_backend: str = "kernel"
    block_format: str = "dense"
    staleness: int = 0
    compression: Optional[str] = None
    topology: Optional[str] = None
    solver_cfg: Optional[object] = None
    passes: int = 1
    queue_capacity: int = 4096
    max_update_rows: Optional[int] = None


class OnlineSolverService:
    """Ties admission, the observation store, the incremental solver,
    snapshot publication, and the live scorer into one object.

    Args:
      config: an :class:`OnlineConfig`.
      manager: optional :class:`~repro_torch.checkpoint.manager.
        CheckpointManager` -- when given, every published version is
        persisted and :meth:`recover` can resume after a crash.
      registry: a :class:`repro_torch.obs.Registry`.  The service exports
        counters ``online/ingested`` / ``online/updates`` /
        ``online/scored`` / ``online/rejected``, gauges
        ``online/staleness_s`` (age of the served snapshot),
        ``online/version_lag`` (admitted observations the served model
        has not seen) and ``online/w_norm`` (L2 norm of the published
        weights), and histograms ``online/update_s`` / ``online/swap_s``.
        The registry also goes to every ``Solver.update``, as the
        reference's does, so every update takes the solver's timed path:
        the ``solver/*`` metrics, and a calibration of the local / comm
        split of the update's program (``2 * (1 + 3)`` extra steps).
      tracer: a :class:`repro_torch.obs.Tracer` (or
        :class:`~repro_torch.obs.FlightRecorder`); spans ``online/ingest``,
        ``online/update`` (with the solver's ``solve`` tree inside),
        ``online/swap`` and ``online/score``.
      monitor: a :class:`repro_torch.obs.HealthMonitor`; its rate-limited
        ``poll()`` runs after every publish, on every ingest and after
        every scoring call.
      clock: injectable wall-clock for staleness math (tests freeze it).
      device: where the window, the solves, the snapshots and the scorer
        live (``"cuda"`` by default; raises without a card).
      index_source: the solver's coordinate orders (see
        ``repro_torch.core.indices``); None draws them from a generator
        seeded from the solver config.
      mesh: a :class:`repro_torch.launch.mesh.ProcessGrid` for the mesh
        engines and the grid-sharded scorer; None runs the updates on the
        memoized grid of P x Q ranks (a mesh engine) or on the grid engine
        (``simulated``), and the scorer on one device.
    """

    def __init__(self, config: OnlineConfig, *, mesh=None, manager=None,
                 tracer=None, registry: Optional[Registry] = None,
                 monitor=None, clock=time.monotonic, device="cuda",
                 index_source=None):
        solver_cls = get_solver(config.solver)
        if not solver_cls.supports_row_gate:
            raise ValueError(
                f"solver {config.solver!r} has no incremental row-gate "
                "path; the online service needs one (use 'd3ca')")
        self.config = config
        self.mesh = mesh
        self.device = resolve_device(device)
        self.tracer = as_tracer(tracer)
        self.registry = registry if registry is not None else Registry()
        self.monitor = monitor
        self.clock = clock
        self.solver = solver_cls(
            engine=config.engine, local_backend=config.local_backend,
            block_format=config.block_format, staleness=config.staleness,
            compression=config.compression, topology=config.topology,
            device=self.device, index_source=index_source)
        self.queue = AdmissionQueue(capacity=config.queue_capacity)
        self.store = GridStore(config.m, config.capacity, config.P,
                               config.Q, device=self.device)
        cap = self.store.capacity
        self.book = SnapshotBook(torch.zeros(config.m),
                                 torch.zeros(cap), manager=manager,
                                 clock=clock, device=self.device)
        self.scorer = LinearScorer(torch.zeros(config.m), mesh,
                                   loss=config.loss, device=self.device)
        self._labels = {"solver": config.solver, "engine": config.engine}
        self.last_result = None

    # ------------------------------------------------------------------
    # ingest
    # ------------------------------------------------------------------
    def submit(self, X, y) -> int:
        """Admit an observation batch (may raise
        :class:`~repro_torch.online.queue.QueueFullError` -- callers retry
        or shed; the counters record either way)."""
        rows = int(np.shape(X)[0])
        with self.tracer.span("online/ingest", rows=rows):
            try:
                seq = self.queue.submit(X, y)
            except Exception:
                self.registry.counter("online/rejected", **self._labels)\
                    .inc(rows)
                self._poll()
                raise
        self.registry.counter("online/ingested", **self._labels).inc(rows)
        self._gauge_staleness()
        self._poll()
        return seq

    # ------------------------------------------------------------------
    # update
    # ------------------------------------------------------------------
    def _wait_for_device(self):
        """Block until the work queued on the service's device finished
        (the update's kernels are asynchronous)."""
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()

    def run_pending(self) -> Optional[int]:
        """Drain the queue and fold the batch into the model.

        One call = at most one warm-started gated solver pass over the
        touched rows, then one atomic snapshot publish + scorer swap.

        Returns:
          The new snapshot version, or None when nothing was pending.
        """
        batch = self.queue.drain(self.config.max_update_rows)
        if batch is None:
            return None
        Xb, yb, seq = batch
        cur = self.book.current()
        with self.tracer.span("online/update", rows=len(yb)):
            t0 = self.clock()
            touched = self.store.insert(Xb, yb)
            res = self.solver.update(
                self.config.loss, self.store.X, self.store.y,
                touched=touched, warm_start=(cur.w, cur.alpha),
                P=self.config.P, Q=self.config.Q,
                cfg=self.config.solver_cfg, mesh=self.mesh,
                passes=self.config.passes,
                tracer=self.tracer if self.tracer.enabled else None,
                registry=self.registry, record_history=False)
            self._wait_for_device()
            self.registry.histogram("online/update_s", **self._labels)\
                .observe(self.clock() - t0)
        with self.tracer.span("online/swap"):
            t0 = self.clock()
            snap = self.book.publish(res.w, res.alpha, seq)
            self.scorer.update_weights(snap.w, version=snap.version)
            self.registry.histogram("online/swap_s", **self._labels)\
                .observe(self.clock() - t0)
        self.registry.counter("online/updates", **self._labels).inc()
        # L2 norm of the published weights: NaN/inf anywhere in w makes
        # the norm non-finite (incremental updates run with
        # record_history=False, so no objective is evaluated here)
        self.registry.gauge("online/w_norm", **self._labels)\
            .set(float(torch.linalg.vector_norm(snap.w)))
        self.last_result = res
        self._gauge_staleness()
        self._poll()
        return snap.version

    def drain_all(self) -> int:
        """Run update passes until the queue is empty; returns the
        number of passes run."""
        n = 0
        while self.run_pending() is not None:
            n += 1
        return n

    # ------------------------------------------------------------------
    # serve
    # ------------------------------------------------------------------
    def score(self, X) -> np.ndarray:
        """Margins under the currently served snapshot (never blocks on
        a concurrent update pass)."""
        with self.tracer.span("online/score", rows=int(np.shape(X)[0])):
            out = self.scorer.score(X)
        self.registry.counter("online/scored", **self._labels)\
            .inc(int(np.shape(X)[0]))
        self._gauge_staleness()
        self._poll()        # staleness grows while only scoring
        return out

    def predict(self, X) -> np.ndarray:
        """Labels / probabilities under the served snapshot."""
        out = self.scorer.predict(X)
        self.registry.counter("online/scored", **self._labels)\
            .inc(int(np.shape(X)[0]))
        self._gauge_staleness()
        return out

    # ------------------------------------------------------------------
    # bookkeeping
    # ------------------------------------------------------------------
    def _poll(self):
        if self.monitor is not None:
            self.monitor.poll()

    def _gauge_staleness(self):
        cur = self.book.current()
        self.registry.gauge("online/staleness_s", **self._labels)\
            .set(self.clock() - cur.trained_at)
        self.registry.gauge("online/version_lag", **self._labels)\
            .set(self.queue.seq - cur.trained_seq)

    @property
    def staleness_s(self) -> float:
        """Age of the snapshot the scorer is serving."""
        return self.clock() - self.book.current().trained_at

    @property
    def version_lag(self) -> int:
        """Admitted observations the served model has not absorbed."""
        return self.queue.seq - self.book.current().trained_seq

    def recover(self) -> Optional[int]:
        """Restore the newest persisted snapshot (see
        :meth:`SnapshotBook.recover`) and point the scorer at it.

        Returns the recovered version, or None without a manager /
        checkpoints."""
        snap = self.book.recover(torch.zeros(self.config.m),
                                 torch.zeros(self.store.capacity))
        if snap is None:
            return None
        self.scorer.update_weights(snap.w, version=snap.version)
        return snap.version

    def stats(self) -> dict:
        """One-call service summary (counters + staleness + store)."""
        cur = self.book.current()
        return {
            "version": cur.version,
            "trained_seq": cur.trained_seq,
            "ingested": self.queue.admitted,
            "rejected": self.queue.rejected,
            "pending_rows": self.queue.pending_rows,
            "version_lag": self.version_lag,
            "staleness_s": self.staleness_s,
            "store_filled": self.store.filled,
            "store_capacity": self.store.capacity,
            "rows_scored": self.scorer.rows_scored,
            "score_rows_per_sec": self.scorer.rows_per_sec,
        }

"""repro_torch.online -- streaming observations into warm-started doubly
distributed solves behind the live scorer (counterpart of
``repro.online``).

New observations arrive as requests, pass an admission queue (bounded;
shed on overload), land in a fixed-capacity ring buffer on the device
sharded into the same P x Q grid, and trigger *incremental* updates:
warm-started, row-gated D3CA passes (``Solver.update``) that only move
the dual of the touched rows while the primal stays exact for the whole
window.  Meanwhile ``LinearScorer`` keeps serving the last published
model from a versioned snapshot swapped in atomically (and, optionally,
persisted through ``repro_torch.checkpoint`` for crash recovery).

Modules:
  * ``queue``    -- :class:`AdmissionQueue`: bounded ingest,
                    reject-on-full, FIFO drain-coalescing (host side)
  * ``store``    -- :class:`GridStore`: constant-shape observation ring
                    on the device; reports touched rows
  * ``snapshot`` -- :class:`ModelSnapshot` / :class:`SnapshotBook`:
                    atomic publish/read hand-off + checkpoint-backed
                    durability and recovery
  * ``service``  -- :class:`OnlineSolverService`: the whole loop, with
                    staleness / throughput metrics
"""
from .queue import AdmissionQueue, QueueFullError
from .service import OnlineConfig, OnlineSolverService
from .snapshot import ModelSnapshot, SnapshotBook
from .store import GridStore

__all__ = [
    "AdmissionQueue", "QueueFullError",
    "OnlineConfig", "OnlineSolverService",
    "ModelSnapshot", "SnapshotBook",
    "GridStore",
]

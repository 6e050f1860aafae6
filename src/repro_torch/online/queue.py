"""Admission control for observation-bearing requests.

The online service sits in front of a solver whose update passes take
milliseconds to seconds; traffic does not.  ``AdmissionQueue`` is the
bounded buffer between the two: producers ``submit`` observation
batches and are *rejected* (not blocked) when the queue is full --
load-shedding at admission keeps the update path's latency bounded
instead of letting a backlog grow without bound.  ``drain`` pops
pending requests and coalesces them into one training batch, so one
warm-started solver pass absorbs a burst.

Thread-safe, host-side numpy: a copy of ``repro/online/queue.py``, whose
semantics the port keeps (bounded, no partial admission, FIFO drain
that coalesces whole batches).
"""
from __future__ import annotations

import threading
from typing import List, Optional, Tuple

import numpy as np


class QueueFullError(RuntimeError):
    """Raised by :meth:`AdmissionQueue.submit` when admission would
    exceed ``capacity`` pending observations (the request is shed)."""


class AdmissionQueue:
    """Bounded FIFO of observation batches awaiting an update pass.

    Args:
      capacity: maximum number of pending *observations* (rows summed
        over queued batches); 0 or negative means unbounded.
    """

    def __init__(self, capacity: int = 4096):
        self.capacity = int(capacity)
        self._lock = threading.Lock()
        self._batches: List[Tuple[np.ndarray, np.ndarray, int]] = []
        self._pending_rows = 0
        self._seq = 0           # observations ever admitted
        self.admitted = 0
        self.rejected = 0

    def submit(self, X, y) -> int:
        """Admit a batch of observations.

        Args:
          X: (b, m) feature rows.
          y: (b,) labels.

        Returns:
          The stream sequence number of the LAST admitted observation
          (1-based; monotone over the life of the queue).

        Raises:
          QueueFullError: when admitting would exceed ``capacity``
            pending rows; the batch is dropped whole (no partial
            admission).
          ValueError: on mismatched X/y lengths.
        """
        X = np.asarray(X, np.float32)
        y = np.asarray(y, np.float32)
        if X.ndim != 2 or y.shape != (X.shape[0],):
            raise ValueError(f"expected (b, m) X and (b,) y; got "
                             f"{X.shape} / {y.shape}")
        b = X.shape[0]
        with self._lock:
            if 0 < self.capacity < self._pending_rows + b:
                self.rejected += b
                raise QueueFullError(
                    f"admission queue full ({self._pending_rows} pending "
                    f"rows + {b} > capacity {self.capacity})")
            self._seq += b
            self.admitted += b
            self._pending_rows += b
            self._batches.append((X, y, self._seq))
            return self._seq

    def drain(self, max_rows: Optional[int] = None):
        """Pop pending batches (FIFO) and coalesce them.

        Args:
          max_rows: stop after at least this many rows have been popped
            (whole batches only; None drains everything).

        Returns:
          ``(X, y, seq)`` -- the concatenated rows and the sequence
          number of the last row included -- or ``None`` when nothing
          is pending.
        """
        with self._lock:
            if not self._batches:
                return None
            take, rows = [], 0
            while self._batches and (max_rows is None or rows < max_rows):
                b = self._batches.pop(0)
                take.append(b)
                rows += len(b[1])
            self._pending_rows -= rows
        X = np.concatenate([b[0] for b in take], axis=0)
        y = np.concatenate([b[1] for b in take], axis=0)
        return X, y, take[-1][2]

    @property
    def pending_rows(self) -> int:
        with self._lock:
            return self._pending_rows

    @property
    def seq(self) -> int:
        """Observations ever admitted (the ingest high-water mark)."""
        with self._lock:
            return self._seq

"""Fixed-capacity observation store sharded into the P x Q grid, on the
service's device.

The streaming solver needs constant array shapes.  ``GridStore``
therefore pre-allocates a ``capacity``-row buffer (rounded up so P
divides it), fills it sequentially, and wraps around ring-buffer style
once full (oldest observations are overwritten; the effective training
window is the last ``capacity`` rows of the stream) -- the semantics of
the reference's ``repro/online/store.py``.

Because the solver partitions rows into P contiguous slabs of
``n_p = capacity / P`` rows, a batch written at the ring cursor lands
in one or two adjacent row partitions -- the "touched cells" the gated
D3CA pass moves.  ``insert`` returns the touched row indices so the
service can build the gate.

``X``, ``y`` and ``filled_mask`` are tensors on the store's device (the
card by default): a batch lands with one ``index_copy_`` per tensor, and
an update reads the window where it lies, so the window never crosses to
the card again.  ``X`` stays dense, as in the reference.  The cursor and
the row counts are kept on the host, so ``insert``, ``filled`` and
``written`` never wait for the device.

Rows never written stay all-zero with ``filled_mask == 0``; the service
always gates them off (their dual is frozen at zero and a zero-feature
row contributes nothing to w), so passing the full buffer to the solver
is safe.  Until the buffer fills, the solver's 1/n scaling counts
``capacity`` rows, so the effective regularization is
``lam * capacity / filled`` relative to the filled-rows problem, as in
the reference.
"""
from __future__ import annotations

import threading

import numpy as np
import torch

from ..core.util import DTYPE, as_tensor, resolve_device


def _ceil_to(x: int, k: int) -> int:
    return (x + k - 1) // k * k


class GridStore:
    """Ring buffer of the last ``capacity`` stream observations.

    Args:
      m: feature dimension.
      capacity: observation window size (rounded up to a multiple of P).
      P, Q: the solver grid this buffer will be partitioned into.
      device: where the window lives (``"cuda"`` by default; raises
        without a card).
    """

    def __init__(self, m: int, capacity: int, P: int, Q: int, *,
                 device="cuda"):
        self.m = int(m)
        self.P = int(P)
        self.Q = int(Q)
        self.device = resolve_device(device)
        self.capacity = _ceil_to(int(capacity), self.P)
        self.n_p = self.capacity // self.P
        self.X = torch.zeros((self.capacity, self.m), dtype=DTYPE,
                             device=self.device)
        self.y = torch.zeros((self.capacity,), dtype=DTYPE,
                             device=self.device)
        self.filled_mask = torch.zeros((self.capacity,), dtype=DTYPE,
                                       device=self.device)
        self._cursor = 0          # next slot to write (ring)
        self._written = 0         # total rows ever written
        self._lock = threading.Lock()

    def insert(self, Xb, yb) -> np.ndarray:
        """Write a batch at the ring cursor.

        Args:
          Xb: (b, m) rows (numpy or a tensor); b may exceed capacity (only
            the last ``capacity`` rows survive, matching ring semantics).
          yb: (b,) labels.

        Returns:
          The touched row indices (np.int64, sorted, unique) -- the gate
          set for the next incremental pass.

        Raises:
          ValueError: on a feature-dimension mismatch.
        """
        if not isinstance(Xb, torch.Tensor):
            Xb = np.asarray(Xb, np.float32)
        if not isinstance(yb, torch.Tensor):
            yb = np.asarray(yb, np.float32)
        if Xb.ndim != 2 or Xb.shape[1] != self.m:
            raise ValueError(f"expected (b, {self.m}); got "
                             f"{tuple(Xb.shape)}")
        b = Xb.shape[0]
        if b > self.capacity:       # only the tail survives a giant batch
            Xb, yb, b = Xb[-self.capacity:], yb[-self.capacity:], \
                self.capacity
        Xb = as_tensor(Xb, self.device)
        yb = as_tensor(yb, self.device)
        with self._lock:
            idx = (self._cursor + np.arange(b)) % self.capacity
            rows = torch.from_numpy(idx).to(self.device)
            self.X.index_copy_(0, rows, Xb)
            self.y.index_copy_(0, rows, yb)
            self.filled_mask.index_fill_(0, rows, 1.0)
            self._cursor = int((self._cursor + b) % self.capacity)
            self._written += b
        return np.unique(idx)

    def touched_partitions(self, rows: np.ndarray) -> np.ndarray:
        """Row partitions (p indices) a set of row indices lands in."""
        return np.unique(np.asarray(rows) // self.n_p)

    @property
    def filled(self) -> int:
        """Rows holding a real observation (<= capacity): the ring fills
        from row 0 on, so every row ever written is one of the first
        ``written`` (up to ``capacity``)."""
        with self._lock:
            return min(self._written, self.capacity)

    @property
    def written(self) -> int:
        """Total rows ever written (>= filled once the ring wraps)."""
        with self._lock:
            return self._written

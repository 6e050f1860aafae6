"""Versioned model snapshots with an atomic publish/read hand-off.

``SnapshotBook`` is the synchronization point between the update path
(one writer) and the scoring path (many readers): ``publish`` builds an
immutable :class:`ModelSnapshot` off to the side and swaps the current
reference under a lock, so ``current()`` always returns a *complete*
(version, w, alpha, trained_seq, trained_at) tuple -- readers see the
old snapshot or the new one, never a mix.  ``w`` and ``alpha`` are
tensors on the book's device, cloned in ``publish``, so a published
snapshot never aliases a tensor the solver writes later.

Durability goes through the port's ``checkpoint.manager``: each published
version is written as checkpoint ``step_<version>`` -- the tree ``{"w",
"alpha", "trained_seq"}`` of the reference, in its on-disk layout -- via
the manager's write-to-tmp + atomic-rename protocol, so a crash
mid-publish can never corrupt the latest on-disk snapshot, and
``recover`` restores the newest complete version after a restart (from a
directory either package wrote).
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Optional

import numpy as np
import torch

from ..checkpoint.manager import CheckpointManager
from ..core.util import DTYPE, as_tensor, resolve_device


@dataclasses.dataclass(frozen=True)
class ModelSnapshot:
    """One immutable published model version.

    Attributes:
      version: monotone snapshot version (0 is the initial model).
      w: (m,) weights, a tensor on the book's device.
      alpha: (capacity,) dual iterate carried for the next warm start
        (None for primal-only solvers).
      trained_seq: stream sequence number the model has absorbed --
        ``ingested_seq - trained_seq`` is the version lag.
      trained_at: publish wall-clock (the staleness zero point).
    """
    version: int
    w: torch.Tensor
    alpha: Optional[torch.Tensor]
    trained_seq: int
    trained_at: float


def _own(a, device):
    """A float32 tensor on ``device`` that aliases nothing the caller
    holds (``as_tensor`` may hand back the caller's tensor, or share a
    numpy array's memory on the CPU)."""
    return as_tensor(a, device).clone()


class SnapshotBook:
    """Single-writer / many-reader registry of model snapshots.

    Args:
      w0: (m,) initial weights (version 0).
      alpha0: optional initial dual.
      manager: optional :class:`CheckpointManager`; when given, every
        publish persists the snapshot as checkpoint step ``version``.
      async_persist: hand the disk write to the manager's background
        thread so ``publish`` only blocks for the device-to-host copy and
        the reference swap.
      clock: injectable time source (tests freeze it).
      device: where the snapshots' tensors live (``"cuda"`` by default;
        raises without a card).
    """

    def __init__(self, w0, alpha0=None, *,
                 manager: Optional[CheckpointManager] = None,
                 async_persist: bool = True, clock=time.monotonic,
                 device="cuda"):
        self.device = resolve_device(device)
        self._lock = threading.Lock()
        self._manager = manager
        self._async = async_persist
        self._clock = clock
        self._current = ModelSnapshot(
            version=0, w=_own(w0, self.device),
            alpha=None if alpha0 is None else _own(alpha0, self.device),
            trained_seq=0, trained_at=clock())

    def current(self) -> ModelSnapshot:
        """The latest published snapshot (always complete)."""
        with self._lock:
            return self._current

    def publish(self, w, alpha, trained_seq: int) -> ModelSnapshot:
        """Publish a new version; returns the new snapshot.

        The snapshot (and, when persistence is on, its on-disk
        checkpoint hand-off) is prepared BEFORE the reference swap, so
        the swap itself is one assignment under the lock.  The caller
        makes sure the work that produced ``w`` / ``alpha`` has finished
        when it wants ``trained_at`` to mean "trained" (the service
        waits for the device first).
        """
        with self._lock:
            version = self._current.version + 1
        snap = ModelSnapshot(
            version=version, w=_own(w, self.device),
            alpha=None if alpha is None else _own(alpha, self.device),
            trained_seq=int(trained_seq), trained_at=self._clock())
        if self._manager is not None:
            tree = {"w": snap.w,
                    "trained_seq": np.asarray(snap.trained_seq, np.int64)}
            if snap.alpha is not None:
                tree["alpha"] = snap.alpha
            if self._async:
                self._manager.save_async(version, tree)
            else:
                self._manager.save(version, tree)
        with self._lock:
            self._current = snap
        return snap

    def flush(self):
        """Block until any background persist completed (surfacing its
        error, if one failed)."""
        if self._manager is not None:
            self._manager.wait()

    def recover(self, like_w, like_alpha=None) -> Optional[ModelSnapshot]:
        """Restore the newest complete on-disk version (crash recovery).

        Incomplete writes (leftover ``.tmp`` directories from a crash
        mid-publish) are invisible to the manager's ``latest_step``, so
        recovery lands on the newest snapshot that finished its atomic
        rename.

        Args:
          like_w: (m,) template fixing the weight shape.
          like_alpha: optional dual template (omit for primal-only).

        Returns:
          The recovered snapshot (now current), or None when no complete
          checkpoint exists (the book keeps its current version).
        """
        if self._manager is None or self._manager.latest_step() is None:
            return None
        like = {"w": torch.zeros(np.shape(like_w), dtype=DTYPE),
                "trained_seq": np.asarray(0, np.int64)}
        if like_alpha is not None:
            like["alpha"] = torch.zeros(np.shape(like_alpha), dtype=DTYPE)
        step, tree = self._manager.restore(like, device=self.device)
        snap = ModelSnapshot(
            version=int(step), w=tree["w"], alpha=tree.get("alpha"),
            trained_seq=int(tree["trained_seq"]),
            trained_at=self._clock())
        with self._lock:
            self._current = snap
        return snap

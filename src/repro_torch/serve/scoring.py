"""Batched scoring for the paper's linear models (counterpart of
``repro/serve/scoring.py``).

``LinearScorer`` is the serving wrapper of a trained ``w``: fixed-size
row buckets, loss-appropriate links (sign / sigmoid), rows/s counters,
and the atomic ``update_weights`` the online service swaps new snapshots
in with.  On one device the margin is ``x @ w`` -- the reference
computes it outside any Pallas kernel too -- so it is a ``torch.matmul``
here.  A request batch is copied to the device once, its buckets are
scored there, and the margins come back with one synchronisation per
``score`` call.

The reference's grid-sharded scoring (``mesh=``, ``make_score_fn``: a
(data, model) mesh with one psum over the model axis) belongs to the mesh
halves of the multi-device engines (ROADMAP queue A item 12b) and raises
by name.
"""
from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from ..core.solver import not_ported
from ..core.util import DTYPE, as_tensor, resolve_device


def make_score_fn(mesh, *, data_axis: str = "data",
                  model_axis: str = "model"):
    """The reference's mesh-sharded margins; not ported yet."""
    raise not_ported("mesh")


class LinearScorer:
    """High-throughput scoring of a trained linear model ``w``.

    ``loss`` picks the link: "logistic" -> P(y=1) = sigmoid(margin);
    "hinge"/"squared" -> +-1 labels = sign(margin).  ``bucket`` is the
    number of request rows scored per matrix product (default 64).
    ``device`` is where ``w`` lives and the margins are computed
    (``"cuda"`` by default; raises without a card).
    """

    def __init__(self, w, mesh=None, *, loss: str = "hinge",
                 bucket: Optional[int] = None, clock=time.perf_counter,
                 device="cuda"):
        if mesh is not None:
            raise not_ported("mesh")
        self.device = resolve_device(device)
        self.loss = loss
        self.clock = clock
        self.rows_scored = 0
        self.seconds = 0.0
        self.m = len(w)
        self.w = self._place(w)
        self.w_version = 0
        self.bucket = bucket if bucket is not None else 64

    def _place(self, w):
        """A new tensor on the device holding ``w`` (never the caller's)."""
        return as_tensor(w, self.device).clone()

    def update_weights(self, w, version: Optional[int] = None):
        """Swap in a new model snapshot.

        The device tensor is built first and the ``self.w``
        reference swapped in one assignment, so a concurrent
        :meth:`score` call always reads a complete weight vector --
        either the old snapshot or the new one, never a mix.  This is
        the serving half of the online service's atomic hand-off.

        Args:
          w: (m,) new weights (same m the scorer was built with).
          version: optional snapshot version recorded as
            ``self.w_version`` for staleness introspection.

        Raises:
          ValueError: on a length mismatch.
        """
        if len(w) != self.m:
            raise ValueError(f"expected ({self.m},) weights; got "
                             f"{tuple(np.shape(w))}")
        w_new = self._place(w)       # build off to the side...
        self.w = w_new               # ...then one atomic reference swap
        if version is not None:
            self.w_version = version

    def score(self, X) -> np.ndarray:
        """Margins x . w for a (B, m) request batch (any B), as float32
        numpy."""
        if not isinstance(X, torch.Tensor):
            X = np.asarray(X, np.float32)
        if X.ndim != 2 or X.shape[1] != self.m:
            raise ValueError(f"expected (B, {self.m}); got "
                             f"{tuple(X.shape)}")
        B = X.shape[0]
        t0 = self.clock()
        w = self.w    # one snapshot read: a whole batch scores one version
        Xd = as_tensor(X, self.device)          # one copy to the device
        out = torch.empty((B,), dtype=DTYPE, device=self.device)
        for lo in range(0, B, self.bucket):
            torch.matmul(Xd[lo: lo + self.bucket], w,
                         out=out[lo: lo + self.bucket])
        margins = out.cpu().numpy()             # one synchronisation
        self.seconds += self.clock() - t0
        self.rows_scored += B
        return margins

    def predict(self, X) -> np.ndarray:
        """Labels (+-1) or, for logistic loss, P(y = +1)."""
        margins = self.score(X)
        if self.loss == "logistic":
            return 1.0 / (1.0 + np.exp(-margins))
        return np.where(margins >= 0.0, 1.0, -1.0).astype(np.float32)

    @property
    def rows_per_sec(self) -> float:
        return self.rows_scored / self.seconds if self.seconds > 0 else 0.0

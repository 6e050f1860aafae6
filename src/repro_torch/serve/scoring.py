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

**On a process grid** (``mesh=``, a
:class:`repro_torch.launch.mesh.ProcessGrid` of P x Q ranks) scoring is
the serving analogue of Algorithm 1's primal-dual map, as in the
reference: the request rows are split over the "data" axis and ``w``
over the "model" axis, rank (p, q) computes ``x_[p,q] @ w_q`` and one
all-reduce over its row of the grid sums the partial margins
(:func:`make_score_fn`, :func:`score_cells`).  B is padded to a multiple
of P and m to a multiple of Q, and the padding is stripped from the
result.  The design, given that a process holds one grid and that the
online service's updates open solver sessions on it:

  * ``w``'s blocks are *resident* on the ranks (``RankContext.resident``,
    keyed by the scorer): placed once by ``update_weights`` (one CALL
    command, :func:`place_cells`), they outlive every solver session, so
    an update never loses them and scoring never sends the solver's
    blocks -- a score call sends only its request rows;
  * a score call is ONE command (``ProcessGrid.call``: the rows
    scattered, every rank's product, the row all-reduce and the gather
    to the controller), and so is a weight swap; the grid's lock is held
    per command, so a score interleaves between two steps of an update
    in flight (it runs inside the update's session) instead of waiting
    for the update, and reads exactly one version of ``w`` -- the swap is
    one command on every rank, never half of one;
  * with no session open, the grid opens an idle session around the
    command (see ``launch/mesh.py``);
  * a scorer's blocks (m / Q floats a rank) stay on the ranks until the
    grid closes; ``update_weights`` overwrites them in place.
"""
from __future__ import annotations

import itertools
import time
from typing import Optional

import numpy as np
import torch

from ..core.engines import CELL, COL
from ..core.util import DTYPE, as_tensor, resolve_device

#: ranks' resident keys, one per grid scorer
_KEYS = itertools.count()


def _ceil_to(x: int, k: int) -> int:
    return (x + k - 1) // k * k


def score_cells(ctx, x, w=None, *, key: Optional[str] = None):
    """A rank's part of a grid score: its request block ``x (1, 1, B_p,
    m_q)`` times its ``w`` block (``w (1, m_q)``, or the one resident
    under ``key``), summed over its row of the grid; the controller
    gets the margins ``(P * B_p,)`` in row order, the other ranks None."""
    if w is None:
        w = ctx.resident[key]
    from ..core.comm import ProcessWire
    z = ProcessWire(ctx).all_reduce(x[0, 0] @ w[0], "model")
    parts = ctx.gather(z)
    if parts is None:
        return None
    return torch.cat([parts[p * ctx.Q] for p in range(ctx.P)])


def place_cells(ctx, w, *, key: str):
    """A rank keeps its block of a scorer's ``w`` under ``key``."""
    ctx.resident[key] = w


def _row_blocks(x, P: int, Q: int):
    """``(B, m)`` with P | B and Q | m -> ``(P, Q, B / P, m / Q)``."""
    B, m = x.shape
    return x.reshape(P, B // P, Q, m // Q).permute(0, 2, 1, 3)


def make_score_fn(mesh, *, data_axis: str = "data",
                  model_axis: str = "model"):
    """``(x (B, m), w (m,)) -> margins (B,)`` on the process grid ``mesh``:
    each rank gets one ``(B / P, m / Q)`` request block and its ``(m /
    Q,)`` block of w, and the partial margins are summed over the
    "model" axis.  ``B % P == 0`` and ``m % Q == 0`` are the caller's job
    (``LinearScorer`` pads).  The grid's axes are named "data" (P) and
    "model" (Q); other names are refused."""
    if (data_axis, model_axis) != ("data", "model"):
        raise ValueError(f"a process grid's axes are 'data' and 'model'; "
                         f"got {data_axis!r}, {model_axis!r}")

    def score(x, w):
        P, Q = mesh.P, mesh.Q
        if x.shape[0] % P or x.shape[1] % Q or w.shape[0] != x.shape[1]:
            raise ValueError(f"x {tuple(x.shape)} / w {tuple(w.shape)} on "
                             f"a {P}x{Q} grid: pad B to a multiple of P "
                             "and m to one of Q")
        out = mesh.call("repro_torch.serve.scoring:score_cells",
                        [(_row_blocks(x, P, Q), CELL),
                         (w.reshape(Q, -1), COL)])
        return out.to(mesh.device)

    return score


class LinearScorer:
    """High-throughput scoring of a trained linear model ``w``.

    ``loss`` picks the link: "logistic" -> P(y=1) = sigmoid(margin);
    "hinge"/"squared" -> +-1 labels = sign(margin).  ``bucket`` is the
    number of request rows scored per matrix product on one device
    (default 64).  ``device`` is where ``w`` lives and the margins are
    computed (``"cuda"`` by default; raises without a card).

    ``mesh``: a :class:`repro_torch.launch.mesh.ProcessGrid` -- the
    margins are computed on its ranks (see the module docstring), ``w``'s
    blocks resident there, and a whole request batch is one grid command;
    the grid must run on ``device``'s type.  ``bucket`` is not used
    there (``self.bucket`` is None): a batch of any size is padded to a
    multiple of P and scored in one command.
    """

    def __init__(self, w, mesh=None, *, loss: str = "hinge",
                 bucket: Optional[int] = None, clock=time.perf_counter,
                 device="cuda"):
        self.device = resolve_device(device)
        self.mesh = mesh
        self.loss = loss
        self.clock = clock
        self.rows_scored = 0
        self.seconds = 0.0
        self.m = len(w)
        if mesh is not None:
            from ..launch.mesh import grid_for
            self.device = grid_for(mesh, None, None, device=self.device,
                                   engine="shard_map").device
            self.P, self.Q = mesh.P, mesh.Q
            self._m_pad = _ceil_to(self.m, self.Q)
            self._key = f"scorer:{next(_KEYS)}"
            self.bucket = None
        else:
            self.P, self.Q = 1, 1
            self.bucket = bucket if bucket is not None else 64
        self.w = self._place(w)
        self.w_version = 0

    def _place(self, w):
        """A new tensor on the device holding ``w`` (never the caller's);
        on a grid, its blocks placed on the ranks too."""
        w_new = as_tensor(w, self.device).clone()
        if self.mesh is not None:
            wp = torch.zeros((self._m_pad,), dtype=DTYPE)
            wp[: self.m] = w_new.to("cpu")
            self.mesh.call("repro_torch.serve.scoring:place_cells",
                           [(wp.reshape(self.Q, -1), COL)], key=self._key)
        return w_new

    def update_weights(self, w, version: Optional[int] = None):
        """Swap in a new model snapshot.

        The device tensor is built first and the ``self.w``
        reference swapped in one assignment, so a concurrent
        :meth:`score` call always reads a complete weight vector --
        either the old snapshot or the new one, never a mix.  On a grid
        the blocks are swapped on every rank by one command, which a
        score command cannot split.  This is the serving half of the
        online service's atomic hand-off.

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
        if self.mesh is not None:
            margins = self._score_grid(X, B)
        else:
            w = self.w    # one snapshot read: a batch scores one version
            Xd = as_tensor(X, self.device)          # one copy to the device
            out = torch.empty((B,), dtype=DTYPE, device=self.device)
            for lo in range(0, B, self.bucket):
                torch.matmul(Xd[lo: lo + self.bucket], w,
                             out=out[lo: lo + self.bucket])
            margins = out.cpu().numpy()             # one synchronisation
        self.seconds += self.clock() - t0
        self.rows_scored += B
        return margins

    def _score_grid(self, X, B: int) -> np.ndarray:
        """The whole batch in one grid command: rows padded to a multiple
        of P, features to one of Q, the padding stripped after."""
        pad = torch.zeros((_ceil_to(max(B, 1), self.P), self._m_pad),
                          dtype=DTYPE)
        pad[:B, : self.m] = as_tensor(X, "cpu")
        out = self.mesh.call("repro_torch.serve.scoring:score_cells",
                             [(_row_blocks(pad, self.P, self.Q), CELL)],
                             key=self._key)
        return out[:B].numpy()

    def predict(self, X) -> np.ndarray:
        """Labels (+-1) or, for logistic loss, P(y = +1)."""
        margins = self.score(X)
        if self.loss == "logistic":
            return 1.0 / (1.0 + np.exp(-margins))
        return np.where(margins >= 0.0, 1.0, -1.0).astype(np.float32)

    @property
    def rows_per_sec(self) -> float:
        return self.rows_scored / self.seconds if self.seconds > 0 else 0.0

"""State carried across from the reference implementation.

Everything here takes plain numpy arrays -- what ``numpy.asarray`` makes of
the reference's arrays -- and imports neither the reference package nor its
array library, so a caller that holds results of the reference can continue
in the port (and the parity tests can hand one side's state to the other).
"""
from __future__ import annotations

import numpy as np
import torch

from .core.partition import DoublyPartitioned
from .core.solver import SolveResult
from .core.util import as_tensor, resolve_device


def partition_from_reference(x_blocks, y_blocks, mask, n: int, m: int,
                             P: int, Q: int, device="cuda"
                             ) -> DoublyPartitioned:
    """The arrays of a reference ``DoublyPartitioned`` -- ``x_blocks
    (P, Q, n_p, m_q)``, ``y_blocks`` and ``mask`` ``(P, n_p)`` -- as the
    port's, contiguous on ``device``."""
    device = resolve_device(device)
    x = as_tensor(np.asarray(x_blocks), device).contiguous()
    if x.dim() != 4 or tuple(x.shape[:2]) != (P, Q):
        raise ValueError(f"x_blocks has shape {tuple(x.shape)}; expected "
                         f"({P}, {Q}, n_p, m_q)")
    yb = as_tensor(np.asarray(y_blocks), device).contiguous()
    mb = as_tensor(np.asarray(mask), device).contiguous()
    if yb.shape != (P, x.shape[2]) or mb.shape != yb.shape:
        raise ValueError("y_blocks / mask must be (P, n_p) = "
                         f"({P}, {x.shape[2]})")
    return DoublyPartitioned(x, yb, mb, int(n), int(m), int(P), int(Q))


def warm_start_from_reference(w, alpha=None, device="cuda"):
    """``(w, alpha)`` of a reference solve -> what
    ``Solver.solve(warm_start=...)`` takes: a ``(w, alpha)`` tuple of
    float32 tensors on ``device`` (``alpha`` stays None for primal-only
    solvers)."""
    device = resolve_device(device)
    w_t = as_tensor(np.asarray(w), device)
    a_t = None if alpha is None else as_tensor(np.asarray(alpha), device)
    return w_t, a_t


def to_numpy(result: SolveResult) -> SolveResult:
    """A copy of ``result`` whose ``w`` / ``alpha`` are numpy arrays on the
    host (history and metadata unchanged)."""
    def host(t):
        if t is None:
            return None
        return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
            else np.asarray(t)
    return SolveResult(**{**result.__dict__, "w": host(result.w),
                          "alpha": host(result.alpha)})

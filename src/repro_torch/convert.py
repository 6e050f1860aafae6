"""State carried across from the reference implementation.

Everything here takes plain numpy arrays -- what ``numpy.asarray`` makes of
the reference's arrays -- and imports neither the reference package nor its
array library, so a caller that holds results of the reference can continue
in the port (and the parity tests can hand one side's state to the other):
solver partitions and warm starts, LM parameter trees and AdamW states.
"""
from __future__ import annotations

import numpy as np
import torch

from .core.partition import DoublyPartitioned, SparseDoublyPartitioned
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


def sparse_partition_from_reference(cols, vals, y_blocks, mask, n: int,
                                    m: int, m_q: int, P: int, Q: int,
                                    device="cuda") -> SparseDoublyPartitioned:
    """The arrays of a reference ``SparseDoublyPartitioned`` -- ``cols``
    (int32) and ``vals`` ``(P, Q, n_p, k)``, ``y_blocks`` and ``mask``
    ``(P, n_p)`` -- as the port's, contiguous on ``device``.  The sparse
    path's state is the same ``(w, alpha)`` as the dense one, so
    :func:`warm_start_from_reference` serves it unchanged."""
    device = resolve_device(device)
    c = as_tensor(np.asarray(cols), device, dtype=torch.int32).contiguous()
    v = as_tensor(np.asarray(vals), device).contiguous()
    if c.dim() != 4 or tuple(c.shape[:2]) != (P, Q) or v.shape != c.shape:
        raise ValueError(f"cols / vals have shapes {tuple(c.shape)} / "
                         f"{tuple(v.shape)}; expected ({P}, {Q}, n_p, k)")
    yb = as_tensor(np.asarray(y_blocks), device).contiguous()
    mb = as_tensor(np.asarray(mask), device).contiguous()
    if yb.shape != (P, c.shape[2]) or mb.shape != yb.shape:
        raise ValueError("y_blocks / mask must be (P, n_p) = "
                         f"({P}, {c.shape[2]})")
    return SparseDoublyPartitioned(c, v, yb, mb, int(n), int(m), int(m_q),
                                   int(P), int(Q))


def warm_start_from_reference(w, alpha=None, device="cuda"):
    """``(w, alpha)`` of a reference solve -- numpy arrays, or the
    reference's ``SolveResult`` itself (anything with ``.w`` and
    ``.alpha``) -> what ``Solver.solve(warm_start=...)`` and a fleet
    round's ``warm_starts`` entry take: a ``(w, alpha)`` tuple of float32
    tensors on ``device`` (``alpha`` stays None for primal-only
    solvers)."""
    if hasattr(w, "w") and hasattr(w, "alpha"):
        w, alpha = w.w, (w.alpha if alpha is None else alpha)
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


def lm_params_from_reference(tree, device="cuda"):
    """A reference LM parameter tree (``Transformer.init(key)[0]``, in
    ``param_dtype``) whose leaves were made numpy arrays -- nested dicts
    and lists of arrays -- as the port's tree of tensors on ``device``,
    dtypes kept.  Every family's tree has the port's layout as it is:
    MoE routers and (E, ...) expert stacks, RG-LRU's leaves (``lam``
    included), XATTN layers, and the embedding frontend's tree without
    ``embed``."""
    device = resolve_device(device)

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return [walk(v) for v in t]
        return torch.from_numpy(np.array(t, copy=True)).to(device)
    return walk(tree)


def adamw_state_from_reference(tree, device="cuda"):
    """A reference AdamW state (``adamw_init`` / ``adamw_update``'s
    ``{"mu", "nu", "count"}``) whose leaves were made numpy arrays, as
    the port's: ``mu`` and ``nu`` trees of tensors on ``device`` (dtypes
    kept), ``count`` a 0-d int32 tensor there."""
    device = resolve_device(device)
    return {"mu": lm_params_from_reference(tree["mu"], device),
            "nu": lm_params_from_reference(tree["nu"], device),
            "count": torch.tensor(int(np.asarray(tree["count"])),
                                  dtype=torch.int32, device=device)}

"""Small shared helpers: device resolution and dtype policy."""
from __future__ import annotations

import numpy as np
import torch

#: the working dtype of the whole port (the reference is float32)
DTYPE = torch.float32


def resolve_device(device="cuda") -> torch.device:
    """Return ``torch.device(device)``, refusing a CUDA request that the
    machine cannot serve.

    The port never picks the CPU by itself: an entry point left at its
    default ``device="cuda"`` on a machine without a CUDA device raises
    here, and the caller has to pass ``device="cpu"`` to run there.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} was requested but no CUDA device is "
            "available; the port does not fall back to the CPU by itself "
            "-- pass device='cpu' (CLI: --device cpu) to run there")
    return dev


def as_tensor(a, device, dtype=DTYPE) -> torch.Tensor:
    """numpy array / tensor / sequence -> tensor of ``dtype`` on ``device``
    (a read-only numpy array is copied rather than aliased)."""
    if isinstance(a, np.ndarray) and not a.flags.writeable:
        a = a.copy()
    return torch.as_tensor(a, dtype=dtype, device=device)


def tree_map(fn, *trees, leaf=()):
    """Map ``fn`` over the leaves of nested dicts / lists / tuples (the
    parameter trees of the LM stack); values of a type in ``leaf`` count
    as leaves too."""
    t0 = trees[0]
    if isinstance(t0, dict):
        return {k: tree_map(fn, *(t[k] for t in trees), leaf=leaf)
                for k in t0}
    if isinstance(t0, (list, tuple)) and not isinstance(t0, leaf):
        return type(t0)(tree_map(fn, *xs, leaf=leaf) for xs in zip(*trees))
    return fn(*trees)


def tree_leaves(tree):
    """The leaves of a nested dict / list tree in the reference's order
    (``jax.tree.leaves``: dict keys sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_unflatten(like, leaves):
    """``like``'s structure with its leaves taken, in :func:`tree_leaves`'s
    order, from the iterable ``leaves``."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            out = {k: build(t[k]) for k in sorted(t)}
            return {k: out[k] for k in t}
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        return next(it)
    return build(like)

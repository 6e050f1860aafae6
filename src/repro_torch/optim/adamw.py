"""AdamW with decoupled weight decay and global-norm clipping (the port of
``repro/optim/adamw.py``; not ``torch.optim.AdamW``).

Functional over nested dict / list trees of tensors, with the reference's
formula: the global norm of the gradients, clipping to ``clip_norm``, the
bias corrections, then ``p - lr * (step + weight_decay * p)`` in float32,
cast back.  :func:`update` works IN PLACE -- the reference donates the
parameter and state buffers to its jitted step -- on ``params``, ``mu``,
``nu`` and the gradients (clipping scales them), and returns the same
tensors.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from ..core.util import tree_leaves as leaves
from ..core.util import tree_map


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: Callable | float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: Optional[float] = 1.0


def init(params):
    """``{"mu", "nu"}`` zeros like ``params`` and ``count`` a 0-d int32
    tensor on their device."""
    dev = leaves(params)[0].device if leaves(params) else None
    return {"mu": tree_map(torch.zeros_like, params),
            "nu": tree_map(torch.zeros_like, params),
            "count": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(tree, counted=None, reduce=None):
    """sqrt of the sum of squares of every leaf, in float32 (0-d tensor).

    On a mesh, where ``tree`` holds a rank's blocks: ``counted`` (one bool
    a leaf) says which blocks this rank counts -- a block held by several
    ranks (its leaf replicated over an axis) is counted by one of them --
    and ``reduce`` sums the rank's part over the mesh, so that every
    element is counted once."""
    gs = leaves(tree)
    counted = [True] * len(gs) if counted is None else counted
    dev = gs[0].device if gs else None
    total = sum((torch.sum(torch.square(g.float()))
                 for g, c in zip(gs, counted) if c),
                torch.zeros((), dtype=torch.float32, device=dev)
                if reduce is not None else 0)
    if reduce is not None:
        total = reduce(total)
    return torch.sqrt(total)


def update(cfg: AdamWConfig, grads, state, params, *, counted=None,
           reduce=None):
    """One AdamW step; returns ``(params, state, grad_norm)`` -- the norm
    before clipping -- with ``params``, ``state["mu"]``, ``state["nu"]``
    (and ``grads``) updated in place.  ``counted`` / ``reduce``: the
    global norm over a mesh's blocks (:func:`global_norm`)."""
    count = state["count"] + 1
    lr = cfg.lr(count) if callable(cfg.lr) else cfg.lr

    gn = global_norm(grads, counted, reduce)
    if cfg.clip_norm is not None:
        scale = torch.clamp(cfg.clip_norm / torch.clamp(gn, min=1e-12),
                            max=1.0)
        for g in leaves(grads):
            g.mul_(scale)

    b1, b2 = cfg.b1, cfg.b2
    c = count.to(torch.float32)
    bc1 = 1.0 - b1 ** c
    bc2 = 1.0 - b2 ** c
    for p, g, mu, nu in zip(leaves(params), leaves(grads),
                            leaves(state["mu"]), leaves(state["nu"])):
        g = g.float()
        mu.mul_(b1).add_(g * (1 - b1))
        nu.mul_(b2).add_((g * (1 - b2)) * g)
        # the reference's (mu / bc1) / (sqrt(nu / bc2) + eps) and
        # lr * (step + wd * p), each operation as there, in place where
        # that holds at most two leaf-sized temporaries at once
        step = nu / bc2
        step.sqrt_().add_(cfg.eps)
        step = torch.div(mu / bc1, step, out=step)
        p32 = p.float()
        step.add_(cfg.weight_decay * p32).mul_(lr)
        if p.dtype == torch.float32:
            p.sub_(step)
        else:
            p.copy_(p32 - step)
    return params, {"mu": state["mu"], "nu": state["nu"],
                    "count": count}, gn

"""RADiSA-SVRG generalized to deep networks (the port of
``repro/optim/radisa_svrg.py``).

Block-coordinate SVRG over parameter tensors: every outer round an anchor
(params_tilde, a full-batch-ish gradient mu_tilde) is refreshed; each
inner step evaluates a minibatch gradient at BOTH the current and the
anchor parameters and applies the variance-reduced direction to a random
subset of the parameter tensors (the "sub-block exchange").

The subset is a per-tensor Bernoulli(``block_fraction``) mask over the
leaves in the reference's order (dict keys sorted).  The reference draws
it with ``jax.random``, which torch cannot reproduce; as for the solvers'
index streams, :func:`step` takes either a ``torch.Generator`` to draw it
from or the mask itself (``keep=``), which is how the parity tests hand it
the reference's own draw.

    state = init(params)
    state = refresh_anchor(state, params, anchor_grads)
    params, state = step(cfg, params, state, grads_now, grads_anchor, gen)
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.util import tree_leaves as leaves
from ..core.util import tree_map, tree_unflatten


@dataclasses.dataclass(frozen=True)
class RadisaSVRGConfig:
    lr: float = 1e-2
    block_fraction: float = 0.5   # fraction of tensors updated per step


def init(params):
    dev = leaves(params)[0].device if leaves(params) else None
    return {"anchor": tree_map(torch.clone, params),
            "mu": tree_map(torch.zeros_like, params),
            "count": torch.zeros((), dtype=torch.int32, device=dev)}


def refresh_anchor(state, params, anchor_grads):
    return {"anchor": tree_map(torch.clone, params), "mu": anchor_grads,
            "count": state["count"]}


def step(cfg: RadisaSVRGConfig, params, state, grads_now, grads_anchor,
         gen: torch.Generator | None = None, *, keep=None):
    """One inner RADiSA-SVRG step; returns ``(new params, state)``.

    grads_now: minibatch gradient at ``params``; grads_anchor: the same
    minibatch at ``state["anchor"]``.  ``keep``: the per-tensor mask (n
    bools, leaves in the reference's order); without it the mask is drawn
    from ``gen``: tensor i is updated iff a uniform draw is below
    ``block_fraction``.
    """
    ps = leaves(params)
    n = len(ps)
    if keep is None:
        if gen is None:
            raise ValueError("step needs a torch.Generator or keep=")
        keep = torch.rand((n,), generator=gen) < cfg.block_fraction
    if isinstance(keep, torch.Tensor):
        keep = keep.cpu().numpy()
    keep = [bool(x) for x in np.asarray(keep).reshape(-1)]
    if len(keep) != n:
        raise ValueError(f"keep has {len(keep)} entries for {n} tensors")
    new = []
    for i, (p, g, ga, mu) in enumerate(zip(ps, leaves(grads_now),
                                           leaves(grads_anchor),
                                           leaves(state["mu"]))):
        d = g.float() - ga.float() + mu.float()
        rate = cfg.lr if keep[i] else 0.0
        new.append((p.float() - rate * d).to(p.dtype))
    return (tree_unflatten(params, new),
            dict(state, count=state["count"] + 1))

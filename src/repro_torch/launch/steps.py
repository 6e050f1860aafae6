"""Step builders (the port of ``repro/launch/steps.py``): the training step
with gradient accumulation and AdamW, the prefill step and the decode
step, each a plain function of the model's parameter tree on one device.

The reference's sharded spec builders (``param_shardings``,
``opt_shardings``, ``batch_specs``, ``cache_specs``, ``input_specs``)
describe an LM parameter tree laid over a device mesh; they arrive with
the port of LM sharding (ROADMAP queue A item 13c) and the dry run (item
15).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..data.tokens import to_device
from ..models.transformer import Transformer
from ..optim import AdamWConfig, adamw_update
from ..core.util import tree_leaves as leaves
from ..core.util import tree_map


def _largest_divisor_leq(n: int, k: int) -> int:
    """Largest divisor of ``n`` that is <= ``k`` (>=1)."""
    k = max(1, min(n, k))
    while n % k:
        k -= 1
    return k


def _batch_size(batch) -> int:
    return int(np.shape(next(iter(batch.values())))[0])


def loss_and_grads(model: Transformer, params, batch,
                   accum_steps: Optional[int] = None):
    """``(loss, grads)`` of ``model.train_loss`` on ``batch``: the batch
    split along its leading axis into ``acc`` microbatches (the largest
    divisor of B at most ``accum_steps``, default ``cfg.train_accum``),
    run one after another, their gradients summed in float32 and scaled
    by 1 / acc, their losses likewise -- the reference's scan.

    The gradients accumulate in the ``.grad`` of the parameter leaves
    (marked ``requires_grad`` for the microbatches' backward only), one
    microbatch's activations live at a time; ``grads`` is the tree of
    those ``.grad`` tensors, which the caller clears
    (:func:`clear_grads`) once it has used them."""
    batch = to_device(batch, model.device)
    B = _batch_size(batch)
    req = model.cfg.train_accum if accum_steps is None else accum_steps
    acc = _largest_divisor_leq(B, req)
    mb = B // acc
    ps = leaves(params)
    for p in ps:
        p.requires_grad_(True)
        p.grad = None
    total = torch.zeros((), dtype=torch.float32, device=model.device)
    for i in range(acc):
        sub = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
        loss = model.train_loss(params, sub)
        loss.backward()
        total = total + loss.detach()
    for p in ps:
        p.requires_grad_(False)
    grads = tree_map(lambda p: p.grad if p.grad is not None
                     else torch.zeros_like(p), params)
    if acc > 1:
        inv = 1.0 / acc
        total = total * inv
        with torch.no_grad():
            for g in leaves(grads):
                g.mul_(inv)
    return total, grads


def clear_grads(params):
    for p in leaves(params):
        p.grad = None


def make_train_step(model: Transformer, opt_cfg: AdamWConfig,
                    accum_steps: Optional[int] = None):
    """Train step ``(params, opt_state, batch) -> (params, opt_state,
    {"loss", "grad_norm"})``: :func:`loss_and_grads`, then AdamW.

    ``params`` and ``opt_state`` are updated IN PLACE and returned (the
    reference donates both buffers to its jitted step); the metrics are
    0-d tensors on the model's device.  ``batch``: {"tokens", "labels"},
    (B, S) integer numpy arrays or tensors."""
    def train_step(params, opt_state, batch):
        loss, grads = loss_and_grads(model, params, batch, accum_steps)
        with torch.no_grad():
            params, opt_state, gnorm = adamw_update(opt_cfg, grads,
                                                    opt_state, params)
        clear_grads(params)
        return params, opt_state, {"loss": loss, "grad_norm": gnorm}

    return train_step


def make_prefill_step(model: Transformer, cache_len: int):
    def prefill_step(params, batch):
        with torch.no_grad():
            return model.prefill(params, batch, cache_len)

    return prefill_step


def make_decode_step(model: Transformer):
    def serve_step(params, cache, batch):
        with torch.no_grad():
            return model.decode_step(params, cache, batch)

    return serve_step

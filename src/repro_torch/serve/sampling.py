"""Token sampling: greedy / temperature / top-k / top-p, per-request seeds
(counterpart of ``repro/serve/sampling.py``).

All parameters are per-row data, so one call serves every slot of a
continuous batch whatever each request's settings: temperature 0 selects
the greedy branch per row, ``top_k <= 0`` disables top-k, ``top_p >= 1``
disables top-p.

Reproducibility: token ``step`` of the request with integer ``seed`` is
drawn from one uniform number of a CPU ``torch.Generator`` seeded from
``(seed, step)`` (inverse-CDF draw from the filtered distribution), so a
request's stream is independent of which slot it runs in, what else
shares the batch, whether it was preempted and replayed, and of the
device.  The numbers differ from the reference's ``jax.random`` draws;
the keep-masks of the filters and the greedy tokens are the same.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

NEG_INF = -1e30


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    temperature: float = 0.0    # 0 -> greedy argmax
    top_k: int = 0              # <= 0 -> no top-k filtering
    top_p: float = 1.0          # >= 1 -> no nucleus filtering
    seed: int = 0


def _filter_logits(logits, top_k, top_p):
    """Apply top-k / top-p masks to logit rows (..., V); ``top_k`` and
    ``top_p`` broadcast against the leading dims (shape (..., 1)).  Ties
    rank in index order (a stable sort, as ``jnp.argsort``)."""
    V = logits.shape[-1]
    top_k = torch.as_tensor(top_k, device=logits.device)
    top_p = torch.as_tensor(top_p, device=logits.device)
    srt, order = torch.sort(-logits, dim=-1, stable=True)   # descending
    srt = -srt
    ranks = torch.empty_like(order)
    ranks.scatter_(-1, order, torch.arange(V, device=logits.device)
                   .expand_as(order))
    keep = (ranks < top_k) | (top_k <= 0)
    probs = torch.softmax(srt, dim=-1)
    # nucleus: keep tokens whose *preceding* cumulative mass is < top_p
    # (the argmax token always survives: its preceding mass is 0)
    cum_before = torch.cumsum(probs, dim=-1) - probs
    keep_p = torch.empty_like(keep)
    keep_p.scatter_(-1, order, cum_before < top_p)
    return torch.where(keep & keep_p, logits, torch.full_like(logits,
                                                              NEG_INF))


def _uniform(seed: int, step: int) -> float:
    gen = torch.Generator()
    gen.manual_seed((int(seed) * 1_000_003 + int(step)) % (1 << 63))
    return float(torch.rand((), generator=gen, dtype=torch.float64))


def sample_tokens(logits, temperatures, top_ks, top_ps, seeds, steps):
    """Sample one token per row.

    logits: (B, V) float32 on any device; temperatures / top_ps: (B,)
    floats; top_ks / seeds / steps: (B,) ints (host arrays or tensors).
    ``steps`` is the per-request count of tokens already drawn.  Returns
    (B,) int64 on the logits' device.
    """
    dev = logits.device
    temps = torch.as_tensor(temperatures, dtype=torch.float32)
    greedy = torch.argmax(logits, dim=-1)
    if bool((temps <= 0).all()):
        return greedy
    t = temps.to(dev)[:, None]
    scaled = logits / torch.clamp(t, min=1e-6)
    filt = _filter_logits(
        scaled, torch.as_tensor(top_ks, dtype=torch.int64).to(dev)[:, None],
        torch.as_tensor(top_ps, dtype=torch.float32).to(dev)[:, None])
    cdf = torch.cumsum(torch.softmax(filt.float(), dim=-1), dim=-1)
    u = torch.tensor([_uniform(s, k) for s, k in
                      zip(torch.as_tensor(seeds).tolist(),
                          torch.as_tensor(steps).tolist())],
                     dtype=torch.float32, device=dev)
    drawn = torch.searchsorted(cdf, (u * cdf[:, -1])[:, None], right=True)
    drawn = torch.clamp(drawn[:, 0], max=logits.shape[-1] - 1)
    return torch.where(t[:, 0] <= 0, greedy, drawn)


def params_arrays(params_list, steps):
    """Stack per-slot SamplingParams (+ step counters) into host arrays:
    (temperatures, top_ks, top_ps, seeds, steps)."""
    temps = np.asarray([p.temperature for p in params_list], np.float32)
    tks = np.asarray([p.top_k for p in params_list], np.int64)
    tps = np.asarray([p.top_p for p in params_list], np.float32)
    seeds = np.asarray([p.seed for p in params_list], np.int64)
    return temps, tks, tps, seeds, np.asarray(steps, np.int64)

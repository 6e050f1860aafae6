"""Attention for the LM stack (counterpart of ``repro/models/attention.py``).

``chunked_attention`` -- what every prefill and training attention layer
calls -- is the flash attention kernel (in training through its autograd
Function: the kernel forward, autograd through the plain version
backward): on a CUDA tensor it launches a hand-written
kernel (``kernels/flash``: bfloat16 at head dims 64 / 128 / 256 on the tensor
cores, ``csrc/flash_attention_tc.cu``, which rounds p to bfloat16 before
p @ v; everything else float32 inside, ``csrc/flash_attention.cu``), on a
CPU tensor it runs the kernel's plain version (float32 inside, as the
Pallas kernel).  The reference's pure-JAX ``chunked_attention`` instead
scales q in the input dtype and rounds p to it before p @ v, so in
bfloat16 they all agree only to bfloat16 rounding.  ``full_attention`` and
``decode_attention`` are plain PyTorch with the reference's dtype steps;
so is ``decode_attention_partial``, the (max, sum, output) of a decode
over a part of the cache, which a rank of a length-split cache merges with
its "model" group's (``sharding/collectives.py::merge_partials``).

GQA layout: q (B, S, H, D), k/v (B, Skv, KV, D) with G = H // KV query
heads per KV head (query head h reads KV head h // G).
"""
from __future__ import annotations

import torch

from ..kernels.flash import flash_attention

NEG_INF = -1e30


def chunked_attention(q, k, v, *, causal=True, window=None, scale=None):
    """Flash attention. q: (B,S,H,D); k,v: (B,Skv,KV,D) -> (B,S,H,D).

    The tiling is the kernel's own (64 x 64), so the reference's
    ``chunk_q`` / ``chunk_k`` have no counterpart; nor does its
    divisibility requirement -- any S works (the serving engine's buckets
    are multiples of the page size, not of a tile)."""
    return flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                           causal=causal, window=window, scale=scale)


def _masked_softmax(s, mask):
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    return torch.softmax(s, dim=-1)


def full_attention(q, k, v, *, causal=True, window=None, scale=None):
    """Reference O(S^2)-memory attention, plain PyTorch."""
    B, S, H, D = q.shape
    KV = k.shape[2]
    G = H // KV
    scale = scale if scale is not None else D ** -0.5
    qr = q.reshape(B, S, KV, G, D)
    s = torch.einsum("bskgd,bxkd->bskgx", (qr * scale).float(), k.float())
    qp = torch.arange(S, device=q.device)[:, None]
    kp = torch.arange(k.shape[1], device=q.device)[None, :]
    mask = torch.ones((S, k.shape[1]), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qp >= kp
    if window is not None:
        mask &= qp - kp < window
    p = _masked_softmax(s, mask[None, :, None, None, :])
    out = torch.einsum("bskgx,bxkd->bskgd", p.to(v.dtype).float(), v.float())
    return out.reshape(B, S, H, D).to(q.dtype)


def decode_attention(q, k_cache, v_cache, pos, *, window=None, scale=None):
    """Single-token attention against a (B, Smax, KV, D) cache, plain
    PyTorch.

    ``pos``: current position -- an int, or a (B,) integer tensor of
    per-sequence positions (paged / continuous-batching decode).  Entries
    > pos are masked.
    """
    B, _, H, D = q.shape
    KV = k_cache.shape[2]
    G = H // KV
    scale = scale if scale is not None else D ** -0.5
    qr = q.reshape(B, KV, G, D)
    s = torch.einsum("bkgd,bxkd->bkgx", (qr * scale).float(),
                     k_cache.float())
    kp = torch.arange(k_cache.shape[1], device=q.device)
    posv = torch.as_tensor(pos, device=q.device).reshape(-1).expand(B)
    mask = kp[None, :] <= posv[:, None]
    if window is not None:
        mask &= kp[None, :] > posv[:, None] - window
    p = _masked_softmax(s, mask[:, None, None, :])
    out = torch.einsum("bkgx,bxkd->bkgd", p.to(v_cache.dtype).float(),
                       v_cache.float())
    return out.reshape(B, 1, H, D).to(q.dtype)


def decode_attention_partial(q, k_cache, v_cache, valid, *, scale=None):
    """One token's attention over the slots of a (B, n, KV, D) part of a
    cache where ``valid`` (n,) is true, as a partial for the
    flash-decoding merge: ``(m, l, o)`` -- each head's largest valid score
    (B, H), the sum of ``exp(score - m)`` over its valid slots (B, H) and
    that sum's weighting of v (B, H, D), all float32 (p rounded to v's
    dtype before p v, as in :func:`decode_attention`).  A part with no
    valid slot gives m = -inf, l = 0, o = 0 (never NaN)."""
    B, _, H, D = q.shape
    KV = k_cache.shape[2]
    G = H // KV
    scale = scale if scale is not None else D ** -0.5
    qr = q.reshape(B, KV, G, D)
    s = torch.einsum("bkgd,bxkd->bkgx", (qr * scale).float(),
                     k_cache.float())
    s = torch.where(valid[None, None, None, :], s,
                    torch.full_like(s, float("-inf")))
    m = s.amax(dim=-1)
    p = torch.exp(s - torch.where(torch.isfinite(m), m,
                                  torch.zeros_like(m))[..., None])
    o = torch.einsum("bkgx,bxkd->bkgd", p.to(v_cache.dtype).float(),
                     v_cache.float())
    return m.reshape(B, H), p.sum(dim=-1).reshape(B, H), o.reshape(B, H, D)

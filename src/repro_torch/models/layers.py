"""Shared layer primitives: RMSNorm, RoPE, the truncated-normal initializer
(counterpart of ``repro/models/layers.py``).

Parameters are plain dicts of tensors in the reference's tree layout.
Initialisation draws from an explicit ``torch.Generator``: its numbers
differ from ``jax.random``'s, so the parity tests carry the reference's
weights across (``repro_torch.convert.lm_params_from_reference``).
"""
from __future__ import annotations

import torch


def trunc_normal(gen: torch.Generator, shape, scale, dtype, device):
    """``scale`` times a standard normal truncated to [-2, 2]."""
    t = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (t.mul_(scale)).to(dtype)


def rms_norm(x, gamma, eps):
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps)
    return (x * gamma.float()).to(dt)


def head_rms_norm(x, gamma, eps):
    """Per-head q/k norm (qwen3 style); x: (..., heads, head_dim)."""
    return rms_norm(x, gamma, eps)


def rope_freqs(head_dim, theta, device=None):
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x, positions, theta):
    """x: (B, S, H, D); positions: (S,) or (B, S) integer tensor."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)             # (D/2,)
    if positions.dim() == 1:
        ang = positions.float()[:, None] * freqs[None, :]
        ang = ang[None, :, None, :]                    # (1, S, 1, D/2)
    else:
        ang = positions.float()[..., None] * freqs
        ang = ang[:, :, None, :]                       # (B, S, 1, D/2)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., : d // 2], x[..., d // 2:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)

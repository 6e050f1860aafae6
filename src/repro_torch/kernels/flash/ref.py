"""Plain PyTorch version of the flash attention kernel: masked softmax
attention with float32 scores (the port of ``repro/kernels/flash/ref.py``
``mha_ref``).

Layout (BH, S, D): batch*heads flattened, kv already expanded to H heads.
The CPU tests run it, the chip check compares the kernel with it on the
card, and ``ops.flash_attention`` takes it only for tensors on the CPU.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def mha_ref(q, k, v, *, causal=True, window=None, scale=None):
    """q: (BH, S, D); k, v: (BH, Skv, D).  Float32 inside (float64 for
    float64 inputs: a reference for the rounding of the float32 versions);
    returns (BH, S, D) in q's dtype.

    A query row with no unmasked key at all (a sliding window with
    S > Skv + window - 1) comes out 0, as on both CUDA routes and as in
    the Pallas kernel for a query block whose every KV tile is skipped
    (its accumulator stays 0 and is divided by max(l, 1e-30)).  The JAX
    ``mha_ref`` gives such a row the uniform average of v instead; every
    row that has a key agrees with it."""
    BH, S, D = q.shape
    Skv = k.shape[1]
    scale = scale if scale is not None else D ** -0.5
    ct = torch.float64 if q.dtype == torch.float64 else torch.float32
    s = torch.einsum("bsd,bxd->bsx", q.to(ct) * scale, k.to(ct))
    qp = torch.arange(S, device=q.device)[:, None]
    kp = torch.arange(Skv, device=q.device)[None, :]
    mask = torch.ones((S, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qp >= kp
    if window is not None:
        mask &= qp - kp < window
    s = torch.where(mask[None], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    p = torch.where(mask.any(-1)[None, :, None], p, torch.zeros_like(p))
    return torch.einsum("bsx,bxd->bsd", p, v.to(ct)).to(q.dtype)

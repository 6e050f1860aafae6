"""Plain PyTorch version of the chunked RWKV6 linear-attention kernel: the
exact sequential recurrence (the port of ``repro/kernels/linattn/ref.py``
``rwkv_linattn_ref``, same math as ``models/rwkv.py::rwkv_scan``, layout
(BH, S, D)), with ``u`` per head.

The CPU tests run it, the chip check compares the kernel with it on the
card, and ``ops.rwkv_linattn`` takes it only for tensors on the CPU.
"""
from __future__ import annotations

import torch


def per_row_u(u, BH):
    """``u`` as (BH, D) float32: a (D,) u is shared by every row; an (H, D)
    u gives row bh the entry ``u[bh % H]`` (rows ordered b * H + h)."""
    u = u.float()
    if u.dim() == 1:
        return u[None, :].expand(BH, -1)
    H = u.shape[0]
    if BH % H:
        raise ValueError(f"{BH} rows are not a multiple of {H} heads")
    return u.repeat(BH // H, 1)


def rwkv_linattn_ref(r, k, v, logw, u, state0=None, dtype=torch.float32):
    """r, k, v, logw: (BH, S, D); u: (D,) or (H, D).  Returns (out
    (BH, S, D), state (BH, D, D)), computed and returned in ``dtype``
    (float32, as the kernel; float64 gives a reference for the rounding
    of both)."""
    BH, S, D = r.shape
    rt, kt, vt = r.to(dtype), k.to(dtype), v.to(dtype)
    wt = torch.exp(logw.to(dtype))
    uf = per_row_u(u, BH).to(dtype)
    st = (torch.zeros((BH, D, D), dtype=dtype, device=r.device)
          if state0 is None else state0.to(dtype))
    outs = []
    for t in range(S):
        kv = kt[:, t, :, None] * vt[:, t, None, :]           # (BH, D, D)
        outs.append(torch.einsum("bd,bde->be", rt[:, t],
                                 st + uf[:, :, None] * kv))
        st = wt[:, t, :, None] * st + kv
    out = (torch.stack(outs, dim=1) if outs
           else torch.zeros((BH, 0, D), dtype=dtype, device=r.device))
    return out, st

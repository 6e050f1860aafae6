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
    """``u`` as (BH, D) float32 (float64 if it is float64): a (D,) u is
    shared by every row; an (H, D) u gives row bh the entry ``u[bh % H]``
    (rows ordered b * H + h)."""
    u = u if u.dtype == torch.float64 else u.float()
    if u.dim() == 1:
        return u[None, :].expand(BH, -1)
    H = u.shape[0]
    if BH % H:
        raise ValueError(f"{BH} rows are not a multiple of {H} heads")
    return u.repeat(BH // H, 1)


#: tokens whose outputs one batched product forms
BLOCK = 64


def rwkv_linattn_ref(r, k, v, logw, u, state0=None, dtype=torch.float32):
    """r, k, v, logw: (BH, S, D); u: (D,) or (H, D).  Returns (out
    (BH, S, D), state (BH, D, D)), computed and returned in ``dtype``
    (float32, as the kernel; float64 gives a reference for the rounding
    of both).

    The loop over tokens carries only the state, S_t = w_t S_{t-1} +
    k_t^T v_t; the outputs o_t = r_t (S_{t-1} + diag(u) k_t^T v_t) of
    ``BLOCK`` tokens at a time are one batched product over their states
    (the same sums as token by token, and far fewer operations for
    autograd to record and replay)."""
    BH, S, D = r.shape
    rt, kt, vt = r.to(dtype), k.to(dtype), v.to(dtype)
    wt = torch.exp(logw.to(dtype))
    uf = per_row_u(u, BH).to(dtype)
    st = (torch.zeros((BH, D, D), dtype=dtype, device=r.device)
          if state0 is None else state0.to(dtype))
    outs = []
    for t0 in range(0, S, BLOCK):
        kv = kt[:, t0:t0 + BLOCK, :, None] * vt[:, t0:t0 + BLOCK, None, :]
        prev = []
        for i in range(kv.shape[1]):
            prev.append(st)
            st = wt[:, t0 + i, :, None] * st + kv[:, i]
        outs.append(torch.einsum(
            "btd,btde->bte", rt[:, t0:t0 + BLOCK],
            torch.stack(prev, dim=1) + uf[:, None, :, None] * kv))
    out = (torch.cat(outs, dim=1) if outs
           else torch.zeros((BH, 0, D), dtype=dtype, device=r.device))
    return out, st

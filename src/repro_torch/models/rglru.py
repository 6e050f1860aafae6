"""RG-LRU recurrent block (RecurrentGemma / Griffin, arXiv:2402.19427;
counterpart of ``repro/models/rglru.py``).

    r_t = sigmoid(W_r x_t)                       (recurrence gate)
    i_t = sigmoid(W_i x_t)                       (input gate)
    a_t = exp(-c * softplus(Lambda) * r_t)       (per-channel decay, in (0,1))
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

The reference evaluates the linear recurrence with
``lax.associative_scan``.  Here it is a two-level scan in float32
(:func:`linear_scan`): inside chunks of ``SCAN_CHUNK`` steps, the pairs
(cumulative decay, state from a zero start) relative to the chunk start by
log-depth doubling; across chunks, the carry runs sequentially.  Decays
are multiplied, never summed as logarithms (a cumulative sum of log a over
the sequence leaves float32's range once it passes -88), and a product
that underflows to 0 is what the recurrence gives too.  Decode is the
O(1) recurrence.  As in the reference, the gated block without the
temporal conv1d of the full release.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .config import ModelConfig
from .layers import trunc_normal

#: steps a chunk of :func:`linear_scan` (its doubling runs log2 of it)
SCAN_CHUNK = 64


#: the logical axes of one layer's RG-LRU leaves (the reference's
#: ``init_rglru``)
RGLRU_LOGICAL = {"w_x": ("fsdp", "ff"), "w_r": ("fsdp", "ff"),
                 "w_i": ("fsdp", "ff"), "w_o": ("ff", "fsdp"),
                 "lam": ("ff",)}


def init_rglru(gen, cfg: ModelConfig, n: int, device):
    """``n`` stacked layers (leading axis n); ``lam`` such that a^c lies in
    [0.9, 0.999] at r = 1 (the paper's init), the same in every layer."""
    dm = cfg.d_model
    dt = cfg.pdtype
    s = dm ** -0.5
    lin = torch.linspace(0.9, 0.999, dm, dtype=torch.float32)
    lam = torch.log(torch.expm1(-torch.log(lin) / cfg.rglru_c))
    return {
        "w_x": trunc_normal(gen, (n, dm, dm), s, dt, device),
        "w_r": trunc_normal(gen, (n, dm, dm), s, dt, device),
        "w_i": trunc_normal(gen, (n, dm, dm), s, dt, device),
        "w_o": trunc_normal(gen, (n, dm, dm), s, dt, device),
        "lam": lam.to(dt).to(device).expand(n, dm).contiguous(),
    }


def linear_scan(a, b, h0=None, chunk: int = SCAN_CHUNK):
    """h_t = a_t h_{t-1} + b_t over axis 1 of a, b (B, S, C) float32, from
    ``h0`` (B, C) (zeros if None).  Returns h (B, S, C)."""
    B, S, C = a.shape
    T = min(chunk, S)
    n = -(-S // T)
    if n * T != S:                     # identity steps past the end
        a = F.pad(a, (0, 0, 0, n * T - S), value=1.0)
        b = F.pad(b, (0, 0, 0, n * T - S))
    a = a.reshape(B, n, T, C)
    b = b.reshape(B, n, T, C)
    # inside each chunk: (prod a, h from 0) of steps [start, t] by doubling
    for d in (1 << i for i in range(math.ceil(math.log2(T)))):
        a_prev = F.pad(a[:, :, :-d], (0, 0, d, 0), value=1.0)
        b_prev = F.pad(b[:, :, :-d], (0, 0, d, 0))
        b = a * b_prev + b
        a = a * a_prev
    # across chunks: the carry into chunk j, sequentially
    carry = (torch.zeros((B, C), dtype=a.dtype, device=a.device)
             if h0 is None else h0.to(a.dtype))
    carries = []
    for j in range(n):
        carries.append(carry)
        carry = a[:, j, -1] * carry + b[:, j, -1]
    h = b + a * torch.stack(carries, dim=1)[:, :, None]
    return h.reshape(B, n * T, C)[:, :S]


def _gates(params, x, cfg: ModelConfig):
    """(a, gated input) of the recurrence, float32, for x: (B, S, dm)."""
    cdt = cfg.cdtype
    xg = x @ params["w_x"].to(cdt)
    r = torch.sigmoid((x @ params["w_r"].to(cdt)).float())
    i = torch.sigmoid((x @ params["w_i"].to(cdt)).float())
    log_a = -cfg.rglru_c * F.softplus(params["lam"].float()) * r
    a = torch.exp(log_a)
    gated = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12)) \
        * (i * xg.float())
    return a, gated


def rglru_block(params, x, cfg: ModelConfig, *, state=None):
    """x: (B, S, dm) -> (out (B, S, dm), new state (B, dm) float32)."""
    a, gated = _gates(params, x, cfg)
    h = linear_scan(a, gated, state)
    out = h.to(cfg.cdtype) @ params["w_o"].to(cfg.cdtype)
    return out, h[:, -1, :]


def rglru_decode(params, x, cfg: ModelConfig, *, state):
    """One-token recurrence. x: (B, 1, dm); state: (B, dm) float32."""
    a, gated = _gates(params, x, cfg)
    h = a[:, 0, :] * state + gated[:, 0, :]
    out = h[:, None, :].to(cfg.cdtype) @ params["w_o"].to(cfg.cdtype)
    return out, h

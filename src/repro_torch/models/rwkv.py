"""RWKV-6 ("Finch") time-mix layer: linear attention with data-dependent
per-channel decay (arXiv:2404.05892), plus the squared-ReLU channel mix
(counterpart of ``repro/models/rwkv.py``).

State recurrence per head (D = head dim):
    S_t = diag(w_t) S_{t-1} + k_t^T v_t          (S: D x D)
    o_t = r_t (S_{t-1} + diag(u) k_t^T v_t)
with w_t = exp(-exp(wx_t)) data-dependent, u a learned per-head "bonus".

Prefill and training (``rwkv_scan`` from a zero state) run the chunked
linear-attention kernel: on a CUDA tensor the hand-written kernel
(``kernels/linattn``, ``csrc/rwkv_linattn_tc.cu``), on a CPU tensor its
plain version, the exact recurrence; in training through the kernel's
autograd Function, whose backward is autograd through that recurrence.  Decode (one token from a carried state) is the plain
recurrence, as in the reference.

On a rank of a mesh whose "model" axis splits the heads, the time mix's
parameters are the rank's: ``w_r`` ... ``w_w`` its heads' columns, ``u``
its heads, ``w_o`` its rows; the head count is read off ``u``, and
``channel0`` names the first of the rank's channels of the whole
``ln_x`` (the output is then the rank's partial product).  The channel
mix needs nothing of the kind: its ``w_in`` / ``w_out`` views are the
rank's ``d_ff`` columns / rows.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels.linattn import rwkv_linattn, rwkv_linattn_ref
from .config import ModelConfig
from .layers import rms_norm, trunc_normal


#: the logical axes of one layer's time-mix leaves (the reference's
#: ``init_rwkv``)
RWKV_LOGICAL = {
    "w_r": ("fsdp", "heads"), "w_k": ("fsdp", "heads"),
    "w_v": ("fsdp", "heads"), "w_g": ("fsdp", "heads"),
    "w_w": ("fsdp", "heads"), "w_o": ("heads", "fsdp"),
    "u": ("heads", None), "mix": (None, "fsdp"), "ln_x": ("fsdp",),
}
#: ... and of its channel-mix leaves (``init_rwkv_channel_mix``)
CHANNEL_MIX_LOGICAL = {"w_in": ("fsdp", "ff"), "w_out": ("ff", "fsdp"),
                       "mix": ("fsdp",)}


def init_rwkv(gen, cfg: ModelConfig, n: int, device):
    """Time-mix parameters of ``n`` stacked layers (leading axis n)."""
    dm = cfg.d_model
    H, D = cfg.rwkv_heads, cfg.rwkv_head_dim
    dt = cfg.pdtype
    s = dm ** -0.5

    def tn(shape, scale):
        return trunc_normal(gen, (n, *shape), scale, dt, device)

    return {
        "w_r": tn((dm, dm), s), "w_k": tn((dm, dm), s),
        "w_v": tn((dm, dm), s), "w_g": tn((dm, dm), s),
        "w_w": tn((dm, dm), 0.1 * s), "w_o": tn((dm, dm), s),
        "u": tn((H, D), 0.5),
        "mix": torch.full((n, 5, dm), 0.5, dtype=dt, device=device),
        "ln_x": torch.ones((n, dm), dtype=dt, device=device),
    }


def _projections(params, x, x_prev, cfg: ModelConfig):
    """Token-shifted r,k,v,g and log-decay lw. x: (B,S,dm), x_prev shifted."""
    cdt = cfg.cdtype
    mix = params["mix"].to(cdt)
    B, S, dm = x.shape
    H, D = params["u"].shape[0], cfg.rwkv_head_dim

    def mixed(i):
        return x * mix[i] + x_prev * (1.0 - mix[i])

    r = (mixed(0) @ params["w_r"].to(cdt)).reshape(B, S, H, D)
    k = (mixed(1) @ params["w_k"].to(cdt)).reshape(B, S, H, D)
    v = (mixed(2) @ params["w_v"].to(cdt)).reshape(B, S, H, D)
    g = F.silu(mixed(3) @ params["w_g"].to(cdt))
    # data-dependent decay, in log space: log w = -exp(wx), clamped for the
    # numerical safety of the chunked kernel (its contract)
    wx = (mixed(4) @ params["w_w"].to(cdt)).reshape(B, S, H, D)
    logw = -torch.exp(torch.clamp(wx.float(), -20.0, 4.0))
    logw = torch.clamp(logw, min=-8.0)
    return r, k, v, g, logw


def rwkv_scan(r, k, v, logw, u, state0=None):
    """r,k,v,logw: (B,S,H,D); u: (H,D).

    Returns (out (B,S,H,D) float32, final state (B,H,D,D) float32).  From
    a zero state (``state0=None``, prefill) this is the chunked
    linear-attention kernel; from a carried state (decode), its plain
    version, the exact recurrence.
    """
    B, S, H, D = r.shape

    def rows(a):                                     # (B*H, S, D) float32
        return a.float().transpose(1, 2).reshape(B * H, S, D).contiguous()

    if state0 is None:
        out, state = rwkv_linattn(rows(r), rows(k), rows(v), rows(logw), u)
    else:
        out, state = rwkv_linattn_ref(rows(r), rows(k), rows(v), rows(logw),
                                      u, state0.reshape(B * H, D, D))
    return (out.reshape(B, H, S, D).transpose(1, 2),
            state.reshape(B, H, D, D))


def rwkv_time_mix(params, x, cfg: ModelConfig, *, x_last=None, state=None,
                  channel0: int = 0):
    """Full time-mix block. x: (B,S,dm).

    ``x_last``/``state``: decode-time carries ((B,dm) previous input and
    (B,H,D,D) recurrence state).  Returns (out, (new_x_last, new_state)).
    ``channel0``: where the heads of ``params`` start in ``ln_x``.
    """
    B, S, dm = x.shape
    H, D = params["u"].shape[0], cfg.rwkv_head_dim
    if x_last is None:
        x_last = torch.zeros((B, dm), dtype=x.dtype, device=x.device)
    x_prev = torch.cat([x_last[:, None, :].to(x.dtype), x[:, :-1, :]], dim=1)
    r, k, v, g, logw = _projections(params, x, x_prev, cfg)
    out, new_state = rwkv_scan(r, k, v, logw, params["u"], state)
    # per-head group norm, then output gate + projection
    out = rms_norm(out, torch.ones((D,), dtype=out.dtype, device=out.device),
                   1e-5).reshape(B, S, H * D)
    ln_x = params["ln_x"][..., channel0:channel0 + H * D]
    out = out.to(cfg.cdtype) * ln_x.to(cfg.cdtype)
    out = (out * g) @ params["w_o"].to(cfg.cdtype)
    return out, (x[:, -1, :], new_state)


def init_rwkv_channel_mix(gen, cfg: ModelConfig, n: int, device):
    dm, dff = cfg.d_model, cfg.d_ff
    dt = cfg.pdtype
    return {
        "w_in": trunc_normal(gen, (n, dm, dff), dm ** -0.5, dt, device),
        "w_out": trunc_normal(gen, (n, dff, dm), dff ** -0.5, dt, device),
        "mix": torch.full((n, dm), 0.5, dtype=dt, device=device),
    }


def rwkv_channel_mix(params, x, cfg: ModelConfig, *, x_last=None):
    """Squared-ReLU channel mix with token shift. Returns (out, new_x_last)."""
    B, S, dm = x.shape
    cdt = cfg.cdtype
    if x_last is None:
        x_last = torch.zeros((B, dm), dtype=x.dtype, device=x.device)
    x_prev = torch.cat([x_last[:, None, :].to(x.dtype), x[:, :-1, :]], dim=1)
    mix = params["mix"].to(cdt)
    xm = x * mix + x_prev * (1.0 - mix)
    h = torch.square(torch.relu(xm @ params["w_in"].to(cdt)))
    return h @ params["w_out"].to(cdt), x[:, -1, :]

"""Roofline model of one device (the port of ``repro/roofline/model.py``,
its formulas copied; the hardware is the port's card).

    compute term    = FLOPs_per_device / peak_FLOPs
    memory term     = bytes_per_device / HBM_bw
    collective term = wire_bytes_per_device / (links * link_bw)

All three in seconds for ONE step; the dominant term is the bottleneck
and its value is the step-time lower bound.

``HW_H100`` holds the published numbers of the NVIDIA H100 SXM5 80 GB
from NVIDIA's H100 Tensor Core GPU data sheet: 989 TFLOP/s of dense
bfloat16 tensor-core work (the sparse 1979 halved), 3.35 TB/s of HBM3,
and NVLink 4 at 900 GB/s both ways -- 450 GB/s each way, written as 18
links of 25 GB/s.  The NVLink term holds only inside one host of 8 cards
(its NVSwitch); a mesh that spans hosts crosses the network between them
at a rate this model does not know.  The TPU's ``HW_V5E`` of the
reference is not carried over: the port never runs on one.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Hardware:
    name: str
    peak_flops: float        # bf16 FLOP/s per chip
    hbm_bw: float            # bytes/s per chip
    ici_bw: float            # bytes/s per link
    ici_links: int           # usable links per chip


HW_H100 = Hardware("nvidia-h100-sxm5-80gb", peak_flops=989e12,
                   hbm_bw=3.35e12, ici_bw=25e9, ici_links=18)


def roofline_terms(flops, bytes_accessed, wire_bytes, hw: Hardware = HW_H100):
    t_c = flops / hw.peak_flops
    t_m = bytes_accessed / hw.hbm_bw
    t_x = wire_bytes / (hw.ici_bw * hw.ici_links)
    dominant = max(("compute", t_c), ("memory", t_m), ("collective", t_x),
                   key=lambda kv: kv[1])
    return {
        "compute_s": t_c,
        "memory_s": t_m,
        "collective_s": t_x,
        "dominant": dominant[0],
        "bound_s": dominant[1],
    }


def model_flops(cfg, shape) -> float:
    """Useful model FLOPs for the whole step (6*N*D dense / 6*N_active*D).

    N counts backbone + head parameters actually touched per token; for
    decode steps D = batch (one token per sequence), forward only (2ND).
    """
    dm, L, V = cfg.d_model, cfg.n_layers, cfg.vocab
    hd, H, KV = cfg.hd, cfg.n_heads, cfg.n_kv

    from ..models.config import ATTN, LOCAL, RWKV, RGLRU, XATTN
    n_full, n_rem = cfg.n_periods()
    counts = {}
    for j, k in enumerate(cfg.pattern):
        counts[k] = counts.get(k, 0) + n_full + (1 if j < n_rem else 0)

    attn_params = dm * hd * (H + 2 * KV) + H * hd * dm
    rwkv_params = 6 * dm * dm
    rglru_params = 4 * dm * dm
    mixer_params = (counts.get(ATTN, 0) + counts.get(LOCAL, 0)
                    + counts.get(XATTN, 0)) * attn_params \
        + counts.get(RWKV, 0) * rwkv_params \
        + counts.get(RGLRU, 0) * rglru_params

    if cfg.moe is not None:
        active = cfg.moe.top_k
        mlp_params = L * (3 * dm * cfg.d_ff * active + dm * cfg.moe.n_experts)
    elif RWKV in cfg.pattern:
        mlp_params = L * 2 * dm * cfg.d_ff
    else:
        mlp_params = L * 3 * dm * cfg.d_ff

    n_active = mixer_params + mlp_params + dm * V \
        + (dm * V if cfg.embed_input == "tokens" else 0) * 0  # embed is gather

    tokens = shape.batch * (1 if shape.kind == "decode" else shape.seq)
    mult = 6 if shape.kind == "train" else 2
    flops = mult * n_active * tokens

    # attention score/value FLOPs (the quadratic term, not in 6ND)
    if shape.kind != "decode":
        S = shape.seq
        for k, cnt in counts.items():
            if k == ATTN:
                win = cfg.swa_window or S
                eff = min(win, S)
                pairs = S * eff - (eff * (eff - 1)) // 2 if eff < S else \
                    S * (S + 1) // 2
            elif k == LOCAL:
                eff = min(cfg.local_window, S)
                pairs = S * eff - (eff * (eff - 1)) // 2 if eff < S else \
                    S * (S + 1) // 2
            elif k == XATTN:
                pairs = S * cfg.encoder_len
            else:
                continue
            flops += mult // 2 * 2 * 2 * pairs * H * hd * shape.batch
    return float(flops)

"""Model / shape configuration dataclasses (counterpart of
``repro/models/config.py``, the same fields and defaults).

A ``ModelConfig`` describes one architecture; the layer stack is a
repeating ``pattern`` of mixer kinds.  The port keeps the reference's
stacked-parameter layout (one tensor per pattern position with a leading
layer axis) and walks it with a Python loop where the reference scans.
``pdtype`` / ``cdtype`` are torch dtypes here.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

# mixer kinds
ATTN = "attn"        # causal self attention (GQA + RoPE, optional qk-norm/SWA)
XATTN = "xattn"      # cross attention to stub encoder states (VLM)
RWKV = "rwkv"        # RWKV-6 data-dependent-decay linear attention
RGLRU = "rglru"      # RG-LRU gated linear recurrence (recurrentgemma)
LOCAL = "local"      # sliding-window self attention (recurrentgemma 1:2)


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    capacity_factor: float = 1.25
    # sequence-chunk size for the capacity-based dispatch
    chunk: int = 512


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int
    pattern: Tuple[str, ...] = (ATTN,)
    head_dim: Optional[int] = None  # default d_model // n_heads
    moe: Optional[MoEConfig] = None
    qk_norm: bool = False
    swa_window: Optional[int] = None    # sliding window for ATTN mixers
    local_window: int = 2048            # window for LOCAL mixers
    rope_theta: float = 1e6
    norm_eps: float = 1e-6
    embed_input: str = "tokens"         # "tokens" | "embeddings" (stub frontend)
    encoder_len: int = 0                # VLM: number of stub image tokens
    rwkv_head_dim: int = 64
    rglru_c: float = 8.0                # RG-LRU decay sharpness constant
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    # the reference's calibration switch: every layer unrolled (in the
    # port all layers run in a Python loop either way; kept so that the
    # parameter tree has the same periods / remainder split)
    unroll: bool = False
    # "chunked" (flash attention: the hand-written kernel on the card) or
    # "full" (materialized scores, plain PyTorch)
    attn_impl: str = "chunked"
    # training fields, carried for the configuration files; the serving
    # slice does not read them
    train_accum: int = 8
    loss_chunk: Optional[int] = 1024
    remat_policy: str = "nothing"
    # decode KV-cache storage dtype: "bfloat16" or "int8" (a scale per
    # position and KV head)
    kv_cache_dtype: str = "bfloat16"
    notes: str = ""

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def rwkv_heads(self) -> int:
        return self.d_model // self.rwkv_head_dim

    @property
    def sub_quadratic(self) -> bool:
        """True if a 500k-token decode is feasible (no full-attention
        mixer)."""
        return not (ATTN in self.pattern and self.swa_window is None)

    @property
    def pdtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    @property
    def cdtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)

    def n_periods(self):
        if self.unroll:
            return 0, self.n_layers
        k = len(self.pattern)
        return self.n_layers // k, self.n_layers % k


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq: int            # sequence length (train) or KV-cache length (decode)
    batch: int          # global batch
    kind: str           # "train" | "prefill" | "decode"


#: the reference's input shapes of the LM cells
LM_SHAPES = (
    ShapeConfig("train_4k", 4096, 256, "train"),
    ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    ShapeConfig("decode_32k", 32768, 128, "decode"),
    ShapeConfig("long_500k", 524288, 1, "decode"),
)


def reduced(cfg: ModelConfig, **overrides) -> ModelConfig:
    """A tiny same-family config for CPU smoke tests (the reference's
    sizes, so a reduced config names the same shapes in both packages)."""
    kw = dict(
        n_layers=max(len(cfg.pattern), 2) if len(cfg.pattern) > 1 else 2,
        d_model=64,
        n_heads=4,
        n_kv=max(1, min(cfg.n_kv, 2)),
        d_ff=128,
        vocab=256,
        head_dim=16,
        rwkv_head_dim=16,
        encoder_len=8 if cfg.encoder_len else 0,
        swa_window=16 if cfg.swa_window else None,
        local_window=16,
    )
    if cfg.moe is not None:
        kw["moe"] = MoEConfig(n_experts=4, top_k=2, chunk=8,
                              capacity_factor=4.0)
    if cfg.pattern == (RGLRU, RGLRU, ATTN):
        kw["n_layers"] = 5   # exercises the remainder (5 = 3 + 2) path
    if XATTN in cfg.pattern:
        kw["n_layers"] = len(cfg.pattern) * 2
    kw.update(overrides)
    return dataclasses.replace(cfg, name=cfg.name + "-smoke", **kw)

"""The LM stack of the port: config, layers, attention (the flash kernel
in prefill and training), RWKV-6 (the linear-attention kernel), MoE,
RG-LRU and the decoder with its ring-buffer (bfloat16 or int8) and paged
caches."""
from .config import (ATTN, LM_SHAPES, LOCAL, RGLRU, RWKV, XATTN,
                     ModelConfig, MoEConfig, ShapeConfig, reduced)
from .transformer import Transformer

__all__ = ["ATTN", "LM_SHAPES", "LOCAL", "RGLRU", "RWKV", "XATTN",
           "ModelConfig", "MoEConfig", "ShapeConfig", "Transformer",
           "reduced"]

"""The LM stack of the port, serving half: config, layers, attention (the
flash kernel in prefill), RWKV-6 (the linear-attention kernel in prefill)
and the decoder with its ring-buffer and paged caches."""
from .config import (ATTN, LOCAL, RGLRU, RWKV, XATTN, ModelConfig,
                     MoEConfig, reduced)
from .transformer import Transformer

__all__ = ["ATTN", "LOCAL", "RGLRU", "RWKV", "XATTN", "ModelConfig",
           "MoEConfig", "Transformer", "reduced"]

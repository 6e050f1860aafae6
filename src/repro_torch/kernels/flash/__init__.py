from .ops import flash_attention, flash_attention_plain
from .ref import mha_ref

__all__ = ["flash_attention", "flash_attention_plain", "mha_ref"]

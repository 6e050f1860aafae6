from .ops import (flash_attention, flash_attention_backward,
                  flash_attention_backward_plain, flash_attention_plain,
                  flash_route)
from .ref import mha_ref

__all__ = ["flash_attention", "flash_attention_backward",
           "flash_attention_backward_plain", "flash_attention_plain",
           "flash_route", "mha_ref"]

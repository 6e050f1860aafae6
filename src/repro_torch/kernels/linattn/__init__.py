from .ops import (linattn_route, rwkv_linattn, rwkv_linattn_backward,
                  rwkv_linattn_backward_plain)
from .ref import rwkv_linattn_ref

__all__ = ["linattn_route", "rwkv_linattn", "rwkv_linattn_backward",
           "rwkv_linattn_backward_plain", "rwkv_linattn_ref"]

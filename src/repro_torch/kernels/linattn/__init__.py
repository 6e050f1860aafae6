from .ops import rwkv_linattn
from .ref import rwkv_linattn_ref

__all__ = ["rwkv_linattn", "rwkv_linattn_ref"]

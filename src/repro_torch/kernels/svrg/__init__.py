from .ops import svrg_inner
from .ref import svrg_inner_plain

__all__ = ["svrg_inner", "svrg_inner_plain"]

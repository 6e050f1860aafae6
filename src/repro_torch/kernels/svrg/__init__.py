from .ops import svrg_inner, svrg_route
from .ref import svrg_inner_plain
from .sparse import (svrg_inner_sparse, svrg_inner_sparse_plain,
                     svrg_sparse_route)

__all__ = ["svrg_inner", "svrg_inner_plain", "svrg_inner_sparse",
           "svrg_inner_sparse_plain", "svrg_route", "svrg_sparse_route"]

from .ops import sdca_epoch, sdca_route
from .ref import sdca_epoch_plain
from .sparse import (sdca_epoch_sparse, sdca_epoch_sparse_plain,
                     sdca_sparse_route)

__all__ = ["sdca_epoch", "sdca_epoch_plain", "sdca_epoch_sparse",
           "sdca_epoch_sparse_plain", "sdca_route", "sdca_sparse_route"]

from .ops import sdca_epoch
from .ref import sdca_epoch_plain

__all__ = ["sdca_epoch", "sdca_epoch_plain"]

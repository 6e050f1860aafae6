"""The fault-tolerant training loop (counterpart of ``repro.runtime``)."""
from .trainer import Trainer, TrainerConfig

__all__ = ["Trainer", "TrainerConfig"]

"""Optimizers of the LM training stack (the port of ``repro.optim``):
AdamW, the learning-rate schedules and RADiSA-SVRG for deep nets, each
functional over the nested dict / list parameter trees of
``repro_torch.models.Transformer``."""
from . import radisa_svrg
from .adamw import (AdamWConfig, global_norm, init as adamw_init,
                    update as adamw_update)
from .schedules import constant, inverse_sqrt, warmup_cosine

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "global_norm",
           "constant", "inverse_sqrt", "warmup_cosine", "radisa_svrg"]


def __getattr__(name):
    # `compression` is a deprecation shim over repro_torch.core.compress;
    # load it lazily so `import repro_torch.optim` (AdamW users) stays
    # silent and only actual use of the legacy path warns
    if name == "compression":
        import importlib
        return importlib.import_module(".compression", __name__)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

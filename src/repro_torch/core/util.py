"""Small shared helpers: device resolution and dtype policy."""
from __future__ import annotations

import numpy as np
import torch

#: the working dtype of the whole port (the reference is float32)
DTYPE = torch.float32


def resolve_device(device="cuda") -> torch.device:
    """Return ``torch.device(device)``, refusing a CUDA request that the
    machine cannot serve.

    The port never picks the CPU by itself: an entry point left at its
    default ``device="cuda"`` on a machine without a CUDA device raises
    here, and the caller has to pass ``device="cpu"`` to run there.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} was requested but no CUDA device is "
            "available; the port does not fall back to the CPU by itself "
            "-- pass device='cpu' (CLI: --device cpu) to run there")
    return dev


def as_tensor(a, device, dtype=DTYPE) -> torch.Tensor:
    """numpy array / tensor / sequence -> tensor of ``dtype`` on ``device``
    (a read-only numpy array is copied rather than aliased)."""
    if isinstance(a, np.ndarray) and not a.flags.writeable:
        a = a.copy()
    return torch.as_tensor(a, dtype=dtype, device=device)

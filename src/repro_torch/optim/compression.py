"""DEPRECATED: moved to :mod:`repro_torch.core.compress`.

The int8 + error-feedback primitives that lived here are the ``int8``
codec of the compressed-communication subsystem
(``repro_torch.core.compress``), which plugs into every solver's declared
CommSchedule via ``get_solver(...)(compression="int8")`` and adds fp8 /
top-k codecs, per-collective policies and exact bytes-on-wire accounting.

This shim re-exports the tree-level helpers (the same objects) and warns
on import.
"""
from __future__ import annotations

import warnings

from repro_torch.core.compress import (compress, decompress,  # noqa: F401
                                       init_error)

warnings.warn(
    "repro_torch.optim.compression is deprecated; use "
    "repro_torch.core.compress (same init_error/compress/decompress "
    "helpers, plus codecs, per-collective CompressionPolicy and wire "
    "accounting)",
    DeprecationWarning, stacklevel=2)

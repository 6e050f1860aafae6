"""DEPRECATED: moved to :mod:`repro_torch.obs.serve` (telemetry).

``ServeMetrics`` is :class:`repro_torch.obs.serve.RequestMetrics`, which
writes every aggregate through a :class:`repro_torch.obs.metrics.Registry`
(one ``snapshot()`` schema shared with solver telemetry), adds p90 to the
default percentile set, and makes ``summary()`` skip unfinished requests.

This shim keeps the old import path working (the same engine-facing API)
and warns on import.
"""
from __future__ import annotations

import warnings

from repro_torch.obs.metrics import percentiles  # noqa: F401
from repro_torch.obs.serve import RequestMetrics

warnings.warn(
    "repro_torch.serve.metrics is deprecated; use repro_torch.obs.serve."
    "RequestMetrics (same lifecycle API, registry-backed, p90 in the "
    "default percentiles) and repro_torch.obs.metrics.percentiles",
    DeprecationWarning, stacklevel=2)


class ServeMetrics(RequestMetrics):
    """Legacy name for :class:`repro_torch.obs.serve.RequestMetrics`."""

"""Serving of the port (counterpart of ``repro.serve``): the
continuous-batching inference engine -- the paged KV-cache pool
(``cache``), the scheduler (``engine``), per-request seeded sampling
(``sampling``) -- and the linear models' ``LinearScorer`` (``scoring``),
which the online service swaps published snapshots into.  ``metrics`` is
the deprecation shim of ``ServeMetrics`` over ``obs.serve``."""
from ..obs.metrics import percentiles
from ..obs.serve import RequestMetrics
from .cache import PagePool, PagedCacheConfig, make_paged_arenas
from .engine import EngineConfig, InferenceEngine, Request
from .sampling import SamplingParams, sample_tokens
from .scoring import LinearScorer

__all__ = [
    "PagePool", "PagedCacheConfig", "make_paged_arenas",
    "EngineConfig", "InferenceEngine", "Request",
    "RequestMetrics", "percentiles",
    "SamplingParams", "sample_tokens",
    "LinearScorer", "ServeMetrics",
]


def __getattr__(name):
    # lazy: importing repro_torch.serve stays silent; touching the legacy
    # name (not the package) is what warns
    if name == "ServeMetrics":
        from .metrics import ServeMetrics
        return ServeMetrics
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

"""Continuous-batching inference engine of the port (counterpart of
``repro.serve``): the paged KV-cache pool (``cache``), the scheduler
(``engine``) and per-request seeded sampling (``sampling``).  The
doubly-distributed ``LinearScorer`` of the reference belongs to the online
slice (ROADMAP queue A item 9)."""
from ..obs.metrics import percentiles
from ..obs.serve import RequestMetrics
from .cache import PagePool, PagedCacheConfig, make_paged_arenas
from .engine import EngineConfig, InferenceEngine, Request
from .sampling import SamplingParams, sample_tokens

__all__ = [
    "PagePool", "PagedCacheConfig", "make_paged_arenas",
    "EngineConfig", "InferenceEngine", "Request",
    "RequestMetrics", "percentiles",
    "SamplingParams", "sample_tokens",
]

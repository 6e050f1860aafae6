"""Telemetry of the port: the metrics registry and the serving engine's
request metrics.  Tracing, health rules, the flight recorder and the HTTP
endpoint are ROADMAP queue A item 11 (observability)."""
from .metrics import Registry, percentiles
from .serve import RequestMetrics

__all__ = ["Registry", "RequestMetrics", "percentiles"]

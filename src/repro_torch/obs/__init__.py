"""repro_torch.obs -- telemetry of the port: tracing, metrics, phase
attribution, flight recorder, health rules, Prometheus endpoint (the
reference's ``repro/obs``, with the same names).

Modules:
  * ``trace``    -- :class:`Tracer`: nestable spans with an injectable
                    clock, thread-safe, near-zero overhead when disabled
                    (``NULL_TRACER``); Chrome-trace JSON and JSONL
                    exports; optional ``torch.profiler.record_function``
                    pass-through so spans appear in device profiles.  A
                    span never waits for the device by itself
  * ``metrics``  -- :class:`Registry` of labelled counters / gauges /
                    histograms holding Python floats, one ``snapshot()``
                    schema
  * ``phases``   -- the local-solve / communication split of a grid
                    program, timed with CUDA events against its
                    collective-free ``local_step``; per-codec timing
  * ``serve``    -- :class:`RequestMetrics`: the serving engine's
                    request-lifecycle bookkeeping
  * ``recorder`` -- :class:`FlightRecorder`: a bounded ring-buffer tracer
                    with atomic postmortem bundles in the reference's
                    layout (each package's :func:`load_bundle` reads the
                    other's)
  * ``health``   -- the :class:`HealthRule` catalog over the registry and
                    the :class:`HealthMonitor` that evaluates it
  * ``export``   -- Prometheus text rendering of a snapshot and its
                    validating parser
  * ``http``     -- :class:`ObsServer`: ``/metrics``, ``/healthz``,
                    ``/varz`` on a background thread that never touches
                    the device

Nothing in this package imports ``repro_torch.core`` or
``repro_torch.serve``: the layer sits below both and is threaded through
them (``core/engines.py::drive``, ``Solver.solve`` / ``update``, the
online service, the fleet, the serving engine and the four CLIs through
``launch/obs.py``).
"""
from .export import parse_prometheus_text, render_prometheus
from .health import (CRIT, OK, WARN, HealthEvent, HealthMonitor, HealthRule,
                     fleet_rules, online_rules, rule_comm_exposed,
                     rule_divergence, rule_fleet_starvation, rule_gap_stall,
                     rule_queue_shed, rule_staleness, rule_version_lag,
                     serve_rules, solver_rules)
from .http import ObsServer
from .metrics import Counter, Gauge, Histogram, Registry, percentiles
from .phases import PhaseSplit, bench_codecs, calibrate_phases
from .recorder import BUNDLE_SCHEMA, FlightRecorder, load_bundle
from .serve import RequestMetrics
from .trace import NULL_TRACER, NullTracer, Tracer, as_tracer

__all__ = [
    "Counter", "Gauge", "Histogram", "Registry", "percentiles",
    "PhaseSplit", "bench_codecs", "calibrate_phases",
    "RequestMetrics",
    "NULL_TRACER", "NullTracer", "Tracer", "as_tracer",
    "BUNDLE_SCHEMA", "FlightRecorder", "load_bundle",
    "OK", "WARN", "CRIT", "HealthEvent", "HealthRule", "HealthMonitor",
    "rule_divergence", "rule_gap_stall", "rule_staleness",
    "rule_version_lag", "rule_queue_shed", "rule_fleet_starvation",
    "rule_comm_exposed",
    "solver_rules", "online_rules", "serve_rules", "fleet_rules",
    "render_prometheus", "parse_prometheus_text",
    "ObsServer",
]

"""Metrics registry: labelled counters / gauges / histograms (a copy of the
reference's ``repro/obs/metrics.py``, which imports no jax).

One :class:`Registry` absorbs the repo's scattered bookkeeping dialects
-- the serving engine's percentile counters, the solver driver's
per-iteration history fields, the compressed-comm wire accounting --
behind a single ``snapshot()`` schema every BENCH emitter can embed::

    reg = Registry()
    reg.counter("serve/prefills").inc()
    reg.gauge("solver/objective", solver="d3ca").set(0.31)
    reg.histogram("solver/step_s", solver="d3ca").observe(0.002)
    reg.snapshot()
    # {"counters":   {"serve/prefills": 1},
    #  "gauges":     {"solver/objective{solver=d3ca}": 0.31},
    #  "histograms": {"solver/step_s{solver=d3ca}":
    #                   {"count": 1, "sum": ..., "mean": ..., "min": ...,
    #                    "max": ..., "p50": ..., "p90": ..., "p99": ...}}}

Metrics are host-side and cheap (a dict lookup + float op per update);
get-or-create is lock-protected so engine threads can share a registry,
and every *update* (``inc`` / ``observe``) is itself lock-protected so
concurrent writers never lose increments and a concurrent ``snapshot()``
always sees a self-consistent histogram (the online service scores and
publishes from different threads; the obs HTTP endpoint scrapes from a
third).  The default percentile set is (50, 90, 99) -- p90 joined
p50/p99 when the serving metrics moved here (the SLO middle ground the
serve ROADMAP item needs).

Histograms are **bounded**: ``count`` / ``sum`` / ``min`` / ``max`` are
exact running aggregates, while percentiles come from a fixed-size
reservoir (Vitter's algorithm R, deterministic per-histogram PRNG).
Below ``reservoir`` observations the reservoir holds every observation
in arrival order, so the percentile summaries are bit-identical to the
unbounded implementation; beyond it the memory stays O(reservoir) no
matter how long the service runs.
"""
from __future__ import annotations

import random
import threading
from typing import Dict, List, Tuple

import numpy as np

#: default percentile set for histograms and the legacy helpers
DEFAULT_PERCENTILES = (50, 90, 99)

#: default histogram reservoir size: exact percentiles below this many
#: observations, O(1) memory above (long-running services observe
#: millions of step/update/latency samples)
DEFAULT_RESERVOIR = 4096


def percentiles(xs, qs: Tuple[int, ...] = DEFAULT_PERCENTILES) -> dict:
    """{f"p{q}": value} over ``xs`` (empty input -> zeros)."""
    if len(xs) == 0:
        return {f"p{q}": 0.0 for q in qs}
    arr = np.asarray(xs, np.float64)
    return {f"p{q}": float(np.percentile(arr, q)) for q in qs}


class Counter:
    """Monotonic float counter (``+=`` semantics via :meth:`inc`).

    ``inc`` is lock-protected: a bare float ``+=`` is read-modify-write
    at the bytecode level, so two threads incrementing concurrently can
    lose updates without it."""

    __slots__ = ("value", "_lock")

    def __init__(self):
        self.value = 0.0
        self._lock = threading.Lock()

    def inc(self, v: float = 1.0):
        with self._lock:
            self.value += v

    def set(self, v: float):
        """Direct assignment -- for shims that mirror legacy attributes
        (``metrics.preemptions += 1`` through a property)."""
        with self._lock:
            self.value = v


class Gauge:
    """Last-value-wins metric (a single assignment is atomic enough)."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, v: float):
        self.value = float(v)


class Histogram:
    """Bounded histogram: exact count/sum/min/max, reservoir percentiles.

    The reservoir (algorithm R, deterministic seed) holds every
    observation in arrival order until ``cap`` is reached -- below the
    cap, ``summary()`` is bit-identical to a summary over the full
    series -- and replaces uniformly at random beyond it, keeping memory
    O(cap) over an unbounded observation stream."""

    __slots__ = ("qs", "cap", "_xs", "_count", "_sum", "_min", "_max",
                 "_rng", "_lock")

    def __init__(self, qs: Tuple[int, ...] = DEFAULT_PERCENTILES,
                 cap: int = DEFAULT_RESERVOIR):
        if cap < 1:
            raise ValueError(f"histogram reservoir cap must be >= 1, "
                             f"got {cap}")
        self.qs = tuple(qs)
        self.cap = int(cap)
        self._xs: List[float] = []
        self._count = 0
        self._sum = 0.0
        self._min = float("inf")
        self._max = float("-inf")
        self._rng = random.Random(0x0B5E7E)   # deterministic reservoir
        self._lock = threading.Lock()

    def observe(self, v: float):
        v = float(v)
        with self._lock:
            self._count += 1
            self._sum += v
            if v < self._min:
                self._min = v
            if v > self._max:
                self._max = v
            if len(self._xs) < self.cap:
                self._xs.append(v)
            else:
                j = self._rng.randrange(self._count)
                if j < self.cap:
                    self._xs[j] = v

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    @property
    def observations(self) -> List[float]:
        """The retained observations (the full series below ``cap``, a
        uniform sample of it above)."""
        with self._lock:
            return list(self._xs)

    def summary(self) -> dict:
        with self._lock:            # consistent (count, sum, reservoir)
            n, s = self._count, self._sum
            mn = self._min if n else 0.0
            mx = self._max if n else 0.0
            xs = list(self._xs)
        out = {"count": n, "sum": s,
               "mean": s / n if n else 0.0,
               "min": mn, "max": mx}
        out.update(percentiles(xs, self.qs))
        return out


def _key(name: str, labels: dict) -> str:
    if not labels:
        return name
    inner = ",".join(f"{k}={labels[k]}" for k in sorted(labels))
    return f"{name}{{{inner}}}"


class Registry:
    """Get-or-create store of labelled metrics with one snapshot schema.

    The same (kind, name, labels) triple always returns the same metric
    object; a name may exist as several kinds (a gauge tracking the
    latest value and a histogram of the series do not collide).
    """

    def __init__(self):
        self._metrics: Dict[Tuple[str, str], object] = {}
        self._lock = threading.Lock()

    def _get(self, kind: str, name: str, labels: dict, factory):
        key = (kind, _key(name, labels))
        m = self._metrics.get(key)
        if m is None:
            with self._lock:
                m = self._metrics.setdefault(key, factory())
        return m

    def counter(self, name: str, **labels) -> Counter:
        return self._get("counter", name, labels, Counter)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get("gauge", name, labels, Gauge)

    def histogram(self, name: str, qs: Tuple[int, ...] = DEFAULT_PERCENTILES,
                  cap: int = DEFAULT_RESERVOIR, **labels) -> Histogram:
        return self._get("histogram", name, labels,
                         lambda: Histogram(qs, cap))

    def snapshot(self) -> dict:
        """The one schema every BENCH emitter embeds: plain JSON-able
        dicts keyed by ``name{label=value,...}``."""
        with self._lock:
            items = list(self._metrics.items())
        out = {"counters": {}, "gauges": {}, "histograms": {}}
        for (kind, key), metric in sorted(items):
            if kind == "counter":
                out["counters"][key] = metric.value
            elif kind == "gauge":
                out["gauges"][key] = metric.value
            else:
                out["histograms"][key] = metric.summary()
        return out

"""Request-lifecycle metrics for the serving engine, registry-backed (a
copy of the reference's ``repro/obs/serve.py``, which imports no jax).

:class:`RequestMetrics` -- ``start_request`` / ``first_token`` /
``finish`` around the step loop, ``summary()`` at the end, attribute
counters (``preemptions`` / ``rejections`` / ``decode_steps`` /
``prefills``) that the engine bumps with ``+=`` -- writes every aggregate
through a :class:`~repro_torch.obs.metrics.Registry`, so one
``registry.snapshot()`` carries the serving numbers.  ``summary()`` skips
unfinished requests and reports their count as ``requests_unfinished``;
TTFT / latency observations land in the registry histograms
``serve/ttft_s`` and ``serve/latency_s`` at finish time.  The clock is
injectable for deterministic tests.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

from .metrics import Registry, percentiles


@dataclasses.dataclass
class _RequestRecord:
    arrival: float
    n_prompt: int
    first_token: Optional[float] = None
    finish: Optional[float] = None
    n_generated: int = 0


def _counter_property(name: str):
    def get(self):
        return self.registry.counter(name).value

    def set_(self, v):
        self.registry.counter(name).set(v)

    return property(get, set_)


class RequestMetrics:
    """Serving metrics: tokens/s, TTFT, latency percentiles."""

    def __init__(self, clock=time.perf_counter,
                 registry: Optional[Registry] = None):
        self.clock = clock
        self.registry = registry if registry is not None else Registry()
        self._req: Dict[object, _RequestRecord] = {}
        self._t0: Optional[float] = None
        self._t1: Optional[float] = None

    # engine-side "metrics.X += 1" attributes, backed by registry counters
    preemptions = _counter_property("serve/preemptions")
    rejections = _counter_property("serve/rejections")
    decode_steps = _counter_property("serve/decode_steps")
    prefills = _counter_property("serve/prefills")

    # ---- per-request lifecycle ----
    def start_request(self, rid, n_prompt, arrival=None):
        t = self.clock() if arrival is None else arrival
        if self._t0 is None:
            self._t0 = t
        # re-registration after preemption keeps the ORIGINAL arrival
        if rid not in self._req:
            self._req[rid] = _RequestRecord(arrival=t, n_prompt=n_prompt)

    def first_token(self, rid):
        rec = self._req.get(rid)
        if rec is not None and rec.first_token is None:
            rec.first_token = self.clock()

    def finish(self, rid, n_generated):
        rec = self._req.get(rid)
        if rec is None:             # finish without start: count nothing
            return
        rec.finish = self.clock()
        rec.n_generated = n_generated
        self._t1 = rec.finish
        reg = self.registry
        reg.counter("serve/requests_finished").inc()
        reg.counter("serve/generated_tokens").inc(n_generated)
        if rec.first_token is not None:
            reg.histogram("serve/ttft_s").observe(
                rec.first_token - rec.arrival)
        reg.histogram("serve/latency_s").observe(rec.finish - rec.arrival)

    # ---- aggregates ----
    def _done(self) -> List[_RequestRecord]:
        return [r for r in self._req.values() if r.finish is not None]

    @property
    def generated_tokens(self) -> int:
        return sum(r.n_generated for r in self._done())

    @property
    def elapsed(self) -> float:
        if self._t0 is None or self._t1 is None:
            return 0.0
        return max(self._t1 - self._t0, 1e-9)

    def tokens_per_sec(self) -> float:
        return self.generated_tokens / self.elapsed if self._done() else 0.0

    def summary(self) -> dict:
        # unfinished requests (queued, in flight, or preempted and never
        # replayed) are SKIPPED, never raised on -- a cut-short trace
        # must still summarize cleanly
        done = self._done()
        ttft = [r.first_token - r.arrival for r in done
                if r.first_token is not None]
        lat = [r.finish - r.arrival for r in done]
        out = {
            "requests_finished": len(done),
            "requests_unfinished": len(self._req) - len(done),
            "generated_tokens": self.generated_tokens,
            "elapsed_s": self.elapsed,
            "tokens_per_sec": self.tokens_per_sec(),
            "ttft_s": percentiles(ttft),
            "latency_s": percentiles(lat),
            "prefills": int(self.prefills),
            "decode_steps": int(self.decode_steps),
            "preemptions": int(self.preemptions),
            "rejections": int(self.rejections),
        }
        self.registry.gauge("serve/tokens_per_sec").set(
            out["tokens_per_sec"])
        self.registry.gauge("serve/elapsed_s").set(out["elapsed_s"])
        return out

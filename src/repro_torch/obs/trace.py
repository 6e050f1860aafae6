"""Structured tracing: nestable spans, Chrome-trace / JSONL exporters
(the port of the reference's ``repro/obs/trace.py``; same event dicts,
same payloads).

A :class:`Tracer` records *spans* -- named wall-clock intervals that
nest (outer_iter > step > comm/dalpha ...) -- plus *instant* events.
Design constraints, in order:

  1. **near-zero overhead when disabled**: the module-level
     :data:`NULL_TRACER` hands out one shared no-op span object, so an
     instrumented hot loop costs a method call per span when tracing is
     off;
  2. **injectable clock** for deterministic tests (``clock=`` takes any
     ``() -> float`` in seconds);
  3. **thread-safe**: span stacks are per-thread (serving runs the
     engine loop on one thread and callbacks elsewhere), the event list
     is lock-protected;
  4. **post-measured spans**: phase attribution times a whole outer
     step and then *synthesizes* child spans inside the measured
     interval (:meth:`Tracer.record`), since the kernels of a step run
     asynchronously to the host and cannot be timed one by one from it.

A span reads the host clock and **never waits for the device**: on a
CUDA device the kernels a span launches may still be running when it
closes.  The code that needs a span to cover device work (the timed
outer step of ``core/engines.py::drive``, the serving engine's prefill
and decode, which read their tokens back) waits for the device itself,
inside the span.

Exports: :meth:`Tracer.to_chrome_trace` produces the Trace Event Format
consumed by ``chrome://tracing`` and https://ui.perfetto.dev (complete
"X" events, microsecond timestamps); :meth:`Tracer.write_jsonl` writes
one JSON object per event for ad-hoc analysis.

Optional ``profiler_annotations=True`` additionally enters a
``torch.profiler.record_function`` for every live span, so the same
names show up in a ``torch.profiler`` trace (and in Nsight under
``torch.autograd.profiler.emit_nvtx``).
"""
from __future__ import annotations

import json
import threading
import time
from typing import Any, Dict, List, Optional


def _profiler_annotation(name: str):
    import torch
    return torch.profiler.record_function(name)


class _Span:
    """A live span; created by :meth:`Tracer.span`, closed on exit."""

    __slots__ = ("_tracer", "name", "args", "_t0", "_ann")

    def __init__(self, tracer: "Tracer", name: str, args: Optional[dict]):
        self._tracer = tracer
        self.name = name
        self.args = args
        self._t0 = 0.0
        self._ann = None

    def __enter__(self):
        tr = self._tracer
        if tr.profiler_annotations:
            self._ann = _profiler_annotation(self.name)
            self._ann.__enter__()
        tr._stack().append(self.name)
        self._t0 = tr.clock()
        return self

    def __exit__(self, exc_type, exc, tb):
        tr = self._tracer
        t1 = tr.clock()
        stack = tr._stack()
        stack.pop()
        tr._push_event(self.name, self._t0, t1 - self._t0, len(stack),
                       self.args)
        if self._ann is not None:
            self._ann.__exit__(exc_type, exc, tb)
        return False


class _NullSpan:
    """Shared no-op context manager handed out by the null tracer."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False


_NULL_SPAN = _NullSpan()


class Tracer:
    """Collects spans and instants; exports Chrome-trace JSON / JSONL.

    Events are dicts ``{name, ts, dur, depth, tid, args}`` with ``ts``
    (seconds since the tracer's epoch -- its construction time under the
    injected clock) and ``dur`` in seconds; instants have ``dur=None``.
    """

    def __init__(self, clock=time.perf_counter, enabled: bool = True,
                 profiler_annotations: bool = False):
        self.clock = clock
        self.enabled = enabled
        self.profiler_annotations = profiler_annotations
        self.events: List[Dict[str, Any]] = []
        self._lock = threading.Lock()
        self._local = threading.local()
        self.epoch = clock()

    # -- recording -----------------------------------------------------------
    def span(self, name: str, **args):
        """Context manager timing a named span; ``args`` land in the
        Chrome-trace ``args`` payload."""
        if not self.enabled:
            return _NULL_SPAN
        return _Span(self, name, args or None)

    def record(self, name: str, t0: float, dur: float, **args):
        """Add an already-measured span (``t0`` in this tracer's clock).
        Used to synthesize attribution spans inside a timed interval --
        e.g. per-collective comm spans inside a timed outer step."""
        if not self.enabled:
            return
        self._push_event(name, t0, dur, len(self._stack()), args or None)

    def instant(self, name: str, **args):
        """Add a zero-duration marker event at the current clock."""
        if not self.enabled:
            return
        self._push_event(name, self.clock(), None, len(self._stack()),
                         args or None)

    def now(self) -> float:
        return self.clock()

    # -- internals -----------------------------------------------------------
    def _stack(self) -> list:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def _event(self, name, t0, dur, depth, args) -> dict:
        ev = {"name": name, "ts": t0 - self.epoch,
              "dur": dur, "depth": depth,
              "tid": threading.get_ident()}
        if args:
            ev["args"] = args
        return ev

    def _push_event(self, name, t0, dur, depth, args):
        ev = self._event(name, t0, dur, depth, args)
        with self._lock:
            self.events.append(ev)

    # -- export --------------------------------------------------------------
    def to_chrome_trace(self) -> dict:
        """Trace Event Format payload (load in chrome://tracing or
        https://ui.perfetto.dev): complete ``"X"`` events with
        microsecond ``ts``/``dur``, instants as ``"i"`` events."""
        out = []
        with self._lock:
            events = list(self.events)
        for ev in events:
            entry = {"name": ev["name"], "cat": "repro", "pid": 0,
                     "tid": ev["tid"], "ts": ev["ts"] * 1e6}
            if ev["dur"] is None:
                entry["ph"] = "i"
                entry["s"] = "t"
            else:
                entry["ph"] = "X"
                entry["dur"] = ev["dur"] * 1e6
            if "args" in ev:
                entry["args"] = ev["args"]
            out.append(entry)
        return {"traceEvents": out, "displayTimeUnit": "ms"}

    def write_chrome_trace(self, path: str):
        with open(path, "w") as fh:
            json.dump(self.to_chrome_trace(), fh)

    def write_jsonl(self, path: str):
        """One JSON object per event, in recording order."""
        with self._lock:
            events = list(self.events)
        with open(path, "w") as fh:
            for ev in events:
                fh.write(json.dumps(ev) + "\n")

    # -- queries (tests, breakdown summaries) --------------------------------
    def spans(self, name: Optional[str] = None) -> List[Dict[str, Any]]:
        """Finished spans (``dur`` is not None), optionally by name."""
        with self._lock:
            events = list(self.events)
        return [e for e in events if e["dur"] is not None
                and (name is None or e["name"] == name)]

    def total(self, name: str) -> float:
        """Sum of durations over all spans with this name."""
        return sum(e["dur"] for e in self.spans(name))


class NullTracer(Tracer):
    """Disabled tracer: every call is a no-op and :meth:`span` returns
    one shared context-manager object, so instrumented code needs no
    ``if`` guards."""

    def __init__(self):
        super().__init__(clock=lambda: 0.0, enabled=False)

    def span(self, name: str, **args):
        return _NULL_SPAN

    def record(self, name: str, t0: float, dur: float, **args):
        pass

    def instant(self, name: str, **args):
        pass


#: the shared disabled tracer -- default for every instrumented code path
NULL_TRACER = NullTracer()


def as_tracer(tracer) -> Tracer:
    """Normalize an optional tracer argument: None -> NULL_TRACER."""
    return NULL_TRACER if tracer is None else tracer

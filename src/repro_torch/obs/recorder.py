"""Flight recorder: a bounded ring-buffer tracer + postmortem bundles
(the port of the reference's ``repro/obs/recorder.py``: the same bundle
layout and schema tag, so each package's :func:`load_bundle` reads the
other's bundles).

The :class:`~repro_torch.obs.trace.Tracer` accumulates spans without
bound and exports at end-of-run -- right for a batch solve, wrong for
the services that run indefinitely (the online service, the fleet
scheduler, the serve engine).  :class:`FlightRecorder` is the same span
API over a drop-oldest ring buffer: O(capacity) memory forever, cheap
enough to leave on, and always holding the *last* ``capacity`` events
-- the ones that matter when something goes wrong.

Because it subclasses :class:`Tracer`, everything that takes a tracer
(``as_tracer``, ``Solver.solve(tracer=...)``, the serve engine, the
online service, the fleet) works unchanged; ``to_chrome_trace`` / ``write_jsonl``
export the retained tail.

:meth:`FlightRecorder.dump` writes a **postmortem bundle**: one JSON
file carrying the trace tail (Chrome-trace payload, loadable in
ui.perfetto.dev after extracting the ``trace`` field or via
:func:`load_bundle`), the paired registry's ``snapshot()``, and
provenance (git sha, reason, caller metadata).  Bundles are written

  * explicitly (``recorder.dump(path, reason=...)``),
  * on crash (:meth:`crash_guard` re-raises after dumping), or
  * on a health-rule CRIT transition (see :mod:`repro_torch.obs.health` --
    the monitor fires exactly one dump per OK->CRIT edge).

Writes are atomic (tmp file + rename), so a half-written bundle is
never observed by whatever collects them.
"""
from __future__ import annotations

import collections
import contextlib
import json
import os
import subprocess
import time
from typing import Optional

from .trace import Tracer

#: bundle schema identifier (bump on incompatible layout changes); the
#: reference's own tag, since the layout is the same
BUNDLE_SCHEMA = "repro.obs.flight_recorder/1"

#: default ring capacity -- at one outer_iter + step + observe + a few
#: comm spans per iteration this holds on the order of the last ~500
#: iterations of a solve, in a few MB of host memory
DEFAULT_CAPACITY = 4096


def _git_sha() -> Optional[str]:
    try:
        return subprocess.run(
            ["git", "rev-parse", "HEAD"],
            cwd=os.path.dirname(os.path.abspath(__file__)),
            capture_output=True, text=True, timeout=5,
        ).stdout.strip() or None
    except Exception:
        return None


class FlightRecorder(Tracer):
    """A :class:`Tracer` over a fixed-capacity drop-oldest ring buffer.

    Args:
      capacity: maximum retained events; the oldest event is dropped
        (and counted in :attr:`dropped`) when a new one arrives at
        capacity.
      clock: injectable clock, as for :class:`Tracer`.
      registry: optional :class:`~repro_torch.obs.metrics.Registry` whose
        ``snapshot()`` is embedded in every bundle.
      meta: JSON-able dict merged into every bundle's ``meta`` block
        (the services stamp their config here).
      profiler_annotations: see :class:`Tracer`.
    """

    def __init__(self, capacity: int = DEFAULT_CAPACITY,
                 clock=time.perf_counter, registry=None, meta=None,
                 profiler_annotations: bool = False):
        if capacity < 1:
            raise ValueError(f"recorder capacity must be >= 1, "
                             f"got {capacity}")
        super().__init__(clock=clock, enabled=True,
                         profiler_annotations=profiler_annotations)
        self.capacity = int(capacity)
        # the ring: deque(maxlen=) drops the oldest entry on append-at-
        # capacity in O(1); every Tracer export/query path copies it
        # under the lock, so they work unchanged
        self.events = collections.deque(maxlen=self.capacity)
        self.dropped = 0
        self.registry = registry
        self.meta = dict(meta or {})
        self.dumps: list = []           # bundle paths written, in order

    # -- recording -----------------------------------------------------------
    def _push_event(self, name, t0, dur, depth, args):
        ev = self._event(name, t0, dur, depth, args)
        with self._lock:
            if len(self.events) == self.capacity:
                self.dropped += 1
            self.events.append(ev)

    # -- postmortem bundles --------------------------------------------------
    def bundle(self, reason: str = "manual") -> dict:
        """The postmortem payload as a plain JSON-able dict."""
        with self._lock:
            dropped, retained = self.dropped, len(self.events)
        return {
            "schema": BUNDLE_SCHEMA,
            "reason": reason,
            "meta": {"git_sha": _git_sha(),
                     "written_at": time.time(), **self.meta},
            "capacity": self.capacity,
            "retained_events": retained,
            "dropped_events": dropped,
            "trace": self.to_chrome_trace(),
            "metrics": (self.registry.snapshot()
                        if self.registry is not None else None),
        }

    def dump(self, path: str, reason: str = "manual") -> str:
        """Write the bundle to ``path`` atomically; returns ``path``."""
        payload = self.bundle(reason)
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        tmp = os.path.join(d, f".{os.path.basename(path)}.tmp")
        with open(tmp, "w") as fh:
            json.dump(payload, fh)
        os.replace(tmp, path)
        self.dumps.append(path)
        return path

    @contextlib.contextmanager
    def crash_guard(self, path: str):
        """Context manager that dumps a bundle when the body raises
        (reason ``crash:<ExcType>``) and re-raises -- wrap a service's
        main loop in it so the trace tail survives the crash."""
        try:
            yield self
        except BaseException as e:
            try:
                self.dump(path, reason=f"crash:{type(e).__name__}")
            except Exception:
                pass                # never mask the original failure
            raise


def load_bundle(path: str) -> dict:
    """Load and validate a postmortem bundle.

    Checks the schema tag and that the embedded trace is a well-formed
    Chrome-trace payload (the same structure ``chrome://tracing`` /
    Perfetto consume: a ``traceEvents`` list of ``"X"``/``"i"`` events
    with microsecond timestamps).

    Raises:
      ValueError: on a missing/foreign schema tag or a malformed trace.
    """
    with open(path) as fh:
        payload = json.load(fh)
    if payload.get("schema") != BUNDLE_SCHEMA:
        raise ValueError(f"{path}: not a flight-recorder bundle "
                         f"(schema={payload.get('schema')!r}, expected "
                         f"{BUNDLE_SCHEMA!r})")
    trace = payload.get("trace")
    if not isinstance(trace, dict) or \
            not isinstance(trace.get("traceEvents"), list):
        raise ValueError(f"{path}: bundle trace is not a Chrome-trace "
                         "payload (no traceEvents list)")
    for ev in trace["traceEvents"]:
        if ev.get("ph") not in ("X", "i"):
            raise ValueError(f"{path}: unexpected trace event phase "
                             f"{ev.get('ph')!r}")
        missing = {"name", "pid", "tid", "ts"} - set(ev)
        if missing:
            raise ValueError(f"{path}: trace event missing {missing}")
        if ev["ph"] == "X" and "dur" not in ev:
            raise ValueError(f"{path}: complete event without dur")
    return payload

"""Shared observability-plane flags for the launch CLIs (the port of the
reference's ``repro/launch/obs.py``).

Every long-running entry point (``optimize``, ``online``, ``serve``,
``fleet``) exposes the same three switches:

  ``--listen HOST:PORT``      start the stdlib HTTP endpoint
                              (``/metrics`` Prometheus, ``/healthz``,
                              ``/varz``); ``:0`` picks a free port and
                              prints it
  ``--health``                evaluate the service's default
                              :mod:`repro_torch.obs.health` rule set while
                              the job runs
  ``--flight-recorder OUT``   keep a bounded ring-buffer trace
                              (``--flight-capacity`` events) and write
                              a postmortem bundle to OUT on crash, on
                              any health CRIT transition, and on clean
                              exit (reason ``exit``)

:func:`add_obs_flags` installs them on an argparse parser;
:func:`build_plane` turns the parsed args into an :class:`ObsPlane`
holding the wired registry / recorder / monitor / server, plus the
teardown (:meth:`ObsPlane.finalize`) and crash capture
(:meth:`ObsPlane.crash_guard`) the CLI main loops wrap themselves in.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import sys
from typing import Optional


def add_obs_flags(ap):
    """Install ``--listen`` / ``--health`` / ``--flight-recorder`` /
    ``--flight-capacity`` on ``ap``; returns ``ap``."""
    g = ap.add_argument_group("observability plane")
    g.add_argument("--listen", default=None, metavar="HOST:PORT",
                   help="serve /metrics (Prometheus text), /healthz "
                        "(503 on CRIT), and /varz on a background "
                        "thread; ':0' and 'HOST:0' bind a free port "
                        "(printed on start)")
    g.add_argument("--health", action="store_true",
                   help="evaluate this service's default health rules "
                        "(divergence, staleness, queue shed, ...) while "
                        "the job runs; verdicts land in the registry "
                        "and on /healthz")
    g.add_argument("--flight-recorder", default=None, metavar="OUT.json",
                   dest="flight_recorder",
                   help="keep a bounded ring-buffer trace and write a "
                        "postmortem bundle (trace tail + metrics "
                        "snapshot + provenance) to OUT.json on crash, "
                        "health CRIT, or clean exit")
    g.add_argument("--flight-capacity", type=int, default=None,
                   metavar="N", dest="flight_capacity",
                   help="flight-recorder ring capacity in events "
                        "(default 4096)")
    return ap


def parse_listen(spec: str):
    """``'HOST:PORT'`` / ``':PORT'`` / ``'PORT'`` -> (host, port)."""
    host, _, port = spec.rpartition(":")
    host = host or "127.0.0.1"
    try:
        return host, int(port)
    except ValueError:
        raise ValueError(f"--listen expects HOST:PORT, got {spec!r}")


@dataclasses.dataclass
class ObsPlane:
    """The wired observability plane of one CLI invocation.

    Any attribute may be None when its flag was off; ``registry`` is
    non-None whenever at least one obs flag was given (the caller may
    also have forced it with its own ``--metrics`` flag)."""
    registry: Optional[object] = None
    recorder: Optional[object] = None
    monitor: Optional[object] = None
    server: Optional[object] = None
    dump_path: Optional[str] = None

    @property
    def active(self) -> bool:
        return self.registry is not None

    def tracer_or(self, tracer):
        """The tracer the solve should run under: an explicit
        ``--trace`` Tracer wins; otherwise the flight recorder (which
        shares the span API); otherwise None."""
        return tracer if tracer is not None else self.recorder

    def crash_guard(self):
        """Context manager dumping the recorder bundle when the body
        raises (no-op without ``--flight-recorder``)."""
        if self.recorder is not None and self.dump_path is not None:
            return self.recorder.crash_guard(self.dump_path)
        return contextlib.nullcontext()

    def summary(self) -> dict:
        """JSON-able plane state for the CLI summary blob."""
        out = {}
        if self.server is not None:
            out["listen"] = self.server.url
        if self.monitor is not None:
            out["health"] = self.monitor.healthz(evaluate=True)
        if self.recorder is not None:
            out["flight_recorder"] = {
                "capacity": self.recorder.capacity,
                "retained": len(self.recorder.events),
                "dropped": self.recorder.dropped,
                "dumps": list(self.recorder.dumps),
            }
        return out

    def finalize(self, reason: str = "exit") -> dict:
        """Stop the endpoint and write the clean-exit bundle; returns
        :meth:`summary` (taken before teardown)."""
        out = self.summary()
        if self.server is not None:
            self.server.stop()
        if self.recorder is not None and self.dump_path is not None:
            try:
                self.recorder.dump(self.dump_path, reason=reason)
                out.setdefault("flight_recorder", {})["bundle"] = \
                    self.dump_path
            except Exception as e:
                print(f"[obs] flight-recorder dump failed: {e!r}",
                      file=sys.stderr)
        return out


def build_plane(args, *, rules=None, registry=None, meta=None,
                start_server: bool = True) -> ObsPlane:
    """Wire the plane from parsed CLI args.

    Args:
      args: argparse namespace carrying the :func:`add_obs_flags`
        attributes.
      rules: the service's default health-rule list for ``--health``
        (e.g. ``repro_torch.obs.online_rules()``); required when --health is
        set.
      registry: an existing registry to attach to (the CLI's own
        ``--metrics`` one); a fresh one is created when any obs flag
        needs it.
      meta: provenance dict stamped into every recorder bundle.
      start_server: tests pass False to wire without binding.

    Returns an :class:`ObsPlane` (``.active`` False when no obs flag
    was given).
    """
    listen = getattr(args, "listen", None)
    health = getattr(args, "health", False)
    rec_path = getattr(args, "flight_recorder", None)
    capacity = getattr(args, "flight_capacity", None)
    if not (listen or health or rec_path):
        return ObsPlane(registry=registry)

    from ..obs import FlightRecorder, HealthMonitor, ObsServer, Registry
    from ..obs.recorder import DEFAULT_CAPACITY

    reg = registry if registry is not None else Registry()
    plane = ObsPlane(registry=reg, dump_path=rec_path)

    if rec_path:
        cap = capacity if capacity is not None else DEFAULT_CAPACITY
        plane.recorder = FlightRecorder(capacity=cap, registry=reg,
                                        meta=meta)
    if health:
        if rules is None:
            rules = []
        dump_dir = (os.path.dirname(os.path.abspath(rec_path))
                    if rec_path else None)
        plane.monitor = HealthMonitor(reg, rules,
                                      recorder=plane.recorder,
                                      dump_dir=dump_dir,
                                      min_interval_s=0.05)
    if listen:
        host, port = parse_listen(listen)
        plane.server = ObsServer(reg, monitor=plane.monitor,
                                 recorder=plane.recorder,
                                 host=host, port=port)
        if start_server:
            plane.server.start()
            print(f"[obs] serving /metrics /healthz /varz on "
                  f"{plane.server.url}")
    return plane


def add_trace_metrics_flags(ap, *, trace_help: str, metrics_help: str):
    """``--trace OUT.json`` and ``--metrics``, as the reference's CLIs
    take them, beside the plane's flags (:func:`add_obs_flags`)."""
    ap.add_argument("--trace", default=None, metavar="OUT.json",
                    help=trace_help)
    ap.add_argument("--metrics", action="store_true", help=metrics_help)
    return add_obs_flags(ap)


def open_plane(args, *, rules=None, meta=None):
    """``--trace`` / ``--metrics`` and the plane flags of one CLI run ->
    ``(tracer, registry, plane)``: a :class:`~repro_torch.obs.Tracer` when
    ``--trace`` is given, the registry the run records into (its own for
    ``--metrics``, the plane's whenever a plane flag is given, else None)
    and the :class:`ObsPlane`.  ``rules()`` makes the service's default
    health rules, called only under ``--health``."""
    from ..obs import Registry, Tracer
    tracer = Tracer() if getattr(args, "trace", None) else None
    registry = Registry() if getattr(args, "metrics", False) else None
    plane = build_plane(
        args, rules=rules() if rules is not None and args.health else None,
        registry=registry, meta=meta)
    return tracer, (plane.registry if plane.active else registry), plane


def close_plane(summary: dict, tracer, registry, plane, trace_path, tag):
    """Put the registry snapshot (``metrics``) and the plane's state
    (``obs``, after stopping its endpoint and writing its exit bundle)
    into ``summary``, and write the trace to ``trace_path`` with its
    JSONL beside it."""
    if registry is not None:
        summary["metrics"] = registry.snapshot()
    if plane.active:
        summary["obs"] = plane.finalize()
    if tracer is not None:
        tracer.write_chrome_trace(trace_path)
        base, _ = os.path.splitext(trace_path)
        tracer.write_jsonl(base + ".jsonl")
        print(f"[{tag}] trace: {len(tracer.events)} events -> "
              f"{trace_path} (+ {base + '.jsonl'})")
    return summary

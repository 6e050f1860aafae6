"""Declarative health monitoring over the metrics the stack already emits
(a copy of the reference's ``repro/obs/health.py``, which imports no jax).

A :class:`HealthRule` is a named check over a ``Registry.snapshot()``
returning an (status, message, value) verdict; a :class:`HealthMonitor`
evaluates a set of rules, records the verdicts back into the registry
(``health/status{rule=...}`` gauges, ``health/transitions`` counters),
and -- on an OK->CRIT edge -- fires **exactly one** postmortem dump of
its paired :class:`~repro_torch.obs.recorder.FlightRecorder` per transition.

Rules are pure functions of the snapshot plus whatever window state
their closure keeps, so they are cheap enough to poll from the drive
loop / service loops; :meth:`HealthMonitor.poll` additionally
rate-limits evaluation (``min_interval_s``) so per-decode-step polling
in the serve engine costs a clock read.

The catalog (:func:`rule_divergence`, :func:`rule_gap_stall`,
:func:`rule_staleness`, :func:`rule_version_lag`,
:func:`rule_queue_shed`, :func:`rule_fleet_starvation`,
:func:`rule_comm_exposed`) covers the signals the algorithms already
export: NaN / non-improving ``solver/objective``-``solver/rel_opt``
(the D3CA dual ascent diverging), a stalled duality gap, the online
service's staleness gauge and version lag, the admission queue's shed
rate, starved fleet buckets, and the exposed-communication share of a
step.  :func:`solver_rules` / :func:`online_rules` / :func:`serve_rules`
/ :func:`fleet_rules` bundle sensible defaults per service.
"""
from __future__ import annotations

import collections
import dataclasses
import math
import os
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

#: health statuses, in increasing severity
OK, WARN, CRIT = "ok", "warn", "crit"
SEVERITY = {OK: 0, WARN: 1, CRIT: 2}


@dataclasses.dataclass(frozen=True)
class HealthEvent:
    """One rule's verdict at one evaluation."""
    rule: str
    status: str                  # OK | WARN | CRIT
    message: str
    value: Optional[float] = None
    t: float = 0.0               # monitor clock at evaluation


@dataclasses.dataclass(frozen=True)
class HealthRule:
    """A named check: ``check(snapshot) -> (status, message, value)``.

    ``check`` receives the full ``Registry.snapshot()`` dict; closures
    may keep window state (e.g. the last N observed values) across
    evaluations.  A rule that raises is reported WARN with the
    exception message -- a broken rule must never take the service
    down."""
    name: str
    check: Callable[[dict], Tuple[str, str, Optional[float]]]
    description: str = ""


def _series(section: Dict[str, object], name: str) -> Dict[str, float]:
    """All entries of a snapshot section whose base metric name is
    ``name`` (label-decorated keys render as ``name{k=v,...}``)."""
    pfx = name + "{"
    return {k: v for k, v in section.items()
            if k == name or k.startswith(pfx)}


def _is_bad(v) -> bool:
    return v is None or not math.isfinite(v)


# ---------------------------------------------------------------------------
# the rule catalog
# ---------------------------------------------------------------------------

def rule_divergence(gauge: str = "solver/objective",
                    improve_gauge: str = "solver/rel_opt",
                    window: int = 8,
                    name: str = "divergence") -> HealthRule:
    """CRIT on a NaN/inf objective; WARN when ``improve_gauge`` (falling
    back to ``gauge``) has not decreased over the last ``window``
    evaluations -- the D3CA dual ascent diverging or wedged."""
    hist: Dict[str, collections.deque] = {}

    def check(snap):
        gauges = snap.get("gauges", {})
        objs = _series(gauges, gauge)
        for key, v in objs.items():
            if _is_bad(v):
                return CRIT, f"{key} is {v!r} (non-finite)", v
        tracked = _series(gauges, improve_gauge) or objs
        worst = None
        for key, v in tracked.items():
            if _is_bad(v):
                return CRIT, f"{key} is {v!r} (non-finite)", v
            dq = hist.setdefault(key, collections.deque(maxlen=window + 1))
            dq.append(float(v))
            if len(dq) == window + 1 and min(dq) >= dq[0]:
                worst = (key, v)
        if worst is not None:
            return WARN, (f"{worst[0]} has not improved over the last "
                          f"{window} evaluations"), worst[1]
        if not objs and not tracked:
            return OK, f"no {gauge} series yet", None
        return OK, "objective finite and improving", None

    return check_rule(name, check, "NaN objective or stalled rel_opt")


def rule_gap_stall(gauge: str = "solver/duality_gap", window: int = 8,
                   min_rel_decrease: float = 1e-3,
                   name: str = "duality_gap_stall") -> HealthRule:
    """WARN when the duality gap shrank less than ``min_rel_decrease``
    (relatively) over the last ``window`` evaluations; CRIT when it is
    non-finite or grew."""
    hist: Dict[str, collections.deque] = {}

    def check(snap):
        gaps = _series(snap.get("gauges", {}), gauge)
        if not gaps:
            return OK, f"no {gauge} series yet", None
        for key, v in gaps.items():
            if _is_bad(v):
                return CRIT, f"{key} is {v!r} (non-finite)", v
            dq = hist.setdefault(key, collections.deque(maxlen=window + 1))
            dq.append(float(v))
            if len(dq) == window + 1:
                first, last = dq[0], dq[-1]
                if last > first and last > 0:
                    return CRIT, f"{key} grew {first:.3e} -> {last:.3e}", v
                denom = max(abs(first), 1e-30)
                if (first - last) / denom < min_rel_decrease:
                    return WARN, (f"{key} stalled at {last:.3e} over "
                                  f"{window} evaluations"), v
        return OK, "gap shrinking", None

    return check_rule(name, check, "duality gap stalled or growing")


def rule_staleness(max_s: float, gauge: str = "online/staleness_s",
                   warn_frac: float = 0.5,
                   name: str = "staleness") -> HealthRule:
    """Served-snapshot age: CRIT above ``max_s`` seconds, WARN above
    ``warn_frac * max_s``."""

    def check(snap):
        vals = _series(snap.get("gauges", {}), gauge)
        if not vals:
            return OK, f"no {gauge} series yet", None
        key, v = max(vals.items(), key=lambda kv: kv[1])
        if v > max_s:
            return CRIT, f"{key}={v:.3f}s > {max_s:.3f}s", v
        if v > warn_frac * max_s:
            return WARN, f"{key}={v:.3f}s > {warn_frac * max_s:.3f}s", v
        return OK, f"staleness {v:.3f}s", v

    return check_rule(name, check, f"served snapshot older than {max_s}s")


def rule_version_lag(max_lag: float, gauge: str = "online/version_lag",
                     warn_frac: float = 0.5,
                     name: str = "version_lag") -> HealthRule:
    """Admitted-but-unserved observations: CRIT above ``max_lag``."""

    def check(snap):
        vals = _series(snap.get("gauges", {}), gauge)
        if not vals:
            return OK, f"no {gauge} series yet", None
        key, v = max(vals.items(), key=lambda kv: kv[1])
        if v > max_lag:
            return CRIT, f"{key}={v:.0f} > {max_lag:.0f}", v
        if v > warn_frac * max_lag:
            return WARN, f"{key}={v:.0f} > {warn_frac * max_lag:.0f}", v
        return OK, f"version lag {v:.0f}", v

    return check_rule(name, check,
                      f"served model more than {max_lag} observations "
                      "behind the stream")


def rule_queue_shed(max_rate: float = 0.1,
                    rejected: str = "online/rejected",
                    admitted: str = "online/ingested",
                    name: str = "queue_shed") -> HealthRule:
    """Admission shed rate between evaluations: CRIT when more than
    ``max_rate`` of offered rows were rejected since the last
    evaluation (queue saturation), WARN above half of it.  The first
    evaluation sees the cumulative counters (baseline zero)."""
    last = {"rej": 0.0, "adm": 0.0}

    def check(snap):
        counters = snap.get("counters", {})
        rej = sum(_series(counters, rejected).values())
        adm = sum(_series(counters, admitted).values())
        d_rej, d_adm = rej - last["rej"], adm - last["adm"]
        last["rej"], last["adm"] = rej, adm
        offered = d_rej + d_adm
        if offered <= 0:
            return OK, "no traffic since last evaluation", 0.0
        rate = d_rej / offered
        if rate > max_rate:
            return CRIT, (f"shed {d_rej:.0f}/{offered:.0f} offered rows "
                          f"({100 * rate:.1f}% > {100 * max_rate:.1f}%)"), \
                rate
        if rate > 0.5 * max_rate:
            return WARN, f"shed rate {100 * rate:.1f}%", rate
        return OK, f"shed rate {100 * rate:.1f}%", rate

    return check_rule(name, check,
                      f"admission queue shedding more than "
                      f"{100 * max_rate:.0f}% of offered rows")


def rule_fleet_starvation(min_tenants: int = 2,
                          gauge: str = "fleet/bucket_tenants",
                          name: str = "fleet_starvation") -> HealthRule:
    """WARN when any fleet shape bucket runs with fewer than
    ``min_tenants`` tenants -- a starved bucket pays a whole compiled
    program for almost no batching win."""

    def check(snap):
        vals = _series(snap.get("gauges", {}), gauge)
        if not vals:
            return OK, "no fleet buckets yet", None
        starved = {k: v for k, v in vals.items() if v < min_tenants}
        if starved:
            key, v = min(starved.items(), key=lambda kv: kv[1])
            return WARN, (f"{len(starved)} bucket(s) below "
                          f"{min_tenants} tenants (worst {key}={v:.0f})"), v
        return OK, f"all {len(vals)} buckets >= {min_tenants} tenants", None

    return check_rule(name, check,
                      f"fleet bucket running under {min_tenants} tenants")


def rule_comm_exposed(max_share: float = 0.5,
                      comm: str = "solver/comm_exposed_s",
                      comm_fallback: str = "solver/comm_s",
                      step: str = "solver/step_s",
                      name: str = "comm_exposed") -> HealthRule:
    """WARN when the exposed-communication share of the mean outer step
    exceeds ``max_share`` -- the wire is eating the critical path
    (overlap cells report ``comm_exposed_s``; hidden comm is free)."""

    def check(snap):
        hists = snap.get("histograms", {})
        steps = _series(hists, step)
        comms = _series(hists, comm) or _series(hists, comm_fallback)
        step_sum = sum(h["sum"] for h in steps.values())
        comm_sum = sum(h["sum"] for h in comms.values())
        if step_sum <= 0 or not comms:
            return OK, "no phased step series yet", None
        share = comm_sum / step_sum
        if share > max_share:
            return WARN, (f"exposed comm is {100 * share:.1f}% of step "
                          f"(> {100 * max_share:.1f}%)"), share
        return OK, f"exposed comm {100 * share:.1f}% of step", share

    return check_rule(name, check,
                      f"exposed comm share of a step above "
                      f"{100 * max_share:.0f}%")


def check_rule(name: str, check, description: str = "") -> HealthRule:
    """Tiny constructor shim so the factories above read declaratively."""
    return HealthRule(name=name, check=check, description=description)


# ---------------------------------------------------------------------------
# bundled defaults per service
# ---------------------------------------------------------------------------

def solver_rules(*, stall_window: int = 8,
                 max_comm_share: float = 0.75) -> List[HealthRule]:
    """Rules for a batch/long solve driven through ``Solver.solve``."""
    return [rule_divergence(window=stall_window),
            rule_gap_stall(window=stall_window),
            rule_comm_exposed(max_share=max_comm_share)]


def online_rules(*, max_staleness_s: float = 60.0, max_lag: float = 10_000,
                 max_shed_rate: float = 0.1,
                 stall_window: int = 8) -> List[HealthRule]:
    """Rules for the :class:`~repro_torch.online.OnlineSolverService` (adds a
    NaN check on the published weights via ``online/w_norm``)."""
    return [rule_divergence(gauge="online/w_norm",
                            improve_gauge="online/w_norm",
                            window=10 ** 9,   # norm drift is not a stall
                            name="online_divergence"),
            rule_staleness(max_staleness_s),
            rule_version_lag(max_lag),
            rule_queue_shed(max_shed_rate)]


def serve_rules(*, max_shed_rate: float = 0.1) -> List[HealthRule]:
    """Rules for the continuous-batching serve engine."""
    return [rule_queue_shed(max_shed_rate,
                            rejected="serve/rejections",
                            admitted="serve/requests_finished",
                            name="serve_shed")]


def fleet_rules(*, min_tenants: int = 2) -> List[HealthRule]:
    """Rules for the multi-tenant fleet scheduler."""
    return [rule_divergence(), rule_fleet_starvation(min_tenants)]


# ---------------------------------------------------------------------------
# the monitor
# ---------------------------------------------------------------------------

class HealthMonitor:
    """Evaluates rules over a registry; edge-triggers postmortem dumps.

    Args:
      registry: the :class:`~repro_torch.obs.metrics.Registry` the monitored
        code writes into; verdicts land back in it as
        ``health/status{rule=...}`` gauges (0 = OK, 1 = WARN, 2 = CRIT)
        and ``health/transitions{rule=...,status=...}`` counters.
      rules: iterable of :class:`HealthRule` (add more with
        :meth:`add_rule`).
      recorder: optional :class:`~repro_torch.obs.recorder.FlightRecorder`;
        on each rule's OK/WARN -> CRIT transition the monitor writes
        exactly one postmortem bundle into ``dump_dir`` (re-arming only
        after the rule leaves CRIT).
      dump_dir: directory for CRIT bundles (required for dumping).
      min_interval_s: :meth:`poll` rate limit -- evaluations are
        skipped until this much monitor-clock time has passed, so
        hot-loop polling is a clock read.
      clock: injectable monotonic clock (tests freeze it).
    """

    def __init__(self, registry, rules: Sequence[HealthRule] = (), *,
                 recorder=None, dump_dir: Optional[str] = None,
                 min_interval_s: float = 0.0, clock=time.monotonic):
        self.registry = registry
        self.rules: List[HealthRule] = list(rules)
        self.recorder = recorder
        self.dump_dir = dump_dir
        self.min_interval_s = float(min_interval_s)
        self.clock = clock
        self._lock = threading.Lock()
        self._last_eval = float("-inf")
        self._last_status: Dict[str, str] = {}
        self._events: collections.deque = collections.deque(maxlen=256)
        self._dump_seq = 0
        self.status = OK
        self.evaluations = 0

    def add_rule(self, rule: HealthRule):
        with self._lock:
            self.rules.append(rule)

    # ------------------------------------------------------------------
    def poll(self) -> str:
        """Rate-limited :meth:`evaluate`; returns the current overall
        status either way."""
        now = self.clock()
        with self._lock:
            due = now - self._last_eval >= self.min_interval_s
        if due:
            self.evaluate()
        return self.status

    def evaluate(self) -> List[HealthEvent]:
        """Run every rule once; returns this evaluation's events."""
        now = self.clock()
        with self._lock:
            self._last_eval = now
            rules = list(self.rules)
        snap = self.registry.snapshot()
        events: List[HealthEvent] = []
        worst = OK
        for rule in rules:
            try:
                status, message, value = rule.check(snap)
            except Exception as e:      # a broken rule must not crash us
                status, message, value = WARN, f"rule error: {e!r}", None
            if SEVERITY[status] > SEVERITY[worst]:
                worst = status
            ev = HealthEvent(rule=rule.name, status=status,
                             message=message, value=value, t=now)
            events.append(ev)
            self.registry.gauge("health/status", rule=rule.name).set(
                SEVERITY[status])
            prev = self._last_status.get(rule.name, OK)
            if status != prev:
                self.registry.counter("health/transitions", rule=rule.name,
                                      status=status).inc()
                if status == CRIT:
                    self._fire_dump(rule.name, message)
            self._last_status[rule.name] = status
        with self._lock:
            self._events.extend(events)
            self.evaluations += 1
        self.status = worst
        self.registry.gauge("health/overall").set(SEVERITY[worst])
        return events

    def _fire_dump(self, rule_name: str, message: str):
        """Exactly one bundle per transition INTO CRIT (edge-triggered:
        a rule staying CRIT across evaluations does not re-dump; it
        re-arms when it recovers)."""
        if self.recorder is None or self.dump_dir is None:
            return
        with self._lock:
            self._dump_seq += 1
            seq = self._dump_seq
        safe = rule_name.replace("/", "_")
        path = os.path.join(self.dump_dir, f"health-{safe}-{seq}.json")
        try:
            self.recorder.dump(path, reason=f"health:{rule_name}:{message}")
        except Exception:
            pass                        # dumping must never crash the loop

    # ------------------------------------------------------------------
    def healthz(self, evaluate: bool = True) -> dict:
        """The ``/healthz`` payload: overall status plus the latest
        per-rule verdicts."""
        if evaluate:
            events = self.evaluate()
        else:
            with self._lock:
                latest: Dict[str, HealthEvent] = {}
                for ev in self._events:
                    latest[ev.rule] = ev
                events = list(latest.values())
        return {
            "status": self.status,
            "evaluations": self.evaluations,
            "rules": {ev.rule: {"status": ev.status,
                                "message": ev.message,
                                "value": ev.value} for ev in events},
        }

    def events(self) -> List[HealthEvent]:
        """The retained event tail (most recent last)."""
        with self._lock:
            return list(self._events)

"""The port's live observability plane against the reference's, on the
CPU: the flight recorder and its bundles (each package loads the other's),
the health-rule catalog and monitor (every verdict case of the
reference's ``tests/test_obs_plane.py`` run through both catalogs), the
Prometheus text (identical renderings, each parser reading the other's),
the HTTP endpoint, the CLI plane wiring, and the plane threaded through a
real solve and the online service.
"""
from __future__ import annotations

import argparse
import json
import math
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import repro.obs as J
import repro_torch.obs as T
from repro.launch import obs as j_launch_obs
from repro_torch.core import D3CAConfig, get_solver
from repro_torch.launch import obs as t_launch_obs
from repro_torch.online import OnlineConfig, OnlineSolverService
from test_torch_common import make_problem

PKGS = {"port": T, "ref": J}


class FakeClock:
    """Deterministic clock: every call advances one second."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 1.0
        return self.t


def test_the_plane_exports_the_reference_names():
    assert T.__all__ == J.__all__
    assert T.BUNDLE_SCHEMA == J.BUNDLE_SCHEMA
    for name in ("OK", "WARN", "CRIT"):
        assert getattr(T, name) == getattr(J, name)


# ---------------------------------------------------------------------------
# flight recorder and bundles
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pkg", ["port", "ref"])
def test_recorder_ring_is_the_reference_ring(pkg):
    """The same 10 000 spans through each package's recorder of capacity
    64 leave the same retained tail and drop count, event for event."""
    rec = PKGS[pkg].FlightRecorder(capacity=64, clock=FakeClock())
    ref = J.FlightRecorder(capacity=64, clock=FakeClock())
    for r in (rec, ref):
        for i in range(10_000):
            with r.span("work", i=i):
                pass
        r.instant("marker")
    assert list(rec.events) == list(ref.events)
    assert rec.dropped == ref.dropped == 10_000 + 1 - 64
    assert T.as_tracer(rec) is rec
    with pytest.raises(ValueError, match="capacity"):
        T.FlightRecorder(capacity=0)


def _bundle(o, path, reason="trigger"):
    reg = o.Registry()
    reg.counter("x").inc(3)
    reg.histogram("h").observe(1.0)
    rec = o.FlightRecorder(capacity=8, clock=FakeClock(), registry=reg,
                           meta={"svc": "test"})
    for i in range(20):
        with rec.span("step", i=i):
            pass
    rec.dump(path, reason=reason)
    assert rec.dumps == [path]
    return rec


@pytest.mark.parametrize("writer,reader", [("port", "ref"), ("ref", "port"),
                                           ("port", "port")])
def test_each_package_loads_the_others_bundle(writer, reader, tmp_path):
    path = str(tmp_path / "bundle.json")
    _bundle(PKGS[writer], path)
    b = PKGS[reader].load_bundle(path)
    assert b["schema"] == J.BUNDLE_SCHEMA and b["reason"] == "trigger"
    assert b["meta"]["svc"] == "test" and b["capacity"] == 8
    assert (b["retained_events"], b["dropped_events"]) == (8, 12)
    assert [e["args"]["i"] for e in b["trace"]["traceEvents"]] == \
        list(range(12, 20))
    assert b["metrics"]["counters"]["x"] == 3
    assert b["metrics"]["histograms"]["h"]["count"] == 1


def test_bundles_of_both_packages_are_equal_but_for_provenance(tmp_path):
    got = _bundle(T, str(tmp_path / "t.json")).bundle("x")
    want = _bundle(J, str(tmp_path / "j.json")).bundle("x")
    for b in (got, want):
        b["meta"].pop("written_at")
        for e in b["trace"]["traceEvents"]:
            e.pop("tid")
    assert got == want


@pytest.mark.parametrize("payload,match", [
    ({"schema": "something/else"}, "schema"),
    ({"schema": J.BUNDLE_SCHEMA, "trace": {}}, "traceEvents"),
    ({"schema": J.BUNDLE_SCHEMA,
      "trace": {"traceEvents": [{"ph": "B", "name": "x"}]}}, "phase"),
    ({"schema": J.BUNDLE_SCHEMA,
      "trace": {"traceEvents": [{"ph": "X", "name": "x", "pid": 0,
                                 "tid": 1, "ts": 0.0}]}}, "without dur")])
def test_load_bundle_rejects_what_the_reference_rejects(payload, match,
                                                        tmp_path):
    p = tmp_path / "b.json"
    p.write_text(json.dumps(payload))
    for o in (T, J):
        with pytest.raises(ValueError, match=match):
            o.load_bundle(str(p))


def test_crash_guard_dumps_and_reraises(tmp_path):
    rec = T.FlightRecorder(capacity=8, clock=FakeClock())
    path = str(tmp_path / "crash.json")
    with pytest.raises(RuntimeError, match="boom"):
        with rec.crash_guard(path):
            with rec.span("doomed"):
                pass
            raise RuntimeError("boom")
    b = J.load_bundle(path)
    assert b["reason"] == "crash:RuntimeError"
    assert [e["name"] for e in b["trace"]["traceEvents"]] == ["doomed"]


# ---------------------------------------------------------------------------
# health rules: every verdict case of the reference's tests, both catalogs
# ---------------------------------------------------------------------------

def _reg_with(o, gauges=(), counters=(), hists=()):
    reg = o.Registry()
    for name, labels, v in gauges:
        reg.gauge(name, **labels).set(v)
    for name, labels, v in counters:
        reg.counter(name, **labels).inc(v)
    for name, labels, vs in hists:
        h = reg.histogram(name, **labels)
        for v in vs:
            h.observe(v)
    return reg


def _case_divergence_nan(o):
    reg = _reg_with(o, gauges=[("solver/objective", {"solver": "d3ca"},
                                float("nan"))])
    return [o.rule_divergence().check(reg.snapshot())[:2]]


def _case_divergence_stall(o):
    rule = o.rule_divergence(window=3)
    reg = o.Registry()
    g = reg.gauge("solver/rel_opt")
    out = []
    for v in (1.0, 0.5, 0.25, 0.12, 0.06):
        g.set(v)
        out.append(rule.check(reg.snapshot())[0])
    out += [rule.check(reg.snapshot())[0] for _ in range(4)]
    return out


def _case_gap(o):
    rule = o.rule_gap_stall(window=3)
    reg = o.Registry()
    g = reg.gauge("solver/duality_gap")
    out = []
    for v in (1.0, 0.5, 0.2, 0.1, 0.1, 0.1, 0.1, 0.2, 0.5, 1.0, 2.0):
        g.set(v)
        out.append(rule.check(reg.snapshot())[:2])
    return out


def _case_staleness(o):
    rule = o.rule_staleness(10.0)
    out = [rule.check(_reg_with(o, gauges=[("online/staleness_s", {}, v)])
                      .snapshot()) for v in (1.0, 6.0, 11.0)]
    return out + [rule.check(o.Registry().snapshot())]


def _case_version_lag(o):
    rule = o.rule_version_lag(100)
    return [rule.check(_reg_with(o, gauges=[("online/version_lag", {}, v)])
                       .snapshot()) for v in (10, 60, 101)]


def _case_queue_shed(o):
    rule = o.rule_queue_shed(max_rate=0.2)
    reg = o.Registry()
    adm, rej = reg.counter("online/ingested"), reg.counter("online/rejected")
    out = []
    for a, r in ((100, 0), (20, 30), (100, 0), (0, 0)):
        adm.inc(a)
        rej.inc(r)
        out.append(rule.check(reg.snapshot()))
    return out


def _case_fleet_starvation(o):
    rule = o.rule_fleet_starvation(min_tenants=2)
    two = _reg_with(o, gauges=[("fleet/bucket_tenants", {"bucket": "a"}, 4),
                               ("fleet/bucket_tenants", {"bucket": "b"}, 1)])
    one = _reg_with(o, gauges=[("fleet/bucket_tenants", {"bucket": "a"}, 4)])
    return [rule.check(two.snapshot()), rule.check(one.snapshot())]


def _case_comm_exposed(o):
    rule = o.rule_comm_exposed(max_share=0.5)
    hi = _reg_with(o, hists=[("solver/step_s", {}, [1.0, 1.0]),
                             ("solver/comm_exposed_s", {}, [0.8, 0.9])])
    lo = _reg_with(o, hists=[("solver/step_s", {}, [1.0]),
                             ("solver/comm_exposed_s", {}, [0.1])])
    return [rule.check(hi.snapshot()), rule.check(lo.snapshot())]


def _case_broken_rule(o):
    def boom(snap):
        raise KeyError("broken rule")
    mon = o.HealthMonitor(o.Registry(), [o.HealthRule("bad", boom)],
                          clock=FakeClock())
    return [(e.rule, e.status, e.message) for e in mon.evaluate()]


def _case_default_sets(o):
    reg = _reg_with(o, gauges=[("online/staleness_s", {}, 20.0),
                               ("online/version_lag", {}, 5.0),
                               ("online/w_norm", {}, 1.0),
                               ("solver/objective", {}, 0.5),
                               ("fleet/bucket_tenants", {"bucket": "a"}, 1)])
    out = []
    for rules in (o.solver_rules(), o.online_rules(max_staleness_s=30.0),
                  o.serve_rules(), o.fleet_rules(min_tenants=2)):
        out.append([(r.name, r.check(reg.snapshot())) for r in rules])
    return out


RULE_CASES = {
    "divergence_nan": (_case_divergence_nan, lambda v: v[0][0] == "crit"),
    "divergence_stall": (_case_divergence_stall,
                         lambda v: v[:5] == ["ok"] * 5 and v[-1] == "warn"),
    "gap_stall_and_growth": (_case_gap,
                             lambda v: [s for s, _ in v][3] == "ok"
                             and v[6][0] == "warn" and v[-1][0] == "crit"),
    "staleness": (_case_staleness, lambda v: [s for s, _, _ in v]
                  == ["ok", "warn", "crit", "ok"]),
    "version_lag": (_case_version_lag, lambda v: [s for s, _, _ in v]
                    == ["ok", "warn", "crit"]),
    "queue_shed": (_case_queue_shed, lambda v: [s for s, _, _ in v]
                   == ["ok", "crit", "ok", "ok"] and v[2][2] == 0.0),
    "fleet_starvation": (_case_fleet_starvation,
                         lambda v: v[0][0] == "warn" and v[0][2] == 1
                         and v[1][0] == "ok"),
    "comm_exposed": (_case_comm_exposed,
                     lambda v: v[0][0] == "warn"
                     and v[0][2] == pytest.approx(0.85) and v[1][0] == "ok"),
    "broken_rule": (_case_broken_rule,
                    lambda v: v[0][1] == "warn" and "rule error" in v[0][2]),
    "default_rule_sets": (_case_default_sets, lambda v: len(v) == 4),
}


@pytest.mark.parametrize("case", sorted(RULE_CASES))
def test_rule_verdicts_match_the_reference(case):
    run, expect = RULE_CASES[case]
    got, want = run(T), run(J)
    assert got == want
    assert expect(got)


def _monitor_story(o, tmp_path):
    """The reference monitor tests' sequence of staleness readings: the
    registry's verdict gauges and transition counters, and the dumps."""
    reg = o.Registry()
    rec = o.FlightRecorder(capacity=8, clock=FakeClock(), registry=reg)
    mon = o.HealthMonitor(reg, [o.rule_staleness(10.0)], recorder=rec,
                          dump_dir=str(tmp_path), clock=FakeClock())
    seen = []
    for v in (1.0, 99.0, 99.0, 99.0, 1.0, 99.0):
        reg.gauge("online/staleness_s").set(v)
        mon.evaluate()
        seen.append((mon.status, len(rec.dumps)))
    hz = mon.healthz()
    snap = reg.snapshot()
    return seen, hz["status"], hz["rules"]["staleness"], \
        snap["gauges"], snap["counters"], \
        [o.load_bundle(p)["reason"] for p in rec.dumps]


def test_monitor_records_verdicts_and_dumps_once_per_edge_as_reference(
        tmp_path):
    got = _monitor_story(T, tmp_path / "t")
    want = _monitor_story(J, tmp_path / "j")
    assert got == want
    seen = got[0]
    assert [n for _, n in seen] == [0, 1, 1, 1, 1, 2]
    assert got[4]["health/transitions{rule=staleness,status=crit}"] == 2


def test_monitor_poll_rate_limit():
    calls = []

    def probe(snap):
        calls.append(1)
        return T.OK, "ok", None
    mon = T.HealthMonitor(T.Registry(), [T.HealthRule("probe", probe)],
                          min_interval_s=10.0, clock=FakeClock())
    for _ in range(8):
        mon.poll()
    assert 1 <= len(calls) < 8


# ---------------------------------------------------------------------------
# Prometheus text
# ---------------------------------------------------------------------------

def _registry_story(o):
    reg = o.Registry()
    reg.counter("solver/iters", solver="d3ca", engine="simulated").inc(5)
    reg.gauge("solver/objective", solver="d3ca").set(0.25)
    reg.gauge("w_norm").set(float("nan"))
    reg.gauge("peak").set(float("inf"))
    reg.counter("compress/ef_norm/w-contrib", codec='top"k').inc()
    h = reg.histogram("solver/step_s", solver="d3ca")
    for v in (0.1, 0.2, 0.3):
        h.observe(v)
    return reg.snapshot()


@pytest.mark.parametrize("prefix", ["", "repro_"])
def test_render_prometheus_is_the_reference_text(prefix):
    snap = _registry_story(T)
    assert json.dumps(snap, sort_keys=True) == json.dumps(
        _registry_story(J), sort_keys=True)
    text = T.render_prometheus(snap, prefix=prefix)
    assert text == J.render_prometheus(snap, prefix=prefix)
    assert f'{prefix}solver_iters{{engine="simulated",solver="d3ca"}} 5.0' \
        in text
    got, want = T.parse_prometheus_text(text), J.parse_prometheus_text(text)
    assert got.keys() == want.keys()
    for name in got:
        for labels, v in got[name].items():
            w = want[name][labels]
            assert v == w or (math.isnan(v) and math.isnan(w))
    assert got[f"{prefix}solver_step_s_sum"][
        frozenset({("solver", "d3ca")})] == pytest.approx(0.6)


@pytest.mark.parametrize("text,match", [
    ("this is { not metrics", "not a valid sample"),
    ("ok_name twelve", "bad value")])
def test_parse_prometheus_rejects_what_the_reference_rejects(text, match):
    for o in (T, J):
        with pytest.raises(ValueError, match=match):
            o.parse_prometheus_text(text)
    assert T.parse_prometheus_text(
        T.render_prometheus(T.Registry().snapshot())) == {}


# ---------------------------------------------------------------------------
# HTTP endpoint and the CLI plane
# ---------------------------------------------------------------------------

def _get(url):
    with urllib.request.urlopen(url, timeout=10) as resp:
        return resp.status, resp.read().decode()


def test_obs_server_serves_metrics_healthz_varz():
    reg = T.Registry()
    reg.counter("online/ingested").inc(7)
    reg.gauge("online/staleness_s").set(1.0)
    mon = T.HealthMonitor(reg, [T.rule_staleness(10.0)], clock=FakeClock())
    rec = T.FlightRecorder(capacity=8, clock=FakeClock())
    with T.ObsServer(reg, monitor=mon, recorder=rec, port=0) as srv:
        assert srv.port != 0 and srv.host == "127.0.0.1"
        code, body = _get(srv.url + "/metrics")
        assert code == 200
        assert J.parse_prometheus_text(body)["online_ingested"][
            frozenset()] == 7.0
        code, body = _get(srv.url + "/healthz")
        assert code == 200 and json.loads(body)["status"] == "ok"
        varz = json.loads(_get(srv.url + "/varz")[1])
        assert varz["metrics"]["counters"]["online/ingested"] == 7.0
        assert varz["recorder"]["capacity"] == 8
        with pytest.raises(urllib.error.HTTPError) as ei:
            _get(srv.url + "/nope")
        assert ei.value.code == 404
        reg.gauge("online/staleness_s").set(999.0)
        with pytest.raises(urllib.error.HTTPError) as ei:
            _get(srv.url + "/healthz")
        assert ei.value.code == 503
        assert json.loads(ei.value.read().decode())["status"] == "crit"


@pytest.mark.parametrize("spec", ["0.0.0.0:9100", ":0", "127.0.0.1:0",
                                  "9100"])
def test_parse_listen_forms_as_reference(spec):
    assert t_launch_obs.parse_listen(spec) == j_launch_obs.parse_listen(spec)
    with pytest.raises(ValueError, match="HOST:PORT"):
        t_launch_obs.parse_listen("nope")


def test_build_plane_wires_recorder_monitor_server(tmp_path):
    args = argparse.Namespace(
        listen="127.0.0.1:0", health=True,
        flight_recorder=str(tmp_path / "b.json"), flight_capacity=32)
    plane = t_launch_obs.build_plane(args, rules=T.online_rules(),
                                     start_server=False)
    assert plane.active and plane.recorder.capacity == 32
    assert plane.monitor.recorder is plane.recorder
    assert plane.monitor.dump_dir == str(tmp_path)
    assert plane.server is not None and plane.server.port == 0
    assert plane.tracer_or(None) is plane.recorder
    sentinel = object()
    assert plane.tracer_or(sentinel) is sentinel
    out = plane.finalize()
    assert out["flight_recorder"]["bundle"] == str(tmp_path / "b.json")
    assert J.load_bundle(str(tmp_path / "b.json"))["reason"] == "exit"
    off = t_launch_obs.build_plane(argparse.Namespace(
        listen=None, health=False, flight_recorder=None,
        flight_capacity=None))
    assert not off.active and off.finalize() == {}
    with off.crash_guard():
        pass


def test_open_plane_reads_the_cli_flags(tmp_path):
    args = argparse.Namespace(trace=str(tmp_path / "t.json"), metrics=True,
                              listen=None, health=True, flight_recorder=None,
                              flight_capacity=None)
    tracer, registry, plane = t_launch_obs.open_plane(
        args, rules=T.solver_rules)
    assert isinstance(tracer, T.Tracer) and plane.registry is registry
    assert [r.name for r in plane.monitor.rules] == [
        r.name for r in J.solver_rules()]
    summary = t_launch_obs.close_plane({}, tracer, registry, plane,
                                       args.trace, "test")
    assert summary["obs"]["health"]["status"] == "ok"
    assert (tmp_path / "t.jsonl").exists()


# ---------------------------------------------------------------------------
# the plane threaded through a real solve and the online service
# ---------------------------------------------------------------------------

def _small_solve(**kw):
    X, y = make_problem(120, 40, seed=0)
    cfg = D3CAConfig(lam=1e-1, outer_iters=4, local_steps=8)
    return get_solver("d3ca")(device="cpu").solve("hinge", X, y, P=2, Q=2,
                                                  cfg=cfg, **kw)


def test_live_endpoint_does_not_perturb_solve():
    """/metrics scraped from another thread all through a registered
    solve: valid text every time, and the iterates bitwise those of the
    same solve without the endpoint."""
    plain = _small_solve(registry=T.Registry())
    reg = T.Registry()
    stop = threading.Event()
    scrapes, errors = [], []
    with T.ObsServer(reg, port=0) as srv:
        def scraper():
            while not stop.is_set():
                try:
                    T.parse_prometheus_text(_get(srv.url + "/metrics")[1])
                    scrapes.append(1)
                except Exception as e:      # pragma: no cover
                    errors.append(repr(e))
        t = threading.Thread(target=scraper)
        t.start()
        try:
            live = _small_solve(registry=reg)
            # a scrape after the last step too
            T.parse_prometheus_text(_get(srv.url + "/metrics")[1])
        finally:
            stop.set()
            t.join()
    assert errors == [] and scrapes
    assert torch.equal(plain.w, live.w) and torch.equal(plain.alpha,
                                                        live.alpha)
    assert [h["objective"] for h in plain.history] == \
        [h["objective"] for h in live.history]


def test_solve_with_recorder_and_monitor_stays_ok(tmp_path):
    reg = T.Registry()
    rec = T.FlightRecorder(capacity=32, registry=reg)
    mon = T.HealthMonitor(reg, T.solver_rules(max_comm_share=1.0),
                          recorder=rec, dump_dir=str(tmp_path))
    res = _small_solve(tracer=rec, registry=reg, monitor=mon)
    assert res.iters == 4 and mon.status == T.OK
    assert mon.evaluations >= 4 and rec.dumps == []
    assert len(rec.events) <= 32
    # every registry value is a plain float: the endpoint thread never
    # touches a tensor
    snap = reg.snapshot()
    assert all(type(v) is float for v in snap["gauges"].values())
    assert all(type(v) is float for v in snap["counters"].values())


def _service(rules, tmp_path, queue_capacity=4096, clock=None):
    reg = T.Registry()
    rec = T.FlightRecorder(capacity=64, registry=reg)
    mon = T.HealthMonitor(reg, rules, recorder=rec, dump_dir=str(tmp_path))
    cfg = OnlineConfig(m=10, capacity=32, P=2, Q=2,
                       solver_cfg=D3CAConfig(lam=1e-2, local_steps=8),
                       passes=2, queue_capacity=queue_capacity)
    kw = {} if clock is None else {"clock": clock}
    svc = OnlineSolverService(cfg, registry=reg, monitor=mon, device="cpu",
                              **kw)
    return svc, reg, rec, mon


def _stream(b, m, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(b, m)).astype(np.float32)
    y = np.sign(X @ np.linspace(-1, 1, m) + 0.1).astype(np.float32)
    return X, np.where(y == 0, 1.0, y)


def test_online_service_healthy_run_stays_ok(tmp_path):
    svc, reg, rec, mon = _service(
        T.online_rules(max_staleness_s=1e6, max_shed_rate=0.5), tmp_path)
    for i in range(3):
        svc.submit(*_stream(8, 10, seed=i))
        svc.run_pending()
        svc.score(_stream(16, 10, seed=100 + i)[0])
    assert mon.status == T.OK and mon.evaluations > 0 and rec.dumps == []
    g = {k.split("{")[0]: v for k, v in reg.snapshot()["gauges"].items()}
    assert math.isfinite(g["online/w_norm"]) and g["online/w_norm"] > 0
    # the service's registry reached every update: the solver's metrics
    assert reg.snapshot()["histograms"][
        "solver/step_s{engine=simulated,solver=d3ca}"]["count"] == 6


def test_online_divergence_flips_crit_and_dumps_once(tmp_path):
    import dataclasses
    svc, reg, rec, mon = _service(T.online_rules(max_staleness_s=1e6),
                                  tmp_path)
    svc.submit(*_stream(8, 10))
    svc.run_pending()
    assert mon.status == T.OK
    real = svc.solver.update

    def poisoned(*a, **kw):
        res = real(*a, **kw)
        return dataclasses.replace(res, w=torch.full_like(res.w, math.nan))
    svc.solver.update = poisoned
    svc.submit(*_stream(8, 10, seed=1))
    svc.run_pending()
    assert mon.status == T.CRIT and len(rec.dumps) == 1
    svc.score(_stream(8, 10)[0])
    mon.evaluate()
    assert len(rec.dumps) == 1
    assert J.load_bundle(rec.dumps[0])["reason"].startswith(
        "health:online_divergence")


def test_online_staleness_breach_flips_crit_and_dumps_once(tmp_path):
    svc, reg, rec, mon = _service(T.online_rules(max_staleness_s=30.0),
                                  tmp_path, clock=FakeClock())
    svc.submit(*_stream(8, 10))
    svc.run_pending()
    assert mon.status == T.OK
    for i in range(60):
        svc.score(_stream(4, 10, seed=i)[0])
    assert mon.status == T.CRIT and len(rec.dumps) == 1
    assert T.load_bundle(rec.dumps[0])["reason"].startswith(
        "health:staleness")


def test_online_queue_saturation_flips_crit_and_dumps_once(tmp_path):
    from repro_torch.online import QueueFullError
    svc, reg, rec, mon = _service(
        T.online_rules(max_staleness_s=1e6, max_shed_rate=0.2), tmp_path,
        queue_capacity=8)
    svc.submit(*_stream(8, 10))
    with pytest.raises(QueueFullError):
        svc.submit(*_stream(8, 10, seed=1))
    assert mon.status == T.CRIT and len(rec.dumps) == 1
    svc.run_pending()
    svc.submit(*_stream(4, 10, seed=2))
    assert mon.status == T.OK and len(rec.dumps) == 1

"""The port's telemetry against the reference's, on the CPU: the tracer's
events and exports, the phase split, ``LocalComm`` and the timing twin of
every grid program, the timed ``drive``, and traced / registered solves
of the four solvers (the reference's ``jax.random`` orders injected), the
online service, the fleet and the serving engine span for span.

Traced solves are held to the reference's span sequence (names, depths,
``iter`` arguments), its registry keys and labels, its objective / gap /
rel_opt gauges within 1e-5 relative and its counters exactly, and to
bitwise the port's own untraced solve.
"""
import dataclasses
import json
import threading

import numpy as np
import pytest
import torch

import repro.obs as J
import repro_torch.obs as T
from repro.core import D3CAConfig as JD3CA
from repro.core import get_solver as j_get_solver
from repro.fleet import FleetProblem as JFleetProblem
from repro.fleet import FleetSolver as JFleetSolver
from repro.online import OnlineConfig as JOnlineConfig
from repro.online import OnlineSolverService as JService
from repro.serve import EngineConfig as RefEngineConfig
from repro.serve import InferenceEngine as RefEngine
from repro.serve import Request as RefRequest
from repro_torch.core import (Comm, CommSchedule, D3CAConfig, LocalComm,
                              SyncComm, get_solver, grid_program)
from repro_torch.core.d3ca import d3ca_cell_program
from repro_torch.core.engines import drive
from repro_torch.core.indices import GeneratorIndexSource
from repro_torch.core.losses import get_loss
from repro_torch.data import csr_from_dense
from repro_torch.fleet import FleetSolver
from repro_torch.online import OnlineConfig, OnlineSolverService
from repro_torch.serve import EngineConfig, InferenceEngine, Request
from test_torch_common import lm_pair, make_problem
from test_torch_compress import CASES, GRID, ITERS, N, _problem
from test_torch_fleet import CFGS as FLEET_CFGS
from test_torch_fleet import make_problems, with_sources

class FakeClock:
    """Deterministic clock: every call advances one second."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 1.0
        return self.t


# ---------------------------------------------------------------------------
# the tracer
# ---------------------------------------------------------------------------

def _script_nested(tr):
    with tr.span("outer", which="o"):
        with tr.span("inner"):
            pass
        tr.instant("marker", reason="x")
    with tr.span("second", k=2):
        pass


def _script_recorded(tr):
    with tr.span("step", iter=1):
        t0 = tr.now()
    tr.record("local_solve", t0, 0.5, iter=1)
    tr.record("comm/dalpha", t0 + 0.5, 0.25, iter=1)
    tr.record("comm/w_contrib", t0 + 0.75, 0.125)
    tr.instant("codec_bench", dalpha=0.001)


SCRIPTS = {"nested": _script_nested, "recorded": _script_recorded}


@pytest.mark.parametrize("script", sorted(SCRIPTS))
def test_tracer_payloads_equal_the_reference(script, tmp_path):
    """One fake-clock span sequence through both tracers: equal events,
    equal Chrome-trace payloads and byte-equal JSONL."""
    got, want = T.Tracer(clock=FakeClock()), J.Tracer(clock=FakeClock())
    SCRIPTS[script](got)
    SCRIPTS[script](want)
    assert got.events == want.events
    assert got.to_chrome_trace() == want.to_chrome_trace()
    got.write_jsonl(str(tmp_path / "t.jsonl"))
    want.write_jsonl(str(tmp_path / "j.jsonl"))
    assert (tmp_path / "t.jsonl").read_text() == \
        (tmp_path / "j.jsonl").read_text()
    got.write_chrome_trace(str(tmp_path / "t.json"))
    want.write_chrome_trace(str(tmp_path / "j.json"))
    assert json.loads((tmp_path / "t.json").read_text()) == \
        json.loads((tmp_path / "j.json").read_text())
    for name in ("inner", "outer", "comm/dalpha", "nope"):
        assert got.total(name) == want.total(name)
        assert got.spans(name) == want.spans(name)


def test_null_tracer_is_shared_and_free():
    assert T.as_tracer(None) is T.NULL_TRACER
    tr = T.Tracer()
    assert T.as_tracer(tr) is tr
    null = T.NullTracer()
    assert null.span("a") is T.NULL_TRACER.span("b")
    null.record("x", 0.0, 1.0)
    null.instant("y")
    assert null.events == [] and not null.enabled
    off = T.Tracer(enabled=False)
    with off.span("z"):
        off.instant("w")
        off.record("v", 0.0, 1.0)
    assert off.events == []


def test_tracer_keeps_a_span_stack_per_thread():
    tr = T.Tracer()

    def work(k):
        for _ in range(100):
            with tr.span(f"outer{k}"):
                with tr.span(f"inner{k}"):
                    pass
    threads = [threading.Thread(target=work, args=(k,)) for k in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(tr.events) == 6 * 200
    for e in tr.events:
        assert e["depth"] == (1 if e["name"].startswith("inner") else 0)


def test_profiler_annotations_appear_in_a_torch_profiler_trace():
    """``profiler_annotations=True`` enters ``record_function`` per live
    span: the names show up in a CPU ``torch.profiler`` trace, and a
    tracer without it adds none."""
    names = {}
    for flag in (True, False):
        tr = T.Tracer(profiler_annotations=flag)
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            with tr.span("obs_outer_span"):
                with tr.span("obs_inner_span"):
                    torch.ones(4) @ torch.ones(4)
        names[flag] = {e.key for e in prof.key_averages()}
    assert {"obs_outer_span", "obs_inner_span"} <= names[True]
    assert not {"obs_outer_span", "obs_inner_span"} & names[False]
    rec = T.FlightRecorder(capacity=4, profiler_annotations=True)
    assert rec.profiler_annotations


# ---------------------------------------------------------------------------
# the phase split
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("local_frac,shares,step_s", [
    (0.8, {"dalpha": 0.25, "w_contrib": 0.75}, 2e-3),
    (1.0, {"z": 0.5, "grad": 0.25, "dw": 0.25}, 1.5e-3),
    (0.0, {"v": 1.0}, 3.0), (0.5, {}, 0.01)])
def test_phase_split_attributes_as_the_reference(local_frac, shares, step_s):
    kw = dict(local_frac=local_frac, comm_shares=shares, step_s=1.0,
              local_s=local_frac)
    assert T.PhaseSplit(**kw).attribute(step_s) == \
        J.PhaseSplit(**kw).attribute(step_s)


@pytest.mark.parametrize("name", ["d3ca", "radisa", "sfk", "admm"])
def test_calibration_prices_collectives_as_the_reference(name):
    """The split's collective shares are the reference's (exact bytes on
    the wire), its fraction lies in [0, 1], and calibrating changes no
    iterate."""
    JCfg, TCfg, kw, source = CASES[name]
    X, y = _problem("dense")
    prog = get_solver(name)(device="cpu", index_source=source(N)).program(
        "hinge", X, y, P=GRID[0], Q=GRID[1], cfg=TCfg(**kw))
    jprog = j_get_solver(name)(engine="simulated").program(
        "hinge", X, y, P=GRID[0], Q=GRID[1], cfg=JCfg(**kw))
    state0 = [t.clone() for t in _leaves(prog.state)]
    split = T.calibrate_phases(prog, reps=2)
    coll = jprog.comm_bytes["collectives"]
    total = sum(c["bytes_per_step"] for c in coll.values())
    assert split.comm_shares == {n: c["bytes_per_step"] / total
                                 for n, c in coll.items()}
    assert 0.0 <= split.local_frac <= 1.0 and split.step_s > 0
    assert all(torch.equal(a, b)
               for a, b in zip(_leaves(prog.state), state0))
    assert T.calibrate_phases(dataclasses.replace(prog, local_step=None)) \
        is None


def _leaves(tree):
    if torch.is_tensor(tree):
        return [tree]
    items = tree.values() if isinstance(tree, dict) else tree
    return [leaf for item in items for leaf in _leaves(item)]


def test_bench_codecs_times_the_blocked_payload_of_each_lossy_collective():
    X, y = _problem("dense")
    s = get_solver("radisa")(device="cpu", compression="z=int8,dw=topk:0.1")
    prog = s.program("hinge", X, y, P=GRID[0], Q=GRID[1],
                     cfg=CASES["radisa"][1](**CASES["radisa"][2]))
    shapes = []
    real = type(s.active_policy.codec_for("z")).apply

    def apply(self, value, err=None):
        shapes.append(tuple(value.shape))
        return real(self, value, err)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(type(s.active_policy.codec_for("z")), "apply", apply)
        got = T.bench_codecs(s.active_policy, prog.comm_bytes, grid=GRID,
                             device="cpu", reps=2)
    assert sorted(got) == ["dw", "z"]   # grad's identity codec is free
    assert all(isinstance(v, float) and v > 0 for v in got.values())
    cell = prog.comm_bytes["collectives"]["z"]["payload_shape"]
    assert set(shapes) == {(*GRID, *cell)}  # the int8 calls: z's only


# ---------------------------------------------------------------------------
# LocalComm and the timing twin of every grid program
# ---------------------------------------------------------------------------

def _record_results(monkeypatch):
    seen = []
    real = Comm.__call__

    def call(self, name, value):
        out = real(self, name, value)
        seen.append((type(self).__name__, name, tuple(out.shape)))
        return out
    monkeypatch.setattr(Comm, "__call__", call)
    return seen


@pytest.mark.parametrize("block_format", ["dense", "sparse"])
@pytest.mark.parametrize("name", ["d3ca", "radisa", "sfk", "admm"])
def test_local_comm_results_have_the_sync_shapes(name, block_format,
                                                 monkeypatch):
    """Every collective of the four solvers: the timing twin's result has
    the shape the synchronous reduction's has, and the twin's state has
    the step's shapes."""
    JCfg, TCfg, kw, source = CASES[name]
    X, y = _problem(block_format)
    if block_format == "sparse":
        X = csr_from_dense(X)
    prog = get_solver(name)(device="cpu", block_format=block_format,
                            index_source=source(N)).program(
        "hinge", X, y, P=GRID[0], Q=GRID[1], cfg=TCfg(**kw))
    seen = _record_results(monkeypatch)
    out = prog.step(1, prog.state)
    twin = prog.local_step(1, prog.state)
    sync = [(n, s) for c, n, s in seen if c == "SyncComm"]
    local = [(n, s) for c, n, s in seen if c == "LocalComm"]
    assert sync == local and len(sync) >= 2
    assert [t.shape for t in _leaves(out)] == [t.shape for t in
                                               _leaves(twin)]


@pytest.mark.parametrize("op,axis", [("psum", "data"), ("psum", "model"),
                                     ("pmean", "data"), ("pmean", "model"),
                                     ("allgather", "data"),
                                     ("allgather", "model")])
def test_local_comm_runs_each_point_cell_locally(op, axis):
    sched = getattr(CommSchedule(), op)("c", axis=axis)
    value = torch.arange(3 * 2 * 5, dtype=torch.float32).reshape(3, 2, 5)
    sizes = {"data": 3, "model": 2}
    got = LocalComm(sched, sizes, device="cpu", payload_shapes={"c": (5,)})(
        "c", value)
    want = SyncComm(sched, sizes, device="cpu")("c", value)
    assert got.shape == want.shape
    dim = 0 if axis == "data" else 1
    if op == "allgather":
        assert torch.equal(got, want)
    else:
        assert torch.equal(got, value.select(dim, 0)) and got.is_contiguous()
    with pytest.raises(ValueError, match="declared"):
        LocalComm(sched, sizes, device="cpu", payload_shapes={"c": (4,)})(
            "c", value)


def test_the_timing_twin_refuses_a_codec_and_ignores_a_topology():
    loss = get_loss("hinge")
    src = GeneratorIndexSource(0, P=4, Q=2, n_p=5, device="cpu")
    cp = d3ca_cell_program(loss, D3CAConfig(), n=20, index_source=src,
                           local_backend="ref", m_q=3)
    with pytest.raises(ValueError, match="compression"):
        grid_program(cp, 4, 2, comm_local=True, compression="int8",
                     device="cpu")
    step = grid_program(cp, 4, 2, comm_local=True, topology="pods=2:int8",
                        device="cpu")
    assert callable(step)


def test_untimed_drive_waits_for_nothing_and_the_timed_drive_every_step(
        monkeypatch):
    import repro_torch.obs.phases as phases
    waits = []
    monkeypatch.setattr(phases, "wait_for", lambda dev: waits.append(dev))
    X, y = make_problem(40, 12)
    prog = get_solver("d3ca")(device="cpu").program(
        "hinge", X, y, P=2, Q=2, cfg=D3CAConfig(outer_iters=3))
    polls = []

    class Mon:
        def poll(self):
            polls.append(1)
    plain, _, _ = drive(prog, 3, monitor=Mon())
    assert waits == [] and len(polls) == 3
    timed = []
    traced, _, _ = drive(prog, 3, tracer=T.Tracer(),
                         on_step=lambda t, t0, s: timed.append(t))
    assert len(waits) == 3 and timed == [1, 2, 3]
    assert all(torch.equal(a, b) for a, b in zip(plain, traced))


# ---------------------------------------------------------------------------
# traced / registered solves against the reference's
# ---------------------------------------------------------------------------

SOLVE_CASES = [("d3ca", "dense", None), ("radisa", "dense", None),
               ("sfk", "dense", None), ("admm", "dense", None),
               ("d3ca", "sparse", None), ("radisa", "sparse", None),
               ("d3ca", "dense", "int8")]
F_STAR = 0.05


def _span_seq(tracer):
    return [(e["name"], e["depth"], (e.get("args") or {}).get("iter"))
            for e in tracer.events]


def _keys(snap):
    return {k: sorted(v) for k, v in snap.items()}


@pytest.mark.parametrize("name,block_format,compression", SOLVE_CASES)
def test_traced_solve_matches_reference_and_untraced(name, block_format,
                                                     compression):
    JCfg, TCfg, kw, source = CASES[name]
    kw = dict(kw, outer_iters=ITERS)
    X, y = _problem(block_format)
    Xt = csr_from_dense(X) if block_format == "sparse" else X
    port = get_solver(name)(device="cpu", block_format=block_format,
                            compression=compression, index_source=source(N))
    plain = port.solve("hinge", Xt, y, P=GRID[0], Q=GRID[1], cfg=TCfg(**kw),
                       f_star=F_STAR)
    tr, reg = T.Tracer(), T.Registry()
    got = port.solve("hinge", Xt, y, P=GRID[0], Q=GRID[1], cfg=TCfg(**kw),
                     f_star=F_STAR, tracer=tr, registry=reg)
    jtr, jreg = J.Tracer(), J.Registry()
    want = j_get_solver(name)(engine="simulated", block_format=block_format,
                              compression=compression).solve(
        "hinge", X, y, P=GRID[0], Q=GRID[1], cfg=JCfg(**kw), f_star=F_STAR,
        tracer=jtr, registry=jreg)
    # the port's traced solve is bitwise its untraced one
    assert torch.equal(got.w, plain.w)
    assert (got.alpha is None) == (plain.alpha is None)
    if got.alpha is not None:
        assert torch.equal(got.alpha, plain.alpha)
    assert [h["objective"] for h in got.history] == \
        [h["objective"] for h in plain.history]
    # the span tree, the registry and the history are the reference's
    assert _span_seq(tr) == _span_seq(jtr)
    snap, jsnap = reg.snapshot(), jreg.snapshot()
    assert _keys(snap) == _keys(jsnap)
    lab = f"{{engine=simulated,solver={name}}}"
    for c in ("solver/iters", "solver/comm_bytes"):
        assert snap["counters"][c + lab] == jsnap["counters"][c + lab]
    for g in ("solver/objective", "solver/duality_gap", "solver/rel_opt"):
        if g + lab in jsnap["gauges"]:
            np.testing.assert_allclose(snap["gauges"][g + lab],
                                       jsnap["gauges"][g + lab], rtol=1e-5)
    for k, v in snap["histograms"].items():
        assert v["count"] == jsnap["histograms"][k]["count"]
    assert [sorted(h) for h in got.history] == \
        [sorted(h) for h in want.history]
    assert all(type(v) is float for v in snap["gauges"].values())
    for h in got.history:
        assert h["local_s"] + h["comm_s"] <= h["step_s"] + 1e-12


def test_untimed_solve_history_has_no_phase_fields():
    X, y = make_problem(40, 12)
    res = get_solver("d3ca")(device="cpu").solve(
        "hinge", X, y, P=2, Q=2, cfg=D3CAConfig(outer_iters=2))
    for h in res.history:
        assert not {"step_s", "local_s", "comm_s", "host_s"} & set(h)


def test_trace_spans_cover_the_solve():
    """The solve span is covered by data prep, calibration and the outer
    iterations, and each iteration's attribution spans lie inside its
    step."""
    X, y = make_problem(120, 40)
    tr = T.Tracer()
    get_solver("d3ca")(device="cpu").solve(
        "hinge", X, y, P=2, Q=2, cfg=D3CAConfig(outer_iters=3), tracer=tr)
    covered = (tr.total("data_prep") + tr.total("calibrate")
               + tr.total("outer_iter"))
    assert covered >= 0.95 * tr.total("solve")
    for it in (1, 2, 3):
        step = next(s for s in tr.spans("step") if s["args"]["iter"] == it)
        for name in ("local_solve", "comm/dalpha", "comm/w_contrib"):
            s = next(s for s in tr.spans(name) if s["args"]["iter"] == it)
            assert s["ts"] >= step["ts"] - 1e-9
            assert s["ts"] + s["dur"] <= step["ts"] + step["dur"] + 1e-9


# ---------------------------------------------------------------------------
# the online service, the fleet and the serving engine, span for span
# ---------------------------------------------------------------------------

def _stream(rng, b, m):
    X = rng.normal(size=(b, m)).astype(np.float32)
    y = np.where(X @ np.linspace(-1.0, 1.0, m) >= 0, 1.0,
                 -1.0).astype(np.float32)
    return X, y


def _drive_service(svc, rounds=2, m=8):
    rng = np.random.default_rng(0)
    for _ in range(rounds):
        svc.submit(*_stream(rng, 6, m))
        svc.run_pending()
        svc.score(_stream(rng, 4, m)[0])


def test_online_service_spans_equal_the_reference():
    kw = dict(m=8, capacity=24, P=2, Q=2, passes=2)
    tr, jtr = T.Tracer(), J.Tracer()
    svc = OnlineSolverService(OnlineConfig(solver_cfg=D3CAConfig(lam=0.1),
                                           **kw), device="cpu", tracer=tr)
    jsvc = JService(JOnlineConfig(solver_cfg=JD3CA(lam=0.1), **kw),
                    tracer=jtr)
    _drive_service(svc)
    _drive_service(jsvc)
    assert _span_seq(tr) == _span_seq(jtr)
    assert [e.get("args") for e in tr.events if e["depth"] == 0] == \
        [e.get("args") for e in jtr.events if e["depth"] == 0]
    assert _keys(svc.registry.snapshot()) == _keys(jsvc.registry.snapshot())


def test_fleet_spans_and_gauges_equal_the_reference():
    cfg, jcfg = FLEET_CFGS["d3ca"]
    probs = [dataclasses.replace(p, f_star=0.25) for p in with_sources(
        "d3ca", cfg, make_problems())]
    jprobs = [JFleetProblem(tenant_id=p.tenant_id, loss_name=p.loss_name,
                            X=p.X, y=p.y, lam=p.lam, seed=p.seed,
                            f_star=p.f_star) for p in probs]
    tr, reg, jtr, jreg = T.Tracer(), T.Registry(), J.Tracer(), J.Registry()
    FleetSolver(device="cpu").solve_batch(probs, P=2, Q=2, cfg=cfg,
                                          check_every=2, tracer=tr,
                                          registry=reg)
    JFleetSolver(local_backend="ref").solve_batch(
        jprobs, P=2, Q=2, cfg=jcfg, check_every=2, tracer=jtr,
        registry=jreg)
    assert [(e["name"], e["depth"], e.get("args")) for e in tr.events] == \
        [(e["name"], e["depth"], e.get("args")) for e in jtr.events]
    got, want = reg.snapshot()["gauges"], jreg.snapshot()["gauges"]
    assert sorted(got) == sorted(want)
    for k in got:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5)


def test_serving_engine_spans_and_instants_equal_the_reference():
    rmodel, rparams, model, params = lm_pair("qwen3-1.7b")
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, model.cfg.vocab, size=n) for n in (5, 9, 7)]
    ecfg = dict(max_slots=2, page_size=8, num_pages=16, max_seq_len=32)
    tr, jtr = T.Tracer(), J.Tracer()
    InferenceEngine(model, params, EngineConfig(**ecfg), tracer=tr).run(
        [Request(rid=i, prompt=p, max_new_tokens=4)
         for i, p in enumerate(prompts)])
    RefEngine(rmodel, rparams, RefEngineConfig(**ecfg), tracer=jtr).run(
        [RefRequest(rid=i, prompt=p, max_new_tokens=4)
         for i, p in enumerate(prompts)])
    seq = [(e["name"], e["depth"], e.get("args")) for e in tr.events]
    assert seq == [(e["name"], e["depth"], e.get("args"))
                   for e in jtr.events]
    assert sum(n == "prefill" for n, _, _ in seq) == 3
    assert sum(n == "finish" for n, _, _ in seq) == 3

"""The mesh engines on a CPU process grid of 3 x 2 ranks over gloo.

``engine="shard_map"`` (alias ``"sync"``), ``"async"`` and ``"overlap"``
run one block per rank (``repro_torch.launch.mesh``).  They are held to:

  * the port's own grid engine (``engine="simulated"``) and the
    reference's ``engine="simulated", local_backend="ref"``, with the
    reference's ``jax.random`` orders injected, iteration by iteration,
    iterates and the objective / gap history within 1e-5 -- the gap is
    summation order (a blocked tensor sum against gloo's all-reduce);
  * the contracts of ``docs/consistency.md``: async tau = 0 and overlap
    tau = 0 bitwise shard_map, overlap tau = 2 bitwise async tau = 2 (also
    under int8), async tau = 2 within 1e-5 of a one-process emulation of
    the delay rule on the grid engine's reductions, and converging;
  * the comm policies: ``compression=None`` bitwise identity, int8 within
    two int8 quanta of int8 on the grid engine, the wire accounting dicts
    equal to the grid engine's;
  * the timed path: the reference's span sequence and registry keys, and
    bitwise the untraced solve.

One grid serves the whole module (a fixture); every test is bounded by an
alarm and every collective by the grid's timeout.
"""
import numpy as np
import pytest
import torch

import repro.obs as J
import repro_torch.obs as T
from repro.core import ADMMConfig as JADMM
from repro.core import D3CAConfig as JD3CA
from repro.core import RADiSAConfig as JRADiSA
from repro.core import SFKConfig as JSFK
from repro.core import get_solver as j_get_solver
from repro_torch.core import (ADMMConfig, D3CAConfig, RADiSAConfig,
                              SFKConfig, SyncComm, get_loss, get_solver,
                              partition, partition_sparse)
from repro_torch.core.d3ca import d3ca_cell_program
from repro_torch.core.radisa import radisa_cell_program
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch.mesh import close_grids, process_grid
from test_torch_common import (MESH_GRID_TIMEOUT, bounded,  # noqa: F401
                               d3ca_source, make_problem, radisa_source,
                               sfk_source)

GRID = (3, 2)
N, M, ITERS = 101, 37, 3
TOL = dict(rtol=1e-5, atol=1e-5)

pytestmark = pytest.mark.usefixtures("bounded")


@pytest.fixture(scope="module")
def grid():
    g = process_grid(*GRID, device="cpu", timeout=MESH_GRID_TIMEOUT)
    yield g
    close_grids()


CASES = {
    "d3ca": (JD3CA, D3CAConfig, dict(lam=0.05, seed=3),
             lambda: d3ca_source(3, N, iters=ITERS, grid=GRID)),
    "radisa": (JRADiSA, RADiSAConfig, dict(lam=0.05, gamma=0.05, seed=3),
               lambda: radisa_source(3, N, iters=ITERS, grid=GRID)),
    "radisa-avg": (JRADiSA, RADiSAConfig,
                   dict(lam=0.05, gamma=0.05, seed=3, variant="avg"),
                   lambda: radisa_source(3, N, iters=ITERS, grid=GRID)),
    "sfk": (JSFK, SFKConfig, dict(lam=0.05, gamma=0.05, seed=3),
            lambda: sfk_source(3, N, 0.5, iters=ITERS, grid=GRID)),
    "admm": (JADMM, ADMMConfig, dict(lam=0.05, rho=0.05), lambda: None),
}


def _problem(block_format):
    X, y = make_problem(N, M, seed=2)
    if block_format == "sparse":
        X = np.where(np.random.default_rng(3).random(X.shape) < 0.3, X,
                     0.0).astype(np.float32)
    return X, y


def _solver(case):
    return case.split("-")[0]


def _collect(solver, X, y, cfg, grid=GRID, **kw):
    """Solve and keep every iteration's (w, alpha)."""
    its = []

    def cb(t, w, alpha):
        its.append((np.array(w), None if alpha is None else np.array(alpha)))
    res = solver.solve("hinge", X, y, P=grid[0], Q=grid[1], cfg=cfg,
                       callback=cb, **kw)
    return res, its


def _port(case, block_format, engine="shard_map", backend="kernel", **kw):
    _, TCfg, cfg_kw, source = CASES[case]
    X, y = _problem(block_format)
    solver = get_solver(_solver(case))(
        engine=engine, local_backend=backend, block_format=block_format,
        device="cpu", index_source=source(), **kw)
    return _collect(solver, X, y, TCfg(**dict(cfg_kw, outer_iters=ITERS)))


_REFERENCE = {}


def _reference(case, block_format):
    """The reference's simulated / ref solve, once per case."""
    if (case, block_format) not in _REFERENCE:
        JCfg, _, cfg_kw, _ = CASES[case]
        X, y = _problem(block_format)
        _REFERENCE[case, block_format] = _collect(
            j_get_solver(_solver(case))(engine="simulated",
                                        local_backend="ref",
                                        block_format=block_format),
            X, y, JCfg(**dict(cfg_kw, outer_iters=ITERS)))
    return _REFERENCE[case, block_format]


def _same_iterates(a, b, dual, tol=TOL):
    (ra, ia), (rb, ib) = a, b
    assert ra.iters == rb.iters == len(ia) == len(ib) == ITERS
    for (wa, aa), (wb, ab), ha, hb in zip(ia, ib, ra.history, rb.history):
        np.testing.assert_allclose(wa, wb, **tol)
        np.testing.assert_allclose(ha["objective"], hb["objective"], **tol)
        if dual:
            np.testing.assert_allclose(aa, ab, **tol)
            np.testing.assert_allclose(ha["duality_gap"], hb["duality_gap"],
                                       **tol)


def _bitwise(a, b):
    return a.shape == b.shape and torch.equal(a, b)


# ---------------------------------------------------------------------------
# engine level: the mesh against the grid engine and the reference
# ---------------------------------------------------------------------------

ENGINE_CASES = [(c, f, b) for c in ("d3ca", "radisa", "radisa-avg", "sfk")
                for f in ("dense", "sparse") for b in ("kernel", "ref")] + [
    ("admm", "dense", "kernel"), ("admm", "sparse", "kernel")]


@pytest.mark.parametrize("case,block_format,backend", ENGINE_CASES)
def test_shard_map_matches_the_grid_engine_and_the_reference(
        grid, case, block_format, backend):
    dual = case == "d3ca"
    mesh = _port(case, block_format, backend=backend)
    flat = _port(case, block_format, engine="simulated", backend=backend)
    _same_iterates(mesh, flat, dual)
    _same_iterates(mesh, _reference(case, block_format), dual)
    res = mesh[0]
    assert (res.engine, res.device, res.block_format) == (
        "shard_map", "cpu", block_format)
    assert res.comm_bytes == flat[0].comm_bytes
    assert res.w.shape == (M,) and res.w.dtype == torch.float32


def test_sync_is_shard_map_and_a_process_grid_is_reused(grid):
    a = _port("d3ca", "dense")[0]
    b = _port("d3ca", "dense", engine="sync")[0]
    assert b.engine == "shard_map"
    assert _bitwise(a.w, b.w) and _bitwise(a.alpha, b.alpha)
    assert process_grid(*GRID, device="cpu") is grid and not grid.closed
    X, y = _problem("dense")
    c = get_solver("d3ca")(engine="shard_map", device="cpu",
                           index_source=CASES["d3ca"][3]()).solve(
        "hinge", X, y, mesh=grid, cfg=D3CAConfig(lam=0.05, seed=3,
                                                 outer_iters=ITERS))
    assert _bitwise(a.w, c.w)
    with pytest.raises(ValueError, match="mesh is 3x2"):
        get_solver("d3ca")(engine="shard_map", device="cpu").solve(
            "hinge", X, y, P=2, Q=3, mesh=grid, cfg=D3CAConfig())


def test_worker_launches_stay_on_the_grid(grid):
    """The workers' launch counts are kept in ``grid.worker_launches``,
    never added to the controller's wrapper counters (on the CPU the
    wrappers run their plain versions and count nothing)."""
    before = mesh_mod.launch_counts()
    grid.worker_launches = {}
    _port("d3ca", "dense")
    assert mesh_mod.launch_counts() == before
    assert set(grid.worker_launches) == {n for _, n in mesh_mod.COUNTED}
    assert all(c["launches"] == 0 for c in grid.worker_launches.values())
    a = {"k": {"launches": 3, "launches_by_route": {"x": 2, "y": 1}}}
    b = {"k": {"launches": 1, "launches_by_route": {"x": 1}}}
    assert mesh_mod.add_counts(a, b, -1) == {
        "k": {"launches": 2, "launches_by_route": {"x": 1, "y": 1}}}


def test_early_stopping_ends_the_session(grid):
    """``tol=`` stops after the first observed iteration: the controller
    issues no further step, and the ranks end the session with it."""
    X, y = _problem("dense")
    cfg = D3CAConfig(lam=0.05, seed=3, outer_iters=ITERS)
    res = get_solver("d3ca")(engine="shard_map", device="cpu").solve(
        "hinge", X, y, P=GRID[0], Q=GRID[1], cfg=cfg, tol=10.0)
    assert res.converged and res.iters == 1 and len(res.history) == 1
    again = get_solver("d3ca")(engine="shard_map", device="cpu").solve(
        "hinge", X, y, P=GRID[0], Q=GRID[1], cfg=cfg)
    assert again.iters == ITERS and not again.converged


def test_warm_start_and_row_gate_on_the_mesh(grid):
    """A warm-started, gated D3CA pass (Solver.update) equals the grid
    engine's."""
    X, y = _problem("dense")
    cfg = D3CAConfig(lam=0.05, seed=3, outer_iters=2)
    got = {}
    for engine in ("simulated", "shard_map"):
        s = get_solver("d3ca")(engine=engine, device="cpu")
        first = s.solve("hinge", X, y, P=GRID[0], Q=GRID[1], cfg=cfg)
        got[engine] = s.update("hinge", torch.as_tensor(X), y,
                               touched=np.arange(20, 60), warm_start=first,
                               P=GRID[0], Q=GRID[1], cfg=cfg, passes=2)
    np.testing.assert_allclose(got["shard_map"].w, got["simulated"].w, **TOL)
    np.testing.assert_allclose(got["shard_map"].alpha,
                               got["simulated"].alpha, **TOL)


# ---------------------------------------------------------------------------
# the staleness contracts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["d3ca", "radisa", "sfk", "admm"])
@pytest.mark.parametrize("block_format", ["dense", "sparse"])
def test_tau0_async_and_overlap_are_shard_map_bitwise(grid, case,
                                                      block_format):
    sync = _port(case, block_format)[0]
    for engine in ("async", "overlap"):
        got = _port(case, block_format, engine=engine, staleness=0)[0]
        assert got.engine == engine and got.staleness == 0
        assert _bitwise(got.w, sync.w)
        if sync.alpha is not None:
            assert _bitwise(got.alpha, sync.alpha)
        assert [h["objective"] for h in got.history] == \
            [h["objective"] for h in sync.history]
        assert got.comm_bytes == sync.comm_bytes


@pytest.mark.parametrize("case", ["d3ca", "radisa", "sfk", "admm"])
@pytest.mark.parametrize("compression", [None, "int8"])
def test_overlap_tau2_is_async_tau2_bitwise(grid, case, compression):
    a = _port(case, "dense", engine="async", staleness=2,
              compression=compression)[0]
    o = _port(case, "dense", engine="overlap", staleness=2,
              compression=compression)[0]
    assert _bitwise(a.w, o.w)
    if a.alpha is not None:
        assert _bitwise(a.alpha, o.alpha)
    # the delay is real: tau = 2 is not the synchronous trajectory
    assert not _bitwise(a.w, _port(case, "dense", compression=compression)
                        [0].w)
    # additive wire accounting: re-timing consumption moves no byte
    assert a.comm_bytes == o.comm_bytes


class DelayRule(SyncComm):
    """A one-process emulation of the bounded-staleness rule on the grid
    engine's blocked reductions: the value applied at step t is the one
    computed at step max(1, t - tau), looked up in the whole history of
    reductions (``past[name][s - 1]`` is step s's)."""

    def __init__(self, *a, tau, t, past, **kw):
        super().__init__(*a, **kw)
        self.tau, self.t, self.past = tau, t, past

    def _exec(self, point, value):
        self.past.setdefault(point.name, []).append(
            self._reduce(point, value))
        return self.past[point.name][max(1, self.t - self.tau) - 1]


def _emulate(name, block_format, tau):
    """The grid engine's cell program under :class:`DelayRule`."""
    _, TCfg, cfg_kw, source = CASES[name]
    cfg = TCfg(**dict(cfg_kw, outer_iters=ITERS))
    X, y = _problem(block_format)
    P, Q = GRID
    loss = get_loss("hinge")
    sparse = block_format == "sparse"
    data = (partition_sparse if sparse else partition)(
        X, y, P, Q, m_multiple=P * Q, device="cpu")
    x_parts = (data.cols, data.vals) if sparse else (data.x_blocks,)
    gdata = (*x_parts, data.y_blocks, data.mask)
    if name == "d3ca":
        prog = d3ca_cell_program(loss, cfg, n=data.n, index_source=source(),
                                 local_backend="ref", sparse=sparse,
                                 m_q=data.m_q)
        state = (torch.zeros(P, data.n_p), torch.zeros(Q, data.m_q))
    else:
        prog = radisa_cell_program(loss, cfg, n=data.n, m_q=data.m_q,
                                   index_source=source(),
                                   local_backend="ref", sparse=sparse)
        state = torch.zeros(Q, data.m_q)
    past = {}
    for t in range(1, ITERS + 1):
        comm = DelayRule(prog.schedule, {"data": P, "model": Q}, tau=tau,
                         t=t, past=past, device="cpu")
        state = prog.cell(comm, t, gdata, state)
        comm.finalize()
    w = state[1] if name == "d3ca" else state
    return data.w_from_blocks(w)


@pytest.mark.parametrize("name", ["d3ca", "radisa"])
@pytest.mark.parametrize("block_format", ["dense", "sparse"])
def test_async_tau2_follows_the_delay_rule(grid, name, block_format):
    got = _port(name, block_format, engine="async", staleness=2,
                backend="ref")[0]
    want = _emulate(name, block_format, tau=2)
    np.testing.assert_allclose(got.w, want, **TOL)


def test_async_tau2_converges(grid):
    """The thresholds of the reference's async contract
    (``tests/helpers/solver_equiv.py``, mode ``async``)."""
    X, y = make_problem(120, 42, seed=1)
    res = get_solver("d3ca")(engine="async", staleness=2, device="cpu").solve(
        "hinge", X, y, P=GRID[0], Q=GRID[1],
        cfg=D3CAConfig(lam=1.0, outer_iters=12))
    assert res.history[-1]["duality_gap"] < 0.5
    res = get_solver("radisa")(engine="async", staleness=2,
                               device="cpu").solve(
        "hinge", X, y, P=GRID[0], Q=GRID[1],
        cfg=RADiSAConfig(lam=1.0, gamma=0.01, outer_iters=12))
    f0 = float(get_loss("hinge").objective(torch.as_tensor(X),
                                           torch.as_tensor(y),
                                           torch.zeros(42), 1.0))
    assert res.history[-1]["objective"] < f0


# ---------------------------------------------------------------------------
# the comm policies on the mesh
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["d3ca", "radisa", "admm"])
def test_compression_on_the_mesh(grid, case):
    none = _port(case, "dense")[0]
    ident = _port(case, "dense", compression="identity")[0]
    assert _bitwise(none.w, ident.w)
    assert ident.comm_bytes["bytes_per_step"] == \
        none.comm_bytes["bytes_per_step"]
    mesh = _port(case, "dense", compression="int8")[0]
    flat = _port(case, "dense", engine="simulated", compression="int8")[0]
    assert mesh.comm_bytes == flat.comm_bytes
    # within two int8 quanta of the largest entry (one scale per cell)
    big = float(flat.w.abs().max())
    assert float((mesh.w - flat.w).abs().max()) <= 2 * big / 127


# ---------------------------------------------------------------------------
# the timed path
# ---------------------------------------------------------------------------

def _span_seq(tracer):
    return [(e["name"], e["depth"], (e.get("args") or {}).get("iter"))
            for e in tracer.events]


@pytest.mark.parametrize("engine,tau", [("shard_map", 0), ("async", 2),
                                        ("overlap", 2)])
def test_traced_mesh_solve(grid, engine, tau):
    """A traced, registered mesh solve: the reference's span sequence and
    registry keys (its mesh engines add ``async/ring_occupancy`` under
    staleness and ``solver/comm_exposed_s`` on overlap), bitwise the
    untraced solve."""
    X, y = _problem("dense")
    cfg = D3CAConfig(lam=0.05, seed=3, outer_iters=ITERS)
    solver = get_solver("d3ca")(engine=engine, staleness=tau, device="cpu",
                                index_source=CASES["d3ca"][3]())
    plain = solver.solve("hinge", X, y, P=GRID[0], Q=GRID[1], cfg=cfg)
    tr, reg = T.Tracer(), T.Registry()
    got = solver.solve("hinge", X, y, P=GRID[0], Q=GRID[1], cfg=cfg,
                       tracer=tr, registry=reg)
    assert _bitwise(got.w, plain.w) and _bitwise(got.alpha, plain.alpha)
    jtr, jreg = J.Tracer(), J.Registry()
    j_get_solver("d3ca")(engine="simulated").solve(
        "hinge", X, y, P=GRID[0], Q=GRID[1],
        cfg=JD3CA(lam=0.05, seed=3, outer_iters=ITERS), tracer=jtr,
        registry=jreg)
    assert _span_seq(tr) == _span_seq(jtr)
    lab = f"{{engine={engine},solver=d3ca}}"
    want = {kind: {k.replace("engine=simulated", f"engine={engine}")
                   for k in v} for kind, v in jreg.snapshot().items()}
    if tau:
        want["gauges"].add("async/ring_occupancy" + lab)
    if engine == "overlap":
        want["histograms"].add("solver/comm_exposed_s" + lab)
    snap = reg.snapshot()
    assert {kind: set(v) for kind, v in snap.items()} == want
    assert snap["counters"]["solver/iters" + lab] == ITERS
    if tau:
        assert snap["gauges"]["async/ring_occupancy" + lab] == 1.0
    for h in got.history:
        assert h["local_s"] + h["comm_s"] <= h["step_s"] + 1e-12
        if engine == "overlap":
            assert h["comm_exposed_s"] + h["comm_hidden_s"] == \
                pytest.approx(h["comm_s"])

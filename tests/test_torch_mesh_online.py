"""The online service and scoring on the mesh engines, on a CPU process
grid of 2 x 2 ranks over gloo (and the 1 x 1 grid last).

  * ``LinearScorer(w, mesh=grid)`` -- request rows split over the "data"
    axis, w over the "model" axis, one all-reduce over each row of the
    grid -- against ``X @ w`` and the reference's single-device scorer,
    with B % P != 0, m % Q != 0 and the logistic link (the reference's
    ``tests/test_serve.py::test_linear_scorer_on_grid_mesh`` case); its
    weight blocks resident on the ranks across solver sessions; a scoring
    thread beside the service's updates, every margin vector one
    published version's;
  * ``OnlineSolverService(config, mesh=grid)`` under every engine the
    reference offers (``shard_map``, ``sync``, ``async``, ``overlap``)
    against the same service on the grid engine (1e-5: gloo's reductions
    against a blocked sum) with the duals outside each batch frozen
    bitwise, and against the reference's service on one stream with its
    ``jax.random`` orders injected (1e-5);
  * the online CLI's ``--engine`` / ``--force-host-devices``.
"""
import sys
import threading

import numpy as np
import pytest
import torch

from repro.core import D3CAConfig as JD3CA
from repro.online import OnlineConfig as JOnlineConfig
from repro.online import OnlineSolverService as JService
from repro.serve.scoring import LinearScorer as JScorer
from repro_torch.core import D3CAConfig, get_solver
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch import online as online_cli
from repro_torch.launch.mesh import close_grids, process_grid
from repro_torch.online import OnlineConfig, OnlineSolverService
from repro_torch.serve.scoring import LinearScorer, make_score_fn
from test_torch_common import (MESH_GRID_TIMEOUT, bounded,  # noqa: F401
                               d3ca_source, make_problem)

P, Q = 2, 2
TOL = dict(rtol=1e-5, atol=1e-5)
LAM = 0.1

pytestmark = pytest.mark.usefixtures("bounded")


@pytest.fixture(scope="module")
def grid():
    g = process_grid(P, Q, device="cpu", timeout=MESH_GRID_TIMEOUT)
    yield g
    close_grids()


def _stream(rng, b, m):
    X = rng.normal(size=(b, m)).astype(np.float32)
    y = np.where(X @ np.linspace(-1.0, 1.0, m) >= 0, 1.0,
                 -1.0).astype(np.float32)
    return X, y


# ---------------------------------------------------------------------------
# the grid scorer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,m", [(23, 37), (8, 10), (1, 5)])
@pytest.mark.parametrize("loss", ["hinge", "logistic"])
def test_grid_scorer_matches_dense_and_reference(grid, loss, B, m):
    rng = np.random.default_rng(B * m)
    w = rng.normal(size=m).astype(np.float32)
    X = rng.normal(size=(B, m)).astype(np.float32)
    sc = LinearScorer(w, grid, loss=loss, device="cpu")
    ref = JScorer(w, None, loss=loss)
    assert sc.bucket is None and sc.P == P and sc.Q == Q
    got = sc.score(X)
    assert got.shape == (B,) and got.dtype == np.float32
    np.testing.assert_allclose(got, X @ w, **TOL)
    np.testing.assert_allclose(got, ref.score(X), **TOL)
    np.testing.assert_allclose(sc.predict(X), ref.predict(X), **TOL)
    assert sc.rows_scored == 2 * B and sc.rows_per_sec > 0
    w2 = rng.normal(size=m).astype(np.float32)
    sc.update_weights(w2, version=4)
    np.testing.assert_allclose(sc.score(X), X @ w2, **TOL)
    assert sc.w_version == 4 and torch.equal(sc.w, torch.from_numpy(w2))
    with pytest.raises(ValueError):
        sc.update_weights(np.zeros(m + 1, np.float32))
    with pytest.raises(ValueError):
        sc.score(np.zeros((3, m + 1), np.float32))


def test_make_score_fn_on_the_grid(grid):
    rng = np.random.default_rng(0)
    X = torch.from_numpy(rng.normal(size=(6, 8)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=8).astype(np.float32))
    fn = make_score_fn(grid)
    np.testing.assert_allclose(fn(X, w), X @ w, **TOL)
    with pytest.raises(ValueError, match="pad B"):
        fn(X[:5], w)
    with pytest.raises(ValueError, match="'data' and 'model'"):
        make_score_fn(grid, data_axis="rows")


def test_grid_scorer_refuses_what_is_not_its_grid(grid):
    with pytest.raises(TypeError, match="ProcessGrid"):
        LinearScorer(np.zeros(4, np.float32), object(), device="cpu")
    with pytest.raises(TypeError, match="ProcessGrid"):
        OnlineSolverService(OnlineConfig(m=4, engine="shard_map"),
                            mesh=object(), device="cpu")


def test_resident_weights_outlive_solver_sessions(grid):
    """A scorer's blocks stay on the ranks while a mesh solve opens and
    closes its session, and a second scorer on the grid keeps its own."""
    rng = np.random.default_rng(3)
    w = rng.normal(size=12).astype(np.float32)
    X = rng.normal(size=(9, 12)).astype(np.float32)
    sc = LinearScorer(w, grid, device="cpu")
    Xs, ys = make_problem(40, 12, seed=1)
    get_solver("d3ca")(engine="shard_map", device="cpu").solve(
        "hinge", Xs, ys, mesh=grid, cfg=D3CAConfig(lam=LAM, outer_iters=2))
    assert sc._key in grid.ctx.resident
    np.testing.assert_allclose(sc.score(X), X @ w, **TOL)
    other = LinearScorer(-w, grid, device="cpu")
    assert other._key != sc._key
    np.testing.assert_allclose(sc.score(X), X @ w, **TOL)
    np.testing.assert_allclose(other.score(X), -(X @ w), **TOL)


# ---------------------------------------------------------------------------
# the service on the mesh
# ---------------------------------------------------------------------------

def _run_service(cfg_kw, rounds=4, seed=0, **svc_kw):
    cfg = OnlineConfig(m=8, capacity=24, P=P, Q=Q, passes=2,
                       solver_cfg=D3CAConfig(lam=LAM), **cfg_kw)
    svc = OnlineSolverService(cfg, device="cpu", **svc_kw)
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(rounds):
        svc.submit(*_stream(rng, 7, 8))
        svc.run_pending()
        snap = svc.book.current()
        out.append((snap.w, snap.alpha, svc.score(_stream(rng, 5, 8)[0])))
    return svc, out


@pytest.mark.parametrize("engine", ["shard_map", "sync", "async", "overlap"])
def test_service_on_the_mesh_matches_the_grid_engine(grid, engine):
    svc, got = _run_service({"engine": engine}, mesh=grid)
    _, want = _run_service({})
    assert svc.scorer.mesh is grid and svc.solver.engine == (
        "shard_map" if engine == "sync" else engine)
    prev = torch.zeros(24)
    for r, ((w, a, s), (w0, a0, s0)) in enumerate(zip(got, want)):
        np.testing.assert_allclose(w, w0, **TOL)
        np.testing.assert_allclose(a, a0, **TOL)
        np.testing.assert_allclose(s, s0, **TOL)
        # the rows outside round r's batch of 7 keep their dual bit for bit
        batch = {(7 * r + i) % 24 for i in range(7)}
        out = [i for i in range(24) if i not in batch]
        assert torch.equal(a[out], prev[out])
        prev = a
    assert svc.stats()["version"] == 4 and svc.version_lag == 0


def test_service_on_the_mesh_matches_reference_over_a_stream(grid):
    """The service on the mesh and the reference's (grid engine, its
    orders injected) on one stream that wraps the ring twice."""
    m, cap = 12, 36
    kw = dict(m=m, capacity=cap, P=P, Q=Q, passes=2)
    svc = OnlineSolverService(
        OnlineConfig(**kw, engine="shard_map",
                     solver_cfg=D3CAConfig(lam=LAM, local_steps=8)),
        mesh=grid, device="cpu",
        index_source=d3ca_source(0, cap, iters=2, steps=8, grid=(P, Q)))
    ref = JService(JOnlineConfig(**kw, solver_cfg=JD3CA(lam=LAM,
                                                        local_steps=8)))
    rng = np.random.default_rng(5)
    for b in (5, 8, 3, 12, 7, 9, 4, 20):
        X, y = _stream(rng, b, m)
        assert svc.submit(X, y) == ref.submit(X, y)
        assert svc.run_pending() == ref.run_pending()
        s, r = svc.book.current(), ref.book.current()
        assert (s.version, s.trained_seq) == (r.version, r.trained_seq)
        np.testing.assert_allclose(s.w.numpy(), r.w, **TOL)
        np.testing.assert_allclose(s.alpha.numpy(), r.alpha, **TOL)
    Xs, _ = _stream(rng, 70, m)
    np.testing.assert_allclose(svc.score(Xs), ref.score(Xs), **TOL)


def test_scoring_threads_beside_updates(grid, monkeypatch):
    """Three threads score one batch over and over, with a short switch
    interval, while the service runs its updates on the same grid:
    nothing deadlocks, scores run inside the updates' sessions (between
    two of their commands), and every margin vector is X @ w of one
    published version (never a mix of two)."""
    inside = []
    real = mesh_mod.MeshSession.call

    def call(self, fn, leaves=(), **kw):
        inside.append(not self.idle)
        return real(self, fn, leaves, **kw)
    monkeypatch.setattr(mesh_mod.MeshSession, "call", call)
    cfg = OnlineConfig(m=8, capacity=24, P=P, Q=Q, engine="shard_map",
                       solver_cfg=D3CAConfig(lam=LAM))
    svc = OnlineSolverService(cfg, mesh=grid, device="cpu")
    rng = np.random.default_rng(9)
    X = rng.normal(size=(6, 8)).astype(np.float32)
    scores, errors, done = [], [], threading.Event()

    def score_loop():
        try:
            while not done.is_set():
                scores.append(svc.score(X))
        except Exception as e:      # noqa: BLE001 -- reported below
            errors.append(e)
    versions = [svc.book.current().w.clone()]
    threads = [threading.Thread(target=score_loop) for _ in range(3)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for thread in threads:
            thread.start()
        for _ in range(4):
            svc.submit(*_stream(rng, 6, 8))
            svc.run_pending()
            versions.append(svc.book.current().w.clone())
    finally:
        done.set()
        for thread in threads:
            thread.join(timeout=MESH_GRID_TIMEOUT)
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads) and not errors
    assert len(scores) >= 1 and any(inside)
    want = [X @ v.numpy() for v in versions]
    for s in scores:
        assert any(np.allclose(s, w, **TOL) for w in want)


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

SMALL = ["--m", "16", "--capacity", "40", "--mesh", "2x2", "--batch", "12",
         "--score-batch", "32", "--device", "cpu", "--rounds", "3"]


@pytest.mark.parametrize("engine", ["shard_map", "overlap"])
def test_online_cli_on_the_mesh(grid, engine):
    plain = online_cli.main(SMALL)
    got = online_cli.main([*SMALL, "--engine", engine,
                           "--force-host-devices", "4"])
    assert got["engine"] == engine and got["version"] == 3
    np.testing.assert_allclose(got["objective"], plain["objective"],
                               rtol=1e-5)
    assert got["rows_scored"] == plain["rows_scored"]


@pytest.mark.parametrize("flags,text", [
    (["--engine", "shard_map", "--force-host-devices", "3"],
     "needs 4 ranks"),
    (["--engine", "mesh"], "invalid choice"),
    (["--engine", "sync", "--staleness", "1"],
     "--staleness 1 only works with --engine async"),
])
def test_online_cli_mesh_refusals(flags, text, capsys):
    with pytest.raises(SystemExit) as exc:
        online_cli.main([*SMALL, *flags])
    assert exc.value.code == 2
    assert text in capsys.readouterr().err


# ---------------------------------------------------------------------------
# one rank: the 1 x 1 grid (closes the 2 x 2 one; the last tests here)
# ---------------------------------------------------------------------------

def test_grid_scorer_on_one_rank():
    """The reference's ``test_linear_scorer_on_grid_mesh`` case on a 1 x 1
    process grid."""
    close_grids()
    one = process_grid(1, 1, device="cpu", timeout=MESH_GRID_TIMEOUT)
    rng = np.random.default_rng(1)
    w = rng.normal(size=10).astype(np.float32)
    X = rng.normal(size=(5, 10)).astype(np.float32)
    sc = LinearScorer(w, mesh=one, loss="logistic", device="cpu")
    np.testing.assert_allclose(sc.score(X), X @ w, **TOL)
    np.testing.assert_allclose(sc.predict(X), 1 / (1 + np.exp(-(X @ w))),
                               **TOL)


def test_service_on_one_rank():
    one = process_grid(1, 1, device="cpu", timeout=MESH_GRID_TIMEOUT)
    cfg = dict(m=8, capacity=24, P=1, Q=1, solver_cfg=D3CAConfig(lam=LAM))
    runs = []
    for extra, mesh in (({}, None), ({"engine": "shard_map"}, one)):
        svc = OnlineSolverService(OnlineConfig(**cfg, **extra), mesh=mesh,
                                  device="cpu")
        rng = np.random.default_rng(2)
        for _ in range(3):
            svc.submit(*_stream(rng, 5, 8))
            svc.run_pending()
        runs.append(svc.book.current().w)
    np.testing.assert_allclose(runs[1], runs[0], **TOL)
    close_grids()

"""The mesh engines on a CPU process grid of 4 x 2 ranks over gloo: the
pod topology, the CLI's ``--engine`` / ``--staleness`` /
``--force-host-devices``, and the grid's failure rules.

``topology="pods=2:identity"`` is held within 1e-5 of the flat mesh
solve, ``pods=2:int8`` within two int8 quanta of the grid engine's, and
their wire accounting equal to the grid engine's; a rank that fails
fails the solve with its traceback, promptly, and the next solve starts
a fresh grid.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import (ADMMConfig, D3CAConfig, RADiSAConfig,
                              get_solver)
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch import optimize
from repro_torch.launch.mesh import GridError, close_grids, process_grid
from test_torch_common import (MESH_GRID_TIMEOUT, bounded,  # noqa: F401
                               make_problem)
from test_torch_mesh_hooks import fail_on_rank_3, report_rank

GRID = (4, 2)
TOL = dict(rtol=1e-5, atol=1e-5)
SMALL = ["--mesh", "4x2", "--n", "120", "--m", "40", "--iters", "3",
         "--device", "cpu", "--ref-epochs", "10"]

pytestmark = pytest.mark.usefixtures("bounded")


@pytest.fixture(scope="module")
def grid():
    g = process_grid(*GRID, device="cpu", timeout=MESH_GRID_TIMEOUT)
    yield g
    close_grids()


CFGS = {"d3ca": D3CAConfig(lam=0.05, seed=3, outer_iters=3),
        "radisa": RADiSAConfig(lam=0.05, gamma=0.05, seed=3, outer_iters=3),
        "admm": ADMMConfig(lam=0.05, rho=0.05, outer_iters=3)}


def _solve(name, engine="shard_map", **kw):
    X, y = make_problem(120, 37, seed=2)
    return get_solver(name)(engine=engine, device="cpu", **kw).solve(
        "hinge", X, y, P=GRID[0], Q=GRID[1], cfg=CFGS[name])


# ---------------------------------------------------------------------------
# the pod topology
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["d3ca", "radisa", "admm"])
def test_pods_identity_is_flat_within_1e5(grid, name):
    flat = _solve(name)
    pods = _solve(name, topology="pods=2:identity")
    np.testing.assert_allclose(pods.w, flat.w, **TOL)
    assert pods.topology == "pods=2:identity:ring"
    assert pods.comm_bytes == _solve(name, engine="simulated",
                                     topology="pods=2:identity").comm_bytes


@pytest.mark.parametrize("name", ["d3ca", "radisa"])
def test_pods_int8_on_the_mesh_as_on_the_grid(grid, name):
    mesh = _solve(name, topology="pods=2:int8")
    flat = _solve(name, engine="simulated", topology="pods=2:int8")
    assert mesh.comm_bytes == flat.comm_bytes
    assert mesh.comm_bytes["inter_bytes_per_step"] > 0
    big = float(flat.w.abs().max())
    assert float((mesh.w - flat.w).abs().max()) <= 2 * big / 127


def test_pod_residuals_gathered_as_the_grid_keeps_them(grid):
    """The registry's error-feedback norms of a mesh solve under int8 and
    pods=2:int8 read the residuals every rank holds, assembled in the
    grid engine's layout (policy ``(P, Q, *cell)``, pod ``(G, Q,
    *cell)``)."""
    from repro_torch.obs import Registry
    X, y = make_problem(120, 37, seed=2)
    snaps = {}
    for engine in ("simulated", "shard_map"):
        reg = Registry()
        get_solver("d3ca")(engine=engine, device="cpu", compression="int8",
                           topology="pods=2:int8").solve(
            "hinge", X, y, P=GRID[0], Q=GRID[1], cfg=CFGS["d3ca"],
            registry=reg)
        snaps[engine] = {k.split("{")[0]: v
                         for k, v in reg.snapshot()["gauges"].items()
                         if k.startswith("compress/ef_norm/")}
    assert set(snaps["shard_map"]) == set(snaps["simulated"]) == {
        "compress/ef_norm/dalpha", "compress/ef_norm/w_contrib",
        "compress/ef_norm/pod:w_contrib"}
    for k, v in snaps["shard_map"].items():
        np.testing.assert_allclose(v, snaps["simulated"][k], rtol=1e-5)


def test_overlap_with_pods_int8_converges(grid):
    """The reference's overlap contract (``solver_equiv.py``): tau = 2
    under pods=2:int8 still closes the duality gap."""
    X, y = make_problem(120, 42, seed=1)
    res = get_solver("d3ca")(engine="overlap", staleness=2, device="cpu",
                             topology="pods=2:int8").solve(
        "hinge", X, y, P=GRID[0], Q=GRID[1],
        cfg=D3CAConfig(lam=1.0, outer_iters=12))
    assert res.history[-1]["duality_gap"] < 0.5


def test_a_topology_the_grid_cannot_split_is_refused(grid):
    with pytest.raises(ValueError, match="must divide P=4"):
        _solve("d3ca", topology="pods=3")


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("engine,tau", [("shard_map", 0), ("sync", 0),
                                        ("async", 2), ("overlap", 2)])
def test_cli_runs_the_mesh_engines(grid, engine, tau, capsys):
    flags = ["--engine", engine, *SMALL]
    if tau:
        flags += ["--staleness", str(tau)]
    got = optimize.main(flags)
    assert got["engine"] == ("shard_map" if engine == "sync" else engine)
    assert (got["staleness"], got["P"], got["Q"], got["iters"]) == (
        tau, 4, 2, 3)
    header = capsys.readouterr().out.splitlines()[0]
    assert f"engine={got['engine']}" in header
    assert ("staleness=2" in header) == (engine in ("async", "overlap"))
    plain = optimize.main(SMALL)
    assert got["comm_bytes_per_step"] == plain["comm_bytes_per_step"]
    if not tau:
        np.testing.assert_allclose(got["objective"], plain["objective"],
                                   **TOL)
    else:
        assert np.isfinite(got["objective"])


def test_cli_overlap_reports_the_hidden_and_exposed_comm(grid, capsys):
    got = optimize.main(["--engine", "overlap", "--staleness", "2",
                         "--metrics", *SMALL])
    out = capsys.readouterr().out
    phases = [ln for ln in out.splitlines() if "[optimize] phases:" in ln]
    assert len(phases) == 1 and "(comm exposed" in phases[0]
    assert "async/ring_occupancy{engine=overlap,solver=d3ca}" in \
        got["metrics"]["gauges"]


def test_cli_force_host_devices(grid, capsys):
    got = optimize.main(["--engine", "shard_map", "--force-host-devices",
                         "8", *SMALL])
    assert got["engine"] == "shard_map"
    for flags, text in (
            (["--engine", "shard_map", "--force-host-devices", "6"],
             "needs 8 ranks"),
            (["--force-host-devices", "8", "--device", "cuda"],
             "needs --device cpu")):
        with pytest.raises(SystemExit) as exc:
            optimize.main([*SMALL, *flags])
        assert exc.value.code == 2
        assert text in capsys.readouterr().err


@pytest.mark.parametrize("flags,text", [
    (["--staleness", "-1", "--engine", "async"], "is negative"),
    (["--staleness", "2", "--engine", "shard_map"],
     "--staleness 2 only works with --engine async"),
    (["--staleness", "2", "--engine", "sync"],
     "--staleness 2 only works with --engine async"),
    (["--engine", "mesh"], "invalid choice"),
    # the fleet fan-out on the mesh, once refused, runs
    pytest.param(["--problems", "3", "--engine", "shard_map"], None,
                 id="flags4-'Multi-device engines'"),
    (["--problems", "3", "--engine", "async"], "engine='async'"),
])
def test_cli_refusals_keep_the_reference_text(flags, text, capsys):
    if text is None:
        # one batched fleet solve of the 3 instances on the 4 x 2 grid,
        # each within 1e-6 (relative) of the grid engine's fan-out
        got = optimize.main([*SMALL, *flags])
        plain = optimize.main([*SMALL, "--problems", "3"])
        assert got["engine"] == "shard_map" and got["problems"] == 3
        np.testing.assert_allclose(
            [r["objective"] for r in got["results"]],
            [r["objective"] for r in plain["results"]], rtol=1e-6)
        return
    with pytest.raises(SystemExit) as exc:
        optimize.main([*SMALL, *flags])
    assert exc.value.code == 2
    assert text in capsys.readouterr().err


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="checks the refusal on a machine without a card")
@pytest.mark.parametrize("engine", ["shard_map", "async", "overlap"])
def test_cli_mesh_without_a_card_raises_before_any_rank_starts(engine):
    close_grids()
    argv = [a for a in SMALL if a not in ("--device", "cpu")]
    with pytest.raises(RuntimeError, match="--device cpu"):
        optimize.main(["--engine", engine, *argv])
    with pytest.raises(RuntimeError, match="--device cpu"):
        get_solver("radisa")(engine=engine)
    assert not mesh_mod._GRIDS


# ---------------------------------------------------------------------------
# failures
# ---------------------------------------------------------------------------

def test_rank_hook_reports_from_every_rank():
    g = process_grid(*GRID, device="cpu", timeout=MESH_GRID_TIMEOUT)
    g.rank_hook = report_rank
    try:
        _solve("radisa")
    finally:
        g.rank_hook = None
    assert g.reports == {r: {"rank": r} for r in range(8)}


def test_a_failing_rank_fails_the_solve_with_its_traceback():
    g = process_grid(*GRID, device="cpu", timeout=MESH_GRID_TIMEOUT)
    g.rank_hook = fail_on_rank_3
    with pytest.raises(GridError, match="rank 3 was told to fail"):
        _solve("d3ca")
    assert g.closed and not mesh_mod._GRIDS
    # the next solve starts a fresh grid
    again = process_grid(*GRID, device="cpu", timeout=MESH_GRID_TIMEOUT)
    assert again is not g and again.rank_hook is None
    np.testing.assert_allclose(_solve("d3ca").w,
                               _solve("d3ca", engine="simulated").w, **TOL)


def test_a_failure_in_the_callers_code_leaves_the_grid_usable():
    """The ranks wait for the next command; the next solve ends the
    session left open and runs on the same ranks."""
    g = process_grid(*GRID, device="cpu", timeout=MESH_GRID_TIMEOUT)
    X, y = make_problem(120, 37, seed=2)

    def boom(t, w, alpha):
        raise ValueError("the callback failed")
    with pytest.raises(ValueError, match="the callback failed"):
        get_solver("d3ca")(engine="shard_map", device="cpu").solve(
            "hinge", X, y, P=GRID[0], Q=GRID[1], cfg=CFGS["d3ca"],
            callback=boom)
    assert not g.closed
    np.testing.assert_allclose(_solve("d3ca").w,
                               _solve("d3ca", engine="simulated").w, **TOL)
    assert process_grid(*GRID, device="cpu") is g

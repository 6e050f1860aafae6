"""The fleet on the mesh engine: ``FleetSolver(engine="shard_map" |
"sync")`` on a CPU process grid of 2 x 2 ranks over gloo (and one case on
1 x 1), one block of every tenant per rank.

Every tenant is held to:

  * the reference's solo ``engine="simulated"`` solve of the same problem
    with its ``jax.random`` orders injected through the tenant's
    ``index_source`` (1e-5, float32), and on the reference's dense grid
    cases its ``FleetSolver(engine="simulated")``;
  * the port's grid-engine fleet and the port's solo mesh solve of the
    tenant (1e-6 relative to the largest entry);
  * the reference's mesh-fleet contract (docs/consistency.md, "Mesh engine
    (`shard_map`)"): bitwise its solo mesh solve on the sparse paths and
    on the piecewise-linear dense ones (hinge: D3CA, RADiSA, SFK), within
    1e-6 elsewhere (ADMM, whose factor is a Cholesky of a gram summed in
    another order).  Every reduction of a 2 x 2 grid sums two ranks'
    values, which gloo adds in either order to the same float, so the
    contract holds bitwise here; on a column of three or more ranks gloo
    may add the (T, n_p) fleet payload and the (n_p,) solo payload in
    different orders (its ring splits a payload by size), and there the
    fleet is held within 1e-6 (chip_smoke's 7 x 4 ``fleet_mesh_full``).

Also: converged tenants frozen exactly on the mesh, the ``active`` mask
sent to the ranks only when it changes (the grid's DATA command), the
scheduler's buckets and warm chains on the mesh, and the fleet and
optimizer CLIs' ``--engine shard_map`` / ``--force-host-devices``.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.fleet import FleetProblem as JFleetProblem
from repro.fleet import FleetSolver as JFleetSolver
from repro_torch.core import (ArrayIndexSource, D3CAConfig,
                              GeneratorIndexSource, get_solver, objective,
                              serial_sdca)
from repro_torch.core.indices import CellIndexSource, TenantIndexSource
from repro_torch.fleet import FleetScheduler, FleetSolver, solo_config
from repro_torch.launch import fleet as fleet_cli
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch import online as online_cli
from repro_torch.launch import optimize
from repro_torch.launch.mesh import close_grids, process_grid
from test_torch_common import MESH_GRID_TIMEOUT, bounded  # noqa: F401
from test_torch_fleet import (CFGS, FLEET_SMALL, GRID_CASES, SOLVERS, TOL,
                              make_problems, reference_solo, with_sources)

P, Q = 2, 2

pytestmark = pytest.mark.usefixtures("bounded")


@pytest.fixture(scope="module")
def grid():
    g = process_grid(P, Q, device="cpu", timeout=MESH_GRID_TIMEOUT)
    yield g
    close_grids()


def rel(a, b):
    """max |a - b| / max |b|."""
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def mesh_fleet(name, probs, grid, *, engine="shard_map", cfg=None, **kw):
    block_format = kw.pop("block_format", "dense")
    return FleetSolver(solver=name, engine=engine, block_format=block_format,
                       device="cpu", mesh=grid).solve_batch(
        probs, P=P, Q=Q, cfg=cfg or CFGS[name][0], record_history=False,
        **kw)


def solo_mesh(name, p, grid, cfg, block_format="dense", **kw):
    return get_solver(name)(engine="shard_map", block_format=block_format,
                            device="cpu", index_source=p.index_source).solve(
        p.loss_name, p.X, p.y, mesh=grid, cfg=solo_config(cfg, p),
        record_history=False, **kw)


# ---------------------------------------------------------------------------
# the tenants against the reference, the grid-engine fleet and solo meshes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("engine", ["shard_map", "sync"])
@pytest.mark.parametrize("block_format", ["dense", "sparse"])
@pytest.mark.parametrize("name", SOLVERS)
def test_mesh_fleet_tenant_matches_reference_solo(grid, name, block_format,
                                                  engine):
    cfg = CFGS[name][0]
    probs = with_sources(name, cfg,
                         make_problems(sparse=block_format == "sparse"))
    batch = mesh_fleet(name, probs, grid, engine=engine,
                       block_format=block_format)
    for res, (w_j, a_j) in zip(batch, reference_solo(name, block_format)):
        np.testing.assert_allclose(res.w.numpy(), w_j, **TOL)
        if a_j is not None:
            np.testing.assert_allclose(res.alpha.numpy(), a_j, **TOL)
        assert (res.solver, res.engine, res.block_format, res.device) == (
            name, "shard_map", block_format, "cpu")


@pytest.mark.parametrize("name,loss,backend", GRID_CASES,
                         ids=[f"{c[0]}-{c[1]}-dense-{c[2]}"
                              for c in GRID_CASES])
def test_mesh_fleet_matches_reference_fleet(grid, name, loss, backend):
    """The reference's ``FleetSolver(engine="simulated")`` on its dense
    grid cases, its streams injected into the port's tenants."""
    cfg, jcfg = CFGS[name]
    probs = with_sources(name, cfg, make_problems(loss))
    jprobs = [JFleetProblem(tenant_id=p.tenant_id, loss_name=loss, X=p.X,
                            y=p.y, lam=p.lam, seed=p.seed) for p in probs]
    want = JFleetSolver(solver=name, local_backend=backend).solve_batch(
        jprobs, P=P, Q=Q, cfg=jcfg, record_history=False)
    got = FleetSolver(solver=name, engine="shard_map", device="cpu",
                      mesh=grid,
                      local_backend="ref" if backend == "ref" else "kernel"
                      ).solve_batch(probs, P=P, Q=Q, cfg=cfg,
                                    record_history=False)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.w.numpy(), np.asarray(w.w), **TOL)
        if w.alpha is not None:
            np.testing.assert_allclose(g.alpha.numpy(), np.asarray(w.alpha),
                                       **TOL)


#: (solver, block format) pairs the reference's contract holds bitwise
BITWISE = {("d3ca", "sparse"), ("radisa", "sparse"), ("sfk", "sparse"),
           ("d3ca", "dense"), ("radisa", "dense"), ("sfk", "dense")}


@pytest.mark.parametrize("block_format", ["dense", "sparse"])
@pytest.mark.parametrize("name", SOLVERS)
def test_mesh_fleet_matches_grid_fleet_and_solo_mesh(grid, name,
                                                     block_format):
    """Default sources (every tenant's generator seeded by its own seed)
    on every side; lam * n a power of two for every tenant."""
    cfg = CFGS[name][0]
    probs = make_problems(sparse=block_format == "sparse")
    batch = mesh_fleet(name, probs, grid, block_format=block_format)
    flat = FleetSolver(solver=name, block_format=block_format,
                       device="cpu").solve_batch(probs, P=P, Q=Q, cfg=cfg,
                                                 record_history=False)
    for p, res, f in zip(probs, batch, flat):
        solo = solo_mesh(name, p, grid, cfg, block_format)
        for field in ("w", "alpha"):
            got = getattr(res, field)
            if got is None:
                continue
            assert rel(got, getattr(f, field)) <= 1e-6
            assert rel(got, getattr(solo, field)) <= 1e-6
            if (name, block_format) in BITWISE:
                assert torch.equal(got, getattr(solo, field))


def test_admm_factors_are_made_per_tenant_on_the_ranks(grid):
    """ADMM's normal matrices on the mesh are factored on the ranks with
    each tenant's own lam: two tenants of one problem at lams a factor 4
    apart converge to different w, each its solo mesh solve's."""
    p0 = make_problems(lams=(1.0,))[0]
    probs = [p0, dataclasses.replace(p0, tenant_id="t1", lam=0.25)]
    cfg = CFGS["admm"][0]
    batch = mesh_fleet("admm", probs, grid)
    assert rel(batch[0].w, batch[1].w) > 1e-2
    for p, res in zip(probs, batch):
        assert rel(res.w, solo_mesh("admm", p, grid, cfg).w) <= 1e-6


# ---------------------------------------------------------------------------
# freezing, and the DATA command behind it
# ---------------------------------------------------------------------------

def test_mesh_frozen_tenant_state_is_exact(grid, monkeypatch):
    """A tenant frozen at iteration k bit-equals its solo mesh solve
    truncated at k; the ranks get the ``active`` mask once per change."""
    probs = make_problems()
    f_stars = []
    for p in probs:
        w_ref, _ = serial_sdca("hinge", p.X, p.y, lam=p.lam, epochs=200,
                               device="cpu")
        f_stars.append(float(objective("hinge", torch.from_numpy(p.X),
                                       torch.from_numpy(p.y), w_ref, p.lam)))
    probs = make_problems(f_stars=f_stars)
    cfg = D3CAConfig(local_steps=16, outer_iters=30)
    puts = []
    real = mesh_mod.MeshSession.put

    def put(self, leaf, value, spec):
        puts.append(value.clone())
        return real(self, leaf, value, spec)
    monkeypatch.setattr(mesh_mod.MeshSession, "put", put)
    batch = mesh_fleet("d3ca", probs, grid, cfg=cfg, tol=0.05,
                       check_every=2)
    assert any(r.converged for r in batch)
    for p, res in zip(probs, batch):
        if not res.converged:
            continue
        solo = solo_mesh("d3ca", p, grid, dataclasses.replace(
            cfg, outer_iters=res.iters))
        assert torch.equal(res.w, solo.w)
        assert torch.equal(res.alpha, solo.alpha)
    # one DATA command per change of the mask while the batch still steps
    # (a change at the last segment boundary is never sent)
    masks = [tuple(m.tolist()) for m in puts]
    last = max(r.iters for r in batch)
    stops = {r.iters for r in batch if r.converged and r.iters < last}
    assert len(masks) == len(set(masks)) == len(stops) >= 1
    for m, k in zip(masks, sorted(stops)):
        assert m == tuple(0.0 if r.converged and r.iters <= k else 1.0
                          for r in batch)


def test_set_data_replaces_a_leaf_on_every_rank(grid):
    """``EngineProgram.set_data`` by name: a step after it equals the grid
    engine's step on the new data (here, the mask freezing tenant 1)."""
    probs = make_problems()
    cfg = CFGS["d3ca"][0]
    mesh = FleetSolver(engine="shard_map", device="cpu", mesh=grid).program(
        probs, P=P, Q=Q, cfg=cfg)
    flat = FleetSolver(device="cpu").program(probs, P=P, Q=Q, cfg=cfg)
    ones, frozen = torch.ones(3), torch.tensor([1.0, 0.0, 1.0])
    ms, fs = mesh.step(1, ones, mesh.state), flat.step(1, ones, flat.state)
    ms, fs = mesh.step(2, frozen, ms), flat.step(2, frozen, fs)
    (mw, ma), (fw, fa) = mesh.unpack(ms), flat.unpack(fs)
    mesh.close()
    for a, b in zip(mw + ma, fw + fa):
        assert torch.equal(a, b)


def test_tenant_streams_cut_to_a_cell():
    """A rank's view of the tenants' streams is cell (p, q) of the grid
    fleet's, every tenant at once."""
    srcs = [GeneratorIndexSource(s, P=3, Q=2, n_p=5, steps=4, L=6,
                                 device="cpu") for s in (0, 1)]
    arr = ArrayIndexSource(sdca={1: np.arange(12).reshape(3, 4)},
                           device="cpu")
    whole = TenantIndexSource(srcs)
    for p, q in ((0, 0), (2, 1)):
        cell = CellIndexSource(whole, p, q, device="cpu")
        assert torch.equal(cell.sdca_rows(1), whole.sdca_rows(1)[p:p + 1])
        assert torch.equal(cell.svrg_rows(2),
                           whole.svrg_rows(2)[p:p + 1, q:q + 1])
        assert torch.equal(cell.radisa_perm(3),
                           whole.radisa_perm(3)[p:p + 1])
        assert torch.equal(cell.sfk_sample(1), whole.sfk_sample(1)[p:p + 1])
    moved = TenantIndexSource([arr]).to("cpu")
    assert torch.equal(moved.sdca_rows(1)[:, 0], torch.arange(12).reshape(
        3, 4).int())


# ---------------------------------------------------------------------------
# the scheduler on the mesh
# ---------------------------------------------------------------------------

def test_mesh_scheduler_buckets_and_warm_chain(grid):
    """Two shape buckets and a second, warm-started round on the mesh:
    every result bitwise its solo mesh solve (chain)."""
    cfg = CFGS["d3ca"][0]
    small = make_problems(n=64)
    big = [dataclasses.replace(p, tenant_id=f"big{i}")
           for i, p in enumerate(make_problems(n=128, lams=(0.5, 0.25)))]
    sched = FleetScheduler(P=P, Q=Q, solver="d3ca", engine="sync", cfg=cfg,
                           device="cpu")
    for p in small + big:
        sched.submit(p)
    assert [len(v) for v in sched.buckets().values()] == [3, 2]
    first = sched.run()
    assert list(first) == ["t0", "t1", "t2", "big0", "big1"]
    for p in small + big:
        assert first[p.tenant_id].engine == "shard_map"
        assert torch.equal(first[p.tenant_id].w,
                           solo_mesh("d3ca", p, grid, cfg).w)
    for p in small:
        sched.submit(p)
    again = sched.run()
    for p in small:
        assert sched.warm_start_of(p.tenant_id) is again[p.tenant_id]
        chain = solo_mesh("d3ca", p, grid, cfg,
                          warm_start=first[p.tenant_id])
        assert torch.equal(again[p.tenant_id].w, chain.w)


# ---------------------------------------------------------------------------
# the CLIs
# ---------------------------------------------------------------------------

def test_fleet_cli_on_the_mesh(grid):
    argv = [*FLEET_SMALL, "--device", "cpu", "--rounds", "2",
            "--shape-mix"]
    plain = fleet_cli.main(argv)
    got = fleet_cli.main([*argv, "--engine", "sync",
                          "--force-host-devices", "4"])
    assert (got["engine"], got["buckets"]) == ("shard_map", 2)
    np.testing.assert_allclose([r["objective"] for r in got["results"]],
                               [r["objective"] for r in plain["results"]],
                               rtol=1e-6)


@pytest.mark.parametrize("flags,text", [
    (["--engine", "shard_map", "--force-host-devices", "3", "--device",
      "cpu"], "needs 4 ranks"),
    (["--force-host-devices", "4"], "needs --device cpu"),
    (["--engine", "async", "--device", "cpu"], "invalid choice"),
])
def test_fleet_cli_mesh_refusals(flags, text, capsys):
    with pytest.raises(SystemExit) as exc:
        fleet_cli.main([*FLEET_SMALL, *flags])
    assert exc.value.code == 2
    assert text in capsys.readouterr().err


def test_optimize_problems_on_the_mesh(grid):
    base = ["--problems", "3", "--solver", "radisa", "--mesh", "2x2",
            "--n", "64", "--m", "24", "--iters", "3", "--lam", "0.5",
            "--device", "cpu"]
    plain = optimize.main(base)
    got = optimize.main([*base, "--engine", "shard_map",
                         "--force-host-devices", "4"])
    assert got["engine"] == "shard_map" and got["problems"] == 3
    np.testing.assert_allclose([r["objective"] for r in got["results"]],
                               [r["objective"] for r in plain["results"]],
                               rtol=1e-6)


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="checks the refusal on a machine without a card")
def test_mesh_entry_points_need_the_card_or_the_cpu_by_name():
    """The mesh entry points default to the card and raise without one,
    before any rank starts."""
    with pytest.raises(RuntimeError, match="device='cpu'"):
        FleetSolver(engine="shard_map")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        process_grid(P, Q)
    with pytest.raises(RuntimeError, match="--device cpu"):
        fleet_cli.main([*FLEET_SMALL, "--engine", "shard_map"])
    with pytest.raises(RuntimeError, match="--device cpu"):
        online_cli.main(["--m", "8", "--capacity", "16", "--engine",
                         "shard_map", "--rounds", "1"])


# ---------------------------------------------------------------------------
# one rank: the 1 x 1 grid (closes the 2 x 2 one; the last test here)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["d3ca", "radisa", "admm"])
def test_mesh_fleet_on_one_rank(name):
    close_grids()
    one = process_grid(1, 1, device="cpu", timeout=MESH_GRID_TIMEOUT)
    cfg = CFGS[name][0]
    probs = make_problems()
    got = FleetSolver(solver=name, engine="shard_map", device="cpu",
                      mesh=one).solve_batch(probs, P=1, Q=1, cfg=cfg,
                                            record_history=False)
    flat = FleetSolver(solver=name, device="cpu").solve_batch(
        probs, P=1, Q=1, cfg=cfg, record_history=False)
    for g, f in zip(got, flat):
        assert rel(g.w, f.w) <= 1e-6
    with pytest.raises(ValueError, match="mesh is 1x1"):
        FleetSolver(engine="shard_map", device="cpu", mesh=one).solve_batch(
            probs, P=2, Q=2, cfg=cfg)
    close_grids()

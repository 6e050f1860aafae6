"""The port's multi-tenant fleet (CPU): every tenant of a fleet batch
against the reference's solo simulated solve of the same problem (its
per-tenant coordinate orders injected through ``ArrayIndexSource``), the
port's fleet against the reference's ``FleetSolver`` on the dense grid
cases, and the port's own contract (docs/consistency.md §10): a fleet
tenant bit-matches the port's solo solve when the per-tenant products
(``lam * n``, ``n * sample_frac``, ``rho * n``) are powers of two,
converged tenants freeze exactly, warm-start chains equal solo chains;
plus the scheduler, the knobs and the two CLIs."""
import dataclasses
import functools
import json

import numpy as np
import pytest
import torch

from repro.core import ADMMConfig as JADMM
from repro.core import D3CAConfig as JD3CA
from repro.core import RADiSAConfig as JRADiSA
from repro.core import SFKConfig as JSFK
from repro.core import get_solver as j_get_solver
from repro.fleet import FleetProblem as JFleetProblem
from repro.fleet import FleetSolver as JFleetSolver
from repro_torch import convert
from repro_torch.core import (ArrayIndexSource, D3CAConfig, RADiSAConfig,
                              SFKConfig, get_solver, objective, serial_sdca)
from repro_torch.core.admm import ADMMConfig
from repro_torch.fleet import (FleetProblem, FleetScheduler, FleetSolver,
                               bucket_key, named_axes, solo_config,
                               stack_grid)
from repro_torch.launch import fleet as fleet_cli
from repro_torch.launch import optimize
from repro_torch.obs import HealthMonitor, Registry, Tracer, fleet_rules
from repro_torch.launch.mesh import close_grids
from test_torch_common import (bounded, ceil_div, d3ca_rows,  # noqa: F401
                               radisa_streams, sfk_samples)

#: end-to-end iterates vs the reference, as the port's other solver tests
TOL = dict(rtol=1e-5, atol=1e-5)
P, Q = 2, 2
N, M = 64, 24
LAMS = (1.0, 0.5, 0.25)         # lam * n = 64 / 32 / 16: powers of two
ITERS = 3
CFGS = {
    "d3ca": (D3CAConfig(local_steps=8, outer_iters=ITERS),
             JD3CA(local_steps=8, outer_iters=ITERS)),
    "radisa": (RADiSAConfig(gamma=0.125, L=8, outer_iters=ITERS),
               JRADiSA(gamma=0.125, L=8, outer_iters=ITERS)),
    "sfk": (SFKConfig(gamma=0.125, L=8, sample_frac=0.5, outer_iters=ITERS),
            JSFK(gamma=0.125, L=8, sample_frac=0.5, outer_iters=ITERS)),
    "admm": (ADMMConfig(rho=0.5, outer_iters=ITERS),
             JADMM(rho=0.5, outer_iters=ITERS)),
}
SOLVERS = list(CFGS)


def tenant_data(i, n=N, m=M, sparse=False):
    rng = np.random.default_rng(10 + i)
    X = rng.uniform(-1, 1, size=(n, m)).astype(np.float32)
    y = np.sign(X @ rng.uniform(-1, 1, size=m)).astype(np.float32)
    y[y == 0] = 1.0
    if sparse:
        X = X * (rng.random(X.shape) < 0.3)
    return X, y


def make_problems(loss="hinge", n=N, m=M, lams=LAMS, sparse=False,
                  f_stars=None):
    probs = []
    for i, lam in enumerate(lams):
        X, y = tenant_data(i, n, m, sparse)
        probs.append(FleetProblem(
            tenant_id=f"t{i}", loss_name=loss, X=X, y=y, lam=lam, seed=i,
            f_star=None if f_stars is None else f_stars[i]))
    return probs


def reference_source(name, cfg, p, iters=ITERS):
    """The reference's exact coordinate orders of tenant ``p`` (seed
    ``p.seed``) as an ``ArrayIndexSource``."""
    n_p = ceil_div(p.n, P)
    if name == "d3ca":
        return ArrayIndexSource(sdca=d3ca_rows(p.seed, iters, P, n_p,
                                               cfg.local_steps or n_p),
                                device="cpu")
    if name == "admm":
        return None
    perms, rows = radisa_streams(p.seed, iters, P, Q, n_p, cfg.L or n_p)
    sample = (sfk_samples(p.seed, iters, P, n_p, cfg.sample_frac)
              if name == "sfk" else None)
    return ArrayIndexSource(svrg=rows, perm=perms, sample=sample,
                            device="cpu")


def with_sources(name, cfg, probs):
    return [dataclasses.replace(p, index_source=reference_source(name, cfg,
                                                                 p))
            for p in probs]


def port_solo(name, p, cfg, *, backend="ref", block_format="dense", **kw):
    s = get_solver(name)(local_backend=backend, block_format=block_format,
                         device="cpu", index_source=p.index_source)
    return s.solve(p.loss_name, p.X, p.y, P=P, Q=Q, cfg=solo_config(cfg, p),
                   record_history=False, **kw)


@functools.lru_cache(maxsize=None)
def reference_solo(name, block_format):
    """The reference's solo simulated solve of every tenant (w, alpha)."""
    jcfg = CFGS[name][1]
    out = []
    for p in make_problems(sparse=block_format == "sparse"):
        kw = {"lam": p.lam}
        if hasattr(jcfg, "seed"):
            kw["seed"] = p.seed
        res = j_get_solver(name)(engine="simulated", local_backend="ref",
                                 block_format=block_format).solve(
            p.loss_name, p.X, p.y, P=P, Q=Q,
            cfg=dataclasses.replace(jcfg, **kw), record_history=False)
        out.append((np.asarray(res.w), None if res.alpha is None
                    else np.asarray(res.alpha)))
    return out


# ---------------------------------------------------------------------------
# a fleet tenant == the reference's solo solve of the same problem
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["ref", "kernel"])
@pytest.mark.parametrize("block_format", ["dense", "sparse"])
@pytest.mark.parametrize("name", SOLVERS)
def test_fleet_tenant_matches_reference_solo(name, block_format, backend):
    cfg = CFGS[name][0]
    probs = with_sources(name, cfg,
                         make_problems(sparse=block_format == "sparse"))
    batch = FleetSolver(solver=name, local_backend=backend,
                        block_format=block_format, device="cpu").solve_batch(
        probs, P=P, Q=Q, cfg=cfg, record_history=False)
    for res, (w_j, a_j) in zip(batch, reference_solo(name, block_format)):
        np.testing.assert_allclose(res.w.numpy(), w_j, **TOL)
        if a_j is not None:
            np.testing.assert_allclose(res.alpha.numpy(), a_j, **TOL)
        assert (res.solver, res.engine, res.block_format, res.device,
                res.iters) == (name, "simulated", block_format, "cpu", ITERS)


# ---------------------------------------------------------------------------
# the port's fleet == the reference's fleet on the dense grid cases
# ---------------------------------------------------------------------------

GRID_CASES = [
    ("d3ca", "hinge", "ref"), ("d3ca", "logistic", "ref"),
    ("d3ca", "hinge", "pallas"), ("radisa", "squared", "ref"),
    ("radisa", "hinge", "pallas"), ("sfk", "hinge", "ref"),
    ("admm", "hinge", "ref"),
]


@pytest.mark.parametrize("name,loss,backend", GRID_CASES,
                         ids=[f"{c[0]}-{c[1]}-dense-{c[2]}"
                              for c in GRID_CASES])
def test_fleet_matches_reference_fleet(name, loss, backend):
    cfg, jcfg = CFGS[name]
    probs = with_sources(name, cfg, make_problems(loss))
    jprobs = [JFleetProblem(tenant_id=p.tenant_id, loss_name=loss, X=p.X,
                            y=p.y, lam=p.lam, seed=p.seed) for p in probs]
    want = JFleetSolver(solver=name, local_backend=backend).solve_batch(
        jprobs, P=P, Q=Q, cfg=jcfg, record_history=False)
    # the reference's Pallas kernels (interpret mode) -> the port's kernel
    # backend, whose wrappers take the plain versions on the CPU
    got = FleetSolver(solver=name, device="cpu",
                      local_backend="ref" if backend == "ref" else "kernel"
                      ).solve_batch(probs, P=P, Q=Q, cfg=cfg,
                                    record_history=False)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.w.numpy(), np.asarray(w.w), **TOL)
        if w.alpha is not None:
            np.testing.assert_allclose(g.alpha.numpy(), np.asarray(w.alpha),
                                       **TOL)


# ---------------------------------------------------------------------------
# contract §10 inside the port: fleet tenant == port solo, bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["ref", "kernel"])
@pytest.mark.parametrize("block_format", ["dense", "sparse"])
@pytest.mark.parametrize("name", SOLVERS)
def test_fleet_bitmatches_port_solo(name, block_format, backend):
    """Default index sources (each tenant's generator seeded by its own
    seed) on both sides; lam * n a power of two for every tenant."""
    cfg = CFGS[name][0]
    probs = make_problems(sparse=block_format == "sparse")
    batch = FleetSolver(solver=name, local_backend=backend,
                        block_format=block_format, device="cpu").solve_batch(
        probs, P=P, Q=Q, cfg=cfg, record_history=False)
    for p, res in zip(probs, batch):
        solo = port_solo(name, p, cfg, backend=backend,
                         block_format=block_format)
        assert torch.equal(res.w, solo.w)
        if solo.alpha is not None:
            assert torch.equal(res.alpha, solo.alpha)


def test_non_pow2_products_match_to_float_tol():
    """Off the power-of-two lattice the solo path's double-precision
    ``lam * n`` (48 here) and the fleet's float32 product may differ in
    the last bit; results agree to 1e-6.  ADMM's squared prox divides by
    ``1 + 2c``, never a power of two."""
    probs = make_problems(n=96, lams=(0.5,))
    cfg = CFGS["d3ca"][0]
    res = FleetSolver(device="cpu").solve_batch(probs, P=P, Q=Q, cfg=cfg,
                                                record_history=False)[0]
    solo = port_solo("d3ca", probs[0], cfg, backend="kernel")
    np.testing.assert_allclose(res.w.numpy(), solo.w.numpy(), rtol=0,
                               atol=1e-6)
    probs = make_problems("squared", lams=(0.3,))
    cfg = CFGS["admm"][0]
    res = FleetSolver(solver="admm", device="cpu").solve_batch(
        probs, P=P, Q=Q, cfg=cfg, record_history=False)[0]
    solo = port_solo("admm", probs[0], cfg)
    np.testing.assert_allclose(res.w.numpy(), solo.w.numpy(), rtol=0,
                               atol=1e-6)


# ---------------------------------------------------------------------------
# convergence freezing + warm starts
# ---------------------------------------------------------------------------

def test_frozen_tenant_state_is_exact():
    """A tenant frozen at iteration k bit-equals a solo solve truncated
    at k outer iterations -- torch.where carries its state untouched."""
    probs = make_problems()
    f_stars = []
    for p in probs:
        w_ref, _ = serial_sdca("hinge", p.X, p.y, lam=p.lam, epochs=200,
                               device="cpu")
        f_stars.append(float(objective("hinge", torch.from_numpy(p.X),
                                       torch.from_numpy(p.y), w_ref, p.lam)))
    probs = make_problems(f_stars=f_stars)
    cfg = D3CAConfig(local_steps=16, outer_iters=30)
    batch = FleetSolver(device="cpu").solve_batch(
        probs, P=P, Q=Q, cfg=cfg, tol=0.05, check_every=2)
    assert any(r.converged for r in batch)
    for p, res in zip(probs, batch):
        if not res.converged:
            continue
        solo = port_solo("d3ca", p, dataclasses.replace(
            cfg, outer_iters=res.iters), backend="kernel")
        assert torch.equal(res.w, solo.w)
        assert torch.equal(res.alpha, solo.alpha)
        assert res.history[-1]["rel_opt"] < 0.05
        assert res.history[-1]["iter"] == res.iters
    # tenants froze at different segment boundaries (the mask matters)
    iters = {r.iters for r in batch}
    assert len(iters) > 1 or not all(r.converged for r in batch)


@pytest.mark.parametrize("name", ["d3ca", "radisa"])
def test_warm_start_chain_bitmatches_solo_chain(name):
    probs = make_problems()
    cfg = CFGS[name][0]
    fleet = FleetSolver(solver=name, device="cpu")
    first = fleet.solve_batch(probs, P=P, Q=Q, cfg=cfg, record_history=False)
    second = fleet.solve_batch(probs, P=P, Q=Q, cfg=cfg, warm_starts=first,
                               record_history=False)
    for p, res in zip(probs, second):
        s1 = port_solo(name, p, cfg, backend="kernel")
        s2 = port_solo(name, p, cfg, backend="kernel", warm_start=s1)
        assert torch.equal(res.w, s2.w)
        if name == "d3ca":
            assert torch.equal(res.alpha, s2.alpha)


def test_reference_result_seeds_a_port_fleet_round():
    """A reference solo result, carried across with
    ``convert.warm_start_from_reference``, warm-starts a port fleet
    round; the round continues as the reference's solo continuation."""
    cfg, jcfg = CFGS["d3ca"]
    probs = with_sources("d3ca", cfg, make_problems())
    warm, want = [], []
    for p in probs:
        jsolver = j_get_solver("d3ca")(engine="simulated",
                                       local_backend="ref")
        jc = dataclasses.replace(jcfg, lam=p.lam, seed=p.seed)
        first = jsolver.solve("hinge", p.X, p.y, P=P, Q=Q, cfg=jc,
                              record_history=False)
        want.append(jsolver.solve("hinge", p.X, p.y, P=P, Q=Q, cfg=jc,
                                  warm_start=first, record_history=False))
        warm.append(convert.warm_start_from_reference(first, device="cpu"))
    got = FleetSolver(device="cpu").solve_batch(
        probs, P=P, Q=Q, cfg=cfg, warm_starts=warm, record_history=False)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.w.numpy(), np.asarray(w.w), **TOL)
        np.testing.assert_allclose(g.alpha.numpy(), np.asarray(w.alpha),
                                   **TOL)


# ---------------------------------------------------------------------------
# packing rules, scheduler
# ---------------------------------------------------------------------------

def test_bucket_key_and_stacking_rule():
    a = make_problems(n=63, m=22, lams=(1.0,))[0]
    b = make_problems(n=64, m=24, lams=(1.0,))[0]
    assert bucket_key(a, P, Q) == bucket_key(b, P, Q) == ("hinge", 64, 24)
    c = make_problems("squared", lams=(1.0,))[0]
    assert bucket_key(c, P, Q) != bucket_key(b, P, Q)
    # the tenant axis lands right after the grid axes of a dim spec
    assert [named_axes(ds) for ds in (("data", "model"), ("data",), ())] \
        == [2, 1, 0]
    blocks = [torch.full((3, 2, 4, 5), float(i)) for i in range(2)]
    st = stack_grid(blocks, ("data", "model"))
    assert st.shape == (3, 2, 2, 4, 5) and st.is_contiguous()
    assert torch.equal(st[:, :, 1], blocks[1])
    assert stack_grid([torch.zeros(3, 4)] * 2, ("data",)).shape == (3, 2, 4)
    assert stack_grid([torch.zeros(())] * 2, ()).shape == (2,)
    cfg = solo_config(CFGS["d3ca"][0], b)
    assert (cfg.lam, cfg.seed) == (1.0, 0)
    assert solo_config(CFGS["admm"][0], b).lam == 1.0
    with pytest.raises(ValueError, match="bucket"):
        FleetSolver(device="cpu").solve_batch(
            [a, make_problems(n=96, lams=(1.0,))[0]], P=P, Q=Q,
            cfg=D3CAConfig(outer_iters=1))


def test_repad_k_pads_zero_slots():
    from repro_torch.core import partition_sparse
    X, y = tenant_data(0, 16, 8, sparse=True)
    part = partition_sparse(X, y, 2, 2, m_multiple=4, device="cpu")
    bigger = FleetSolver._repad_k(part, part.k + 8)
    assert bigger.k == part.k + 8
    assert not bigger.cols[..., part.k:].any()
    assert not bigger.vals[..., part.k:].any()
    assert torch.equal(bigger.vals[..., : part.k], part.vals)


def test_scheduler_buckets_chunks_and_warm_registry():
    cfg = CFGS["d3ca"][0]
    small = make_problems(n=64)
    big = [dataclasses.replace(p, tenant_id=f"big{i}")
           for i, p in enumerate(make_problems(n=128, lams=(0.5, 0.25)))]
    seen = []
    sched = FleetScheduler(P=P, Q=Q, solver="d3ca", cfg=cfg, max_tenants=2,
                           device="cpu",
                           on_result=lambda tid, r: seen.append(tid))
    for p in small + big:
        sched.submit(p)
    assert sched.pending() == 5
    groups = sched.buckets()
    assert [len(v) for v in groups.values()] == [3, 2]
    assert list(sched._chunks(small)) == [small[:2], small[2:]]
    results = sched.run()
    assert sched.pending() == 0
    assert list(results) == ["t0", "t1", "t2", "big0", "big1"] == seen
    for p in small + big:
        solo = port_solo("d3ca", p, cfg, backend="kernel")
        assert torch.equal(results[p.tenant_id].w, solo.w)
    # round 2 warm-starts every tenant from its round-1 result
    first = {k: v for k, v in results.items()}
    for p in small:
        sched.submit(p)
    again = sched.run()
    for p in small:
        assert sched.warm_start_of(p.tenant_id) is again[p.tenant_id]
        solo = port_solo("d3ca", p, cfg, backend="kernel",
                         warm_start=first[p.tenant_id])
        assert torch.equal(again[p.tenant_id].w, solo.w)
    cold = FleetScheduler(P=P, Q=Q, cfg=cfg, warm_registry=False,
                          device="cpu")
    cold.submit(small[0])
    assert torch.equal(cold.run()["t0"].w, first["t0"].w)
    assert cold.warm_start_of("t0") is None


# ---------------------------------------------------------------------------
# knobs
# ---------------------------------------------------------------------------

def test_fleet_knob_validation():
    with pytest.raises(ValueError, match="solver"):
        FleetSolver(solver="sgd", device="cpu")
    for engine in ("async", "overlap"):
        with pytest.raises(ValueError, match="engine"):
            FleetSolver(engine=engine, device="cpu")
    with pytest.raises(ValueError, match="staleness"):
        FleetSolver(engine="shard_map", staleness=2, device="cpu")
    with pytest.raises(ValueError, match="compression"):
        FleetSolver(compression="int8", device="cpu")
    with pytest.raises(ValueError, match="compression"):
        FleetSolver(topology="pods=2", device="cpu")
    with pytest.raises(ValueError, match="compression"):
        FleetSolver(overlap=True, device="cpu")
    with pytest.raises(ValueError, match="local_backend"):
        FleetSolver(local_backend="triton", device="cpu")
    with pytest.raises(ValueError, match="block_format"):
        FleetSolver(block_format="csr", device="cpu")
    # the synchronous mesh runs (tests/test_torch_mesh_fleet.py): "sync"
    # names it, and a process grid is refused by the grid engine
    for engine in ("shard_map", "sync"):
        assert FleetSolver(engine=engine, device="cpu").engine == "shard_map"
    with pytest.raises(ValueError, match="mesh= needs engine='shard_map'"):
        FleetSolver(mesh=object(), device="cpu")
    probs = make_problems(lams=(1.0,))
    with pytest.raises(ValueError, match="warm_starts"):
        FleetSolver(device="cpu").solve_batch(probs, P=P, Q=Q,
                                              warm_starts=[None, None])
    assert FleetSolver(device="cpu").solve_batch([], P=P, Q=Q) == []
    with pytest.raises(NotImplementedError, match="local_backend='ref'"):
        FleetSolver(device="cpu").solve_batch(make_problems(
            "logistic", lams=(1.0,)), P=P, Q=Q, cfg=CFGS["d3ca"][0])


# ---------------------------------------------------------------------------
# the CLIs
# ---------------------------------------------------------------------------

FLEET_SMALL = ["--tenants", "4", "--n", "64", "--m", "24", "--mesh", "2x2",
               "--iters", "3"]


@pytest.mark.parametrize("solver,block_format", [
    ("d3ca", "dense"), ("radisa", "sparse"), ("sfk", "dense"),
    ("admm", "sparse")])
def test_fleet_cli_on_the_cpu(solver, block_format, capsys):
    got = []
    argv = ["--solver", solver, "--block-format", block_format, "--rounds",
            "2", "--shape-mix", "--density", "0.3", *FLEET_SMALL, "--device",
            "cpu"]
    summary = fleet_cli.run(fleet_cli.parse_args(argv),
                            on_result=lambda p, r: got.append((p, r)))
    assert summary["buckets"] == 2 and summary["solves_per_s"] > 0
    assert [r["lam"] for r in summary["results"]] == [1.0, 0.5, 0.25, 1.0]
    assert len(got) == 8 and all(r.device == "cpu" for _, r in got)
    out = capsys.readouterr().out
    assert out.count("round=1") == 4
    json.loads(out[out.index("{"):])
    # the CLI's main runs the same tenants to the same results
    timed = ("total_s", "solves_per_s")
    assert fleet_cli.main(argv) | {k: summary[k] for k in timed} == summary
    # each tenant of the last round continued from its first-round result
    p, res = got[-1]
    assert res.w.shape == (p.m,) and res.iters == 3


#: the expectation of a refusal case whose flag is now ported: it runs
PORTED = object()
#: the same, for a flag of the mesh engine: it runs on a CPU process grid
MESH_PORTED = object()


@pytest.fixture(scope="module", autouse=True)
def _close_grids():
    """The mesh cases start the memoized 2 x 2 CPU grid; end it with the
    module."""
    yield
    close_grids()


@pytest.mark.usefixtures("bounded")
@pytest.mark.parametrize("flags,named", [
    pytest.param(["--engine", "shard_map"], MESH_PORTED,
                 id="flags0-'Multi-device engines'"),
    pytest.param(["--force-host-devices", "8"], MESH_PORTED,
                 id="flags1-'Multi-device engines'"),
    # the observability flags, once refused, run
    pytest.param(["--trace", "TRACE"], PORTED, id="flags2-'Observability'"),
    pytest.param(["--metrics"], PORTED, id="flags3-'Observability'"),
    pytest.param(["--health", "--min-tenants", "8"], PORTED,
                 id="flags4-'Observability'"),
    pytest.param(["--listen", "127.0.0.1:0"], PORTED,
                 id="flags5-'Observability'"),
    (["--solver", "nope"], "unknown solver"),
])
def test_fleet_cli_refuses_unported_flags_by_name(flags, named, capsys,
                                                  tmp_path):
    """A flag of a layer that is not ported exits 2 naming it; a flag
    whose layer is now ported (``PORTED``) runs, and its case checks what
    it made."""
    if named is PORTED:
        return _check_observability_flag(flags, tmp_path, capsys)
    if named is MESH_PORTED:
        return _check_mesh_flag(flags)
    with pytest.raises(SystemExit) as exc:
        fleet_cli.main([*flags, *FLEET_SMALL, "--device", "cpu"])
    assert exc.value.code == 2
    assert named in capsys.readouterr().err


def test_fleet_cli_publishes_snapshots(capsys):
    """``--publish-snapshots``: every tenant's book is at version = rounds
    and its scorer holds that tenant's last w, at that version."""
    got = {}
    snaps = fleet_cli.TenantSnapshots("hinge")
    argv = ["--rounds", "3", "--publish-snapshots", *FLEET_SMALL,
            "--device", "cpu"]
    summary = fleet_cli.run(fleet_cli.parse_args(argv),
                            on_result=lambda p, r: got.update({p.tenant_id:
                                                               r}),
                            snapshots=snaps)
    assert sorted(snaps.books) == sorted(got) and len(got) == 4
    for entry in summary["results"]:
        tid = entry["tenant"]
        assert entry["snapshot_version"] == 3
        snap = snaps.books[tid].current()
        assert snap.version == 3 and snap.trained_seq == got[tid].iters
        assert torch.equal(snap.w, got[tid].w)
        assert torch.equal(snap.alpha, got[tid].alpha)
        assert torch.equal(snaps.scorers[tid].w, got[tid].w)
        assert snaps.scorers[tid].w_version == 3
    assert "snapshot_version" not in fleet_cli.main(
        [*FLEET_SMALL, "--device", "cpu"])["results"][0]
    capsys.readouterr()


def test_optimize_problems_fanout_on_the_cpu():
    summary = optimize.main(["--problems", "3", "--solver", "radisa",
                             "--mesh", "2x2", "--n", "64", "--m", "24",
                             "--iters", "3", "--lam", "0.5", "--device",
                             "cpu"])
    assert summary["problems"] == 3 and len(summary["results"]) == 3
    # each fanned-out instance equals its solo solve (lam * n = 32)
    from repro_torch.data import make_svm_data
    for i, r in enumerate(summary["results"]):
        X, y = make_svm_data(64, 24, seed=i)
        solo = get_solver("radisa")(device="cpu").solve(
            "hinge", X, y, P=2, Q=2, cfg=RADiSAConfig(lam=0.5, outer_iters=3,
                                                      seed=i))
        assert r["objective"] == solo.history[-1]["objective"]


@pytest.mark.parametrize("dataset,block_format,kind", [
    ("dense", "dense", "dense"), ("dense", "sparse", "dense"),
    ("sparse", "dense", "sparse rows"), ("sparse", "sparse", "csr")])
def test_fanout_makes_its_instances_with_the_fleet_cli(dataset, block_format,
                                                      kind):
    """``--problems N`` makes its instances with the fleet CLI's
    ``make_tenants``, all at ``--lam``: seeds ``seed + i``, the data kind
    of ``--dataset`` on ``--block-format`` (exact, against the data
    helpers of the same seed)."""
    from repro_torch.data import (CSRMatrix, make_sparse_svm_csr,
                                  make_sparse_svm_data, make_svm_data)
    args = optimize.build_parser().parse_args(
        ["--problems", "3", "--n", "40", "--m", "30", "--lam", "0.5",
         "--density", "0.2", "--seed", "4", "--dataset", dataset,
         "--block-format", block_format])
    probs = fleet_cli.make_tenants(args, count=3, lam_of=lambda i: args.lam,
                                   prefix="p")
    assert [(p.tenant_id, p.lam, p.seed) for p in probs] == [
        ("p0", 0.5, 4), ("p1", 0.5, 5), ("p2", 0.5, 6)]
    for p in probs:
        if kind == "csr":
            X, y = make_sparse_svm_csr(40, 30, density=0.2, seed=p.seed)
            assert isinstance(p.X, CSRMatrix)
            np.testing.assert_array_equal(p.X.toarray(), X.toarray())
        else:
            X, y = (make_svm_data(40, 30, seed=p.seed) if kind == "dense"
                    else make_sparse_svm_data(40, 30, density=0.2,
                                              seed=p.seed))
            np.testing.assert_array_equal(p.X, X)
        np.testing.assert_array_equal(p.y, y)


def test_entry_points_need_the_card_or_the_cpu_by_name():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the rule under test "
                    "is what happens without one")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        FleetSolver()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        FleetScheduler(P=P, Q=Q)
    with pytest.raises(RuntimeError, match="--device cpu"):
        fleet_cli.main(FLEET_SMALL)
    with pytest.raises(RuntimeError, match="--device cpu"):
        optimize.main(["--problems", "3", "--mesh", "2x2", "--n", "64",
                       "--m", "24", "--iters", "1"])


def test_fleet_observability_hooks_keep_the_results():
    """``solve_batch(tracer=, registry=)`` and ``FleetScheduler(tracer=,
    registry=, monitor=)`` run the batch under the hooks: the results are
    bitwise those without, and the spans and gauges are recorded."""
    probs = [dataclasses.replace(p, f_star=0.25)
             for p in make_problems(lams=(1.0, 0.5))]
    cfg = CFGS["d3ca"][0]
    plain = FleetSolver(device="cpu").solve_batch(probs, P=P, Q=Q, cfg=cfg)
    tr, reg = Tracer(), Registry()
    got = FleetSolver(device="cpu").solve_batch(probs, P=P, Q=Q, cfg=cfg,
                                                tracer=tr, registry=reg)
    for a, b in zip(plain, got):
        assert torch.equal(a.w, b.w) and torch.equal(a.alpha, b.alpha)
    assert {e["name"] for e in tr.events} == {
        "fleet/pack", "fleet/step", "fleet/unpack"}
    gauges = reg.snapshot()["gauges"]
    assert gauges["fleet/tenants{engine=simulated,solver=d3ca}"] == 2.0
    assert gauges["fleet/active{engine=simulated,solver=d3ca}"] == 2.0
    assert sum(k.startswith("fleet/rel_opt{") for k in gauges) == 2
    mon = HealthMonitor(reg, fleet_rules(min_tenants=3), min_interval_s=0)
    sched = FleetScheduler(P=P, Q=Q, device="cpu", cfg=cfg, tracer=tr,
                           registry=reg, monitor=mon)
    for p in probs:
        sched.submit(p)
    res = sched.run()
    assert torch.equal(res[probs[0].tenant_id].w, plain[0].w)
    assert mon.healthz(evaluate=False)["rules"]["fleet_starvation"][
        "status"] == "warn"


def _check_mesh_flag(flags):
    """A flag of the reference's fleet CLI for the mesh runs the fleet:
    ``--engine shard_map`` on the 2 x 2 process grid, every tenant's
    objective within 1e-6 (relative) of the grid engine's (gloo's
    reductions against a blocked sum); ``--force-host-devices 8`` with the
    grid engine (8 >= P * Q CPU ranks), the same results bitwise."""
    argv = [*FLEET_SMALL, "--device", "cpu"]
    plain = fleet_cli.main(argv)
    got = fleet_cli.main([*flags, *argv])
    want = [r["objective"] for r in plain["results"]]
    have = [r["objective"] for r in got["results"]]
    if flags[0] == "--engine":
        assert got["engine"] == "shard_map" and got["buckets"] == 1
        np.testing.assert_allclose(have, want, rtol=1e-6)
    else:
        assert got["engine"] == "simulated" and have == want


def _check_observability_flag(flags, tmp_path, capsys):
    """An observability flag of the reference's fleet CLI runs the fleet
    under it and reports what it made, with the results of the plain
    run."""
    key = flags[0]
    flags = [str(tmp_path / "t.json") if f == "TRACE" else f for f in flags]
    argv = [*FLEET_SMALL, "--device", "cpu"]
    plain = fleet_cli.main(argv)
    got = fleet_cli.main([*flags, *argv])
    assert [r["objective"] for r in got["results"]] == \
        [r["objective"] for r in plain["results"]]
    if key == "--trace":
        names = {e["name"] for e in json.loads(
            (tmp_path / "t.json").read_text())["traceEvents"]}
        assert names == {"fleet/pack", "fleet/step", "fleet/unpack"}
        assert "[fleet] trace" in capsys.readouterr().out
    elif key == "--metrics":
        assert got["metrics"]["gauges"][
            "fleet/tenants{engine=simulated,solver=d3ca}"] == 4.0
    elif key == "--health":
        # one bucket of 4 tenants under --min-tenants 8: a starved bucket
        rule = got["obs"]["health"]["rules"]["fleet_starvation"]
        assert rule["status"] == "warn"
    else:
        assert got["obs"]["listen"].startswith("http://127.0.0.1:")

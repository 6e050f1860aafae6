"""The slice as a whole: the port's D3CA on the grid engine vs the
reference's ``engine="simulated"``, per iteration, with the reference's
coordinate orders injected, plus what both solvers share -- warm starts,
early stopping, index sources, the CommSchedule contract (CPU).  RADiSA's
per-iteration comparison is in ``test_torch_radisa.py``."""
import numpy as np
import pytest
import torch

from repro.core import D3CAConfig as JD3CA
from repro.core import RADiSAConfig as JRADiSA
from repro.core import get_solver as j_get_solver
from repro_torch import convert
from repro_torch.core import (ArrayIndexSource, CommSchedule, D3CAConfig,
                              GeneratorIndexSource, RADiSAConfig, SyncComm,
                              get_solver, grid_program, partition)
from repro_torch.core.d3ca import d3ca_simulated
from repro_torch.core.engines import CellProgram, cached_build
from test_torch_common import (ITERS, P, Q, SIZES, TOL, collect, compare,
                               d3ca_source, make_problem, radisa_source)


@pytest.mark.parametrize("n,m", SIZES)
@pytest.mark.parametrize("loss", ["hinge", "squared"])
@pytest.mark.parametrize("step_mode", ["exact", "beta"])
@pytest.mark.parametrize("backend", ["kernel", "ref"])
def test_d3ca_matches_reference(n, m, loss, step_mode, backend):
    X, y = make_problem(n, m, seed=1)
    # beta = lam / t stands in for ||x_i||^2 (~m / Q here).  The squared
    # loss has no box to clip to, so that recursion is contractive only
    # when ||x_i||^2 / (lam n) is small beside 1 / (2Q); elsewhere it
    # amplifies rounding differences beyond any fixed tolerance.
    lam = 5.0 if (loss, step_mode) == ("squared", "beta") else 0.05
    kw = dict(lam=lam, outer_iters=ITERS, step_mode=step_mode, seed=3)
    res_j, its_j = collect(
        j_get_solver("d3ca")(engine="simulated", local_backend="ref"),
        loss, X, y, JD3CA(**kw))
    res_t, its_t = collect(
        get_solver("d3ca")(local_backend=backend, device="cpu",
                           index_source=d3ca_source(3, n)),
        loss, X, y, D3CAConfig(**kw))
    compare(res_t, its_t, res_j, its_j, dual=True)
    assert res_t.alpha.shape == (n,) and res_t.w.shape == (m,)
    assert (res_t.solver, res_t.engine, res_t.local_backend,
            res_t.device) == ("d3ca", "simulated", backend, "cpu")


def test_d3ca_logistic_ref_backend_and_kernel_refusal():
    X, y = make_problem(101, 37, seed=4)
    kw = dict(lam=0.05, outer_iters=2, seed=1)
    res_j, its_j = collect(
        j_get_solver("d3ca")(engine="simulated", local_backend="ref"),
        "logistic", X, y, JD3CA(**kw))
    src = d3ca_source(1, 101, iters=2)
    res_t, its_t = collect(
        get_solver("d3ca")(local_backend="ref", device="cpu",
                           index_source=src), "logistic", X, y,
        D3CAConfig(**kw))
    for (w_t, a_t), (w_j, a_j) in zip(its_t, its_j):
        np.testing.assert_allclose(w_t, w_j, rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(a_t, a_j, rtol=1e-4, atol=1e-5)
    with pytest.raises(NotImplementedError, match="local_backend='ref'"):
        get_solver("d3ca")(local_backend="kernel", device="cpu",
                           index_source=src).solve(
            "logistic", X, y, P=P, Q=Q, cfg=D3CAConfig(**kw))


@pytest.mark.parametrize("name", ["d3ca", "radisa"])
def test_warm_start_carried_from_reference(name):
    """2 reference iterations -> the port continues == the reference
    continues (the reference restarts its iteration counter on a warm
    start, so both continue with the streams of t = 1, 2)."""
    X, y = make_problem(200, 60, seed=6)
    JCfg, TCfg = ((JD3CA, D3CAConfig) if name == "d3ca"
                  else (JRADiSA, RADiSAConfig))
    kw = dict(lam=0.05, outer_iters=2, seed=2)
    if name == "radisa":
        kw["gamma"] = 0.05
    jsolver = j_get_solver(name)(engine="simulated", local_backend="ref")
    first = jsolver.solve("hinge", X, y, P=P, Q=Q, cfg=JCfg(**kw))
    cont_j = jsolver.solve("hinge", X, y, P=P, Q=Q, cfg=JCfg(**kw),
                           warm_start=first)
    warm = convert.warm_start_from_reference(
        np.asarray(first.w),
        None if first.alpha is None else np.asarray(first.alpha),
        device="cpu")
    src = (d3ca_source(2, 200, iters=2) if name == "d3ca"
           else radisa_source(2, 200, iters=2))
    cont_t = get_solver(name)(device="cpu", index_source=src).solve(
        "hinge", X, y, P=P, Q=Q, cfg=TCfg(**kw), warm_start=warm)
    out = convert.to_numpy(cont_t)
    assert isinstance(out.w, np.ndarray)
    np.testing.assert_allclose(out.w, np.asarray(cont_j.w), **TOL)
    if name == "d3ca":
        np.testing.assert_allclose(out.alpha, np.asarray(cont_j.alpha),
                                   **TOL)
    np.testing.assert_allclose(cont_t.history[-1]["objective"],
                               cont_j.history[-1]["objective"], rtol=1e-6)
    # a SolveResult and a bare w are accepted as warm starts too
    again = get_solver(name)(device="cpu", index_source=src).solve(
        "hinge", X, y, P=P, Q=Q, cfg=TCfg(**kw), warm_start=cont_t)
    assert again.iters == 2
    bare = get_solver(name)(device="cpu", index_source=src).program(
        "hinge", X, y, P=P, Q=Q, cfg=TCfg(**kw), warm_start=warm[0])
    np.testing.assert_array_equal(bare.w_of(bare.state).numpy(),
                                  warm[0].numpy())


def test_partition_from_reference_feeds_the_port():
    from repro.core import partition as j_partition
    X, y = make_problem(101, 37, seed=7)
    J = j_partition(X, y, P, Q, m_multiple=P * Q)
    data = convert.partition_from_reference(
        np.asarray(J.x_blocks), np.asarray(J.y_blocks), np.asarray(J.mask),
        J.n, J.m, J.P, J.Q, device="cpu")
    own = partition(X, y, P, Q, m_multiple=P * Q, device="cpu")
    assert torch.equal(data.x_blocks, own.x_blocks)
    assert data.x_blocks.is_contiguous()
    cfg = D3CAConfig(lam=0.05, outer_iters=2, seed=3)
    src = d3ca_source(3, 101, iters=2)
    w1, a1 = d3ca_simulated("hinge", data, cfg, index_source=src)
    w2, a2 = d3ca_simulated("hinge", own, cfg, index_source=src)
    assert torch.equal(w1, w2) and torch.equal(a1, a2)
    with pytest.raises(ValueError, match="x_blocks has shape"):
        convert.partition_from_reference(
            np.asarray(J.x_blocks), np.asarray(J.y_blocks),
            np.asarray(J.mask), J.n, J.m, Q, P, device="cpu")


@pytest.mark.parametrize("name", ["d3ca", "radisa"])
def test_early_stop_by_tol(name):
    X, y = make_problem(200, 60, seed=8)
    Cfg = D3CAConfig if name == "d3ca" else RADiSAConfig
    kw = dict(lam=0.05, outer_iters=6)
    if name == "radisa":
        kw["gamma"] = 0.05
    solver = get_solver(name)(device="cpu")
    full = solver.solve("hinge", X, y, P=P, Q=Q, cfg=Cfg(**kw))
    assert full.iters == 6 and not full.converged
    # rel_opt vs f_star comes first in the stopping order
    f2 = full.history[1]["objective"]
    f_star = 0.5 * f2
    tol = (f2 - f_star) / f_star * 1.0001
    res = solver.solve("hinge", X, y, P=P, Q=Q, cfg=Cfg(**kw),
                       f_star=f_star, tol=tol)
    assert res.converged and res.iters == 2
    assert res.history[-1]["rel_opt"] < tol
    if name == "d3ca":
        gap3 = full.history[2]["duality_gap"]
        res = solver.solve("hinge", X, y, P=P, Q=Q, cfg=Cfg(**kw),
                           tol=gap3 * 1.0001)
        assert res.converged and res.iters == 3
    else:
        # primal solver without f_star: relative objective change
        res = solver.solve("hinge", X, y, P=P, Q=Q, cfg=Cfg(**kw), tol=1e9)
        assert res.converged and res.iters == 2
    quiet = solver.solve("hinge", X, y, P=P, Q=Q, cfg=Cfg(**kw),
                         record_history=False)
    assert quiet.history == [] and quiet.iters == 6


@pytest.mark.parametrize("name", ["d3ca", "radisa"])
def test_default_generator_source_reproducible_and_descends(name):
    X, y = make_problem(200, 60, seed=9)
    Cfg = D3CAConfig if name == "d3ca" else RADiSAConfig
    kw = dict(lam=0.05, outer_iters=4, seed=11)
    if name == "radisa":
        kw["gamma"] = 0.05
    runs = [get_solver(name)(device="cpu").solve("hinge", X, y, P=P, Q=Q,
                                                 cfg=Cfg(**kw))
            for _ in range(2)]
    assert torch.equal(runs[0].w, runs[1].w)
    other = get_solver(name)(device="cpu").solve(
        "hinge", X, y, P=P, Q=Q, cfg=Cfg(**{**kw, "seed": 12}))
    assert not torch.equal(runs[0].w, other.w)
    h = runs[0].history
    assert h[3]["objective"] < h[0]["objective"]
    if name == "d3ca":
        assert 0 < h[3]["duality_gap"] < h[0]["duality_gap"]


def test_generator_index_source_shapes_and_ranges():
    src = GeneratorIndexSource(5, P=3, Q=2, n_p=17, steps=40, L=9,
                               device="cpu")
    rows = src.sdca_rows(1)
    assert rows.shape == (3, 40) and rows.dtype == torch.int32
    assert 0 <= int(rows.min()) and int(rows.max()) < 17
    cells = src.svrg_rows(2)
    assert cells.shape == (3, 2, 9) and cells.dtype == torch.int32
    assert sorted(src.radisa_perm(3).tolist()) == [0, 1, 2]
    # a draw depends on (seed, t, stream) only, not on what came before
    assert torch.equal(src.sdca_rows(1), rows)
    assert not torch.equal(src.sdca_rows(2), rows)
    arr = ArrayIndexSource(sdca={1: rows.numpy()}, device="cpu")
    assert torch.equal(arr.sdca_rows(1), rows)
    with pytest.raises(KeyError, match="t=2"):
        arr.sdca_rows(2)
    with pytest.raises(KeyError, match="svrg_rows"):
        arr.svrg_rows(1)


def test_comm_schedule_exactly_once_contract():
    sched = (CommSchedule().pmean("dalpha", axis="model")
             .psum("w_contrib", axis="data"))
    assert sched.names == ("dalpha", "w_contrib")
    assert sched["dalpha"].result_axis == "data"
    v = torch.arange(24, dtype=torch.float32).reshape(3, 2, 4)

    def skips(comm, t, data, state):
        return comm("dalpha", v)

    def twice(comm, t, data, state):
        comm("dalpha", v)
        comm("w_contrib", v)
        return comm("dalpha", v)

    def undeclared(comm, t, data, state):
        return comm("grad", v)

    with pytest.raises(ValueError, match="never executed.*w_contrib"):
        grid_program(CellProgram(sched, skips), 3, 2, device="cpu")(1, None, None)
    with pytest.raises(ValueError, match="executed twice"):
        grid_program(CellProgram(sched, twice), 3, 2, device="cpu")(1, None, None)
    with pytest.raises(KeyError, match="not declared"):
        grid_program(CellProgram(sched, undeclared), 3, 2, device="cpu")(1, None, None)
    with pytest.raises(ValueError, match="declared twice"):
        CommSchedule().psum("z", axis="model").psum("z", axis="data")
    with pytest.raises(ValueError, match="op="):
        from repro_torch.core import Collective
        Collective("z", "pmax", "data")

    comm = SyncComm(CommSchedule().psum("a", axis="data")
                    .pmean("b", axis="model").allgather("c", axis="data")
                    .allgather("d", axis="model"), {"data": 3, "model": 2},
                    device="cpu")
    assert torch.equal(comm("a", v), v.sum(0))            # (Q, ...)
    assert torch.equal(comm("b", v), v.mean(1))           # (P, ...)
    assert comm("c", v).shape == (2, 3, 4)                # per q: all p
    assert torch.equal(comm("d", v), v)                   # per p: all q
    comm.finalize()
    assert comm.axis_size("data") == 3
    assert comm.axis_index("model").tolist() == [0, 1]
    with pytest.raises(ValueError, match="does not lead with the 3x2 grid"):
        SyncComm(sched, {"data": 3, "model": 2},
                 device="cpu")("dalpha", v[:2])
    cache = {}
    assert cached_build(cache, "k", lambda: 1) == 1
    assert cached_build(cache, "k", lambda: 2) == 1
    assert cached_build(None, "k", lambda: 2) == 2

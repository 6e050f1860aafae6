"""Communication policies beyond the codecs, against the reference on the
CPU: the alpha-beta wire-time model (``core/comm_model.py``, every case
of the reference's own model tests), the hierarchical two-level
reduction on blocked payloads (``SyncComm.set_topology``), the
``topology=`` knob of the four solvers, the solver knob validation, and
the online service under a codec.

The hierarchical identity reduction is held at the reference's 1e-5 (it
sums within pods, then across: another association than the flat sum).
Under an int8 pod codec the iterates are held within two int8 quanta of
the largest entry, as the lossy solves of ``test_torch_compress.py`` are
(a code on a rounding boundary may land one quantum apart).
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import D3CAConfig as JD3CA
from repro.core import comm_model as jm
from repro.core import get_solver as j_get_solver
from repro.core.comm import CommSchedule as JSchedule
from repro.core.comm import SyncComm as JSync
from repro.core.comm import hier_ef_names as j_hier_ef_names
from repro.core.compress import get_codec as j_get_codec
from repro.core.d3ca import d3ca_schedule as j_d3ca_schedule
from repro.core.radisa import radisa_schedule as j_radisa_schedule
from repro.online import OnlineConfig as JOnlineConfig
from repro.online import OnlineSolverService as JService
from repro_torch.core import (CellProgram, CommSchedule, D3CAConfig,
                              SyncComm, get_solver, grid_program)
from repro_torch.core import comm_model as tm
from repro_torch.core.comm import hier_ef_names
from repro_torch.core.compress import get_codec
from repro_torch.core.d3ca import d3ca_schedule
from repro_torch.core.engines import grid_bind_state
from repro_torch.core.radisa import radisa_schedule
from repro_torch.online import OnlineConfig, OnlineSolverService
from test_torch_common import d3ca_source, make_problem
from test_torch_compress import LOSSY_REL, assert_close, solve_pair

TOL = dict(rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# the alpha-beta model: every reference case, on both packages
# ---------------------------------------------------------------------------

def test_module_exports_and_priors_match_reference():
    assert tm.__all__ == jm.__all__
    for name in ("INTRA_POD_LINK", "INTER_POD_LINK"):
        a, b = getattr(tm, name), getattr(jm, name)
        assert (a.alpha_s, a.beta_s_per_byte, a.name) == (
            b.alpha_s, b.beta_s_per_byte, b.name)


def test_link_model_validation_and_bandwidth():
    link = tm.LinkModel(1e-6, 1.0 / 100e9)
    assert link.bandwidth_gbps == pytest.approx(100.0)
    assert tm.LinkModel(0.0, 0.0).bandwidth_gbps == math.inf
    with pytest.raises(ValueError, match=">= 0"):
        tm.LinkModel(-1e-6, 0.0)


@pytest.mark.parametrize("op", ["psum", "pmean", "allgather"])
@pytest.mark.parametrize("algo", ["ring", "tree"])
@pytest.mark.parametrize("n,k", [(4096.0, 8), (4096.0, 6), (1024.0, 4),
                                 (1e8, 64), (8.0, 64), (1024.0, 1),
                                 (0.0, 8)])
def test_collective_time_equals_reference(op, algo, n, k):
    a, b = 2e-6, 1e-9
    got = tm.collective_time(op, n, k, tm.LinkModel(a, b), algo)
    assert got == jm.collective_time(op, n, k, jm.LinkModel(a, b), algo)
    if k <= 1 or n <= 0:
        assert got == 0.0
    elif op != "allgather" and algo == "ring":
        assert got == pytest.approx(2 * (k - 1) * a + 2 * (k - 1) / k * n * b)
    elif op != "allgather":
        assert got == pytest.approx(2 * math.ceil(math.log2(k)) * (a + n * b))
    elif algo == "ring":
        assert got == pytest.approx((k - 1) * (a + n * b))
    else:
        assert got == pytest.approx(math.ceil(math.log2(k)) * a
                                    + (k - 1) * n * b)


def test_collective_time_degenerate_and_errors():
    link = tm.LinkModel(1e-6, 1e-9)
    assert tm.collective_time("psum", 1024.0, 1, link) == 0.0
    assert tm.collective_time("psum", 0.0, 8, link) == 0.0
    with pytest.raises(ValueError, match="algorithm"):
        tm.collective_time("psum", 64.0, 4, link, "butterfly")
    with pytest.raises(ValueError, match="op"):
        tm.collective_time("reduce", 64.0, 4, link)


def test_ring_beats_tree_on_bandwidth_tree_on_latency():
    fat = tm.LinkModel(1e-6, 1e-9)
    big, small, k = 1e8, 8.0, 64
    assert (tm.collective_time("psum", big, k, fat, "ring")
            < tm.collective_time("psum", big, k, fat, "tree"))
    assert (tm.collective_time("psum", small, k, fat, "tree")
            < tm.collective_time("psum", small, k, fat, "ring"))


@pytest.mark.parametrize("spec", ["pods=4:int8:tree", "pods=2", "pods=1",
                                  "pods=3:topk", "pods=2::tree",
                                  " pods=8:fp8 "])
def test_topology_spec_roundtrip_matches_reference(spec):
    t, j = tm.Topology.from_spec(spec), jm.Topology.from_spec(spec)
    assert (t.pods, t.codec, t.algo, t.axis, t.spec) == (
        j.pods, j.codec, j.algo, j.axis, j.spec)
    assert tm.Topology.from_spec(t.spec) == t
    assert t.hierarchical() == j.hierarchical()
    assert tm.Topology.from_spec(t) is t


def test_topology_spec_errors():
    for bad in ("", "2", "pods=x", "pods=2:int8:tree:extra", 2):
        with pytest.raises(ValueError, match="spec|pod count"):
            tm.Topology.from_spec(bad)
    with pytest.raises(ValueError, match="pods"):
        tm.Topology(pods=0)
    with pytest.raises(ValueError, match="algo"):
        tm.Topology(pods=2, algo="butterfly")
    assert tm.as_topology(None) is None
    assert tm.as_topology("pods=2").pods == 2
    t = tm.Topology(pods=3)
    assert tm.as_topology(t) is t


def _acct(per_cell=4096, cells=8, op="psum", axis="data", name="g"):
    """Minimal wire_accounting dict with one collective."""
    return {"collectives": {
        name: {"payload_bytes_per_cell": per_cell, "cells": cells,
               "bytes_per_step": per_cell * cells, "op": op, "axis": axis}},
        "bytes_per_step": per_cell * cells,
        "uncompressed_bytes_per_step": per_cell * cells}


@pytest.mark.parametrize("topo", [None, "pods=2", "pods=2:int8",
                                  "pods=4:fp8:tree"])
@pytest.mark.parametrize("axis,op", [("data", "psum"), ("model", "pmean"),
                                     ("data", "allgather")])
def test_predict_comm_s_equals_reference(topo, axis, op):
    acct = _acct(per_cell=4096, op=op, axis=axis)
    sizes = {"data": 8, "model": 2}
    link = tm.LinkModel(1e-6, 1e-9)
    got = tm.predict_comm_s(acct, sizes, topology=tm.as_topology(topo),
                            link=link)
    want = jm.predict_comm_s(acct, sizes, topology=jm.as_topology(topo),
                             link=jm.LinkModel(1e-6, 1e-9))
    assert got == want


def test_predict_comm_s_flat_and_hierarchical_stages():
    link = tm.LinkModel(1e-6, 1e-9)
    pred = tm.predict_comm_s(_acct(), {"data": 4, "model": 2}, link=link)
    assert pred["total_s"] == pytest.approx(
        tm.collective_time("psum", 4096, 4, link, "ring"))
    assert pred["collectives"]["g"]["k"] == 4
    topo = tm.Topology(pods=2, codec="identity")
    pred = tm.predict_comm_s(_acct(), {"data": 8, "model": 1},
                             topology=topo)
    c = pred["collectives"]["g"]
    intra = tm.collective_time("psum", 4096, 4, topo.intra, "ring")
    inter = tm.collective_time("psum", 4096, 2, topo.inter, "ring")
    assert (c["intra_s"], c["inter_s"]) == (pytest.approx(intra),
                                            pytest.approx(inter))
    assert pred["total_s"] == pytest.approx(intra + inter)


@pytest.mark.parametrize("codec", ["identity", "int8", "fp8", "topk:0.1"])
def test_hierarchical_accounting_equals_reference(codec):
    acct = _acct(per_cell=4096, cells=8, axis="data")
    sizes = {"data": 8, "model": 1}
    got = tm.hierarchical_accounting(acct, tm.Topology(pods=2, codec=codec),
                                     sizes)
    assert got == jm.hierarchical_accounting(
        acct, jm.Topology(pods=2, codec=codec), sizes)
    c = got["collectives"]["g"]
    assert c["intra_bytes_per_step"] == 4096 * 8
    if codec == "identity":
        assert c["inter_bytes_per_step"] == 4096 * 2
        assert got["bytes_per_step"] == 4096 * 10
    else:
        assert c["inter_bytes_per_step"] < 4096 * 2 / 3
    assert got["topology"] == tm.Topology(pods=2, codec=codec).spec


def test_hierarchical_accounting_passthrough_and_other_axes():
    acct = _acct(per_cell=4096, cells=8, axis="data")
    assert tm.hierarchical_accounting(acct, None, {}) is acct
    assert tm.hierarchical_accounting(acct, tm.Topology(pods=1), {}) is acct
    other = _acct(per_cell=512, cells=8, axis="model")
    o = tm.hierarchical_accounting(other, tm.Topology(pods=2),
                                   {"data": 8, "model": 1})
    assert o["collectives"]["g"]["inter_bytes_per_step"] == 0.0
    assert o["collectives"]["g"]["bytes_per_step"] == 512 * 8


def test_fit_link_recovers_known_parameters_as_reference():
    true = tm.LinkModel(3e-6, 2e-9)
    samples = []
    for per_cell, k in ((1024, 4), (8192, 4), (65536, 8), (256, 8)):
        acct = _acct(per_cell=per_cell, cells=k, axis="data")
        sizes = {"data": k, "model": 1}
        samples.append((acct, sizes,
                        tm.predict_comm_s(acct, sizes, link=true)["total_s"]))
    for algo in ("ring", "tree"):
        fit = tm.fit_link(samples, algo=algo)
        ref = jm.fit_link(samples, algo=algo)
        assert (fit.alpha_s, fit.beta_s_per_byte) == (ref.alpha_s,
                                                      ref.beta_s_per_byte)
    fit = tm.fit_link(samples)
    assert fit.alpha_s == pytest.approx(true.alpha_s, rel=1e-6)
    assert fit.beta_s_per_byte == pytest.approx(true.beta_s_per_byte,
                                                rel=1e-6)


def test_fit_link_clamps_and_degenerates():
    acct = _acct(per_cell=4096, cells=4, axis="data")
    sizes = {"data": 4, "model": 1}
    one = tm.fit_link([(acct, sizes, 1e-3)])
    assert one.alpha_s >= 0 and one.beta_s_per_byte >= 0
    assert tm.predict_comm_s(acct, sizes, link=one)["total_s"] > 0
    ref = jm.fit_link([(acct, sizes, 1e-3)])
    assert (one.alpha_s, one.beta_s_per_byte) == (ref.alpha_s,
                                                  ref.beta_s_per_byte)
    empty = tm.fit_link([])
    assert (empty.alpha_s, empty.beta_s_per_byte) == (0.0, 0.0)
    solo = tm.fit_link([(_acct(per_cell=64, cells=1, axis="data"),
                         {"data": 1, "model": 1}, 1e-3)])
    assert (solo.alpha_s, solo.beta_s_per_byte) == (0.0, 0.0)


@pytest.mark.parametrize("comm_s,local_s,tau", [
    (3.0, 1.0, 2), (1.5, 1.0, 2), (3.0, 1.0, 0), (-1.0, 1.0, 2),
    (2.0, -1.0, 3), (5.0, 0.5, 4)])
def test_overlap_split_equals_reference(comm_s, local_s, tau):
    got = tm.overlap_split(comm_s, local_s, tau)
    assert got == jm.overlap_split(comm_s, local_s, tau)
    assert got["comm_hidden_s"] + got["comm_exposed_s"] == pytest.approx(
        max(comm_s, 0.0))


# ---------------------------------------------------------------------------
# the hierarchical reduction on blocked payloads
# ---------------------------------------------------------------------------

def _port_hier(codec, vals, ef=None, ops=("psum",)):
    sched = CommSchedule()
    for i, op in enumerate(ops):
        getattr(sched, op)(f"s{i}", axis="data")
    comm = SyncComm(sched, {"data": vals.shape[0], "model": vals.shape[1]},
                    device="cpu")
    comm.set_topology(tm.Topology(pods=2, codec=codec), get_codec(codec),
                      ef=ef)
    out = [comm(f"s{i}", vals) for i in range(len(ops))]
    comm.finalize()
    return out, comm.hier_ef_out


def test_hierarchical_psum_and_pmean_match_flat():
    """identity pod codec: pod sums then the sum over pods == the flat
    reduction over all cells (up to f32 reassociation)."""
    vals = torch.tensor(np.random.default_rng(1).normal(size=(8, 2, 5)),
                        dtype=torch.float32)
    (s, m), ef = _port_hier("identity", vals, ops=("psum", "pmean"))
    np.testing.assert_allclose(s.numpy(), vals.sum(0).numpy(), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(m.numpy(), vals.mean(0).numpy(), rtol=1e-6,
                               atol=1e-6)
    assert ef == {}
    # summation order: within pods first, then across pods
    want = vals.reshape(2, 4, 2, 5).sum(1).sum(0)
    assert torch.equal(s, want)


@pytest.mark.parametrize("codec", ["int8", "fp8", "topk:0.4"])
def test_hierarchical_codec_threads_ef_as_the_reference_per_pod(codec):
    """A stateful pod codec reads and writes one residual a pod and
    feature block; the reference keeps one a cell, equal across the cells
    of a pod: the port's equals each of them, and so does the result."""
    P, Q, c = 4, 2, 6
    rng = np.random.default_rng(2)
    vals = (rng.normal(size=(P, Q, c)) * 3).astype(np.float32)
    ef_pod = (rng.normal(size=(2, Q, c)) * 0.05).astype(np.float32)
    (out,), ef = _port_hier(codec, torch.tensor(vals),
                            ef={"s0": torch.tensor(ef_pod)})
    sched = JSchedule().psum("s", axis="data")
    topo = jm.Topology(pods=2, codec=codec)

    def cell(x, e):
        comm = JSync(sched, {"data": ("pod", "d"), "model": ("m",)},
                     {"data": P, "model": Q})
        comm.set_topology(topo, j_get_codec(codec), ef={"s": e})
        res = comm("s", x)
        comm.finalize()
        return res, comm.hier_ef_out["s"]

    run = jax.vmap(jax.vmap(jax.vmap(cell, axis_name="m"), axis_name="d"),
                   axis_name="pod")
    ef_cells = np.repeat(ef_pod[:, None], P // 2, axis=1)   # (2, 2, Q, c)
    j_out, j_ef = run(jnp.asarray(vals.reshape(2, P // 2, Q, c)),
                      jnp.asarray(ef_cells))
    assert ef["s0"].shape == (2, Q, c)
    for g in range(2):
        for d in range(P // 2):
            np.testing.assert_allclose(out.numpy(), np.asarray(j_out[g, d]),
                                       rtol=1e-6, atol=1e-6)
            np.testing.assert_allclose(ef["s0"][g].numpy(),
                                       np.asarray(j_ef[g, d]), rtol=1e-6,
                                       atol=1e-6)


def test_hierarchical_missing_residual_and_names():
    sched = CommSchedule().psum("s", axis="data").pmean("r", axis="model")
    with pytest.raises(KeyError, match="error-feedback residual"):
        _port_hier("int8", torch.ones(4, 2, 3))
    for topo in ("pods=2:int8", "pods=2", "pods=1:int8", None,
                 "pods=4:topk"):
        got = hier_ef_names(sched, tm.as_topology(topo))
        want = j_hier_ef_names(
            JSchedule().psum("s", axis="data").pmean("r", axis="model"),
            jm.as_topology(topo))
        assert got == want
    assert hier_ef_names(d3ca_schedule(), tm.as_topology("pods=2:int8")) \
        == j_hier_ef_names(j_d3ca_schedule(),
                           jm.as_topology("pods=2:int8")) == ("w_contrib",)
    assert hier_ef_names(radisa_schedule(), tm.as_topology("pods=2:fp8")) \
        == j_hier_ef_names(j_radisa_schedule(), jm.as_topology("pods=2:fp8"))


def test_pods_must_divide_p_everywhere():
    sched = CommSchedule().psum("s", axis="data")
    comm = SyncComm(sched, {"data": 3, "model": 1}, device="cpu")
    with pytest.raises(ValueError, match="divide"):
        comm.set_topology(tm.Topology(pods=2), get_codec("identity"))
    prog = CellProgram(sched, lambda comm, t, d, s: comm("s", d))
    with pytest.raises(ValueError, match="divide"):
        grid_program(prog, 3, 1, topology="pods=2", device="cpu")
    X, y = make_problem(24, 8)
    with pytest.raises(ValueError, match="divide"):
        get_solver("d3ca")(device="cpu", topology="pods=2").program(
            "hinge", X, y, P=3, Q=1)
    # the allgather and the "model" collectives stay flat
    sched = CommSchedule().allgather("g", axis="data").psum("m",
                                                            axis="model")
    comm = SyncComm(sched, {"data": 4, "model": 2}, device="cpu")
    comm.set_topology(tm.Topology(pods=2, codec="int8"), get_codec("int8"))
    vals = torch.arange(24.0).reshape(4, 2, 3)
    assert torch.equal(comm("g", vals), vals.movedim(0, 1))
    assert torch.equal(comm("m", vals), vals.sum(1))


def test_grid_program_carries_pod_residuals_in_its_state():
    sched = CommSchedule().psum("s", axis="data")

    def cell(comm, t, data, state):
        return state + comm("s", data)

    prog = CellProgram(sched, cell, state_specs=("model",),
                       payload_shapes=lambda data, state: {
                           "s": tuple(state.shape[1:])})
    data = torch.tensor(np.random.default_rng(3).normal(size=(4, 2, 5)),
                        dtype=torch.float32)
    state0 = torch.zeros(2, 5)
    full0, unwrap, acct = grid_bind_state(prog, data, state0, Pn=4, Qn=2,
                                          compression="int8",
                                          topology="pods=2:int8",
                                          device="cpu")
    assert sorted(full0[1]) == ["pod:s", "s"]
    assert full0[1]["s"].shape == (4, 2, 5)
    assert full0[1]["pod:s"].shape == (2, 2, 5)
    assert acct["topology"] == "pods=2:int8:ring"
    step = grid_program(prog, 4, 2, compression="int8",
                        topology="pods=2:int8", device="cpu")
    state, ef = step(1, data, full0)
    assert unwrap((state, ef)) is state and state.shape == (2, 5)
    assert sorted(ef) == ["pod:s", "s"] and ef["pod:s"].abs().max() > 0
    np.testing.assert_allclose(state.numpy(), data.sum(0).numpy(),
                               atol=0.2)
    # no knob: the state is the solver state itself, no ef dict
    plain0, unwrap0, acct0 = grid_bind_state(prog, data, state0, Pn=4, Qn=2,
                                             device="cpu")
    assert plain0 is state0 and "topology" not in acct0


# ---------------------------------------------------------------------------
# Solver(topology=...) against the reference's grid topology
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("block_format", ["dense", "sparse"])
@pytest.mark.parametrize("name", ["d3ca", "radisa", "sfk", "admm"])
def test_topology_identity_matches_reference_and_flat(name, block_format):
    flat, _ = solve_pair(name, block_format)
    res_t, res_j = solve_pair(name, block_format, topology="pods=2")
    assert_close(res_t, res_j, TOL)
    assert res_t.comm_bytes == res_j.comm_bytes
    assert res_t.topology == res_j.topology == "pods=2:identity:ring"
    np.testing.assert_allclose(res_t.w.numpy(), flat.w.numpy(), **TOL)
    acct = res_t.comm_bytes
    assert acct["intra_bytes_per_step"] + acct["inter_bytes_per_step"] == \
        acct["bytes_per_step"] > flat.comm_bytes["bytes_per_step"]


@pytest.mark.parametrize("block_format", ["dense", "sparse"])
@pytest.mark.parametrize("name,topology,compression", [
    ("d3ca", "pods=2:int8", None), ("d3ca", "pods=4:fp8", "int8"),
    ("radisa", "pods=2:int8", None), ("sfk", "pods=2:fp8", None),
    ("admm", "pods=2:int8", "fp8")])
def test_topology_codec_matches_reference(name, topology, compression,
                                          block_format):
    res_t, res_j = solve_pair(name, block_format, topology=topology,
                              compression=compression)
    assert_close(res_t, res_j)
    assert res_t.comm_bytes == res_j.comm_bytes
    assert res_t.topology == res_j.topology
    assert res_t.compression == res_j.compression


def test_pod_residuals_step_by_step_equal_the_references():
    """D3CA under pods=2:int8, three outer steps of the program: the
    port's residual of each pod equals the reference's of every cell of
    that pod."""
    X, y = make_problem(120, 37, seed=2)
    kw = dict(lam=0.05, seed=3, outer_iters=3)
    port = get_solver("d3ca")(
        device="cpu", topology="pods=2:int8",
        index_source=d3ca_source(3, 120, iters=3, grid=(4, 2))).program(
        "hinge", X, y, P=4, Q=2, cfg=D3CAConfig(**kw))
    ref = j_get_solver("d3ca")(topology="pods=2:int8").program(
        "hinge", X, y, P=4, Q=2, cfg=JD3CA(**kw))
    s, js = port.state, ref.state
    for t in range(1, 4):
        s, js = port.step(t, s), ref.step(t, js)
        pod, j_pod = port.ef_of(s), ref.ef_of(js)
        assert sorted(pod) == sorted(j_pod) == ["pod:w_contrib"]
        j_res = np.asarray(j_pod["pod:w_contrib"])          # (P, Q, m_q)
        scale = np.abs(j_res).max()
        for p in range(4):
            np.testing.assert_allclose(
                pod["pod:w_contrib"][p // 2].numpy(), j_res[p],
                atol=LOSSY_REL * scale)
        np.testing.assert_allclose(port.w_of(s).numpy(),
                                   np.asarray(ref.w_of(js)), rtol=1e-5,
                                   atol=1e-5)


# ---------------------------------------------------------------------------
# knob validation
# ---------------------------------------------------------------------------

def test_solver_staleness_validation_as_the_reference():
    cls = get_solver("d3ca")
    assert cls(device="cpu").staleness == 0
    with pytest.raises(ValueError, match="must be >= 0"):
        cls(device="cpu", staleness=-1)
    for engine in ("simulated",):
        with pytest.raises(ValueError, match="needs engine='async'"):
            cls(device="cpu", engine=engine, staleness=1)
        with pytest.raises(ValueError, match="needs engine='async'"):
            j_get_solver("d3ca")(engine=engine, staleness=1)
    # the async / overlap engines take a delay, as the reference's; the
    # synchronous mesh engine refuses one with the reference's text
    for engine in ("async", "overlap"):
        s = cls(device="cpu", engine=engine, staleness=3)
        j = j_get_solver("d3ca")(engine=engine, staleness=3)
        assert (s.engine, s.staleness) == (j.engine, j.staleness)
    for engine in ("sync", "shard_map"):
        with pytest.raises(ValueError, match="needs engine='async'") as e:
            cls(device="cpu", engine=engine, staleness=3)
        with pytest.raises(ValueError) as je:
            j_get_solver("d3ca")(engine=engine, staleness=3)
        assert str(e.value) == str(je.value)


def test_solver_topology_validation_as_the_reference():
    cls = get_solver("d3ca")
    s = cls(device="cpu", topology="pods=2:int8")
    assert s.topology.pods == 2 and s.topology_spec == "pods=2:int8:ring"
    assert cls(device="cpu").topology is None
    assert cls(device="cpu").topology_spec is None
    with pytest.raises(ValueError, match="spec"):
        cls(device="cpu", topology="2pods")
    with pytest.raises(ValueError, match="unknown codec"):
        X, y = make_problem(24, 8)
        cls(device="cpu", topology="pods=2:int4").program(
            "hinge", X, y, P=2, Q=1)


# ---------------------------------------------------------------------------
# the online service under a codec
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("knobs", [dict(compression="int8"),
                                   dict(compression="fp8",
                                        topology="pods=3:int8")])
def test_online_service_under_a_codec_matches_reference(knobs):
    m, P, Q, cap = 12, 3, 2, 36
    kw = dict(m=m, capacity=cap, P=P, Q=Q, passes=2, **knobs)
    svc = OnlineSolverService(
        OnlineConfig(**kw, solver_cfg=D3CAConfig(lam=0.05, local_steps=8)),
        device="cpu",
        index_source=d3ca_source(0, cap, iters=2, steps=8, grid=(P, Q)))
    ref = JService(JOnlineConfig(**kw, solver_cfg=JD3CA(lam=0.05,
                                                        local_steps=8)))
    assert svc.solver.compression_spec == ref.solver.compression_spec
    assert svc.solver.topology_spec == ref.solver.topology_spec
    rng = np.random.default_rng(5)
    for b in (5, 8, 3, 12, 7, 9):
        X = rng.normal(size=(b, m)).astype(np.float32)
        y = np.where(X @ np.linspace(-1.0, 1.0, m) >= 0, 1.0,
                     -1.0).astype(np.float32)
        assert svc.submit(X, y) == ref.submit(X, y)
        assert svc.run_pending() == ref.run_pending()
        s, r = svc.book.current(), ref.book.current()
        assert (s.version, s.trained_seq) == (r.version, r.trained_seq)
        for got, want in ((s.w, r.w), (s.alpha, r.alpha)):
            assert np.abs(got.numpy() - np.asarray(want)).max() <= \
                LOSSY_REL * np.abs(np.asarray(want)).max()
    res = svc.last_result
    assert res.compression == knobs["compression"]
    assert res.comm_bytes["compression"] == knobs["compression"]


def test_online_config_staleness_refused_as_the_reference():
    for pkg in ("port", "ref"):
        with pytest.raises(ValueError, match="needs engine='async'"):
            if pkg == "port":
                OnlineSolverService(OnlineConfig(m=4, staleness=2),
                                    device="cpu")
            else:
                JService(JOnlineConfig(m=4, staleness=2))

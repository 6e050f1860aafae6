"""The compressed-communication slice (``repro_torch.core.compress``)
against the reference's ``repro.core.compress`` on the CPU: codecs on
blocked payloads against the reference applied cell by cell, the legacy
tree helpers, policy and schedule specs, the CompressedComm executor,
exact wire accounting, and the solver-level ``compression=`` knob for the
four solvers, dense and sparse, with the reference's coordinate orders
injected.

Tolerances, and why.  A codec is held bitwise to the reference on the
same inputs: both quantize with the same float32 operations (max-abs,
a true division, round-half-to-even, the e4m3 cast, top-k by magnitude
on continuous payloads).  End to end, the identity codec is held at the
reference's own 1e-5.  A lossy codec amplifies input differences: the
codec inputs of the two packages differ by ~1e-7 relative (other
summation orders), so a code that sits on a rounding boundary can land
one quantum apart (1/127 of its cell's largest entry for int8), and
error feedback hands that quantum back on the next step.  Lossy solves
are therefore held within two quanta of the largest entry of w and alpha
(``LOSSY_REL``) and the objective at 1e-3 relative (one such flip moved
it 6e-5 here).  Top-k is held on payloads without ties: the hinge dual's
box makes many |dalpha| exactly equal, and equal magnitudes may be kept
in either order, so D3CA runs top-k on the squared loss.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ADMMConfig as JADMM
from repro.core import D3CAConfig as JD3CA
from repro.core import RADiSAConfig as JRADiSA
from repro.core import SFKConfig as JSFK
from repro.core import get_solver as j_get_solver
from repro.core import compress as jc
from repro.core.admm import admm_schedule as j_admm_schedule
from repro.core.comm import CommSchedule as JSchedule
from repro.core.comm import SyncComm as JSync
from repro.core.d3ca import d3ca_schedule as j_d3ca_schedule
from repro.core.radisa import radisa_schedule as j_radisa_schedule
from repro.core.sfk import sfk_schedule as j_sfk_schedule
from repro_torch.core import (ADMMConfig, CommSchedule, D3CAConfig,
                              RADiSAConfig, SFKConfig, SyncComm, get_solver)
from repro_torch.core import compress as tc
from repro_torch.core.admm import admm_schedule
from repro_torch.core.d3ca import d3ca_schedule
from repro_torch.core.radisa import radisa_schedule
from repro_torch.core.sfk import sfk_schedule
from repro_torch.data import csr_from_dense
from repro_torch.launch import optimize
from test_torch_common import (d3ca_source, make_problem, radisa_source,
                               sfk_source)

RNG = np.random.default_rng(7)
TOL = dict(rtol=1e-5, atol=1e-5)
#: lossy codecs end to end, relative to the largest entry: two quanta of
#: int8 (see the module docstring)
LOSSY_REL = 2 / 127
CODECS = ["identity", "int8", "fp8", "topk:0.1", "topk:0.3", "topk:1"]


def _payload(shape, seed=0):
    """A continuous blocked payload whose cells differ in scale (so each
    cell's own scale matters), plus an error-feedback residual."""
    rng = np.random.default_rng(seed)
    scale = rng.uniform(0.1, 10.0, size=shape[:2] + (1,) * (len(shape) - 2))
    v = (rng.normal(size=shape) * scale).astype(np.float32)
    e = (rng.normal(size=shape) * 0.01).astype(np.float32)
    return v, e


# ---------------------------------------------------------------------------
# codecs: blocked payloads against the reference cell by cell
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(3, 2, 50), (2, 3, 4, 5), (1, 4, 7)])
@pytest.mark.parametrize("name", CODECS)
def test_codec_apply_matches_reference_cell_by_cell(name, shape):
    v, e = _payload(shape, seed=len(shape))
    port, ref = tc.get_codec(name), jc.get_codec(name)
    assert port.name == ref.name and port.stateful == ref.stateful
    deq, err = port.apply(torch.tensor(v), torch.tensor(e))
    for p in range(shape[0]):
        for q in range(shape[1]):
            j_deq, j_err = ref.apply(jnp.asarray(v[p, q]),
                                     jnp.asarray(e[p, q]))
            np.testing.assert_array_equal(deq[p, q].numpy(),
                                          np.asarray(j_deq))
            if ref.stateful:
                np.testing.assert_array_equal(err[p, q].numpy(),
                                              np.asarray(j_err))
    if not ref.stateful:
        assert err is None
    # the EF invariant: decoded + new residual == payload + old residual
    if port.stateful:
        np.testing.assert_allclose((deq + err).numpy(), v + e, rtol=1e-6,
                                   atol=1e-6)
    cell = shape[2:]
    for dtype in (torch.float32, "float32", np.int8):
        assert port.payload_nbytes(cell, dtype) == ref.payload_nbytes(
            cell, jnp.int8 if dtype is np.int8 else jnp.float32)


@pytest.mark.parametrize("name", ["int8", "fp8", "topk:0.25"])
def test_codec_encode_decode_match_reference(name):
    v, _ = _payload((3, 2, 40), seed=3)
    port, ref = tc.get_codec(name), jc.get_codec(name)
    wire = port.encode(torch.tensor(v))
    for p in range(3):
        for q in range(2):
            j_wire = ref.encode(jnp.asarray(v[p, q]))
            if name.startswith("topk"):
                # the kept set; the order of equal magnitudes is free
                order = np.argsort(wire[1][p, q].numpy())
                j_order = np.argsort(np.asarray(j_wire[1]))
                np.testing.assert_array_equal(
                    wire[1][p, q].numpy()[order],
                    np.asarray(j_wire[1])[j_order])
                np.testing.assert_array_equal(
                    wire[0][p, q].numpy()[order],
                    np.asarray(j_wire[0])[j_order])
            else:
                np.testing.assert_array_equal(
                    wire[0][p, q].float().numpy(),
                    np.asarray(j_wire[0].astype(jnp.float32)))
                assert float(wire[1][p, q]) == float(j_wire[1])
    deq = port.decode(wire, v.shape)
    np.testing.assert_array_equal(deq.numpy(),
                                  port.apply(torch.tensor(v))[0].numpy())
    assert deq.shape == v.shape and deq.dtype == torch.float32


def test_identity_codec_returns_the_same_tensor_and_is_stateless():
    c = tc.get_codec("identity")
    v = torch.tensor(RNG.normal(size=(2, 3, 33)), dtype=torch.float32)
    deq, err = c.apply(v)
    assert deq is v and err is None and not c.stateful
    assert isinstance(tc.get_codec("none"), tc.IdentityCodec)
    assert c.encode(v)[0] is v and c.decode((v,), v.shape) is v


def test_int8_bounded_error_per_cell_and_scale_on_device():
    c = tc.get_codec("int8")
    v = torch.tensor(RNG.normal(size=(2, 2, 64)) * 10, dtype=torch.float32)
    v[1, 1] *= 1e-3                      # a small cell keeps a small scale
    q, scale = c.encode(v)
    assert q.dtype == torch.int8 and scale.shape == (2, 2)
    assert isinstance(scale, torch.Tensor)
    deq, err = c.apply(v, torch.zeros_like(v))
    bound = v.abs().amax(dim=-1, keepdim=True) / 127.0 * 0.5 + 1e-6
    assert bool(((deq - v).abs() <= bound).all())
    np.testing.assert_allclose(err.numpy(), (v - deq).numpy(), atol=1e-7)


def test_topk_keeps_each_cells_largest_and_feeds_back_the_rest():
    c = tc.get_codec("topk:0.25")
    v = torch.tensor([[[0.1, -5.0, 0.2, 3.0, -0.3, 0.05, 7.0, -0.01],
                       [9.0, 0.1, 0.2, 0.3, -8.0, 0.0, 0.5, 0.6]]])
    deq, err = c.apply(v, torch.zeros_like(v))
    assert c.k_of(8) == 2
    assert set(torch.nonzero(deq[0, 0]).flatten().tolist()) == {1, 6}
    assert set(torch.nonzero(deq[0, 1]).flatten().tolist()) == {0, 4}
    np.testing.assert_allclose((deq + err).numpy(), v.numpy(), atol=1e-7)
    assert c.payload_nbytes((8,), torch.float32) == 16
    with pytest.raises(ValueError, match="fraction"):
        tc.TopKCodec(0.0)


def test_codec_registry_matches_reference():
    assert tc.available_codecs() == jc.available_codecs()
    for spec in ("identity", "none", "int8", "fp8", "topk", "topk:",
                 "topk:0.5", " INT8 "):
        assert tc.get_codec(spec).name == jc.get_codec(spec).name
    assert tc.get_codec("topk").frac == 0.1
    codec = tc.Int8Codec()
    assert tc.get_codec(codec) is codec
    with pytest.raises(ValueError, match="unknown codec"):
        tc.get_codec("int4")
    zero = tc.get_codec("int8").init_state((2, 3, 4), device="cpu")
    assert zero.shape == (2, 3, 4) and not zero.any()


# ---------------------------------------------------------------------------
# the legacy tree helpers
# ---------------------------------------------------------------------------

def test_tree_helpers_match_reference_bitwise():
    tree = {"a": RNG.normal(size=(32,)).astype(np.float32),
            "b": [RNG.normal(size=(3, 4)).astype(np.float32) * 5,
                  [RNG.normal(size=(2,)).astype(np.float32)]]}
    t_tree = jax.tree.map(torch.tensor, tree)
    j_tree = jax.tree.map(jnp.asarray, tree)
    t_err, j_err = tc.init_error(t_tree), jc.init_error(j_tree)
    for _ in range(3):
        t_q, t_s, t_err = tc.compress(t_tree, t_err)
        j_q, j_s, j_err = jc.compress(j_tree, j_err)
        for part_t, part_j in ((t_q, j_q), (t_s, j_s), (t_err, j_err),
                               (tc.decompress(t_q, t_s),
                                jc.decompress(j_q, j_s))):
            lt = jax.tree.leaves(jax.tree.map(lambda x: x.float().numpy(),
                                              part_t))
            lj = jax.tree.leaves(jax.tree.map(
                lambda x: np.asarray(x, np.float32), part_j))
            assert len(lt) == len(lj) == 3
            for a, b in zip(lt, lj):
                np.testing.assert_array_equal(a, b)
    assert t_q["a"].dtype == torch.int8 and t_s["a"].shape == ()


def test_error_feedback_accumulation_tracks_true_sum():
    g = {"a": torch.tensor(RNG.normal(size=(32,)), dtype=torch.float32)}
    e = tc.init_error(g)
    total_true = np.zeros(32)
    total_deq = np.zeros(32)
    for _ in range(50):
        q, s, e = tc.compress(g, e)
        total_true += g["a"].numpy()
        total_deq += tc.decompress(q, s)["a"].numpy()
    assert np.abs(total_true - total_deq).max() / 50 < 1e-2


def test_ef_sgd_converges_quadratic():
    target = torch.tensor(RNG.normal(size=(16,)), dtype=torch.float32)
    w = torch.zeros(16)
    e = tc.init_error({"w": w})
    for _ in range(200):
        q, s, e = tc.compress({"w": w - target}, e)
        w = w - 0.1 * tc.decompress(q, s)["w"]
    assert float((w - target).abs().max()) < 1e-2


# ---------------------------------------------------------------------------
# policies and adaptive schedules
# ---------------------------------------------------------------------------

SPECS = ["int8", "int8,rhs=identity", "dalpha=fp8,w_contrib=topk:0.2",
         "identity", "none", "topk", "w_contrib=int8,dalpha=identity",
         " fp8 , z=int8 "]


@pytest.mark.parametrize("spec", SPECS)
def test_policy_specs_match_reference(spec):
    port, ref = tc.as_policy(spec), jc.as_policy(spec)
    assert port.spec == ref.spec and repr(port) == repr(ref)
    for name in ("dalpha", "w_contrib", "z", "rhs", "other"):
        assert port.codec_for(name).name == ref.codec_for(name).name
    assert tc.CompressionPolicy.from_spec(port.spec).spec == port.spec


@pytest.mark.parametrize("spec,match", [
    ("a=int8,a=fp8", "assigned twice"), ("int8,fp8", "two default"),
    ("a=", "malformed"), ("=int8", "malformed"), ("int4", "unknown codec")])
def test_policy_spec_errors_match_reference(spec, match):
    for mod in (tc, jc):
        with pytest.raises(ValueError, match=match):
            mod.CompressionPolicy.from_spec(spec)


@pytest.mark.parametrize("which", ["d3ca", "radisa", "radisa-avg", "sfk",
                                   "admm"])
def test_policy_validates_against_each_solvers_schedule(which):
    port, ref = {
        "d3ca": (d3ca_schedule(), j_d3ca_schedule()),
        "radisa": (radisa_schedule(), j_radisa_schedule()),
        "radisa-avg": (radisa_schedule("avg"), j_radisa_schedule("avg")),
        "sfk": (sfk_schedule(), j_sfk_schedule()),
        "admm": (admm_schedule(), j_admm_schedule())}[which]
    assert port.names == ref.names
    for spec in ("int8", "identity", "topk:0.1", f"{port.names[0]}=int8"):
        assert tc.as_policy(spec).stateful_names(port) == \
            jc.as_policy(spec).stateful_names(ref)
        tc.as_policy(spec).validate(port)
    with pytest.raises(ValueError, match="never declares"):
        tc.as_policy("nope=int8").validate(port)


def test_as_policy_forms():
    p = tc.as_policy("int8,rhs=identity")
    assert tc.as_policy(None) is None and tc.as_policy(p) is p
    assert tc.as_policy({"default": "int8", "rhs": "identity"}).spec == \
        jc.as_policy({"default": "int8", "rhs": "identity"}).spec
    assert tc.as_policy(tc.Int8Codec()).spec == "int8"
    assert tc.identity_policy().spec == "identity"
    assert tc.as_compression(None) is None
    assert isinstance(tc.as_compression("int8"), tc.CompressionPolicy)
    assert isinstance(tc.as_compression(" adaptive"), tc.CompressionSchedule)
    sched = tc.CompressionSchedule()
    assert tc.as_compression(sched) is sched


@pytest.mark.parametrize("spec", [
    "adaptive", "adaptive:topk:0.1->int8",
    "adaptive:topk:0.25->int8->identity@slope=0.02@window=4",
    "adaptive@window=1", "adaptive:fp8@slope=0"])
def test_schedule_specs_match_reference(spec):
    port = tc.CompressionSchedule.from_spec(spec)
    ref = jc.CompressionSchedule.from_spec(spec)
    assert port.spec == ref.spec and repr(port) == repr(ref)
    assert [s.spec for s in port.stages] == [s.spec for s in ref.stages]
    assert tc.CompressionSchedule.from_spec(port.spec).spec == port.spec
    port.validate(d3ca_schedule())


@pytest.mark.parametrize("spec,match", [
    ("int8->identity", "adaptive"), ("adaptive@rate=2", "unknown adaptive"),
    ("adaptive@window=0", "window"), ("adaptive@slope=-1", "slope_tol")])
def test_schedule_spec_errors_match_reference(spec, match):
    for mod in (tc, jc):
        with pytest.raises(ValueError, match=match):
            mod.CompressionSchedule.from_spec(spec)


@pytest.mark.parametrize("values", [
    [1.0, 0.9], [1.0, 0.1, 0.01, 1e-3], [0.5, 0.5, 0.5, 0.5],
    [1.0, 0.8, 0.7, 0.65, 0.64], [0.0, 0.0, 0.0, 0.0], [2.0, 1.0, 0.5, 0.3]])
@pytest.mark.parametrize("window,slope", [(3, 0.05), (1, 0.2), (2, 0.0)])
def test_schedule_should_advance_matches_reference(values, window, slope):
    port = tc.CompressionSchedule(window=window, slope_tol=slope)
    ref = jc.CompressionSchedule(window=window, slope_tol=slope)
    assert port.should_advance(values) == ref.should_advance(values)


# ---------------------------------------------------------------------------
# the CompressedComm executor
# ---------------------------------------------------------------------------

def _port_cells(policy, vals, ef=None):
    """One psum over "data" of a blocked (P, 1, 8) payload."""
    sched = CommSchedule().psum("s", axis="data")
    comm = tc.CompressedComm(
        SyncComm(sched, {"data": vals.shape[0], "model": 1}, device="cpu",
                 payload_shapes={"s": (8,)}), policy, ef=ef)
    out = comm("s", vals)
    comm.finalize()
    return out, comm.ef_out, comm.wire_bytes["s"]


def _ref_cells(policy, vals, ef):
    sched = JSchedule().psum("s", axis="data")

    def cell(x, e):
        comm = jc.CompressedComm(JSync(sched, {"data": ("d",),
                                               "model": ("m",)},
                                       {"data": vals.shape[0], "model": 1}),
                                 policy, ef=e)
        out = comm("s", x)
        comm.finalize()
        return out, comm.ef_out

    return jax.vmap(jax.vmap(cell, axis_name="m"), axis_name="d")(
        jnp.asarray(vals), ef)


def test_compressed_comm_identity_is_an_exact_psum():
    vals = torch.tensor(RNG.normal(size=(3, 1, 8)), dtype=torch.float32)
    out, ef_out, wire = _port_cells(tc.as_policy("identity"), vals, ef={})
    assert torch.equal(out, vals.sum(dim=0)) and ef_out == {}
    assert wire == 8 * 4


@pytest.mark.parametrize("codec", ["int8", "fp8", "topk:0.5"])
def test_compressed_comm_reduces_decoded_values_and_updates_ef(codec):
    vals = (RNG.normal(size=(3, 1, 8)) * 5).astype(np.float32)
    ef = (RNG.normal(size=(3, 1, 8)) * 0.1).astype(np.float32)
    policy = tc.as_policy(codec)
    out, ef_out, wire = _port_cells(policy, torch.tensor(vals),
                                    ef={"s": torch.tensor(ef)})
    j_out, j_ef = _ref_cells(jc.as_policy(codec), vals,
                             {"s": jnp.asarray(ef)})
    # the reference's psum result sits in every cell; the port's once
    np.testing.assert_allclose(out.numpy(), np.asarray(j_out)[0], rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_array_equal(ef_out["s"].numpy(), np.asarray(j_ef["s"]))
    assert wire == policy.codec_for("s").payload_nbytes((8,), "float32")
    # the decoded payloads + new residuals are the payloads + old ones
    deq = torch.tensor(vals + ef) - ef_out["s"]
    np.testing.assert_allclose(out.numpy(), deq.sum(0).numpy(), rtol=1e-5,
                               atol=1e-5)
    # a stateful collective without its residual is refused, as the pod
    # path refuses a missing pod residual: error feedback never resets
    with pytest.raises(KeyError, match="'s'"):
        _port_cells(policy, torch.tensor(vals))


def test_comm_records_uncompressed_bytes_and_checks_declared_shapes():
    sched = CommSchedule().psum("s", axis="data")
    comm = SyncComm(sched, {"data": 2, "model": 1}, device="cpu",
                    payload_shapes={"s": (5,)})
    comm("s", torch.ones(2, 1, 5))
    assert comm.wire_bytes == {"s": 20}
    bad = SyncComm(sched, {"data": 2, "model": 1}, device="cpu",
                   payload_shapes={"s": (4,)})
    with pytest.raises(ValueError, match="declared"):
        bad("s", torch.ones(2, 1, 5))
    ident = tc.CompressedComm(SyncComm(sched, {"data": 2, "model": 1},
                                       device="cpu"), tc.as_policy("int8"))
    with pytest.raises(ValueError, match="never executed"):
        ident.finalize()


# ---------------------------------------------------------------------------
# wire accounting
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec", [None, "identity", "int8", "fp8",
                                  "topk:0.1", "dalpha=int8",
                                  "int8,w_contrib=topk:0.3"])
def test_wire_accounting_equals_reference(spec):
    shapes = {"dalpha": (400,), "w_contrib": (180,)}
    sizes = {"data": 4, "model": 2}
    port = tc.wire_accounting(d3ca_schedule(), shapes, sizes,
                              tc.as_policy(spec))
    ref = jc.wire_accounting(
        j_d3ca_schedule(),
        {k: jax.ShapeDtypeStruct(v, jnp.float32) for k, v in shapes.items()},
        sizes, jc.as_policy(spec))
    assert port == ref
    if spec in (None, "identity"):
        assert port["bytes_per_step"] == port["uncompressed_bytes_per_step"]
    if spec == "int8":
        assert port["bytes_per_step"] * 3 <= ref[
            "uncompressed_bytes_per_step"]


# ---------------------------------------------------------------------------
# the solver knob, the four solvers, dense and sparse
# ---------------------------------------------------------------------------

N, M, GRID, ITERS = 120, 37, (4, 2), 3

CASES = {
    "d3ca": (JD3CA, D3CAConfig, dict(lam=0.05, seed=3),
             lambda n: d3ca_source(3, n, iters=ITERS, grid=GRID)),
    "radisa": (JRADiSA, RADiSAConfig, dict(lam=0.05, gamma=0.05, seed=3),
               lambda n: radisa_source(3, n, iters=ITERS, grid=GRID)),
    "sfk": (JSFK, SFKConfig, dict(lam=0.05, gamma=0.05, seed=3),
            lambda n: sfk_source(3, n, 0.5, iters=ITERS, grid=GRID)),
    "admm": (JADMM, ADMMConfig, dict(lam=0.05, rho=0.05), lambda n: None),
}


def _problem(block_format):
    X, y = make_problem(N, M, seed=2)
    if block_format == "sparse":
        X = np.where(np.random.default_rng(3).random(X.shape) < 0.3, X,
                     0.0).astype(np.float32)
    return X, y


def solve_pair(name, block_format, compression=None, topology=None,
               f_star=None, iters=ITERS, loss="hinge"):
    """The port and the reference on one problem under one set of knobs,
    the reference's streams injected; returns (port, reference)."""
    JCfg, TCfg, kw, source = CASES[name]
    X, y = _problem(block_format)
    kw = dict(kw, outer_iters=iters)
    res_j = j_get_solver(name)(
        engine="simulated", block_format=block_format,
        compression=compression, topology=topology).solve(
        loss, X, y, P=GRID[0], Q=GRID[1], cfg=JCfg(**kw), f_star=f_star)
    Xt = csr_from_dense(X) if block_format == "sparse" else X
    res_t = get_solver(name)(
        device="cpu", block_format=block_format, compression=compression,
        topology=topology, index_source=source(N)).solve(
        loss, Xt, y, P=GRID[0], Q=GRID[1], cfg=TCfg(**kw), f_star=f_star)
    return res_t, res_j


def assert_close(res_t, res_j, tol=None):
    """Iterates at ``tol``, or within LOSSY_REL of the largest entry when
    ``tol`` is None (lossy codecs), and the history entry by entry."""
    pairs = [(res_t.w, res_j.w)]
    if res_j.alpha is not None:
        pairs.append((res_t.alpha, res_j.alpha))
    for got, want in pairs:
        got, want = got.numpy(), np.asarray(want)
        if tol is not None:
            np.testing.assert_allclose(got, want, **tol)
        else:
            assert np.abs(got - want).max() <= \
                LOSSY_REL * np.abs(want).max()
    for h_t, h_j in zip(res_t.history, res_j.history, strict=True):
        np.testing.assert_allclose(h_t["objective"], h_j["objective"],
                                   rtol=1e-5 if tol is not None else 1e-3)
        assert h_t["comm_bytes"] == h_j["comm_bytes"]


@pytest.mark.parametrize("block_format", ["dense", "sparse"])
@pytest.mark.parametrize("name", ["d3ca", "radisa", "sfk", "admm"])
def test_none_is_bitwise_identity_and_both_match_reference(name,
                                                           block_format):
    runs = {}
    for comp in (None, "identity"):
        res_t, res_j = solve_pair(name, block_format, compression=comp)
        assert_close(res_t, res_j, TOL)
        assert res_t.comm_bytes == res_j.comm_bytes
        assert res_t.compression == res_j.compression
        runs[comp] = res_t
    assert torch.equal(runs[None].w, runs["identity"].w)
    if runs[None].alpha is not None:
        assert torch.equal(runs[None].alpha, runs["identity"].alpha)
    acct = runs[None].comm_bytes
    assert acct["bytes_per_step"] == acct["uncompressed_bytes_per_step"]
    assert [h["comm_bytes"] for h in runs[None].history] == [
        acct["bytes_per_step"] * t for t in range(1, ITERS + 1)]


@pytest.mark.parametrize("block_format", ["dense", "sparse"])
@pytest.mark.parametrize("codec", ["int8", "fp8", "topk:0.2"])
@pytest.mark.parametrize("name", ["d3ca", "radisa", "sfk", "admm"])
def test_lossy_codecs_match_reference(name, codec, block_format):
    loss = "squared" if (name, codec) == ("d3ca", "topk:0.2") else "hinge"
    res_t, res_j = solve_pair(name, block_format, compression=codec,
                              loss=loss)
    assert_close(res_t, res_j)
    assert res_t.comm_bytes == res_j.comm_bytes
    assert res_t.compression == res_j.compression == codec
    assert res_t.comm_bytes["bytes_per_step"] < \
        res_t.comm_bytes["uncompressed_bytes_per_step"]


@pytest.mark.parametrize("name", ["d3ca", "radisa"])
def test_program_carries_ef_residuals_and_wire_accounting(name):
    X, y = _problem("dense")
    JCfg, TCfg, kw, source = CASES[name]
    solver = get_solver(name)(device="cpu", compression="int8,z=identity"
                              if name == "radisa" else "int8",
                              index_source=source(N))
    prog = solver.program("hinge", X, y, P=GRID[0], Q=GRID[1],
                          cfg=TCfg(**kw, outer_iters=2))
    ef = prog.ef_of(prog.state)
    names = ("dalpha", "w_contrib") if name == "d3ca" else ("grad", "dw")
    assert tuple(ef) == names
    assert all(not v.any() and v.shape[:2] == GRID for v in ef.values())
    state = prog.step(1, prog.state)
    assert all(v.abs().max() > 0 for v in prog.ef_of(state).values())
    assert prog.comm_bytes["compression"] == solver.compression_spec
    plain = get_solver(name)(device="cpu", index_source=source(N)).program(
        "hinge", X, y, P=GRID[0], Q=GRID[1], cfg=TCfg(**kw, outer_iters=2))
    assert plain.ef_of is None and isinstance(plain.state,
                                              (tuple, torch.Tensor))


def test_adaptive_stages_and_history_match_reference():
    """An adaptive schedule on one instance: the same stage switches, the
    same codecs per entry, the same cumulative bytes, iterates at 1e-4."""
    X, y = _problem("dense")
    spec = "adaptive:topk:0.3->int8->identity@slope=0.2@window=1"
    f_star = 0.2
    res_t, res_j = solve_pair("d3ca", "dense", compression=spec,
                              f_star=f_star, iters=6)
    key = [(h["iter"], h["stage"], h["codec"], h["comm_bytes"])
           for h in res_j.history]
    assert [(h["iter"], h["stage"], h["codec"], h["comm_bytes"])
            for h in res_t.history] == key
    assert len({k[1] for k in key}) >= 2          # it did advance
    assert res_t.compression == res_j.compression
    assert res_t.iters == res_j.iters == 6
    assert_close(res_t, res_j)


def test_solver_knob_errors_and_specs():
    X, y = _problem("dense")
    s = get_solver("d3ca")(device="cpu", compression="dw=int8")
    with pytest.raises(ValueError, match="never declares"):
        s.solve("hinge", X, y, P=2, Q=2, cfg=D3CAConfig(outer_iters=1))
    assert get_solver("d3ca")(device="cpu").compression_spec is None
    s = get_solver("d3ca")(device="cpu", compression="adaptive")
    assert s.compression_spec == jc.as_compression("adaptive").spec
    assert s.active_policy.spec == "topk:0.25"


def test_update_under_a_codec_starts_from_zero_error_feedback():
    """``Solver.update`` rebuilds its program under a codec (the cache is
    bypassed), so two updates from one warm start agree bitwise, and
    they match the reference's update."""
    X, y = make_problem(36, 16, seed=1)
    touched = np.arange(4, 14)
    warm = (np.zeros(16, np.float32), np.zeros(36, np.float32))
    kw = dict(lam=0.05, local_steps=6, seed=2)
    solver = get_solver("d3ca")(
        device="cpu", compression="int8",
        index_source=d3ca_source(2, 36, iters=2, steps=6, grid=(3, 2)))
    a, b = (solver.update("hinge", X, y, touched=touched, warm_start=warm,
                          P=3, Q=2, cfg=D3CAConfig(**kw), passes=2)
            for _ in range(2))
    assert torch.equal(a.w, b.w) and solver._prog_cache == {}
    ref = j_get_solver("d3ca")(compression="int8").update(
        "hinge", X, y, touched=touched, warm_start=warm, P=3, Q=2,
        cfg=JD3CA(**kw), passes=2)
    assert_close(a, ref)


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("solver", ["d3ca", "radisa", "admm"])
def test_cli_compression_reports_exact_wire_bytes(solver, capsys):
    small = ["--mesh", "4x2", "--n", "200", "--m", "60", "--iters", "3",
             "--ref-epochs", "0", "--device", "cpu", "--solver", solver]
    base = optimize.main(small)
    summary = optimize.main([*small, "--compression", "int8"])
    assert summary["compression"] == "int8" and base["compression"] is None
    assert summary["comm_bytes_total"] == 3 * summary["comm_bytes_per_step"]
    assert summary["comm_bytes_per_step"] * 3 <= base["comm_bytes_per_step"]
    out = capsys.readouterr().out
    assert "compression=int8" in out and "[optimize] wire:" in out
    assert np.isfinite(summary["objective"])


def test_cli_adaptive_prints_the_canonical_spec(capsys):
    optimize.main(["--mesh", "4x2", "--n", "200", "--m", "60", "--iters",
                   "4", "--ref-epochs", "20", "--device", "cpu",
                   "--compression", "adaptive"])
    assert ("compression=" + jc.as_compression("adaptive").spec
            in capsys.readouterr().out)


def test_cli_fanout_refuses_compression_as_the_reference(capsys):
    with pytest.raises(SystemExit) as exc:
        optimize.main(["--problems", "2", "--mesh", "2x2", "--n", "40",
                       "--m", "12", "--iters", "1", "--device", "cpu",
                       "--compression", "int8"])
    assert exc.value.code == 2
    assert "do not support compression" in capsys.readouterr().err

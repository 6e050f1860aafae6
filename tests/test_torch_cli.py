"""The port's CLI and its device / not-ported rules (CPU); the cases of
the mesh engines run on CPU process grids over gloo."""
import json

import numpy as np
import pytest
import torch

from repro_torch.core import (D3CAConfig, Solver, available_solvers,
                              get_solver, partition, serial_sdca)
from repro_torch.core.util import resolve_device
from repro_torch.launch import optimize
from repro_torch.launch.mesh import close_grids, process_grid
from repro_torch.obs import load_bundle
from test_torch_common import (MESH_GRID_TIMEOUT, bounded,  # noqa: F401
                               make_problem)

SMALL = ["--mesh", "3x2", "--n", "200", "--m", "60", "--iters", "3",
         "--device", "cpu"]
#: the expectation of a refusal case whose flag is now ported: it runs
PORTED = object()
SUMMARY_KEYS = {"solver", "engine", "local_backend", "device",
                "block_format", "P", "Q", "n", "m", "loss", "lam", "iters",
                "converged", "objective", "rel_opt", "total_s",
                # the reference's comm fields (its summary has them too)
                "staleness", "compression", "topology",
                "comm_bytes_per_step", "comm_bytes_total"}


pytestmark = pytest.mark.usefixtures("bounded")


@pytest.fixture(scope="module", autouse=True)
def _process_grid():
    """The mesh cases of this module run on the memoized CPU process grid
    of 3 x 2 ranks, started here with the short MESH_GRID_TIMEOUT; its
    ranks stop when the module ends."""
    process_grid(3, 2, device="cpu", timeout=MESH_GRID_TIMEOUT)
    yield
    close_grids()


@pytest.mark.parametrize("solver", ["d3ca", "radisa", "sfk"])
@pytest.mark.parametrize("backend", ["kernel", "ref"])
def test_cli_runs_and_reports(solver, backend, tmp_path, capsys):
    out = tmp_path / "run.json"
    summary = optimize.main(["--solver", solver, "--backend", backend,
                             "--ref-epochs", "5", "--json-out", str(out),
                             *SMALL])
    assert set(summary) == SUMMARY_KEYS
    assert (summary["solver"], summary["engine"], summary["local_backend"],
            summary["device"], summary["P"], summary["Q"], summary["n"],
            summary["m"], summary["iters"]) == (
        solver, "simulated", backend, "cpu", 3, 2, 200, 60, 3)
    assert np.isfinite(summary["objective"])
    assert np.isfinite(summary["rel_opt"])
    saved = json.loads(out.read_text())
    assert saved["summary"] == summary and len(saved["history"]) == 3
    assert ("duality_gap" in saved["history"][0]) == (solver == "d3ca")
    printed = capsys.readouterr().out
    assert f"[optimize] {solver} engine=simulated backend={backend}" in printed
    assert printed.count("  t=") == 3 and "rel_opt=" in printed


@pytest.mark.parametrize("solver", ["d3ca", "radisa", "sfk"])
def test_cli_sparse_block_format(solver, capsys):
    summary = optimize.main([
        "--solver", solver, "--dataset", "sparse", "--density", "0.05",
        "--n", "96", "--m", "40", "--block-format", "sparse", "--iters",
        "2", "--ref-epochs", "5", "--mesh", "4x2", "--device", "cpu"])
    assert (summary["block_format"], summary["n"], summary["m"]) == (
        "sparse", 96, 40)
    assert np.isfinite(summary["objective"])
    assert np.isfinite(summary["rel_opt"])    # n * m is small: f* is run
    assert "block_format=sparse" in capsys.readouterr().out
    # the same data through dense blocks (densified from the generator)
    dense = optimize.main([
        "--solver", solver, "--dataset", "sparse", "--density", "0.05",
        "--n", "96", "--m", "40", "--iters", "2", "--ref-epochs", "0",
        "--mesh", "4x2", "--device", "cpu"])
    assert dense["block_format"] == "dense" and np.isfinite(
        dense["objective"])


@pytest.mark.parametrize("block_format", ["dense", "sparse"])
def test_cli_libsvm_dataset(block_format, tmp_path):
    from repro_torch.data import save_libsvm
    X, y = make_problem(60, 20, seed=3)
    X[np.abs(X) < 0.8] = 0.0
    path = tmp_path / "train.svm"
    save_libsvm(str(path), X, y)
    summary = optimize.main([
        "--solver", "d3ca", "--dataset", "libsvm", "--libsvm-path",
        str(path), "--block-format", block_format, "--mesh", "2x2",
        "--iters", "2", "--ref-epochs", "3", "--device", "cpu"])
    assert (summary["n"], summary["block_format"]) == (60, block_format)
    assert summary["m"] == int(np.flatnonzero(X.any(0)).max()) + 1
    assert np.isfinite(summary["objective"]) and np.isfinite(
        summary["rel_opt"])


def test_cli_ref_epochs_zero_skips_rel_opt_and_logistic_needs_ref():
    summary = optimize.main(["--solver", "d3ca", "--ref-epochs", "0", *SMALL])
    assert summary["rel_opt"] is None
    with pytest.raises(NotImplementedError, match="local_backend='ref'"):
        optimize.main(["--solver", "d3ca", "--loss", "logistic",
                       "--ref-epochs", "0", *SMALL])
    summary = optimize.main(["--solver", "d3ca", "--loss", "logistic",
                             "--backend", "ref", "--ref-epochs", "0", *SMALL])
    assert np.isfinite(summary["objective"])


def test_cli_early_stop():
    summary = optimize.main(["--solver", "d3ca", "--ref-epochs", "0",
                             "--tol", "10.0", *SMALL])
    assert summary["converged"] and summary["iters"] == 1


#: the expectation of a refusal case whose mesh engine is now ported: it
#: runs on a CPU process grid
MESH = object()


@pytest.mark.parametrize("flags,named", [
    # the mesh engines are ported: these run on a CPU process grid (MESH)
    pytest.param(["--engine", "shard_map"], MESH, id="flags0---engine"),
    pytest.param(["--engine", "async", "--staleness", "2"], MESH,
                 id="flags1---engine"),
    # staleness needs the async engines: the reference's refusal
    pytest.param(["--staleness", "1"],
                 "--staleness 1 only works with --engine async",
                 id="flags2---staleness"),
    pytest.param(["--compression", "int8", "--engine", "async"], MESH,
                 id="flags3---compression"),
    # pods=2 does not divide the 3 rows of SMALL's grid: the reference's
    # ValueError, on the mesh as on the grid engine
    pytest.param(["--topology", "pods=2:int8", "--engine", "shard_map"],
                 (ValueError, "topology pods=2 must divide P=3"),
                 id="flags4---topology"),
    pytest.param(["--block-format", "sparse", "--engine", "shard_map"], MESH,
                 id="flags5---engine"),
    (["--block-format", "csc"], "--block-format"),
    (["--dataset", "libsvm"], "--dataset libsvm needs --libsvm-path"),
    # the fan-out is ported; it takes synthetic instances only
    (["--problems", "4", "--dataset", "libsvm"], "--problems"),
    pytest.param(["--force-host-devices", "6"], MESH,
                 id="flags9---force-host-devices"),
    # the observability flags, once refused, run (PORTED: see below)
    pytest.param(["--trace", "TRACE"], PORTED, id="flags10---trace"),
    pytest.param(["--metrics"], PORTED, id="flags11---metrics"),
    pytest.param(["--listen", "127.0.0.1:0"], PORTED,
                 id="flags12---listen"),
    pytest.param(["--health"], PORTED, id="flags13---health"),
    pytest.param(["--flight-recorder", "BUNDLE"], PORTED,
                 id="flags14---flight-recorder"),
    # ADMM, its comm policies and its mesh engines are ported
    pytest.param(["--solver", "admm", "--compression", "int8", "--engine",
                  "shard_map"], MESH, id="flags15-admm"),
    pytest.param(["--solver", "admm", "--block-format", "sparse",
                  "--engine", "shard_map"], MESH, id="flags16-admm"),
    (["--solver", "nope"], "unknown solver"),
    (["--backend", "pallas"], "--backend"),
])
def test_cli_rejects_unported_flags_by_name(flags, named, capsys, tmp_path):
    """A flag of a layer that is not ported exits 2 naming it; a flag
    whose layer is now ported (``PORTED``, ``MESH``) runs, and its case
    checks what it made; a flag the reference refuses with a
    ``ValueError`` for this input (``(ValueError, text)``) raises it."""
    if named is PORTED:
        return _check_observability_flag(flags, tmp_path, capsys)
    if named is MESH:
        return _check_mesh_flag(flags)
    if isinstance(named, tuple):
        with pytest.raises(named[0], match=named[1]):
            optimize.main([*flags, *SMALL])
        return
    with pytest.raises(SystemExit) as exc:
        optimize.main([*flags, *SMALL])
    assert exc.value.code == 2
    err = capsys.readouterr().err
    assert named in err
    if named not in ("unknown solver", "--backend", "--block-format",
                     "--dataset libsvm needs --libsvm-path", "--problems",
                     "--staleness 1 only works with --engine async"):
        assert "ROADMAP" in err


def _check_mesh_flag(flags):
    """A flag of the mesh engines runs the solve on a CPU process grid of
    SMALL's 3 x 2 ranks: its engine and staleness in the summary, the
    grid engine's exact wire bytes a step, and (at staleness 0) the grid
    engine's objective within 1e-5."""
    got = optimize.main([*flags, *SMALL])
    opts = dict(zip(flags[::2], flags[1::2]))
    engine = opts.pop("--engine", "simulated")
    tau = int(opts.pop("--staleness", 0))
    opts.pop("--force-host-devices", None)
    plain = optimize.main([*(a for kv in opts.items() for a in kv), *SMALL])
    assert (got["engine"], got["staleness"]) == (engine, tau)
    assert got["comm_bytes_per_step"] == plain["comm_bytes_per_step"]
    assert got["block_format"] == plain["block_format"]
    if tau:
        assert np.isfinite(got["objective"])
    else:
        np.testing.assert_allclose(got["objective"], plain["objective"],
                                   rtol=1e-5)


@pytest.mark.parametrize("kw,named", [
    # the mesh engines are ported: each knob runs on a CPU process grid
    pytest.param(dict(engine="shard_map"), MESH,
                 id="kw0-engine='shard_map'"),
    pytest.param(dict(engine="async"), MESH, id="kw1-engine='async'"),
    pytest.param(dict(block_format="sparse", engine="shard_map"), MESH,
                 id="kw2-engine='shard_map'"),
    pytest.param(dict(staleness=2, engine="async"), MESH,
                 id="kw3-staleness=2"),
    pytest.param(dict(compression="int8", engine="shard_map"), MESH,
                 id="kw4-compression='int8'"),
    # pods=2 does not divide P=3: the reference's ValueError
    pytest.param(dict(topology="pods=2", engine="overlap"),
                 "topology pods=2 must divide P=3",
                 id="kw5-topology='pods=2'"),
])
def test_solver_rejects_unported_knobs_by_name(kw, named):
    """The knobs of the mesh engines, once refused by name, run on a CPU
    process grid of 3 x 2 ranks (``MESH``): the grid engine's wire bytes,
    and at staleness 0 its iterates within 1e-5; a knob the reference
    refuses for this input raises its ``ValueError``."""
    X, y = make_problem(60, 20, seed=5)
    cfg = D3CAConfig(lam=0.1, outer_iters=3)
    solver = get_solver("d3ca")(device="cpu", **kw)
    if named is not MESH:
        with pytest.raises(ValueError, match=named):
            solver.solve("hinge", X, y, P=3, Q=2, cfg=cfg)
        return
    got = solver.solve("hinge", X, y, P=3, Q=2, cfg=cfg)
    grid_kw = {k: v for k, v in kw.items() if k not in ("engine",
                                                       "staleness")}
    want = get_solver("d3ca")(device="cpu", **grid_kw).solve(
        "hinge", X, y, P=3, Q=2, cfg=cfg)
    assert (got.engine, got.staleness) == (kw["engine"],
                                           kw.get("staleness", 0))
    assert got.comm_bytes == want.comm_bytes
    if not got.staleness:
        np.testing.assert_allclose(got.w, want.w, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got.alpha, want.alpha, rtol=1e-5,
                                   atol=1e-5)
    else:
        assert torch.isfinite(got.w).all()


def _check_observability_flag(flags, tmp_path, capsys):
    """An observability flag of the reference's CLI runs the solve under
    it and reports what it made; the iterates are those of the plain
    run."""
    key = flags[0]
    flags = [str(tmp_path / "t.json") if f == "TRACE" else
             str(tmp_path / "b.json") if f == "BUNDLE" else f for f in flags]
    plain = optimize.main(SMALL)
    got = optimize.main([*flags, *SMALL])
    assert got["objective"] == plain["objective"]
    out = capsys.readouterr().out
    if key == "--trace":
        events = json.loads((tmp_path / "t.json").read_text())["traceEvents"]
        assert sum(e["name"] == "outer_iter" for e in events) == 3
        assert (tmp_path / "t.jsonl").exists() and "[optimize] trace" in out
        assert "[optimize] phases: local" in out
    elif key == "--metrics":
        assert got["metrics"]["counters"][
            "solver/iters{engine=simulated,solver=d3ca}"] == 3.0
    elif key == "--listen":
        assert got["obs"]["listen"].startswith("http://127.0.0.1:")
        assert "metrics" in got and "[obs] serving" in out
    elif key == "--health":
        assert got["obs"]["health"]["status"] in ("ok", "warn")
    else:
        assert got["obs"]["flight_recorder"]["bundle"] == \
            str(tmp_path / "b.json")
        assert load_bundle(str(tmp_path / "b.json"))["reason"] == "exit"


def test_solver_rejects_unported_calls_by_name():
    X, y = make_problem(40, 12)
    solver = get_solver("d3ca")(device="cpu")
    cfg = D3CAConfig(outer_iters=1)
    # a mesh is for the mesh engines, and it is a process grid
    with pytest.raises(ValueError, match="mesh= needs engine="):
        solver.solve("hinge", X, y, P=2, Q=2, cfg=cfg, mesh=object())
    with pytest.raises(TypeError, match="ProcessGrid"):
        get_solver("d3ca")(device="cpu", engine="shard_map").solve(
            "hinge", X, y, P=2, Q=2, cfg=cfg, mesh=object())
    # the mesh engines take the comm policies; an unknown engine is the
    # reference's ValueError
    s = get_solver("admm")(device="cpu", engine="async",
                           compression="int8")
    assert (s.engine, s.compression_spec) == ("async", "int8")
    with pytest.raises(ValueError, match="engine='nope'; expected one of"):
        get_solver("admm")(device="cpu", engine="nope")
    with pytest.raises(KeyError, match="available"):
        get_solver("nope")
    with pytest.raises(ValueError, match="local_backend"):
        get_solver("d3ca")(local_backend="pallas", device="cpu")
    with pytest.raises(ValueError, match="needs P and Q"):
        solver.solve("hinge", X, y, cfg=cfg)
    assert available_solvers() == ["admm", "d3ca", "radisa", "sfk"]
    assert issubclass(get_solver("radisa"), Solver)
    assert issubclass(get_solver("sfk"), Solver)


@pytest.mark.parametrize("name", ["d3ca", "radisa"])
def test_program_cache_equals_an_uncached_solve(name):
    """``program_cache=True`` reuses the built step across solves of one
    key and changes no number: every solve equals the uncached one, bit
    for bit, and a second key (another shape) gets an entry of its own."""
    X, y = make_problem(40, 12)
    cfg = get_solver(name).config_cls(lam=0.1, outer_iters=3)
    plain = get_solver(name)(device="cpu").solve("hinge", X, y, P=2, Q=2,
                                                 cfg=cfg)
    cached = get_solver(name)(device="cpu", program_cache=True)
    for _ in range(2):
        res = cached.solve("hinge", X, y, P=2, Q=2, cfg=cfg)
        assert torch.equal(res.w, plain.w)
        assert [h["objective"] for h in res.history] == \
            [h["objective"] for h in plain.history]
    assert len(cached._prog_cache) == 1
    entry = next(iter(cached._prog_cache.values()))
    # the step and its collective-free timing twin, as in the reference
    assert set(entry) == {"step", "local"}
    cached.solve("hinge", X[:30], y[:30], P=2, Q=2, cfg=cfg)
    assert len(cached._prog_cache) == 2


def test_default_device_is_the_card_and_is_never_swapped_for_the_cpu():
    """With no CUDA device every entry point left at its default raises;
    it does not run on the CPU instead."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the rule under test "
                    "is what happens without one")
    X, y = make_problem(40, 12)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        get_solver("d3ca")()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Solver(device="cuda")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        partition(X, y, 2, 2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serial_sdca("hinge", X, y, lam=0.1, epochs=1)
    with pytest.raises(RuntimeError, match="--device cpu"):
        optimize.main(["--mesh", "2x2", "--n", "40", "--m", "12",
                       "--iters", "1"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device("cuda:0")
    assert resolve_device("cpu") == torch.device("cpu")


def test_kernel_build_refuses_without_a_compiler(monkeypatch, tmp_path):
    """On a machine without nvcc the build says so; it does not fall
    back to the plain versions."""
    from repro_torch.kernels import _build
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.delenv("CUDA_PATH", raising=False)
    if (_build.Path("/usr/local/cuda") / "bin" / "nvcc").exists():
        pytest.skip("a CUDA toolkit is installed")
    with pytest.raises(RuntimeError, match="no nvcc was found"):
        _build._find_nvcc()
    assert len(_build._source_hash(_build._sources())) == 16


def test_ctypes_signatures_match_the_c_entry_points():
    """Every C entry point's parameter list, read from the source, is what
    ctypes is told: a pointer as c_void_p, int as c_int, float as c_float."""
    import ctypes
    import re
    from repro_torch.kernels import _build
    text = "".join(p.read_text() for p in _build._sources())
    for name, argtypes in _build._SIGNATURES.items():
        params = re.search(r'extern "C" int %s\((.*?)\)\s*{' % name, text,
                           re.S).group(1).split(",")
        want = [ctypes.c_void_p if "*" in p else
                ctypes.c_float if "float" in p else ctypes.c_int
                for p in params]
        assert want == list(argtypes), name

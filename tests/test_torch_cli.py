"""The port's CLI and its device / not-ported rules (CPU)."""
import json

import numpy as np
import pytest
import torch

from repro_torch.core import (D3CAConfig, Solver, available_solvers,
                              get_solver, partition, serial_sdca)
from repro_torch.core.util import resolve_device
from repro_torch.launch import optimize
from repro_torch.obs import load_bundle
from test_torch_common import make_problem

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


@pytest.mark.parametrize("flags,named", [
    (["--engine", "shard_map"], "--engine"),
    (["--engine", "async", "--staleness", "2"], "--engine"),
    # staleness needs the async engines: the reference's refusal
    pytest.param(["--staleness", "1"],
                 "--staleness 1 only works with --engine async",
                 id="flags2---staleness"),
    # the comm policies are ported; beside a mesh engine the engine is not
    pytest.param(["--compression", "int8", "--engine", "async"], "--engine",
                 id="flags3---compression"),
    pytest.param(["--topology", "pods=2:int8", "--engine", "shard_map"],
                 "--engine", id="flags4---topology"),
    (["--block-format", "sparse", "--engine", "shard_map"], "--engine"),
    (["--block-format", "csc"], "--block-format"),
    (["--dataset", "libsvm"], "--dataset libsvm needs --libsvm-path"),
    # the fan-out is ported; it takes synthetic instances only
    (["--problems", "4", "--dataset", "libsvm"], "--problems"),
    (["--force-host-devices", "6"], "--force-host-devices"),
    # the observability flags, once refused, run (PORTED: see below)
    pytest.param(["--trace", "TRACE"], PORTED, id="flags10---trace"),
    pytest.param(["--metrics"], PORTED, id="flags11---metrics"),
    pytest.param(["--listen", "127.0.0.1:0"], PORTED,
                 id="flags12---listen"),
    pytest.param(["--health"], PORTED, id="flags13---health"),
    pytest.param(["--flight-recorder", "BUNDLE"], PORTED,
                 id="flags14---flight-recorder"),
    # ADMM and its comm policies are ported; its mesh knobs are not
    pytest.param(["--solver", "admm", "--compression", "int8", "--engine",
                  "shard_map"], "--engine", id="flags15-admm"),
    pytest.param(["--solver", "admm", "--block-format", "sparse",
                  "--engine", "shard_map"], "--engine", id="flags16-admm"),
    (["--solver", "nope"], "unknown solver"),
    (["--backend", "pallas"], "--backend"),
])
def test_cli_rejects_unported_flags_by_name(flags, named, capsys, tmp_path):
    """A flag of a layer that is not ported exits 2 naming it; a flag
    whose layer is now ported (``PORTED``) runs, and its case checks what
    it made."""
    if named is PORTED:
        return _check_observability_flag(flags, tmp_path, capsys)
    with pytest.raises(SystemExit) as exc:
        optimize.main([*flags, *SMALL])
    assert exc.value.code == 2
    err = capsys.readouterr().err
    assert named in err
    if named not in ("unknown solver", "--backend", "--block-format",
                     "--dataset libsvm needs --libsvm-path", "--problems",
                     "--staleness 1 only works with --engine async"):
        assert "ROADMAP" in err


@pytest.mark.parametrize("kw,named", [
    (dict(engine="shard_map"), "engine='shard_map'"),
    (dict(engine="async"), "engine='async'"),
    (dict(block_format="sparse", engine="shard_map"), "engine='shard_map'"),
    # staleness and the comm policies beside an engine that is not ported
    pytest.param(dict(staleness=2, engine="async"), "engine='async'",
                 id="kw3-staleness=2"),
    pytest.param(dict(compression="int8", engine="shard_map"),
                 "engine='shard_map'", id="kw4-compression='int8'"),
    pytest.param(dict(topology="pods=2", engine="overlap"),
                 "engine='overlap'", id="kw5-topology='pods=2'"),
])
def test_solver_rejects_unported_knobs_by_name(kw, named):
    with pytest.raises(NotImplementedError, match="ROADMAP") as exc:
        get_solver("d3ca")(device="cpu", **kw)
    assert named in str(exc.value)


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
    with pytest.raises(NotImplementedError, match="mesh"):
        solver.solve("hinge", X, y, P=2, Q=2, cfg=cfg, mesh=object())
    with pytest.raises(NotImplementedError, match="engine='async'"):
        get_solver("admm")(device="cpu", engine="async",
                           compression="int8")
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

"""The port's CLI and its device / not-ported rules (CPU)."""
import json

import numpy as np
import pytest
import torch

from repro_torch.core import (D3CAConfig, Solver, available_solvers,
                              get_solver, partition, serial_sdca)
from repro_torch.core.util import resolve_device
from repro_torch.launch import optimize
from test_torch_common import make_problem

SMALL = ["--mesh", "3x2", "--n", "200", "--m", "60", "--iters", "3",
         "--device", "cpu"]
SUMMARY_KEYS = {"solver", "engine", "local_backend", "device",
                "block_format", "P", "Q", "n", "m", "loss", "lam", "iters",
                "converged", "objective", "rel_opt", "total_s"}



@pytest.mark.parametrize("solver", ["d3ca", "radisa"])
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
    (["--staleness", "1"], "--staleness"),
    (["--compression", "int8"], "--compression"),
    (["--topology", "pods=2:int8"], "--topology"),
    (["--block-format", "sparse"], "--block-format"),
    (["--dataset", "sparse"], "--dataset sparse"),
    (["--dataset", "libsvm", "--libsvm-path", "x.svm"], "--dataset libsvm"),
    (["--libsvm-path", "x.svm"], "--libsvm-path"),
    (["--problems", "4"], "--problems"),
    (["--force-host-devices", "6"], "--force-host-devices"),
    (["--trace", "t.json"], "--trace"),
    (["--metrics"], "--metrics"),
    (["--listen", "127.0.0.1:0"], "--listen"),
    (["--health"], "--health"),
    (["--flight-recorder", "fr"], "--flight-recorder"),
    (["--solver", "sfk"], "sfk"),
    (["--solver", "admm"], "admm"),
    (["--solver", "nope"], "unknown solver"),
    (["--backend", "pallas"], "--backend"),
])
def test_cli_rejects_unported_flags_by_name(flags, named, capsys):
    with pytest.raises(SystemExit) as exc:
        optimize.main([*flags, *SMALL])
    assert exc.value.code == 2
    err = capsys.readouterr().err
    assert named in err
    if named not in ("unknown solver", "--backend"):
        assert "ROADMAP" in err


@pytest.mark.parametrize("kw,named", [
    (dict(engine="shard_map"), "engine='shard_map'"),
    (dict(engine="async"), "engine='async'"),
    (dict(block_format="sparse"), "block_format='sparse'"),
    (dict(staleness=2), "staleness=2"),
    (dict(compression="int8"), "compression='int8'"),
    (dict(topology="pods=2"), "topology='pods=2'"),
    (dict(program_cache=True), "program_cache=True"),
])
def test_solver_rejects_unported_knobs_by_name(kw, named):
    with pytest.raises(NotImplementedError, match="ROADMAP") as exc:
        get_solver("d3ca")(device="cpu", **kw)
    assert named in str(exc.value)


def test_solver_rejects_unported_calls_by_name():
    X, y = make_problem(40, 12)
    solver = get_solver("d3ca")(device="cpu")
    cfg = D3CAConfig(outer_iters=1)
    for kw in (dict(tracer=object()), dict(registry=object()),
               dict(monitor=object()), dict(row_gate=np.ones(40)),
               dict(mesh=object())):
        with pytest.raises(NotImplementedError, match=next(iter(kw))):
            solver.solve("hinge", X, y, P=2, Q=2, cfg=cfg, **kw)
    with pytest.raises(NotImplementedError, match="update"):
        solver.update("hinge", X, y, touched=[0], warm_start=None)
    for name in ("sfk", "admm"):
        with pytest.raises(NotImplementedError, match=name):
            get_solver(name)
    with pytest.raises(KeyError, match="available"):
        get_solver("nope")
    with pytest.raises(ValueError, match="local_backend"):
        get_solver("d3ca")(local_backend="pallas", device="cpu")
    with pytest.raises(ValueError, match="needs P and Q"):
        solver.solve("hinge", X, y, cfg=cfg)
    assert available_solvers() == ["d3ca", "radisa"]
    assert issubclass(get_solver("radisa"), Solver)


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

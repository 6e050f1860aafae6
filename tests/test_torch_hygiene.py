"""The port stands alone: it imports neither jax nor the JAX package,
ships its CUDA sources, and builds into a git-ignored directory."""
import os
import re
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "src", "repro_torch")


def _port_files():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for base, _, files in os.walk(PKG):
        out += [os.path.join(base, f) for f in files
                if f.endswith((".py", ".cu", ".cuh"))]
    return out


def _modules():
    mods = []
    for base, _, files in os.walk(PKG):
        for f in files:
            if not f.endswith(".py"):
                continue
            rel = os.path.relpath(os.path.join(base, f),
                                  os.path.join(ROOT, "src"))[:-3]
            parts = rel.split(os.sep)
            if parts[-1] == "__init__":
                parts = parts[:-1]
            mods.append(".".join(parts))
    return sorted(mods)


def test_importing_the_port_pulls_in_neither_jax_nor_the_jax_package():
    mods = _modules()
    assert "repro_torch.core.solver" in mods and len(mods) >= 25
    code = (
        "import importlib, sys\n"
        f"sys.path.insert(0, {os.path.join(ROOT, 'src')!r})\n"
        f"sys.path.insert(0, {ROOT!r})\n"
        f"for m in {mods!r} + ['chip_smoke']:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' "
        "or m.startswith('jax.') or m == 'jaxlib' or m == 'repro' "
        "or m.startswith('repro.'))\n"
        "assert not bad, bad\n"
        "print('clean', len(sys.modules))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300, env=env)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.startswith("clean")


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_source_names_jax_or_the_jax_package(path):
    text = open(path).read()
    pat = re.compile(r"^\s*(import\s+jax|from\s+jax|import\s+repro\b(?!_)"
                     r"|from\s+repro(\.|\s))", re.M)
    assert not pat.search(text), pat.search(text).group(0)


def test_cuda_sources_ship_and_build_dir_is_ignored():
    csrc = os.path.join(PKG, "csrc")
    for name in ("sdca_epoch.cu", "svrg_inner.cu"):
        src = open(os.path.join(csrc, name)).read()
        assert "__global__" in src and 'extern "C"' in src
        # the note every kernel carries: what it replaces, what bounds it
        assert "Replaces the TPU kernel src/repro/kernels/" in src
        assert "What bounds it" in src
        assert "torch/extension.h" not in src
    ignored = open(os.path.join(ROOT, ".gitignore")).read().split()
    assert "build/" in ignored
    from repro_torch.kernels import _build
    assert str(_build.BUILD_ROOT).startswith(os.path.join(ROOT, "build"))
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS


def test_chip_smoke_fails_without_a_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    r = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")],
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "needs a CUDA device" in r.stderr

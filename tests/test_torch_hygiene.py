"""The port stands alone: it imports neither jax nor the JAX package,
ships its CUDA sources, and builds into a git-ignored directory; its
examples (``examples/torch_*.py``) import neither either and default to
the card."""
import glob
import importlib.util
import os
import re
import subprocess
import sys

import pytest
from test_torch_common import TORCH_TEST_ENV

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "src", "repro_torch")
EXAMPLES = sorted(glob.glob(os.path.join(ROOT, "examples", "torch_*.py")))
#: an import of jax or of the JAX package at the start of a line
NAMES_JAX = re.compile(r"^\s*(import\s+jax|from\s+jax|import\s+repro\b(?!_)"
                       r"|from\s+repro(\.|\s))", re.M)


#: CUDA sources whose kernels have no Pallas counterpart: the backward of
#: flash attention and of the RWKV6 linear attention
NO_TPU_COUNTERPART = ("flash_attention_bwd.cu", "rwkv_linattn_bwd.cu")


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
    for m in ("repro_torch.kernels.flash.ops", "repro_torch.kernels.linattn"
              ".ops", "repro_torch.models.transformer",
              "repro_torch.serve.engine", "repro_torch.launch.serve",
              "repro_torch.configs.qwen3_1_7b", "repro_torch.online.queue",
              "repro_torch.online.store", "repro_torch.online.snapshot",
              "repro_torch.online.service", "repro_torch.checkpoint.manager",
              "repro_torch.serve.scoring", "repro_torch.launch.online",
              "repro_torch.core.compress", "repro_torch.core.compress.codecs",
              "repro_torch.core.compress.policy",
              "repro_torch.core.compress.executor",
              "repro_torch.core.comm_model", "repro_torch.launch.mesh"):
        assert m in mods, m
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
    env = {k: v for k, v in TORCH_TEST_ENV.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300, env=env)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.startswith("clean")


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_source_names_jax_or_the_jax_package(path):
    text = open(path).read()
    assert not NAMES_JAX.search(text), NAMES_JAX.search(text).group(0)


def test_the_six_examples_are_ported():
    assert [os.path.basename(p) for p in EXAMPLES] == [
        f"torch_{n}.py" for n in ("lm_train", "online_loop", "quickstart",
                                  "serve_lm", "svm_doubly_distributed",
                                  "trace_solve")]
    for path in EXAMPLES:
        twin = os.path.join(ROOT, "examples",
                            os.path.basename(path)[len("torch_"):])
        assert os.path.exists(twin), twin


@pytest.mark.parametrize("path", EXAMPLES, ids=os.path.basename)
def test_no_example_names_jax_or_the_jax_package(path):
    text = open(path).read()
    assert not NAMES_JAX.search(text), NAMES_JAX.search(text).group(0)
    assert "def main(argv=None" in text


def test_importing_the_examples_pulls_in_neither_jax_nor_the_jax_package():
    """A fresh interpreter loads every example module by path (nothing
    runs: ``main`` is not called)."""
    code = (
        "import importlib.util, sys\n"
        f"for i, p in enumerate({EXAMPLES!r}):\n"
        "    spec = importlib.util.spec_from_file_location(f'ex{i}', p)\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' "
        "or m.startswith('jax.') or m == 'jaxlib' or m == 'repro' "
        "or m.startswith('repro.'))\n"
        "assert not bad, bad\n"
        "print('clean', len(sys.modules))\n")
    env = {k: v for k, v in TORCH_TEST_ENV.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300, env=env)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.startswith("clean")


@pytest.mark.parametrize("path", EXAMPLES, ids=os.path.basename)
def test_example_without_device_cpu_raises_without_a_card(path):
    """Every example defaults to the card and never falls back to the CPU
    (as ``test_chip_smoke_fails_without_a_card`` for the script)."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    spec = importlib.util.spec_from_file_location("example_under_test", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    with pytest.raises(RuntimeError, match="no CUDA device is available"):
        mod.main([])


def test_cuda_sources_ship_and_build_dir_is_ignored():
    csrc = os.path.join(PKG, "csrc")
    sources = sorted(f for f in os.listdir(csrc) if f.endswith(".cu"))
    assert set(sources) >= {"sdca_epoch.cu", "svrg_inner.cu",
                            "sdca_epoch_sparse.cu", "svrg_inner_sparse.cu",
                            "flash_attention.cu", "rwkv_linattn.cu",
                            *NO_TPU_COUNTERPART}
    for name in sources:
        src = open(os.path.join(csrc, name)).read()
        assert "__global__" in src and 'extern "C"' in src
        # the note every kernel carries: what it replaces, what bounds it;
        # the two backward kernels' sources replace none (the reference
        # differentiates pure-JAX functions) and say so
        if name in NO_TPU_COUNTERPART:
            assert "Replaces no TPU kernel" in src
        else:
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
                       capture_output=True, text=True, timeout=300,
                       env=TORCH_TEST_ENV)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "needs a CUDA device" in r.stderr

"""The port's training CLI (``python -m repro_torch.launch.train``) on the
CPU: reduced Qwen3 learns (the case of ``tests/test_system.py``),
``--resume`` continues at the saved step, the card is the default device,
and the families once refused by name train (two over a mesh of ranks,
whose grids this module closes at its end)."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.launch import train as train_mod
from repro_torch.launch.mesh import close_grids
from test_torch_common import bounded  # noqa: F401

ROOT = __file__.rsplit("/tests/", 1)[0]


@pytest.fixture(scope="module", autouse=True)
def _close_at_end():
    yield
    close_grids()


def test_train_driver_end_to_end(tmp_path):
    hist = train_mod.main([
        "--arch", "qwen3-1.7b", "--reduced", "--steps", "40",
        "--batch", "4", "--seq", "64", "--lr", "5e-3", "--device", "cpu",
        "--ckpt-dir", str(tmp_path), "--ckpt-every", "20"])
    losses = [h["loss"] for h in hist]
    assert len(losses) == 40
    assert np.all(np.isfinite(losses))
    assert all(np.isfinite(h["grad_norm"]) for h in hist)
    assert np.mean(losses[-5:]) < np.mean(losses[:5])   # it learns


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "rwkv6-3b"])
def test_train_driver_resume(tmp_path, arch):
    first = train_mod.main([
        "--arch", arch, "--reduced", "--steps", "10", "--batch", "2",
        "--seq", "32", "--device", "cpu", "--ckpt-dir", str(tmp_path)])
    hist = train_mod.main([
        "--arch", arch, "--reduced", "--steps", "5", "--batch", "2",
        "--seq", "32", "--device", "cpu", "--ckpt-dir", str(tmp_path),
        "--resume"])
    assert [h["step"] for h in first] == list(range(10))
    assert hist[0]["step"] == 10   # continued from the checkpoint
    assert [h["step"] for h in hist] == list(range(10, 15))


def test_resume_continues_the_same_trajectory(tmp_path):
    """4 steps, then --resume for 2, equals 6 steps in one run when the
    schedule is the same (--steps sets the cosine's length: 6 both)."""
    common = ["--arch", "qwen3-1.7b", "--reduced", "--batch", "2",
              "--seq", "16", "--device", "cpu"]
    whole = train_mod.main(common + ["--steps", "6", "--ckpt-dir",
                                     str(tmp_path / "a")])
    # a run of 6 interrupted after 4 (preemption) and resumed
    d = str(tmp_path / "b")
    train_mod.main(common + ["--steps", "6", "--ckpt-dir", d,
                             "--ckpt-every", "4"])
    import shutil
    shutil.rmtree(os.path.join(d, "step_00000006"))
    tail = train_mod.main(common + ["--steps", "6", "--ckpt-dir", d,
                                    "--resume"])
    assert tail[0]["step"] == 4
    for a, b in zip(whole[4:], tail[:2]):
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=1e-6)


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs a machine "
                    "without a CUDA device")
def test_train_cli_without_device_cpu_raises(tmp_path):
    with pytest.raises(RuntimeError, match="--device cpu"):
        train_mod.main(["--arch", "qwen3-1.7b", "--reduced", "--steps",
                        "2", "--ckpt-dir", str(tmp_path)])


def test_train_cli_module_entry_point(tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "rwkv6-3b", "--reduced", "--steps", "2", "--batch", "2", "--seq",
         "8", "--device", "cpu", "--ckpt-dir", str(tmp_path)],
        capture_output=True, text=True, cwd=ROOT,
        env={**os.environ, "PYTHONPATH": "src"})
    assert out.returncode == 0, out.stderr
    assert "steps=2 first_loss=" in out.stdout


@pytest.mark.usefixtures("bounded")
@pytest.mark.parametrize("flags,named", [
    (["--arch", "mixtral-8x7b", "--mesh", "2,1"], "item 13d"),
    (["--arch", "rwkv6-3b", "--mesh", "1,4"], "item 13d"),
    (["--arch", "musicgen-large"], "embed_input"),
    (["--arch", "mixtral-8x7b"], "MoE"),
    (["--arch", "recurrentgemma-9b"], "rglru"),
    (["--arch", "llama-3.2-vision-90b"], "xattn")])
def test_train_cli_refuses_by_name(tmp_path, capsys, flags, named):
    """The families once refused by name now train, two steps on their
    synthetic batches (frame embeddings, stub encoder states), finite
    losses: those of item 13b (the embedding frontend, MoE, RG-LRU,
    XATTN) on one device, and those refused over a mesh until item 13d's
    first half (the cases tagged "item 13d") over their ``--mesh``, which
    a ``--resume`` on the same mesh continues."""
    argv = flags + ["--reduced", "--device", "cpu", "--ckpt-dir",
                    str(tmp_path), "--batch", "2", "--seq", "16"]
    hist = train_mod.main(argv + ["--steps", "2"])
    if named == "item 13d":
        hist += train_mod.main(argv + ["--steps", "1", "--resume"])
        assert "resumed at step 2" in capsys.readouterr().out
    assert [h["step"] for h in hist] == list(range(len(hist)))
    assert all(np.isfinite(h["loss"]) for h in hist)


def test_train_cli_mesh_of_one_device_runs(tmp_path):
    hist = train_mod.main(["--arch", "qwen3-1.7b", "--reduced", "--mesh",
                           "1,1", "--steps", "1", "--batch", "2", "--seq",
                           "8", "--device", "cpu", "--ckpt-dir",
                           str(tmp_path)])
    assert len(hist) == 1


def test_default_ckpt_dir_follows_tmpdir(tmp_path):
    """Two runs with their own TMPDIR never share a checkpoint folder."""
    import tempfile
    default = train_mod.build_parser().parse_args(["--arch", "x"]).ckpt_dir
    assert default == os.path.join(tempfile.gettempdir(), "repro_ckpt")
    out = subprocess.run(
        [sys.executable, "-c", "from repro_torch.launch.train import "
         "build_parser; print(build_parser().parse_args(['--arch', 'x'])"
         ".ckpt_dir)"],
        capture_output=True, text=True, cwd=ROOT,
        env={**os.environ, "PYTHONPATH": "src", "TMPDIR": str(tmp_path)})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == str(tmp_path / "repro_ckpt")

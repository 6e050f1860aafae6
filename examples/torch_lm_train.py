"""End-to-end training example on the PyTorch/CUDA port: train a ~100M-parameter
Qwen3-family model for a few hundred steps with checkpointing and the
fault-tolerant trainer -- the counterpart of ``examples/lm_train.py``.
(Reduced further with --small.)

    PYTHONPATH=src python examples/torch_lm_train.py [--small]
    PYTHONPATH=src python examples/torch_lm_train.py --small --device cpu

It drives the training CLI's ``main`` (``repro_torch.launch.train``) on
one device.  ``--small``: reduced Qwen3 (2 layers, d_model 64), 60 steps
of 4 x 64 tokens at lr 5e-3.  Default: Qwen3's family scaled to ~100M
parameters (12 layers x 768, 12 heads of 64, 4 KV heads, d_ff 2048,
vocab 32768), 300 steps of 8 x 256 tokens at lr 3e-4, a checkpoint every
100 steps; handed to the CLI as a config object (``main(config=)``).
Every attention layer of every forward runs the flash attention kernel.
``--device`` defaults to ``cuda`` and raises on a machine without a card.
"""
import argparse
import dataclasses
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

import numpy as np  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import train as train_mod  # noqa: E402


def config_100m():
    """~100M params: the Qwen3 family scaled (12L x 768 x 12H, vocab 32k)."""
    return dataclasses.replace(
        get_config("qwen3-1.7b"), name="qwen3-100m", n_layers=12,
        d_model=768, n_heads=12, n_kv=4, d_ff=2048, vocab=32768,
        head_dim=64)


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint folder (default: repro_lm_small or "
                         "repro_lm_100m under the temporary directory)")
    return ap


def main(argv=None):
    """Run the example; returns the ``losses``, each step's ``time_s``,
    the median step time ``step_ms`` and ``tokens_per_s`` over the steps
    after the first, and ``learned`` (the mean loss of the last 5 steps
    below that of the first 5; None with fewer than 10 steps, where the
    two windows overlap)."""
    args = build_parser().parse_args(argv)
    tmp = tempfile.gettempdir()
    if args.small:
        batch, seq, config = 4, 64, None
        cli = ["--arch", "qwen3-1.7b", "--reduced",
               "--steps", str(args.steps or 60),
               "--batch", str(batch), "--seq", str(seq), "--lr", "5e-3",
               "--ckpt-dir",
               args.ckpt_dir or os.path.join(tmp, "repro_lm_small")]
    else:
        batch, seq, config = 8, 256, config_100m()
        cli = ["--steps", str(args.steps or 300),
               "--batch", str(batch), "--seq", str(seq), "--lr", "3e-4",
               "--ckpt-dir", args.ckpt_dir or os.path.join(tmp,
                                                          "repro_lm_100m"),
               "--ckpt-every", "100"]

    hist = train_mod.main(cli + ["--device", args.device], config=config)
    losses = [h["loss"] for h in hist]
    times = [h["time_s"] for h in hist]
    print(f"\nfirst 5 losses: {[round(v, 3) for v in losses[:5]]}")
    print(f"last 5 losses:  {[round(v, 3) for v in losses[-5:]]}")
    learned = None
    if len(losses) >= 10:
        learned = bool(np.mean(losses[-5:]) < np.mean(losses[:5]))
        assert learned, "did not learn!"
        print("OK: loss decreased")
    step_s = float(np.median(times[1:] or times))
    return {"losses": losses, "time_s": times, "step_ms": step_s * 1e3,
            "tokens_per_s": batch * seq / step_s, "learned": learned}


if __name__ == "__main__":
    main()

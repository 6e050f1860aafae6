"""End-to-end LM training driver (the port of ``repro/launch/train.py``).

    # reduced Qwen3 on the CPU
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \\
        --reduced --steps 40 --batch 4 --seq 64 --lr 5e-3 --device cpu \\
        --ckpt-dir "$(mktemp -d)"

    # Qwen3-1.7B at full width and depth on the card (random weights)
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \\
        --steps 3 --batch 8 --seq 128 --ckpt-dir "$(mktemp -d)"

    # the other families the same way: mixtral-8x7b / moonshot-v1-16b-a3b
    # (MoE), recurrentgemma-9b (RG-LRU + LOCAL), llama-3.2-vision-90b
    # (XATTN on stub encoder states), musicgen-large (frame embeddings)
    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch recurrentgemma-9b --reduced --steps 4 --batch 2 --seq 32 \\
        --device cpu --ckpt-dir "$(mktemp -d)"

The whole stack on one device: the deterministic token pipeline -> the
train step (gradient accumulation over microbatches, remat, chunked cross
entropy; flash attention / RWKV6 linear attention kernels in the forward)
-> AdamW -> the fault-tolerant trainer (async checkpoints, NaN rollback,
preemption save, straggler log).  Batches carry frame embeddings and stub
encoder states where the config asks for them, as the reference's CLI
makes them (``data.tokens.synthetic_lm_batch``).  ``--device`` defaults
to ``cuda`` and raises without a card.

``--mesh d,m`` trains over a (data, model) mesh: d x m ranks of a process
grid on ``--device`` (every rank on the one card of a one-card machine),
the parameters and AdamW's state laid out by the sharding rules, the
step split by ``launch/mesh_train.py``; checkpoints are full arrays, so
``--resume`` continues on any mesh (one device included).  Every family
trains on a mesh::

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \
        --reduced --steps 4 --batch 4 --seq 32 --mesh 2,2 --device cpu \
        --ckpt-dir "$(mktemp -d)"
"""
from __future__ import annotations

import argparse
import logging
import math
import os
import tempfile

from ..configs import get_config
from ..core.util import resolve_device
from ..data.tokens import synthetic_lm_batch
from ..models import Transformer, reduced
from ..optim import AdamWConfig, adamw_init, warmup_cosine
from ..runtime import Trainer, TrainerConfig
from .mesh import make_mesh
from .mesh_train import init_on_mesh
from .steps import make_train_step


def build_parser(require_arch: bool = True):
    ap = argparse.ArgumentParser(
        prog="repro_torch.launch.train",
        description="LM training CLI (PyTorch/CUDA port)")
    ap.add_argument("--arch", required=require_arch,
                    help="the config to train (left out when main() is "
                         "handed a config)")
    ap.add_argument("--reduced", action="store_true",
                    help="tiny same-family config (CPU friendly)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(), "repro_ckpt"),
                    help="checkpoint folder (default: repro_ckpt under the "
                         "temporary directory, which follows TMPDIR)")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--mesh", default=None,
                    help="e.g. '4,2' for a 4x2 (data, model) mesh of ranks "
                         "on --device")
    ap.add_argument("--resume", action="store_true")
    return ap


def main(argv=None, *, config=None):
    """Train; returns the trainer's history (one dict a step).  ``config``
    (a :class:`~repro_torch.models.config.ModelConfig`) trains that
    model in place of ``--arch``, which is then left out -- a model no
    config module names, such as an example's scaled-down family member.
    """
    ap = build_parser(require_arch=config is None)
    args = ap.parse_args(argv)
    if config is not None and args.arch is not None:
        ap.error("--arch names a config and main() was handed another")

    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")

    cfg = config if config is not None else get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    mesh = None
    if args.mesh:
        shape = tuple(int(x) for x in args.mesh.split(","))
        if len(shape) > 2:
            ap.error(f"--mesh {args.mesh}: at most (data, model)")
        if math.prod(shape) > 1:
            mesh = make_mesh(shape, ("data", "model")[:len(shape)],
                             device=args.device)
    device = resolve_device(args.device)
    model = Transformer(cfg, device=device, mesh=mesh)
    opt_cfg = AdamWConfig(lr=warmup_cosine(args.lr, 20, args.steps))

    if mesh is None:
        params = model.init(0)
        opt_state = adamw_init(params)
    else:
        params, opt_state = init_on_mesh(model, 0)
    step_fn = make_train_step(model, opt_cfg)

    def make_batch(step):
        return synthetic_lm_batch(cfg, step, batch=args.batch, seq=args.seq)

    trainer = Trainer(
        TrainerConfig(ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every),
        step_fn, make_batch, params, opt_state)
    del params, opt_state
    if args.resume:
        print("resumed at step", trainer.restore())
    history = trainer.run(args.steps)

    losses = [h["loss"] for h in history]
    print(f"steps={len(history)} first_loss={losses[0]:.4f} "
          f"last_loss={losses[-1]:.4f} stragglers={trainer.stragglers[:5]}")
    return history


if __name__ == "__main__":
    main()

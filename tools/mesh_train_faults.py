"""Planted faults in the LM grid's train step, read as ``chip_smoke.py``'s
``train_mesh_full`` reads the sound grid: where its limits on the first
step (``MESH_TRAIN_LIMITS``) must lie.

On a machine with a card, Qwen3-1.7B at full width on chip_smoke's 2 x 2
(data, model) grid of ranks sharing the card, in bfloat16 at
``MESH_TRAIN_DEPTH`` layers and in float32 at ``MESH_TRAIN_F32_DEPTH``:
the first step from init(0) of the sound grid and of the grid with one
fault planted on every rank for that step, each held against the
one-device step (``held_first_step``: the loss's and gradient norm's
relative errors, the share of parameter entries whose step went another
way, overall and in the worst leaf, and the one-device control beside):

  * ``skip_data_reduce_scatter``: the reduce-scatter of an FSDP leaf's
    gradient over the batch axes keeps the rank's own block of its local
    gradient (the other data rank's rows never reach it); its bytes are
    still counted, so the wire check does not see it;
  * ``wrong_kv_pick``: every rank's attention reads its KV heads rotated
    by one (query group g attends with KV head g + 1);

and the same for Mixtral-8x7B at ``train_mesh_families_full``'s depth (1
layer: 4 of its 8 experts a rank), in float32, the precision that phase
gates, with the faults of the MoE's split compute:

  * ``router_grad_unsummed``: the router's gradient, a partial sum on
    every rank (its experts' part of every token's gates), is not summed
    over "model": the reduce-scatter over the "model" group keeps the
    rank's own block of its partial gradient (bytes still counted);
  * ``wrong_expert_block``: every rank runs the other rank's block of
    experts on its own weights (the choices routed to experts 4-7 go
    through experts 0-3's weights on model rank 0, and back).

Run from the root of the repo::

    python3 tools/mesh_train_faults.py [--out FILE] [--runs qwen3,mixtral]

Prints one JSON line a run (and writes them to ``--out``), then the card's
name and power limit.
"""
import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
# the grid's ranks call this script's rank-side functions by module name
sys.modules.setdefault("mesh_train_faults", sys.modules[__name__])

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.sharding import collectives as coll  # noqa: E402
from repro_torch.sharding import resident  # noqa: E402

FAULTS = (None, "skip_data_reduce_scatter", "wrong_kv_pick")
MOE_FAULTS = (None, "router_grad_unsummed", "wrong_expert_block")


def _own_block_only(x, dim, group, n):
    """The fault: the rank's block of its own gradient, unsummed."""
    if group is None or n == 1:
        return x
    coll.WIRE["reduce_scatter"] += x.numel() * x.element_size()
    i = dist.get_group_rank(group, dist.get_rank())
    return x.chunk(n, dim)[i].contiguous()


def _kv_rotated(real):
    def call(q, k, v, **kw):
        if k.shape[2] > 1:
            k, v = k.roll(1, dims=2), v.roll(1, dims=2)
        return real(q, k, v, **kw)
    return call


def _model_block_only(model_group, real):
    """The fault on the "model" group's reduce-scatters alone."""
    def call(x, dim, group, n):
        if group is model_group:
            return _own_block_only(x, dim, group, n)
        return real(x, dim, group, n)
    return call


def _experts_shifted(real):
    def call(params, x, cfg, *, first_expert=0, partial=False):
        if partial:
            first_expert = ((first_expert + params["w_gate"].shape[0])
                            % cfg.moe.n_experts)
        return real(params, x, cfg, first_expert=first_expert,
                    partial=partial)
    return call


def _rank_plant(ctx, mesh, fault):
    """On a rank: take out any planted fault, then plant ``fault``
    (None: none)."""
    planted = ctx.resident.setdefault("planted", {})
    for (owner, name), real in planted.items():
        setattr(owner, name, real)
    planted.clear()
    if fault == "skip_data_reduce_scatter":
        planted[(coll, "reduce_scatter")] = coll.reduce_scatter
        coll.reduce_scatter = _own_block_only
    elif fault == "wrong_kv_pick":
        attn = cs.lm_attention
        planted[(attn, "flash_attention")] = attn.flash_attention
        attn.flash_attention = _kv_rotated(attn.flash_attention)
    elif fault == "router_grad_unsummed":
        planted[(coll, "reduce_scatter")] = coll.reduce_scatter
        coll.reduce_scatter = _model_block_only(ctx.group("model"),
                                                coll.reduce_scatter)
    elif fault == "wrong_expert_block":
        planted[(transformer, "moe_ffn")] = transformer.moe_ffn
        transformer.moe_ffn = _experts_shifted(transformer.moe_ffn)


def readings(dtype, depth, grid_mesh, arch="qwen3-1.7b", faults=FAULTS,
             control=True):
    cfg = cs.family_config(arch, depth, compute_dtype=dtype)
    batch = cs.synthetic_lm_batch(cfg, 0, batch=cs.TRAIN_BATCH,
                                  seq=cs.TRAIN_SEQ)
    one = cs.one_device_first_steps(cfg, batch, control=control)
    out = []
    for fault in faults:
        resident.call(grid_mesh, "mesh_train_faults:_rank_plant",
                      fault=fault)
        try:
            held = cs.grid_first_step(cfg, one, dtype)
        finally:
            resident.call(grid_mesh, "mesh_train_faults:_rank_plant",
                          fault=None)
        out.append({"arch": arch, "dtype": dtype, "layers": depth,
                    "fault": fault, **held})
        print(json.dumps(out[-1]), flush=True)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None)
    ap.add_argument("--runs", default="qwen3,mixtral",
                    help="qwen3 (bf16 and float32), mixtral (float32)")
    args = ap.parse_args(argv)
    runs = args.runs.split(",")
    if not torch.cuda.is_available():
        raise SystemExit("mesh_train_faults: no card")
    smi = cs.phase_env()
    cs.phase_build()
    cs.close_grids()
    cs.process_grid(*cs.MESH_TRAIN_GRID, device="cuda")
    mesh = cs.make_mesh(cs.MESH_TRAIN_GRID, ("data", "model"))
    try:
        rows = []
        if "qwen3" in runs:
            rows += (readings("bfloat16", cs.MESH_TRAIN_DEPTH, mesh)
                     + readings("float32", cs.MESH_TRAIN_F32_DEPTH, mesh))
        if "mixtral" in runs:
            depth = dict((a, d) for a, d, _ in cs.MESH_FAMILIES)[
                "mixtral-8x7b"]
            rows += readings("float32", depth, mesh, "mixtral-8x7b",
                             MOE_FAULTS, control=False)
    finally:
        cs.close_grids()
    if args.out:
        with open(args.out, "w") as fh:
            for r in rows:
                fh.write(json.dumps(r) + "\n")
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""LM prefill and decode on a mesh's process grid (the sharded half of
``launch/steps.py::make_prefill_step`` / ``make_decode_step``).

The parameters are the resident trees of ``launch/mesh_train.py``
(``put_params``); the decode cache is resident too: every rank keeps its
block of each cache leaf (``launch/steps.py::cache_specs``: its rows, its
KV heads or its L / M cache positions, RWKV-6's state on its heads, RG-LRU's
``h`` on its channels) and the controller holds a tree of
:class:`~repro_torch.sharding.resident.ShardedLeaf` handles beside the
position.

**A step** is one CALL (:func:`_rank_serve`): the global batch's rows
split over the batch axes (each rank's block of ``batch_specs``; every
rank takes every row where the batch axes do not divide them), the rank's
``Transformer.prefill`` / ``decode_step`` on its part (see
``models/transformer.py``), and its rows' logits -- whole over the
vocabulary -- gathered to the controller.

**The views.**  A rank computes with the FSDP views of its blocks
(``ViewPlan.gather`` of each block cast to the compute dtype, as
``Transformer.compute_params`` casts them: a bf16 view crosses the wire
in bf16).  It gathers them at the first
step that needs them and holds them for every later prefill and decode
step of the same parameter version: a decoded token moves no parameter.
Any write into the parameters (a training step, a put, a restore) drops
them (``sharding/resident.py::changed``) and the next step gathers anew;
views whose version is not the parameters' are never used (the step
raises).  The reference re-gathers inside every jitted step instead
(ROADMAP C "Choices": the results are the reference's, the cost is not).
"""
from __future__ import annotations

import time
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..core.util import tree_leaves, tree_map, tree_unflatten
from ..models.config import ATTN, LOCAL, XATTN, ShapeConfig
from ..models.transformer import Transformer, layer_exits, param_shapes
from ..sharding import collectives as coll
from ..sharding import resident
from ..sharding.resident import ShardedLeaf
from ..sharding.rules import PartitionSpec
from .mesh import Mesh
from .mesh_train import _cpu_share, _rank_model, _Sizes, rank_mesh

_THIS = "repro_torch.launch.mesh_serve"


# ---------------------------------------------------------------------------
# rank side
# ---------------------------------------------------------------------------

def _views(ctx, model: Transformer, prefs):
    """The rank's compute views of the resident parameters ``prefs``:
    held from an earlier step of the same version, or gathered now.
    Returns (tree, whether gathered now)."""
    keys = tuple(sorted({k for k, _ in prefs}))
    now = resident.version(ctx, keys)
    store = resident.derived(ctx)
    if keys in store:
        made, views = store[keys]
        if made != now:
            raise RuntimeError(
                f"the views held for parameters {keys} are of version "
                f"{made}, the parameters of {now}: stale views are never "
                "used (a write into them must drop the views: "
                "sharding/resident.py::changed)")
        return views, False
    st = resident.trees(ctx)
    views = gather_views(model, [st[k][i] for k, i in prefs])
    store[keys] = (now, views)
    return views, True


def view_dtypes(model: Transformer):
    """Each leaf's dtype as the model computes with it
    (``Transformer.compute_params``), in the leaves' order."""
    return [t.dtype for t in tree_leaves(model.compute_params(
        param_shapes(model.cfg)))]


def gather_views(model: Transformer, blocks):
    """A rank's compute views of its blocks (in the leaves' order): each
    block cast to the dtype the model computes with it, then gathered by
    its ``ViewPlan`` -- the cast is element-wise, so this is the cast of
    the gathered view, and a bf16 view crosses the wire in bf16."""
    views = [pl.gather(b.to(dt)) for pl, b, dt in zip(
        tree_leaves(model.view_plans), blocks, view_dtypes(model))]
    return tree_unflatten(param_shapes(model.cfg), views)


def _sync(ctx):
    if ctx.device.type == "cuda":
        torch.cuda.synchronize(ctx.device)


def _rows_to_0(ctx, mesh: Mesh, logits, split: bool):
    """Every rank's rows of the logits to rank 0 (not counted in
    ``WIRE``: the hand-off to the controller, no step's collective), which
    returns the global batch's (B, 1, V) float32 on the host."""
    host = logits.float().cpu().contiguous()
    parts = ([torch.empty_like(host) for _ in range(mesh.size)]
             if ctx.rank == 0 else None)
    dist.gather(host, parts, dst=0)
    if ctx.rank != 0:
        return None
    if not split:
        return parts[0]
    return torch.cat(parts[::mesh.model_size], dim=0)


def _rank_serve(ctx, *cells, mesh: Mesh, cfg, names, prefs, kind: str,
                ckey: str, cache_len: int, pos: Optional[int], split: bool):
    """One prefill (``kind="prefill"``: the cache's blocks made under
    ``ckey``) or decode step (the blocks under ``ckey`` updated in place)
    on this rank; rank 0 returns the logits, the step's wire bytes and
    what the views cost (bytes, seconds) when it gathered them."""
    with _cpu_share(ctx), torch.no_grad():
        rank_mesh(ctx, mesh)
        model = _rank_model(ctx, mesh, cfg)
        before = dict(coll.WIRE)
        t0 = time.perf_counter()
        params, gathered = _views(ctx, model, prefs)
        _sync(ctx)
        views = {"gathered": gathered, "s": time.perf_counter() - t0,
                 "wire": {k: coll.WIRE[k] - before[k] for k in coll.WIRE}}
        before = dict(coll.WIRE)
        batch = {k: c[0] for k, c in zip(names, cells)}
        # the blocks under ``ckey`` (handles, checkpoints), and the rank's
        # cache tree of them held beside until they are freed
        held = resident.derived(ctx)
        if kind == "prefill":
            logits, cache = model.prefill(params, batch, cache_len)
            resident.trees(ctx)[ckey] = tree_leaves(
                {"periods": cache["periods"],
                 "remainder": cache["remainder"]})
            held[(ckey,)] = (resident.version(ctx, (ckey,)), cache)
        else:
            cache = held[(ckey,)][1]
            if cache["pos"] != pos:
                raise ValueError(f"the ranks' cache {ckey} is at position "
                                 f"{cache['pos']}, the step at {pos}")
            logits, cache = model.decode_step(params, cache, batch)
        wire = {k: coll.WIRE[k] - before[k] for k in coll.WIRE}
        logits = _rows_to_0(ctx, mesh, logits, split)
    if ctx.rank != 0:
        return None
    return {"logits": logits, "wire": wire, "views": views}


# ---------------------------------------------------------------------------
# controller side
# ---------------------------------------------------------------------------

def _batch_leaves(mesh: Mesh, batch):
    """``(names, leaves, split)``: the batch's arrays cut into the ranks'
    rows along the batch axes when they divide them (else every rank gets
    every row)."""
    names = sorted(batch)
    rows = int(np.shape(batch[names[0]])[0])
    split = rows % mesh.batch_size == 0
    leaves = []
    for k in names:
        t = torch.as_tensor(np.ascontiguousarray(np.asarray(batch[k])))
        leaves.append((t.reshape(mesh.batch_size, -1, *t.shape[1:]),
                       ("data",)) if split else (t[None], ()))
    return names, leaves, split


def cache_handles(model: Transformer, batch: int, cache_len: int, key: str):
    """The controller's tree of handles of a cache resident under ``key``
    (``periods`` / ``remainder`` of ``cache_specs``, a handle a leaf)."""
    from .steps import cache_specs
    specs = cache_specs(model, ShapeConfig("serve", cache_len, batch,
                                           "decode"), model.mesh)
    tree = {"periods": specs["periods"], "remainder": specs["remainder"]}
    hs = [ShardedLeaf(model.mesh, key, i, s)
          for i, s in enumerate(tree_leaves(tree))]
    return tree_unflatten(tree, hs)


def free_cache(cache):
    """Drop a resident cache (its blocks and the ranks' trees of them)."""
    resident.free({"periods": cache["periods"],
                   "remainder": cache["remainder"]})


def _step(model: Transformer, params, batch, kind, ckey, cache_len, pos):
    mesh = model.mesh
    names, leaves, split = _batch_leaves(mesh, batch)
    prefs = [(h.key, h.idx) for h in tree_leaves(params)]
    return mesh.grid().call(f"{_THIS}:_rank_serve", leaves, mesh=mesh,
                            cfg=model.cfg, names=names, prefs=prefs,
                            kind=kind, ckey=ckey, cache_len=int(cache_len),
                            pos=pos, split=split)


def make_mesh_prefill_step(model: Transformer, cache_len: int):
    """The controller's prefill step ``(params, batch) -> (logits, cache)``
    of a sharded model: ``params`` the handle tree of resident parameters
    (``mesh_train.put_params``), ``batch`` the global batch (numpy arrays
    or tensors), ``logits`` (B, 1, V) float32 on the mesh's device, and
    ``cache`` ``{"pos", "periods", "remainder", "cache_len"}`` with a
    handle a leaf, its blocks resident on the ranks.  ``last`` holds the
    last step's rank-0 report (wire bytes by kind, the views')."""
    mesh = model.mesh

    def prefill_step(params, batch):
        key = resident.new_key("cache")
        out = _step(model, params, batch, "prefill", key, cache_len, None)
        prefill_step.last = out
        B, S = np.shape(batch.get("tokens", batch.get("embeds")))[:2]
        cache = {"pos": int(S), **cache_handles(model, int(B), cache_len,
                                                key),
                 "cache_len": int(cache_len)}
        return out["logits"].to(mesh.device), cache

    prefill_step.last = None
    return prefill_step


def make_mesh_decode_step(model: Transformer):
    """The controller's decode step ``(params, cache, batch) -> (logits,
    cache)`` of a sharded model: ``cache`` a prefill's handle cache (its
    blocks updated in place on the ranks, ``pos`` advanced), ``batch``
    ``{"tokens": (B, 1)}`` (or ``{"embeds": (B, 1, d_model)}``)."""
    mesh = model.mesh

    def decode_step(params, cache, batch):
        key = tree_leaves({"periods": cache["periods"],
                           "remainder": cache["remainder"]})[0].key
        out = _step(model, params, batch, "decode", key, cache["cache_len"],
                    int(cache["pos"]))
        decode_step.last = out
        cache["pos"] = int(cache["pos"]) + 1
        return out["logits"].to(mesh.device), cache

    decode_step.last = None
    return decode_step


# ---------------------------------------------------------------------------
# wire bytes, counted from the specs beforehand
# ---------------------------------------------------------------------------

def serve_wire_bytes(model: Transformer, batch: int, seq: int,
                     kind: str) -> Dict[str, Dict[str, int]]:
    """The bytes one rank hands to each kind of collective (``WIRE``'s
    units) in one step of :func:`make_mesh_prefill_step` (``kind=
    "prefill"``, a batch of ``batch`` x ``seq`` tokens) or
    :func:`make_mesh_decode_step` (``"decode"``, ``batch`` tokens against
    a cache of ``seq`` positions), from the specs and the step's structure
    alone: ``{"step": ..., "views": ...}`` -- the step's own collectives
    (the vocab-parallel lookup, every layer kind's Megatron exits
    (``layer_exits``), a length-split cache's query gather and log-sum-exp
    merge, the vocab-parallel head's gather), and apart from them the
    one-time gather of the views (each leaf's ``ViewPlan`` forward
    half)."""
    if kind not in ("prefill", "decode"):
        raise ValueError(f"kind {kind!r} is not 'prefill' or 'decode'")
    cfg, tp, mesh = model.cfg, model.tp, model.mesh
    sizes = _Sizes(mesh)
    views = dict.fromkeys(coll.WIRE, 0)
    plans = tree_map(lambda s, sp, u: coll.ViewPlan(s.shape, sp, u, sizes),
                     param_shapes(cfg), tp["specs"], tp["uses"],
                     leaf=PartitionSpec)
    for pl, dt in zip(tree_leaves(plans), view_dtypes(model)):
        views["all_gather"] += pl.view_bytes(dt.itemsize)["all_gather"]
    step = dict.fromkeys(coll.WIRE, 0)
    M = tp["M"]
    if M > 1:
        rows = batch // mesh.batch_size if batch % mesh.batch_size == 0 \
            else batch
        S = seq if kind == "prefill" else 1
        f32 = 4
        act = rows * S * cfg.d_model * f32
        n_full, n_rem = cfg.n_periods()
        kinds = ([k for _ in range(n_full) for k in cfg.pattern]
                 + [cfg.pattern[r % len(cfg.pattern)] for r in range(n_rem)])
        exits = sum(sum(layer_exits(tp, k)) for k in kinds)
        step["all_reduce"] += act * (exits + int(bool(tp["embed_vp"])))
        if tp["head_vp"]:
            step["all_gather"] += rows * cfg.vocab * f32
        if kind == "decode":
            H, hd = cfg.n_heads, cfg.hd
            for k in kinds:
                L = model._cache_len(k, seq)
                if k not in (ATTN, LOCAL, XATTN) or 1 not in \
                        model._cache_split("k", (rows, L, cfg.n_kv, hd)):
                    continue
                if tp["heads_local"]:
                    step["all_gather"] += rows * H * hd * f32
                step["all_reduce"] += rows * H * f32 + rows * H * (hd + 1) \
                    * f32
    return {"step": step, "views": views}



# ---------------------------------------------------------------------------
# the command line: greedy decoding over a mesh
# ---------------------------------------------------------------------------

def main(argv=None):
    """``python -m repro_torch.launch.mesh_serve --arch A --mesh d,m``:
    random weights (init(0), made on the ranks), a prefill of ``--batch``
    random prompts and ``--gen`` greedy decode steps over a (data, model)
    mesh -- or (pod, data, model) with three sizes -- of ranks on
    ``--device``; prints one JSON line: the greedy tokens, the seconds of
    the prefill and of each decode step, and the wire bytes of a step."""
    import argparse
    import json
    import math

    from ..configs import get_config
    from ..models.config import reduced
    from .mesh import make_mesh
    from .mesh_train import init_params_on_mesh
    ap = argparse.ArgumentParser(
        prog="repro_torch.launch.mesh_serve",
        description="greedy decoding over a mesh (PyTorch/CUDA port)")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="tiny same-family config (CPU friendly)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--mesh", default="2,2",
                    help="'d,m' or 'p,d,m' ranks (pod, data, model)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--cache-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=8)
    args = ap.parse_args(argv)
    shape = tuple(int(x) for x in args.mesh.split(","))
    if len(shape) not in (2, 3) or math.prod(shape) < 2:
        ap.error(f"--mesh {args.mesh}: two or three sizes, more than one "
                 "rank in all")
    if args.prompt_len + args.gen > args.cache_len:
        ap.error("--cache-len must hold the prompt and the decoded tokens")
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    mesh = make_mesh(shape, ("pod", "data", "model")[3 - len(shape):],
                     device=args.device)
    model = Transformer(cfg, device=args.device, mesh=mesh)
    params = init_params_on_mesh(model, 0)
    rng = np.random.default_rng(0)
    batch = {}
    if cfg.embed_input == "tokens":
        batch["tokens"] = rng.integers(0, cfg.vocab, (
            args.batch, args.prompt_len)).astype(np.int32)
    else:
        batch["embeds"] = rng.normal(size=(
            args.batch, args.prompt_len, cfg.d_model)).astype(np.float32)
    if cfg.encoder_len:
        batch["encoder"] = rng.normal(size=(
            args.batch, cfg.encoder_len, cfg.d_model)).astype(np.float32)
    prefill = make_mesh_prefill_step(model, args.cache_len)
    decode = make_mesh_decode_step(model)
    t0 = time.perf_counter()
    logits, cache = prefill(params, batch)
    prefill_s = time.perf_counter() - t0
    tokens, decode_s = [], []
    for _ in range(args.gen):
        nxt = logits[:, -1].argmax(-1).cpu().numpy().astype(np.int32)
        tokens.append(nxt.tolist())
        inp = ({"tokens": nxt[:, None]} if cfg.embed_input == "tokens"
               else {"embeds": rng.normal(size=(args.batch, 1, cfg.d_model))
                     .astype(np.float32)})
        t0 = time.perf_counter()
        logits, cache = decode(params, cache, inp)
        decode_s.append(time.perf_counter() - t0)
    print(json.dumps({
        "arch": cfg.name, "mesh": list(shape), "batch": args.batch,
        "prompt_len": args.prompt_len, "cache_len": args.cache_len,
        "greedy_tokens": tokens, "prefill_s": prefill_s,
        "decode_step_s": decode_s,
        "views": prefill.last["views"]["wire"],
        "wire_prefill": prefill.last["wire"],
        "wire_decode": decode.last["wire"] if args.gen else None}))
    free_cache(cache)
    resident.free(params)
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(main())

"""LM training on a mesh's process grid (the sharded half of
``launch/steps.py::make_train_step``).

The parameters and the AdamW state live on the ranks as resident trees
(``sharding/resident.py``: every rank holds its block of each leaf, the
controller a :class:`~repro_torch.sharding.resident.ShardedLeaf` handle
a leaf).

**The step.**  One CALL a step (:func:`_rank_train_step`) on every rank:
its rows of the global batch (``batch_specs``: a contiguous block of rows
along the batch axes), cut into the pieces of the reference's
microbatches (microbatch i is rows ``[i mb, (i+1) mb)`` of the global
batch; a rank runs the part of each that it holds, each piece's token sum
divided by its whole microbatch's token count), gradients accumulated,
scaled by 1 / acc, the loss summed over the batch axes; AdamW on the
blocks, its global norm counting every element once (a leaf's block
counts on the ranks at coordinate 0 of every axis its spec leaves out).

**FSDP gathers.**  A step gathers every leaf's view once (all-gather over
the batch axes; over "model" where the work is not split), accumulates
the microbatches' gradients on the views and reduces them once
(reduce-scatter / all-reduce): a view crosses the wire twice a step and
is held, with its gradient, for the whole step.  (Gathering a layer's
view inside every microbatch, as the reference's scan body does, was
measured against this and dropped: ROADMAP C "Choices".)
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..core.util import tree_leaves, tree_map, tree_unflatten
from ..models import moe
from ..models.transformer import Transformer, layer_exits, param_shapes
from ..optim import AdamWConfig, adamw_init, adamw_update
from ..sharding import collectives as coll
from ..sharding import resident
from ..sharding.layout import NamedSharding, ShapeDtypeStruct
from ..sharding.resident import ShardedLeaf
from ..sharding.rules import PartitionSpec, batch_axes
from .mesh import Mesh, RankMesh

_THIS = "repro_torch.launch.mesh_train"


# ---------------------------------------------------------------------------
# rank side: the rank's meshes and models, and what it reports
# ---------------------------------------------------------------------------

def _store(ctx):
    return ctx.resident.setdefault("lm", {"meshes": {}, "models": {}})


def rank_mesh(ctx, mesh: Mesh) -> RankMesh:
    st = _store(ctx)
    if mesh not in st["meshes"]:
        st["meshes"][mesh] = RankMesh(mesh, ctx)
    return st["meshes"][mesh]


def _rank_model(ctx, mesh: Mesh, cfg) -> Transformer:
    st = _store(ctx)
    key = (mesh, cfg)
    if key not in st["models"]:
        st["models"][key] = Transformer(cfg, mesh=rank_mesh(ctx, mesh))
    return st["models"][key]


def _rank_init_opt(ctx, mesh: Mesh, pkey: str, okey: str):
    """AdamW's zeros beside a resident parameter list, and count 0."""
    ps = resident.trees(ctx)[pkey]
    st = adamw_init({"p": ps})
    resident.trees(ctx)[okey] = ([st["count"]] + tree_leaves(st["mu"])
                                 + tree_leaves(st["nu"]))


def _gather_to_0(ctx, mine):
    got = [None] * dist.get_world_size() if ctx.rank == 0 else None
    dist.gather_object(mine, got, dst=0)
    return got


def _rank_reading(ctx, mesh: Mesh, cfg, what: str):
    """Every rank's reading ``what`` of its model's last training forward
    (gathered to rank 0): ``"heads"`` (query heads, KV heads) of its last
    attention, ``"scan"`` (kind, heads or channels) of its last RWKV /
    RG-LRU mixer."""
    model = _rank_model(ctx, mesh, cfg)
    return _gather_to_0(ctx, getattr(model, {"heads": "last_heads",
                                             "scan": "last_scan"}[what],
                                     None))


def _rank_routes(ctx, mesh: Mesh, on: bool):
    """On a rank: from ``on``, the experts every MoE dispatch chooses
    recorded (``moe.top_k_lower_first`` wrapped); then (``on`` False) the
    function put back and every rank's record gathered to rank 0."""
    if on:
        seen, real = [], moe.top_k_lower_first

        def record(logits, k):
            vals, idx = real(logits, k)
            seen.append(idx.detach())
            return vals, idx
        ctx.resident["expert_routes"] = (seen, real)
        moe.top_k_lower_first = record
        return None
    seen, real = ctx.resident.pop("expert_routes")
    moe.top_k_lower_first = real
    return _gather_to_0(ctx, [r.tolist() for r in seen])


def _rank_memory(ctx, mesh: Mesh, reset: bool):
    """Every rank's peak device memory (bytes; 0 on the CPU) since the
    last reset (gathered to rank 0); ``reset`` starts a new window."""
    dev = ctx.device
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    if reset and dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    got = [None] * dist.get_world_size() if ctx.rank == 0 else None
    dist.gather_object(int(peak), got, dst=0)
    return got


def _call(mesh: Mesh, fn: str, leaves=(), **kw):
    return resident.call(mesh, f"{_THIS}:{fn}", leaves, **kw)


def attention_heads(model: Transformer):
    """``[(query heads, KV heads)]`` a rank, of each rank's last training
    attention on the model's mesh (the evidence that "model" splits the
    work: H / M query heads a rank where the heads split)."""
    return _call(model.mesh, "_rank_reading", cfg=model.cfg, what="heads")


def scan_widths(model: Transformer):
    """``[("rwkv", heads) or ("rglru", channels)]`` a rank, of each rank's
    last RWKV time mix or RG-LRU scan (H / M heads, d_model / M channels
    where "model" splits them)."""
    return _call(model.mesh, "_rank_reading", cfg=model.cfg, what="scan")


@contextlib.contextmanager
def expert_routes(mesh: Mesh):
    """Inside the block, every rank records the experts its MoE
    dispatches choose (forward and recompute); at its end the list it
    yields holds each rank's record (a list of nested (N, C, k) lists):
    equal across the ranks of a "model" group, which route the same
    rows."""
    got = []
    _call(mesh, "_rank_routes", on=True)
    try:
        yield got
    finally:
        got.extend(_call(mesh, "_rank_routes", on=False))


def memory_peaks(mesh: Mesh, reset: bool = False):
    """``[peak bytes]`` a rank of the mesh's device memory since the last
    reset (``reset``: start a new window after reading)."""
    return _call(mesh, "_rank_memory", reset=reset)


# ---------------------------------------------------------------------------
# the parameters and the optimizer state on a mesh
# ---------------------------------------------------------------------------

def param_structs(model: Transformer):
    """The parameter ShapeDtypeStructs of a sharded model over its mesh."""
    from .steps import param_shardings
    return param_shardings(model, model.mesh)[0]


def put_params(model: Transformer, params):
    """A full parameter tree (tensors or the reference's numpy arrays) as
    blocks on the model's mesh: the tree of handles."""
    return resident.put_tree(model.mesh, params, param_structs(model),
                             "params")


def init_opt(model: Transformer, params):
    """AdamW's state (zeros, count 0) beside resident parameters, made on
    the ranks: ``{"mu", "nu", "count"}`` of handles."""
    mesh = model.mesh
    hs = tree_leaves(params)
    okey = resident.new_key("opt")
    _call(mesh, "_rank_init_opt", pkey=hs[0].key, okey=okey)
    structs = param_structs(model)
    n = len(hs)
    count = ShardedLeaf(mesh, okey, 0, ShapeDtypeStruct(
        (), torch.int32, NamedSharding(mesh, PartitionSpec())))
    mu = tree_unflatten(structs, [ShardedLeaf(mesh, okey, 1 + i, s)
                                  for i, s in enumerate(tree_leaves(structs))])
    nu = tree_unflatten(structs, [ShardedLeaf(mesh, okey, 1 + n + i, s)
                                  for i, s in enumerate(tree_leaves(structs))])
    return {"mu": mu, "nu": nu, "count": count}


def _rank_init(ctx, mesh: Mesh, cfg, seed: int, key: str, metas):
    """On every rank: ``cfg``'s ``init(seed)`` made on the rank's device,
    its block of each leaf (``metas``: ``(shape, dtype, spec)`` a leaf)
    kept under ``key``, the rest dropped."""
    from ..sharding.layout import shard_of
    full = tree_leaves(Transformer(cfg, device=ctx.device).init(seed))
    coords = mesh.coords(ctx.rank)
    resident.trees(ctx)[key] = [
        shard_of(t, spec, mesh, coords).to(dtype).clone()
        for t, (_, dtype, spec) in zip(full, metas)]
    resident.changed(ctx, [key])


def init_params_on_mesh(model: Transformer, seed: int = 0):
    """``model``'s ``init(seed)`` -- the same numbers as one device's --
    made on every rank's own device, each rank keeping its blocks (no
    full tree crosses the host): the tree of handles."""
    mesh = model.mesh
    structs = param_structs(model)
    key = resident.new_key("params")
    _call(mesh, "_rank_init", cfg=model.cfg, seed=int(seed), key=key,
          metas=[(tuple(s.shape), s.dtype, s.spec)
                 for s in tree_leaves(structs)])
    return tree_unflatten(structs, [
        ShardedLeaf(mesh, key, i, s)
        for i, s in enumerate(tree_leaves(structs))])


def init_on_mesh(model: Transformer, seed: int = 0):
    """:func:`init_params_on_mesh` and AdamW's state made on the ranks:
    ``(params, opt)`` handle trees."""
    params = init_params_on_mesh(model, seed)
    return params, init_opt(model, params)


# ---------------------------------------------------------------------------
# the step
# ---------------------------------------------------------------------------

def pieces(rows: int, b_index: int, acc: int, mb: int):
    """``[(lo, hi)]`` local row ranges of this rank's part of each of the
    ``acc`` global microbatches of ``mb`` rows (rows ``[b_index * rows,
    (b_index + 1) * rows)`` of the global batch are this rank's)."""
    first = b_index * rows
    out = []
    for i in range(acc):
        lo, hi = max(i * mb, first), min((i + 1) * mb, first + rows)
        if lo < hi:
            out.append((lo - first, hi - first))
    return out


def _counted(model: Transformer, rm: RankMesh):
    """Whether this rank's block of each leaf counts in the global norm:
    it is at coordinate 0 of every axis the leaf's spec leaves out."""
    def own(spec):
        used = set(spec.mesh_axes())
        return all(rm.coords[a] == 0 for a in rm.axis_names if a not in used)
    return [own(pl.spec) for pl in tree_leaves(model.view_plans)]


@contextlib.contextmanager
def _cpu_share(ctx):
    """On CPU ranks, this rank's share of the host's cores for the intra-op
    pool while the step runs (P x Q ranks each with every core spin
    against each other), never more than the grid's caller runs
    (``RankContext.cpu_threads``); put back after."""
    if ctx.device.type != "cpu":
        yield
        return
    old = torch.get_num_threads()
    torch.set_num_threads(ctx.cpu_threads)
    try:
        yield
    finally:
        torch.set_num_threads(old)


def _rank_train_step(ctx, *cells, **kw):
    """One training step on this rank (see the module docstring); rank 0
    returns the metrics and its wire bytes."""
    with _cpu_share(ctx):
        return _train_step_on_rank(ctx, *cells, **kw)


def _train_step_on_rank(ctx, *cells, mesh: Mesh, cfg, names, prefs, orefs,
                        acc_req: Optional[int], lr: float, opt: dict):
    rm = rank_mesh(ctx, mesh)
    model = _rank_model(ctx, mesh, cfg)
    st = resident.trees(ctx)
    shapes = param_shapes(cfg)
    params = tree_unflatten(shapes, [st[k][i] for k, i in prefs])
    ostate = [st[k][i] for k, i in orefs]       # count, mu..., nu...
    n = len(prefs)
    state = {"count": ostate[0],
             "mu": tree_unflatten(shapes, ostate[1:1 + n]),
             "nu": tree_unflatten(shapes, ostate[1 + n:])}
    batch = {k: c[0] for k, c in zip(names, cells)}
    # the parameters change: views held from them (serving) go now
    resident.changed(ctx, sorted({k for k, _ in prefs}))
    total, gnorm, new, wire, n_pieces = rank_train_step(
        model, rm, params, state, batch, acc_req, lr, opt)
    key, i = orefs[0]
    st[key][i] = new["count"]
    return {"loss": float(total), "grad_norm": float(gnorm), "wire": wire,
            "pieces": n_pieces}


def rank_train_step(model: Transformer, rm: RankMesh, params, state, batch,
                    acc_req: Optional[int], lr: float, opt: dict):
    """The compute of one training step on a rank (see the module
    docstring): ``params`` / ``state`` its blocks (updated in place),
    ``batch`` its rows.  Returns (loss, grad norm, AdamW's new state, the
    wire bytes it handed to each collective, the pieces it ran) -- 0-d
    tensors, not yet read on the host (the dry run runs this on the meta
    device)."""
    cfg, mesh = model.cfg, rm.mesh
    shapes = param_shapes(cfg)
    rows, S = batch["labels"].shape
    B = rows * mesh.batch_size
    acc = _largest_divisor_leq(B, cfg.train_accum if acc_req is None
                               else acc_req)
    mb = B // acc
    b_index = rm.index(batch_axes(mesh))
    mine = pieces(rows, b_index, acc, mb)
    before = dict(coll.WIRE)

    plans = tree_leaves(model.view_plans)
    with torch.no_grad():
        views = [pl.gather(p).detach()
                 for pl, p in zip(plans, tree_leaves(params))]
    for v in views:
        v.requires_grad_(True)
    run_on = tree_unflatten(shapes, views)
    total = torch.zeros((), dtype=torch.float32, device=rm.device)
    for lo, hi in mine:
        sub = {k: v[lo:hi] for k, v in batch.items()}
        loss = model.train_loss(run_on, sub, tokens=mb * S)
        loss.backward()
        total = total + loss.detach()
    grads = [pl.reduce(v.grad if v.grad is not None else torch.zeros_like(v))
             for pl, v in zip(plans, views)]
    del views, run_on
    inv = 1.0 / acc
    with torch.no_grad():
        if acc > 1:
            total = total * inv
            for g in grads:
                g.mul_(inv)
        total = coll.all_reduce(total, rm.group(batch_axes(mesh)))
        cfg_opt = AdamWConfig(lr=torch.tensor(lr, dtype=torch.float32,
                                              device=rm.device), **opt)
        _, new, gnorm = adamw_update(
            cfg_opt, tree_unflatten(shapes, grads), state, params,
            counted=_counted(model, rm),
            reduce=lambda t: coll.all_reduce(t, rm.world()))
    wire = {k: coll.WIRE[k] - before[k] for k in coll.WIRE}
    return total, gnorm, new, wire, len(mine)


def _largest_divisor_leq(n: int, k: int) -> int:
    k = max(1, min(n, k))
    while n % k:
        k -= 1
    return k


def make_mesh_train_step(model: Transformer, opt_cfg: AdamWConfig,
                         accum_steps: Optional[int] = None):
    """The controller's train step ``(params, opt_state, batch) ->
    (params, opt_state, {"loss", "grad_norm"})`` of a sharded model:
    ``params`` / ``opt_state`` handle trees on ``model.mesh`` (updated on
    the ranks, returned as they are), ``batch`` the global batch (numpy
    arrays or tensors, rows divisible by the batch axes).  The rate is
    computed here from the resident count, as the one-device step does on
    the device.  ``last`` holds the last step's rank-0 report (wire bytes
    by kind, pieces)."""
    mesh = model.mesh
    opt_kw = {f.name: getattr(opt_cfg, f.name)
              for f in dataclasses.fields(opt_cfg) if f.name != "lr"}

    def train_step(params, opt_state, batch):
        grid = mesh.grid()
        prefs = [(h.key, h.idx) for h in tree_leaves(params)]
        ohs = ([opt_state["count"]] + tree_leaves(opt_state["mu"])
               + tree_leaves(opt_state["nu"]))
        orefs = [(h.key, h.idx) for h in ohs]
        count = resident.trees(grid.ctx)[orefs[0][0]][orefs[0][1]]
        lr = opt_cfg.lr(count + 1) if callable(opt_cfg.lr) else opt_cfg.lr
        lr = float(torch.as_tensor(lr, dtype=torch.float32))
        names = sorted(batch)
        leaves = []
        for k in names:
            t = torch.as_tensor(np.ascontiguousarray(np.asarray(batch[k])))
            if t.shape[0] % mesh.batch_size:
                raise ValueError(
                    f"a batch of {t.shape[0]} rows does not split over the "
                    f"{mesh.batch_size} ranks of the batch axes of {mesh!r}")
            leaves.append((t.reshape(mesh.batch_size, -1, *t.shape[1:]),
                           ("data",)))
        out = grid.call(f"{_THIS}:_rank_train_step", leaves, mesh=mesh,
                        cfg=model.cfg, names=names, prefs=prefs, orefs=orefs,
                        acc_req=accum_steps, lr=lr, opt=opt_kw)
        train_step.last = out
        return params, opt_state, {
            "loss": torch.tensor(out["loss"], dtype=torch.float32),
            "grad_norm": torch.tensor(out["grad_norm"], dtype=torch.float32)}

    train_step.last = None
    return train_step


# ---------------------------------------------------------------------------
# wire bytes, counted from the specs beforehand
# ---------------------------------------------------------------------------

class _Sizes:
    """The axis sizes of a mesh, as a ViewPlan reads them."""

    def __init__(self, mesh):
        self.shape, self.axis_names = mesh.shape, mesh.axis_names

    def group_size(self, axes) -> int:
        return int(math.prod(self.shape.get(a, 1) for a in axes))


def wire_bytes(model: Transformer, batch: int, seq: int,
               accum_steps: Optional[int] = None) -> Dict[str, int]:
    """The bytes one rank hands to each kind of collective in one step of
    :func:`make_mesh_train_step` on a global batch of ``batch`` x ``seq``
    tokens, from the specs and the step's structure alone: the leaves'
    views and gradients (``ViewPlan.view_bytes``), every layer kind's
    Megatron exits and entries (``layer_exits``), the vocab-parallel
    lookup and cross entropy, the loss and the norm (remat "nothing" or
    "save_boundaries": a period's forward runs again in its backward, up
    to its last saved tensor)."""
    cfg, tp, mesh = model.cfg, model.tp, model.mesh
    if cfg.remat_policy not in ("nothing", "save_boundaries"):
        raise ValueError("wire_bytes counts the recomputing remat "
                         "policies only")
    sizes = _Sizes(mesh)
    shapes = param_shapes(cfg)
    plans = tree_map(lambda s, sp, u: coll.ViewPlan(s.shape, sp, u, sizes),
                     shapes, tp["specs"], tp["uses"], leaf=PartitionSpec)
    out = dict.fromkeys(coll.WIRE, 0)

    def add(d, k=1):
        for key, v in d.items():
            out[key] += k * v

    rows = batch // mesh.batch_size
    acc = _largest_divisor_leq(batch, cfg.train_accum if accum_steps is None
                               else accum_steps)
    mb = batch // acc
    n_full, n_rem = cfg.n_periods()
    kp = len(cfg.pattern)
    exits = [layer_exits(tp, k) for k in cfg.pattern]
    per_period = sum(map(sum, exits))
    # the Megatron exits of a step's layers; a period's forward runs again
    # in its backward (its checkpoint) up to its last saved tensor: past
    # none of its exits under "save_boundaries" (each half its own
    # checkpoint, ending at its exit), else up to its last exit when its
    # last layer ends with one (nothing after it saves a tensor)
    fwd = n_full * per_period + sum(sum(exits[r % kp]) for r in range(n_rem))
    again = (0 if cfg.remat_policy == "save_boundaries" or not per_period
             else per_period - exits[-1][1])
    f32 = 4
    for lo, hi in pieces(rows, 0, acc, mb):
        r = hi - lo
        act = r * seq * cfg.d_model * f32
        if tp["M"] > 1:
            if tp["embed_vp"]:
                out["all_reduce"] += act
            # forward and recompute; the backward's f at every entry
            out["all_reduce"] += act * (2 * fwd + again * n_full)
            if tp["head_vp"]:
                C = cfg.loss_chunk
                chunked = bool(C) and seq > C and seq % C == 0
                runs = 2 if chunked else 1
                out["all_reduce"] += act + 3 * r * seq * f32 * runs
    for pl in tree_leaves(plans):
        add(pl.view_bytes())
    if mesh.batch_size > 1:
        out["all_reduce"] += f32                                    # loss
    out["all_reduce"] += f32                                        # norm
    return out

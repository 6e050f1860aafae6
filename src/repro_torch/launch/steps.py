"""Step builders and input specs for every (architecture x input shape)
cell (the port of ``repro/launch/steps.py``).

  * the spec builders -- ``param_shardings``, ``opt_shardings``,
    ``batch_specs``, ``cache_specs``, ``input_specs`` -- describe a cell's
    trees laid over a mesh as :class:`ShapeDtypeStruct` trees (shape,
    dtype, ``(mesh, spec)``), nothing allocated, every family;
  * the steps: training with gradient accumulation and AdamW, prefill and
    decode, each a plain function of the model's parameter tree on one
    device; with a mesh of more than one device, every family's steps run
    on the mesh's process grid (training: ``launch/mesh_train.py``;
    prefill and decode: ``launch/mesh_serve.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..core.util import tree_leaves as leaves
from ..core.util import tree_map
from ..data.tokens import to_device
from ..models.config import ModelConfig, ShapeConfig
from ..models.transformer import (Transformer, cache_logical, logical_tree,
                                  param_shapes)
from ..optim import AdamWConfig, adamw_update
from ..sharding.layout import NamedSharding, ShapeDtypeStruct
from ..sharding.rules import (PartitionSpec, batch_axes, logical_to_spec,
                              spec_tree)


# ---------------------------------------------------------------------------
# shardings
# ---------------------------------------------------------------------------

def _struct(shape, dtype, mesh, spec):
    return ShapeDtypeStruct(tuple(int(d) for d in shape), dtype,
                            NamedSharding(mesh, spec))


def param_shardings(model: Transformer, mesh, key=None):
    """(param ShapeDtypeStructs with shardings, logical tree, spec tree);
    the shapes come from a meta-device init (nothing allocated).  ``key``
    is accepted for the reference's signature; shapes do not depend on
    it."""
    shapes = param_shapes(model.cfg)
    logical = logical_tree(model.cfg)
    specs = spec_tree(logical, shapes, mesh)
    structs = tree_map(lambda s, sp: _struct(s.shape, s.dtype, mesh, sp),
                       shapes, specs, leaf=PartitionSpec)
    return structs, logical, specs


def opt_shardings(param_structs, mesh, param_specs):
    """AdamW state shards exactly like the params."""
    def build(sp):
        return tree_map(lambda s, p: _struct(s.shape, s.dtype, mesh, p),
                        param_structs, sp, leaf=PartitionSpec)
    return {"mu": build(param_specs), "nu": build(param_specs),
            "count": _struct((), torch.int32, mesh, PartitionSpec())}


def _axsize(mesh, axes):
    s = 1
    for a in axes:
        s *= mesh.shape[a]
    return s


def _entry(axes):
    """A spec entry of the axes ``axes``: None, a name, or a tuple."""
    axes = tuple(axes)
    return axes if len(axes) > 1 else (axes[0] if axes else None)


def batch_specs(cfg: ModelConfig, shape: ShapeConfig, mesh) -> Dict[str, Any]:
    """ShapeDtypeStructs for one input batch of the given shape: the batch
    over the batch axes when they divide it, else replicated."""
    b = batch_axes(mesh)
    B = shape.batch
    S = 1 if shape.kind == "decode" else shape.seq
    bspec = _entry(b if B % _axsize(mesh, b) == 0 else ())
    specs = {}
    if cfg.embed_input == "tokens":
        specs["tokens"] = _struct((B, S), torch.int32, mesh,
                                  PartitionSpec(bspec))
    else:
        specs["embeds"] = _struct((B, S, cfg.d_model), cfg.cdtype, mesh,
                                  PartitionSpec(bspec, None, None))
    if shape.kind == "train":
        specs["labels"] = _struct((B, S), torch.int32, mesh,
                                  PartitionSpec(bspec))
    if cfg.encoder_len:
        specs["encoder"] = _struct((B, cfg.encoder_len, cfg.d_model),
                                   cfg.cdtype, mesh,
                                   PartitionSpec(bspec, None, None))
    return specs


def _cache_logical(model: Transformer, mesh):
    """Logical axes for decode-cache leaves
    (``models/transformer.py::cache_logical``: KV heads over "model" when
    they divide it, else the cache length)."""
    return cache_logical(model.cfg, mesh)


def cache_specs(model: Transformer, shape: ShapeConfig, mesh):
    """ShapeDtypeStructs (with shardings) for the decode cache (the
    reference's tree: ``pos`` an int32 scalar)."""
    names = _cache_logical(model, mesh)
    cache = Transformer(model.cfg, device="meta").make_cache(shape.batch,
                                                             shape.seq)

    def walk(t, name=None):
        if isinstance(t, dict):
            return {k: walk(v, k if k in names else name)
                    for k, v in t.items()}
        if isinstance(t, list):
            return [walk(v, name) for v in t]
        if not isinstance(t, torch.Tensor):       # "pos"
            return _struct((), torch.int32, mesh, PartitionSpec())
        logical = tuple(names.get(name, ()))[:t.dim()]
        logical = logical + (None,) * (t.dim() - len(logical))
        return _struct(t.shape, t.dtype, mesh,
                       logical_to_spec(t.shape, logical, mesh))
    return walk(cache)


def _largest_divisor_leq(n: int, k: int) -> int:
    """Largest divisor of ``n`` that is <= ``k`` (>=1)."""
    k = max(1, min(n, k))
    while n % k:
        k -= 1
    return k


def _batch_size(batch) -> int:
    return int(np.shape(next(iter(batch.values())))[0])


def loss_and_grads(model: Transformer, params, batch,
                   accum_steps: Optional[int] = None):
    """``(loss, grads)`` of ``model.train_loss`` on ``batch``: the batch
    split along its leading axis into ``acc`` microbatches (the largest
    divisor of B at most ``accum_steps``, default ``cfg.train_accum``),
    run one after another, their gradients summed in float32 and scaled
    by 1 / acc, their losses likewise -- the reference's scan.

    The gradients accumulate in the ``.grad`` of the parameter leaves
    (marked ``requires_grad`` for the microbatches' backward only), one
    microbatch's activations live at a time; ``grads`` is the tree of
    those ``.grad`` tensors, which the caller clears
    (:func:`clear_grads`) once it has used them."""
    batch = to_device(batch, model.device)
    B = _batch_size(batch)
    req = model.cfg.train_accum if accum_steps is None else accum_steps
    acc = _largest_divisor_leq(B, req)
    mb = B // acc
    ps = leaves(params)
    for p in ps:
        p.requires_grad_(True)
        p.grad = None
    total = torch.zeros((), dtype=torch.float32, device=model.device)
    for i in range(acc):
        sub = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
        loss = model.train_loss(params, sub)
        loss.backward()
        total = total + loss.detach()
    for p in ps:
        p.requires_grad_(False)
    grads = tree_map(lambda p: p.grad if p.grad is not None
                     else torch.zeros_like(p), params)
    if acc > 1:
        inv = 1.0 / acc
        total = total * inv
        with torch.no_grad():
            for g in leaves(grads):
                g.mul_(inv)
    return total, grads


def clear_grads(params):
    for p in leaves(params):
        p.grad = None


def make_train_step(model: Transformer, opt_cfg: AdamWConfig,
                    accum_steps: Optional[int] = None):
    """Train step ``(params, opt_state, batch) -> (params, opt_state,
    {"loss", "grad_norm"})``: :func:`loss_and_grads`, then AdamW.

    ``params`` and ``opt_state`` are updated IN PLACE and returned (the
    reference donates both buffers to its jitted step); the metrics are
    0-d tensors on the model's device.  ``batch``: {"tokens", "labels"},
    (B, S) integer numpy arrays or tensors.

    A sharded model (a mesh of more than one device) gets the mesh's step
    instead (``launch/mesh_train.py::make_mesh_train_step``): ``params``
    and ``opt_state`` are handle trees resident on the mesh's ranks."""
    if model.sharded:
        from .mesh_train import make_mesh_train_step
        return make_mesh_train_step(model, opt_cfg, accum_steps)

    def train_step(params, opt_state, batch):
        loss, grads = loss_and_grads(model, params, batch, accum_steps)
        with torch.no_grad():
            params, opt_state, gnorm = adamw_update(opt_cfg, grads,
                                                    opt_state, params)
        clear_grads(params)
        return params, opt_state, {"loss": loss, "grad_norm": gnorm}

    return train_step


def make_prefill_step(model: Transformer, cache_len: int):
    """Prefill ``(params, batch) -> (logits, cache)``; a sharded model
    gets the mesh's step (``launch/mesh_serve.py``: resident parameters,
    the cache's blocks resident on the ranks, a handle cache)."""
    if model.sharded:
        from .mesh_serve import make_mesh_prefill_step
        return make_mesh_prefill_step(model, cache_len)

    def prefill_step(params, batch):
        with torch.no_grad():
            return model.prefill(params, batch, cache_len)

    return prefill_step


def make_decode_step(model: Transformer):
    """Decode ``(params, cache, batch) -> (logits, cache)``, the cache
    updated in place; a sharded model gets the mesh's step."""
    if model.sharded:
        from .mesh_serve import make_mesh_decode_step
        return make_mesh_decode_step(model)

    def serve_step(params, cache, batch):
        with torch.no_grad():
            return model.decode_step(params, cache, batch)

    return serve_step


# ---------------------------------------------------------------------------
# full per-cell spec assembly (what the dry run consumes)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class CellSpecs:
    params: Any
    opt: Optional[Any]
    batch: Any
    cache: Optional[Any]
    fn: Any           # the step of ``kind``; args per kind
    kind: str


def input_specs(cfg: ModelConfig, shape: ShapeConfig, mesh,
                opt_cfg: Optional[AdamWConfig] = None) -> CellSpecs:
    """Every spec tree of one cell and its step function (built, not
    run: a production mesh describes only)."""
    model = Transformer(cfg, device="meta", mesh=mesh)
    pstructs, _, pspecs = param_shardings(model, mesh)
    batch = batch_specs(cfg, shape, mesh)
    if shape.kind == "train":
        opt_cfg = opt_cfg or AdamWConfig()
        ostructs = opt_shardings(pstructs, mesh, pspecs)
        return CellSpecs(pstructs, ostructs, batch, None,
                         make_train_step(model, opt_cfg), "train")
    if shape.kind == "prefill":
        return CellSpecs(pstructs, None, batch, None,
                         make_prefill_step(model, shape.seq), "prefill")
    cache = cache_specs(model, shape, mesh)
    return CellSpecs(pstructs, None, batch, cache,
                     make_decode_step(model), "decode")

"""Decoder stack for training and serving (counterpart of
``repro/models/transformer.py``, every mixer kind of the reference: ATTN,
LOCAL, XATTN, RWKV and RG-LRU, the dense and MoE feed-forwards, the token
and embedding frontends): ``train_loss`` (full-sequence forward, mean token
cross entropy, remat and chunked cross entropy), prefill, ring-buffer
decode (bfloat16 or int8 KV cache) and paged decode.

The parameter tree is the reference's: ``embed``, ``head``,
``final_norm``, ``periods`` (one dict per pattern position whose tensors
carry a leading layer axis) and ``remainder`` (single layers).  Where the
reference runs the periods under ``lax.scan``, the port loops over the
layer index i in Python and reads slice i of the same stacked tensors.
In training (:func:`_layer_slices`) slice i of a stacked leaf that wants a
gradient is a leaf of its own whose ``.grad`` is slice i of the stacked
leaf's ``.grad``: the backward adds each layer's gradient into place as
soon as that layer's backward is done, so no layer's gradient waits for
the others and none is stacked (the peak stays near the four float32
copies of training).  ``loss.backward()`` fills the stacked leaves'
``.grad`` as before; ``torch.autograd.grad`` with respect to a stacked
leaf does not see these slices.

Weights stay in ``param_dtype`` (float32) and every use casts to the
compute dtype, as in the reference; :meth:`Transformer.compute_params`
makes that cast once for the weights that are only ever used cast (the
same numbers: a cast is deterministic), so a decode step does not re-read
the float32 copy.

Caches follow the reference's trees and are updated IN PLACE by the
decode functions, which return the same tensors (the reference donates
the buffers instead); ``cache["pos"]`` is a Python int.  XATTN layers
attend to ``batch["encoder"]`` (stub encoder states) and keep their k / v
of it as a static cache; LOCAL layers keep a ring of ``local_window``
entries; RG-LRU layers keep ``{"h"}``.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..core.util import resolve_device, tree_map
from ..sharding import collectives as coll
from ..sharding.rules import PartitionSpec, logical_to_spec, spec_tree
from .attention import (chunked_attention, decode_attention,
                        decode_attention_partial, full_attention)
from .config import ATTN, LOCAL, RGLRU, RWKV, XATTN, ModelConfig
from .layers import apply_rope, head_rms_norm, rms_norm, trunc_normal
from .moe import MOE_LOGICAL, init_moe, moe_ffn
from .rglru import RGLRU_LOGICAL, init_rglru, rglru_block, rglru_decode
from .rwkv import (CHANNEL_MIX_LOGICAL, RWKV_LOGICAL, init_rwkv,
                   init_rwkv_channel_mix, rwkv_channel_mix, rwkv_time_mix)

#: parameter leaves the reference only ever uses cast to the compute dtype
#: (RG-LRU's ``lam`` is read in float32 and is not among them)
COMPUTE_CAST_LEAVES = frozenset({
    "embed", "head", "wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down",
    "w_r", "w_k", "w_v", "w_g", "w_w", "w_o", "w_in", "w_out", "mix",
    "ln_x", "router", "w_x", "w_i"})

MIXER_KINDS = (ATTN, LOCAL, XATTN, RWKV, RGLRU)


def _kv_quant(x):
    """Symmetric int8 quantization over the head dim: (int8 values,
    float32 absmax / 127 scales without the head dim)."""
    xf = x.float()
    scale = xf.abs().amax(dim=-1) / 127.0
    q = torch.clamp(torch.round(xf / torch.clamp(scale, min=1e-8)[..., None]),
                    -127, 127).to(torch.int8)
    return q, scale


def _kv_dequant(q, scale, dtype):
    return (q.float() * scale[..., None]).to(dtype)


#: the matrix products whose outputs the "save_dots" policy keeps (the
#: reference's ``dots_saveable``)
_DOTS = frozenset({torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
                   torch.ops.aten.addmm.default,
                   torch.ops.aten.baddbmm.default})


def _save_dots(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _save_dots_context():
    return create_selective_checkpoint_contexts(_save_dots)


def _index(tree, i):
    return tree_map(lambda a: a[i], tree)


def _layer_slices(a):
    """The per-layer slices of a stacked leaf for a training forward.  A
    leaf that wants a gradient gives leaves of its own, views of its
    data, each with slice i of its ``.grad`` (zeros, made here if it has
    none) as ``.grad``, so that autograd's accumulation adds layer i's
    gradient into that slice in place; anything else is unbound."""
    if not (torch.is_grad_enabled() and a.requires_grad and a.is_leaf):
        return a.unbind(0)
    if a.grad is None:
        a.grad = torch.zeros_like(a)
    data = a.detach()
    out = []
    for i in range(a.shape[0]):
        s = data[i].requires_grad_(True)
        s.grad = a.grad[i]
        out.append(s)
    return tuple(out)


def check_supported(cfg: ModelConfig):
    """Raise ``ValueError`` for a config the reference would refuse too:
    an unknown mixer kind, frontend or KV-cache dtype."""
    bad = sorted(set(cfg.pattern) - set(MIXER_KINDS))
    if bad:
        raise ValueError(f"{cfg.name}: unknown mixer kinds {bad}")
    if cfg.embed_input not in ("tokens", "embeddings"):
        raise ValueError(f"{cfg.name}: unknown embed_input "
                         f"{cfg.embed_input!r}")
    if cfg.kv_cache_dtype not in ("bfloat16", "int8"):
        raise ValueError(f"{cfg.name}: unknown kv_cache_dtype "
                         f"{cfg.kv_cache_dtype!r}")


def _init_attn(gen, cfg: ModelConfig, n: int, device):
    dm, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.hd
    dt = cfg.pdtype
    s = dm ** -0.5
    p = {
        "wq": trunc_normal(gen, (n, dm, H * hd), s, dt, device),
        "wk": trunc_normal(gen, (n, dm, KV * hd), s, dt, device),
        "wv": trunc_normal(gen, (n, dm, KV * hd), s, dt, device),
        "wo": trunc_normal(gen, (n, H * hd, dm), (H * hd) ** -0.5, dt,
                           device),
    }
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((n, hd), dtype=dt, device=device)
        p["k_norm"] = torch.ones((n, hd), dtype=dt, device=device)
    return p


def _init_mlp(gen, cfg: ModelConfig, n: int, device):
    dm, dff = cfg.d_model, cfg.d_ff
    dt = cfg.pdtype
    return {
        "w_gate": trunc_normal(gen, (n, dm, dff), dm ** -0.5, dt, device),
        "w_up": trunc_normal(gen, (n, dm, dff), dm ** -0.5, dt, device),
        "w_down": trunc_normal(gen, (n, dff, dm), dff ** -0.5, dt, device),
    }


def _attn_logical(cfg: ModelConfig):
    lg = {"wq": ("fsdp", "heads"), "wk": ("fsdp", "kv_heads"),
          "wv": ("fsdp", "kv_heads"), "wo": ("heads", "fsdp")}
    if cfg.qk_norm:
        lg["q_norm"] = (None,)
        lg["k_norm"] = (None,)
    return lg


MLP_LOGICAL = {"w_gate": ("fsdp", "ff"), "w_up": ("fsdp", "ff"),
               "w_down": ("ff", "fsdp")}


def layer_logical(cfg: ModelConfig, kind: str):
    """The logical axes of one layer of ``kind`` (the reference's
    ``_init_layer``'s second result): a tuple of names a dimension."""
    lg: Dict[str, Any] = {"ln1": ("fsdp",), "ln2": ("fsdp",)}
    lg["mixer"] = dict(RWKV_LOGICAL if kind == RWKV else RGLRU_LOGICAL
                       if kind == RGLRU else _attn_logical(cfg))
    lg["mlp"] = dict(CHANNEL_MIX_LOGICAL if kind == RWKV else MOE_LOGICAL
                     if cfg.moe is not None else MLP_LOGICAL)
    return lg


def logical_tree(cfg: ModelConfig):
    """The reference's ``logical`` tree of ``Transformer.init`` for a
    config: ``embed`` ("vocab", "fsdp"), ``head`` ("fsdp", "vocab"),
    ``final_norm``, every layer's names, with a leading None on the
    stacked leaves of ``periods``."""
    n_full, n_rem = cfg.n_periods()
    lg: Dict[str, Any] = {}
    if cfg.embed_input == "tokens":
        lg["embed"] = ("vocab", "fsdp")
    lg["head"] = ("fsdp", "vocab")
    lg["final_norm"] = ("fsdp",)
    lg["periods"] = [tree_map(lambda ax: (None,) + ax,
                              layer_logical(cfg, kind), leaf=tuple)
                     for kind in cfg.pattern] if n_full else []
    lg["remainder"] = [layer_logical(cfg, cfg.pattern[r % len(cfg.pattern)])
                       for r in range(n_rem)]
    return lg


def param_shapes(cfg: ModelConfig):
    """The parameter tree of ``cfg`` as meta tensors: every leaf's shape
    and dtype, nothing allocated (Llama-3.2-Vision-90B's tree included)."""
    return Transformer(cfg, device="meta").init(0)


def cache_logical(cfg: ModelConfig, mesh):
    """Logical axes of the decode-cache leaves (the reference's
    ``launch/steps.py::_cache_logical``): the KV caches shard their KV
    heads over "model" when n_kv divides it (attention stays head-local),
    else the cache length (flash-decoding style: a rank holds L / M of
    every KV head's positions); RWKV-6's state over its heads, RG-LRU's
    ``h`` over its channels, the token-shift carries whole."""
    kv_div = ("model" in mesh.axis_names
              and cfg.n_kv % mesh.shape["model"] == 0)
    kv = ((None, "batch", None, "kv_heads", None) if kv_div
          else (None, "batch", "kv_len", None, None))
    return {
        "k": kv,
        "v": kv,
        "k_scale": kv[:-1],
        "v_scale": kv[:-1],
        "state": (None, "batch", "heads", None, None),
        "x_tm": (None, "batch", "model_dim"),
        "x_cm": (None, "batch", "model_dim"),
        "h": (None, "batch", "ff"),
        "pos": (),
    }


def mesh_size(mesh) -> int:
    return int(math.prod(mesh.shape.values()))


def _kind_layers(cfg: ModelConfig, specs):
    """``{kind: one layer's spec tree}`` (with the stacked layer axis) for
    every mixer kind of the config, from its first period position or
    remainder layer."""
    kp = len(cfg.pattern)
    out = {}
    for kind, t in zip(cfg.pattern, specs["periods"]):
        out.setdefault(kind, t)
    for r, t in enumerate(specs["remainder"]):
        out.setdefault(cfg.pattern[r % kp], tree_map(
            lambda sp: PartitionSpec(None, *sp), t, leaf=PartitionSpec))
    return out


def tp_plan(cfg: ModelConfig, mesh) -> Dict[str, Any]:
    """How "model" splits the work of every layer kind on ``mesh``, read
    off the specs of the rules (each kind's own leaves: a split that the
    work cannot use is gathered instead):

      * ``embed_vp`` / ``head_vp``: the vocabulary split over "model"
        (a vocab-parallel lookup and cross entropy);
      * ``heads_local``: the attention kinds' ``wq`` / ``wo`` split over
        "model" at a head boundary (H % M == 0): each rank runs its H / M
        query heads;
      * ``kv_local``: ``wk`` / ``wv`` likewise (KV % M == 0); with heads
        local but KV heads not (granite's and RecurrentGemma's single KV
        head), the KV projection runs on every rank from ``wk`` / ``wv``
        gathered over "model" -- a spec that splits inside a head is
        never used split;
      * ``ff_local``: the dense MLP's ``d_ff`` split (column- then
        row-parallel);
      * ``moe``: ``"experts"`` (E % M == 0: a rank runs its E / M
        experts), ``"expert_ff"`` (the rules' fallback: every expert on
        the rank's ``d_ff`` columns) or None; the router is gathered and
        its gradient summed over "model" (``partial``) either way;
      * ``rwkv_local``: RWKV-6's time mix on the rank's H / M heads
        (``w_r`` ... ``w_w`` column-, ``w_o`` row-parallel, ``u`` local,
        ``mix`` and ``ln_x`` whole and ``partial``: the activation enters
        "model" before the token-shift mix, and a rank uses ``ln_x`` on
        its channels only); ``cm_local``: the channel mix's ``d_ff``
        (``mix`` whole, ``partial``);
      * ``rglru_local``: RG-LRU's channels (``w_x`` / ``w_r`` / ``w_i``
        column-, ``w_o`` row-parallel, ``lam`` local);
      * ``uses``: every leaf's :class:`~repro_torch.sharding.collectives.
        ViewPlan` use, in the parameter tree's structure."""
    M = mesh.shape.get("model", 1)
    specs = spec_tree(logical_tree(cfg), param_shapes(cfg), mesh)

    def split(spec, dim):
        return "model" in spec.axes(dim)
    kinds = _kind_layers(cfg, specs)
    attn = next((kinds[k]["mixer"] for k in (ATTN, LOCAL, XATTN)
                 if k in kinds), None)
    mlp = next((kinds[k]["mlp"] for k in kinds if k != RWKV), None)
    plan = {
        "M": M,
        "embed_vp": "embed" in specs and split(specs["embed"], 0),
        "head_vp": split(specs["head"], 1),
        "heads_local": (attn is not None and split(attn["wq"], 2)
                        and cfg.n_heads % M == 0),
        "kv_local": (attn is not None and split(attn["wk"], 2)
                     and cfg.n_kv % M == 0),
        "ff_local": (mlp is not None and cfg.moe is None
                     and split(mlp["w_gate"], 2)),
        "moe": (None if mlp is None or cfg.moe is None else "experts"
                if split(mlp["w_gate"], 1) else "expert_ff"
                if split(mlp["w_gate"], 3) else None),
        "rwkv_local": (RWKV in kinds and split(kinds[RWKV]["mixer"]["w_r"], 2)
                       and cfg.rwkv_heads % M == 0),
        "cm_local": RWKV in kinds and split(kinds[RWKV]["mlp"]["w_in"], 2),
        "rglru_local": (RGLRU in kinds
                        and split(kinds[RGLRU]["mixer"]["w_x"], 2)),
    }
    plan["kv_local"] &= plan["heads_local"]

    def use(local, gathered="replicated"):
        return "local" if local else gathered
    hq = use(plan["heads_local"])
    hkv = use(plan["kv_local"], "partial" if plan["heads_local"]
              else "replicated")
    norm = "partial" if plan["heads_local"] else "replicated"
    rw, cm = plan["rwkv_local"], plan["cm_local"]
    ex = use(plan["moe"] is not None)
    mixers = {
        "attn": {"wq": hq, "wk": hkv, "wv": hkv, "wo": hq,
                 "q_norm": norm, "k_norm": norm},
        RWKV: {**dict.fromkeys(("w_r", "w_k", "w_v", "w_g", "w_w", "w_o",
                                "u"), use(rw)),
               "mix": "partial" if rw else "replicated",
               "ln_x": "partial" if rw else "replicated"},
        RGLRU: dict.fromkeys(("w_x", "w_r", "w_i", "w_o", "lam"),
                             use(plan["rglru_local"]))}
    mlps = {
        "dense": dict.fromkeys(("w_gate", "w_up", "w_down"),
                               use(plan["ff_local"])),
        "moe": {"router": "partial" if plan["moe"] else "replicated",
                "w_gate": ex, "w_up": ex, "w_down": ex},
        RWKV: {"w_in": use(cm), "w_out": use(cm),
               "mix": "partial" if cm else "replicated"}}

    def layer_uses(kind, t):
        mixer = mixers.get(kind, mixers["attn"])
        mlp_u = mlps[RWKV if kind == RWKV else "moe" if cfg.moe is not None
                     else "dense"]
        return {"ln1": "replicated", "ln2": "replicated",
                "mixer": {n: mixer[n] for n in t["mixer"]},
                "mlp": {n: mlp_u[n] for n in t["mlp"]}}

    top = {"embed": use(plan["embed_vp"]), "head": use(plan["head_vp"]),
           "final_norm": "replicated"}
    kp = len(cfg.pattern)
    plan["uses"] = {
        **{k: top[k] for k in specs if k not in ("periods", "remainder")},
        "periods": [layer_uses(k, t) for k, t in zip(cfg.pattern,
                                                     specs["periods"])],
        "remainder": [layer_uses(cfg.pattern[r % kp], t)
                      for r, t in enumerate(specs["remainder"])]}
    plan["specs"] = specs
    return plan


def layer_exits(tp, kind) -> tuple:
    """(mixer, MLP) of a layer of ``kind`` under the plan ``tp``: 1 where
    that half leaves "model" through a Megatron all-reduce, else 0."""
    mixer = (tp["rwkv_local"] if kind == RWKV else tp["rglru_local"]
             if kind == RGLRU else tp["heads_local"])
    mlp = (tp["cm_local"] if kind == RWKV
           else tp["moe"] is not None or tp["ff_local"])
    return int(bool(mixer)), int(bool(mlp))


def owned_slot(slot: int, rows: int, index: int):
    """Where global cache slot ``slot`` lies in the block of ``rows``
    slots that the rank at ``index`` of its "model" group holds (slots
    ``[index * rows, (index + 1) * rows)``), or None: only that rank
    writes a decoded token there."""
    j = slot - index * rows
    return j if 0 <= j < rows else None


def _init_layers(gen, cfg: ModelConfig, kind: str, n: int, device):
    """``n`` stacked layers of ``kind`` (leading axis n)."""
    dt = cfg.pdtype
    p: Dict[str, Any] = {
        "ln1": torch.ones((n, cfg.d_model), dtype=dt, device=device),
        "ln2": torch.ones((n, cfg.d_model), dtype=dt, device=device)}
    if kind == RWKV:
        p["mixer"] = init_rwkv(gen, cfg, n, device)
    elif kind == RGLRU:
        p["mixer"] = init_rglru(gen, cfg, n, device)
    else:
        p["mixer"] = _init_attn(gen, cfg, n, device)
    if kind == RWKV:
        p["mlp"] = init_rwkv_channel_mix(gen, cfg, n, device)
    elif cfg.moe is not None:
        p["mlp"] = init_moe(gen, cfg, n, device)
    else:
        p["mlp"] = _init_mlp(gen, cfg, n, device)
    return p


class Transformer:
    """The decoder for one ``ModelConfig`` on one device, or one rank's
    part of it on a mesh.

    ``device`` defaults to ``"cuda"`` and raises without a card; pass
    ``device="cpu"`` to run the plain versions of the kernels there.

    ``mesh`` (the reference's ``Transformer(cfg, mesh=)``): a mesh of
    more than one device makes the model *sharded*.  With a
    ``launch.mesh.Mesh`` it describes the layout (spec trees,
    ``launch/steps.py::make_train_step`` drives the ranks); with a rank's
    ``launch.mesh.RankMesh`` it computes that rank's part of a training
    forward: the parameters it takes are the rank's views of its blocks,
    each made by the leaf's
    :class:`~repro_torch.sharding.collectives.ViewPlan` in
    ``view_plans`` (gathered over the batch axes; over "model" only where
    the split is not the work's -- :func:`tp_plan`) once a step by
    ``launch/mesh_train.py``.  "model" splits the work Megatron's way
    (:func:`tp_plan`): the query / KV heads of a rank (column-parallel
    ``wq`` / ``wk`` / ``wv``, row-parallel ``wo``, an all-reduce) for every
    attention kind, RWKV-6's heads and RG-LRU's channels likewise, the
    ``d_ff`` of the MLP and of the RWKV channel mix, the experts of a MoE
    (or every expert's ``d_ff``), the vocabulary of ``embed`` (a masked
    lookup, an all-reduce) and of ``head`` (the vocab-parallel cross
    entropy); the activations keep the reference's ("batch", None, None)
    layout.

    Prefill and decode on a rank run the same split (``launch/
    mesh_serve.py`` drives them) and keep the rank's block of the decode
    cache, exactly the block of ``launch/steps.py::cache_specs``
    (:func:`cache_logical`): its rows, and its KV heads where n_kv % M ==
    0, else its L / M cache positions (where they divide), RWKV-6's state
    on its heads, RG-LRU's ``h`` on its channels.  A length-split cache
    decodes flash-decoding style: the rank's query heads all-gathered over
    "model", every head's (max, sum, output) over the rank's slots, the
    partials merged by a log-sum-exp all-reduce over "model"
    (``sharding/collectives.py::merge_partials``), the rank's heads kept
    for the row-parallel ``wo``; only the rank that holds slot pos % L
    writes the decoded token.  The logits come back whole (a
    vocab-parallel head's columns all-gathered over "model").  Paged
    decode runs on one device only.
    """

    def __init__(self, cfg: ModelConfig, device="cuda", mesh=None):
        check_supported(cfg)
        self.cfg = cfg
        from ..launch.mesh import RankMesh
        on_rank = isinstance(mesh, RankMesh)
        self.device = mesh.device if on_rank else resolve_device(device)
        self.mesh = mesh
        self.sharded = mesh is not None and mesh_size(mesh) > 1
        self.tp = tp_plan(cfg, mesh) if self.sharded else None
        #: on a rank: every leaf's ViewPlan, in the parameters' structure
        self.view_plans = (self._view_plans() if self.tp is not None
                           and on_rank else None)

    # ---- the mesh ----
    def check_mesh_compute(self, what: str = "training"):
        """Raise unless this model can run ``what`` where it is: a sharded
        model computes training, logits, prefill and decode only on a
        rank, and paged decode not at all."""
        if not self.sharded:
            return
        if what == "paged decode":
            raise NotImplementedError(
                f"{self.cfg.name}: paged decode runs on one device, not "
                f"over a mesh of {mesh_size(self.mesh)} devices (the "
                "reference's paged decode constrains nothing and never "
                "runs over a mesh)")
        if self.view_plans is None:
            route = ("launch.steps.make_train_step" if what == "training"
                     else "launch.steps.make_prefill_step / "
                     "make_decode_step")
            raise RuntimeError(
                f"{self.cfg.name} over {self.mesh!r}: this model describes "
                f"the layout; its {what} runs on the mesh's ranks "
                f"({route})")

    def _view_plans(self):
        mesh, tp = self.mesh, self.tp
        return tree_map(lambda s, sp, u: coll.ViewPlan(s.shape, sp, u, mesh),
                        param_shapes(self.cfg), tp["specs"], tp["uses"],
                        leaf=PartitionSpec)

    def _group(self, axes=("model",)):
        return self.mesh.group(axes)

    def _sum_model(self, x):
        """Megatron's exit: the rank's partial product summed over "model"
        (in float32 on the wire, back in ``x``'s dtype)."""
        return coll.reduce_from(x.float(), self._group()).to(x.dtype)

    def _enter_model(self, x):
        """Megatron's entry: identity forward, dL/dx summed over "model"
        backward."""
        return coll.copy_to(x, self._group())

    def _split(self, what: str) -> bool:
        """Whether "model" splits ``what`` (a key of :func:`tp_plan`)."""
        return self.tp is not None and bool(self.tp[what])

    def _own(self, t, dim: int):
        """This rank's block of ``t`` along ``dim`` of M blocks over
        "model"."""
        return coll.own_block(t, dim, self.tp["M"],
                              self.mesh.coords["model"])

    def _cache_split(self, name: str, shape) -> tuple:
        """The dims of a cache leaf ``name`` of (global, layer axis left
        out) ``shape`` that its spec (:func:`cache_logical`) splits over
        "model" -- on a sharded model; () on one device."""
        if not self.sharded or self.tp["M"] == 1:
            return ()
        logical = cache_logical(self.cfg, self.mesh)[name][1:]
        spec = logical_to_spec(shape, logical, self.mesh)
        return tuple(d for d in range(len(shape)) if "model" in spec.axes(d))

    def _gather_vocab(self, logits):
        """Whole logits from a vocab-parallel head's columns."""
        if not self._split("head_vp"):
            return logits
        return coll.all_gather(logits.float(), logits.dim() - 1,
                               self._group(), self.tp["M"])

    def _heads(self):
        """(query heads, KV heads of the projection, KV heads to pick
        per query group or None) of this rank's attention."""
        cfg, tp = self.cfg, self.tp
        H, KV = cfg.n_heads, cfg.n_kv
        if tp is None or not tp["heads_local"]:
            return H, KV, None
        M = tp["M"]
        if tp["kv_local"]:
            return H // M, KV // M, None
        h_loc, G = H // M, H // KV
        q0 = self.mesh.coords["model"] * h_loc
        of = [(q0 + i) // G for i in range(h_loc)]
        u = sorted(set(of))
        if h_loc % len(u) == 0 and of == [k for k in u
                                          for _ in range(h_loc // len(u))]:
            return h_loc, KV, u
        return h_loc, KV, of

    # ---- init ----
    def init(self, seed: int = 0) -> Dict[str, Any]:
        """Random parameters in ``param_dtype`` on the model's device,
        drawn from a ``torch.Generator`` seeded with ``seed`` (numbers
        differ from the reference's ``jax.random``; the tree and the
        distributions are the same)."""
        cfg, dev = self.cfg, self.device
        # a meta tree (``param_shapes``) draws nothing: a host generator
        gen = torch.Generator(device=dev if dev.type != "meta" else "cpu")
        gen.manual_seed(int(seed))
        n_full, n_rem = cfg.n_periods()
        dt = cfg.pdtype
        params: Dict[str, Any] = {}
        if cfg.embed_input == "tokens":
            params["embed"] = trunc_normal(gen, (cfg.vocab, cfg.d_model),
                                           1.0, dt, dev)
        params["head"] = trunc_normal(gen, (cfg.d_model, cfg.vocab),
                                      cfg.d_model ** -0.5, dt, dev)
        params["final_norm"] = torch.ones((cfg.d_model,), dtype=dt,
                                          device=dev)
        params["periods"] = [_init_layers(gen, cfg, kind, n_full, dev)
                             for kind in cfg.pattern] if n_full else []
        params["remainder"] = [
            _index(_init_layers(gen, cfg, cfg.pattern[r % len(cfg.pattern)],
                                1, dev), 0)
            for r in range(n_rem)]
        return params

    def compute_params(self, params):
        """The tree with every leaf of ``COMPUTE_CAST_LEAVES`` cast to the
        compute dtype once (other leaves -- norms, u -- are shared, not
        copied).  Every function of this class gives the same numbers on
        either tree."""
        cdt = self.cfg.cdtype

        def walk(t, name=None):
            if isinstance(t, dict):
                return {k: walk(v, k) for k, v in t.items()}
            if isinstance(t, list):
                return [walk(v, name) for v in t]
            return t.to(cdt) if name in COMPUTE_CAST_LEAVES else t
        return walk(params)

    # ---- building blocks ----
    def _embed(self, params, batch):
        """Token ids through ``embed``, or (``embed_input="embeddings"``)
        ``batch["embeds"]`` (B, S, d_model) as they are; in the compute
        dtype either way."""
        if self.cfg.embed_input == "tokens":
            tokens = torch.as_tensor(batch["tokens"], device=self.device)
            E = params["embed"]
            if self.tp is None or not self.tp["embed_vp"]:
                return E[tokens.long()].to(self.cfg.cdtype)
            # vocab-parallel: this rank's rows, zeros elsewhere, summed
            lo = self.mesh.coords["model"] * E.shape[0]
            local = tokens.long() - lo
            hit = (local >= 0) & (local < E.shape[0])
            rows = E[torch.where(hit, local, torch.zeros_like(local))]
            rows = torch.where(hit[..., None], rows, torch.zeros_like(rows))
            return coll.reduce_from(rows.float(), self._group()).to(
                self.cfg.cdtype)
        return torch.as_tensor(batch["embeds"], device=self.device).to(
            self.cfg.cdtype)

    def _encoder(self, batch):
        """The stub encoder states of ``batch`` (XATTN's k / v source) in
        the compute dtype, or None."""
        enc = batch.get("encoder") if isinstance(batch, dict) else None
        if enc is None:
            return None
        return torch.as_tensor(enc, device=self.device).to(self.cfg.cdtype)

    def _mlp(self, p, x, kind, x_last=None):
        cfg, tp = self.cfg, self.tp
        if kind == RWKV:
            split = tp is not None and tp["cm_local"]
            out = rwkv_channel_mix(p, self._enter_model(x) if split else x,
                                   cfg, x_last=x_last)[0]
            return self._sum_model(out) if split else out
        if cfg.moe is not None:
            if tp is None or tp["moe"] is None:
                return moe_ffn(p, x, cfg)
            # every rank routes all of its tokens; its experts' part summed
            first = (self.mesh.coords["model"] * p["w_gate"].shape[0]
                     if tp["moe"] == "experts" else 0)
            out = moe_ffn(p, self._enter_model(x), cfg, first_expert=first,
                          partial=True)
            return self._sum_model(out).to(x.dtype)
        cdt = cfg.cdtype
        split = tp is not None and tp["ff_local"]
        if split:
            x = self._enter_model(x)
        h = F.silu(x @ p["w_gate"].to(cdt)) * (x @ p["w_up"].to(cdt))
        out = h @ p["w_down"].to(cdt)
        return self._sum_model(out) if split else out

    def _q(self, p, h):
        """The (rank's) query heads of ``h``, normed where the config
        says."""
        cfg, cdt = self.cfg, self.cfg.cdtype
        B, S, _ = h.shape
        q = (h @ p["wq"].to(cdt)).reshape(B, S, self._heads()[0], cfg.hd)
        if cfg.qk_norm:
            q = head_rms_norm(q, p["q_norm"], cfg.norm_eps)
        return q

    def _qkv(self, p, h, src=None):
        """q of ``h``, k and v of ``src`` (XATTN's encoder states; ``h``
        by default), q / k normed where the config says.  k and v are
        the projection's KV heads (all of them where a rank's heads read
        a pick of them: :meth:`_picked`)."""
        cfg, cdt = self.cfg, self.cfg.cdtype
        src = h if src is None else src
        B, Skv = src.shape[:2]
        KV, hd = self._heads()[1], cfg.hd
        k = (src @ p["wk"].to(cdt)).reshape(B, Skv, KV, hd)
        v = (src @ p["wv"].to(cdt)).reshape(B, Skv, KV, hd)
        if cfg.qk_norm:
            k = head_rms_norm(k, p["k_norm"], cfg.norm_eps)
        return self._q(p, h), k, v

    def _picked(self, k, v):
        """The KV heads this rank's query heads read, in their order (k
        and v as they are where there is no pick)."""
        pick = self._heads()[2]
        if pick is None:
            return k, v
        return k[:, :, pick], v[:, :, pick]

    def _window(self, kind):
        return self.cfg.swa_window if kind == ATTN else self.cfg.local_window

    def _attn_seq(self, p, h, kind, positions, enc):
        """Attention of a whole sequence: (out (B, S, H, hd), k, v) with
        k / v as the cache keeps them (after RoPE; XATTN's of the encoder,
        no RoPE, non-causal)."""
        cfg = self.cfg
        attn = (chunked_attention if cfg.attn_impl == "chunked"
                else full_attention)
        if kind == XATTN:
            q, k, v = self._qkv(p, h, enc)
            return attn(q, *self._picked(k, v), causal=False,
                        window=None), k, v
        q, k, v = self._qkv(p, h)
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
        ka, va = self._picked(k, v)
        #: the query / KV heads of the last sequence attention (on a
        #: mesh: this rank's)
        self.last_heads = (q.shape[2], ka.shape[2])
        return attn(q, ka, va, causal=True, window=self._window(kind)), k, v

    def _final_logits(self, params, x):
        cfg = self.cfg
        x = rms_norm(x, params["final_norm"], cfg.norm_eps)
        return self._gather_vocab((x @ params["head"].to(cfg.cdtype))
                                  .float())

    # ---- train ----
    def _attn_train(self, p, x, kind, positions, enc):
        if self._split("heads_local"):
            x = self._enter_model(x)
        return self._wo(p, self._attn_seq(p, x, kind, positions, enc)[0])

    def _mixer_train(self, p, x, kind, positions, enc=None):
        """ln1 and the mixer: the residual branch of the first half."""
        h = rms_norm(x, p["ln1"], self.cfg.norm_eps)
        if kind not in (RWKV, RGLRU):
            return self._attn_train(p["mixer"], h, kind, positions, enc)
        return self._recurrent(p["mixer"], h, kind)[0]

    def _mlp_train(self, p, x, kind):
        """ln2 and the MLP: the residual branch of the second half."""
        return self._mlp(p["mlp"], rms_norm(x, p["ln2"], self.cfg.norm_eps),
                         kind)

    def _layer_train(self, p, x, kind, positions, enc=None):
        x = x + self._mixer_train(p, x, kind, positions, enc)
        return x + self._mlp_train(p, x, kind)

    def _backbone_train(self, params, x, positions, enc=None):
        """The layers over the whole sequence.  Each full period runs under
        the config's ``remat_policy`` (the reference's ``jax.checkpoint``
        of its scan body), the remainder layers without:

          * ``"nothing"``: the period under one checkpoint -- only its
            input is saved, the backward re-runs it;
          * ``"save_boundaries"``: the mixer and the MLP each under a
            checkpoint of its own, so the residual stream between them
            (their outputs added in) is what is saved;
          * ``"save_dots"``: the period under a selective checkpoint that
            saves every matrix product's output and recomputes the rest.

        The reference's ``unroll`` (a scan's unrolling) has no meaning
        here: the periods are a Python loop either way."""
        cfg = self.cfg
        kp = len(cfg.pattern)
        if params["periods"]:
            # slice i of every stacked leaf (its gradient added in place)
            layers = [tree_map(_layer_slices, t) for t in params["periods"]]
            n_full = len(params["periods"][0]["ln1"])
            for i in range(n_full):
                ps = [tree_map(lambda a: a[i], t, leaf=tuple)
                      for t in layers]
                x = self._period_train(ps, x, positions, enc)
        for r, p in enumerate(params["remainder"]):
            x = self._layer_train(p, x, cfg.pattern[r % kp], positions, enc)
        return x

    def _period_train(self, ps, x, positions, enc=None):
        cfg = self.cfg
        kinds = cfg.pattern

        def body(xc):
            for p, kind in zip(ps, kinds):
                xc = self._layer_train(p, xc, kind, positions, enc)
            return xc

        if not torch.is_grad_enabled():
            return body(x)
        if cfg.remat_policy == "save_boundaries":
            for p, kind in zip(ps, kinds):
                x = x + checkpoint(self._mixer_train, p, x, kind, positions,
                                   enc, use_reentrant=False)
                x = x + checkpoint(self._mlp_train, p, x, kind,
                                   use_reentrant=False)
            return x
        if cfg.remat_policy == "save_dots":
            return checkpoint(body, x, use_reentrant=False,
                              context_fn=_save_dots_context)
        if cfg.remat_policy != "nothing":
            raise ValueError(f"unknown remat_policy {cfg.remat_policy!r}")
        return checkpoint(body, x, use_reentrant=False)

    def _hidden_fn(self, params, batch):
        """Backbone forward up to (and including) the final norm."""
        cfg = self.cfg
        x = self._embed(params, batch)
        positions = torch.arange(x.shape[1], device=self.device)
        x = self._backbone_train(params, x, positions, self._encoder(batch))
        return rms_norm(x, params["final_norm"], cfg.norm_eps)

    def logits_fn(self, params, batch):
        """Logits (B, S, V) float32 of every position of ``batch`` (on a
        rank: of its rows, the whole vocabulary)."""
        self.check_mesh_compute("logits")
        x = self._hidden_fn(params, batch)
        return self._gather_vocab((x @ params["head"].to(self.cfg.cdtype))
                                  .float())

    def train_loss(self, params, batch, tokens=None):
        """Mean next-token cross entropy of ``batch`` ({"tokens",
        "labels"}: (B, S) integers), a 0-d float32 tensor: the sum over
        its tokens divided by ``tokens`` (default B * S; a rank of a mesh
        divides its rows' sum by its whole microbatch's count).

        With ``loss_chunk`` = C, S > C and C dividing S, the head and the
        cross entropy run C tokens at a time, each chunk under a
        checkpoint: the (B, C, vocab) float32 logits exist for one chunk
        at a time and the backward recomputes them chunk by chunk;
        otherwise in one pass -- the reference's condition.  With the
        vocabulary split over "model", a rank's chunk holds its (B, C,
        V / M) logits only (``VocabParallelNLL``)."""
        cfg = self.cfg
        self.check_mesh_compute()
        x = self._hidden_fn(params, batch)
        labels = torch.as_tensor(batch["labels"], device=self.device).long()
        head = params["head"]
        B, S = labels.shape
        C = cfg.loss_chunk
        tokens = B * S if tokens is None else tokens
        vp = self.tp is not None and self.tp["head_vp"]
        if vp:
            x = self._enter_model(x)
            lo = self.mesh.coords["model"] * head.shape[1]

        def chunk_nll(xc, lc):
            logits = (xc @ head.to(cfg.cdtype)).float()
            if vp:
                return torch.sum(coll.VocabParallelNLL.apply(
                    logits, lc, lo, self._group()))
            logz = torch.logsumexp(logits, dim=-1)
            gold = torch.gather(logits, -1, lc[..., None])[..., 0]
            return torch.sum(logz - gold)

        if not C or S <= C or S % C:
            return chunk_nll(x, labels) / tokens
        total = torch.zeros((), dtype=torch.float32, device=self.device)
        for i in range(S // C):
            sl = slice(i * C, (i + 1) * C)
            if torch.is_grad_enabled():
                total = total + checkpoint(chunk_nll, x[:, sl], labels[:, sl],
                                           use_reentrant=False)
            else:
                total = total + chunk_nll(x[:, sl], labels[:, sl])
        return total / tokens

    def _layers(self, params):
        """(layer params, kind) in order: periods, then remainder."""
        cfg = self.cfg
        if params["periods"]:
            n_full = len(params["periods"][0]["ln1"])
            for i in range(n_full):
                for j, kind in enumerate(cfg.pattern):
                    yield _index(params["periods"][j], i), kind
        for r, p in enumerate(params["remainder"]):
            yield p, cfg.pattern[r % len(cfg.pattern)]

    # ---- caches ----
    def _cache_len(self, kind, cache_len):
        cfg = self.cfg
        if kind == ATTN and cfg.swa_window is not None:
            return min(cache_len, cfg.swa_window)
        if kind == LOCAL:
            return min(cache_len, cfg.local_window)
        if kind == XATTN:
            return max(cfg.encoder_len, 1)
        return cache_len

    def _int8(self, kind):
        """Whether ``kind``'s cache is stored in int8 (XATTN's static
        encoder cache never is)."""
        return self.cfg.kv_cache_dtype == "int8" and kind != XATTN

    def init_cache(self, batch_size, cache_len, *, n_layers, kind):
        """Zero cache subtree for ``n_layers`` stacked layers of ``kind``."""
        cfg, dev = self.cfg, self.device
        B, n = batch_size, n_layers
        cdt = cfg.cdtype
        if kind == RWKV:
            H, D = cfg.rwkv_heads, cfg.rwkv_head_dim
            return {"state": torch.zeros((n, B, H, D, D), device=dev),
                    "x_tm": torch.zeros((n, B, cfg.d_model), dtype=cdt,
                                        device=dev),
                    "x_cm": torch.zeros((n, B, cfg.d_model), dtype=cdt,
                                        device=dev)}
        if kind == RGLRU:
            return {"h": torch.zeros((n, B, cfg.d_model), device=dev)}
        L = self._cache_len(kind, cache_len)
        kv = (n, B, L, cfg.n_kv, cfg.hd)
        if self._int8(kind):
            return {"k": torch.zeros(kv, dtype=torch.int8, device=dev),
                    "v": torch.zeros(kv, dtype=torch.int8, device=dev),
                    "k_scale": torch.zeros(kv[:-1], device=dev),
                    "v_scale": torch.zeros(kv[:-1], device=dev)}
        return {"k": torch.zeros(kv, dtype=cdt, device=dev),
                "v": torch.zeros(kv, dtype=cdt, device=dev)}

    def make_cache(self, batch_size, cache_len):
        cfg = self.cfg
        n_full, n_rem = cfg.n_periods()
        return {
            "pos": 0,
            "periods": [self.init_cache(batch_size, cache_len,
                                        n_layers=n_full, kind=k)
                        for k in cfg.pattern] if n_full else [],
            "remainder": [self.init_cache(batch_size, cache_len, n_layers=1,
                                          kind=cfg.pattern[r % len(
                                              cfg.pattern)])
                          for r in range(n_rem)]}

    # ---- prefill ----
    def _recurrent(self, p, h, kind, cache=None):
        """An RWKV-6 time mix or RG-LRU block of ``h`` -- over a whole
        sequence, or (``cache``: the layer's carries) one decoded token --
        on the rank's heads / channels where "model" splits them (its exit
        summed): (out, the cache entries it leaves)."""
        cfg = self.cfg
        split = self._split("rwkv_local" if kind == RWKV else "rglru_local")
        hin = self._enter_model(h) if split else h
        if kind == RWKV:
            heads = p["u"].shape[0]
            out, (x_tm, state) = rwkv_time_mix(
                p, hin, cfg, channel0=(self.mesh.coords["model"] * heads
                                       * cfg.rwkv_head_dim if split else 0),
                x_last=None if cache is None else cache["x_tm"],
                state=None if cache is None else cache["state"])
            new = {"state": state, "x_tm": x_tm.to(cfg.cdtype)}
            #: the heads of the last RWKV time mix (on a mesh: this rank's)
            self.last_scan = ("rwkv", heads)
        else:
            out, hs = (rglru_block(p, hin, cfg) if cache is None
                       else rglru_decode(p, hin, cfg, state=cache["h"]))
            new = {"h": hs}
            #: ... or the channels of the last RG-LRU scan
            self.last_scan = ("rglru", p["lam"].shape[-1])
        return (self._sum_model(out) if split else out), new

    def _wo(self, p, out):
        """The attention heads ``out`` (B, S, heads, hd) through ``wo``
        (row-parallel on a rank's heads: its exit summed)."""
        B, S = out.shape[:2]
        y = out.reshape(B, S, out.shape[2] * self.cfg.hd) @ p["wo"].to(
            self.cfg.cdtype)
        return self._sum_model(y) if self._split("heads_local") else y

    def _rank_block(self, name: str, t, local: tuple = ()):
        """The block of cache leaf ``name`` that this rank keeps, from the
        rank's tensor ``t`` (no layer axis; its rows; ``local``: the dims
        it already holds only its "model" block of): the dims the spec
        splits over "model" cut to the rank's block."""
        if not self.sharded or self.tp["M"] == 1:
            return t
        M = self.tp["M"]
        shape = tuple(n * (M if d in local else 1)
                      for d, n in enumerate(t.shape))
        split = self._cache_split(name, shape)
        if set(local) - set(split):
            raise ValueError(f"cache leaf {name!r}: the rank computed dims "
                             f"{local} split, its spec splits {split}")
        for d in split:
            if d not in local:
                t = self._own(t, d)
        return t

    def _layer_prefill(self, p, x, kind, positions, cache_len, enc=None,
                       linear_cache=False):
        """One layer over the whole sequence; returns (x, cache entry).

        ``linear_cache=True`` (paged serving): attention layers return the
        prompt's raw full-length k/v (no ring buffer, no padding to
        ``cache_len``, no int8) for the caller to scatter into a paged
        arena.  On a rank, the entry is the rank's block of the cache."""
        cfg, cdt = self.cfg, self.cfg.cdtype
        S = x.shape[1]
        h = rms_norm(x, p["ln1"], cfg.norm_eps)
        if kind in (RWKV, RGLRU):
            mix, cache = self._recurrent(p["mixer"], h, kind)
            x = x + mix
            h2 = rms_norm(x, p["ln2"], cfg.norm_eps)
            if kind == RWKV:
                cache["x_cm"] = h2[:, -1].to(cdt)
                cache["state"] = self._rank_block(
                    "state", cache["state"],
                    (1,) if self._split("rwkv_local") else ())
            else:
                cache["h"] = self._rank_block(
                    "h", cache["h"], (1,) if self._split("rglru_local")
                    else ())
            return x + self._mlp(p["mlp"], h2, kind), cache
        split = self._split("heads_local")
        out, k, v = self._attn_seq(p["mixer"],
                                   self._enter_model(h) if split else h,
                                   kind, positions, enc)
        L = self._cache_len(kind, cache_len)
        Skv = k.shape[1]
        if kind == XATTN or linear_cache:
            # XATTN: the static encoder cache; paged: full length, unrolled
            ck, cv = k, v
        elif L >= Skv:
            ck = F.pad(k, (0, 0, 0, 0, 0, L - Skv))
            cv = F.pad(v, (0, 0, 0, 0, 0, L - Skv))
        else:
            # ring buffer: keep the last L, placed at slot pos % L
            shift = S % L
            ck = torch.roll(k[:, -L:], shift, dims=1)
            cv = torch.roll(v[:, -L:], shift, dims=1)
        if self._int8(kind) and not linear_cache:
            ck, sk = _kv_quant(ck)
            cv, sv = _kv_quant(cv)
            cache = {"k": ck, "v": cv, "k_scale": sk, "v_scale": sv}
        else:
            cache = {"k": ck, "v": cv}
        local = (2,) if self._split("kv_local") else ()
        cache = {n: self._rank_block(n, t, local) for n, t in cache.items()}
        x = x + self._wo(p["mixer"], out)
        h2 = rms_norm(x, p["ln2"], cfg.norm_eps)
        return x + self._mlp(p["mlp"], h2, kind), cache

    def prefill(self, params, batch, cache_len, *, last_pos=None,
                linear_cache=False):
        """Forward pass that also materialises the decode caches.

        ``batch``: {"tokens": (B, S)} (or {"embeds": (B, S, d_model)}),
        with ``"encoder"`` (B, encoder_len, d_model) for XATTN layers.
        ``last_pos``: position whose next-token logits to return
        (default: the last); serving prefills pad prompts to a bucket
        length, so the real last token sits mid-way.  ``linear_cache``:
        raw full-length k/v per attention layer (see ``_layer_prefill``;
        one device only).  Returns (logits (B, 1, V) float32, cache); on a
        rank, its rows' logits and its blocks of the cache, which also
        keeps ``cache_len`` (its decode reads the global lengths)."""
        self.check_mesh_compute("prefill")
        if linear_cache and self.sharded:
            self.check_mesh_compute("paged decode")
        cfg = self.cfg
        x = self._embed(params, batch)
        enc = self._encoder(batch)
        B, S = x.shape[:2]
        positions = torch.arange(S, device=self.device)
        kp = len(cfg.pattern)
        per_pos: List[List[dict]] = [[] for _ in range(kp)]
        caches_r = []
        n_period_layers = (len(params["periods"][0]["ln1"]) * kp
                           if params["periods"] else 0)
        for li, (p, kind) in enumerate(self._layers(params)):
            x, c = self._layer_prefill(p, x, kind, positions, cache_len,
                                       enc, linear_cache=linear_cache)
            if li < n_period_layers:
                per_pos[li % kp].append(c)
            else:
                caches_r.append(tree_map(lambda a: a[None], c))
        caches_p = ([tree_map(lambda *xs: torch.stack(xs), *cs)
                     for cs in per_pos] if n_period_layers else [])
        last = S - 1 if last_pos is None else int(last_pos)
        logits = self._final_logits(params, x[:, last:last + 1])
        cache = {"pos": S, "periods": caches_p, "remainder": caches_r}
        if self.sharded:
            cache["cache_len"] = int(cache_len)
        return logits, cache

    # ---- decode ----
    def _decode_attn(self, q, ak, av, last: int, L: int):
        """One token's attention over a layer's cache (the rank's block of
        it), every slot up to global index ``last`` valid; ``L`` the
        cache's global length.  A length-split cache (the rank holds L / M
        slots of every KV head): the query heads gathered over "model",
        each head's partial over the rank's slots, merged over "model",
        the rank's heads kept."""
        B, KV, hd = q.shape[0], self.cfg.n_kv, self.cfg.hd
        if 1 not in self._cache_split("k", (B, L, KV, hd)):
            return decode_attention(q, *self._picked(ak, av), last)
        g, M = self._group(), self.tp["M"]
        heads = self._split("heads_local")
        qa = (coll.all_gather(q.float(), 2, g, M).to(q.dtype) if heads
              else q)
        n = ak.shape[1]
        first = self.mesh.coords["model"] * n
        valid = torch.arange(first, first + n, device=q.device) <= last
        out = coll.merge_partials(*decode_attention_partial(qa, ak, av,
                                                            valid), g)
        out = out.to(q.dtype)[:, None]
        return self._own(out, 2) if heads else out

    def _layer_decode(self, p, x, cache, kind, pos: int, cache_len=None):
        """x: (B,1,dm); cache: this layer's subtree (no leading layer
        axis), written in place; ``cache_len``: the cache's global length
        (a rank's; on one device the cache's own)."""
        cfg, cdt = self.cfg, self.cfg.cdtype
        h = rms_norm(x, p["ln1"], cfg.norm_eps)
        if kind in (RWKV, RGLRU):
            mix, new = self._recurrent(p["mixer"], h, kind, cache)
            x = x + mix
            h2 = rms_norm(x, p["ln2"], cfg.norm_eps)
            out = self._mlp(p["mlp"], h2, kind, x_last=cache.get("x_cm"))
            for name, t in new.items():
                cache[name].copy_(t)
            if kind == RWKV:
                cache["x_cm"].copy_(h2[:, -1])
            return x + out
        mp = p["mixer"]
        hin = self._enter_model(h) if self._split("heads_local") else h
        if kind == XATTN:
            # the static encoder cache, every entry visible
            out = self._decode_attn(self._q(mp, hin), cache["k"], cache["v"],
                                    cfg.encoder_len - 1,
                                    self._cache_len(kind, 0))
        else:
            q, k, v = self._qkv(mp, hin)
            posv = torch.tensor([pos], device=self.device)
            q = apply_rope(q, posv, cfg.rope_theta)
            k = apply_rope(k, posv, cfg.rope_theta)
            n = cache["k"].shape[1]
            L = n if cache_len is None else self._cache_len(kind, cache_len)
            slot = pos % L
            if n != L:
                # a length-split cache: the rank that holds the slot
                slot = owned_slot(slot, n, self.mesh.coords["model"])
            if self._int8(kind):
                qk, sk = _kv_quant(k)
                qv, sv = _kv_quant(v)
                if slot is not None:
                    cache["k"][:, slot] = qk[:, 0]
                    cache["v"][:, slot] = qv[:, 0]
                    cache["k_scale"][:, slot] = sk[:, 0]
                    cache["v_scale"][:, slot] = sv[:, 0]
                ak = _kv_dequant(cache["k"], cache["k_scale"], cdt)
                av = _kv_dequant(cache["v"], cache["v_scale"], cdt)
            else:
                if slot is not None:
                    cache["k"][:, slot] = k[:, 0]
                    cache["v"][:, slot] = v[:, 0]
                ak, av = cache["k"], cache["v"]
            # with a ring buffer every slot is valid once filled; the
            # per-slot positional mask only matters while pos < L
            out = self._decode_attn(q, ak, av, min(pos, L - 1), L)
        x = x + self._wo(mp, out)
        h2 = rms_norm(x, p["ln2"], cfg.norm_eps)
        return x + self._mlp(p["mlp"], h2, kind)

    def _cache_layers(self, cache):
        """Per-layer cache views, in the order of ``_layers``."""
        cfg = self.cfg
        if cache["periods"]:
            n_full = next(iter(cache["periods"][0].values())).shape[0]
            for i in range(n_full):
                for j in range(len(cfg.pattern)):
                    yield _index(cache["periods"][j], i)
        for c in cache["remainder"]:
            yield _index(c, 0)

    def decode_step(self, params, cache, batch):
        """batch: {"tokens": (B, 1)} (or {"embeds": (B, 1, d_model)}).
        Returns (logits (B, 1, V), cache) with the cache updated in place
        and ``cache["pos"]`` advanced (on a rank: its rows' logits, its
        blocks of the cache, as its prefill left them)."""
        self.check_mesh_compute("decode")
        x = self._embed(params, batch)
        pos = int(cache["pos"])
        for (p, kind), c in zip(self._layers(params),
                                self._cache_layers(cache)):
            x = self._layer_decode(p, x, c, kind, pos,
                                   cache.get("cache_len"))
        cache["pos"] = pos + 1
        return self._final_logits(params, x), cache

    # ---- paged decode (continuous-batching serving) ----
    def _layer_decode_paged(self, p, x, arena, kind, bt, pos, active):
        """One-token decode against a paged KV arena (written in place).

        ``arena``: this layer's ``{"k", "v"}`` pages, each
        ``(num_pages + 1, page_size, KV, hd)`` -- the last page is the
        trash page for masked writes.  ``bt``: (B, max_pages) block
        tables mapping token t -> ``bt[b, t // page_size]``; ``pos``: (B,)
        write positions; ``active``: (B,) bool slot occupancy."""
        cfg, cdt = self.cfg, self.cfg.cdtype
        B = x.shape[0]
        H, KV, hd = cfg.n_heads, cfg.n_kv, cfg.hd
        h = rms_norm(x, p["ln1"], cfg.norm_eps)
        q, k, v = self._qkv(p["mixer"], h)
        q = apply_rope(q, pos[:, None], cfg.rope_theta)
        k = apply_rope(k, pos[:, None], cfg.rope_theta)

        n_pages1, page_size = arena["k"].shape[:2]
        max_pages = bt.shape[1]
        slot = torch.clamp(pos // page_size, 0, max_pages - 1)
        pidx = torch.where(active, bt[torch.arange(B, device=bt.device),
                                      slot], n_pages1 - 1)
        off = pos % page_size
        arena["k"][pidx, off] = k[:, 0]
        arena["v"][pidx, off] = v[:, 0]
        # this batch's pages as a (B, max_pages * page_size, ...) linear
        # view; positions beyond ``pos`` (and trash-backed entries) are
        # masked inside decode_attention
        kseq = arena["k"][bt].reshape(B, max_pages * page_size, KV, hd)
        vseq = arena["v"][bt].reshape(B, max_pages * page_size, KV, hd)
        out = decode_attention(q, kseq, vseq, pos, window=self._window(kind))
        x = x + out.reshape(B, 1, H * hd) @ p["mixer"]["wo"].to(cdt)
        h2 = rms_norm(x, p["ln2"], cfg.norm_eps)
        return x + self._mlp(p["mlp"], h2, kind)

    def decode_step_paged(self, params, arenas, batch, block_tables,
                          lengths, active):
        """One continuous-batching decode step over the paged arenas.

        ``batch``: {"tokens": (B, 1)} last sampled token per slot;
        ``block_tables``: (B, max_pages) int; ``lengths``: (B,) int number
        of cached tokens per slot (= the write position of this step's
        token); ``active``: (B,) bool.  Returns (logits (B, 1, V), arenas)
        with the arenas updated in place.  Attention mixers only (see
        ``serve.cache.paged_kinds``)."""
        self.check_mesh_compute("paged decode")
        dev = self.device
        x = self._embed(params, batch)
        bt = torch.as_tensor(block_tables, device=dev).long()
        pos = torch.as_tensor(lengths, device=dev).long()
        act = torch.as_tensor(active, device=dev).bool()
        for (p, kind), a in zip(self._layers(params),
                                self._cache_layers(arenas)):
            x = self._layer_decode_paged(p, x, a, kind, bt, pos, act)
        return self._final_logits(params, x), arenas

"""Trees resident on a mesh's ranks, and the controller's handles to them.

A tree that lives on a mesh is held by its ranks: rank r keeps its block
of every leaf (``layout.py::shard_of`` under the leaf's spec) in its
``RankContext.resident`` store, as a flat list under a key.  The
controller holds a :class:`ShardedLeaf` a leaf -- the mesh, the key, the
leaf's index, its :class:`ShapeDtypeStruct` -- so that a parameter or
AdamW tree on a mesh is a tree of handles in the usual structure:
``checkpoint/manager.py`` saves it by gathering each leaf to full size
(:meth:`ShardedLeaf.numpy`) and restores into it by scattering the blocks
(:meth:`ShardedLeaf.put`).  Full trees reach rank 0's CALL through
:data:`_OUTBOX` (rank 0 is the calling process), the other ranks through
``dist.scatter``.

A mesh here is a ``launch.mesh.Mesh``: its ``coords(rank)``, ``size``,
``device`` and ``grid()`` (the process grid whose ``call`` runs a
function on every rank) are all that is read.

**Versions and held views.**  Every write into a resident list (a put, a
restore, a training step through :func:`changed`) gives its key a new
version on every rank and drops what the ranks hold derived from the old
one (:func:`derived`: the serving steps' gathered parameter views,
``launch/mesh_serve.py``), so nothing computes with a view of parameters
that have since changed.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Dict

import numpy as np
import torch
import torch.distributed as dist

from ..core.util import tree_leaves, tree_unflatten
from .layout import ShapeDtypeStruct, shard_of, unshard
from .rules import PartitionSpec

#: trees handed to rank 0's side of a CALL, by key (rank 0 is this process)
_OUTBOX: Dict[str, Any] = {}
_KEYS = itertools.count()
_THIS = "repro_torch.sharding.resident"


def new_key(prefix: str) -> str:
    return f"{prefix}/{next(_KEYS)}"


# ---------------------------------------------------------------------------
# rank side: the store
# ---------------------------------------------------------------------------

def trees(ctx) -> Dict[str, list]:
    """This rank's resident lists of blocks, by key."""
    return ctx.resident.setdefault("sharded_trees", {})


def version(ctx, keys) -> tuple:
    """The versions of resident lists ``keys`` on this rank."""
    got = ctx.resident.setdefault("versions", {})
    return tuple(got.get(k, 0) for k in keys)


def derived(ctx) -> Dict[tuple, Any]:
    """What this rank holds derived from resident lists, by the tuple of
    their keys: ``(their versions when it was made, the thing)``."""
    return ctx.resident.setdefault("derived", {})


def changed(ctx, keys):
    """Resident lists ``keys`` change (or go) on this rank: a new version
    of each, and everything held from any of them dropped."""
    got = ctx.resident.setdefault("versions", {})
    for k in keys:
        got[k] = got.get(k, 0) + 1
    store = derived(ctx)
    for hk in [hk for hk in store if set(hk) & set(keys)]:
        del store[hk]


def _block_shape(shape, spec, mesh, coords):
    return shard_of(torch.empty(shape, device="meta"), spec, mesh,
                    coords).shape


def _rank_put(ctx, mesh, key: str, metas, idxs):
    """Write this rank's block of each leaf rank 0 holds in
    ``_OUTBOX[key]`` (``metas``: ``(shape, dtype, spec)`` a leaf) into
    entries ``idxs`` of the list under ``key``."""
    full = _OUTBOX.pop(key) if ctx.rank == 0 else None
    changed(ctx, [key])
    blocks = trees(ctx)[key]
    coords = [mesh.coords(r) for r in range(mesh.size)]
    for i, (j, (shape, dtype, spec)) in enumerate(zip(idxs, metas)):
        buf = torch.empty(_block_shape(shape, spec, mesh, coords[ctx.rank]),
                          dtype=dtype)
        parts = None
        if ctx.rank == 0:
            host = (full[i].detach().cpu() if isinstance(full[i], torch.Tensor)
                    else torch.from_numpy(np.array(full[i])))
            host = host.to(dtype)
            parts = [shard_of(host, spec, mesh, c).contiguous()
                     for c in coords]
        dist.scatter(buf, parts, src=0)
        with torch.no_grad():
            blocks[j].copy_(buf)


def _rank_gather(ctx, mesh, key: str, metas, idxs):
    """Every rank's block of leaves ``idxs`` of ``key`` to rank 0, which
    returns the full arrays (numpy)."""
    blocks = trees(ctx)[key]
    out = []
    for j, (shape, dtype, spec) in zip(idxs, metas):
        host = blocks[j].detach().cpu().contiguous()
        parts = ([torch.empty_like(host) for _ in range(mesh.size)]
                 if ctx.rank == 0 else None)
        dist.gather(host, parts, dst=0)
        if ctx.rank == 0:
            full = unshard(parts, spec, mesh)
            out.append(full.numpy())
    return out if ctx.rank == 0 else None


def _rank_alloc(ctx, mesh, key: str, metas):
    """A new list under ``key`` of this rank's (uninitialised) blocks."""
    coords = mesh.coords(ctx.rank)
    trees(ctx)[key] = [
        torch.empty(_block_shape(shape, spec, mesh, coords), dtype=dtype,
                    device=ctx.device) for shape, dtype, spec in metas]


def _rank_free(ctx, mesh, keys):
    changed(ctx, keys)
    for k in keys:
        trees(ctx).pop(k, None)


def _rank_block_shapes(ctx, mesh, key: str):
    """Every rank's block shapes of ``key`` (gathered to rank 0)."""
    mine = [tuple(b.shape) for b in trees(ctx)[key]]
    got = [None] * dist.get_world_size() if ctx.rank == 0 else None
    dist.gather_object(mine, got, dst=0)
    return got


# ---------------------------------------------------------------------------
# controller side: handles
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ShardedLeaf:
    """One leaf of a tree resident on a mesh (see the module docstring)."""

    mesh: Any
    key: str
    idx: int
    struct: ShapeDtypeStruct

    @property
    def shape(self):
        return self.struct.shape

    @property
    def dtype(self):
        return self.struct.dtype

    @property
    def spec(self) -> PartitionSpec:
        return self.struct.spec

    def _meta(self):
        return (self.struct.shape, self.struct.dtype, self.struct.spec)

    def numpy(self) -> np.ndarray:
        """The full array, gathered from the ranks."""
        return gather_leaves([self])[0]

    def put(self, value):
        """Scatter ``value`` (the full array) into the ranks' blocks."""
        put_into([self], [value])


def call(mesh, fn: str, leaves=(), **kw):
    """``fn`` (``"module:function"``) on every rank of ``mesh``'s grid."""
    return mesh.grid().call(fn, leaves, mesh=mesh, **kw)


def _call(mesh, fn: str, **kw):
    return call(mesh, f"{_THIS}:{fn}", **kw)


def alloc_leaves(mesh, structs, prefix: str = "tree"):
    """Handles of new, uninitialised leaves on the mesh (filled by
    :meth:`ShardedLeaf.put`)."""
    key = new_key(prefix)
    _call(mesh, "_rank_alloc", key=key,
          metas=[(tuple(s.shape), s.dtype, s.spec) for s in structs])
    return [ShardedLeaf(mesh, key, i, s) for i, s in enumerate(structs)]


def put_tree(mesh, tree, structs, prefix: str = "tree"):
    """Scatter a tree of full arrays (tensors or numpy) onto the mesh by
    its struct tree; returns the tree of handles."""
    hs = alloc_leaves(mesh, tree_leaves(structs), prefix)
    put_into(hs, tree_leaves(tree))
    return tree_unflatten(structs, hs)


def put_into(handles, values):
    """Scatter full arrays into existing handles' blocks, in place."""
    for (mesh, key), group in _by_key(handles, values).items():
        hs, vs = zip(*group)
        _OUTBOX[key] = list(vs)
        try:
            _call(mesh, "_rank_put", key=key, metas=[h._meta() for h in hs],
                  idxs=[h.idx for h in hs])
        finally:
            _OUTBOX.pop(key, None)


def gather_leaves(handles):
    """The full arrays (numpy) of handles, in order."""
    out = {}
    for (mesh, key), group in _by_key(handles, handles).items():
        hs = [h for h, _ in group]
        arrs = _call(mesh, "_rank_gather", key=key,
                     metas=[h._meta() for h in hs], idxs=[h.idx for h in hs])
        out.update({id(h): a for h, a in zip(hs, arrs)})
    return [out[id(h)] for h in handles]


def gather_tree(tree):
    """A tree of handles as a tree of full numpy arrays."""
    hs = tree_leaves(tree)
    return tree_unflatten(tree, gather_leaves(hs))


def block_shapes(tree):
    """``{rank: [block shape of each leaf]}`` of a handle tree (one key)."""
    h = tree_leaves(tree)[0]
    got = _call(h.mesh, "_rank_block_shapes", key=h.key)
    idx = [x.idx for x in tree_leaves(tree)]
    return {r: [shapes[i] for i in idx] for r, shapes in enumerate(got)}


def free(tree):
    """Drop the ranks' blocks of a handle tree."""
    hs = tree_leaves(tree)
    for mesh in {h.mesh for h in hs}:
        _call(mesh, "_rank_free", keys=sorted({h.key for h in hs
                                               if h.mesh == mesh}))


def _by_key(handles, values):
    groups: Dict[tuple, list] = {}
    for h, v in zip(handles, values):
        groups.setdefault((h.mesh, h.key), []).append((h, v))
    return groups

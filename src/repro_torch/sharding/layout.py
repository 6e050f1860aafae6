"""The blocks of an array laid out over a mesh, and the structs that
describe a tree without holding it (``jax.sharding`` gives the reference
this part).

  * :class:`NamedSharding` ``(mesh, spec)`` and :class:`ShapeDtypeStruct`
    ``(shape, dtype, sharding)``: what the spec builders of
    ``launch/steps.py`` return, nothing allocated;
  * :func:`shard_of` cuts one device's block out of a full array and
    :func:`unshard` puts the blocks of every device back together, both
    by exact slicing and concatenation: device ``coords`` (an index along
    every mesh axis) holds, along a dimension split over axes
    ``(a1, a2, ...)``, block number ``i = i_a1 * |a2| * ... + i_a2 * ...``
    (the first axis the major one, as ``jax`` lays a multi-axis entry);
  * :func:`shard_params_from_reference` carries a reference parameter or
    AdamW tree (numpy leaves) onto a mesh: every leaf's block for the
    given coordinates, as ``convert.lm_params_from_reference`` carries it
    to one device.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, NamedTuple, Sequence

import numpy as np
import torch

from .rules import PartitionSpec, local_shape


class NamedSharding(NamedTuple):
    """A mesh and the spec of one array over it."""

    mesh: Any
    spec: PartitionSpec


@dataclasses.dataclass(frozen=True)
class ShapeDtypeStruct:
    """Shape, dtype (a ``torch.dtype``) and sharding of one leaf -- the
    counterpart of ``jax.ShapeDtypeStruct``."""

    shape: tuple
    dtype: torch.dtype
    sharding: NamedSharding = None

    @property
    def spec(self) -> PartitionSpec:
        return self.sharding.spec

    @property
    def local_shape(self) -> tuple:
        """One device's block."""
        return local_shape(self.shape, self.spec, self.sharding.mesh)


def block_index(spec: PartitionSpec, dim: int, mesh, coords: Dict[str, int]
                ) -> tuple:
    """``(i, n)``: the device's block number along ``dim`` and the number
    of blocks there."""
    i, n = 0, 1
    for a in spec.axes(dim):
        i = i * mesh.shape[a] + coords[a]
        n *= mesh.shape[a]
    return i, n


def shard_of(full, spec: PartitionSpec, mesh, coords: Dict[str, int]):
    """The block of ``full`` (a tensor or numpy array) that the device at
    ``coords`` holds under ``spec`` (a view where slicing makes one)."""
    out = full
    for d in range(len(spec)):
        i, n = block_index(spec, d, mesh, coords)
        if n > 1:
            size = full.shape[d] // n
            out = out[(slice(None),) * d + (slice(i * size,
                                                  (i + 1) * size),)]
    return out


def device_coords(mesh) -> list:
    """Every device's coordinates, in rank order (``r = b * M + m``)."""
    names = mesh.axis_names
    sizes = [mesh.shape[a] for a in names]
    out = []
    for r in range(math.prod(sizes)):
        c, rest = {}, r
        for a, s in zip(reversed(names), reversed(sizes)):
            rest, c[a] = divmod(rest, s)
        out.append({a: c[a] for a in names})
    return out


def unshard(blocks: Sequence, spec: PartitionSpec, mesh):
    """The full array from every device's block (``blocks[r]`` of rank r,
    in :func:`device_coords`' order; tensors or numpy arrays).  Devices
    that hold the same block (the axes the spec leaves out) hold copies;
    the first is taken."""
    coords = device_coords(mesh)
    cat = (torch.cat if isinstance(blocks[0], torch.Tensor)
           else np.concatenate)

    def build(d, fixed):
        if d == len(spec):
            for r, c in enumerate(coords):
                if all(c[a] == v for a, v in fixed.items()):
                    return blocks[r]
            raise ValueError(f"no device holds the block {fixed}")
        axes = spec.axes(d)
        if not axes:
            return build(d + 1, fixed)
        parts = []
        for idx in range(math.prod(mesh.shape[a] for a in axes)):
            sub, rest = dict(fixed), idx
            for a in reversed(axes):
                rest, sub[a] = divmod(rest, mesh.shape[a])
            parts.append(build(d + 1, sub))
        return cat(parts, d) if cat is np.concatenate else cat(parts, dim=d)
    return build(0, {})


def shard_tree(tree, specs, mesh, coords):
    """Every leaf's block (:func:`shard_of`) of a tree and a parallel
    tree of specs."""
    if isinstance(tree, dict):
        return {k: shard_tree(tree[k], specs[k], mesh, coords) for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(shard_tree(t, s, mesh, coords)
                          for t, s in zip(tree, specs))
    return shard_of(tree, specs, mesh, coords)


def shard_params_from_reference(tree, mesh, specs, coords, device="cuda"):
    """A reference parameter tree (or AdamW ``mu`` / ``nu``; numpy
    leaves, nested dicts and lists) as the port's blocks for the device at
    ``coords``: each leaf's block under its spec, a tensor on ``device``,
    dtypes kept."""
    from ..convert import lm_params_from_reference
    return lm_params_from_reference(
        shard_tree(tree, specs, mesh, coords), device=device)

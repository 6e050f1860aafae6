"""Logical-axis -> PartitionSpec rules (doubly distributed sharding; the
port of ``repro/sharding/rules.py``).

The paper's P x Q scheme generalized: the *observation* dimensions (batch,
dual variables) shard over ("pod", "data"); the *feature* dimensions
(vocab, heads, ff, experts, model-parallel contractions) shard over
"model"; remaining parameter dims are FSDP-sharded over ("pod", "data")
for ZeRO-3 style memory scaling.  Divisibility-aware: a rule silently
drops mesh axes that do not divide the dimension (e.g. mixtral's 8 experts
on a 16-wide model axis fall back to replication and the per-expert ff dim
carries the model sharding instead).

A mesh is anything with ``.shape`` (axis name -> size) and
``.axis_names``: ``repro_torch.launch.mesh.Mesh``, the rank's view of one
(``RankMesh``), or a test's stand-in.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple


class PartitionSpec(tuple):
    """One entry a dimension: None (replicated), an axis name, or a tuple
    of axis names (the first the major one) -- ``jax.sharding.
    PartitionSpec``'s layout, compared as the tuple of its entries."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self):
        return f"PartitionSpec{tuple.__repr__(self)}"

    def __reduce__(self):
        return (PartitionSpec, tuple(self))

    def axes(self, dim: int) -> Tuple[str, ...]:
        """The mesh axes dimension ``dim`` is split over (major first)."""
        e = self[dim] if dim < len(self) else None
        if e is None:
            return ()
        return (e,) if isinstance(e, str) else tuple(e)

    def mesh_axes(self) -> Tuple[str, ...]:
        """Every mesh axis the spec uses."""
        return tuple(a for d in range(len(self)) for a in self.axes(d))


def batch_axes(mesh) -> Tuple[str, ...]:
    """Mesh axes the batch/observation dimension shards over."""
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def fsdp_axes(mesh) -> Tuple[str, ...]:
    return batch_axes(mesh)


def default_rules(mesh) -> Dict[str, Tuple[str, ...]]:
    b = batch_axes(mesh)
    return {
        "batch": b,
        "fsdp": b,
        "vocab": ("model",),
        "heads": ("model",),
        "kv_heads": ("model",),
        "ff": ("model",),
        "experts": ("model",),
        "expert_ff": ("model",),   # used when `experts` falls back
        "kv_len": ("model",),      # sequence-parallel KV cache (decode)
        "model_dim": (),           # activations keep d_model unsharded
        "seq": (),
        None: (),
    }


Rules = Dict[str, Tuple[str, ...]]


def _axes_fit(dim: int, axes: Sequence[str], mesh) -> Tuple[str, ...]:
    """Largest prefix of ``axes`` whose total size divides ``dim``."""
    out = []
    prod = 1
    for a in axes:
        size = mesh.shape[a]
        if dim % (prod * size) == 0:
            out.append(a)
            prod *= size
        else:
            break
    return tuple(out)


def logical_to_spec(shape: Sequence[int], logical: Sequence[Optional[str]],
                    mesh, rules: Optional[Rules] = None) -> PartitionSpec:
    """Map per-dimension logical names to a PartitionSpec.

    Divisibility fallback per dim; also guarantees no mesh axis is used
    twice in one spec (first dim wins).
    """
    rules = rules or default_rules(mesh)
    used = set()
    parts = []
    for dim, name in zip(shape, logical):
        axes = _axes_fit(dim, [a for a in rules.get(name, ()) if a not in used],
                         mesh)
        for a in axes:
            used.add(a)
        parts.append(axes if len(axes) > 1 else (axes[0] if axes else None))
    return PartitionSpec(*parts)


def _is_logical_leaf(x):
    return isinstance(x, tuple) and (len(x) == 0 or all(
        isinstance(e, (str, type(None))) for e in x))


def spec_tree(logical_tree, param_tree, mesh, rules: Optional[Rules] = None):
    """Build a PartitionSpec tree parallel to ``param_tree`` (leaves: any
    objects with ``.shape``).

    ``logical_tree`` mirrors the structure with tuples of logical axis names
    (or None) per array dimension (a tuple-of-strings leaf).
    """
    def build(lg, p):
        if _is_logical_leaf(lg):
            return logical_to_spec(p.shape, lg, mesh, rules)
        if isinstance(lg, dict):
            return {k: build(lg[k], p[k]) for k in lg}
        return type(lg)(build(a, b) for a, b in zip(lg, p))
    return build(logical_tree, param_tree)


def local_shape(shape: Sequence[int], spec: PartitionSpec, mesh
                ) -> Tuple[int, ...]:
    """The extent of one device's block of an array of ``shape`` laid out
    by ``spec``."""
    return tuple(int(d) // math.prod(mesh.shape[a] for a in spec.axes(i))
                 for i, d in enumerate(shape))


def constrain(x, mesh, *logical, rules: Optional[Rules] = None, shape=None):
    """The reference's ``with_sharding_constraint`` by logical axis names.

    The port does not move data here: with no mesh it returns ``x``; on a
    mesh it checks that ``x`` -- a rank's local tensor -- is the block
    that the spec of ``logical`` names for the global array of ``shape``
    (by default: ``x`` scaled up by the axes its logical names map to),
    and raises ``ValueError`` otherwise (a dimension the rule cannot
    split evenly, or a block of the wrong extent)."""
    if mesh is None:
        return x
    rules = rules or default_rules(mesh)
    if shape is None:
        shape = []
        for d, name in zip(x.shape, logical):
            want = rules.get(name, ())
            shape.append(d * math.prod(mesh.shape[a] for a in want
                                       if a in mesh.axis_names))
    spec = logical_to_spec(shape, logical, mesh, rules)
    got = local_shape(shape, spec, mesh)
    if tuple(x.shape) != got:
        raise ValueError(f"a {tuple(x.shape)} block is not the block "
                         f"{got} of the global {tuple(shape)} array that "
                         f"{spec} lays out over the mesh {dict(mesh.shape)} "
                         f"(logical axes {logical})")
    return x


__all__ = ["PartitionSpec", "Rules", "batch_axes", "constrain",
           "default_rules", "fsdp_axes", "local_shape", "logical_to_spec",
           "spec_tree"]

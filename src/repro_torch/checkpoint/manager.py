"""Fault-tolerant checkpointing, in the reference's on-disk layout.

A checkpoint of a tree (nested dicts, lists and tuples whose leaves are
tensors or numpy arrays) is one directory:

  * ``leaf_XXXXX.npy`` per leaf, in the reference's leaf order (dict keys
    sorted, sequence entries by index), and ``index.json`` with each
    leaf's path (``"nested/b"``, ``"lst/0"``), file, shape and dtype --
    the layout ``repro.checkpoint.manager`` writes, so that either
    package restores what the other saved;
  * writes go to ``<dir>.tmp`` and are atomically renamed -- a crash
    mid-write can never corrupt the latest checkpoint;
  * ``save_async`` copies device to host on the caller's thread and
    writes the files in a background thread;
  * ``restore`` loads every leaf into a tensor on ``device`` (the card by
    default) with the dtype of the template's leaf;
  * ``keep_n`` garbage-collects old steps, never touching the newest.

  * ``into=True`` writes each leaf into ``like``'s own tensor (the
    trainer's restore: no second copy of the model on the device).

Trees on a mesh (``sharding/resident.py::ShardedLeaf`` leaves) are saved
in the same full-array format -- each leaf gathered from the ranks'
blocks -- so a checkpoint written on a grid restores on one device, in
the reference, or on a grid of another shape.  ``restore_tree``'s
``shardings=`` (the reference's elastic re-scale) puts each leaf's block
on each rank of a mesh; a tree of handles restores into its own blocks.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch

from ..core.util import resolve_device
from ..sharding.layout import NamedSharding, ShapeDtypeStruct
from ..sharding.resident import ShardedLeaf, alloc_leaves


def _flatten(tree, prefix=()):
    """``(paths, leaves)`` of a tree of dicts / lists / tuples, in the
    reference's order (dict keys sorted); ``None`` holds no leaf."""
    if tree is None:
        return [], []
    if isinstance(tree, dict):
        items = ((k, tree[k]) for k in sorted(tree))
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return ["/".join(str(k) for k in prefix)], [tree]
    paths, leaves = [], []
    for k, sub in items:
        p, lv = _flatten(sub, prefix + (k,))
        paths += p
        leaves += lv
    return paths, leaves


def _unflatten(like, leaves):
    """``like``'s structure with its leaves taken in order from the
    iterator ``leaves``."""
    if like is None:
        return None
    if isinstance(like, dict):
        out = {k: _unflatten(like[k], leaves) for k in sorted(like)}
        return {k: out[k] for k in like}
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(v, leaves) for v in like)
    return next(leaves)


def _host(leaf, copy: bool = False) -> np.ndarray:
    """A leaf as a numpy array; ``copy``: one that shares no memory with
    the leaf (a device tensor's is a copy already, as is a mesh leaf's,
    gathered from its ranks)."""
    if isinstance(leaf, ShardedLeaf):
        return leaf.numpy()
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach()
        if leaf.device.type != "cpu":
            return leaf.cpu().numpy()
        leaf = leaf.numpy()
    return np.array(leaf) if copy else np.asarray(leaf)


def _dtype_of(leaf) -> torch.dtype:
    """A leaf's torch dtype (a tensor's, a struct's or a mesh leaf's, or
    a numpy array's)."""
    if isinstance(getattr(leaf, "dtype", None), torch.dtype):
        return leaf.dtype
    return torch.from_numpy(np.zeros((), np.asarray(leaf).dtype)).dtype


def save_tree(path: str, tree: Any):
    """Synchronous atomic save of a tree of tensors / arrays."""
    tmp = path + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    paths, leaves = _flatten(tree)
    index = {"leaves": []}
    for i, (p, leaf) in enumerate(zip(paths, leaves)):
        arr = _host(leaf)
        fn = f"leaf_{i:05d}.npy"
        np.save(os.path.join(tmp, fn), arr)
        index["leaves"].append({"path": p, "file": fn,
                                "shape": list(arr.shape),
                                "dtype": str(arr.dtype)})
    with open(os.path.join(tmp, "index.json"), "w") as fh:
        json.dump(index, fh)
    if os.path.exists(path):
        shutil.rmtree(path)
    os.rename(tmp, path)


def _as_sharding(s):
    """A sharding leaf -- ``NamedSharding``, a struct or a mesh leaf with
    one, or None -- as a ``NamedSharding`` or None."""
    if s is None or isinstance(s, NamedSharding):
        return s
    if isinstance(s, ShardedLeaf):
        return s.struct.sharding
    return s.sharding


def _aligned_shardings(like, shardings):
    """One sharding (or None) per leaf of ``like``, in ``_flatten``'s
    order; ``shardings`` mirrors ``like``, or a subtree of it is one
    sharding (or None) for every leaf below."""
    if like is None:
        return []
    one = not isinstance(shardings, (dict, list))
    if isinstance(like, dict):
        return [s for k in sorted(like) for s in _aligned_shardings(
            like[k], shardings if one else shardings.get(k))]
    if isinstance(like, (list, tuple)):
        return [s for i, v in enumerate(like) for s in _aligned_shardings(
            v, shardings if one else shardings[i])]
    return [_as_sharding(shardings)]


def restore_tree(path: str, like: Any, shardings: Optional[Any] = None, *,
                 device="cuda", into: bool = False):
    """Restore into the structure of ``like``: every leaf a tensor on
    ``device`` with the dtype of ``like``'s leaf.  ``into``: a leaf of
    ``like`` that is a tensor, or a mesh leaf, is overwritten in place and
    returned (on its own device, or its own ranks) instead.

    ``shardings`` (the reference's elastic re-scale): a tree mirroring
    ``like`` (or a prefix of it) of ``NamedSharding`` s -- or structs from
    ``launch/steps.py::param_shardings`` / ``opt_shardings``, or None for
    a plain tensor.  A leaf whose sharding names a mesh of more than one
    device is placed on that mesh's ranks, each holding its block, and
    restored as a ``ShardedLeaf``; a mesh leaf of ``like`` on the same
    mesh and spec is written in place when ``into``.

    Raises:
      ValueError: when a leaf's shape differs from ``like``'s.
    """
    device = resolve_device(device)
    with open(os.path.join(path, "index.json")) as fh:
        index = json.load(fh)
    paths, leaves = _flatten(like)
    shards = _aligned_shardings(like, shardings)
    by_path = {e["path"]: e for e in index["leaves"]}
    out = []
    placed = {}                     # mesh -> [(leaf number, struct)]
    for i, (p, leaf, sh) in enumerate(zip(paths, leaves, shards)):
        e = by_path[p]
        shape = tuple(e["shape"])
        if list(shape) != list(np.shape(leaf)):
            raise ValueError(f"shape mismatch for {p}: ckpt {shape} "
                             f"vs target {tuple(np.shape(leaf))}")
        if isinstance(leaf, ShardedLeaf) and (sh is None or sh == leaf.struct.sharding):
            sh = leaf.struct.sharding
            if into:
                leaf.put(np.load(os.path.join(path, e["file"])))
                out.append(leaf)
                continue
        if sh is not None and sh.mesh.size > 1:
            placed.setdefault(sh.mesh, []).append(
                (i, ShapeDtypeStruct(shape, _dtype_of(leaf), sh)))
            out.append(None)
            continue
        arr = np.load(os.path.join(path, e["file"]))
        if into and isinstance(leaf, torch.Tensor):
            with torch.no_grad():
                leaf.copy_(torch.from_numpy(arr))
            out.append(leaf)
            continue
        dev = device if sh is None else resolve_device(sh.mesh.device)
        out.append(torch.from_numpy(arr).to(device=dev,
                                            dtype=_dtype_of(leaf)))
    for mesh, items in placed.items():
        # a fresh store on the ranks, filled a leaf at a time
        hs = alloc_leaves(mesh, [s for _, s in items])
        for (i, _), h in zip(items, hs):
            h.put(np.load(os.path.join(path, by_path[paths[i]]["file"])))
            out[i] = h
    return _unflatten(like, iter(out))


class CheckpointManager:
    """Numbered checkpoints ``step_XXXXXXXX`` under ``directory``, the
    newest ``keep_n`` kept (0: all)."""

    def __init__(self, directory: str, keep_n: int = 3):
        self.dir = directory
        self.keep_n = keep_n
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._last_error: Optional[BaseException] = None

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:08d}")

    def all_steps(self):
        steps = []
        for d in os.listdir(self.dir):
            if d.startswith("step_") and not d.endswith(".tmp"):
                steps.append(int(d.split("_")[1]))
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, tree: Any):
        save_tree(self._step_dir(step), tree)
        self._gc()

    def save_async(self, step: int, tree: Any):
        """Device->host copy now, on the caller's thread; the disk write in
        the background (its error surfaces on the next :meth:`wait`)."""
        self.wait()
        _, leaves = _flatten(tree)
        host_tree = _unflatten(tree, iter([_host(leaf, copy=True)
                                           for leaf in leaves]))

        def work():
            try:
                save_tree(self._step_dir(step), host_tree)
                self._gc()
            except BaseException as e:   # surfaced on next wait()
                self._last_error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self):
        """Block until the background write finished; re-raise its
        error, if it failed."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._last_error is not None:
            e, self._last_error = self._last_error, None
            raise e

    def restore(self, like: Any, step: Optional[int] = None,
                shardings: Optional[Any] = None, *, device="cuda",
                into: bool = False):
        """``(step, tree)`` of ``step`` (the newest by default), leaves on
        ``device`` (or written into ``like``'s tensors: ``into``)."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        return step, restore_tree(self._step_dir(step), like, shardings,
                                  device=device, into=into)

    def _gc(self):
        steps = self.all_steps()
        for s in steps[: -self.keep_n] if self.keep_n else []:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

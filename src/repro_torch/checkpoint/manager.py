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

Re-sharding on restore (the reference's ``shardings=``, whose only
caller there is the LM trainer) belongs to LM sharding (ROADMAP queue A
item 13c) and raises by name.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch

from ..core.solver import not_ported
from ..core.util import resolve_device


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
    the leaf (a device tensor's is a copy already)."""
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach()
        if leaf.device.type != "cpu":
            return leaf.cpu().numpy()
        leaf = leaf.numpy()
    return np.array(leaf) if copy else np.asarray(leaf)


def _dtype_of(leaf) -> torch.dtype:
    if isinstance(leaf, torch.Tensor):
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


def restore_tree(path: str, like: Any, shardings: Optional[Any] = None, *,
                 device="cuda", into: bool = False):
    """Restore into the structure of ``like``: every leaf a tensor on
    ``device`` with the dtype of ``like``'s leaf.  ``into``: a leaf of
    ``like`` that is a tensor is overwritten in place and returned (on its
    own device) instead.

    Raises:
      ValueError: when a leaf's shape differs from ``like``'s.
    """
    if shardings is not None:
        raise not_ported("shardings")
    device = resolve_device(device)
    with open(os.path.join(path, "index.json")) as fh:
        index = json.load(fh)
    paths, leaves = _flatten(like)
    by_path = {e["path"]: e for e in index["leaves"]}
    out = []
    for p, leaf in zip(paths, leaves):
        e = by_path[p]
        arr = np.load(os.path.join(path, e["file"]))
        if list(arr.shape) != list(np.shape(leaf)):
            raise ValueError(f"shape mismatch for {p}: ckpt {arr.shape} "
                             f"vs target {tuple(np.shape(leaf))}")
        if into and isinstance(leaf, torch.Tensor):
            with torch.no_grad():
                leaf.copy_(torch.from_numpy(arr))
            out.append(leaf)
            continue
        out.append(torch.from_numpy(arr).to(device=device,
                                            dtype=_dtype_of(leaf)))
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

"""Deterministic LM token pipeline (the port of ``repro/data/tokens.py``).

Every host generates only its shard of the global batch, determined by
(step, shard index): row r of the global batch comes from numpy's
``SeedSequence([seed, step, r])`` alone, so the batches are the
reference's bit for bit and re-sharding replays identical data.  The
source stands in for a tokenized corpus; a real reader only changes
:func:`synthetic_token_batch`.

:class:`TokenPipeline` prefetches batches in a background thread (depth 2
by default) and, given ``device=``, puts each on the device through pinned
host memory, so the copy overlaps the previous step's compute; given
``sharding=``, it hands a rank of a mesh its rows of the global batch
(:func:`shard_batch`).
"""
from __future__ import annotations

import queue
import threading

import numpy as np
import torch


def synthetic_token_batch(step: int, *, batch: int, seq: int, vocab: int,
                          seed: int = 0, shard: tuple[int, int] = (0, 1)):
    """Deterministic batch for global ``step``; returns this host's rows
    as int32 numpy arrays ``{"tokens": (rows, seq), "labels": (rows,
    seq)}``, labels the tokens shifted by one.

    shard = (shard_index, shard_count).
    """
    idx, count = shard
    rows = batch // count
    lo = idx * rows
    out = np.empty((rows, seq + 1), dtype=np.int32)
    for r in range(rows):
        rng = np.random.default_rng(
            np.random.SeedSequence([seed, step, lo + r]))
        out[r] = rng.integers(0, vocab, size=(seq + 1,), dtype=np.int32)
    return {"tokens": out[:, :-1], "labels": out[:, 1:]}


def synthetic_lm_batch(cfg, step: int, *, batch: int, seq: int):
    """The training CLI's batch for global ``step`` of a model config, as
    the reference's CLI builds it: :func:`synthetic_token_batch`, whose
    tokens an embedding frontend replaces by frame embeddings (numpy
    ``default_rng(step)`` normals, (batch, seq, d_model) float32), plus
    stub encoder states for XATTN layers (``default_rng(10_000 + step)``,
    (batch, encoder_len, d_model) float32).  The model casts both to its
    compute dtype."""
    b = synthetic_token_batch(step, batch=batch, seq=seq, vocab=cfg.vocab)
    if cfg.embed_input != "tokens":
        rng = np.random.default_rng(step)
        b = {"embeds": rng.normal(size=(batch, seq, cfg.d_model)
                                  ).astype("float32"),
             "labels": b["labels"]}
    if cfg.encoder_len:
        rng = np.random.default_rng(10_000 + step)
        b["encoder"] = rng.normal(size=(batch, cfg.encoder_len, cfg.d_model)
                                  ).astype("float32")
    return b


def to_device(batch, device):
    """A batch of numpy arrays / tensors as tensors on ``device``; a CUDA
    copy goes through pinned host memory and does not block the host."""
    device = torch.device(device)
    out = {}
    for k, a in batch.items():
        if isinstance(a, torch.Tensor):
            out[k] = a.to(device)
            continue
        t = torch.as_tensor(np.ascontiguousarray(a))
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        else:
            t = t.to(device)
        out[k] = t
    return out


def shard_batch(batch, specs, coords):
    """The rows of a global batch that the device at ``coords`` holds:
    each entry cut by its struct in ``specs`` (``launch/steps.py::
    batch_specs``: the batch dimension over the batch axes, or whole)."""
    from ..sharding.layout import shard_of
    return {k: shard_of(v, specs[k].spec, specs[k].sharding.mesh, coords)
            for k, v in batch.items()}


class TokenPipeline:
    """Background prefetcher with a bounded buffer (depth 2 by default);
    yields ``(step, batch)`` in step order from ``start_step``.
    ``device``: put each batch there (:func:`to_device`); None leaves it
    as ``make_batch`` made it.  ``sharding``: ``(specs, coords)`` -- the
    ``batch_specs`` of the global batch and a rank's coordinates on their
    mesh: each batch is that rank's rows (:func:`shard_batch`)."""

    def __init__(self, make_batch, start_step: int = 0, depth: int = 2,
                 device=None, sharding=None):
        if sharding is not None:
            specs, coords = sharding
            whole = make_batch

            def make_batch(step):
                return shard_batch(whole(step), specs, coords)
        self._make = make_batch
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._step = start_step
        self._stop = threading.Event()
        self._device = device
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        step = self._step
        while not self._stop.is_set():
            batch = self._make(step)
            if self._device is not None:
                batch = to_device(batch, self._device)
            try:
                self._q.put((step, batch), timeout=0.5)
            except queue.Full:
                continue
            step += 1

    def __iter__(self):
        return self

    def __next__(self):
        return self._q.get()

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2.0)

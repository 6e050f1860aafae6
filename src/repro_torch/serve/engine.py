"""Continuous-batching inference engine over the paged KV cache
(counterpart of ``repro/serve/engine.py``).

The step loop interleaves *prefill* of newly admitted requests with
*decode* of in-flight ones: a finished sequence's slot and pages are
released at the end of the step and backfilled from the queue at the top
of the next, so decode batches stay as full as the queue allows.

Scheduling state lives on the host (slot table, block tables, lengths);
device state is the paged arena tree, written in place by one prefill
per admitted request (prompt padded to a bucket, a multiple of the page
size: every attention layer of it runs the flash attention kernel on the
card) and one decode step of the fixed ``max_slots`` batch.  Greedy
decoding is token-for-token identical to the static-batch loop.

Admission control:
  * requests longer than ``max_seq_len`` (prompt + max_new_tokens) or
    beyond ``max_queue`` are rejected at submit(), as are duplicate rids;
  * ``reserve_pages=True`` (default) admits a request only when its
    *worst-case* page count fits alongside all current reservations --
    growth can then never fail and no preemption happens;
  * ``reserve_pages=False`` admits on prompt-size fit and handles page
    exhaustion during decode by *preempting* the youngest sequence: its
    pages are freed and the request is requeued at the front, to be
    replayed later.  Per-request seeds make the replayed sample stream
    identical.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..obs.serve import RequestMetrics
from ..obs.trace import as_tracer
from .cache import (PagePool, PagedCacheConfig, make_paged_arenas,
                    paged_kinds, write_prompt_pages)
from .sampling import SamplingParams, params_arrays, sample_tokens


@dataclasses.dataclass
class Request:
    rid: object
    prompt: np.ndarray              # (len,) int32 token ids
    max_new_tokens: int = 16
    sampling: SamplingParams = SamplingParams()
    stop_token: Optional[int] = None

    def __post_init__(self):
        self.prompt = np.asarray(self.prompt, np.int32).reshape(-1)
        if self.prompt.size == 0:
            raise ValueError("empty prompt")
        if self.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    max_slots: int = 4
    page_size: int = 16
    num_pages: int = 256
    max_seq_len: int = 512          # prompt + generated, per sequence
    max_queue: int = 1024
    reserve_pages: bool = True


@dataclasses.dataclass
class _Slot:
    rid: object
    request: Request
    kv_len: int                     # tokens whose KV is in the arena
    generated: List[int]
    admit_seq: int                  # admission order; eviction priority


class InferenceEngine:
    """Serve ``model`` (a ``repro_torch.models.Transformer``) on its device.

    ``params`` is the model's tree in ``param_dtype``; the engine keeps
    ``model.compute_params(params)`` (the weights cast to the compute
    dtype once).  ``registry`` (a ``repro_torch.obs.Registry``) receives
    the request metrics.  ``tracer`` (a ``repro_torch.obs.Tracer``) spans
    every ``engine_step`` with its ``admission`` (``prefill`` per
    admitted request) and ``decode_step`` phases and marks ``reject`` /
    ``preempt`` / ``finish`` instants; the prefill and decode spans close
    after their tokens are read back to the host, so they cover the
    device work.  ``monitor`` (a ``repro_torch.obs.HealthMonitor``) is
    polled after every engine step (rate-limited inside the monitor).
    """

    def __init__(self, model, params, cfg: EngineConfig = EngineConfig(),
                 clock=time.perf_counter, tracer=None, registry=None,
                 monitor=None):
        paged_kinds(model.cfg)      # raises for unsupported archs
        self.model = model
        self.device = model.device
        self.params = model.compute_params(params)
        self.cfg = cfg
        self.pc = PagedCacheConfig(cfg.page_size, cfg.num_pages)
        self.max_pages = self.pc.pages_for(cfg.max_seq_len)
        self.pool = PagePool(self.pc)
        self.arenas = make_paged_arenas(model.cfg, self.pc, self.device)
        self.metrics = RequestMetrics(clock, registry=registry)
        self.tracer = as_tracer(tracer)
        self.monitor = monitor

        self.queue: collections.deque = collections.deque()
        self.slots: List[Optional[_Slot]] = [None] * cfg.max_slots
        # block tables, trash-initialized; copied to the device each step
        self._bt = np.full((cfg.max_slots, self.max_pages),
                           self.pc.trash_page, np.int32)
        self.outputs: Dict[object, np.ndarray] = {}
        self._live: set = set()         # rids queued or in a slot
        self._admit_seq = 0
        self._reserved_pages = 0
        self._greedy = SamplingParams()

    # ------------------------------------------------------------------
    # device functions
    # ------------------------------------------------------------------
    def _prefill(self, tokens, true_len, bt_row, sp):
        S = tokens.shape[1]
        logits, cache = self.model.prefill(
            self.params, {"tokens": tokens}, S, last_pos=true_len - 1,
            linear_cache=True)
        write_prompt_pages(self.arenas, cache, bt_row, true_len, self.pc)
        return int(sample_tokens(logits[:, 0], *sp)[0])

    def _decode(self, tokens, lengths, active, sp=None):
        dev = self.device
        logits, _ = self.model.decode_step_paged(
            self.params, self.arenas,
            {"tokens": torch.as_tensor(tokens, device=dev)},
            torch.as_tensor(self._bt, device=dev),
            torch.as_tensor(lengths, device=dev),
            torch.as_tensor(active, device=dev))
        if sp is None:              # greedy fast path: no sampling machinery
            nxt = torch.argmax(logits[:, 0], dim=-1)
        else:
            nxt = sample_tokens(logits[:, 0], *sp)
        return nxt.cpu().numpy()

    # ------------------------------------------------------------------
    # admission
    # ------------------------------------------------------------------
    def _reject(self, req: Request, reason: str) -> bool:
        self.metrics.rejections += 1
        self.tracer.instant("reject", rid=str(req.rid), reason=reason)
        return False

    def submit(self, req: Request) -> bool:
        """Queue a request; False (and a rejection count) if refused."""
        total = len(req.prompt) + req.max_new_tokens
        if total > self.cfg.max_seq_len or \
                self.pc.pages_for(total) > self.cfg.num_pages:
            return self._reject(req, "too_long")
        if len(self.queue) >= self.cfg.max_queue:
            return self._reject(req, "queue_full")
        # rids key the page pool and the output dict: a duplicate would
        # merge two requests' pages under one owner
        if req.rid in self._live or req.rid in self.outputs:
            return self._reject(req, "duplicate_rid")
        self._live.add(req.rid)
        self.queue.append(req)
        self.metrics.start_request(req.rid, len(req.prompt))
        return True

    def _bucket(self, n: int) -> int:
        return self.pc.pages_for(n) * self.cfg.page_size

    def _try_admit_one(self) -> bool:
        free_slots = [i for i, s in enumerate(self.slots) if s is None]
        if not free_slots or not self.queue:
            return False
        req = self.queue[0]
        need_now = self.pc.pages_for(len(req.prompt))
        need_max = self.pc.pages_for(len(req.prompt) + req.max_new_tokens)
        if self.cfg.reserve_pages:
            if self._reserved_pages + need_max > self.cfg.num_pages:
                return False
        elif self.pool.n_free < need_now:
            return False
        self.queue.popleft()
        pages = self.pool.alloc(req.rid, need_now)
        if pages is None:
            raise RuntimeError("page pool refused an admitted request")
        if self.cfg.reserve_pages:
            self._reserved_pages += need_max

        i = free_slots[0]
        bt_row = np.full((self.max_pages,), self.pc.trash_page, np.int32)
        bt_row[: len(pages)] = pages
        self._bt[i] = bt_row

        plen = len(req.prompt)
        bucket = self._bucket(plen)
        toks = np.zeros((1, bucket), np.int32)
        toks[0, :plen] = req.prompt
        with self.tracer.span("prefill", rid=str(req.rid), prompt_len=plen,
                              bucket=bucket):
            # the first token is read back to the host: the span closes
            # after the prefill's device work
            first = self._prefill(torch.as_tensor(toks, device=self.device),
                                  plen, bt_row,
                                  params_arrays([req.sampling], [0]))
        self.metrics.prefills += 1
        self.metrics.first_token(req.rid)

        slot = _Slot(rid=req.rid, request=req, kv_len=plen,
                     generated=[first], admit_seq=self._admit_seq)
        self._admit_seq += 1
        self.slots[i] = slot
        self._maybe_finish(i, first)
        return True

    # ------------------------------------------------------------------
    # growth / eviction
    # ------------------------------------------------------------------
    def _preempt(self, i: int):
        """Evict slot ``i``: free its pages, requeue its request (front)."""
        slot = self.slots[i]
        self.pool.free(slot.rid)
        if self.cfg.reserve_pages:
            self._reserved_pages -= self.pc.pages_for(
                len(slot.request.prompt) + slot.request.max_new_tokens)
        self._bt[i] = self.pc.trash_page
        self.slots[i] = None
        self.queue.appendleft(slot.request)
        self.metrics.preemptions += 1
        self.tracer.instant("preempt", rid=str(slot.rid), slot=i)

    def _grow(self):
        """Ensure every active slot has a page for its next write."""
        order = sorted((s.admit_seq, i) for i, s in enumerate(self.slots)
                       if s is not None)
        for _, i in order:
            slot = self.slots[i]
            if slot is None:
                continue
            n_owned = len(self.pool.pages(slot.rid))
            if slot.kv_len < n_owned * self.cfg.page_size:
                continue
            while True:
                got = self.pool.alloc(slot.rid, 1)
                if got is not None:
                    self._bt[i, n_owned] = got[0]
                    break
                # page exhaustion: evict the youngest active sequence
                victims = [(s.admit_seq, j) for j, s in
                           enumerate(self.slots) if s is not None]
                _, j = max(victims)
                self._preempt(j)
                if j == i:          # evicted ourselves; nothing to grow
                    break

    # ------------------------------------------------------------------
    # finish / retire
    # ------------------------------------------------------------------
    def _maybe_finish(self, i: int, last_token: int) -> bool:
        slot = self.slots[i]
        req = slot.request
        done = len(slot.generated) >= req.max_new_tokens or \
            (req.stop_token is not None and last_token == req.stop_token)
        if not done:
            return False
        self.outputs[slot.rid] = np.asarray(slot.generated, np.int32)
        self._live.discard(slot.rid)
        self.metrics.finish(slot.rid, len(slot.generated))
        self.tracer.instant("finish", rid=str(slot.rid),
                            n_generated=len(slot.generated))
        self.pool.free(slot.rid)
        if self.cfg.reserve_pages:
            self._reserved_pages -= self.pc.pages_for(
                len(req.prompt) + req.max_new_tokens)
        self._bt[i] = self.pc.trash_page
        self.slots[i] = None
        return True

    # ------------------------------------------------------------------
    # the step loop
    # ------------------------------------------------------------------
    def step(self) -> bool:
        """Admit + grow + one decode step.  False when fully idle."""
        with self.tracer.span("engine_step"):
            out = self._step_inner()
        if self.monitor is not None:
            self.monitor.poll()
        return out

    def _step_inner(self) -> bool:
        with self.tracer.span("admission"):
            while self._try_admit_one():
                pass
            self._grow()

        active_idx = [i for i, s in enumerate(self.slots) if s is not None]
        if not active_idx:
            return bool(self.queue)

        B = self.cfg.max_slots
        tokens = np.zeros((B, 1), np.int32)
        lengths = np.zeros((B,), np.int32)
        active = np.zeros((B,), bool)
        sp_list = [self._greedy] * B
        steps = [0] * B
        for i in active_idx:
            s = self.slots[i]
            tokens[i, 0] = s.generated[-1]
            lengths[i] = s.kv_len
            active[i] = True
            sp_list[i] = s.request.sampling
            steps[i] = len(s.generated)

        greedy = all(self.slots[i].request.sampling.temperature <= 0.0
                     for i in active_idx)
        with self.tracer.span("decode_step", batch=len(active_idx)):
            # the tokens come back to the host inside: the span covers
            # the step's device work
            nxt = self._decode(tokens, lengths, active, None if greedy
                               else params_arrays(sp_list, steps))
        self.metrics.decode_steps += 1

        for i in active_idx:
            s = self.slots[i]
            s.kv_len += 1
            tok = int(nxt[i])
            s.generated.append(tok)
            self._maybe_finish(i, tok)
        return True

    def run(self, requests) -> Dict[object, np.ndarray]:
        """Submit everything, drive the loop to completion, return
        {rid: generated token ids}; read ``self.metrics`` for stats.
        ``outputs`` and ``metrics`` accumulate across calls."""
        for r in requests:
            self.submit(r)
        while self.step():
            pass
        return dict(self.outputs)

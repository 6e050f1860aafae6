"""Decoder stack for training and serving (counterpart of
``repro/models/transformer.py`` for the ATTN and RWKV mixer kinds):
``train_loss`` (full-sequence forward, mean token cross entropy, remat
and chunked cross entropy), prefill, ring-buffer decode and paged decode.

The parameter tree is the reference's: ``embed``, ``head``,
``final_norm``, ``periods`` (one dict per pattern position whose tensors
carry a leading layer axis) and ``remainder`` (single layers).  Where the
reference runs the periods under ``lax.scan``, the port loops over the
layer index i in Python and reads slice i of the same stacked tensors
(in training through one ``unbind`` a leaf, so the backward stacks the
layers' gradients once).

Weights stay in ``param_dtype`` (float32) and every use casts to the
compute dtype, as in the reference; :meth:`Transformer.compute_params`
makes that cast once for the weights that are only ever used cast (the
same numbers: a cast is deterministic), so a decode step does not re-read
the float32 copy.

Caches follow the reference's trees and are updated IN PLACE by the
decode functions, which return the same tensors (the reference donates
the buffers instead); ``cache["pos"]`` is a Python int.

Mixers, frontends and cache formats of the reference that the port does
not have yet raise ``NotImplementedError`` at ``Transformer(cfg)``: MoE,
RG-LRU, LOCAL and XATTN mixers, ``embed_input="embeddings"`` and the int8
KV cache (ROADMAP queue A item 13b).
"""
from __future__ import annotations

from typing import Any, Dict, List

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..core.util import resolve_device, tree_map
from .attention import chunked_attention, decode_attention, full_attention
from .config import ATTN, RWKV, ModelConfig
from .layers import apply_rope, head_rms_norm, rms_norm, trunc_normal
from .rwkv import (init_rwkv, init_rwkv_channel_mix, rwkv_channel_mix,
                   rwkv_time_mix)

NOT_PORTED_ITEM = ("ROADMAP queue A item 13b (the other LM families: MoE, "
                   "RG-LRU, LOCAL / XATTN, embeddings, int8 KV cache)")

#: parameter leaves the reference only ever uses cast to the compute dtype
COMPUTE_CAST_LEAVES = frozenset({
    "embed", "head", "wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down",
    "w_r", "w_k", "w_v", "w_g", "w_w", "w_o", "w_in", "w_out", "mix",
    "ln_x"})


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


def check_supported(cfg: ModelConfig):
    """Raise ``NotImplementedError`` for what the port does not have."""
    what = []
    if cfg.moe is not None:
        what.append("MoE feed-forward")
    bad = sorted(set(cfg.pattern) - {ATTN, RWKV})
    if bad:
        what.append(f"mixer kinds {bad}")
    if cfg.embed_input != "tokens":
        what.append(f"embed_input={cfg.embed_input!r}")
    if cfg.kv_cache_dtype != "bfloat16":
        what.append(f"kv_cache_dtype={cfg.kv_cache_dtype!r}")
    if what:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(what)} not ported to repro_torch yet "
            f"({NOT_PORTED_ITEM}); the port serves dense attention "
            "(qwen3, granite, stablelm, mistral-nemo) and RWKV-6 archs")


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


def _init_layers(gen, cfg: ModelConfig, kind: str, n: int, device):
    """``n`` stacked layers of ``kind`` (leading axis n)."""
    dt = cfg.pdtype
    p: Dict[str, Any] = {
        "ln1": torch.ones((n, cfg.d_model), dtype=dt, device=device),
        "ln2": torch.ones((n, cfg.d_model), dtype=dt, device=device)}
    if kind == RWKV:
        p["mixer"] = init_rwkv(gen, cfg, n, device)
        p["mlp"] = init_rwkv_channel_mix(gen, cfg, n, device)
    else:
        p["mixer"] = _init_attn(gen, cfg, n, device)
        p["mlp"] = _init_mlp(gen, cfg, n, device)
    return p


class Transformer:
    """The decoder for one ``ModelConfig`` on one device.

    ``device`` defaults to ``"cuda"`` and raises without a card; pass
    ``device="cpu"`` to run the plain versions of the kernels there.
    """

    def __init__(self, cfg: ModelConfig, device="cuda"):
        check_supported(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)

    # ---- init ----
    def init(self, seed: int = 0) -> Dict[str, Any]:
        """Random parameters in ``param_dtype`` on the model's device,
        drawn from a ``torch.Generator`` seeded with ``seed`` (numbers
        differ from the reference's ``jax.random``; the tree and the
        distributions are the same)."""
        cfg, dev = self.cfg, self.device
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(seed))
        n_full, n_rem = cfg.n_periods()
        dt = cfg.pdtype
        params: Dict[str, Any] = {
            "embed": trunc_normal(gen, (cfg.vocab, cfg.d_model), 1.0, dt,
                                  dev),
            "head": trunc_normal(gen, (cfg.d_model, cfg.vocab),
                                 cfg.d_model ** -0.5, dt, dev),
            "final_norm": torch.ones((cfg.d_model,), dtype=dt, device=dev),
        }
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
        tokens = torch.as_tensor(batch["tokens"], device=self.device)
        return params["embed"][tokens.long()].to(self.cfg.cdtype)

    def _mlp(self, p, x, kind):
        if kind == RWKV:
            return rwkv_channel_mix(p, x, self.cfg)[0]
        cdt = self.cfg.cdtype
        h = F.silu(x @ p["w_gate"].to(cdt)) * (x @ p["w_up"].to(cdt))
        return h @ p["w_down"].to(cdt)

    def _qkv(self, p, h):
        cfg, cdt = self.cfg, self.cfg.cdtype
        B, S, _ = h.shape
        H, KV, hd = cfg.n_heads, cfg.n_kv, cfg.hd
        k = (h @ p["wk"].to(cdt)).reshape(B, S, KV, hd)
        v = (h @ p["wv"].to(cdt)).reshape(B, S, KV, hd)
        q = (h @ p["wq"].to(cdt)).reshape(B, S, H, hd)
        if cfg.qk_norm:
            q = head_rms_norm(q, p["q_norm"], cfg.norm_eps)
            k = head_rms_norm(k, p["k_norm"], cfg.norm_eps)
        return q, k, v

    def _final_logits(self, params, x):
        cfg = self.cfg
        x = rms_norm(x, params["final_norm"], cfg.norm_eps)
        return (x @ params["head"].to(cfg.cdtype)).float()

    # ---- train ----
    def _attn_train(self, p, x, positions):
        cfg, cdt = self.cfg, self.cfg.cdtype
        B, S, _ = x.shape
        q, k, v = self._qkv(p, x)
        attn = (chunked_attention if cfg.attn_impl == "chunked"
                else full_attention)
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
        out = attn(q, k, v, causal=True, window=cfg.swa_window)
        return out.reshape(B, S, cfg.n_heads * cfg.hd) @ p["wo"].to(cdt)

    def _mixer_train(self, p, x, kind, positions):
        """ln1 and the mixer: the residual branch of the first half."""
        h = rms_norm(x, p["ln1"], self.cfg.norm_eps)
        if kind == RWKV:
            return rwkv_time_mix(p["mixer"], h, self.cfg)[0]
        return self._attn_train(p["mixer"], h, positions)

    def _mlp_train(self, p, x, kind):
        """ln2 and the MLP: the residual branch of the second half."""
        return self._mlp(p["mlp"], rms_norm(x, p["ln2"], self.cfg.norm_eps),
                         kind)

    def _layer_train(self, p, x, kind, positions):
        x = x + self._mixer_train(p, x, kind, positions)
        return x + self._mlp_train(p, x, kind)

    def _backbone_train(self, params, x, positions):
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
            # one unbind a stacked leaf: slice i of every leaf, whose
            # gradients the backward stacks in one go
            layers = [tree_map(lambda a: a.unbind(0), t)
                      for t in params["periods"]]
            n_full = len(params["periods"][0]["ln1"])
            for i in range(n_full):
                ps = [tree_map(lambda a: a[i], t, leaf=tuple)
                      for t in layers]
                x = self._period_train(ps, x, positions)
        for r, p in enumerate(params["remainder"]):
            x = self._layer_train(p, x, cfg.pattern[r % kp], positions)
        return x

    def _period_train(self, ps, x, positions):
        cfg = self.cfg
        kinds = cfg.pattern

        def body(xc):
            for p, kind in zip(ps, kinds):
                xc = self._layer_train(p, xc, kind, positions)
            return xc

        if not torch.is_grad_enabled():
            return body(x)
        if cfg.remat_policy == "save_boundaries":
            for p, kind in zip(ps, kinds):
                x = x + checkpoint(self._mixer_train, p, x, kind, positions,
                                   use_reentrant=False)
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
        x = self._backbone_train(params, x, positions)
        return rms_norm(x, params["final_norm"], cfg.norm_eps)

    def logits_fn(self, params, batch):
        """Logits (B, S, V) float32 of every position of ``batch``."""
        x = self._hidden_fn(params, batch)
        return (x @ params["head"].to(self.cfg.cdtype)).float()

    def train_loss(self, params, batch):
        """Mean next-token cross entropy of ``batch`` ({"tokens",
        "labels"}: (B, S) integers), a 0-d float32 tensor.

        With ``loss_chunk`` = C, S > C and C dividing S, the head and the
        cross entropy run C tokens at a time, each chunk under a
        checkpoint: the (B, C, vocab) float32 logits exist for one chunk
        at a time and the backward recomputes them chunk by chunk;
        otherwise in one pass -- the reference's condition."""
        cfg = self.cfg
        x = self._hidden_fn(params, batch)
        labels = torch.as_tensor(batch["labels"], device=self.device).long()
        head = params["head"]
        B, S = labels.shape
        C = cfg.loss_chunk

        def chunk_nll(xc, lc):
            logits = (xc @ head.to(cfg.cdtype)).float()
            logz = torch.logsumexp(logits, dim=-1)
            gold = torch.gather(logits, -1, lc[..., None])[..., 0]
            return torch.sum(logz - gold)

        if not C or S <= C or S % C:
            return chunk_nll(x, labels) / (B * S)
        total = torch.zeros((), dtype=torch.float32, device=self.device)
        for i in range(S // C):
            sl = slice(i * C, (i + 1) * C)
            if torch.is_grad_enabled():
                total = total + checkpoint(chunk_nll, x[:, sl], labels[:, sl],
                                           use_reentrant=False)
            else:
                total = total + chunk_nll(x[:, sl], labels[:, sl])
        return total / (B * S)

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
        if kind == ATTN and self.cfg.swa_window is not None:
            return min(cache_len, self.cfg.swa_window)
        return cache_len

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
        L = self._cache_len(kind, cache_len)
        kv = (n, B, L, cfg.n_kv, cfg.hd)
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
    def _layer_prefill(self, p, x, kind, positions, cache_len,
                       linear_cache=False):
        """One layer over the whole sequence; returns (x, cache entry).

        ``linear_cache=True`` (paged serving): attention layers return the
        prompt's raw full-length k/v (no ring buffer, no padding to
        ``cache_len``) for the caller to scatter into a paged arena."""
        cfg, cdt = self.cfg, self.cfg.cdtype
        B, S, _ = x.shape
        h = rms_norm(x, p["ln1"], cfg.norm_eps)
        if kind == RWKV:
            mix, (x_tm, state) = rwkv_time_mix(p["mixer"], h, cfg)
            x = x + mix
            h2 = rms_norm(x, p["ln2"], cfg.norm_eps)
            out, x_cm = rwkv_channel_mix(p["mlp"], h2, cfg)
            return x + out, {"state": state, "x_tm": x_tm.to(cdt),
                             "x_cm": x_cm.to(cdt)}
        q, k, v = self._qkv(p["mixer"], h)
        attn = (chunked_attention if cfg.attn_impl == "chunked"
                else full_attention)
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
        out = attn(q, k, v, causal=True, window=cfg.swa_window)
        L = self._cache_len(kind, cache_len)
        if linear_cache:
            ck, cv = k, v
        elif L >= S:
            ck = F.pad(k, (0, 0, 0, 0, 0, L - S))
            cv = F.pad(v, (0, 0, 0, 0, 0, L - S))
        else:
            # ring buffer: keep the last L, placed at slot pos % L
            shift = S % L
            ck = torch.roll(k[:, -L:], shift, dims=1)
            cv = torch.roll(v[:, -L:], shift, dims=1)
        H, hd = cfg.n_heads, cfg.hd
        x = x + out.reshape(B, S, H * hd) @ p["mixer"]["wo"].to(cdt)
        h2 = rms_norm(x, p["ln2"], cfg.norm_eps)
        return x + self._mlp(p["mlp"], h2, kind), {"k": ck, "v": cv}

    def prefill(self, params, batch, cache_len, *, last_pos=None,
                linear_cache=False):
        """Forward pass that also materialises the decode caches.

        ``batch``: {"tokens": (B, S)}.  ``last_pos``: position whose
        next-token logits to return (default: the last); serving prefills
        pad prompts to a bucket length, so the real last token sits
        mid-way.  ``linear_cache``: raw full-length k/v per attention
        layer (see ``_layer_prefill``).  Returns (logits (B, 1, V)
        float32, cache)."""
        cfg = self.cfg
        x = self._embed(params, batch)
        B, S = x.shape[:2]
        positions = torch.arange(S, device=self.device)
        kp = len(cfg.pattern)
        per_pos: List[List[dict]] = [[] for _ in range(kp)]
        caches_r = []
        n_period_layers = (len(params["periods"][0]["ln1"]) * kp
                           if params["periods"] else 0)
        for li, (p, kind) in enumerate(self._layers(params)):
            x, c = self._layer_prefill(p, x, kind, positions, cache_len,
                                       linear_cache=linear_cache)
            if li < n_period_layers:
                per_pos[li % kp].append(c)
            else:
                caches_r.append(tree_map(lambda a: a[None], c))
        caches_p = ([tree_map(lambda *xs: torch.stack(xs), *cs)
                     for cs in per_pos] if n_period_layers else [])
        last = S - 1 if last_pos is None else int(last_pos)
        logits = self._final_logits(params, x[:, last:last + 1])
        return logits, {"pos": S, "periods": caches_p,
                        "remainder": caches_r}

    # ---- decode ----
    def _layer_decode(self, p, x, cache, kind, pos: int):
        """x: (B,1,dm); cache: this layer's subtree (no leading layer
        axis), written in place."""
        cfg, cdt = self.cfg, self.cfg.cdtype
        B = x.shape[0]
        h = rms_norm(x, p["ln1"], cfg.norm_eps)
        if kind == RWKV:
            mix, (x_tm, state) = rwkv_time_mix(
                p["mixer"], h, cfg, x_last=cache["x_tm"],
                state=cache["state"])
            x = x + mix
            h2 = rms_norm(x, p["ln2"], cfg.norm_eps)
            out, x_cm = rwkv_channel_mix(p["mlp"], h2, cfg,
                                         x_last=cache["x_cm"])
            cache["state"].copy_(state)
            cache["x_tm"].copy_(x_tm)
            cache["x_cm"].copy_(x_cm)
            return x + out
        H, hd = cfg.n_heads, cfg.hd
        q, k, v = self._qkv(p["mixer"], h)
        posv = torch.tensor([pos], device=self.device)
        q = apply_rope(q, posv, cfg.rope_theta)
        k = apply_rope(k, posv, cfg.rope_theta)
        L = cache["k"].shape[1]
        cache["k"][:, pos % L] = k[:, 0]
        cache["v"][:, pos % L] = v[:, 0]
        # with a ring buffer every slot is valid once filled; the per-slot
        # positional mask only matters while pos < L
        out = decode_attention(q, cache["k"], cache["v"], min(pos, L - 1))
        x = x + out.reshape(B, 1, H * hd) @ p["mixer"]["wo"].to(cdt)
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
        """batch: {"tokens": (B, 1)}.  Returns (logits (B, 1, V), cache)
        with the cache updated in place and ``cache["pos"]`` advanced."""
        x = self._embed(params, batch)
        pos = int(cache["pos"])
        for (p, kind), c in zip(self._layers(params),
                                self._cache_layers(cache)):
            x = self._layer_decode(p, x, c, kind, pos)
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
        out = decode_attention(q, kseq, vseq, pos, window=cfg.swa_window)
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
        dev = self.device
        x = self._embed(params, batch)
        bt = torch.as_tensor(block_tables, device=dev).long()
        pos = torch.as_tensor(lengths, device=dev).long()
        act = torch.as_tensor(active, device=dev).bool()
        for (p, kind), a in zip(self._layers(params),
                                self._cache_layers(arenas)):
            x = self._layer_decode_paged(p, x, a, kind, bt, pos, act)
        return self._final_logits(params, x), arenas

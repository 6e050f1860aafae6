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

from typing import Any, Dict, List

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..core.util import resolve_device, tree_map
from .attention import chunked_attention, decode_attention, full_attention
from .config import ATTN, LOCAL, RGLRU, RWKV, XATTN, ModelConfig
from .layers import apply_rope, head_rms_norm, rms_norm, trunc_normal
from .moe import init_moe, moe_ffn
from .rglru import init_rglru, rglru_block, rglru_decode
from .rwkv import (init_rwkv, init_rwkv_channel_mix, rwkv_channel_mix,
                   rwkv_time_mix)

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
            return params["embed"][tokens.long()].to(self.cfg.cdtype)
        return torch.as_tensor(batch["embeds"], device=self.device).to(
            self.cfg.cdtype)

    def _encoder(self, batch):
        """The stub encoder states of ``batch`` (XATTN's k / v source) in
        the compute dtype, or None."""
        enc = batch.get("encoder") if isinstance(batch, dict) else None
        if enc is None:
            return None
        return torch.as_tensor(enc, device=self.device).to(self.cfg.cdtype)

    def _mlp(self, p, x, kind):
        if kind == RWKV:
            return rwkv_channel_mix(p, x, self.cfg)[0]
        if self.cfg.moe is not None:
            return moe_ffn(p, x, self.cfg)
        cdt = self.cfg.cdtype
        h = F.silu(x @ p["w_gate"].to(cdt)) * (x @ p["w_up"].to(cdt))
        return h @ p["w_down"].to(cdt)

    def _qkv(self, p, h, src=None):
        """q of ``h``, k and v of ``src`` (XATTN's encoder states; ``h``
        by default), q / k normed where the config says."""
        cfg, cdt = self.cfg, self.cfg.cdtype
        src = h if src is None else src
        B, S, _ = h.shape
        Skv = src.shape[1]
        H, KV, hd = cfg.n_heads, cfg.n_kv, cfg.hd
        k = (src @ p["wk"].to(cdt)).reshape(B, Skv, KV, hd)
        v = (src @ p["wv"].to(cdt)).reshape(B, Skv, KV, hd)
        q = (h @ p["wq"].to(cdt)).reshape(B, S, H, hd)
        if cfg.qk_norm:
            q = head_rms_norm(q, p["q_norm"], cfg.norm_eps)
            k = head_rms_norm(k, p["k_norm"], cfg.norm_eps)
        return q, k, v

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
            return attn(q, k, v, causal=False, window=None), k, v
        q, k, v = self._qkv(p, h)
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
        return attn(q, k, v, causal=True, window=self._window(kind)), k, v

    def _final_logits(self, params, x):
        cfg = self.cfg
        x = rms_norm(x, params["final_norm"], cfg.norm_eps)
        return (x @ params["head"].to(cfg.cdtype)).float()

    # ---- train ----
    def _attn_train(self, p, x, kind, positions, enc):
        cfg, cdt = self.cfg, self.cfg.cdtype
        B, S, _ = x.shape
        out = self._attn_seq(p, x, kind, positions, enc)[0]
        return out.reshape(B, S, cfg.n_heads * cfg.hd) @ p["wo"].to(cdt)

    def _mixer_train(self, p, x, kind, positions, enc=None):
        """ln1 and the mixer: the residual branch of the first half."""
        h = rms_norm(x, p["ln1"], self.cfg.norm_eps)
        if kind == RWKV:
            return rwkv_time_mix(p["mixer"], h, self.cfg)[0]
        if kind == RGLRU:
            return rglru_block(p["mixer"], h, self.cfg)[0]
        return self._attn_train(p["mixer"], h, kind, positions, enc)

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
    def _layer_prefill(self, p, x, kind, positions, cache_len, enc=None,
                       linear_cache=False):
        """One layer over the whole sequence; returns (x, cache entry).

        ``linear_cache=True`` (paged serving): attention layers return the
        prompt's raw full-length k/v (no ring buffer, no padding to
        ``cache_len``, no int8) for the caller to scatter into a paged
        arena."""
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
        if kind == RGLRU:
            mix, hstate = rglru_block(p["mixer"], h, cfg)
            x = x + mix
            h2 = rms_norm(x, p["ln2"], cfg.norm_eps)
            return x + self._mlp(p["mlp"], h2, kind), {"h": hstate}
        out, k, v = self._attn_seq(p["mixer"], h, kind, positions, enc)
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
        H, hd = cfg.n_heads, cfg.hd
        x = x + out.reshape(B, S, H * hd) @ p["mixer"]["wo"].to(cdt)
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
        raw full-length k/v per attention layer (see ``_layer_prefill``).
        Returns (logits (B, 1, V) float32, cache)."""
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
        if kind == RGLRU:
            mix, hstate = rglru_decode(p["mixer"], h, cfg, state=cache["h"])
            cache["h"].copy_(hstate)
            x = x + mix
            h2 = rms_norm(x, p["ln2"], cfg.norm_eps)
            return x + self._mlp(p["mlp"], h2, kind)
        H, hd = cfg.n_heads, cfg.hd
        if kind == XATTN:
            # the static encoder cache, every entry visible
            q = (h @ p["mixer"]["wq"].to(cdt)).reshape(B, 1, H, hd)
            if cfg.qk_norm:
                q = head_rms_norm(q, p["mixer"]["q_norm"], cfg.norm_eps)
            out = decode_attention(q, cache["k"], cache["v"],
                                   cfg.encoder_len - 1)
        else:
            q, k, v = self._qkv(p["mixer"], h)
            posv = torch.tensor([pos], device=self.device)
            q = apply_rope(q, posv, cfg.rope_theta)
            k = apply_rope(k, posv, cfg.rope_theta)
            L = cache["k"].shape[1]
            slot = pos % L
            if self._int8(kind):
                qk, sk = _kv_quant(k)
                qv, sv = _kv_quant(v)
                cache["k"][:, slot] = qk[:, 0]
                cache["v"][:, slot] = qv[:, 0]
                cache["k_scale"][:, slot] = sk[:, 0]
                cache["v_scale"][:, slot] = sv[:, 0]
                ak = _kv_dequant(cache["k"], cache["k_scale"], cdt)
                av = _kv_dequant(cache["v"], cache["v_scale"], cdt)
            else:
                cache["k"][:, slot] = k[:, 0]
                cache["v"][:, slot] = v[:, 0]
                ak, av = cache["k"], cache["v"]
            # with a ring buffer every slot is valid once filled; the
            # per-slot positional mask only matters while pos < L
            out = decode_attention(q, ak, av, min(pos, L - 1))
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
        """batch: {"tokens": (B, 1)} (or {"embeds": (B, 1, d_model)}).
        Returns (logits (B, 1, V), cache) with the cache updated in place
        and ``cache["pos"]`` advanced."""
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
        dev = self.device
        x = self._embed(params, batch)
        bt = torch.as_tensor(block_tables, device=dev).long()
        pos = torch.as_tensor(lengths, device=dev).long()
        act = torch.as_tensor(active, device=dev).bool()
        for (p, kind), a in zip(self._layers(params),
                                self._cache_layers(arenas)):
            x = self._layer_decode_paged(p, x, a, kind, bt, pos, act)
        return self._final_logits(params, x), arenas

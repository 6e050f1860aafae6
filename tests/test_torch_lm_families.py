"""The LM families beyond dense attention and RWKV-6 -- MoE (Mixtral,
Moonshot), RG-LRU with LOCAL attention (RecurrentGemma), cross attention
(Llama-3.2-Vision), the embedding frontend (MusicGen) -- and the int8 KV
cache, against the reference at reduced size on the CPU, float32 compute:
the same weights (``convert.lm_params_from_reference``) and the same numpy
inputs through ``logits_fn``, ``train_loss`` and its gradients, prefill
and a decode chain (ring buffers that wrap, XATTN's static encoder cache),
paged decode with MoE, and B5 at head dim 256 (RecurrentGemma's).
Tolerance 1e-5 (rtol = atol) unless a test says otherwise.  The
per-family checks run here for MoE and the embedding frontend and, as the
same ``check_*`` functions, for RG-LRU and cross attention in
``test_torch_lm_families_rglru_xattn.py``.

RecurrentGemma runs at ``reduced(cfg, n_layers=5)``: one (rglru, rglru,
local) period and two remainder layers.  ``reduced()`` itself, copied from
the reference, tests for the pattern (rglru, rglru, attn), which this
config does not have, so by default it gives 3 layers and no remainder."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash import flash_attention as ref_flash
from repro.serve import cache as ref_cache
from repro_torch.kernels.flash import flash_attention, flash_route
from repro_torch.launch.steps import loss_and_grads
from repro_torch.models.transformer import tree_map
from repro_torch.core.util import tree_leaves as leaves
from repro_torch.serve import cache as port_cache
from test_torch_common import lm_pair

TOL = 1e-5
#: the families whose cases this file runs: MoE and the embedding
#: frontend; RG-LRU with LOCAL attention and cross attention run the same
#: checks in ``test_torch_lm_families_rglru_xattn.py``
HERE = ["mixtral-8x7b", "moonshot-v1-16b-a3b", "musicgen-large"]
REMATS = ["nothing", "save_boundaries"]
#: the overrides that make each reduced config reach all of its paths
OVERRIDES = {"recurrentgemma-9b": {"n_layers": 5}}


def _pair(arch, **kw):
    return lm_pair(arch, **{**OVERRIDES.get(arch, {}), **kw})


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, tol=TOL, what=""):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol,
                               err_msg=what)


def _close_tree(got, want, tol=TOL):
    for path, w in jax.tree_util.tree_flatten_with_path(want)[0]:
        g = got
        for p in path:
            g = g[p.key if hasattr(p, "key") else p.idx]
        assert tuple(g.shape) == w.shape, jax.tree_util.keystr(path)
        assert str(g.dtype).split(".")[-1] == str(w.dtype)
        _close(g, w, tol, jax.tree_util.keystr(path))


def _inputs(cfg, seed, B, S, labels=False):
    """numpy inputs of ``cfg``'s frontend: tokens or frame embeddings,
    and stub encoder states where the pattern has XATTN layers."""
    rng = np.random.default_rng(seed)
    b = {}
    if cfg.embed_input == "tokens":
        b["tokens"] = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    else:
        b["embeds"] = rng.normal(size=(B, S, cfg.d_model)).astype(np.float32)
    if cfg.encoder_len:
        b["encoder"] = rng.normal(
            size=(B, cfg.encoder_len, cfg.d_model)).astype(np.float32)
    if labels:
        b["labels"] = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    return b


def _j(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _t(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def check_logits_fn(arch):
    rmodel, rparams, pmodel, pparams = _pair(arch)
    b = _inputs(pmodel.cfg, 1, 2, 16)
    with torch.no_grad():
        got = pmodel.logits_fn(pparams, _t(b))
    _close(got, rmodel.logits_fn(rparams, _j(b)))


@pytest.mark.parametrize("arch", HERE)
def test_logits_fn_matches_the_reference(arch):
    check_logits_fn(arch)


def check_loss_and_grads(arch, remat):
    """Every leaf's gradient (the router's, the experts', RG-LRU's lam,
    XATTN's) at 1e-5, none of them zero."""
    rmodel, rparams, pmodel, pparams = _pair(arch, remat_policy=remat)
    b = _inputs(pmodel.cfg, 2, 2, 16, labels=True)
    r_loss, r_grads = jax.jit(jax.value_and_grad(rmodel.train_loss))(
        rparams, _j(b))
    params = tree_map(lambda t: t.detach().clone(), pparams)
    loss, grads = loss_and_grads(pmodel, params, b, accum_steps=1)
    np.testing.assert_allclose(float(loss), float(r_loss), rtol=TOL, atol=TOL)
    _close_tree(grads, r_grads)
    assert all(float(g.abs().max()) > 0 for g in leaves(grads))


@pytest.mark.parametrize("arch", HERE)
@pytest.mark.parametrize("remat", REMATS)
def test_train_loss_and_grads_match_the_reference(arch, remat):
    check_loss_and_grads(arch, remat)


def _decode_input(cfg, nxt, step):
    """The next decode step's input: the argmax tokens, or (embedding
    frontend) fresh frame embeddings."""
    if cfg.embed_input == "tokens":
        return {"tokens": nxt[:, None].astype(np.int32)}
    rng = np.random.default_rng(100 + step)
    return {"embeds": rng.normal(size=(nxt.shape[0], 1, cfg.d_model)
                                 ).astype(np.float32)}


def _prefill_decode(arch, S, cache_len, steps, **kw):
    rmodel, rparams, pmodel, pparams = _pair(arch, **kw)
    cfg = pmodel.cfg
    b = _inputs(cfg, 3, 2, S)
    r_logits, r_cache = jax.jit(
        lambda p, bb: rmodel.prefill(p, bb, cache_len))(rparams, _j(b))
    with torch.no_grad():
        p_logits, p_cache = pmodel.prefill(pparams, _t(b), cache_len)
    _close(p_logits, r_logits, what="prefill logits")
    _close_tree({k: p_cache[k] for k in ("periods", "remainder")},
                {k: r_cache[k] for k in ("periods", "remainder")})
    decode = jax.jit(rmodel.decode_step)
    for step in range(steps):
        nxt = np.asarray(jnp.argmax(r_logits[:, -1], -1))
        inp = _decode_input(cfg, nxt, step)
        r_logits, r_cache = decode(rparams, r_cache, _j(inp))
        with torch.no_grad():
            p_logits, p_cache = pmodel.decode_step(pparams, p_cache, _t(inp))
        _close(p_logits, r_logits, what=f"decode logits {step}")
        _close_tree({k: p_cache[k] for k in ("periods", "remainder")},
                    {k: r_cache[k] for k in ("periods", "remainder")})
        assert p_cache["pos"] == int(r_cache["pos"]) == S + step + 1
    return p_cache


def check_prefill_then_decode(arch):
    """Prompt 20, cache 28: the windows of 16 (Mixtral's sliding window,
    RecurrentGemma's LOCAL layers) wrap their ring buffers in prefill and
    again in decode; XATTN layers decode against the encoder cache."""
    cache = _prefill_decode(arch, 20, 28, 5)
    if arch == "llama-3.2-vision-90b":
        # the encoder cache is the static (B, encoder_len, KV, hd) k / v
        assert cache["periods"][4]["k"].shape[2] == 8


@pytest.mark.parametrize("arch", HERE)
def test_prefill_then_decode_matches_the_reference(arch):
    check_prefill_then_decode(arch)


def check_int8_kv_cache(arch, S, cache_len):
    """int8 ring buffers (values, and absmax / 127 scales in float32):
    Qwen3's 8-slot cache and Mixtral's / RecurrentGemma's 16-slot windows
    wrap in prefill and in decode; Vision's XATTN cache stays in the
    compute dtype."""
    cache = _prefill_decode(arch, S, cache_len, 6, kv_cache_dtype="int8")
    kinds = [k for k in ("periods", "remainder") for c in cache[k]
             if "k_scale" in c]
    assert kinds
    assert all(c["k"].dtype == torch.int8 for k in ("periods", "remainder")
               for c in cache[k] if "k_scale" in c)


@pytest.mark.parametrize("arch,S,cache_len", [
    ("qwen3-1.7b", 12, 8), ("mixtral-8x7b", 20, 28)])
def test_int8_kv_cache_matches_the_reference(arch, S, cache_len):
    check_int8_kv_cache(arch, S, cache_len)


def test_moe_paged_decode_matches_the_reference():
    """Mixtral through the paged engine's model calls: two prompts written
    into pages, three paged decode steps (MoE on every slot, a third
    inactive one), the sliding window of 16 crossed."""
    rmodel, rparams, pmodel, pparams = _pair("mixtral-8x7b")
    rpc = ref_cache.PagedCacheConfig(page_size=4, num_pages=16)
    ppc = port_cache.PagedCacheConfig(page_size=4, num_pages=16)
    r_ar = ref_cache.make_paged_arenas(rmodel.cfg, rpc)
    p_ar = port_cache.make_paged_arenas(pmodel.cfg, ppc, "cpu")
    bt = np.full((3, 6), 16, np.int32)
    bt[0, :5] = [4, 0, 7, 11, 3]
    bt[1, :2] = [2, 9]
    lens = [17, 5]
    first = []
    for b, L in enumerate(lens):
        toks = np.zeros((1, 20), np.int32)
        toks[0, :L] = np.random.default_rng(10 + b).integers(0, 256, L)
        rl, rc = rmodel.prefill(rparams, {"tokens": jnp.asarray(toks)}, 20,
                                last_pos=L - 1, linear_cache=True)
        r_ar = ref_cache.write_prompt_pages(r_ar, rc, jnp.asarray(bt[b]), L,
                                            rpc)
        with torch.no_grad():
            pl_, pc_ = pmodel.prefill(pparams,
                                      {"tokens": torch.from_numpy(toks)}, 20,
                                      last_pos=L - 1, linear_cache=True)
        port_cache.write_prompt_pages(p_ar, pc_, bt[b], L, ppc)
        _close(pl_, rl)
        first.append(int(np.argmax(np.asarray(rl)[0, 0])))
    tokens = np.array([[first[0]], [first[1]], [0]], np.int32)
    lengths = np.array([17, 5, 0], np.int32)
    active = np.array([True, True, False])
    for step in range(3):
        rl, r_ar = rmodel.decode_step_paged(
            rparams, r_ar, {"tokens": jnp.asarray(tokens)}, jnp.asarray(bt),
            jnp.asarray(lengths), jnp.asarray(active))
        with torch.no_grad():
            pl_, p_ar = pmodel.decode_step_paged(
                pparams, p_ar, {"tokens": torch.from_numpy(tokens)}, bt,
                lengths, active)
        _close(pl_[:2], rl[:2], what=f"paged logits {step}")
        tokens = np.argmax(np.asarray(rl)[:, 0], -1).astype(np.int32)[:, None]
        lengths = lengths + active
    _close_tree(jax.tree.map(lambda a: a[:, :16], p_ar),
                jax.tree.map(lambda a: a[:, :16], r_ar))


def test_paged_serving_refuses_what_the_reference_refuses():
    """RG-LRU / XATTN mixers, int8 pages and the embedding frontend take
    the static loop, as in the reference; MoE with a sliding window (and
    LOCAL) is pageable."""
    for arch, named in (("recurrentgemma-9b", "rglru"),
                        ("llama-3.2-vision-90b", "xattn"),
                        ("musicgen-large", "token frontend")):
        with pytest.raises(NotImplementedError, match=named):
            port_cache.paged_kinds(_pair(arch)[2].cfg)
    with pytest.raises(NotImplementedError, match="int8"):
        port_cache.paged_kinds(_pair("qwen3-1.7b",
                                     kv_cache_dtype="int8")[2].cfg)
    assert port_cache.paged_kinds(_pair("mixtral-8x7b")[2].cfg) == ["attn"]


@pytest.mark.parametrize("dtype,route", [(torch.bfloat16, "tc"),
                                         (torch.float32, "simt")])
def test_flash_route_at_head_dim_256(dtype, route):
    assert flash_route(dtype, 256) == route


@pytest.mark.parametrize("dtype,tol", [("float32", 2e-5), ("bfloat16", 3e-2)])
@pytest.mark.parametrize("S,Skv,causal,window", [
    (80, 80, True, 48), (40, 70, False, None), (130, 130, True, None)])
def test_flash_at_head_dim_256_matches_the_reference(dtype, tol, S, Skv,
                                                     causal, window):
    """B5's plain version at RecurrentGemma's head dim (16 query heads, 1
    KV head), against the reference's flash attention (its plain
    reference, as tests/test_kernels.py runs it), at that file's
    tolerances."""
    rng = np.random.default_rng(S + Skv)
    arrs = [rng.normal(size=s).astype(np.float32)
            for s in ((1, S, 16, 256), (1, Skv, 1, 256), (1, Skv, 1, 256))]
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    td = getattr(torch, dtype)
    got = flash_attention(*(torch.from_numpy(a).to(td) for a in arrs),
                          causal=causal, window=window)
    want = ref_flash(*(jnp.asarray(a, jd) for a in arrs), causal=causal,
                     window=window, backend="ref")
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)

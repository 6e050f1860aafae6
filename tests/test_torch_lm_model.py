"""The port's LM decoder (``repro_torch.models``) against the reference's
(``repro.models``) at reduced size on the CPU: the same weights, carried
across by ``convert.lm_params_from_reference``, and the same numpy tokens
through ``prefill`` (logits, ring-buffer and linear caches),
``decode_step`` and ``decode_step_paged``, for Qwen3 (GQA, qk-norm) and
RWKV-6; the init trees of all ten archs (the other families' numbers are
in tests/test_torch_lm_families.py).  Float32 compute at 1e-5; one bfloat16 case at a stated looser
tolerance."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.serve import cache as ref_cache
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.models import Transformer, reduced
from repro_torch.models.layers import apply_rope, rms_norm
from repro_torch.serve import cache as port_cache
from test_torch_common import lm_pair

TOL = 1e-5
def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, tol=TOL, what=""):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol,
                               err_msg=what)


def _close_tree(got, want, tol=TOL):
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    for path, w in flat_w:
        g = got
        for p in path:
            g = g[p.key if hasattr(p, "key") else p.idx]
        _close(g, w, tol, jax.tree_util.keystr(path))


def _tokens(seed, B, S, vocab=256):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)
                                                ).astype(np.int32)


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "rwkv6-3b", "granite-20b",
                                  "stablelm-12b", "mistral-nemo-12b",
                                  "mixtral-8x7b", "moonshot-v1-16b-a3b",
                                  "recurrentgemma-9b",
                                  "llama-3.2-vision-90b", "musicgen-large"])
def test_init_tree_matches_the_reference(arch):
    """Same tree, shapes and dtypes as the reference's init (the numbers
    differ: torch.Generator vs jax.random)."""
    rmodel, rparams, pmodel, _ = lm_pair(arch)
    mine = pmodel.init(0)
    flat = jax.tree_util.tree_flatten_with_path(rparams)[0]
    n = 0
    for path, w in flat:
        g = mine
        for p in path:
            g = g[p.key if hasattr(p, "key") else p.idx]
        assert tuple(g.shape) == w.shape, jax.tree_util.keystr(path)
        assert str(g.dtype).split(".")[-1] == str(w.dtype)
        n += 1
    assert n == len(jax.tree.leaves(mine))
    # ones stay ones; random leaves are drawn truncated at 2 sigma
    assert torch.all(mine["final_norm"] == 1)
    if "embed" in mine:
        assert float(mine["embed"].abs().max()) <= 2.0
    else:
        assert "embed" not in rparams           # the embedding frontend


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "rwkv6-3b"])
@pytest.mark.parametrize("cache_len", [20, 8])
def test_prefill_then_decode_matches_the_reference(arch, cache_len):
    """Logits and every cache leaf after prefill and after each of four
    decode steps; cache_len 8 < S = 12 exercises the ring buffer."""
    rmodel, rparams, pmodel, pparams = lm_pair(arch)
    toks = _tokens(1, 2, 12)
    r_logits, r_cache = jax.jit(
        lambda p, b: rmodel.prefill(p, b, cache_len))(
            rparams, {"tokens": jnp.asarray(toks)})
    p_logits, p_cache = pmodel.prefill(pparams,
                                       {"tokens": torch.from_numpy(toks)},
                                       cache_len)
    _close(p_logits, r_logits, what="prefill logits")
    assert p_cache["pos"] == int(r_cache["pos"])
    _close_tree({k: p_cache[k] for k in ("periods", "remainder")},
                {k: r_cache[k] for k in ("periods", "remainder")})
    decode = jax.jit(rmodel.decode_step)
    nxt = np.asarray(jnp.argmax(r_logits[:, -1], -1)).astype(np.int32)
    for step in range(4):
        r_logits, r_cache = decode(rparams, r_cache,
                                   {"tokens": jnp.asarray(nxt[:, None])})
        p_logits, p_cache = pmodel.decode_step(
            pparams, p_cache, {"tokens": torch.from_numpy(nxt[:, None])})
        _close(p_logits, r_logits, what=f"decode logits {step}")
        _close_tree({k: p_cache[k] for k in ("periods", "remainder")},
                    {k: r_cache[k] for k in ("periods", "remainder")})
        assert p_cache["pos"] == int(r_cache["pos"])
        nxt = np.asarray(jnp.argmax(r_logits[:, -1], -1)).astype(np.int32)


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "rwkv6-3b"])
def test_make_cache_matches_the_reference(arch):
    rmodel, _, pmodel, _ = lm_pair(arch)
    want, got = rmodel.make_cache(3, 10), pmodel.make_cache(3, 10)
    assert got["pos"] == int(want["pos"]) == 0
    trees = [{k: t[k] for k in ("periods", "remainder")} for t in (got, want)]
    _close_tree(*trees)
    for g, w in zip(jax.tree.leaves(trees[0]), jax.tree.leaves(trees[1])):
        assert str(g.dtype).split(".")[-1] == str(w.dtype)


def test_linear_cache_and_last_pos_match_the_reference():
    rmodel, rparams, pmodel, pparams = lm_pair("qwen3-1.7b")
    toks = _tokens(2, 1, 16)
    r_logits, r_cache = rmodel.prefill(rparams, {"tokens": jnp.asarray(toks)},
                                       16, last_pos=10, linear_cache=True)
    p_logits, p_cache = pmodel.prefill(pparams,
                                       {"tokens": torch.from_numpy(toks)},
                                       16, last_pos=10, linear_cache=True)
    _close(p_logits, r_logits)
    _close_tree({k: p_cache[k] for k in ("periods", "remainder")},
                {k: r_cache[k] for k in ("periods", "remainder")})
    _close(pmodel.logits_fn(pparams, {"tokens": torch.from_numpy(toks)}),
           rmodel.logits_fn(rparams, {"tokens": jnp.asarray(toks)}))


def test_paged_decode_matches_the_reference():
    """Two prompts of different lengths written into paged arenas (one
    of them across a page boundary), then three paged decode steps with a
    third, inactive slot."""
    rmodel, rparams, pmodel, pparams = lm_pair("qwen3-1.7b")
    cfgp = pmodel.cfg
    rpc = ref_cache.PagedCacheConfig(page_size=4, num_pages=12)
    ppc = port_cache.PagedCacheConfig(page_size=4, num_pages=12)
    r_ar = ref_cache.make_paged_arenas(rmodel.cfg, rpc)
    p_ar = port_cache.make_paged_arenas(cfgp, ppc, "cpu")
    max_pages = 5
    bt = np.full((3, max_pages), 12, np.int32)
    bt[0, :3] = [4, 0, 7]
    bt[1, :2] = [2, 9]
    lens = [7, 5]
    first = []
    for b, L in enumerate(lens):
        toks = np.zeros((1, 8), np.int32)
        toks[0, :L] = _tokens(10 + b, 1, L)[0]
        rl, rc = rmodel.prefill(rparams, {"tokens": jnp.asarray(toks)}, 8,
                                last_pos=L - 1, linear_cache=True)
        r_ar = ref_cache.write_prompt_pages(r_ar, rc, jnp.asarray(bt[b]), L,
                                            rpc)
        pl_, pc_ = pmodel.prefill(pparams,
                                  {"tokens": torch.from_numpy(toks)}, 8,
                                  last_pos=L - 1, linear_cache=True)
        port_cache.write_prompt_pages(p_ar, pc_, bt[b], L, ppc)
        _close(pl_, rl)
        first.append(int(np.argmax(np.asarray(rl)[0, 0])))
    _close_tree(p_ar, r_ar)
    tokens = np.array([[first[0]], [first[1]], [0]], np.int32)
    lengths = np.array([7, 5, 0], np.int32)
    active = np.array([True, True, False])
    # slot 0 writes positions 7, 8, 9: from step 1 on into its third page
    for step in range(3):
        rl, r_ar = rmodel.decode_step_paged(
            rparams, r_ar, {"tokens": jnp.asarray(tokens)}, jnp.asarray(bt),
            jnp.asarray(lengths), jnp.asarray(active))
        pl_, p_ar = pmodel.decode_step_paged(
            pparams, p_ar, {"tokens": torch.from_numpy(tokens)}, bt,
            lengths, active)
        _close(pl_[:2], rl[:2], what=f"paged logits {step}")
        tokens = np.argmax(np.asarray(rl)[:, 0], -1).astype(np.int32)[:, None]
        lengths = lengths + active
    # the trash page takes every masked write; compare the real pages
    _close_tree(jax.tree.map(lambda a: a[:, :12], p_ar),
                jax.tree.map(lambda a: a[:, :12], r_ar))


def test_bfloat16_prefill_and_decode_within_bf16_rounding():
    """Default compute dtype (bfloat16).  The two packages round at other
    places (the reference's chunked attention rounds q * scale and p to
    bf16, the port's kernel stays in float32; XLA's and PyTorch's CPU
    bf16 matmuls differ in accumulation), so logits are compared
    relative to their largest entry at 5e-2 (bf16 keeps ~2-3 digits and
    the error compounds over layers)."""
    rmodel, rparams, pmodel, pparams = lm_pair("qwen3-1.7b",
                                             compute_dtype="bfloat16")
    toks = _tokens(3, 2, 16)
    r_logits, r_cache = rmodel.prefill(rparams, {"tokens": jnp.asarray(toks)},
                                       20)
    p_logits, p_cache = pmodel.prefill(pparams,
                                       {"tokens": torch.from_numpy(toks)},
                                       20)
    scale = float(np.abs(np.asarray(r_logits)).max())
    assert np.abs(_np(p_logits) - _np(r_logits)).max() <= 5e-2 * scale
    nxt = np.asarray(jnp.argmax(r_logits[:, -1], -1)).astype(np.int32)
    r_logits, _ = rmodel.decode_step(rparams, r_cache,
                                     {"tokens": jnp.asarray(nxt[:, None])})
    p_logits, _ = pmodel.decode_step(pparams, p_cache,
                                     {"tokens": torch.from_numpy(nxt[:, None])})
    assert np.abs(_np(p_logits) - _np(r_logits)).max() <= 5e-2 * scale
    # the cast-once weights give the same numbers as casting per use
    cparams = pmodel.compute_params(pparams)
    assert cparams["head"].dtype == torch.bfloat16
    assert cparams["final_norm"].dtype == torch.float32
    a, _ = pmodel.prefill(pparams, {"tokens": torch.from_numpy(toks)}, 20)
    b, _ = pmodel.prefill(cparams, {"tokens": torch.from_numpy(toks)}, 20)
    assert torch.equal(a, b)


def test_layers_match_the_reference():
    from repro.models import layers as ref_layers
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 5, 3, 16)).astype(np.float32)
    g = rng.normal(size=(16,)).astype(np.float32)
    _close(rms_norm(torch.from_numpy(x), torch.from_numpy(g), 1e-6),
           ref_layers.rms_norm(jnp.asarray(x), jnp.asarray(g), 1e-6))
    pos = np.array([0, 3, 17, 900, 1023], np.int32)
    _close(apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e6),
           ref_layers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6))
    pos2 = np.stack([pos, pos[::-1]])
    _close(apply_rope(torch.from_numpy(x), torch.from_numpy(pos2), 1e4),
           ref_layers.apply_rope(jnp.asarray(x), jnp.asarray(pos2), 1e4))


@pytest.mark.parametrize("arch,named", [
    ("mixtral-8x7b", "MoE"), ("moonshot-v1-16b-a3b", "MoE"),
    ("recurrentgemma-9b", "rglru"), ("llama-3.2-vision-90b", "xattn"),
    ("musicgen-large", "embeddings")])
def test_unported_archs_raise_by_name(arch, named):
    """These families were refused by name (ROADMAP item 13b) until the
    port had them; each case now builds the family, checks that the
    feature once named is there, and runs a prefill and a decode step
    (tests/test_torch_lm_families.py holds them against the
    reference)."""
    cfg = reduced(get_config(arch), compute_dtype="float32")
    model = Transformer(cfg, device="cpu")
    params = model.init(0)
    rng = np.random.default_rng(0)
    if cfg.embed_input == "tokens":
        batch = {"tokens": torch.from_numpy(_tokens(0, 2, 6))}
        step = {"tokens": torch.zeros((2, 1), dtype=torch.long)}
    else:
        batch = {"embeds": torch.from_numpy(
            rng.normal(size=(2, 6, cfg.d_model)).astype(np.float32))}
        step = {"embeds": batch["embeds"][:, :1]}
    if cfg.encoder_len:
        batch["encoder"] = torch.from_numpy(rng.normal(
            size=(2, cfg.encoder_len, cfg.d_model)).astype(np.float32))
    with torch.no_grad():
        _, cache = model.prefill(params, batch, 10)
        logits, cache = model.decode_step(params, cache, step)
    assert logits.shape == (2, 1, cfg.vocab)
    assert torch.isfinite(logits).all()
    layers = params["periods"] + params["remainder"]
    caches = cache["periods"] + cache["remainder"]
    if named == "MoE":
        assert all(p["mlp"]["router"].shape[-1] == cfg.moe.n_experts
                   for p in layers)
    elif named == "rglru":
        assert any("lam" in p["mixer"] for p in layers)
        assert any(set(c) == {"h"} for c in caches)
    elif named == "xattn":
        assert any(c["k"].shape[-3] == cfg.encoder_len for c in caches)
    else:
        assert "embed" not in params


def test_int8_kv_cache_raises_and_no_card_default_raises():
    """The int8 KV cache, once refused, builds: its caches hold int8
    values and float32 scales (tests/test_torch_lm_families.py holds them
    against the reference).  Without a card the default device raises."""
    cfg = dataclasses.replace(reduced(get_config("qwen3-1.7b")),
                              kv_cache_dtype="int8")
    model = Transformer(cfg, device="cpu")
    params = model.init(0)
    with torch.no_grad():
        _, cache = model.prefill(params, {"tokens": torch.from_numpy(
            _tokens(1, 2, 6))}, 8)
    c = cache["periods"][0]
    assert c["k"].dtype == torch.int8 and c["k_scale"].dtype == torch.float32
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the rule under test is "
                    "what happens without one")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Transformer(reduced(get_config("qwen3-1.7b")))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        convert.lm_params_from_reference({"a": np.zeros(2)})


def test_configs_are_the_references():
    from repro.configs import ARCHS as REF_ARCHS
    from repro_torch.configs import ARCHS
    assert ARCHS == REF_ARCHS
    for arch in ARCHS:
        mine, ref = get_config(arch), ref_get_config(arch)
        for f in dataclasses.fields(ref):
            got, want = getattr(mine, f.name), getattr(ref, f.name)
            if f.name == "moe" and want is not None:
                got, want = dataclasses.asdict(got), dataclasses.asdict(want)
            assert got == want, (arch, f.name)

"""LM training of the port (``Transformer.train_loss``, remat, chunked
cross entropy, ``launch.steps.make_train_step``, the autograd Functions
around the flash attention and RWKV6 linear attention kernels) against the
reference's single-device ``jax.value_and_grad(model.train_loss)`` and
jitted ``make_train_step`` at reduced size on the CPU, float32 compute.

The same weights (``convert.lm_params_from_reference``) and the same numpy
tokens go to both.  Tolerances: 1e-5 (rtol = atol) for losses and
gradients, 1e-4 for parameters after three AdamW steps."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch.steps import make_train_step as ref_make_train_step
from repro.models import attention as ref_attention
from repro.models import rwkv as ref_rwkv
from repro.optim import AdamWConfig as RefAdamWConfig
from repro.optim import adamw_init as ref_adamw_init
from repro.optim import warmup_cosine as ref_warmup_cosine
from repro_torch.data import synthetic_lm_batch
from repro_torch.kernels.flash import flash_attention
from repro_torch.kernels.linattn import rwkv_linattn
from repro_torch.launch.steps import (_largest_divisor_leq, loss_and_grads,
                                      make_decode_step, make_prefill_step,
                                      make_train_step)
from repro_torch.models import attention, rwkv
from repro_torch.models.transformer import tree_map
from repro_torch.optim import AdamWConfig, adamw_init, warmup_cosine
from repro_torch.core.util import tree_leaves as leaves
from test_torch_common import lm_pair

LOSS_TOL = 1e-5
GRAD_TOL = 1e-5
PARAM_TOL = 1e-4
ARCHS = ["qwen3-1.7b", "rwkv6-3b"]
#: the other families (MoE, RG-LRU + LOCAL, XATTN, the embedding frontend)
#: and the overrides that make their reduced configs reach every path
FAMILY_ARCHS = ["mixtral-8x7b", "moonshot-v1-16b-a3b", "recurrentgemma-9b",
                "llama-3.2-vision-90b", "musicgen-large"]
FAMILY_OVERRIDES = {"recurrentgemma-9b": {"n_layers": 5}}


def _batch(seed, B=2, S=32, vocab=256):
    toks = np.random.default_rng(seed).integers(0, vocab, (B, S + 1)
                                                ).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _clone(params):
    return tree_map(lambda t: t.detach().clone(), params)


def _close_leaves(got, want, tol, what):
    gl, wl = leaves(got), jax.tree.leaves(want)
    assert len(gl) == len(wl)
    paths = [jax.tree_util.keystr(p)
             for p, _ in jax.tree_util.tree_flatten_with_path(want)[0]]
    for g, w, p in zip(gl, wl, paths):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   rtol=tol, atol=tol,
                                   err_msg=f"{what} {p}")


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("remat", ["nothing", "save_boundaries",
                                   "save_dots"])
@pytest.mark.parametrize("attn_impl", ["chunked", "full"])
@pytest.mark.parametrize("loss_chunk", [8, None])
def test_train_loss_and_grads_match_reference(arch, remat, attn_impl,
                                              loss_chunk):
    """Loss and the gradient of every leaf; loss_chunk 8 at S = 32 takes
    the chunked cross entropy, None the single pass."""
    rmodel, rparams, pmodel, pparams = lm_pair(
        arch, remat_policy=remat, attn_impl=attn_impl, loss_chunk=loss_chunk)
    batch = _batch(3)
    r_loss, r_grads = jax.jit(jax.value_and_grad(rmodel.train_loss))(
        rparams, {k: jnp.asarray(v) for k, v in batch.items()})
    params = _clone(pparams)
    loss, grads = loss_and_grads(pmodel, params, batch, accum_steps=1)
    np.testing.assert_allclose(float(loss), float(r_loss), rtol=LOSS_TOL,
                               atol=LOSS_TOL)
    _close_leaves(grads, r_grads, GRAD_TOL, "grad")
    assert all(float(g.abs().max()) > 0 for g in leaves(grads))


def test_train_loss_without_grad_and_logits_fn():
    """No-grad forward (no checkpoint) equals the graded one; logits_fn
    against the reference's."""
    rmodel, rparams, pmodel, pparams = lm_pair("qwen3-1.7b", loss_chunk=8)
    batch = _batch(4)
    with torch.no_grad():
        loss = pmodel.train_loss(pparams, batch)
        logits = pmodel.logits_fn(pparams, batch)
    r_loss = rmodel.train_loss(rparams,
                               {k: jnp.asarray(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(loss), float(r_loss), rtol=LOSS_TOL,
                               atol=LOSS_TOL)
    r_logits = rmodel.logits_fn(rparams, {"tokens": jnp.asarray(
        batch["tokens"])})
    np.testing.assert_allclose(logits.numpy(), np.asarray(r_logits),
                               rtol=LOSS_TOL, atol=LOSS_TOL)


@pytest.mark.parametrize("arch", ARCHS + FAMILY_ARCHS)
@pytest.mark.parametrize("accum", [1, 4])
def test_train_step_trajectory_matches_reference(arch, accum):
    """Three steps of make_train_step (warmup_cosine(3e-3, 2, 10), batch
    4, seq 32, the training CLI's synthetic batches -- tokens, or frame
    embeddings, and stub encoder states): losses and grad norms at 1e-5,
    every parameter and AdamW moment after the third step at 1e-4.

    The other families run with AdamW's eps at 1e-6 in both packages:
    at the default 1e-8, an entry whose first gradient is at float32
    rounding level (Vision's ``w_down`` has one at -8.4e-9 against a
    largest entry of 3.4e-2, -6.7e-9 in the port) moves by
    g / (|g| + eps) of the learning rate, a fraction that rounding
    decides (2.1e-4 apart after the first step)."""
    rmodel, rparams, pmodel, pparams = lm_pair(
        arch, **FAMILY_OVERRIDES.get(arch, {}))
    eps = 1e-6 if arch in FAMILY_ARCHS else 1e-8
    r_step = jax.jit(ref_make_train_step(
        rmodel, RefAdamWConfig(lr=ref_warmup_cosine(3e-3, 2, 10), eps=eps),
        accum))
    step = make_train_step(pmodel, AdamWConfig(
        lr=warmup_cosine(3e-3, 2, 10), eps=eps), accum)
    rp, ro = rparams, ref_adamw_init(rparams)
    params = _clone(pparams)
    opt = adamw_init(params)
    for s in range(3):
        b = synthetic_lm_batch(pmodel.cfg, s, batch=4, seq=32)
        rp, ro, rm = r_step(rp, ro, {k: jnp.asarray(v) for k, v in b.items()})
        params, opt, m = step(params, opt, b)
        np.testing.assert_allclose(float(m["loss"]), float(rm["loss"]),
                                   rtol=LOSS_TOL, atol=LOSS_TOL)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(rm["grad_norm"]), rtol=GRAD_TOL,
                                   atol=GRAD_TOL)
    _close_leaves(params, rp, PARAM_TOL, "param")
    _close_leaves(opt["mu"], ro["mu"], PARAM_TOL, "mu")
    _close_leaves(opt["nu"], ro["nu"], PARAM_TOL, "nu")
    assert int(opt["count"]) == int(ro["count"]) == 3
    assert all(p.grad is None for p in leaves(params))


def test_largest_divisor_and_microbatch_count():
    assert _largest_divisor_leq(8, 8) == 8
    assert _largest_divisor_leq(6, 4) == 3
    assert _largest_divisor_leq(7, 4) == 1
    assert _largest_divisor_leq(4, 0) == 1
    # B = 6 at train_accum 4 runs 3 microbatches of 2: the same loss as
    # one pass (the mean of equal-sized means)
    _, _, pmodel, pparams = lm_pair("qwen3-1.7b")
    batch = _batch(5, B=6, S=16)
    l3, _ = loss_and_grads(pmodel, _clone(pparams), batch, accum_steps=4)
    l1, _ = loss_and_grads(pmodel, _clone(pparams), batch, accum_steps=1)
    np.testing.assert_allclose(float(l3), float(l1), rtol=1e-6)


def test_prefill_and_decode_steps():
    _, _, pmodel, pparams = lm_pair("qwen3-1.7b")
    toks = torch.from_numpy(_batch(6)["tokens"])
    logits, cache = make_prefill_step(pmodel, 40)(pparams, {"tokens": toks})
    want, _ = pmodel.prefill(pparams, {"tokens": toks}, 40)
    assert logits.grad_fn is None
    torch.testing.assert_close(logits, want, rtol=0, atol=0)
    nxt = torch.argmax(logits[:, -1], -1)[:, None]
    logits2, cache = make_decode_step(pmodel)(pparams, cache,
                                              {"tokens": nxt})
    assert logits2.shape == (2, 1, 256) and cache["pos"] == 33


# ---------------------------------------------------------------------------
# the kernels' autograd Functions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("window", [None, 5])
def test_flash_function_grads_match_reference(window):
    """chunked_attention (the flash Function on the CPU: the plain forward,
    autograd through the plain version) against jax.grad of the
    reference's chunked_attention; GQA 4 / 2 heads, S = 32, D = 16."""
    rng = np.random.default_rng(7)
    q, k, v = (rng.normal(size=(2, 32, h, 16)).astype(np.float32)
               for h in (4, 2, 2))
    dout = rng.normal(size=(2, 32, 4, 16)).astype(np.float32)

    def ref(q_, k_, v_):
        o = ref_attention.chunked_attention(q_, k_, v_, causal=True,
                                            window=window, chunk_q=8,
                                            chunk_k=8)
        return jnp.sum(o * dout)
    r_val = ref(q, k, v)
    r_grads = jax.grad(ref, argnums=(0, 1, 2))(q, k, v)
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    before = flash_attention.plain_backwards
    launches = flash_attention.launches
    out = attention.chunked_attention(*ts, causal=True, window=window)
    assert out.grad_fn is not None
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    val = torch.sum(out * torch.from_numpy(dout))
    val.backward()
    assert flash_attention.plain_backwards == before + 1
    assert flash_attention.launches == launches      # no kernel on the CPU
    np.testing.assert_allclose(val.item(), float(r_val), rtol=1e-5,
                               atol=1e-5)
    for t, g in zip(ts, r_grads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g),
                                   rtol=1e-5, atol=1e-5)


def test_flash_function_only_where_a_grad_is_wanted():
    q = torch.randn(1, 8, 2, 16)
    k = torch.randn(1, 8, 1, 16)
    assert flash_attention(q, k, k).grad_fn is None
    with torch.no_grad():
        assert flash_attention(q.requires_grad_(True), k, k).grad_fn is None
    # only k wants a gradient: q and v get None, k its gradient
    kg = k.clone().requires_grad_(True)
    out = flash_attention(q.detach(), kg, k)
    out.sum().backward()
    assert kg.grad is not None and kg.grad.abs().max() > 0


def test_rwkv_function_grads_match_reference():
    """rwkv_scan from a zero state (the linear-attention Function on the
    CPU) against jax.grad of the reference's rwkv_scan: gradients of r, k,
    v, logw and the per-head u."""
    rng = np.random.default_rng(8)
    B, S, H, D = 2, 24, 3, 16
    r, k, v = (rng.normal(size=(B, S, H, D)).astype(np.float32)
               for _ in range(3))
    logw = -np.exp(rng.uniform(-3, 1, size=(B, S, H, D))).astype(np.float32)
    u = rng.normal(size=(H, D)).astype(np.float32) * 0.5
    dout = rng.normal(size=(B, S, H, D)).astype(np.float32)

    def ref(*a):
        o, _ = ref_rwkv.rwkv_scan(*a)
        return jnp.sum(o * dout)
    r_val = ref(r, k, v, logw, u)
    r_grads = jax.grad(ref, argnums=(0, 1, 2, 3, 4))(r, k, v, logw, u)
    ts = [torch.from_numpy(a).requires_grad_(True)
          for a in (r, k, v, logw, u)]
    before = rwkv_linattn.plain_backwards
    out, state = rwkv.rwkv_scan(*ts)
    assert out.grad_fn is not None
    val = torch.sum(out * torch.from_numpy(dout))
    val.backward()
    assert rwkv_linattn.plain_backwards == before + 1
    np.testing.assert_allclose(val.item(), float(r_val), rtol=1e-5,
                               atol=1e-5)
    for name, t, g in zip("r k v logw u".split(), ts, r_grads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g),
                                   rtol=1e-5, atol=1e-5, err_msg=name)


def test_rwkv_function_state_gradient():
    """A loss on the final state too: its gradient flows back through the
    recurrence (the reference's scan carries it)."""
    rng = np.random.default_rng(9)
    BH, S, D = 4, 10, 16
    a = [rng.normal(size=(BH, S, D)).astype(np.float32) for _ in range(3)]
    lw = -np.exp(rng.uniform(-3, 0, size=(BH, S, D))).astype(np.float32)
    u = rng.normal(size=(D,)).astype(np.float32)
    ts = [torch.from_numpy(x).requires_grad_(True) for x in (*a, lw, u)]
    out, state = rwkv_linattn(*ts)
    (out.sum() + state.square().sum()).backward()

    def ref(r_, k_, v_, w_, u_):
        o, st = ref_rwkv.rwkv_scan(r_[:, :, None], k_[:, :, None],
                                   v_[:, :, None], w_[:, :, None],
                                   u_[None])
        return jnp.sum(o) + jnp.sum(st * st)
    r_grads = jax.grad(ref, argnums=(0, 1, 2, 3, 4))(*a, lw, u)
    for t, g in zip(ts, r_grads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g),
                                   rtol=1e-5, atol=1e-5)

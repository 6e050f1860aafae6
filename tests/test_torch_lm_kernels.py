"""Kernels B5 (flash attention) and B6 (chunked RWKV6 linear attention) of
the port, through their wrappers on the CPU (= their plain versions),
against the reference: ``flash_attention(backend="ref" | "pallas")`` and
``rwkv_linattn_ref`` / ``rwkv_linattn_pallas`` (Pallas in interpret mode,
as ``tests/test_kernels.py`` runs it), over that file's shape sweep and
tolerances, plus ragged lengths and per-head ``u``.  The same numpy inputs
go to both packages.  The CUDA kernels themselves are held against these
plain versions on the card by ``chip_smoke.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash import flash_attention as ref_flash
from repro.kernels.linattn import rwkv_linattn_pallas
from repro.kernels.linattn import rwkv_linattn_ref as ref_linattn
from repro.models import attention as ref_attention
from repro.models.rwkv import rwkv_scan as ref_rwkv_scan
from repro_torch.kernels.flash import flash_attention, mha_ref
from repro_torch.kernels.linattn import rwkv_linattn, rwkv_linattn_ref
from repro_torch.models import attention
from repro_torch.models.rwkv import rwkv_scan

FLASH_SWEEP = [(2, 128, 4, 2, 32), (1, 256, 2, 2, 64), (2, 64, 8, 1, 16)]
LINATTN_SWEEP = [(2, 64, 16, 16), (3, 128, 32, 32), (1, 256, 64, 64),
                 (2, 96, 16, 32)]
#: tests/test_kernels.py's tolerances: f32 2e-5, bf16 3e-2 (rtol = atol)
FLASH_TOL = {"float32": 2e-5, "bfloat16": 3e-2}


def _qkv(seed, B, S, H, KV, D, Skv=None):
    rng = np.random.default_rng(seed)
    Skv = S if Skv is None else Skv
    return (rng.normal(size=(B, S, H, D)).astype(np.float32),
            rng.normal(size=(B, Skv, KV, D)).astype(np.float32),
            rng.normal(size=(B, Skv, KV, D)).astype(np.float32))


def _both(arrs, dtype):
    """numpy float32 -> (jax arrays, torch tensors) of ``dtype``, rounded
    the same way (round to nearest even)."""
    jx = [jnp.asarray(a, getattr(jnp, dtype)) for a in arrs]
    tt = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs]
    return jx, tt


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("B,S,H,KV,D", FLASH_SWEEP)
@pytest.mark.parametrize("window", [None, 48])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_plain_matches_reference_ref_and_pallas(B, S, H, KV, D,
                                                      window, dtype):
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(S + D, B, S, H, KV, D), dtype)
    got = _np(flash_attention(tq, tk, tv, causal=True, window=window))
    tol = FLASH_TOL[dtype]
    for backend, extra in (("ref", {}),
                           ("pallas", dict(block_q=64, block_k=64))):
        want = _np(ref_flash(jq, jk, jv, causal=True, window=window,
                             backend=backend, **extra))
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol,
                                   err_msg=backend)


@pytest.mark.parametrize("B,S,H,KV,D,window", [
    (1, 80, 4, 2, 32, None), (2, 200, 4, 1, 16, 48),
    (1, 80, 2, 1, 128, None), (1, 33, 2, 2, 64, 7)])
def test_flash_plain_ragged_lengths_and_head_dim_128(B, S, H, KV, D,
                                                     window):
    """S not a multiple of any tile (the serving engine's buckets are
    multiples of the page size): against the reference's ``mha_ref``
    (the Pallas kernel asserts divisibility, so it has no say here)."""
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(S, B, S, H, KV, D), "float32")
    got = _np(flash_attention(tq, tk, tv, causal=True, window=window))
    want = _np(ref_flash(jq, jk, jv, causal=True, window=window,
                         backend="ref"))
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


def test_flash_plain_non_causal_and_custom_scale():
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(5, 1, 24, 4, 2, 16, Skv=40),
                                       "float32")
    got = _np(flash_attention(tq, tk, tv, causal=False, scale=0.3))
    want = _np(ref_attention.full_attention(jq, jk, jv, causal=False,
                                            scale=0.3))
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


def test_mha_ref_is_the_reference_oracle():
    rng = np.random.default_rng(3)
    q, k, v = (rng.normal(size=(3, 40, 16)).astype(np.float32)
               for _ in range(3))
    from repro.kernels.flash import mha_ref as jax_mha_ref
    for window in (None, 9):
        got = mha_ref(*map(torch.from_numpy, (q, k, v)), window=window)
        want = jax_mha_ref(*map(jnp.asarray, (q, k, v)), window=window)
        np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("S,dtype,tol", [
    (80, "float32", 2e-5),
    # the reference's pure-JAX chunked_attention scales q in bfloat16 and
    # rounds p to bfloat16 before p @ v; the port follows the Pallas
    # kernel (float32 inside), so in bfloat16 they agree to bf16 rounding
    (64, "bfloat16", 3e-2)])
def test_chunked_attention_matches_the_models_attention(S, dtype, tol):
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(11, 2, S, 4, 2, 16), dtype)
    got = _np(attention.chunked_attention(tq, tk, tv, causal=True))
    want = _np(ref_attention.chunked_attention(jq, jk, jv, causal=True))
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5),
                                       ("bfloat16", 2e-2)])
@pytest.mark.parametrize("window", [None, 5])
def test_full_and_decode_attention_match_the_reference(dtype, tol, window):
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(13, 2, 12, 4, 2, 16), dtype)
    got = _np(attention.full_attention(tq, tk, tv, window=window))
    want = _np(ref_attention.full_attention(jq, jk, jv, window=window))
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
    pos = np.array([3, 11], np.int32)
    got = _np(attention.decode_attention(tq[:, :1], tk, tv,
                                         torch.from_numpy(pos),
                                         window=window))
    want = _np(ref_attention.decode_attention(jq[:, :1], jk, jv,
                                              jnp.asarray(pos),
                                              window=window))
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
    got = _np(attention.decode_attention(tq[:, :1], tk, tv, 7))
    want = _np(ref_attention.decode_attention(jq[:, :1], jk, jv,
                                              jnp.asarray(7)))
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


def test_flash_wrapper_checks_its_arguments():
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 1, 16, 4, 2, 16))
    with pytest.raises(ValueError, match="multiple of"):
        flash_attention(q, k[:, :, :1].repeat(1, 1, 3, 1).contiguous(),
                        v[:, :, :1].repeat(1, 1, 3, 1).contiguous())
    with pytest.raises(TypeError, match="dtype"):
        flash_attention(q, k.double(), v)
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2), k,
                        v)
    with pytest.raises(ValueError, match="window"):
        flash_attention(q, k, v, window=0)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        flash_attention(q.double(), k.double(), v.double())
    before = flash_attention.launches
    flash_attention(q, k, v)
    assert flash_attention.launches == before      # CPU: no launch


# ---------------------------------------------------------------------------
# B6: chunked RWKV6 linear attention
# ---------------------------------------------------------------------------

def _linattn_inputs(seed, BH, S, D, heads=None):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.normal(size=(BH, S, D)).astype(np.float32)
               for _ in range(3))
    logw = -np.exp(rng.normal(size=(BH, S, D))).astype(np.float32)
    u = rng.normal(size=(D,) if heads is None else (heads, D)
                   ).astype(np.float32)
    return r, k, v, logw, u


@pytest.mark.parametrize("BH,S,D,chunk", LINATTN_SWEEP)
def test_linattn_plain_matches_pallas_and_ref(BH, S, D, chunk):
    arrs = _linattn_inputs(BH * S + D, BH, S, D)
    o, s = rwkv_linattn(*map(torch.from_numpy, arrs), chunk=chunk)
    o_p, s_p = rwkv_linattn_pallas(*map(jnp.asarray, arrs), chunk=chunk)
    np.testing.assert_allclose(_np(o), _np(o_p), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(_np(s), _np(s_p), rtol=2e-4, atol=2e-4)
    o_r, s_r = ref_linattn(*map(jnp.asarray, arrs))
    np.testing.assert_allclose(_np(o), _np(o_r), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_np(s), _np(s_r), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("BH,S,D", [(2, 100, 16), (1, 7, 32)])
def test_linattn_plain_ragged_length_matches_ref(BH, S, D):
    arrs = _linattn_inputs(S, BH, S, D)
    o, s = rwkv_linattn(*map(torch.from_numpy, arrs))
    o_r, s_r = ref_linattn(*map(jnp.asarray, arrs))
    np.testing.assert_allclose(_np(o), _np(o_r), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_np(s), _np(s_r), rtol=1e-5, atol=1e-5)


def test_linattn_per_head_u_matches_the_models_rwkv_scan():
    """(H, D) u, rows ordered b * H + h, against the reference model's
    ``rwkv_scan`` in its (B, S, H, D) layout -- through the port's
    ``rwkv_scan``, which hands prefill to the kernel wrapper."""
    B, S, H, D = 2, 40, 3, 16
    rng = np.random.default_rng(21)
    r, k, v = (rng.normal(size=(B, S, H, D)).astype(np.float32)
               for _ in range(3))
    logw = -np.exp(rng.normal(size=(B, S, H, D))).astype(np.float32)
    u = rng.normal(size=(H, D)).astype(np.float32)
    o, s = rwkv_scan(*map(torch.from_numpy, (r, k, v, logw, u)))
    o_r, s_r = ref_rwkv_scan(*map(jnp.asarray, (r, k, v, logw, u)))
    np.testing.assert_allclose(_np(o), _np(o_r), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_np(s), _np(s_r), rtol=1e-5, atol=1e-5)
    # a carried state (decode) takes the plain recurrence
    state0 = rng.normal(size=(B, H, D, D)).astype(np.float32)
    o, s = rwkv_scan(*map(torch.from_numpy, (r[:, :1], k[:, :1], v[:, :1],
                                             logw[:, :1], u, state0)))
    o_r, s_r = ref_rwkv_scan(*map(jnp.asarray, (r[:, :1], k[:, :1],
                                                v[:, :1], logw[:, :1], u,
                                                state0)))
    np.testing.assert_allclose(_np(o), _np(o_r), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_np(s), _np(s_r), rtol=1e-5, atol=1e-5)
    # the (H, D) u of the wrapper is the (D,) u of each head
    rows = [torch.from_numpy(a.transpose(0, 2, 1, 3).reshape(B * H, S, D)
                             .copy()) for a in (r, k, v, logw)]
    o_h, _ = rwkv_linattn(*rows, torch.from_numpy(u))
    for h in range(H):
        sel = [a[h::H].contiguous() for a in rows]
        o_1, _ = rwkv_linattn_ref(*sel, torch.from_numpy(u[h]))
        assert torch.equal(o_h[h::H], o_1)


def test_linattn_extreme_decay_stays_finite():
    """logw = -50 (decay ~ e^-50 a step), as in tests/test_kernels.py."""
    BH, S, D = 1, 64, 16
    r = torch.full((BH, S, D), 0.5)
    k = torch.full((BH, S, D), 0.5)
    v = torch.ones((BH, S, D))
    logw = torch.full((BH, S, D), -50.0)
    o, s = rwkv_linattn(r, k, v, logw, torch.ones(D), chunk=16)
    assert torch.isfinite(o).all() and torch.isfinite(s).all()
    o_p, s_p = rwkv_linattn_pallas(*(jnp.asarray(t.numpy())
                                     for t in (r, k, v, logw)),
                                   jnp.ones(D), chunk=16)
    np.testing.assert_allclose(_np(o), _np(o_p), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(_np(s), _np(s_p), rtol=2e-4, atol=2e-4)


def test_linattn_wrapper_checks_its_arguments():
    r, k, v, logw, u = map(torch.from_numpy,
                           _linattn_inputs(0, 4, 8, 16, heads=2))
    with pytest.raises(ValueError, match="multiple of 3 heads"):
        rwkv_linattn(r, k, v, logw, torch.zeros(3, 16))
    with pytest.raises(ValueError, match="chunk"):
        rwkv_linattn(r, k, v, logw, u, chunk=65)
    with pytest.raises(ValueError, match="shape"):
        rwkv_linattn(r, k[:, :4].contiguous(), v, logw, u)
    before = rwkv_linattn.launches
    out, state = rwkv_linattn(r.double(), k, v, logw, u)
    assert out.dtype == torch.float64 and state.dtype == torch.float32
    assert rwkv_linattn.launches == before          # CPU: no launch

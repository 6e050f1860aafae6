"""The backward of B5 (flash attention) and B6 (RWKV6 linear attention) on
the CPU: the plain backward of each (``flash_attention_backward_plain``,
``rwkv_linattn_backward_plain``) against ``jax.grad`` of the reference's
``chunked_attention`` / ``rwkv_scan`` at 1e-5 in float32; the backward
kernels' arithmetic (``csrc/flash_attention_bwd.cu``,
``csrc/rwkv_linattn_bwd.cu``: their tiles, skipped tiles, log-sum-exp and
delta, state checkpoints and chunk recompute) emulated loop for loop in
float64 against the plain backward in float64; the wrappers' CPU path
(the plain backward, counted) and meta path (the kernels' work counted).
The kernels themselves run on the card only: ``test_torch_backward_card.py``
and ``chip_smoke.py``.  Inputs from a numpy seed, handed to both
packages."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as ref_attention
from repro.models import rwkv as ref_rwkv
from repro_torch.kernels import _launch
from repro_torch.kernels.flash import (flash_attention,
                                       flash_attention_backward,
                                       flash_attention_backward_plain)
from repro_torch.kernels.flash import ops as flash_ops
from repro_torch.kernels.linattn import (rwkv_linattn, rwkv_linattn_backward,
                                         rwkv_linattn_backward_plain)
from repro_torch.kernels.linattn import ops as linattn_ops
import test_torch_common  # noqa: F401  (one torch thread a process)

TOL = 1e-5
#: emulation against the plain backward, both in float64: the same sums in
#: another order
EMU_TOL = 1e-10

# (B, S, Skv, H, KV, D, causal, window): GQA 1 / 2 / 4, causal, a window
# shorter than S, non-causal with Skv != S (both ways), head dims 16 / 32
# / 64
FLASH_CASES = {
    "g1_causal_d16": (2, 32, 32, 2, 2, 16, True, None),
    "g2_window_d32": (1, 40, 40, 4, 2, 32, True, 5),
    "g4_causal_d64": (1, 24, 24, 4, 1, 64, True, None),
    "g2_xattn_d32": (2, 16, 40, 4, 2, 32, False, None),
    "g4_xattn_d16": (1, 32, 8, 4, 1, 16, False, None),
    "g1_noncausal_window_d64": (1, 24, 24, 2, 2, 64, False, 6),
    "g4_window_d16": (1, 48, 48, 8, 2, 16, True, 7),
}


def flash_arrays(seed, B, S, Skv, H, KV, D):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, S, H, D)).astype(np.float32)
    k, v = (rng.normal(size=(B, Skv, KV, D)).astype(np.float32)
            for _ in range(2))
    dout = rng.normal(size=(B, S, H, D)).astype(np.float32)
    return q, k, v, dout


@pytest.mark.parametrize("case", list(FLASH_CASES), ids=list(FLASH_CASES))
def test_flash_backward_plain_matches_jax_grad(case):
    """dq, dk, dv of the plain backward against jax.grad of the reference's
    chunked_attention (chunks of 8) for the same output gradient."""
    B, S, Skv, H, KV, D, causal, window = FLASH_CASES[case]
    q, k, v, dout = flash_arrays(3, B, S, Skv, H, KV, D)

    def ref(q_, k_, v_):
        o = ref_attention.chunked_attention(q_, k_, v_, causal=causal,
                                            window=window, chunk_q=8,
                                            chunk_k=8)
        return jnp.sum(o * dout)
    want = jax.grad(ref, argnums=(0, 1, 2))(q, k, v)
    got = flash_attention_backward_plain(
        *(torch.from_numpy(a) for a in (q, k, v, dout)), causal=causal,
        window=window)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=TOL,
                                   atol=TOL, err_msg=name)


def emulate_flash_backward(q, k, v, dout, *, causal, window, scale, tile):
    """The two kernels of csrc/flash_attention_bwd.cu, loop for loop, in
    float64: the dq kernel per query tile (a pass keeping each row's
    running max m, l = sum exp(s - m) and u = sum exp(s - m) dp, rescaled
    as m moves; lse = m + log l, delta = u / l; a pass for dq), then the
    dk / dv kernel per key tile summing over the G query heads and the
    query tiles that see it -- with both kernels' tile-skipping
    conditions."""
    B, S, H, D = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    G = H // KV
    neg = -1e30
    q, k, v, dout = (t.double() for t in (q, k, v, dout))
    dq = torch.zeros_like(q)
    dk, dv = torch.zeros_like(k), torch.zeros_like(v)
    lse = torch.zeros(B, H, S, dtype=torch.float64)
    delta = torch.zeros(B, H, S, dtype=torch.float64)

    def rows(x, b, h, s0, n):
        """A tile of ``tile`` rows of x[b, :, h] from s0, 0 past n."""
        t = torch.zeros(tile, D, dtype=torch.float64)
        m = min(tile, n - s0)
        t[:m] = x[b, s0:s0 + m, h]
        return t

    def kept(q0, k0):
        qr = torch.arange(q0, q0 + tile)[:, None]
        kc = torch.arange(k0, k0 + tile)[None, :]
        ok = (qr < S) & (kc < Skv)
        if causal:
            ok &= qr >= kc
        if window is not None:
            ok &= qr - kc < window
        return ok

    nk = -(-Skv // tile)
    for b in range(B):
        for h in range(H):
            kvh = h // G
            for q0 in range(0, S, tile):
                qt = rows(q, b, h, q0, S) * scale
                dt = rows(dout, b, h, q0, S)
                kj_end = min(nk, (q0 + tile - 1) // tile + 1) if causal \
                    else nk
                tiles = [kj * tile for kj in range(kj_end)
                         if window is None
                         or kj * tile + tile - 1 > q0 - window]
                m = torch.full((tile,), neg, dtype=torch.float64)
                l_ = torch.zeros(tile, dtype=torch.float64)
                u = torch.zeros(tile, dtype=torch.float64)
                for k0 in tiles:
                    ok = kept(q0, k0)
                    sc = torch.where(ok, qt @ rows(k, b, kvh, k0, Skv).T,
                                     torch.tensor(neg, dtype=torch.float64))
                    dp = dt @ rows(v, b, kvh, k0, Skv).T
                    m_new = torch.maximum(m, sc.max(1).values)
                    e = torch.where(ok, torch.exp(sc - m_new[:, None]), 0.0)
                    corr = torch.exp(m - m_new)
                    l_ = l_ * corr + e.sum(1)
                    u = u * corr + (e * dp).sum(1)
                    m = m_new
                row_lse = m + torch.log(torch.clamp(l_, min=1e-30))
                dl = torch.where(l_ > 0, u / torch.where(l_ > 0, l_, 1.0),
                                 0.0)
                acc = torch.zeros(tile, D, dtype=torch.float64)
                for k0 in tiles:
                    ok = kept(q0, k0)
                    kt = rows(k, b, kvh, k0, Skv)
                    p = torch.where(ok, torch.exp(qt @ kt.T
                                                  - row_lse[:, None]), 0.0)
                    dp = dt @ rows(v, b, kvh, k0, Skv).T
                    acc += (p * (dp - dl[:, None])) @ kt
                n = min(tile, S - q0)
                dq[b, q0:q0 + n, h] = acc[:n] * scale
                lse[b, h, q0:q0 + n] = row_lse[:n]
                delta[b, h, q0:q0 + n] = dl[:n]
    for b in range(B):
        for kvh in range(KV):
            for k0 in range(0, Skv, tile):
                kt, vt = rows(k, b, kvh, k0, Skv), rows(v, b, kvh, k0, Skv)
                adk = torch.zeros(tile, D, dtype=torch.float64)
                adv = torch.zeros(tile, D, dtype=torch.float64)
                for h in range(kvh * G, (kvh + 1) * G):
                    for q0 in range(0, S, tile):
                        if causal and q0 + tile - 1 < k0:
                            continue
                        if window is not None and \
                                q0 - (k0 + tile - 1) >= window:
                            continue
                        qt = rows(q, b, h, q0, S) * scale
                        dt = rows(dout, b, h, q0, S)
                        lt = torch.zeros(tile, dtype=torch.float64)
                        dl = torch.zeros(tile, dtype=torch.float64)
                        n = min(tile, S - q0)
                        lt[:n] = lse[b, h, q0:q0 + n]
                        dl[:n] = delta[b, h, q0:q0 + n]
                        p = torch.where(kept(q0, k0), torch.exp(
                            qt @ kt.T - lt[:, None]), 0.0)
                        ds = p * (dt @ vt.T - dl[:, None])
                        adv += p.T @ dt
                        adk += ds.T @ qt
                n = min(tile, Skv - k0)
                dk[b, k0:k0 + n, kvh] = adk[:n]
                dv[b, k0:k0 + n, kvh] = adv[:n]
    return dq, dk, dv


@pytest.mark.parametrize("tile", [8, 16])
@pytest.mark.parametrize("case", [
    (1, 37, 37, 4, 2, 16, True, None), (2, 30, 30, 4, 1, 16, True, 9),
    (1, 20, 45, 2, 2, 16, False, None), (1, 44, 44, 4, 4, 16, False, 5),
    (1, 1, 1, 2, 1, 16, True, None), (1, 1, 13, 4, 2, 16, False, None),
    (1, 30, 6, 2, 1, 16, True, 3)],
    ids=["ragged", "window", "xattn", "noncausal_window", "s1", "s1_xattn",
         "keyless_rows"])
def test_flash_backward_kernel_arithmetic(case, tile):
    """The kernels' loops (emulated) against the plain backward, both in
    float64, at tiles that leave a ragged last tile: rows past S, keys past
    Skv, skipped tiles, S = 1, and query rows with no unmasked key (window
    3, S 30 > Skv + 2), whose gradients are 0."""
    B, S, Skv, H, KV, D, causal, window = case
    q, k, v, dout = (torch.from_numpy(a).double()
                     for a in flash_arrays(5, B, S, Skv, H, KV, D))
    kw = dict(causal=causal, window=window)
    o = flash_ops.flash_attention_plain(q, k, v, **kw)
    got = emulate_flash_backward(q, k, v, dout, scale=D ** -0.5, tile=tile,
                                 **kw)
    want = flash_attention_backward_plain(q, k, v, dout, **kw)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert w.dtype == torch.float64
        torch.testing.assert_close(g, w, rtol=EMU_TOL, atol=EMU_TOL,
                                   msg=name)
    if window is not None and S > Skv + window - 1:
        keyless = slice(Skv + window - 1, S)
        assert float(want[0][:, keyless].abs().max()) == 0.0
        assert float(o[:, keyless].abs().max()) == 0.0


def test_flash_function_backward_on_the_cpu_is_the_counted_plain():
    """The Function's backward on the CPU is the plain backward: counted in
    plain_backwards, no kernel launch, its gradients those of
    flash_attention_backward_plain bitwise."""
    q, k, v, dout = (torch.from_numpy(a) for a in
                     flash_arrays(6, 1, 24, 24, 4, 2, 16))
    ins = [t.clone().requires_grad_(True) for t in (q, k, v)]
    before = flash_attention.plain_backwards
    launched = flash_attention_backward.launches
    out = flash_attention(*ins, window=7)
    got = torch.autograd.grad(out, ins, dout)
    assert flash_attention.plain_backwards == before + 1
    assert flash_attention_backward.launches == launched
    want = flash_attention_backward_plain(q, k, v, dout, window=7)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_flash_backward_meta_counts_the_kernels_work():
    """On the meta device the backward gives the gradients' shapes and
    counts BACKWARD_FLOPS (18) x B H D per kept (query, key) pair, and q,
    k, v, dout and the three gradients once each."""
    B, S, H, KV, D, window = 2, 100, 8, 2, 64, 30
    q, dout = (torch.empty(B, S, H, D, dtype=torch.bfloat16, device="meta")
               for _ in range(2))
    k, v = (torch.empty(B, S, KV, D, dtype=torch.bfloat16, device="meta")
            for _ in range(2))
    _launch.META_WORK.update(flops=0.0, bytes=0.0)
    grads = flash_attention_backward(q, k, v, dout, window=window)
    assert [tuple(g.shape) for g in grads] == [(B, S, H, D), (B, S, KV, D),
                                               (B, S, KV, D)]
    assert all(g.device.type == "meta" for g in grads)
    pairs = flash_ops.attention_pairs(S, S, True, window)
    assert _launch.META_WORK["flops"] == 18 * B * H * D * pairs
    assert _launch.META_WORK["bytes"] == 2 * D * (3 * B * S * H
                                                  + 4 * B * S * KV)
    # the Function's backward on meta tensors takes the same branch
    ins = [t.requires_grad_(True) for t in (torch.empty_like(q),
                                             torch.empty_like(k),
                                             torch.empty_like(v))]
    _launch.META_WORK.update(flops=0.0, bytes=0.0)
    o = flash_attention(*ins, window=window)
    fwd = _launch.META_WORK["flops"]
    g = torch.autograd.grad(o, ins, torch.empty_like(o))
    assert [t.shape for t in g] == [t.shape for t in ins]
    assert _launch.META_WORK["flops"] - fwd == 18 * B * H * D * pairs


# ---------------------------------------------------------------------------
# B6
# ---------------------------------------------------------------------------

def rwkv_arrays(seed, B, S, H, D, shared_u=False):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.normal(size=(B, S, H, D)).astype(np.float32)
               for _ in range(3))
    logw = -np.exp(rng.uniform(-3, 1, size=(B, S, H, D))).astype(np.float32)
    u = (rng.normal(size=(D,) if shared_u else (H, D)) * 0.5
         ).astype(np.float32)
    dout = rng.normal(size=(B, S, H, D)).astype(np.float32)
    dstate = rng.normal(size=(B, H, D, D)).astype(np.float32)
    return r, k, v, logw, u, dout, dstate


def rows_of(a):
    """(B, S, H, D) -> (B H, S, D), rows ordered b * H + h."""
    B, S, H, D = a.shape
    return torch.from_numpy(np.ascontiguousarray(
        a.transpose(0, 2, 1, 3).reshape(B * H, S, D)))


def bshd(t, B, H):
    """(B H, S, D) -> (B, S, H, D) numpy."""
    BH, S, D = t.shape
    return t.reshape(B, H, S, D).transpose(1, 2).numpy()


@pytest.mark.parametrize("shared_u", [False, True], ids=["u_per_head",
                                                         "u_shared"])
@pytest.mark.parametrize("loss", ["out_and_state", "out", "state"])
def test_rwkv_backward_plain_matches_jax_grad(shared_u, loss):
    """dr, dk, dv, dlogw, du of the plain backward against jax.grad of the
    reference's rwkv_scan (u (H, D), or (D,) broadcast over the heads) for
    a loss on the output, the final state, or both; S = 70."""
    B, S, H, D = 2, 70, 3, 16
    r, k, v, logw, u, dout, dstate = rwkv_arrays(11, B, S, H, D, shared_u)
    use_out, use_state = loss != "state", loss != "out"

    def ref(r_, k_, v_, lw_, u_):
        uh = jnp.broadcast_to(u_, (H, D)) if shared_u else u_
        o, st = ref_rwkv.rwkv_scan(r_, k_, v_, lw_, uh)
        return (jnp.sum(o * dout) if use_out else 0.0) + (
            jnp.sum(st * dstate) if use_state else 0.0)
    want = jax.grad(ref, argnums=(0, 1, 2, 3, 4))(r, k, v, logw, u)
    got = rwkv_linattn_backward_plain(
        *(rows_of(a) for a in (r, k, v, logw)), torch.from_numpy(u),
        rows_of(dout) if use_out else None,
        torch.from_numpy(dstate.reshape(B * H, D, D)) if use_state
        else None)
    for name, g, w in zip(("dr", "dk", "dv", "dlogw"), got, want):
        np.testing.assert_allclose(bshd(g, B, H), np.asarray(w), rtol=TOL,
                                   atol=TOL, err_msg=name)
    np.testing.assert_allclose(got[4].numpy(), np.asarray(want[4]),
                               rtol=TOL, atol=TOL, err_msg="du")


def emulate_rwkv_backward(r, k, v, logw, u, dout, dstate, C):
    """The two kernels of csrc/rwkv_linattn_bwd.cu, chunk for chunk and
    token for token, in float64: the forward sweep (a checkpoint before
    every chunk, dr, each row's du terms), then the reverse sweep (each
    chunk's states recomputed from its checkpoint, dk, dlogw, dv and the
    state's gradient carried backwards), du summed over each head's rows
    (every row for a (D,) u)."""
    BH, S, D = r.shape
    H = u.shape[0] if u.dim() == 2 else 1
    r, k, v, logw = (t.double() for t in (r, k, v, logw))
    uf = u.double().reshape(H, D).repeat(BH // H, 1)
    w = torch.exp(logw)
    do = torch.zeros_like(r) if dout is None else dout.double()
    dr, dk, dv, dlogw = (torch.zeros_like(r) for _ in range(4))
    st = torch.zeros(BH, D, D, dtype=torch.float64)
    du_rows = torch.zeros(BH, D, dtype=torch.float64)
    checkpoints = []
    for c0 in range(0, S, C):
        checkpoints.append(st.clone())
        for t in range(c0, min(S, c0 + C)):
            vdo = (v[:, t] * do[:, t]).sum(1, keepdim=True)
            dr[:, t] = torch.einsum("bde,be->bd", st, do[:, t]) \
                + uf * k[:, t] * vdo
            du_rows += r[:, t] * k[:, t] * vdo
            st = w[:, t, :, None] * st + k[:, t, :, None] * v[:, t, None, :]
    g = (torch.zeros(BH, D, D, dtype=torch.float64) if dstate is None
         else dstate.double().clone())
    for c in reversed(range(len(checkpoints))):
        c0 = c * C
        n = min(C, S - c0)
        st, states = checkpoints[c], []
        for t in range(c0, c0 + n):
            states.append(st)
            st = w[:, t, :, None] * st + k[:, t, :, None] * v[:, t, None, :]
        for i in reversed(range(n)):
            t = c0 + i
            vdo = (v[:, t] * do[:, t]).sum(1, keepdim=True)
            dk[:, t] = torch.einsum("bde,be->bd", g, v[:, t]) \
                + uf * r[:, t] * vdo
            dlogw[:, t] = w[:, t] * (states[i] * g).sum(2)
            dv[:, t] = torch.einsum("bd,bde->be", k[:, t], g + (
                uf * r[:, t])[:, :, None] * do[:, t, None, :])
            g = w[:, t, :, None] * g + r[:, t, :, None] * do[:, t, None, :]
    du = du_rows.reshape(BH // H, H, D).sum(0)
    return dr, dk, dv, dlogw, du.reshape(u.shape)


@pytest.mark.parametrize("S,C", [(70, 9), (64, 8), (5, 3), (1, 1),
                                 (33, 64)])
@pytest.mark.parametrize("grads", ["both", "dout_only", "dstate_only"])
def test_rwkv_backward_kernel_arithmetic(S, C, grads):
    """The kernels' sweeps (emulated) against the plain backward, both in
    float64: S not a multiple of the chunk, one chunk, S = 1, dout or
    dstate absent; the extreme decay (logw -50: w underflows nowhere in
    float64 but the sweep never divides by it)."""
    B, H, D = 2, 3, 16
    r, k, v, logw, u, dout, dstate = rwkv_arrays(13, B, S, H, D)
    logw[:, S // 2] = -50.0
    ins = [rows_of(a).double() for a in (r, k, v, logw)]
    ins.append(torch.from_numpy(u).double())
    do = None if grads == "dstate_only" else rows_of(dout).double()
    ds = None if grads == "dout_only" else torch.from_numpy(
        dstate.reshape(B * H, D, D)).double()
    got = emulate_rwkv_backward(*ins, do, ds, C)
    want = rwkv_linattn_backward_plain(*ins, do, ds)
    for name, g, w in zip(("dr", "dk", "dv", "dlogw", "du"), got, want):
        assert w.dtype == torch.float64
        torch.testing.assert_close(g, w, rtol=EMU_TOL, atol=EMU_TOL,
                                   msg=name)


def test_rwkv_backward_chunk_is_about_sqrt_s():
    """The reverse sweep's chunk: ceil(sqrt(S)), at most 64, so both
    scratches (checkpoints and a chunk's states) are O(sqrt(S) D^2)."""
    chunk = linattn_ops.backward_chunk
    assert [chunk(s) for s in (1, 2, 4, 5, 128, 4096, 10 ** 6)] == \
        [1, 2, 2, 3, 12, 64, 64]
    for s in range(1, 300):
        c = chunk(s)
        assert c * c >= s and (c - 1) ** 2 < s


def test_rwkv_function_backward_on_the_cpu_is_the_counted_plain():
    """The Function's backward on the CPU is the plain backward: counted in
    plain_backwards, no kernel launch, gradients bitwise those of
    rwkv_linattn_backward_plain, for a loss on both outputs."""
    B, S, H, D = 1, 20, 2, 16
    r, k, v, logw, u, dout, dstate = rwkv_arrays(17, B, S, H, D)
    ins = [rows_of(a) for a in (r, k, v, logw)] + [torch.from_numpy(u)]
    dstate = torch.from_numpy(dstate.reshape(B * H, D, D))
    leaves = [t.clone().requires_grad_(True) for t in ins]
    before = rwkv_linattn.plain_backwards
    launched = rwkv_linattn_backward.launches
    out, state = rwkv_linattn(*leaves)
    got = torch.autograd.grad((out, state), leaves,
                              (rows_of(dout), dstate))
    assert rwkv_linattn.plain_backwards == before + 1
    assert rwkv_linattn_backward.launches == launched
    want = rwkv_linattn_backward_plain(*ins, rows_of(dout), dstate)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("shared_u", [False, True])
def test_rwkv_backward_meta_counts_the_kernels_work(shared_u):
    """On the meta device: the gradients' shapes (du as u's), and
    BACKWARD_FLOPS (18) x BH S D^2 with the inputs, dout and the five
    gradients counted once each; the Function takes the same branch."""
    BH, S, D, H = 6, 50, 64, 3
    r, k, v, logw, dout = (torch.empty(BH, S, D, device="meta")
                           for _ in range(5))
    u = torch.empty((D,) if shared_u else (H, D), device="meta")
    _launch.META_WORK.update(flops=0.0, bytes=0.0)
    grads = rwkv_linattn_backward(r, k, v, logw, u, dout, None)
    assert [g.shape for g in grads] == [t.shape for t in (r, k, v, logw, u)]
    assert _launch.META_WORK["flops"] == 18 * BH * S * D * D
    assert _launch.META_WORK["bytes"] == 4 * (9 * BH * S * D
                                              + 2 * u.numel())
    leaves = [t.requires_grad_(True) for t in (torch.empty_like(r),
                                               torch.empty_like(k),
                                               torch.empty_like(v),
                                               torch.empty_like(logw),
                                               torch.empty_like(u))]
    out, _ = rwkv_linattn(*leaves)
    _launch.META_WORK.update(flops=0.0, bytes=0.0)
    g = torch.autograd.grad(out, leaves, torch.empty_like(out))
    assert [t.shape for t in g] == [t.shape for t in leaves]
    assert _launch.META_WORK["flops"] == 18 * BH * S * D * D

"""The two-route wrappers of the port, on the CPU: flash attention
(``"tc"`` tensor-core kernel for bfloat16 at head dims 64 / 128, ``"simt"``
CUDA-core kernel otherwise) and the sparse SVRG inner loop (``"cluster"``
thread-block-cluster kernel where a window slice fits one CTA,
``"block"`` otherwise).  Route choice is a pure function of shape and
dtype, so it is tested here at its boundaries, beside the wrappers'
argument checks and the plain versions at the shapes and edge layouts the
new routes take, against the reference.  The CUDA kernels themselves are
held against these plain versions on the card by ``chip_smoke.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash import flash_attention as ref_flash
from repro.kernels.svrg import svrg_inner_sparse_pallas
from repro_torch.kernels._launch import MAX_DYNAMIC_SMEM
from repro_torch.kernels.flash import flash_attention, flash_route
from repro_torch.kernels.flash import ops as flash_ops
from repro_torch.kernels.svrg import svrg_inner_sparse, svrg_sparse_route
from repro_torch.kernels.svrg import sparse as svrg_sparse

#: tests/test_kernels.py's bf16 tolerance (rtol = atol)
BF16_TOL = 3e-2
TOL = dict(rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,D,route", [
    (torch.bfloat16, 64, "tc"), (torch.bfloat16, 128, "tc"),
    (torch.bfloat16, 16, "simt"), (torch.bfloat16, 32, "simt"),
    (torch.float32, 64, "simt"), (torch.float32, 128, "simt"),
    (torch.float32, 16, "simt"), (torch.float16, 128, "simt")])
def test_flash_route_is_chosen_by_dtype_and_head_dim(dtype, D, route):
    assert flash_route(dtype, D) == route
    assert route in flash_ops.ROUTES


def _qkv(seed, B, S, Skv, H, KV, D):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, S, H, D)).astype(np.float32),
            rng.normal(size=(B, Skv, KV, D)).astype(np.float32),
            rng.normal(size=(B, Skv, KV, D)).astype(np.float32))


# the tensor-core route's shapes: ragged S (a multiple of 16, odd), Skv
# shorter and longer than S, GQA ratios 1 / 2 / 4, head dims 64 / 128,
# windows of 1 and 20 keys, causal or not
@pytest.mark.parametrize("B,S,Skv,H,KV,D,causal,window", [
    (1, 80, 80, 4, 4, 128, True, None), (2, 37, 37, 4, 2, 64, True, 20),
    (1, 50, 20, 4, 1, 64, True, None), (1, 24, 70, 4, 2, 128, False, None),
    (1, 33, 33, 2, 1, 64, True, 1), (2, 16, 45, 8, 2, 64, False, 20)])
def test_flash_tc_shapes_plain_matches_reference(B, S, Skv, H, KV, D,
                                                 causal, window):
    assert flash_route(torch.bfloat16, D) == "tc"
    arrs = _qkv(S + Skv + D, B, S, Skv, H, KV, D)
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in arrs)
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in arrs)
    got = flash_attention(tq, tk, tv, causal=causal, window=window)
    want = ref_flash(jq, jk, jv, causal=causal, window=window,
                     backend="ref")
    assert got.dtype == torch.bfloat16 and got.shape == tq.shape
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=BF16_TOL, atol=BF16_TOL)


def test_flash_tc_route_checks_its_arguments():
    """The tensor-core kernel reads q, k and v by TMA, which needs 16-byte
    aligned bases: the check refuses a contiguous view that starts
    mid-element pair.  It guards only the CUDA launch -- on the CPU such a
    view takes the plain version like any other tensor."""
    B, S, H, KV, D = 1, 16, 2, 1, 64
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16)
               for a in _qkv(1, B, S, S, H, KV, D))
    flat = torch.zeros(q.numel() + 1, dtype=torch.bfloat16)
    shifted = flat[1:].view(B, S, H, D)           # data_ptr 2 bytes off
    shifted.copy_(q)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16
    with pytest.raises(ValueError, match="q starts at a 16-byte"):
        flash_ops.check_tma_alignment(shifted, k, v)
    vflat = torch.zeros(v.numel() + 1, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="v starts at a 16-byte"):
        flash_ops.check_tma_alignment(q, k, vflat[1:].view(v.shape))
    flash_ops.check_tma_alignment(q, k, v)        # fresh tensors pass
    assert flash_route(shifted.dtype, D) == "tc"
    torch.testing.assert_close(flash_attention(shifted, k, v),
                               flash_attention(q, k, v), rtol=0, atol=0)
    # the CUDA-core route has no such requirement
    q32 = torch.zeros(q.numel() + 1)[1:].view(q.shape)
    out = flash_attention(q32, k.float(), v.float())
    assert out.shape == q.shape and torch.isfinite(out).all()


def test_flash_cpu_calls_count_no_launch_on_either_route():
    before = (flash_attention.launches,
              dict(flash_attention.launches_by_route))
    for dtype, D in ((torch.bfloat16, 64), (torch.float32, 32)):
        q, k, v = (torch.from_numpy(a).to(dtype)
                   for a in _qkv(2, 1, 20, 20, 2, 2, D))
        flash_attention(q, k, v, window=8)
    assert (flash_attention.launches,
            flash_attention.launches_by_route) == before
    assert set(before[1]) == {"tc", "simt"}


# ---------------------------------------------------------------------------
# sparse SVRG inner loop
# ---------------------------------------------------------------------------

MAX_SLICE = svrg_sparse.CLUSTER_THREADS * svrg_sparse.CLUSTER_MAX_PER_THREAD


def _k_at_smem_limit(m_sub):
    """The widest ELL row that still fits one cluster CTA's shared memory
    beside the window slice of ``m_sub``."""
    return (MAX_DYNAMIC_SMEM - svrg_sparse.cluster_smem(m_sub, 0)) // 16


@pytest.mark.parametrize("m_sub,k,route", [
    (48400, 168, "cluster"),                  # the news20 RADiSA / SFK window
    (338800, 168, "block"),                   # RADiSA avg at news20 width
    (1, 1, "cluster"), (5, 16, "cluster"),    # fewer columns than CTAs
    (8 * MAX_SLICE, 168, "cluster"),          # the largest slice in registers
    (8 * MAX_SLICE + 1, 168, "block"),        # one column more
    (8 * MAX_SLICE - 7, 168, "cluster"),
    (48400, _k_at_smem_limit(48400), "cluster"),
    (48400, _k_at_smem_limit(48400) + 1, "block"),
    (8, _k_at_smem_limit(8) + 1, "block")])
def test_svrg_sparse_route_boundaries(m_sub, k, route):
    assert svrg_sparse_route(m_sub, k) == route
    fits_smem = svrg_sparse.cluster_smem(m_sub, k) <= MAX_DYNAMIC_SMEM
    fits_regs = svrg_sparse.cluster_slice(m_sub) <= MAX_SLICE
    assert (route == "cluster") == (fits_smem and fits_regs)


@pytest.mark.parametrize("m_sub,k", [
    (48400, 168), (1, 1), (13, 20), (64, 0), (8 * MAX_SLICE, 168),
    (8 * MAX_SLICE - 7, 3), (131071, 0)])
def test_cluster_geometry_covers_the_window(m_sub, k):
    """The geometry the wrapper hands the cluster launch: the slices of
    the CTAs cover the window, each fits the registers of a CTA, and the
    shared memory holds the kernel's layout -- d and g for the slice
    rounded up to runs of 4 columns, then two ELL rows of k ids and
    values."""
    assert svrg_sparse_route(m_sub, k) == "cluster"
    sl = svrg_sparse.cluster_slice(m_sub)
    assert (sl - 1) * svrg_sparse.CLUSTER_SIZE < m_sub \
        <= sl * svrg_sparse.CLUSTER_SIZE
    assert sl <= MAX_SLICE
    spad = -(-sl // 4) * 4
    assert spad % 4 == 0 and sl <= spad < sl + 4
    assert svrg_sparse.cluster_smem(m_sub, k) == 2 * 4 * spad + 2 * k * (4 + 4)
    assert svrg_sparse.cluster_smem(m_sub, k) <= MAX_DYNAMIC_SMEM
    assert svrg_sparse.cluster_slice(48400) == 6050


def _edge_inputs(rng, n_p, m_q, m_sub, k, L, lo):
    """One ELL cell laid out for the cluster route's edges: row 0 holds a
    column twice, row 1 is all padding, row 2 holds the columns on both
    sides of every slice boundary of the window and the window's ends;
    the steps visit rows 0-2 often."""
    cols = np.zeros((n_p, k), np.int32)
    vals = np.zeros((n_p, k), np.float32)
    for i in range(n_p):
        r = int(rng.integers(1, min(k, m_q) + 1))
        c = np.sort(rng.choice(m_q, size=r, replace=False))
        if i == 0 and r >= 2:
            c[1] = c[0]
        if i != 1:
            cols[i, :r], vals[i, :r] = c, rng.normal(size=r)
    sl = svrg_sparse.cluster_slice(m_sub)
    edge = sorted({lo + c for t in range(1, svrg_sparse.CLUSTER_SIZE)
                   for c in (t * sl - 1, t * sl) if 0 <= c < m_sub}
                  | {lo, lo + m_sub - 1, max(lo - 1, 0),
                     min(lo + m_sub, m_q - 1)})[:k]
    cols[2] = 0
    vals[2] = 0.0
    cols[2, :len(edge)] = edge
    vals[2, :len(edge)] = rng.normal(size=len(edge))
    y = np.where(rng.random(n_p) < 0.5, -1.0, 1.0).astype(np.float32)
    mask = np.ones(n_p, np.float32)
    mask[-2:] = 0.0
    za = rng.normal(size=n_p).astype(np.float32)
    wa = (rng.normal(size=m_sub) * 0.2).astype(np.float32)
    mu = (rng.normal(size=m_sub) * 0.05).astype(np.float32)
    idx = rng.integers(0, n_p, L).astype(np.int32)
    idx[::3], idx[1::5], idx[2::7] = 2, 1, 0
    return cols, vals, y, mask, za, wa, mu, idx


@pytest.mark.parametrize("n_p,m_q,m_sub,k,L,lo", [
    (16, 24, 13, 20, 40, 5), (16, 40, 5, 16, 40, 35),
    (20, 120, 101, 24, 60, 19), (12, 64, 64, 20, 30, 0)])
@pytest.mark.parametrize("loss", ["hinge", "squared"])
def test_svrg_cluster_edge_layout_plain_vs_pallas(n_p, m_q, m_sub, k, L, lo,
                                                  loss):
    """Windows that do not divide by the cluster size (or are narrower),
    columns on slice boundaries, a repeated column, an all-padding row and
    lo > 0: the port's plain version against the reference's Pallas kernel
    in interpret mode."""
    assert svrg_sparse_route(m_sub, k) == "cluster"
    args = _edge_inputs(np.random.default_rng(m_sub + k), n_p, m_q, m_sub,
                        k, L, lo)
    kw = dict(lam=0.1, eta=0.03, loss=loss)
    want = svrg_inner_sparse_pallas(*map(jnp.asarray, args), lo=lo, **kw)
    got = svrg_inner_sparse(*(torch.from_numpy(a) for a in args), lo=lo,
                            **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_svrg_sparse_cpu_calls_count_no_launch_on_either_route():
    rng = np.random.default_rng(4)
    before = (svrg_inner_sparse.launches,
              dict(svrg_inner_sparse.launches_by_route))
    for m_sub in (13, 8 * MAX_SLICE + 8):
        args = _edge_inputs(rng, 8, m_sub, m_sub, 6, 5, 0)
        w = svrg_inner_sparse(*(torch.from_numpy(a) for a in args), lam=0.1,
                              eta=0.03)
        assert w.shape == (m_sub,) and torch.isfinite(w).all()
    assert (svrg_inner_sparse.launches,
            svrg_inner_sparse.launches_by_route) == before
    assert set(before[1]) == {"cluster", "block"}

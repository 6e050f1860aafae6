"""The two-route wrappers of the port, on the CPU: flash attention
(``"tc"`` tensor-core kernel for bfloat16 at head dims 64 / 128, ``"simt"``
CUDA-core kernel otherwise), the sparse SVRG inner loop (``"cluster"``
thread-block-cluster kernel where a window slice fits one CTA,
``"block"`` otherwise), the dense SDCA epoch (``"cluster"`` where a slice
of w fits a CTA's registers and the dual deltas its shared memory,
``"block"`` otherwise) and RWKV6 linear attention (``"tc"`` at head dim 64
with chunks of 64, ``"simt"`` otherwise).  Route choice is a pure function
of shape and dtype, so it is tested here at its boundaries, beside the
wrappers' argument checks and the plain versions at the shapes and edge
layouts the new routes take, against the reference.  The CUDA kernels
themselves are held against these plain versions on the card by
``chip_smoke.py``.

Also here: the port's device rule for the building blocks that
``repro_torch.core`` exports (no silent CPU default), and the plain flash
version's answer for query rows with no unmasked key, held against the
Pallas kernel in interpret mode."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash import flash_attention as ref_flash
from repro.kernels.flash import flash_attention_pallas
from repro.kernels.flash import mha_ref as jax_mha_ref
from repro.kernels.linattn import rwkv_linattn_ref as jax_linattn_ref
from repro.kernels.sdca import sdca_epoch_pallas
from repro.kernels.svrg import svrg_inner_sparse_pallas
from repro_torch.core import (ArrayIndexSource, CellProgram, CommSchedule,
                              GeneratorIndexSource, SyncComm)
from repro_torch.core.comm import Comm
from repro_torch.core.engines import grid_program
from repro_torch.core.util import resolve_device
from repro_torch.kernels._launch import MAX_DYNAMIC_SMEM
from repro_torch.kernels.flash import flash_attention, flash_route, mha_ref
from repro_torch.kernels.flash import ops as flash_ops
from repro_torch.kernels.linattn import linattn_route, rwkv_linattn
from repro_torch.kernels.linattn import ops as linattn_ops
from repro_torch.kernels.sdca import sdca_epoch, sdca_route
from repro_torch.kernels.sdca import ops as sdca_ops
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


# ---------------------------------------------------------------------------
# dense SDCA epoch
# ---------------------------------------------------------------------------

SDCA_MAX_SLICE = sdca_ops.CLUSTER_MAX_SLICE


def _rows_at_smem_limit(m_q, steps):
    """The most rows whose dual deltas still fit one cluster CTA's shared
    memory beside the order of ``steps`` indices and the ring of rows."""
    e = sdca_ops.sdca_cluster_per_thread(sdca_ops.sdca_cluster_slice(m_q))
    return (MAX_DYNAMIC_SMEM - sdca_ops.sdca_cluster_smem(0, 0, e)) // 4 \
        - steps


@pytest.mark.parametrize("n_p,m_q,steps,route", [
    (2000, 3003, 2000, "cluster"),            # the D3CA cells of Part 1
    (14000, 12000, 14000, "cluster"),         # a serial-SDCA epoch for f*
    (8, 8, 8, "cluster"), (17, 9, 33, "cluster"), (1, 1, 0, "cluster"),
    (_rows_at_smem_limit(3003, 2000), 3003, 2000, "cluster"),
    (_rows_at_smem_limit(3003, 2000) + 1, 3003, 2000, "block"),
    (2000, 3003, _rows_at_smem_limit(3003, 2000), "cluster"),
    (2000, 3003, _rows_at_smem_limit(3003, 2000) + 1, "block"),
    (100, 16 * SDCA_MAX_SLICE, 100, "cluster"),  # the widest row
    (100, 16 * SDCA_MAX_SLICE + 1, 100, "block"),
    (0, 64, 8, "block"), (64, 0, 8, "block")])
def test_sdca_route_boundaries(n_p, m_q, steps, route):
    assert sdca_route(n_p, m_q, steps) == route
    assert route in sdca_ops.ROUTES


@pytest.mark.parametrize("m_q", [1, 9, 17, 3003, 4096, 4097, 12000, 32768,
                                 32769, 16 * SDCA_MAX_SLICE - 5,
                                 16 * SDCA_MAX_SLICE])
def test_sdca_cluster_geometry_covers_the_row(m_q):
    """The cluster size comes from m_q alone, out of the sizes the kernel
    is compiled for; the slices of its CTAs cover the row, the columns a
    thread holds cover its slice with the fewest the kernel is compiled
    for, and the shared memory holds the kernel's layout."""
    g = sdca_ops.sdca_cluster_size(m_q)
    assert g in sdca_ops.CLUSTER_SIZES
    sl = sdca_ops.sdca_cluster_slice(m_q)
    assert sl == -(-m_q // g)
    assert (sl - 1) * g < m_q <= sl * g
    assert sl <= SDCA_MAX_SLICE
    e = sdca_ops.sdca_cluster_per_thread(sl)
    assert e in sdca_ops.CLUSTER_PER_THREAD
    assert sl <= sdca_ops.CLUSTER_THREADS * e
    smaller = [v for v in sdca_ops.CLUSTER_PER_THREAD if v < e]
    assert not smaller or sl > sdca_ops.CLUSTER_THREADS * smaller[-1]
    # dual deltas and order (rounded up to 4), 8 slots of 128 e + 8 floats
    # (a slice copied from the 16-byte boundary before it), 16 x 4 scalars
    assert sdca_ops.sdca_cluster_smem(2000, 2000, e) == \
        4 * (4000 + 8 * (128 * e + 8) + 64)
    assert sdca_ops.sdca_cluster_smem(3, 2, e) == \
        sdca_ops.sdca_cluster_smem(4, 4, e)
    # the main-path widths: one CTA for the D3CA cells, 16 for the serial
    # epochs
    assert sdca_ops.sdca_cluster_size(3003) == 1
    assert sdca_ops.sdca_cluster_size(12000) == 16
    # monotone: a wider row never takes fewer CTAs
    assert sdca_ops.sdca_cluster_size(m_q + 1) >= g


def _sdca_cell(rng, n_p, m_q, steps):
    x = (rng.normal(size=(n_p, m_q)) / np.sqrt(m_q)).astype(np.float32)
    y = np.where(rng.random(n_p) < 0.5, -1.0, 1.0).astype(np.float32)
    mask = np.ones(n_p, np.float32)
    mask[-2:] = 0.0
    a0 = (rng.uniform(0, 0.5, n_p) * (y > 0)).astype(np.float32)
    w0 = (rng.normal(size=m_q) * 0.1).astype(np.float32)
    idx = rng.integers(0, n_p, steps).astype(np.int32)
    # a row twice in a row, three times in a row, and 4 and 5 steps apart
    for h, back in ((5, 1), (9, 1), (10, 2), (20, 4), (31, 5)):
        if h < steps:
            idx[h] = idx[h - back]
    return x, y, mask, a0, w0, idx


@pytest.mark.parametrize("m_q", [9, 17, 33])
@pytest.mark.parametrize("loss,beta", [("hinge", None), ("squared", None),
                                       ("hinge", 1.0), ("squared", 1.0)])
def test_sdca_cluster_edge_layout_plain_vs_pallas(m_q, loss, beta):
    """Widths that do not divide by a cluster's columns, masked rows,
    exact and beta denominators, repeated indices: the port's plain
    version against the reference's Pallas kernel in interpret mode."""
    assert sdca_route(24, m_q, 37) == "cluster"
    args = _sdca_cell(np.random.default_rng(m_q), 24, m_q, 37)
    kw = dict(lam=0.2, n=200, Q=3, loss=loss, beta=beta)
    da_j, w_j = sdca_epoch_pallas(*map(jnp.asarray, args), **kw)
    da_t, w_t = sdca_epoch(*map(torch.from_numpy, args), **kw)
    np.testing.assert_allclose(da_t.numpy(), np.asarray(da_j), **TOL)
    np.testing.assert_allclose(w_t.numpy(), np.asarray(w_j), **TOL)


def test_sdca_cluster_launch_checks_its_route():
    """The private launch refuses a route it does not know before it
    touches the library; the public wrapper keeps its argument checks."""
    args = list(map(torch.from_numpy, _sdca_cell(np.random.default_rng(2),
                                                 16, 9, 12)))
    with pytest.raises(ValueError, match="unknown sdca_epoch route"):
        sdca_ops._launch(*[a[None, None] if a.dim() == 2 else a[None]
                           for a in args], lam=0.2, n=200, Q=3, loss_id=0,
                         beta=None, route="warp")
    with pytest.raises(ValueError, match="x must be"):
        sdca_epoch(args[0][None], *args[1:], lam=0.2, n=200, Q=3)
    with pytest.raises(ValueError, match="idx must be"):
        sdca_epoch(args[0][None, None], *[a[None] for a in args[1:5]],
                   args[5][None, None], lam=0.2, n=200, Q=3)


def test_sdca_cpu_calls_count_no_launch_on_either_route():
    rng = np.random.default_rng(3)
    before = (sdca_epoch.launches, dict(sdca_epoch.launches_by_route),
              dict(sdca_epoch.launches_by_cluster))
    for n_p, m_q in ((12, 9), (_rows_at_smem_limit(2, 6) + 1, 2)):
        assert sdca_route(n_p, m_q, 6) == ("cluster" if n_p == 12
                                           else "block")
        args = _sdca_cell(rng, n_p, m_q, 6)
        da, w = sdca_epoch(*map(torch.from_numpy, args), lam=0.2, n=200,
                           Q=1)
        assert da.shape == (n_p,) and w.shape == (m_q,)
    assert (sdca_epoch.launches, sdca_epoch.launches_by_route,
            sdca_epoch.launches_by_cluster) == before
    assert set(before[1]) == {"cluster", "block"}
    assert set(before[2]) == set(sdca_ops.CLUSTER_SIZES)


# ---------------------------------------------------------------------------
# RWKV6 linear attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("D,chunk,route", [
    (64, 64, "tc"), (64, 32, "simt"), (64, 63, "simt"), (64, 1, "simt"),
    (32, 64, "simt"), (16, 64, "simt"), (128, 64, "simt")])
def test_linattn_route_is_chosen_by_head_dim_and_chunk(D, chunk, route):
    assert linattn_route(D, chunk) == route
    assert route in linattn_ops.ROUTES


def _linattn(rng, BH, S, D, heads=None, logw=None):
    r, k, v = (rng.normal(size=(BH, S, D)).astype(np.float32)
               for _ in range(3))
    lw = (np.maximum(-np.exp(np.clip(rng.normal(size=(BH, S, D)), -20, 4)),
                     -8.0) if logw is None
          else np.full((BH, S, D), logw)).astype(np.float32)
    u = (0.5 * rng.normal(size=(D,) if heads is None else (heads, D))
         ).astype(np.float32)
    return r, k, v, lw, u


@pytest.mark.parametrize("BH,S,logw", [(2, 5, None), (1, 1, None),
                                       (2, 37, -50.0), (1, 70, 0.0)])
def test_linattn_tc_shapes_plain_matches_reference(BH, S, logw):
    """The tensor-core route's shapes -- S below 16, S not a multiple of
    16 or 64, the extreme decay, no decay -- through the port's wrapper
    on the CPU (its plain version) against the reference's plain
    recurrence."""
    assert linattn_route(64, 64) == "tc"
    args = _linattn(np.random.default_rng(S), BH, S, 64, logw=logw)
    out_t, st_t = rwkv_linattn(*map(torch.from_numpy, args))
    out_j, st_j = jax_linattn_ref(*map(jnp.asarray, args))
    assert np.isfinite(out_t.numpy()).all()
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), rtol=2e-4,
                               atol=2e-4)
    np.testing.assert_allclose(st_t.numpy(), np.asarray(st_j), rtol=2e-4,
                               atol=2e-4)


def test_linattn_wrapper_checks_its_arguments():
    r, k, v, lw, u = map(torch.from_numpy,
                         _linattn(np.random.default_rng(1), 4, 10, 64,
                                  heads=2))
    with pytest.raises(ValueError, match="chunk must be"):
        rwkv_linattn(r, k, v, lw, u, chunk=65)
    with pytest.raises(ValueError, match="chunk must be"):
        rwkv_linattn(r, k, v, lw, u, chunk=0)
    with pytest.raises(ValueError, match="not a multiple of 3 heads"):
        rwkv_linattn(r, k, v, lw, torch.zeros(3, 64))
    with pytest.raises(ValueError, match="u must be"):
        rwkv_linattn(r, k, v, lw, torch.zeros(1, 2, 64))
    with pytest.raises(ValueError, match="k has shape"):
        rwkv_linattn(r, k[:, :-1], v, lw, u)
    with pytest.raises(ValueError, match="r must be"):
        rwkv_linattn(r[0], k, v, lw, u)


def test_linattn_cpu_calls_count_no_launch_on_either_route():
    rng = np.random.default_rng(5)
    before = (rwkv_linattn.launches, dict(rwkv_linattn.launches_by_route))
    for D, chunk in ((64, 64), (32, 16)):
        out, state = rwkv_linattn(*map(torch.from_numpy,
                                       _linattn(rng, 2, 9, D)), chunk=chunk)
        assert out.shape == (2, 9, D) and state.shape == (2, D, D)
    assert (rwkv_linattn.launches, rwkv_linattn.launches_by_route) == before
    assert set(before[1]) == {"tc", "simt"}


# ---------------------------------------------------------------------------
# repairs: the device rule, and rows with no unmasked key
# ---------------------------------------------------------------------------

def _no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError) as rule:
        resolve_device()
    return str(rule.value)


@pytest.mark.parametrize("build", [
    lambda: Comm(CommSchedule().psum("a", axis="data"),
                 {"data": 2, "model": 1}),
    lambda: SyncComm(CommSchedule().psum("a", axis="data"),
                     {"data": 2, "model": 1}),
    lambda: grid_program(CellProgram(CommSchedule(), lambda *a: None), 2, 1),
    lambda: GeneratorIndexSource(0, P=2, Q=1, n_p=4),
    lambda: ArrayIndexSource(sdca={1: np.zeros((2, 4), np.int32)})],
    ids=["Comm", "SyncComm", "grid_program", "GeneratorIndexSource",
         "ArrayIndexSource"])
def test_core_building_blocks_default_to_the_card(build, monkeypatch):
    """Built with no ``device``, each raises on a machine without a card
    the way ``resolve_device`` does; ``device="cpu"`` has to be asked
    for."""
    msg = _no_card(monkeypatch)
    with pytest.raises(RuntimeError) as got:
        build()
    assert str(got.value) == msg and "device='cpu'" in msg


def test_core_building_blocks_take_the_cpu_when_asked():
    assert Comm(CommSchedule(), {"data": 1, "model": 1},
                device="cpu").device.type == "cpu"
    assert GeneratorIndexSource(0, P=1, Q=1, n_p=2,
                                device="cpu").sdca_rows(1).device.type == "cpu"
    assert ArrayIndexSource(sdca={1: np.zeros((1, 2), np.int32)},
                            device="cpu").sdca_rows(1).device.type == "cpu"
    sched = CommSchedule().psum("a", axis="data")
    step = grid_program(CellProgram(sched, lambda comm, t, d, s: comm(
        "a", torch.ones(2, 1, 3))), 2, 1, device="cpu")
    assert torch.equal(step(1, None, None), torch.full((1, 3), 2.0))


def test_flash_plain_gives_keyless_rows_zero_as_the_pallas_kernel():
    """BH 2, S 256, Skv 64, window 8, non-causal, 64-row blocks: rows >= 71
    have no unmasked key.  The Pallas kernel skips every KV tile of query
    blocks 2-3 (rows 128-255) and gives them 0, as the port's plain
    version does; rows that have a key agree with the JAX ``mha_ref``.
    (Rows 71-127 share a visited tile with keyed rows: there the Pallas
    kernel gives the average of v, so they are held to neither.)"""
    rng = np.random.default_rng(21)
    q, k, v = (rng.normal(size=s).astype(np.float32)
               for s in ((2, 256, 32), (2, 64, 32), (2, 64, 32)))
    kw = dict(causal=False, window=8)
    got = mha_ref(*map(torch.from_numpy, (q, k, v)), **kw).numpy()
    pallas = np.asarray(flash_attention_pallas(
        *map(jnp.asarray, (q, k, v)), block_q=64, block_k=64, **kw))
    want = np.asarray(jax_mha_ref(*map(jnp.asarray, (q, k, v)), **kw))
    np.testing.assert_array_equal(pallas[:, 128:], 0.0)
    np.testing.assert_array_equal(got[:, 71:], 0.0)
    np.testing.assert_allclose(got[:, 128:], pallas[:, 128:], atol=0)
    np.testing.assert_allclose(got[:, :71], want[:, :71], **TOL)
    np.testing.assert_allclose(got[:, :71], pallas[:, :71], **TOL)

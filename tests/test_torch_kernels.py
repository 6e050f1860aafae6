"""Plain versions of the port's kernels vs the reference's Pallas kernels
(interpret mode) and ``ref.py`` functions, over the reference's own shape
sweep (CPU).  The CUDA kernels themselves run only on a card; the chip
check ``chip_smoke.py`` holds them against these plain versions there."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.sdca import sdca_epoch_pallas, sdca_epoch_ref
from repro.kernels.svrg import svrg_inner_pallas, svrg_inner_ref
from repro_torch.kernels.sdca import sdca_epoch, sdca_epoch_plain
from repro_torch.kernels.svrg import svrg_inner, svrg_inner_plain
import test_torch_common  # noqa: F401  (one torch thread a process)

TOL = dict(rtol=1e-5, atol=1e-5)


def _sdca_inputs(rng, n_p, m_q, steps):
    x = rng.normal(size=(n_p, m_q)).astype(np.float32)
    y = np.sign(rng.normal(size=n_p)).astype(np.float32)
    y[y == 0] = 1.0
    mask = np.ones(n_p, np.float32)
    mask[-2:] = 0.0
    a0 = (rng.uniform(0, 0.5, n_p) * (y > 0)).astype(np.float32)
    w0 = (rng.normal(size=m_q) * 0.1).astype(np.float32)
    idx = rng.integers(0, n_p, steps).astype(np.int32)
    return x, y, mask, a0, w0, idx


def _svrg_inputs(rng, n_p, m_sub, L):
    x = rng.normal(size=(n_p, m_sub)).astype(np.float32)
    y = np.sign(rng.normal(size=n_p)).astype(np.float32)
    y[y == 0] = 1.0
    mask = np.ones(n_p, np.float32)
    wa = (rng.normal(size=m_sub) * 0.2).astype(np.float32)
    za = (x @ wa + rng.normal(size=n_p) * 0.1).astype(np.float32)
    mu = (rng.normal(size=m_sub) * 0.05).astype(np.float32)
    idx = rng.integers(0, n_p, L).astype(np.int32)
    return x, y, mask, za, wa, mu, idx


@pytest.mark.parametrize("n_p,m_q,steps", [(8, 8, 8), (24, 16, 50),
                                           (64, 128, 64), (17, 9, 33)])
@pytest.mark.parametrize("loss", ["hinge", "squared"])
@pytest.mark.parametrize("beta", [None, "m_q"])
def test_sdca_plain_vs_reference(n_p, m_q, steps, loss, beta):
    rng = np.random.default_rng(7)
    args = _sdca_inputs(rng, n_p, m_q, steps)
    # beta ~ ||x_i||^2 keeps the step-size-variant recursion contractive
    kw = dict(lam=0.2, n=200, Q=3, loss=loss,
              beta=float(m_q) if beta else None)
    jargs = [jnp.asarray(a) for a in args]
    da_r, w_r = sdca_epoch_ref(*jargs, **kw)
    da_p, w_p = sdca_epoch_pallas(*jargs, **kw)
    da_t, w_t = sdca_epoch(*map(torch.from_numpy, args), **kw)
    for want_da, want_w in ((da_r, w_r), (da_p, w_p)):
        np.testing.assert_allclose(da_t.numpy(), np.asarray(want_da), **TOL)
        np.testing.assert_allclose(w_t.numpy(), np.asarray(want_w), **TOL)


@pytest.mark.parametrize("n_p,m_sub,L", [(16, 8, 20), (40, 32, 64),
                                         (13, 5, 11)])
@pytest.mark.parametrize("loss", ["hinge", "squared"])
def test_svrg_plain_vs_reference(n_p, m_sub, L, loss):
    rng = np.random.default_rng(7)
    args = _svrg_inputs(rng, n_p, m_sub, L)
    kw = dict(lam=0.1, eta=0.03, loss=loss)
    jargs = [jnp.asarray(a) for a in args]
    w_r = svrg_inner_ref(*jargs, **kw)
    w_p = svrg_inner_pallas(*jargs, **kw)
    w_t = svrg_inner(*map(torch.from_numpy, args), **kw)
    np.testing.assert_allclose(w_t.numpy(), np.asarray(w_r), **TOL)
    np.testing.assert_allclose(w_t.numpy(), np.asarray(w_p), **TOL)


@pytest.mark.parametrize("loss", ["hinge", "squared"])
@pytest.mark.parametrize("beta", [None, 9.0])
def test_sdca_batched_equals_per_cell(loss, beta):
    """One batched call over the grid == one call per cell, bit for bit;
    y / mask / alpha0 / idx follow p, w0 follows q."""
    rng = np.random.default_rng(11)
    P, Q, n_p, m_q, steps = 3, 2, 17, 9, 33
    x = torch.from_numpy(rng.normal(size=(P, Q, n_p, m_q)).astype(np.float32))
    cells = [_sdca_inputs(rng, n_p, m_q, steps) for _ in range(P)]
    y, mask, a0, idx = (torch.from_numpy(np.stack([c[k] for c in cells]))
                        for k in (1, 2, 3, 5))
    w0 = torch.from_numpy((rng.normal(size=(Q, m_q)) * 0.1).astype(np.float32))
    kw = dict(lam=0.2, n=200, Q=Q, loss=loss, beta=beta)
    da, wf = sdca_epoch(x, y, mask, a0, w0, idx, **kw)
    assert da.shape == (P, Q, n_p) and wf.shape == (P, Q, m_q)
    for p in range(P):
        for q in range(Q):
            da1, wf1 = sdca_epoch(x[p, q], y[p], mask[p], a0[p], w0[q],
                                  idx[p], **kw)
            assert torch.equal(da[p, q], da1)
            assert torch.equal(wf[p, q], wf1)
    # padded rows (mask 0) never move their dual
    assert torch.all(da[:, :, -2:] == 0)


@pytest.mark.parametrize("loss", ["hinge", "squared"])
def test_svrg_batched_equals_per_cell_and_window_equals_slice(loss):
    """Batched == per cell, bit for bit; the in-place window
    ``[lo, lo + m_sub)`` == the same call on the explicit column slice,
    with offsets that are not multiples of 4."""
    rng = np.random.default_rng(12)
    P, Q, n_p, m_x, m_sub, L = 3, 2, 13, 15, 5, 11
    x = torch.from_numpy(rng.normal(size=(P, Q, n_p, m_x)).astype(np.float32))
    y = torch.from_numpy(np.where(rng.random((P, n_p)) < 0.5, -1.0, 1.0)
                         .astype(np.float32))
    mask = torch.ones(P, n_p)
    mask[-1, -3:] = 0.0
    za = torch.from_numpy(rng.normal(size=(P, n_p)).astype(np.float32))
    wa = torch.from_numpy((rng.normal(size=(P, Q, m_sub)) * 0.2)
                          .astype(np.float32))
    mu = torch.from_numpy((rng.normal(size=(P, Q, m_sub)) * 0.05)
                          .astype(np.float32))
    idx = torch.from_numpy(rng.integers(0, n_p, (P, Q, L)).astype(np.int32))
    lo = torch.tensor([5, 10, 1], dtype=torch.int32)
    kw = dict(lam=0.1, eta=0.03, loss=loss)
    w = svrg_inner(x, y, mask, za, wa, mu, idx, lo=lo, **kw)
    assert w.shape == (P, Q, m_sub)
    for p in range(P):
        for q in range(Q):
            l0 = int(lo[p])
            w1 = svrg_inner(x[p, q], y[p], mask[p], za[p], wa[p, q],
                            mu[p, q], idx[p, q], lo=l0, **kw)
            assert torch.equal(w[p, q], w1)
            w2 = svrg_inner(x[p, q, :, l0:l0 + m_sub].contiguous(), y[p],
                            mask[p], za[p], wa[p, q], mu[p, q], idx[p, q],
                            **kw)
            assert torch.equal(w[p, q], w2)


def test_wrappers_check_their_arguments():
    rng = np.random.default_rng(13)
    args = list(map(torch.from_numpy, _sdca_inputs(rng, 8, 8, 8)))
    kw = dict(lam=0.2, n=200, Q=3)
    with pytest.raises(NotImplementedError, match="local_backend='ref'"):
        sdca_epoch(*args, loss="logistic", **kw)
    bad = list(args)
    bad[5] = bad[5].long()                       # idx must be int32
    with pytest.raises(TypeError, match="idx"):
        sdca_epoch(*bad, **kw)
    bad = list(args)
    bad[0] = bad[0].t()                          # x must be contiguous
    with pytest.raises(ValueError, match="contiguous"):
        sdca_epoch(*bad, **kw)
    bad = list(args)
    bad[1] = bad[1][:-1]                         # y of the wrong length
    with pytest.raises(ValueError, match="y has shape"):
        sdca_epoch(*bad, **kw)
    sargs = list(map(torch.from_numpy, _svrg_inputs(rng, 16, 8, 20)))
    with pytest.raises(NotImplementedError, match="local_backend='ref'"):
        svrg_inner(*sargs, lam=0.1, eta=0.03, loss="logistic")
    with pytest.raises(ValueError, match="leaves the block"):
        svrg_inner(sargs[0], *sargs[1:4], sargs[4][:3], sargs[5][:3],
                   sargs[6], lam=0.1, eta=0.03, lo=6)
    with pytest.raises(ValueError, match="does not match"):
        svrg_inner(sargs[0], *sargs[1:4], sargs[4][:3], sargs[5][:3],
                   sargs[6], lam=0.1, eta=0.03)


def test_cpu_calls_launch_nothing():
    """The launch counters count CUDA launches only."""
    rng = np.random.default_rng(14)
    before = (sdca_epoch.launches, svrg_inner.launches)
    sdca_epoch(*map(torch.from_numpy, _sdca_inputs(rng, 8, 8, 8)), lam=0.2,
               n=200, Q=3)
    svrg_inner(*map(torch.from_numpy, _svrg_inputs(rng, 16, 8, 20)), lam=0.1,
               eta=0.03)
    assert (sdca_epoch.launches, svrg_inner.launches) == before
    assert sdca_epoch_plain is not sdca_epoch
    assert svrg_inner_plain is not svrg_inner

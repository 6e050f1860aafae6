"""The solver kernels' runtime (per-tenant) branch, on the CPU: the tenant
axis and the per-cell scalars of the four wrappers, and their plain
versions against the reference's Pallas kernels called with traced
scalars (interpret mode), so that their runtime branch runs.

The CUDA kernels run only on a card; ``chip_smoke.py`` holds them, at
T = 1 and 3 with a distinct lam in every cell, against these plain
versions there."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.sdca import sdca_epoch_pallas, sdca_epoch_sparse_pallas
from repro.kernels.svrg import svrg_inner_pallas, svrg_inner_sparse_pallas
from repro_torch.kernels._launch import cell_index, cell_params
from repro_torch.kernels.sdca import sdca_epoch, sdca_epoch_sparse
from repro_torch.kernels.svrg import svrg_inner, svrg_inner_sparse
from test_torch_sparse import _ell_cell

#: the tolerance of the reference's own kernel tests
TOL = dict(rtol=1e-5, atol=1e-5)
P, Q, T = 3, 2, 3
LAMS = np.array([0.2, 0.05, 0.8], np.float32)        # one per tenant
NS = np.array([200.0, 96.0, 150.0], np.float32)


def _signs(rng, shape):
    return np.where(rng.random(shape) < 0.5, -1.0, 1.0).astype(np.float32)


def _sdca_args(rng, sparse, n_p=11, m_q=9, k=5, steps=23):
    """(P, Q, T, ...) inputs of one SDCA epoch, dense or padded-ELL."""
    if sparse:
        cells = [_ell_cell(rng, n_p, m_q, k) for _ in range(P * Q * T)]
        x = (np.stack([c[0] for c in cells]).reshape(P, Q, T, n_p, k),
             np.stack([c[1] for c in cells]).reshape(P, Q, T, n_p, k))
    else:
        x = (rng.normal(size=(P, Q, T, n_p, m_q)).astype(np.float32),)
    y = _signs(rng, (P, T, n_p))
    mask = np.ones((P, T, n_p), np.float32)
    mask[:, :, -2:] = 0.0
    a0 = (rng.uniform(0, 0.5, (P, T, n_p)) * (y > 0)).astype(np.float32)
    w0 = (rng.normal(size=(Q, T, m_q)) * 0.1).astype(np.float32)
    idx = rng.integers(0, n_p, (P, T, steps)).astype(np.int32)
    return [torch.from_numpy(a) for a in (*x, y, mask, a0, w0, idx)]


def _svrg_args(rng, sparse, n_p=13, m_x=15, m_sub=5, k=5, L=11):
    """(P, Q, T, ...) inputs of one SVRG inner loop with windows lo."""
    if sparse:
        cells = [_ell_cell(rng, n_p, m_x, k) for _ in range(P * Q * T)]
        x = (np.stack([c[0] for c in cells]).reshape(P, Q, T, n_p, k),
             np.stack([c[1] for c in cells]).reshape(P, Q, T, n_p, k))
    else:
        x = (rng.normal(size=(P, Q, T, n_p, m_x)).astype(np.float32),)
    y = _signs(rng, (P, T, n_p))
    mask = np.ones((P, T, n_p), np.float32)
    mask[-1, :, -3:] = 0.0
    za = rng.normal(size=(P, T, n_p)).astype(np.float32)
    wa = (rng.normal(size=(P, Q, T, m_sub)) * 0.2).astype(np.float32)
    mu = (rng.normal(size=(P, Q, T, m_sub)) * 0.05).astype(np.float32)
    idx = rng.integers(0, n_p, (P, Q, T, L)).astype(np.int32)
    lo = rng.integers(0, m_x - m_sub + 1, (P, T)).astype(np.int32)
    return ([torch.from_numpy(a) for a in (*x, y, mask, za, wa, mu, idx)],
            torch.from_numpy(lo))


def _tenant(a, t, axis):
    return a.select(axis, t).contiguous()


# ---------------------------------------------------------------------------
# the tenant axis: one call for T tenants == T calls, bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "sparse"])
@pytest.mark.parametrize("loss", ["hinge", "squared"])
@pytest.mark.parametrize("beta", [False, True], ids=["exact", "beta"])
def test_sdca_tenant_axis_equals_scalar_calls(sparse, loss, beta):
    rng = np.random.default_rng(21)
    args = _sdca_args(rng, sparse)
    fn = sdca_epoch_sparse if sparse else sdca_epoch
    lam, n = torch.from_numpy(LAMS), torch.from_numpy(NS)
    # beta = lam / t (D3CA's step-size variant at t = 4), per tenant;
    # squared needs a larger one to stay contractive
    bt = (lam / 4 * (40.0 if loss == "squared" else 1.0)) if beta else None
    da, wf = fn(*args, lam=lam, n=n, Q=Q, loss=loss, beta=bt)
    nx = len(args) - 5
    for t in range(T):
        one = [_tenant(a, t, 2) for a in args[:nx]] + \
              [_tenant(a, t, 1) for a in args[nx:]]
        da1, wf1 = fn(*one, lam=float(lam[t]), n=float(n[t]), Q=Q,
                      loss=loss, beta=None if bt is None else float(bt[t]))
        assert torch.equal(da[:, :, t], da1)
        assert torch.equal(wf[:, :, t], wf1)
    # a distinct lam in every cell: each cell == that cell alone
    lam_c = torch.from_numpy(rng.uniform(0.05, 0.9, (P, Q, T))
                             .astype(np.float32))
    da, wf = fn(*args, lam=lam_c, n=n, Q=Q, loss=loss, beta=bt)
    for p in range(P):
        for q in range(Q):
            for t in range(T):
                cell = [a[p, q, t] for a in args[:nx]] + \
                       [args[nx + i][p, t] for i in range(3)] + \
                       [args[nx + 3][q, t], args[nx + 4][p, t]]
                da1, wf1 = fn(*cell, lam=float(lam_c[p, q, t]),
                              n=float(n[t]), Q=Q, loss=loss,
                              beta=None if bt is None else float(bt[t]))
                assert torch.equal(da[p, q, t], da1)
                assert torch.equal(wf[p, q, t], wf1)


@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "sparse"])
@pytest.mark.parametrize("loss", ["hinge", "squared"])
def test_svrg_tenant_axis_equals_scalar_calls(sparse, loss):
    rng = np.random.default_rng(22)
    args, lo = _svrg_args(rng, sparse)
    fn = svrg_inner_sparse if sparse else svrg_inner
    lam = torch.from_numpy(LAMS)
    w = fn(*args, lam=lam, eta=0.03, loss=loss, lo=lo)
    nx = len(args) - 6
    axes = [2] * nx + [1, 1, 1, 2, 2, 2]
    for t in range(T):
        one = [_tenant(a, t, ax) for a, ax in zip(args, axes)]
        w1 = fn(*one, lam=float(lam[t]), eta=0.03, loss=loss,
                lo=_tenant(lo, t, 1))
        assert torch.equal(w[:, :, t], w1)
    lam_c = torch.from_numpy(rng.uniform(0.05, 0.9, (P, Q, T))
                             .astype(np.float32))
    eta_c = torch.from_numpy(rng.uniform(0.01, 0.05, (P, Q, T))
                             .astype(np.float32))
    w = fn(*args, lam=lam_c, eta=eta_c, loss=loss, lo=lo)
    for p in range(P):
        for q in range(Q):
            for t in range(T):
                cell = [a[p, q, t] for a in args[:nx]] + \
                       [args[nx + i][p, t] for i in range(3)] + \
                       [args[nx + 3 + i][p, q, t] for i in range(3)]
                w1 = fn(*cell, lam=float(lam_c[p, q, t]),
                        eta=float(eta_c[p, q, t]), loss=loss,
                        lo=int(lo[p, t]))
                assert torch.equal(w[p, q, t], w1)


def test_cell_order_and_params_layout():
    """c = (p*Q + q)*T + t; rows by p*T + t, w0 by q*T + t; the
    per-cell scalars one row per cell in that order."""
    cell, row, col = cell_index(P, Q, T, "cpu")
    for p in range(P):
        for q in range(Q):
            for t in range(T):
                c = (p * Q + q) * T + t
                assert (int(row[c]), int(col[c])) == (p * T + t, q * T + t)
    lam = torch.arange(T, dtype=torch.float32)
    params = cell_params((P, Q, T), "cpu", lam, 7.0)
    assert params.shape == (P * Q * T, 2) and params.is_contiguous()
    assert torch.equal(params[:, 0], (cell % T).float())
    assert torch.all(params[:, 1] == 7.0)


def test_tenant_axis_shapes_are_checked():
    rng = np.random.default_rng(23)
    args = _sdca_args(rng, False)
    bad = list(args)
    bad[4] = bad[4][:, :2]                      # w0 with 2 tenants of 3
    with pytest.raises(ValueError, match="w0 has shape"):
        sdca_epoch(*bad, lam=0.2, n=100, Q=Q)
    bad = list(args)
    bad[5] = bad[5][:, 0]                       # idx without its tenant axis
    with pytest.raises(ValueError, match="idx must be"):
        sdca_epoch(*bad, lam=0.2, n=100, Q=Q)
    sargs, lo = _svrg_args(rng, True)
    with pytest.raises(ValueError, match="lo has shape"):
        svrg_inner_sparse(*sargs, lam=0.1, eta=0.03, lo=lo[:, 0].contiguous())


# ---------------------------------------------------------------------------
# the plain versions in runtime mode == the Pallas kernels' runtime branch
# ---------------------------------------------------------------------------

def _one_cell_sdca(rng, sparse, n_p=17, m_q=9, k=7, steps=33):
    if sparse:
        x = _ell_cell(rng, n_p, m_q, k)
    else:
        x = (rng.normal(size=(n_p, m_q)).astype(np.float32),)
    y = _signs(rng, n_p)
    mask = np.ones(n_p, np.float32)
    mask[-2:] = 0.0
    a0 = (rng.uniform(0, 0.5, n_p) * (y > 0)).astype(np.float32)
    w0 = (rng.normal(size=m_q) * 0.1).astype(np.float32)
    idx = rng.integers(0, n_p, steps).astype(np.int32)
    return (*x, y, mask, a0, w0, idx)


@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "sparse"])
@pytest.mark.parametrize("loss", ["hinge", "squared"])
@pytest.mark.parametrize("beta", [None, 4.0])
def test_sdca_runtime_branch_matches_pallas(sparse, loss, beta):
    rng = np.random.default_rng(24)
    args = _one_cell_sdca(rng, sparse)
    lam, n = 0.15, 120.0
    pallas = sdca_epoch_sparse_pallas if sparse else sdca_epoch_pallas
    fn = sdca_epoch_sparse if sparse else sdca_epoch
    # jnp scalars are traced-type values: the kernel takes its runtime
    # branch (lam / n from the prefetch params, not constants)
    da_p, w_p = pallas(*map(jnp.asarray, args), lam=jnp.float32(lam),
                       n=jnp.float32(n), Q=3, loss=loss,
                       beta=None if beta is None else jnp.float32(beta),
                       interpret=True)
    da_t, w_t = fn(*map(torch.from_numpy, args), lam=torch.tensor(lam),
                   n=torch.tensor(n), Q=3, loss=loss,
                   beta=None if beta is None else torch.tensor(beta))
    np.testing.assert_allclose(da_t.numpy(), np.asarray(da_p), **TOL)
    np.testing.assert_allclose(w_t.numpy(), np.asarray(w_p).reshape(-1),
                               **TOL)


@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "sparse"])
@pytest.mark.parametrize("loss", ["hinge", "squared"])
def test_svrg_runtime_branch_matches_pallas(sparse, loss):
    rng = np.random.default_rng(25)
    n_p, m_x, m_sub, k, L, lo = 16, 24, 8, 6, 20, 8
    if sparse:
        x = _ell_cell(rng, n_p, m_x, k)
    else:
        x = (rng.normal(size=(n_p, m_x)).astype(np.float32),)
    y = _signs(rng, n_p)
    mask = np.ones(n_p, np.float32)
    mask[-2:] = 0.0
    za = rng.normal(size=n_p).astype(np.float32)
    wa = (rng.normal(size=m_sub) * 0.2).astype(np.float32)
    mu = (rng.normal(size=m_sub) * 0.05).astype(np.float32)
    idx = rng.integers(0, n_p, L).astype(np.int32)
    args = (*x, y, mask, za, wa, mu, idx)
    lam, eta = 0.1, 0.03
    if sparse:
        w_p = svrg_inner_sparse_pallas(*map(jnp.asarray, args),
                                       lam=jnp.float32(lam), eta=eta, lo=lo,
                                       loss=loss, interpret=True)
    else:
        # the dense Pallas kernel takes the window cut out of the block
        x_sub = x[0][:, lo:lo + m_sub]
        w_p = svrg_inner_pallas(*map(jnp.asarray, (x_sub, *args[1:])),
                                lam=jnp.float32(lam), eta=eta, loss=loss,
                                interpret=True)
    fn = svrg_inner_sparse if sparse else svrg_inner
    w_t = fn(*map(torch.from_numpy, args), lam=torch.tensor(lam), eta=eta,
             loss=loss, lo=lo)
    np.testing.assert_allclose(w_t.numpy(), np.asarray(w_p).reshape(-1),
                               **TOL)

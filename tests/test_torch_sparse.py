"""The sparse (padded-ELL) slice of the port vs the reference (CPU): CSR
containers and the LIBSVM reader, the ELL partition and its gather /
scatter, the plain versions of the two sparse kernels vs the reference's
Pallas kernels in interpret mode, the sparse local solvers, and D3CA /
RADiSA with ``block_format="sparse"`` per iteration vs the reference's
``engine="simulated"`` -- plus sparse == dense inside the port and a
sparse solve that never densifies.  SFK is in ``test_torch_sfk.py``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import D3CAConfig as JD3CA
from repro.core import RADiSAConfig as JRADiSA
from repro.core import get_solver as j_get_solver
from repro.core import partition_sparse as j_partition_sparse
from repro.core.local import local_sdca_sparse as j_local_sdca_sparse
from repro.core.local import local_svrg_sparse as j_local_svrg_sparse
from repro.core.losses import get_loss as j_get_loss
from repro.core.partition import ell_gather as j_ell_gather
from repro.core.partition import ell_scatter_add as j_ell_scatter_add
from repro.data import csr_from_dense as j_csr_from_dense
from repro.data import load_libsvm_csr as j_load_libsvm_csr
from repro.data import make_sparse_svm_csr as j_make_sparse_svm_csr
from repro.kernels.sdca import sdca_epoch_sparse_pallas
from repro.kernels.svrg import svrg_inner_sparse_pallas
from repro_torch import convert
from repro_torch.core import (D3CAConfig, RADiSAConfig, SparseDoublyPartitioned,
                              ell_gather, ell_scatter_add, get_solver,
                              partition, partition_sparse)
from repro_torch.core.local import (local_sdca, local_sdca_sparse, local_svrg,
                                    local_svrg_sparse)
from repro_torch.core.losses import get_loss
from repro_torch.data import (CSRMatrix, csr_from_dense, load_libsvm,
                              load_libsvm_csr, make_sparse_svm_csr,
                              make_sparse_svm_data, save_libsvm)
from repro_torch.kernels.sdca import sdca_epoch_sparse, sdca_epoch_sparse_plain
from repro_torch.kernels.svrg import (svrg_inner_sparse,
                                      svrg_inner_sparse_plain)
from repro_torch.launch import optimize
from test_torch_common import (ITERS, TOL, collect, compare, d3ca_source,
                               make_problem, radisa_source)

EDGE = (4, 2)           # the edge instance's grid: m = 41 pads to 48


def _instance():
    """The reference's edge instance (``tests/test_sparse.py``): 120 x 41
    at 15% density; P*Q = 8 does not divide m = 41 (pads to m_q = 24),
    and zeroing columns 24+ leaves feature block q = 1 entirely zero."""
    X, y = make_sparse_svm_data(120, 41, density=0.15, seed=7)
    X[:, 24:] = 0.0
    return X, y


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# host side: CSR, LIBSVM, the ELL partition
# ---------------------------------------------------------------------------

def _same_csr(a, b):
    assert tuple(a.shape) == tuple(b.shape)
    for f in ("indptr", "indices", "data"):
        x, y = getattr(a, f), np.asarray(getattr(b, f))
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x, y)


def test_csr_containers_bit_identical_to_reference():
    X, _ = _instance()
    _same_csr(csr_from_dense(X), j_csr_from_dense(X))
    c_t, y_t = make_sparse_svm_csr(300, 80, density=0.05, seed=3)
    c_j, y_j = j_make_sparse_svm_csr(300, 80, density=0.05, seed=3)
    _same_csr(c_t, c_j)
    np.testing.assert_array_equal(y_t, y_j)
    assert c_t.nnz == c_j.nnz and c_t.density == c_j.density
    np.testing.assert_array_equal(c_t.toarray(), c_j.toarray())


def test_csr_products_on_torch_tensors():
    X, _ = _instance()
    csr = csr_from_dense(X)
    rng = np.random.default_rng(23)
    w = rng.normal(size=X.shape[1]).astype(np.float32)
    a = rng.normal(size=X.shape[0]).astype(np.float32)
    got_w, got_a = csr @ torch.from_numpy(w), csr.T @ torch.from_numpy(a)
    assert isinstance(got_w, torch.Tensor) and got_w.dtype == torch.float32
    assert csr.T.shape == (41, 120)
    np.testing.assert_allclose(got_w.numpy(), X @ w, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got_a.numpy(), X.T @ a, rtol=1e-4, atol=1e-4)
    # the device copy is made once per device and reused
    assert csr._device_coo(torch.device("cpu")) is \
        csr._device_coo(torch.device("cpu"))


def test_libsvm_reader_bit_identical_to_reference(tmp_path):
    X, y = _instance()
    path = tmp_path / "inst.svm"
    save_libsvm(str(path), X, y)
    c_t, y_t = load_libsvm_csr(str(path))
    c_j, y_j = j_load_libsvm_csr(str(path))
    _same_csr(c_t, c_j)
    np.testing.assert_array_equal(y_t, y_j)
    Xd, yd = load_libsvm(str(path))
    np.testing.assert_array_equal(Xd, c_t.toarray())
    # 0-based indices and a column given twice in one line
    raw = tmp_path / "dup.svm"
    raw.write_text("+1 0:1.5 3:2 3:-0.5\n-1 2:4\n\n1 1:1\n")
    c_t, y_t = load_libsvm_csr(str(raw), n_features=6)
    c_j, y_j = j_load_libsvm_csr(str(raw), n_features=6)
    _same_csr(c_t, c_j)
    np.testing.assert_array_equal(y_t, [1.0, -1.0, 1.0])


@pytest.mark.parametrize("k_multiple", [1, 8, 32])
@pytest.mark.parametrize("as_csr", [False, True])
def test_partition_sparse_matches_reference(k_multiple, as_csr):
    X, y = _instance()
    src = csr_from_dense(X) if as_csr else X
    jsrc = j_csr_from_dense(X) if as_csr else X
    sp = partition_sparse(src, y, *EDGE, m_multiple=8, k_multiple=k_multiple,
                          device="cpu")
    jp = j_partition_sparse(jsrc, y, *EDGE, m_multiple=8,
                            k_multiple=k_multiple)
    assert isinstance(sp, SparseDoublyPartitioned)
    assert (sp.n, sp.m, sp.m_q, sp.P, sp.Q, sp.n_p, sp.k) == (
        jp.n, jp.m, jp.m_q, jp.P, jp.Q, jp.n_p, jp.k)
    assert sp.cols.dtype == torch.int32 and sp.device == torch.device("cpu")
    for mine, ref in ((sp.cols, jp.cols), (sp.vals, jp.vals),
                      (sp.y_blocks, jp.y_blocks), (sp.mask, jp.mask)):
        np.testing.assert_array_equal(mine.numpy(), np.asarray(ref))
    # the same logical blocks as the dense partition
    dn = partition(X, y, *EDGE, m_multiple=8, device="cpu")
    Xs, ys = sp.dense()
    np.testing.assert_array_equal(Xs, dn.dense()[0].numpy())
    np.testing.assert_array_equal(ys, y)


def test_ell_gather_and_scatter_match_reference():
    X, y = _instance()
    sp = partition_sparse(X, y, *EDGE, m_multiple=8, device="cpu")
    jp = j_partition_sparse(X, y, *EDGE, m_multiple=8)
    rng = np.random.default_rng(4)
    w = rng.normal(size=(EDGE[1], sp.m_q)).astype(np.float32)
    coef = rng.normal(size=(EDGE[0], sp.n_p)).astype(np.float32)
    z = ell_gather(_t(w), sp.cols, sp.vals)
    g = ell_scatter_add(sp.m_q, sp.cols, sp.vals, _t(coef)[:, None, :])
    assert z.shape == (*EDGE, sp.n_p) and g.shape == (*EDGE, sp.m_q)
    for p in range(EDGE[0]):
        for q in range(EDGE[1]):
            np.testing.assert_allclose(
                z[p, q].numpy(), np.asarray(j_ell_gather(
                    jnp.asarray(w[q]), jp.cols[p, q], jp.vals[p, q])),
                **TOL)
            np.testing.assert_allclose(
                g[p, q].numpy(), np.asarray(j_ell_scatter_add(
                    sp.m_q, jp.cols[p, q], jp.vals[p, q],
                    jnp.asarray(coef[p]))), **TOL)
    # feature block q = 1 is empty: nothing gathered, nothing scattered
    assert not z[:, 1].any() and not g[:, 1].any()


# ---------------------------------------------------------------------------
# the two sparse kernels' plain versions vs the Pallas kernels (interpret)
# ---------------------------------------------------------------------------

def _ell_cell(rng, n_p, m_q, k, zero=False):
    """One (n_p, k) ELL cell: a random number of distinct sorted columns
    per row, padding slots (col 0, val 0), row 0 holding a real entry at
    column 0 beside its col-0 padding; ``zero`` makes an all-zero
    feature block (every slot padding)."""
    cols = np.zeros((n_p, k), np.int32)
    vals = np.zeros((n_p, k), np.float32)
    if zero:
        return cols, vals
    for i in range(n_p):
        r = int(rng.integers(1, min(k, m_q) + 1))
        if i == 0:
            r = min(r, k - 1) if k > 1 else 1
            c = np.r_[0, rng.choice(np.arange(1, m_q), size=r - 1,
                                    replace=False)] if r > 1 else [0]
        else:
            c = rng.choice(m_q, size=r, replace=False)
        cols[i, :r] = np.sort(c)
        vals[i, :r] = rng.normal(size=r)
    return cols, vals


def _sdca_sparse_inputs(rng, n_p, m_q, k, steps, zero=False):
    cols, vals = _ell_cell(rng, n_p, m_q, k, zero)
    y = np.where(rng.random(n_p) < 0.5, -1.0, 1.0).astype(np.float32)
    mask = np.ones(n_p, np.float32)
    mask[-2:] = 0.0                                  # masked tail
    a0 = (rng.uniform(0, 0.5, n_p) * (y > 0)).astype(np.float32)
    w0 = (rng.normal(size=m_q) * 0.1).astype(np.float32)
    idx = rng.integers(0, n_p, steps).astype(np.int32)
    return cols, vals, y, mask, a0, w0, idx


def _svrg_sparse_inputs(rng, n_p, m_q, m_sub, k, L, zero=False):
    cols, vals = _ell_cell(rng, n_p, m_q, k, zero)
    y = np.where(rng.random(n_p) < 0.5, -1.0, 1.0).astype(np.float32)
    mask = np.ones(n_p, np.float32)
    mask[-2:] = 0.0
    za = rng.normal(size=n_p).astype(np.float32)
    wa = (rng.normal(size=m_sub) * 0.2).astype(np.float32)
    mu = (rng.normal(size=m_sub) * 0.05).astype(np.float32)
    idx = rng.integers(0, n_p, L).astype(np.int32)
    return cols, vals, y, mask, za, wa, mu, idx


# (n_p, m_q, k, steps): k = 3, 5, 7, 40 -- none a multiple of 32
SDCA_SWEEP = [(8, 8, 3, 8, False), (24, 16, 5, 50, False),
              (64, 128, 40, 64, False), (17, 9, 7, 33, False),
              (17, 9, 7, 33, True)]


@pytest.mark.parametrize("n_p,m_q,k,steps,zero", SDCA_SWEEP)
@pytest.mark.parametrize("loss", ["hinge", "squared"])
@pytest.mark.parametrize("beta", [None, "k"])
def test_sdca_sparse_plain_vs_pallas(n_p, m_q, k, steps, zero, loss, beta):
    rng = np.random.default_rng(7)
    args = _sdca_sparse_inputs(rng, n_p, m_q, k, steps, zero)
    # beta ~ ||x_i||^2 keeps the step-size-variant recursion contractive
    kw = dict(lam=0.2, n=200, Q=3, loss=loss,
              beta=float(k) if beta else None)
    da_p, w_p = sdca_epoch_sparse_pallas(*map(jnp.asarray, args), **kw)
    da_t, w_t = sdca_epoch_sparse(*map(_t, args), **kw)
    np.testing.assert_allclose(da_t.numpy(), np.asarray(da_p), **TOL)
    np.testing.assert_allclose(w_t.numpy(), np.asarray(w_p), **TOL)
    assert not da_t[-2:].any()                       # masked rows stay


# (n_p, m_q, m_sub, k, L, lo): the whole block (lo None), an aligned
# window (8), a misaligned one (5), an all-zero feature block
SVRG_SWEEP = [(16, 24, 24, 6, 20, None, False), (16, 24, 8, 6, 20, 8, False),
              (40, 32, 32, 9, 64, None, False), (13, 15, 5, 5, 11, 5, False),
              (13, 15, 5, 5, 11, 10, True)]


@pytest.mark.parametrize("n_p,m_q,m_sub,k,L,lo,zero", SVRG_SWEEP)
@pytest.mark.parametrize("loss", ["hinge", "squared"])
def test_svrg_sparse_plain_vs_pallas(n_p, m_q, m_sub, k, L, lo, zero, loss):
    rng = np.random.default_rng(8)
    args = _svrg_sparse_inputs(rng, n_p, m_q, m_sub, k, L, zero)
    kw = dict(lam=0.1, eta=0.03, loss=loss)
    w_p = svrg_inner_sparse_pallas(*map(jnp.asarray, args), lo=lo or 0, **kw)
    w_t = svrg_inner_sparse(*map(_t, args), lo=lo, **kw)
    np.testing.assert_allclose(w_t.numpy(), np.asarray(w_p), **TOL)
    if zero:       # no entry in the window: only the dense part moves w
        wa, mu = args[5], args[6]
        want = wa.copy()
        for _ in range(L):
            want = want - 0.03 * (0.0 + mu + 0.1 * (want - wa))
        np.testing.assert_allclose(w_t.numpy(), want, **TOL)


@pytest.mark.parametrize("loss", ["hinge", "squared"])
def test_sparse_kernels_batched_equal_per_cell(loss):
    """One batched call over a 3 x 2 grid == one call per cell, bit for
    bit; y / mask / alpha0 / z / idx of SDCA follow p, w0 follows q."""
    rng = np.random.default_rng(11)
    P, Q, n_p, m_q, k, steps, m_sub = 3, 2, 17, 12, 5, 33, 4
    cells = [[_ell_cell(rng, n_p, m_q, k, zero=(p, q) == (1, 1))
              for q in range(Q)] for p in range(P)]
    cols = _t(np.stack([np.stack([c[0] for c in row]) for row in cells]))
    vals = _t(np.stack([np.stack([c[1] for c in row]) for row in cells]))
    rows = [_sdca_sparse_inputs(rng, n_p, m_q, k, steps) for _ in range(P)]
    y, mask, a0, idx = (_t(np.stack([r[j] for r in rows]))
                        for j in (2, 3, 4, 6))
    w0 = _t((rng.normal(size=(Q, m_q)) * 0.1).astype(np.float32))
    kw = dict(lam=0.2, n=200, Q=Q, loss=loss)
    da, wf = sdca_epoch_sparse(cols, vals, y, mask, a0, w0, idx, **kw)
    assert da.shape == (P, Q, n_p) and wf.shape == (P, Q, m_q)
    za = _t(rng.normal(size=(P, n_p)).astype(np.float32))
    wa = _t((rng.normal(size=(P, Q, m_sub)) * 0.2).astype(np.float32))
    mu = _t((rng.normal(size=(P, Q, m_sub)) * 0.05).astype(np.float32))
    sidx = _t(rng.integers(0, n_p, (P, Q, 11)).astype(np.int32))
    lo = torch.tensor([4, 8, 1], dtype=torch.int32)
    vkw = dict(lam=0.1, eta=0.03, loss=loss)
    w = svrg_inner_sparse(cols, vals, y, mask, za, wa, mu, sidx, lo=lo, **vkw)
    for p in range(P):
        for q in range(Q):
            da1, wf1 = sdca_epoch_sparse(cols[p, q], vals[p, q], y[p],
                                         mask[p], a0[p], w0[q], idx[p], **kw)
            assert torch.equal(da[p, q], da1) and torch.equal(wf[p, q], wf1)
            w1 = svrg_inner_sparse(cols[p, q], vals[p, q], y[p], mask[p],
                                   za[p], wa[p, q], mu[p, q], sidx[p, q],
                                   lo=int(lo[p]), **vkw)
            assert torch.equal(w[p, q], w1)
    assert torch.equal(wf[1, 1], w0[1])          # the empty cell's w stays


def test_sparse_wrappers_check_their_arguments():
    rng = np.random.default_rng(13)
    args = list(map(_t, _sdca_sparse_inputs(rng, 8, 8, 3, 8)))
    kw = dict(lam=0.2, n=200, Q=3)
    with pytest.raises(NotImplementedError, match="local_backend='ref'"):
        sdca_epoch_sparse(*args, loss="logistic", **kw)
    bad = list(args)
    bad[0] = bad[0].long()                       # cols must be int32
    with pytest.raises(TypeError, match="cols"):
        sdca_epoch_sparse(*bad, **kw)
    bad = list(args)
    bad[1] = bad[1].t().contiguous().t()         # vals must be contiguous
    with pytest.raises(ValueError, match="contiguous"):
        sdca_epoch_sparse(*bad, **kw)
    sargs = list(map(_t, _svrg_sparse_inputs(rng, 16, 24, 8, 6, 20)))
    with pytest.raises(NotImplementedError, match="local_backend='ref'"):
        svrg_inner_sparse(*sargs, lam=0.1, eta=0.03, loss="logistic")
    with pytest.raises(ValueError, match="mu has shape"):
        svrg_inner_sparse(*sargs[:6], sargs[6][:3], sargs[7], lam=0.1,
                          eta=0.03)
    before = (sdca_epoch_sparse.launches, svrg_inner_sparse.launches)
    sdca_epoch_sparse(*args, **kw)
    svrg_inner_sparse(*sargs, lam=0.1, eta=0.03, lo=8)
    # CPU calls launch nothing
    assert (sdca_epoch_sparse.launches, svrg_inner_sparse.launches) == before
    assert sdca_epoch_sparse_plain is not sdca_epoch_sparse
    assert svrg_inner_sparse_plain is not svrg_inner_sparse


# ---------------------------------------------------------------------------
# sparse local solvers: vs the reference (ref and pallas), vs dense
# ---------------------------------------------------------------------------

def _one_cell(X, y):
    """P = Q = 1: the single ELL cell covers the whole (unpadded) matrix,
    so the dense local solvers are directly comparable."""
    sp = partition_sparse(X, y, 1, 1, k_multiple=8, device="cpu")
    assert sp.m_q == X.shape[1]
    return sp


@pytest.mark.parametrize("loss_name", ["hinge", "squared"])
@pytest.mark.parametrize("step_mode", ["exact", "beta"])
def test_local_sdca_sparse_matches_reference(loss_name, step_mode):
    X, y = _instance()
    sp = _one_cell(X, y)
    rng = np.random.default_rng(23)
    mask = np.ones(sp.n_p, np.float32)
    mask[-3:] = 0.0
    a0 = np.zeros(sp.n_p, np.float32)
    w0 = (rng.normal(size=sp.m_q) * 0.1).astype(np.float32)
    key = jax.random.PRNGKey(5)
    idx = np.asarray(jax.random.randint(key, (48,), 0, sp.n_p), np.int32)
    jkw = dict(lam=0.2, n=200, Q=3, steps=48, key=key, step_mode=step_mode,
               beta=float(sp.m_q))
    jargs = (j_get_loss(loss_name), *map(jnp.asarray, (
        sp.cols[0, 0].numpy(), sp.vals[0, 0].numpy(),
        sp.y_blocks[0].numpy(), mask, a0, w0)))
    want_ref = np.asarray(j_local_sdca_sparse(*jargs, backend="ref", **jkw))
    want_pal = np.asarray(j_local_sdca_sparse(*jargs, backend="pallas",
                                              **jkw))
    kw = dict(lam=0.2, n=200, Q=3, idx=_t(idx)[None], step_mode=step_mode,
              beta=float(sp.m_q))
    cell = (get_loss(loss_name), sp.cols, sp.vals, sp.y_blocks,
            _t(mask)[None], _t(a0)[None], _t(w0)[None])
    for backend in ("kernel", "ref"):
        got = local_sdca_sparse(*cell, backend=backend, **kw)[0, 0].numpy()
        np.testing.assert_allclose(got, want_ref, **TOL)
        np.testing.assert_allclose(got, want_pal, **TOL)
        assert not got[-3:].any()
    dense = local_sdca(get_loss(loss_name), _t(X)[None, None], *cell[3:],
                       backend="ref", **kw)[0, 0].numpy()
    np.testing.assert_allclose(got, dense, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("loss_name", ["hinge", "squared"])
@pytest.mark.parametrize("lo", [None, 8, 5])
def test_local_svrg_sparse_matches_reference(loss_name, lo):
    X, y = _instance()
    sp = _one_cell(X, y)
    rng = np.random.default_rng(29)
    mask = np.ones(sp.n_p, np.float32)
    m_sub = sp.m_q if lo is None else 8
    wa = (rng.normal(size=m_sub) * 0.2).astype(np.float32)
    za = (rng.normal(size=sp.n_p) * 0.3).astype(np.float32)
    mu = (rng.normal(size=m_sub) * 0.05).astype(np.float32)
    key = jax.random.PRNGKey(9)
    idx = np.asarray(jax.random.randint(key, (32,), 0, sp.n_p), np.int32)
    jargs = (j_get_loss(loss_name), *map(jnp.asarray, (
        sp.cols[0, 0].numpy(), sp.vals[0, 0].numpy(),
        sp.y_blocks[0].numpy(), mask, za, wa, mu)))
    jkw = dict(lam=0.1, L=32, eta=0.03, key=key, lo=lo)
    want_ref = np.asarray(j_local_svrg_sparse(*jargs, backend="ref", **jkw))
    want_pal = np.asarray(j_local_svrg_sparse(*jargs, backend="pallas",
                                              **jkw))
    lo_t = None if lo is None else torch.tensor([lo], dtype=torch.int32)
    kw = dict(lam=0.1, eta=0.03, idx=_t(idx)[None, None], lo=lo_t)
    cell = (sp.y_blocks, _t(mask)[None], _t(za)[None], _t(wa)[None, None],
            _t(mu)[None, None])
    for backend in ("kernel", "ref"):
        got = local_svrg_sparse(get_loss(loss_name), sp.cols, sp.vals, *cell,
                                backend=backend, **kw)[0, 0].numpy()
        np.testing.assert_allclose(got, want_ref, **TOL)
        np.testing.assert_allclose(got, want_pal, **TOL)
    dense = local_svrg(get_loss(loss_name), _t(X)[None, None], *cell,
                       backend="ref", **kw)[0, 0].numpy()
    np.testing.assert_allclose(got, dense, rtol=1e-4, atol=1e-4)


def test_local_sparse_logistic_needs_the_ref_backend():
    X, y = _instance()
    sp = _one_cell(X, y)
    ones, zeros = torch.ones(1, sp.n_p), torch.zeros(1, sp.n_p)
    w0 = torch.zeros(1, sp.m_q)
    idx = torch.zeros((1, 4), dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="local_backend='ref'"):
        local_sdca_sparse(get_loss("logistic"), sp.cols, sp.vals,
                          sp.y_blocks, ones, zeros, w0, lam=0.1, n=120, Q=1,
                          idx=idx)
    d = local_sdca_sparse(get_loss("logistic"), sp.cols, sp.vals,
                          sp.y_blocks, ones, zeros, w0, lam=0.1, n=120, Q=1,
                          idx=idx, backend="ref")
    assert torch.isfinite(d).all() and d.abs().sum() > 0


# ---------------------------------------------------------------------------
# the solvers, per iteration, vs the reference's simulated engine
# ---------------------------------------------------------------------------

def _problems():
    X, y = _instance()
    Xd, yd = make_problem(200, 60, seed=1)
    return {"edge": (X, y, EDGE), "dense200": (Xd, yd, (3, 2))}


@pytest.mark.parametrize("inst", ["edge", "dense200"])
@pytest.mark.parametrize("loss,step_mode", [("hinge", "exact"),
                                            ("hinge", "beta"),
                                            ("squared", "exact"),
                                            ("squared", "beta")])
def test_d3ca_sparse_matches_reference(inst, loss, step_mode):
    X, y, grid = _problems()[inst]
    # squared + beta: lam = 5 keeps that recursion contractive (see
    # test_torch_solver.py)
    lam = 5.0 if (loss, step_mode) == ("squared", "beta") else 0.05
    kw = dict(lam=lam, outer_iters=ITERS, step_mode=step_mode, seed=3)
    res_j, its_j = collect(
        j_get_solver("d3ca")(engine="simulated", local_backend="ref",
                             block_format="sparse"),
        loss, j_csr_from_dense(X), y, JD3CA(**kw), grid=grid)
    res_t, its_t = collect(
        get_solver("d3ca")(device="cpu", block_format="sparse",
                           index_source=d3ca_source(3, len(y), grid=grid)),
        loss, csr_from_dense(X), y, D3CAConfig(**kw), grid=grid)
    compare(res_t, its_t, res_j, its_j, dual=True)
    assert res_t.block_format == "sparse"


@pytest.mark.parametrize("inst", ["edge", "dense200"])
@pytest.mark.parametrize("variant,loss,backend", [
    ("block", "hinge", "kernel"), ("avg", "hinge", "kernel"),
    ("block", "squared", "ref")])
def test_radisa_sparse_matches_reference(inst, variant, loss, backend):
    X, y, grid = _problems()[inst]
    # eta * 2 ||x_j||^2 < 2 keeps the squared-loss SGD steps contractive
    gamma = 0.01 if loss == "squared" else 0.05
    kw = dict(lam=0.05, outer_iters=ITERS, variant=variant, gamma=gamma,
              seed=5)
    res_j, its_j = collect(
        j_get_solver("radisa")(engine="simulated", local_backend="ref",
                               block_format="sparse"),
        loss, j_csr_from_dense(X), y, JRADiSA(**kw), grid=grid)
    res_t, its_t = collect(
        get_solver("radisa")(device="cpu", block_format="sparse",
                             local_backend=backend,
                             index_source=radisa_source(5, len(y),
                                                        grid=grid)),
        loss, csr_from_dense(X), y, RADiSAConfig(**kw), grid=grid)
    compare(res_t, its_t, res_j, its_j, dual=False)


@pytest.mark.parametrize("name,cfg", [
    ("d3ca", D3CAConfig(lam=1.0, outer_iters=3, local_steps=12)),
    ("radisa", RADiSAConfig(lam=1.0, gamma=0.03, outer_iters=3, L=12)),
    ("radisa", RADiSAConfig(lam=1.0, gamma=0.03, outer_iters=2, L=12,
                            variant="avg")),
])
def test_sparse_matches_dense_in_the_port(name, cfg):
    X, y = _instance()
    base = get_solver(name)(device="cpu").solve(
        "hinge", X, y, P=4, Q=2, cfg=cfg, record_history=False)
    for backend in ("kernel", "ref"):
        for data in (csr_from_dense(X), X):     # CSR or dense input
            rs = get_solver(name)(device="cpu", local_backend=backend,
                                  block_format="sparse").solve(
                "hinge", data, y, P=4, Q=2, cfg=cfg, record_history=False)
            assert rs.block_format == "sparse"
            np.testing.assert_allclose(rs.w.numpy(), base.w.numpy(),
                                       rtol=2e-4, atol=2e-4)
            if base.alpha is not None:
                np.testing.assert_allclose(rs.alpha.numpy(),
                                           base.alpha.numpy(),
                                           rtol=2e-4, atol=2e-4)
    # block_format="dense" densifies a CSR input
    rd = get_solver(name)(device="cpu").solve(
        "hinge", csr_from_dense(X), y, P=4, Q=2, cfg=cfg,
        record_history=False)
    np.testing.assert_array_equal(rd.w.numpy(), base.w.numpy())


def test_block_format_knob_validation():
    with pytest.raises(ValueError, match="block_format"):
        get_solver("d3ca")(block_format="csc", device="cpu")


@pytest.mark.parametrize("solver", ["d3ca", "radisa", "sfk"])
def test_sparse_solve_never_densifies(solver, monkeypatch, capsys):
    """n * m = 40 M > 20 M at 0.1 % density: the CLI skips f* with the
    reference's note, and the solve runs with both densifying paths
    patched to raise."""
    def refuse(*a, **k):
        raise AssertionError("densified")
    monkeypatch.setattr(CSRMatrix, "toarray", refuse)
    monkeypatch.setattr(SparseDoublyPartitioned, "dense", refuse)
    summary = optimize.main([
        "--solver", solver, "--dataset", "sparse", "--block-format",
        "sparse", "--n", "2000", "--m", "20000", "--density", "1e-3",
        "--mesh", "2x2", "--iters", "1", "--lam", "1e-3", "--device",
        "cpu"])
    err = capsys.readouterr().err
    assert "skipping f* reference" in err and "2000x20000" in err
    assert summary["block_format"] == "sparse" and summary["rel_opt"] is None
    assert (summary["n"], summary["m"], summary["iters"]) == (2000, 20000, 1)
    assert np.isfinite(summary["objective"])


def test_sparse_partition_from_reference_feeds_the_port():
    X, y = _instance()
    jp = j_partition_sparse(X, y, *EDGE, m_multiple=8)
    data = convert.sparse_partition_from_reference(
        np.asarray(jp.cols), np.asarray(jp.vals), np.asarray(jp.y_blocks),
        np.asarray(jp.mask), jp.n, jp.m, jp.m_q, jp.P, jp.Q, device="cpu")
    own = partition_sparse(X, y, *EDGE, m_multiple=8, device="cpu")
    assert torch.equal(data.cols, own.cols) and torch.equal(data.vals,
                                                            own.vals)
    from repro_torch.core.d3ca import d3ca_simulated
    cfg = D3CAConfig(lam=0.05, outer_iters=2, seed=3)
    src = d3ca_source(3, 120, iters=2, grid=EDGE)
    w1, a1 = d3ca_simulated("hinge", data, cfg, index_source=src)
    w2, a2 = d3ca_simulated("hinge", own, cfg, index_source=src)
    assert torch.equal(w1, w2) and torch.equal(a1, a2)
    with pytest.raises(ValueError, match="expected"):
        convert.sparse_partition_from_reference(
            np.asarray(jp.cols), np.asarray(jp.vals),
            np.asarray(jp.y_blocks), np.asarray(jp.mask), jp.n, jp.m,
            jp.m_q, jp.Q, jp.P, device="cpu")

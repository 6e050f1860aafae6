"""Port vs reference: losses, objectives, partitioning (CPU)."""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import losses as jl
from repro.core import reference as jr
from repro.data import synthetic as jdata
from repro_torch.core import losses as tl
from repro_torch.core import reference as tr
from repro_torch.data import synthetic as tdata
from test_torch_common import make_problem, serial_perms

# the packages export a function called ``partition`` that hides the module
jp = importlib.import_module("repro.core.partition")
tp = importlib.import_module("repro_torch.core.partition")

LOSSES = ["hinge", "squared", "logistic"]
TOL = dict(rtol=1e-6, atol=1e-6)


def _samples(seed=0, k=257):
    rng = np.random.default_rng(seed)
    z = rng.normal(size=k).astype(np.float32) * 2
    y = np.where(rng.random(k) < 0.5, -1.0, 1.0).astype(np.float32)
    # feasible duals: a*y in [0, 1]
    a = (rng.uniform(0.02, 0.98, size=k) * y).astype(np.float32)
    x_sq = rng.uniform(0.5, 20.0, size=k).astype(np.float32)
    return z, y, a, x_sq


@pytest.mark.parametrize("loss", LOSSES)
def test_loss_value_grad_conj_bounds(loss):
    z, y, a, _ = _samples()
    J, T = jl.get_loss(loss), tl.get_loss(loss)
    tz, ty, ta = map(torch.from_numpy, (z, y, a))
    np.testing.assert_allclose(T.value(tz, ty).numpy(),
                               np.asarray(J.value(z, y)), **TOL)
    np.testing.assert_allclose(T.grad(tz, ty).numpy(),
                               np.asarray(J.grad(z, y)), **TOL)
    np.testing.assert_allclose(T.conj(ta, ty).numpy(),
                               np.asarray(J.conj(a, y)), **TOL)
    for got, want in zip(T.dual_bounds(ty), J.dual_bounds(jnp.asarray(y))):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("loss", LOSSES)
@pytest.mark.parametrize("beta", [None, 3.5])
def test_loss_sdca_delta(loss, beta):
    z, y, a, x_sq = _samples(1)
    # include padded rows (y = 0), which must stay finite
    y[:5] = 0.0
    a[:5] = 0.0
    J, T = jl.get_loss(loss), tl.get_loss(loss)
    kw = dict(lam=0.05, n=300, Q=3)
    want = J.sdca_delta(jnp.asarray(a), jnp.asarray(x_sq), jnp.asarray(z),
                        jnp.asarray(y), kw["lam"], kw["n"], kw["Q"],
                        beta=beta)
    got = T.sdca_delta(*map(torch.from_numpy, (a, x_sq, z, y)), kw["lam"],
                       kw["n"], kw["Q"], beta=beta)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("loss", LOSSES)
@pytest.mark.parametrize("masked", [False, True])
def test_objective_and_dual(loss, masked):
    X, y = make_problem(50, 13, seed=3)
    rng = np.random.default_rng(4)
    w = rng.normal(size=13).astype(np.float32) * 0.3
    a = (rng.uniform(0.05, 0.9, size=50) * y).astype(np.float32)
    mask = np.ones(50, np.float32)
    if masked:
        mask[-7:] = 0.0
    J, T = jl.get_loss(loss), tl.get_loss(loss)
    kw_j = dict(mask=jnp.asarray(mask)) if masked else {}
    kw_t = dict(mask=torch.from_numpy(mask)) if masked else {}
    tX, ty, tw, ta = map(torch.from_numpy, (X, y, w, a))
    np.testing.assert_allclose(
        float(T.objective(tX, ty, tw, 0.1, **kw_t)),
        float(J.objective(X, y, w, 0.1, **kw_j)), rtol=1e-6)
    np.testing.assert_allclose(
        float(T.dual_objective(tX, ty, ta, 0.1, **kw_t)),
        float(J.dual_objective(X, y, a, 0.1, **kw_j)), rtol=1e-5, atol=1e-6)
    if not masked:
        np.testing.assert_allclose(
            float(tr.duality_gap(loss, tX, ty, tw, ta, 0.1)),
            float(jr.duality_gap(loss, X, y, w, a, 0.1)), rtol=1e-5,
            atol=1e-6)
        np.testing.assert_allclose(
            float(tr.objective(loss, tX, ty, tw, 0.1)),
            float(jr.objective(loss, X, y, w, 0.1)), rtol=1e-6)


@pytest.mark.parametrize("n,m,P,Q,mult", [(200, 60, 3, 2, 6),
                                          (101, 37, 3, 2, 6),
                                          (101, 37, 3, 2, None),
                                          (64, 32, 4, 2, 8),
                                          (17, 5, 1, 1, None)])
def test_partition_identical(n, m, P, Q, mult):
    X, y = make_problem(n, m, seed=5)
    J = jp.partition(X, y, P, Q, m_multiple=mult)
    T = tp.partition(X, y, P, Q, m_multiple=mult, device="cpu")
    assert (T.n, T.m, T.P, T.Q, T.n_p, T.m_q) == (J.n, J.m, J.P, J.Q,
                                                 J.n_p, J.m_q)
    assert T.x_blocks.is_contiguous()
    np.testing.assert_array_equal(T.x_blocks.numpy(), np.asarray(J.x_blocks))
    np.testing.assert_array_equal(T.y_blocks.numpy(), np.asarray(J.y_blocks))
    np.testing.assert_array_equal(T.mask.numpy(), np.asarray(J.mask))
    Xd, yd = T.dense()
    np.testing.assert_array_equal(Xd.numpy(), X)
    np.testing.assert_array_equal(yd.numpy(), y)


def test_partition_round_trips_and_products():
    X, y = make_problem(101, 37, seed=6)
    J = jp.partition(X, y, 3, 2, m_multiple=6)
    T = tp.partition(X, y, 3, 2, m_multiple=6, device="cpu")
    rng = np.random.default_rng(7)
    w = rng.normal(size=37).astype(np.float32)
    a = rng.normal(size=101).astype(np.float32)
    wb, ab = T.w_to_blocks(w), T.alpha_to_blocks(a)
    np.testing.assert_array_equal(wb.numpy(), np.asarray(J.w_to_blocks(w)))
    np.testing.assert_array_equal(ab.numpy(),
                                  np.asarray(J.alpha_to_blocks(a)))
    np.testing.assert_array_equal(T.w_from_blocks(wb).numpy(), w)
    np.testing.assert_array_equal(T.alpha_from_blocks(ab).numpy(), a)
    # the blocked products are the einsums the reference's cells compute
    np.testing.assert_allclose(
        tp.rows_times_blocks(ab, T.x_blocks).numpy(),
        np.einsum("pn,pqnm->pqm", ab.numpy(), T.x_blocks.numpy()),
        rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        tp.blocks_times_cols(T.x_blocks, wb).numpy(),
        np.einsum("pqnm,qm->pqn", T.x_blocks.numpy(), wb.numpy()),
        rtol=1e-5, atol=1e-5)


def test_partition_rejects_bad_multiple():
    X, y = make_problem(10, 6)
    with pytest.raises(ValueError, match="m_multiple"):
        tp.partition(X, y, 2, 2, m_multiple=3, device="cpu")


@pytest.mark.parametrize("fn", ["make_svm_data", "make_sparse_svm_data"])
def test_synthetic_data_same_seed_same_data(fn):
    Xj, yj = getattr(jdata, fn)(40, 12, seed=3)
    Xt, yt = getattr(tdata, fn)(40, 12, seed=3)
    np.testing.assert_array_equal(Xt, Xj)
    np.testing.assert_array_equal(yt, yj)


def test_paper_config_copy_matches():
    from repro.configs import svm_paper as js
    from repro_torch.configs import svm_paper as ts
    assert ts.PART1 == [ts.SVMExperiment(*[getattr(e, f) for f in (
        "name", "P", "Q", "block_n", "block_m", "lam")]) for e in js.PART1]
    full = ts.PART1[-1]
    assert (full.P, full.Q, full.n, full.m) == (7, 4, 14000, 12000)
    assert ts.REAL_DATASETS == js.REAL_DATASETS


@pytest.mark.parametrize("loss", ["hinge", "squared"])
def test_serial_sdca_matches_reference(loss):
    X, y = make_problem(60, 11, seed=8)
    epochs = 5
    w_j, a_j = jr.serial_sdca(loss, X, y, lam=0.1, epochs=epochs, seed=2)
    w_t, a_t = tr.serial_sdca(loss, X, y, lam=0.1, epochs=epochs,
                              perms=serial_perms(2, epochs, 60),
                              device="cpu")
    np.testing.assert_allclose(w_t.numpy(), np.asarray(w_j), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(a_t.numpy(), np.asarray(a_j), rtol=1e-5,
                               atol=1e-5)


def test_serial_sdca_logistic_and_default_generator():
    X, y = make_problem(40, 7, seed=9)
    epochs = 3
    w_j, a_j = jr.serial_sdca("logistic", X, y, lam=0.1, epochs=epochs,
                              seed=1)
    w_t, a_t = tr.serial_sdca("logistic", X, y, lam=0.1, epochs=epochs,
                              perms=serial_perms(1, epochs, 40),
                              device="cpu")
    np.testing.assert_allclose(w_t.numpy(), np.asarray(w_j), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(a_t.numpy(), np.asarray(a_j), rtol=1e-4,
                               atol=1e-5)
    # default orders: reproducible from the seed, and they optimise
    w1, _ = tr.serial_sdca("hinge", X, y, lam=0.1, epochs=10, seed=4,
                           device="cpu")
    w2, _ = tr.serial_sdca("hinge", X, y, lam=0.1, epochs=10, seed=4,
                           device="cpu")
    assert torch.equal(w1, w2)
    tX, ty = torch.from_numpy(X), torch.from_numpy(y)
    f0 = float(tr.objective("hinge", tX, ty, torch.zeros(7), 0.1))
    assert float(tr.objective("hinge", tX, ty, w1, 0.1)) < f0
    assert tr.rel_opt(1.5, 1.0) == pytest.approx(0.5)

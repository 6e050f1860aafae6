"""Cell-local solvers of the port vs the reference's ``backend="ref"``
scans, with the reference's coordinate orders injected (CPU)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import local as jlocal
from repro.core.losses import get_loss as j_loss
from repro_torch.core import local as tlocal
from repro_torch.core.losses import get_loss as t_loss
import test_torch_common  # noqa: F401  (one torch thread a process)

P, Q, N_P, M_Q = 3, 2, 17, 12


def _grid(seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(P, Q, N_P, M_Q)).astype(np.float32)
    y = np.where(rng.random((P, N_P)) < 0.5, -1.0, 1.0).astype(np.float32)
    mask = np.ones((P, N_P), np.float32)
    mask[-1, -3:] = 0.0
    y[-1, -3:] = 0.0
    x[-1, :, -3:] = 0.0
    a0 = (rng.uniform(0, 0.5, (P, N_P)) * y).astype(np.float32)
    w0 = (rng.normal(size=(Q, M_Q)) * 0.1).astype(np.float32)
    return x, y, mask, a0, w0


@pytest.mark.parametrize("loss", ["hinge", "squared", "logistic"])
@pytest.mark.parametrize("step_mode", ["exact", "beta"])
def test_local_sdca_ref_matches_reference(loss, step_mode):
    x, y, mask, a0, w0 = _grid(0)
    steps, kw = 25, dict(lam=0.1, n=50, Q=Q, step_mode=step_mode, beta=11.0)
    keys = [jax.random.PRNGKey(100 + p) for p in range(P)]
    idx = np.stack([np.asarray(jax.random.randint(k, (steps,), 0, N_P))
                    for k in keys]).astype(np.int32)
    got = tlocal.local_sdca(t_loss(loss), *map(torch.from_numpy,
                                               (x, y, mask, a0, w0)),
                            idx=torch.from_numpy(idx), backend="ref", **kw)
    for p in range(P):
        for q in range(Q):
            want = jlocal.local_sdca(
                j_loss(loss), jnp.asarray(x[p, q]), jnp.asarray(y[p]),
                jnp.asarray(mask[p]), jnp.asarray(a0[p]), jnp.asarray(w0[q]),
                steps=steps, key=keys[p], backend="ref", **kw)
            np.testing.assert_allclose(got[p, q].numpy(), np.asarray(want),
                                       rtol=1e-5, atol=1e-5)
    # padded rows never move
    assert torch.all(got[-1, :, -3:] == 0)


@pytest.mark.parametrize("loss", ["hinge", "squared", "logistic"])
@pytest.mark.parametrize("windowed", [False, True])
def test_local_svrg_ref_matches_reference(loss, windowed):
    x, y, mask, _, w0 = _grid(1)
    rng = np.random.default_rng(2)
    L, m_sub = 21, (M_Q // P if windowed else M_Q)
    lo = np.array([8, 0, 4], np.int32) if windowed else None
    za = rng.normal(size=(P, N_P)).astype(np.float32)
    mu = (rng.normal(size=(Q, M_Q)) * 0.05).astype(np.float32)
    cols = (np.arange(m_sub)[None] + (lo[:, None] if windowed else 0))
    cols = np.broadcast_to(cols, (P, m_sub))
    wa = np.stack([w0[:, cols[p]] for p in range(P)])     # (P, Q, m_sub)
    mus = np.stack([mu[:, cols[p]] for p in range(P)])
    keys = [[jax.random.PRNGKey(7 * p + q) for q in range(Q)]
            for p in range(P)]
    idx = np.stack([np.stack([np.asarray(jax.random.randint(
        keys[p][q], (L,), 0, N_P)) for q in range(Q)])
        for p in range(P)]).astype(np.int32)
    kw = dict(lam=0.1, eta=0.03)
    got = tlocal.local_svrg(
        t_loss(loss), *map(torch.from_numpy, (x, y, mask, za, wa, mus)),
        idx=torch.from_numpy(idx),
        lo=torch.from_numpy(lo) if windowed else None, backend="ref", **kw)
    for p in range(P):
        for q in range(Q):
            want = jlocal.local_svrg(
                j_loss(loss), jnp.asarray(x[p, q]), jnp.asarray(y[p]),
                jnp.asarray(mask[p]), jnp.asarray(za[p]),
                jnp.asarray(wa[p, q]), jnp.asarray(mus[p, q]), L=L,
                key=keys[p][q], lo=int(lo[p]) if windowed else None,
                backend="ref", **kw)
            np.testing.assert_allclose(got[p, q].numpy(), np.asarray(want),
                                       rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("loss", ["hinge", "squared"])
@pytest.mark.parametrize("step_mode", ["exact", "beta"])
def test_local_sdca_kernel_on_cpu_equals_ref(loss, step_mode):
    x, y, mask, a0, w0 = map(torch.from_numpy, _grid(3))
    idx = torch.from_numpy(np.random.default_rng(4).integers(
        0, N_P, (P, 30)).astype(np.int32))
    kw = dict(lam=0.1, n=50, Q=Q, idx=idx, step_mode=step_mode, beta=11.0)
    ref = tlocal.local_sdca(t_loss(loss), x, y, mask, a0, w0, backend="ref",
                            **kw)
    ker = tlocal.local_sdca(t_loss(loss), x, y, mask, a0, w0,
                            backend="kernel", **kw)
    np.testing.assert_allclose(ker.numpy(), ref.numpy(), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("loss", ["hinge", "squared"])
def test_local_svrg_kernel_on_cpu_equals_ref(loss):
    x, y, mask, _, w0 = map(torch.from_numpy, _grid(5))
    rng = np.random.default_rng(6)
    m_sub = M_Q // P
    lo = torch.tensor([4, 8, 0], dtype=torch.int32)
    za = torch.from_numpy(rng.normal(size=(P, N_P)).astype(np.float32))
    wa = torch.from_numpy((rng.normal(size=(P, Q, m_sub)) * 0.2)
                          .astype(np.float32))
    mu = torch.from_numpy((rng.normal(size=(P, Q, m_sub)) * 0.05)
                          .astype(np.float32))
    idx = torch.from_numpy(rng.integers(0, N_P, (P, Q, 19)).astype(np.int32))
    kw = dict(lam=0.1, eta=0.03, idx=idx, lo=lo)
    ref = tlocal.local_svrg(t_loss(loss), x, y, mask, za, wa, mu,
                            backend="ref", **kw)
    ker = tlocal.local_svrg(t_loss(loss), x, y, mask, za, wa, mu,
                            backend="kernel", **kw)
    np.testing.assert_allclose(ker.numpy(), ref.numpy(), rtol=1e-6, atol=1e-6)


def test_kernel_backend_rejects_logistic_and_unknown_backend():
    x, y, mask, a0, w0 = map(torch.from_numpy, _grid(7))
    idx = torch.zeros((P, 4), dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="local_backend='ref'"):
        tlocal.local_sdca(t_loss("logistic"), x, y, mask, a0, w0, lam=0.1,
                          n=50, Q=Q, idx=idx, backend="kernel")
    with pytest.raises(NotImplementedError, match="local_backend='ref'"):
        tlocal.local_svrg(t_loss("logistic"), x, y, mask, a0,
                          w0[None].expand(P, Q, M_Q).contiguous(),
                          w0[None].expand(P, Q, M_Q).contiguous(), lam=0.1,
                          eta=0.1, idx=idx[:, None].expand(P, Q, 4),
                          backend="kernel")
    with pytest.raises(ValueError, match="unknown local backend"):
        tlocal.local_sdca(t_loss("hinge"), x, y, mask, a0, w0, lam=0.1,
                          n=50, Q=Q, idx=idx, backend="pallas")

"""Shared helpers of the port's parity tests (no tests of its own).

Inputs are made with ``numpy.random.default_rng`` and handed to both
packages.  The reference draws its coordinate orders with ``jax.random``;
the helpers here compute those exact streams with the reference's own
formulas so that the tests can inject them into the port through an
``ArrayIndexSource``.
"""
import signal

import jax
import numpy as np
import pytest

from repro_torch.core import ArrayIndexSource

#: seconds a test of a module that starts a CPU process grid is given, and
#: the grid's bound on each of its collectives and waits
MESH_TEST_LIMIT, MESH_GRID_TIMEOUT = 120, 60


@pytest.fixture
def bounded():
    """Fail a test that outlives MESH_TEST_LIMIT seconds (an alarm), so a
    hung process grid fails its test, never the whole run.  A module
    imports it and applies it with ``pytest.mark.usefixtures``."""
    def expire(signum, frame):
        raise TimeoutError(f"test exceeded {MESH_TEST_LIMIT} s")
    old = signal.signal(signal.SIGALRM, expire)
    signal.alarm(MESH_TEST_LIMIT)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, old)


def make_problem(n, m, seed=0):
    """A small dense classification problem, float32."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, m)).astype(np.float32)
    w = rng.normal(size=(m,))
    y = np.sign(X @ w + 0.3 * rng.normal(size=n)).astype(np.float32)
    y[y == 0] = 1.0
    return X, y


def d3ca_rows(seed, iters, P, n_p, steps):
    """{t: (P, steps) int32} -- ``randint(fold_in(fold_in(key0, t), p))``,
    the order D3CA's cells of row partition p use at outer iteration t."""
    key0 = jax.random.PRNGKey(seed)
    out = {}
    for t in range(1, iters + 1):
        key_t = jax.random.fold_in(key0, t)
        out[t] = np.stack([
            np.asarray(jax.random.randint(jax.random.fold_in(key_t, p),
                                          (steps,), 0, n_p))
            for p in range(P)]).astype(np.int32)
    return out


def radisa_streams(seed, iters, P, Q, n_p, L):
    """({t: (P,) perm}, {t: (P, Q, L) int32 rows}) -- RADiSA's shared
    sub-block permutation and per-cell minibatch orders."""
    key0 = jax.random.PRNGKey(seed)
    perms, rows = {}, {}
    for t in range(1, iters + 1):
        key_t = jax.random.fold_in(key0, t)
        perms[t] = np.asarray(jax.random.permutation(
            jax.random.fold_in(key_t, 0), P)).astype(np.int64)
        key_1 = jax.random.fold_in(key_t, 1)
        rows[t] = np.stack([
            np.stack([np.asarray(jax.random.randint(
                jax.random.fold_in(key_1, p * Q + q), (L,), 0, n_p))
                for q in range(Q)])
            for p in range(P)]).astype(np.int32)
    return perms, rows


def sfk_samples(seed, iters, P, n_p, frac):
    """{t: (P, n_p) float32 0/1} -- SFK's Bernoulli row sample,
    ``uniform(fold_in(fold_in(fold_in(key0, t), 2), p)) < frac``."""
    key0 = jax.random.PRNGKey(seed)
    out = {}
    for t in range(1, iters + 1):
        key_2 = jax.random.fold_in(jax.random.fold_in(key0, t), 2)
        out[t] = np.stack([
            np.asarray(jax.random.uniform(jax.random.fold_in(key_2, p),
                                          (n_p,)) < frac)
            for p in range(P)]).astype(np.float32)
    return out


def serial_perms(seed, epochs, n):
    """(epochs, n) -- the visiting orders of the reference's serial SDCA."""
    keys = jax.random.split(jax.random.PRNGKey(seed), epochs)
    return np.stack([np.asarray(jax.random.permutation(k, n))
                     for k in keys]).astype(np.int32)


# ---------------------------------------------------------------------------
# the solver-level comparison shared by the D3CA and RADiSA test files
# ---------------------------------------------------------------------------

P, Q, ITERS = 3, 2, 4
SIZES = [(200, 60), (101, 37)]          # dividing / non-dividing
TOL = dict(rtol=1e-5, atol=1e-5)


def ceil_div(a, k):
    return -(-a // k)


def collect(solver, loss, X, y, cfg, grid=(P, Q), **kw):
    """Solve and keep every iteration's (w, alpha)."""
    iterates = []

    def cb(t, w, alpha):
        iterates.append((np.array(w), None if alpha is None
                         else np.array(alpha)))
    res = solver.solve(loss, X, y, P=grid[0], Q=grid[1], cfg=cfg,
                       callback=cb, **kw)
    return res, iterates


def d3ca_source(seed, n, iters=ITERS, steps=None, grid=(P, Q)):
    n_p = ceil_div(n, grid[0])
    return ArrayIndexSource(sdca=d3ca_rows(seed, iters, grid[0], n_p,
                                           steps or n_p), device="cpu")


def radisa_source(seed, n, iters=ITERS, grid=(P, Q), L=None):
    n_p = ceil_div(n, grid[0])
    perms, rows = radisa_streams(seed, iters, *grid, n_p, L or n_p)
    return ArrayIndexSource(svrg=rows, perm=perms, device="cpu")


def sfk_source(seed, n, frac, iters=ITERS, grid=(P, Q), L=None):
    """SFK draws its permutation and minibatch orders as RADiSA does, plus
    the row sample."""
    n_p = ceil_div(n, grid[0])
    perms, rows = radisa_streams(seed, iters, *grid, n_p, L or n_p)
    return ArrayIndexSource(svrg=rows, perm=perms, sample=sfk_samples(
        seed, iters, grid[0], n_p, frac), device="cpu")


def compare(res_t, its_t, res_j, its_j, dual):
    assert res_t.iters == res_j.iters == len(its_t) == len(its_j)
    for (w_t, a_t), (w_j, a_j), h_t, h_j in zip(its_t, its_j, res_t.history,
                                               res_j.history):
        np.testing.assert_allclose(w_t, w_j, **TOL)
        assert h_t["iter"] == h_j["iter"]
        np.testing.assert_allclose(h_t["objective"], h_j["objective"],
                                   rtol=1e-6)
        if dual:
            np.testing.assert_allclose(a_t, a_j, **TOL)
            np.testing.assert_allclose(h_t["duality_gap"],
                                       h_j["duality_gap"], **TOL)


_LM_PAIRS = {}


def lm_pair(arch, **overrides):
    """(reference model, reference params, port model, port params) of
    ``reduced(get_config(arch))`` with float32 compute unless overridden,
    both on the CPU, the port's weights carried across from the
    reference's ``init(PRNGKey(0))``; cached per process so the
    reference's init compiles once per config.  ``n_experts=E``: the
    reduced MoE with E experts (each package's own ``MoEConfig``, top-2,
    as ``reduced`` makes it otherwise)."""
    from repro import models as ref_models
    from repro.configs import get_config as ref_get_config
    from repro.models.config import MoEConfig as RefMoEConfig
    from repro_torch import convert
    from repro_torch.configs import get_config
    from repro_torch.models import Transformer, reduced
    from repro_torch.models.config import MoEConfig
    key = (arch, tuple(sorted(overrides.items())))
    if key not in _LM_PAIRS:
        kw = {"compute_dtype": "float32", **overrides}
        rkw, pkw = dict(kw), dict(kw)
        E = kw.pop("n_experts", None)
        if E is not None:
            moe = dict(n_experts=E, top_k=2, chunk=8, capacity_factor=4.0)
            rkw = {**kw, "moe": RefMoEConfig(**moe)}
            pkw = {**kw, "moe": MoEConfig(**moe)}
        rmodel = ref_models.Transformer(
            ref_models.reduced(ref_get_config(arch), **rkw))
        rparams = jax.jit(lambda k: rmodel.init(k)[0])(jax.random.PRNGKey(0))
        pmodel = Transformer(reduced(get_config(arch), **pkw), device="cpu")
        pparams = convert.lm_params_from_reference(
            jax.tree.map(np.asarray, rparams), device="cpu")
        _LM_PAIRS[key] = (rmodel, rparams, pmodel, pparams)
    return _LM_PAIRS[key]

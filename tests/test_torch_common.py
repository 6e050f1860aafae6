"""Shared helpers of the port's parity tests (no tests of its own).

Inputs are made with ``numpy.random.default_rng`` and handed to both
packages.  The reference draws its coordinate orders with ``jax.random``;
the helpers here compute those exact streams with the reference's own
formulas so that the tests can inject them into the port through an
``ArrayIndexSource``.
"""
import jax
import numpy as np

from repro_torch.core import ArrayIndexSource


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


def collect(solver, loss, X, y, cfg, **kw):
    """Solve and keep every iteration's (w, alpha)."""
    iterates = []

    def cb(t, w, alpha):
        iterates.append((np.array(w), None if alpha is None
                         else np.array(alpha)))
    res = solver.solve(loss, X, y, P=P, Q=Q, cfg=cfg, callback=cb, **kw)
    return res, iterates


def d3ca_source(seed, n, iters=ITERS, steps=None):
    n_p = ceil_div(n, P)
    return ArrayIndexSource(sdca=d3ca_rows(seed, iters, P, n_p,
                                           steps or n_p))


def radisa_source(seed, n, iters=ITERS):
    n_p = ceil_div(n, P)
    perms, rows = radisa_streams(seed, iters, P, Q, n_p, n_p)
    return ArrayIndexSource(svrg=rows, perm=perms)


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

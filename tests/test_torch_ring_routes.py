"""The two solver routes redesigned for Hopper last, on the CPU: the dense
SVRG inner loop's ``"ring"`` route (``csrc/svrg_inner_ring.cu``: the
window in registers, rows by bulk copies into a ring) and the sparse SDCA
epoch's ``"lookahead"`` route (``csrc/sdca_epoch_sparse_ahead.cu``: the
gather of w D steps ahead of the dual step, the scatters it missed added
back through row overlaps).  Route choice and geometry are pure functions
of shape, tested at their boundaries; the plain versions are held against
the reference's Pallas kernels (interpret mode) at the layouts the new
routes take; and the recurrences the two kernels run -- the ring route's
dot pipelined one step through the identity, and the lookahead route's
order of scatters, stale gathers, overlaps and reduced sums, step for
step -- are emulated here in float32 and held against both.  The CUDA kernels are held
against the plain versions on the card by ``chip_smoke.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.sdca import sdca_epoch_sparse_pallas
from repro.kernels.svrg import svrg_inner_pallas
from repro_torch.kernels._launch import MAX_DYNAMIC_SMEM
from repro_torch.kernels.sdca import sdca_epoch_sparse, sdca_sparse_route
from repro_torch.kernels.sdca import sparse as sdca_sparse
from repro_torch.kernels.svrg import svrg_inner, svrg_route
from repro_torch.kernels.svrg import ops as svrg_ops

TOL = dict(rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# dense SVRG inner loop: the ring route
# ---------------------------------------------------------------------------

def _steps_at_smem_limit(m_sub):
    """The longest order whose indices still fit one ring CTA's shared
    memory beside the ring of rows of a window of ``m_sub``."""
    warps = svrg_ops.svrg_ring_warps(m_sub)
    e = svrg_ops.svrg_ring_per_thread(m_sub, warps)
    room = MAX_DYNAMIC_SMEM // 4 - svrg_ops.svrg_ring_smem(0, warps, e) // 4
    return room // 4 * 4


@pytest.mark.parametrize("m_sub,L,route", [
    (429, 2000, "ring"),                       # the RADiSA cells of Part 1
    (1, 0, "ring"), (5, 11, "ring"), (512, 100, "ring"), (513, 100, "ring"),
    (svrg_ops.RING_MAX_WINDOW, 2000, "ring"),  # the widest window
    (svrg_ops.RING_MAX_WINDOW + 1, 2000, "block"),
    (1715, 2000, "ring"),                      # RADiSA avg at Part 1 width
    (0, 10, "block"), (3003, 2000, "block"),
    (429, _steps_at_smem_limit(429), "ring"),
    (429, _steps_at_smem_limit(429) + 1, "block"),
    (2000, _steps_at_smem_limit(2000), "ring"),
    (2000, _steps_at_smem_limit(2000) + 1, "block")])
def test_svrg_route_boundaries(m_sub, L, route):
    assert svrg_route(m_sub, L) == route
    assert route in svrg_ops.ROUTES


@pytest.mark.parametrize("m_sub", [1, 5, 31, 33, 128, 429, 512, 513, 1000,
                                   1024, 1025, 2047, 2048])
def test_svrg_ring_geometry_covers_the_window(m_sub):
    """Warps from the width alone, out of the counts the kernel is
    compiled for; the columns a thread holds cover the window with the
    fewest the kernel is compiled for; the shared memory is the kernel's
    layout -- the order rounded up to 4 indices, then the ring's slots of
    a row (copied from the 16-byte boundary before the window) and three
    16-byte scalar chunks."""
    warps = svrg_ops.svrg_ring_warps(m_sub)
    assert warps in svrg_ops.RING_WARPS
    e = svrg_ops.svrg_ring_per_thread(m_sub, warps)
    assert e in svrg_ops.RING_PER_THREAD
    assert m_sub <= 32 * warps * e
    fewer = [v for v in svrg_ops.RING_PER_THREAD if v < e]
    assert not fewer or m_sub > 32 * warps * fewer[-1]
    nt = 32 * warps
    assert svrg_ops.svrg_ring_smem(2000, warps, e) == \
        4 * (2000 + svrg_ops.RING_SLOTS * (nt * e + 8 + 12))
    assert svrg_ops.svrg_ring_smem(3, warps, e) == \
        svrg_ops.svrg_ring_smem(4, warps, e)
    # a window starting 12 bytes past a boundary, rounded up to 16 bytes,
    # fits its slot
    assert (3 + m_sub + 3) // 4 * 4 <= nt * e + 8
    # the main path's windows take one warp; a wider window never fewer
    assert svrg_ops.svrg_ring_warps(429) == 1
    assert svrg_ops.svrg_ring_warps(m_sub + 1) >= warps


def _svrg_cell(rng, n_p, m_x, m_sub, L):
    x = (rng.normal(size=(n_p, m_x)) / np.sqrt(m_sub)).astype(np.float32)
    y = np.where(rng.random(n_p) < 0.5, -1.0, 1.0).astype(np.float32)
    mask = np.ones(n_p, np.float32)
    mask[-2:] = 0.0
    za = rng.normal(size=n_p).astype(np.float32)
    wa = (rng.normal(size=m_sub) * 0.2).astype(np.float32)
    mu = (rng.normal(size=m_sub) * 0.05).astype(np.float32)
    idx = rng.integers(0, n_p, L).astype(np.int32)
    # a row twice in a row, three times, 4 and 5 steps apart; the masked
    # rows visited
    for h, back in ((5, 1), (9, 1), (10, 2), (20, 4), (31, 5)):
        if h < L:
            idx[h] = idx[h - back]
    idx[3::11] = n_p - 1
    return x, y, mask, za, wa, mu, idx


@pytest.mark.parametrize("n_p,m_x,m_sub,L,lo", [
    (16, 20, 13, 40, 1), (24, 110, 100, 36, 7), (20, 440, 429, 24, 5),
    (12, 33, 33, 12, 0)])
@pytest.mark.parametrize("loss", ["hinge", "squared"])
def test_svrg_ring_layout_plain_vs_pallas(n_p, m_x, m_sub, L, lo, loss):
    """The ring route's layouts -- windows that start off a 16-byte
    boundary, widths that divide by no thread count, masked and repeated
    rows -- through the port's wrapper on the CPU (its plain version)
    against the reference's Pallas kernel in interpret mode on the cut
    window."""
    assert svrg_route(m_sub, L) == "ring"
    x, *rest = _svrg_cell(np.random.default_rng(m_sub + L), n_p, m_x, m_sub,
                          L)
    kw = dict(lam=0.1, eta=0.03, loss=loss)
    want = svrg_inner_pallas(jnp.asarray(x[:, lo:lo + m_sub]),
                             *map(jnp.asarray, rest), **kw)
    got = svrg_inner(*(torch.from_numpy(a) for a in (x, *rest)), lo=lo, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_svrg_cpu_calls_count_no_launch_on_either_route():
    rng = np.random.default_rng(6)
    before = (svrg_inner.launches, dict(svrg_inner.launches_by_route))
    for m_sub in (13, svrg_ops.RING_MAX_WINDOW + 3):
        assert svrg_route(m_sub, 5) == ("ring" if m_sub == 13 else "block")
        args = _svrg_cell(rng, 8, m_sub, m_sub, 5)
        w = svrg_inner(*map(torch.from_numpy, args), lam=0.1, eta=0.03)
        assert w.shape == (m_sub,) and torch.isfinite(w).all()
    assert (svrg_inner.launches, svrg_inner.launches_by_route) == before
    assert set(before[1]) == {"ring", "block"}


def _grad(loss, z, y):
    if loss == "hinge":
        return -y if y * z < 1.0 else np.float32(0.0)
    return np.float32(2.0) * (z - y)


def ring_epoch(x, y, mask, z_anchor, w_anchor, mu, idx, *, lam, eta, loss,
               lo):
    """One cell's L steps in the ring kernel's order, in float32.  Step h
    takes its margin from the dot carried over from step h - 1 (0 at h =
    0, where w = w~); while it updates every column with the block
    route's expression it forms, from the iterate before the update and
    the next row x', A = x'.(w - w~), B = x'.x and C = x'.mu, and carries
    x'.(w_new - w~) = (1 - eta lam) A - eta gd B - eta C to step h + 1."""
    f = np.float32
    m_sub = w_anchor.shape[0]
    rows = x[:, lo:lo + m_sub].astype(f)
    lam, eta = f(lam), f(eta)
    decay = f(1) - eta * lam
    wa, mv = w_anchor.astype(f), mu.astype(f)
    w = wa.copy()
    dot = f(0.0)
    L = len(idx)
    for h in range(L):
        j = idx[h]
        xk = rows[j]
        gd = (_grad(loss, f(z_anchor[j] + dot), y[j])
              - _grad(loss, z_anchor[j], y[j])) * mask[j]
        if h + 1 < L:
            xn = rows[idx[h + 1]]
            A = np.dot(xn, w - wa)
            B = np.dot(xn, xk)
            C = np.dot(xn, mv)
        w = w - eta * (gd * xk + mv + lam * (w - wa))
        if h + 1 < L:
            dot = f(decay * A - eta * gd * B - eta * C)
    return w


@pytest.mark.parametrize("L", [0, 1, 3, 40])
@pytest.mark.parametrize("m_sub,lo", [(13, 3), (100, 7), (33, 0)])
@pytest.mark.parametrize("loss", ["hinge", "squared"])
def test_ring_recurrence_matches_plain_and_pallas(L, m_sub, lo, loss):
    """The ring route's pipelined dot -- each step's margin from the
    previous step's A, B and C through the identity, not from the iterate
    -- gives the steps the plain version and the reference's Pallas
    kernel give, within 1e-5, on masked rows and rows repeated 1 to 5
    steps apart.  At L = 0 the Pallas kernel runs no step and writes no
    output, so there the plain version alone (w = w~) is the reference."""
    n_p = 16
    x, y, mask, za, wa, mu, idx = _svrg_cell(
        np.random.default_rng(10 * m_sub + L), n_p, m_sub + lo + 5, m_sub, L)
    if L:
        idx[0] = n_p - 1                          # a masked row first
    if L >= 3:
        idx[2] = idx[1]                           # repeated at once
    assert svrg_route(m_sub, L) == "ring"
    kw = dict(lam=0.1, eta=0.05, loss=loss)
    got = ring_epoch(x, y, mask, za, wa, mu, idx, lo=lo, **kw)
    plain = svrg_inner(*map(torch.from_numpy, (x, y, mask, za, wa, mu, idx)),
                       lo=lo, **kw)
    np.testing.assert_allclose(got, plain.numpy(), **TOL)
    if L:
        want = svrg_inner_pallas(jnp.asarray(x[:, lo:lo + m_sub]),
                                 *map(jnp.asarray, (y, mask, za, wa, mu, idx)),
                                 **kw)
        np.testing.assert_allclose(got, np.asarray(want), **TOL)
        assert np.abs(got - wa).max() > 0         # the steps moved w
    else:
        np.testing.assert_array_equal(got, wa)


def test_svrg_launch_checks_its_route():
    """The private launch refuses a route it does not know before it
    touches the library."""
    args = [torch.from_numpy(a) for a in _svrg_cell(np.random.default_rng(1),
                                                    8, 9, 9, 4)]
    lead = [a[None, None] if i in (0, 4, 5, 6) else a[None]
            for i, a in enumerate(args)]
    with pytest.raises(ValueError, match="unknown svrg_inner route"):
        svrg_ops._launch(*lead, None, lam=0.1, eta=0.03, loss_id=0,
                         route="warp")


# ---------------------------------------------------------------------------
# sparse SDCA epoch: the lookahead route
# ---------------------------------------------------------------------------

def _rows_at_smem_limit(k, steps):
    """The most rows whose dual deltas still fit one lookahead CTA's
    shared memory beside an order of ``steps``, the ring and the tables."""
    room = MAX_DYNAMIC_SMEM - sdca_sparse.ahead_smem(0, k, steps)
    return room // 16 * 4


@pytest.mark.parametrize("n_p,k,steps,route", [
    (2857, 168, 2857, "lookahead"),            # the news20 cells
    (8, 4, 8, "lookahead"), (17, 8, 33, "lookahead"), (1, 4, 0, "lookahead"),
    (17, 7, 33, "block"), (40, 3, 64, "block"), (40, 2, 64, "block"),
    (40, 0, 64, "block"), (0, 8, 8, "block"),
    (_rows_at_smem_limit(168, 2857), 168, 2857, "lookahead"),
    (_rows_at_smem_limit(168, 2857) + 1, 168, 2857, "block"),
    (2857, 168, _rows_at_smem_limit(168, 2857), "lookahead"),
    (2857, 168, _rows_at_smem_limit(168, 2857) + 1, "block")])
def test_sdca_sparse_route_boundaries(n_p, k, steps, route):
    assert sdca_sparse_route(n_p, k, steps) == route
    assert route in sdca_sparse.ROUTES
    if route == "lookahead":
        assert sdca_sparse.ahead_smem(n_p, k, steps) <= MAX_DYNAMIC_SMEM


@pytest.mark.parametrize("k", [4, 8, 12, 32, 64, 168, 256, 300])
def test_sdca_sparse_ahead_geometry(k):
    """A stepper warp, six helper warps and a producer warp; the shared
    memory is the kernel's layout -- the order and the dual deltas, each
    rounded up to 4, then for each of the ring's rows its slot (k ids, k
    values, three 16-byte scalar chunks) and its record (the 32 owner
    lanes' counts, 8 scalars, the lanes' lists of (column, value) pairs,
    the overflow list); two CTAs of a cell's 4-CTA cluster share an SM."""
    assert sdca_sparse.AHEAD_THREADS == 32 * 8
    assert sdca_sparse.AHEAD_CLUSTER == 4
    rb = sdca_sparse.ahead_record_bytes(k)
    assert rb == 4 * 32 + 4 * 8 + 8 * 32 * sdca_sparse.AHEAD_CAP \
        + 8 * (-(-k // 8) * 8)
    assert rb % 16 == 0
    assert sdca_sparse.ahead_smem(2857, k, 2857) == \
        4 * (2860 + 2860) + sdca_sparse.AHEAD_RING * (8 * k + 48 + rb)
    # a row is gathered D steps ahead and its record is built before that:
    # the ring holds more rows than the lookahead and its overlaps
    assert sdca_sparse.AHEAD_RING > 2 * sdca_sparse.AHEAD_DEPTH
    # the records carry at most 3 overlaps (D - 1)
    assert 1 <= sdca_sparse.AHEAD_DEPTH - 1 <= 3
    # the main path's cells: two CTAs fit one SM
    if k == 168:
        assert 2 * sdca_sparse.ahead_smem(2857, 168, 2857) \
            <= MAX_DYNAMIC_SMEM + 2048


def _ell_cell(rng, n_p, m_q, k, steps, D):
    """One padded-ELL cell in the layouts the lookahead route must get
    right: unsorted rows, padding slots (col 0, val 0) between real
    entries, a real entry at column 0, columns twice (and thrice) in a
    row, an all-padding row, masked rows, and rows repeated 1 .. D + 1
    steps apart."""
    cols = np.zeros((n_p, k), np.int32)
    vals = np.zeros((n_p, k), np.float32)
    for i in range(n_p):
        if i == 2:
            continue                              # all padding
        r = int(rng.integers(1, k + 1))
        c = rng.integers(0, m_q, r)               # with repeats
        if i == 0:
            c[0] = 0
        if i == 1 and r >= 3:
            c[1] = c[2] = c[0]
        slots = rng.permutation(k)[:r]
        cols[i, slots] = c
        vals[i, slots] = rng.normal(size=r)
    y = np.where(rng.random(n_p) < 0.5, -1.0, 1.0).astype(np.float32)
    mask = np.ones(n_p, np.float32)
    mask[-2:] = 0.0
    a0 = (rng.uniform(0, 0.5, n_p) * (y > 0)).astype(np.float32)
    w0 = (rng.normal(size=m_q) * 0.1).astype(np.float32)
    idx = rng.integers(0, n_p, steps).astype(np.int32)
    idx[1::9] = 1
    idx[4::13] = n_p - 1
    for t, back in enumerate(range(1, D + 2)):
        h = 6 + 5 * t
        if h < steps:
            idx[h] = idx[h - back]
    return cols, vals, y, mask, a0, w0, idx


def lookahead_epoch(cols, vals, y, mask, alpha0, w0, idx, *, lam, n, Q,
                    loss, beta, D):
    """One cell's epoch in the lookahead kernel's order, in float32.
    Iteration h (from -D): the dual step of step h from row h's reduced
    sums, and its scatter; then row g = h + D is gathered from w as the
    scatters of steps <= h left it, and its overlaps with rows g - 1 ..
    g - D + 1 are formed from the columns they share; step g's margin is
    its gather plus c_j times its overlap with each of those D - 1 rows.
    The dual step takes 1 / Q and 1 / (lam n) once and divides once, as
    the kernel does."""
    f = np.float32
    n_p, k = cols.shape
    steps = len(idx)
    w = w0.astype(f).copy()
    dal = np.zeros(n_p, f)
    stats = {}                             # row -> (S, ||x||^2, overlaps)
    cs = [f(0.0)] * max(D - 1, 1)          # c_{h-1}, ..., c_{h-D+1}
    lam_n = f(lam) * f(n)
    inv_lam_n, inv_q, half_inv_q = f(1) / lam_n, f(1) / f(Q), f(1) / f(2 * Q)

    def entries(r):                        # the row's nonzero slots
        i = idx[r]
        return [(int(c), v) for c, v in zip(cols[i], vals[i]) if v != 0.0]

    for h in range(-D, steps):
        if h >= 0:
            i = idx[h]
            S, sq, ov = stats.pop(h)
            z = S
            for j in range(1, D):
                z = f(z + cs[j - 1] * ov[j - 1])
            yq, mi = y[i] * inv_q, mask[i]
            a_i = alpha0[i] + dal[i]
            denom = max(f(beta) if beta is not None else sq, f(1e-12))
            if loss == "hinge":
                d = f((yq - z) * lam_n / denom)
                lo, hi = (f(0.0), f(1.0)) if yq > 0 else (f(-1.0), f(0.0))
                d = min(max(a_i + d, lo), hi) - a_i
            else:
                num = yq - a_i * half_inv_q - z
                d = num / max(denom * inv_lam_n + half_inv_q, f(1e-12))
            d = f(d * mi)
            coef = f(d * inv_lam_n)
            for c, v in entries(h):
                w[c] += coef * v
            dal[i] += d
            cs = [coef] + cs[:-1]
        g = h + D
        if g < steps:
            mine = entries(g)
            S = f(sum(v * w[c] for c, v in mine))
            sq = f(sum(v * v for _, v in mine))
            ov = [f(sum(v * v2 for c, v in mine for c2, v2 in entries(g - j)
                        if c2 == c)) if g - j >= 0 else f(0.0)
                  for j in range(1, D)]
            stats[g] = (S, sq, ov)
    return dal, w


#: lookahead depths whose recurrence is emulated: the kernel's, and the
#: 1 and 4 it was measured against (PERF.md)
DEPTHS = (1, 2, 4)


@pytest.mark.parametrize("D", DEPTHS)
@pytest.mark.parametrize("n_p,m_q,k,steps", [
    (20, 30, 12, 40),         # narrow block: rows share most columns
    (24, 500, 8, 36),         # wide block: overlaps are rare
    (6, 10, 4, 3)])           # fewer steps than the deepest lookahead
@pytest.mark.parametrize("loss,beta", [("hinge", None), ("squared", None),
                                       ("hinge", 3.0)])
def test_lookahead_recurrence_matches_plain_and_pallas(D, n_p, m_q, k, steps,
                                                       loss, beta):
    """The lookahead route's recurrence -- stale gather plus the missed
    scatters through row overlaps -- gives the epoch the plain version
    and the reference's Pallas kernel give, within 1e-5, on unsorted rows
    with padding, duplicate columns, an all-padding row, masked rows and
    rows repeated within D steps."""
    assert sdca_sparse.AHEAD_DEPTH in DEPTHS
    assert sdca_sparse_route(n_p, k, steps) == "lookahead"
    args = _ell_cell(np.random.default_rng(100 * D + k + steps), n_p, m_q,
                     k, steps, D)
    kw = dict(lam=0.2, n=200, Q=3, loss=loss, beta=beta)
    da_e, w_e = lookahead_epoch(*args, **kw, D=D)
    da_t, w_t = sdca_epoch_sparse(*map(torch.from_numpy, args), **kw)
    da_p, w_p = sdca_epoch_sparse_pallas(*map(jnp.asarray, args), **kw)
    np.testing.assert_allclose(da_e, da_t.numpy(), **TOL)
    np.testing.assert_allclose(w_e, w_t.numpy(), **TOL)
    np.testing.assert_allclose(da_e, np.asarray(da_p), **TOL)
    np.testing.assert_allclose(w_e, np.asarray(w_p), **TOL)
    assert np.abs(da_e).max() > 0               # the epoch moved


def test_lookahead_without_correction_is_wrong():
    """The overlap correction is what makes the stale gather right: the
    same recurrence with the missed scatters dropped (z = S) departs from
    the plain version on rows that share columns."""
    args = _ell_cell(np.random.default_rng(3), 20, 30, 12, 40, 4)
    kw = dict(lam=0.2, n=200, Q=3, loss="squared", beta=None)
    _, w_t = sdca_epoch_sparse(*map(torch.from_numpy, args), **kw)
    _, w_e = lookahead_epoch(*args, **kw, D=4)
    np.testing.assert_allclose(w_e, w_t.numpy(), **TOL)
    blind = _no_overlap_epoch(*args, **kw, D=4)
    assert np.abs(blind - w_t.numpy()).max() > 1e-3


def _no_overlap_epoch(cols, vals, y, mask, alpha0, w0, idx, *, lam, n, Q,
                      loss, beta, D):
    """``lookahead_epoch``'s stale gather with no correction (squared
    loss, exact denominator)."""
    f = np.float32
    w = w0.astype(f).copy()
    dal = np.zeros(len(y), f)
    gathered = {}
    steps = len(idx)
    lam_n = f(lam) * f(n)
    for h in range(-D, steps):
        if h >= 0:
            i = idx[h]
            z, sq = gathered.pop(h)
            a_i = alpha0[i] + dal[i]
            num = y[i] / f(Q) - a_i / f(2.0 * Q) - z
            den = f(1.0) / f(2.0 * Q) + max(sq, f(1e-12)) / lam_n
            d = f(num / den * mask[i])
            np.add.at(w, cols[i], f(d / lam_n) * vals[i])
            dal[i] += d
        if h + D < steps:
            r = idx[h + D]
            gathered[h + D] = (f((vals[r] * w[cols[r]]).sum()),
                               f((vals[r] ** 2).sum()))
    return w


def test_sdca_sparse_cpu_calls_count_no_launch_on_either_route():
    rng = np.random.default_rng(8)
    before = (sdca_epoch_sparse.launches,
              dict(sdca_epoch_sparse.launches_by_route))
    for k in (8, 7):
        assert sdca_sparse_route(12, k, 9) == ("lookahead" if k == 8
                                                else "block")
        args = _ell_cell(rng, 12, 40, k, 9, 2)
        da, w = sdca_epoch_sparse(*map(torch.from_numpy, args), lam=0.2,
                                  n=200, Q=1)
        assert da.shape == (12,) and w.shape == (40,)
    assert (sdca_epoch_sparse.launches,
            sdca_epoch_sparse.launches_by_route) == before
    assert set(before[1]) == {"lookahead", "block"}


def test_sdca_sparse_launch_checks_its_route_and_alignment():
    """The private launch refuses a route it does not know, and the
    lookahead route a view whose rows would not start on 16-byte
    boundaries, before either touches the library."""
    args = [torch.from_numpy(a) for a in _ell_cell(np.random.default_rng(2),
                                                   8, 20, 8, 6, 1)]
    lead = [a[None, None] if i < 2 else a[None] for i, a in enumerate(args)]
    with pytest.raises(ValueError, match="unknown sdca_epoch_sparse route"):
        sdca_sparse._launch(*lead, lam=0.2, n=200, Q=1, loss_id=0,
                            beta=None, route="warp")
    flat = torch.zeros(args[1].numel() + 1)
    shifted = flat[1:].view(args[1].shape)      # data_ptr 4 bytes off
    assert shifted.is_contiguous() and shifted.data_ptr() % 16
    with pytest.raises(ValueError, match="vals starts at a 16-byte"):
        sdca_sparse.check_bulk_alignment(args[0], shifted)
    sdca_sparse.check_bulk_alignment(args[0], args[1])

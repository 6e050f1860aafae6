"""The exponents of the RWKV6 linear attention's tensor-core route
(``csrc/rwkv_linattn_tc.cu``), on the CPU.  Each 64-token chunk is cut
into four 16-token sub-chunks; every decay factor of the chunked form is
2 to the power of a sum of log2 decays.  The kernel forms each such sum
from the decays it spans -- a sub-chunk's exclusive prefix sums as
TwoSum pairs hi + lo, the decays across sub-chunks from the sub-chunks'
totals -- never as the difference of two cumulative sums that share a
long prefix, whose float32 rounding (ulp 6e-5 at -700) becomes the
relative error of a term.

Here the kernel's exponent scheme is emulated step for step in float32
(the products in float64, so that only the exponents round) and held
against the exact recurrence in float64, beside the float32 recurrence
(the kernel's plain version) and the chunk-long cumulative sums of the
reference's Pallas kernel.  The CUDA kernel is held against the float64
recurrence on the card by ``chip_smoke.py``."""
import numpy as np
import pytest
import torch

from repro_torch.kernels.linattn import rwkv_linattn_ref
import test_torch_common  # noqa: F401  (one torch thread a process)

F32, F64 = torch.float32, torch.float64
LOG2E = torch.tensor(1.4426950408889634, dtype=F32)
C, SUB = 64, 16


def _inputs(seed, BH, S, D):
    """The main path's draw (chip_smoke.py::linattn_inputs): r, k, v
    normal, logw = -exp(clip(normal, -20, 4)) floored at -8, u per row."""
    rng = np.random.default_rng(seed)
    r, k, v = (torch.from_numpy(rng.normal(size=(BH, S, D)).astype(np.float32))
               for _ in range(3))
    lw = torch.from_numpy(np.maximum(
        -np.exp(np.clip(rng.normal(size=(BH, S, D)), -20, 4)), -8.0
    ).astype(np.float32))
    u = torch.from_numpy((0.5 * rng.normal(size=(D,))).astype(np.float32))
    return r, k, v, lw, u


def _two_sum(a, b):
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def _exponents_kernel(x):
    """The kernel's log2 decays of one chunk, x (BH, C, D) float32 log2
    decays a token: per token its sub-chunk's exclusive prefix sum P as
    (hi, lo), and per sub-chunk its total (hi, lo)."""
    ph, pl = torch.empty_like(x), torch.empty_like(x)
    th, tl = [], []
    for b in range(C // SUB):
        hi = torch.zeros_like(x[:, 0])
        lo = torch.zeros_like(hi)
        for t in range(SUB * b, SUB * b + SUB):
            ph[:, t], pl[:, t] = hi, lo
            hi, e = _two_sum(hi, x[:, t])
            lo = lo + e
        th.append(hi)
        tl.append(lo)

    def span(b0, b1):                       # sum of the totals b0 .. b1 - 1
        h = torch.zeros_like(th[0])
        lo = torch.zeros_like(h)
        for c in range(b0, b1):
            h, lo = h + th[c], lo + tl[c]
        return h + lo

    def within(t, i):                        # decay from i + 1 to t - 1
        return (ph[:, t] - ph[:, i + 1]) + (pl[:, t] - pl[:, i + 1])

    def r_to_start(t):                       # t's sub-chunk start to t - 1
        return ph[:, t] + pl[:, t]

    def k_to_end(t):                         # t + 1 to its sub-chunk's end
        b = t // SUB
        if t % SUB == SUB - 1:
            return torch.zeros_like(th[0])
        return (th[b] - ph[:, t + 1]) + (tl[b] - pl[:, t + 1])
    return within, r_to_start, k_to_end, span


def _exponents_cumsum(x):
    """The same decays from chunk-long cumulative sums (la inclusive, lp
    exclusive), as the reference's Pallas kernel forms them."""
    la = torch.cumsum(x, 1)
    lp = la - x
    starts = [lp[:, SUB * b] for b in range(C // SUB)]
    ends = [la[:, SUB * b + SUB - 1] for b in range(C // SUB)]

    def span(b0, b1):
        if b0 >= b1:
            return torch.zeros_like(la[:, 0])
        return ends[b1 - 1] - starts[b0]
    return (lambda t, i: lp[:, t] - la[:, i],
            lambda t: lp[:, t] - starts[t // SUB],
            lambda t: ends[t // SUB] - la[:, t], span)


def chunked(r, k, v, lw, u, exponents):
    """The tc route's chunked form with the given exponent scheme: r
    decayed to its sub-chunk's start, k to its sub-chunk's end, the six
    off-diagonal 16 x 16 score blocks with a per-channel factor across
    the sub-chunks between, per-pair decays on the four diagonal blocks,
    the current-token bonus on the diagonal, the inter-chunk and state
    terms with per-channel scales.  Exponents in float32, 2^e in float32,
    products in float64."""
    BH, S, D = r.shape
    assert S % C == 0
    ex2 = lambda e: torch.exp2(e.to(F32)).to(F64)       # noqa: E731
    st = torch.zeros((BH, D, D), dtype=F64)
    outs = []
    for c0 in range(0, S, C):
        rc, kc, vc = (t[:, c0:c0 + C].to(F64) for t in (r, k, v))
        within, r_start, k_end, span = exponents(lw[:, c0:c0 + C] * LOG2E)
        rd = torch.stack([rc[:, t] * ex2(r_start(t)) for t in range(C)], 1)
        kd = torch.stack([kc[:, t] * ex2(k_end(t)) for t in range(C)], 1)
        A = torch.zeros((BH, C, C), dtype=F64)
        for t in range(C):
            for i in range(SUB * (t // SUB), t):
                A[:, t, i] = (rc[:, t] * kc[:, i] * ex2(within(t, i))).sum(-1)
            A[:, t, t] = (rc[:, t] * u.to(F64) * kc[:, t]).sum(-1)
        nb = C // SUB
        for b in range(nb):
            tb = slice(SUB * b, SUB * b + SUB)
            for a in range(b):
                ta = slice(SUB * a, SUB * a + SUB)
                A[:, tb, ta] = torch.einsum(
                    "btd,bid->bti", rd[:, tb] * ex2(span(a + 1, b))[:, None],
                    kd[:, ta])
        o = torch.einsum("bti,bie->bte", A, vc)
        new = ex2(span(0, nb))[:, :, None] * st
        for b in range(nb):
            tb = slice(SUB * b, SUB * b + SUB)
            o[:, tb] += torch.einsum(
                "btd,bde->bte", rd[:, tb] * ex2(span(0, b))[:, None], st)
            new = new + torch.einsum(
                "bid,bie->bde", kd[:, tb] * ex2(span(b + 1, nb))[:, None],
                vc[:, tb])
        outs.append(o)
        st = new
    return torch.cat(outs, 1), st


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_tc_exponents_are_as_exact_as_the_float32_recurrence(seed):
    """With the kernel's exponents the chunked form is within 2x (and
    1e-6 of the largest entry) of the float32 recurrence's own distance
    to the float64 one, in the output and the state; with chunk-long
    cumulative sums it is at least 4x farther than the kernel's."""
    args = _inputs(seed, 8, 256, 64)
    o64, s64 = rwkv_linattn_ref(*args, dtype=F64)
    o32, s32 = rwkv_linattn_ref(*args)
    ok, sk = chunked(*args, _exponents_kernel)
    oc, sc = chunked(*args, _exponents_cumsum)
    err = lambda a, b: float((a.to(F64) - b).abs().max())  # noqa: E731
    for got, plain, cum, ref in ((ok, o32, oc, o64), (sk, s32, sc, s64)):
        scale = float(ref.abs().max())
        assert err(got, ref) <= 2 * err(plain, ref) + 1e-6 * scale
        assert err(cum, ref) >= 4 * err(got, ref)


def test_tc_exponents_never_exceed_zero_by_more_than_rounding():
    """Every exponent the kernel forms is a sum of non-positive decays:
    it is <= 0 up to the compensation's rounding, so no factor exceeds 1
    however strong the decay (logw down to -50)."""
    x = torch.from_numpy(-np.random.default_rng(4).exponential(
        8.0, size=(3, C, 16)).astype(np.float32)) * LOG2E
    within, r_start, k_end, span = _exponents_kernel(x)
    vals = [within(t, i) for t in range(C)
            for i in range(SUB * (t // SUB), t)]
    vals += [r_start(t) for t in range(C)] + [k_end(t) for t in range(C)]
    vals += [span(b0, b1) for b0 in range(4) for b1 in range(b0, 5)]
    assert max(float(v.max()) for v in vals) <= 1e-6
    assert all(torch.isfinite(v).all() for v in vals)

"""The port's RG-LRU block (``repro_torch.models.rglru``) against the
reference's (``repro.models.rglru``) on the CPU, float32: the block over
sequences up to 4096 steps with and without a start state, a sharp decay
that a log-space cumulative sum over the sequence could not hold, and a
chain of one-token decodes against the block.  The same numpy weights and
inputs go to both packages; tolerance 1e-5 (rtol = atol)."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import reduced as ref_reduced
from repro.models import rglru as ref_rglru
from repro_torch.configs import get_config
from repro_torch.models import reduced
from repro_torch.models import rglru
import test_torch_common  # noqa: F401  (one torch thread a process)

TOL = 1e-5


def _cfgs(d_model=64):
    return [dataclasses.replace(red(get("recurrentgemma-9b")),
                                compute_dtype="float32", d_model=d_model)
            for get, red in ((ref_get_config, ref_reduced),
                             (get_config, reduced))]


def _params(dm, seed, lam_shift=0.0):
    """numpy weights; ``lam_shift`` raises Lambda (a sharper decay)."""
    rng = np.random.default_rng(seed)
    p = {k: (rng.normal(size=(dm, dm)) * dm ** -0.5).astype(np.float32)
         for k in ("w_x", "w_r", "w_i", "w_o")}
    lam = np.log(np.expm1(-np.log(np.linspace(0.9, 0.999, dm)) / 8.0))
    p["lam"] = (lam + lam_shift).astype(np.float32)
    return p


def _both(p, x, h0):
    rcfg, pcfg = _cfgs(x.shape[-1])
    r_out, r_h = ref_rglru.rglru_block(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x), rcfg,
        state=None if h0 is None else jnp.asarray(h0))
    with torch.no_grad():
        out, h = rglru.rglru_block(
            {k: torch.from_numpy(v) for k, v in p.items()},
            torch.from_numpy(x), pcfg,
            state=None if h0 is None else torch.from_numpy(h0))
    return (out, h), (np.asarray(r_out), np.asarray(r_h))


@pytest.mark.parametrize("S", [1, 5, 64, 100, 1000, 4096])
@pytest.mark.parametrize("with_h0", [False, True])
def test_rglru_block_matches_the_reference(S, with_h0):
    """S of one step, less than a chunk, one chunk, ragged, many chunks."""
    dm = 32
    p = _params(dm, S)
    rng = np.random.default_rng(S + 1)
    x = rng.normal(size=(2, S, dm)).astype(np.float32)
    h0 = rng.normal(size=(2, dm)).astype(np.float32) if with_h0 else None
    (out, h), (r_out, r_h) = _both(p, x, h0)
    np.testing.assert_allclose(out.numpy(), r_out, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(h.numpy(), r_h, rtol=TOL, atol=TOL)


def test_rglru_sharp_decay_stays_finite():
    """Lambda raised by 6: log a ~ -8 softplus(Lambda) r reaches -50 a
    step, so the sum of log a over 512 steps is ~ -1e4, far below
    float32's exp range (-88): a scan over exp(cumsum(log a)) would
    divide 0 by 0.  The chunked scan multiplies decays and matches."""
    dm, S = 32, 512
    p = _params(dm, 7, lam_shift=6.0)
    rng = np.random.default_rng(8)
    x = rng.normal(size=(2, S, dm)).astype(np.float32)
    h0 = rng.normal(size=(2, dm)).astype(np.float32)
    cfg = _cfgs(dm)[1]
    with torch.no_grad():
        a, _ = rglru._gates({k: torch.from_numpy(v) for k, v in p.items()},
                            torch.from_numpy(x), cfg)
    assert float(torch.log(a).sum(1).min()) < -88.0 * 10
    (out, h), (r_out, r_h) = _both(p, x, h0)
    assert torch.isfinite(out).all() and torch.isfinite(h).all()
    np.testing.assert_allclose(out.numpy(), r_out, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(h.numpy(), r_h, rtol=TOL, atol=TOL)


def test_rglru_decode_chain_equals_the_block():
    """Prefill 10 steps, then 20 one-token decodes from its state: the
    outputs and the state equal the block over all 30 (and the
    reference's decode)."""
    dm = 32
    p = _params(dm, 9)
    x = np.random.default_rng(10).normal(size=(3, 30, dm)).astype(np.float32)
    rcfg, pcfg = _cfgs(dm)
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    rp = {k: jnp.asarray(v) for k, v in p.items()}
    tx = torch.from_numpy(x)
    with torch.no_grad():
        whole, h_whole = rglru.rglru_block(tp, tx, pcfg)
        out, h = rglru.rglru_block(tp, tx[:, :10], pcfg)
        outs = [out]
        r_h = jnp.asarray(h.numpy())
        for t in range(10, 30):
            o, h = rglru.rglru_decode(tp, tx[:, t:t + 1], pcfg, state=h)
            r_o, r_h = ref_rglru.rglru_decode(rp, jnp.asarray(x[:, t:t + 1]),
                                              rcfg, state=r_h)
            np.testing.assert_allclose(o.numpy(), np.asarray(r_o),
                                       rtol=TOL, atol=TOL)
            outs.append(o)
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(), whole.numpy(),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(h.numpy(), h_whole.numpy(), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(r_h), rtol=TOL,
                               atol=TOL)


def test_rglru_block_gradients_match_the_reference():
    """Gradients of a weighted sum of the output and the last state with
    respect to the input, the start state and every weight (lam
    included), S = 150 (three chunks, ragged)."""
    import jax
    dm, S = 32, 150
    p = _params(dm, 11)
    rng = np.random.default_rng(12)
    x = rng.normal(size=(2, S, dm)).astype(np.float32)
    h0 = rng.normal(size=(2, dm)).astype(np.float32)
    g = rng.normal(size=(2, S, dm)).astype(np.float32)
    gh = rng.normal(size=(2, dm)).astype(np.float32)
    rcfg, pcfg = _cfgs(dm)

    def ref_loss(pp, xx, hh):
        o, h = ref_rglru.rglru_block(pp, xx, rcfg, state=hh)
        return jnp.sum(o * g) + jnp.sum(h * gh)

    r_g = jax.grad(ref_loss, argnums=(0, 1, 2))(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
        jnp.asarray(h0))
    tp = {k: torch.from_numpy(v).requires_grad_(True) for k, v in p.items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    th = torch.from_numpy(h0).requires_grad_(True)
    o, h = rglru.rglru_block(tp, tx, pcfg, state=th)
    ((o * torch.from_numpy(g)).sum() + (h * torch.from_numpy(gh)).sum()
     ).backward()
    for k in p:
        np.testing.assert_allclose(tp[k].grad.numpy(), np.asarray(r_g[0][k]),
                                   rtol=TOL, atol=TOL, err_msg=k)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(r_g[1]),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(r_g[2]),
                               rtol=TOL, atol=TOL)

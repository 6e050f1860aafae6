"""The port's MoE feed-forward (``repro_torch.models.moe``) against the
reference's (``repro.models.moe``) on the CPU at reduced Mixtral and
Moonshot widths, float32, 1e-5 (rtol = atol): the output and the
gradients of the input and of every weight, with and without capacity
drops, a padded tail chunk, tied router logits and the one-token decode
case.  The same numpy weights and inputs go to both packages."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import moe as ref_moe
from repro.models import reduced as ref_reduced
from repro_torch.configs import get_config
from repro_torch.models import reduced
from repro_torch.models import moe
import test_torch_common  # noqa: F401  (one torch thread a process)

TOL = 1e-5


def _cfgs(arch, **moe_kw):
    """(reference config, port config): the arch reduced, float32, with
    its MoE fields overridden by ``moe_kw``."""
    out = []
    for get, red in ((ref_get_config, ref_reduced), (get_config, reduced)):
        cfg = red(get(arch), compute_dtype="float32")
        m = dataclasses.replace(cfg.moe, **moe_kw)
        out.append(dataclasses.replace(cfg, moe=m))
    return out


def _params(cfg, seed, tie=None):
    """numpy weights of one MoE layer; ``tie=(i, j)`` makes router column
    j a copy of column i, so experts i and j tie on every token."""
    rng = np.random.default_rng(seed)
    E, dm, dff = cfg.moe.n_experts, cfg.d_model, cfg.d_ff
    p = {"router": rng.normal(size=(dm, E)) * dm ** -0.5,
         "w_gate": rng.normal(size=(E, dm, dff)) * dm ** -0.5,
         "w_up": rng.normal(size=(E, dm, dff)) * dm ** -0.5,
         "w_down": rng.normal(size=(E, dff, dm)) * dff ** -0.5}
    if tie is not None:
        p["router"][:, tie[1]] = p["router"][:, tie[0]]
    return {k: v.astype(np.float32) for k, v in p.items()}


def _run_both(arch, B, S, seed=0, tie=None, **moe_kw):
    rcfg, pcfg = _cfgs(arch, **moe_kw)
    params = _params(rcfg, seed, tie)
    x = np.random.default_rng(seed + 1).normal(
        size=(B, S, rcfg.d_model)).astype(np.float32)
    g = np.random.default_rng(seed + 2).normal(
        size=(B, S, rcfg.d_model)).astype(np.float32)

    def ref_loss(p, xx):
        return jnp.sum(ref_moe.moe_ffn(p, xx, rcfg) * g)

    rp = {k: jnp.asarray(v) for k, v in params.items()}
    r_out = ref_moe.moe_ffn(rp, jnp.asarray(x), rcfg)
    r_gp, r_gx = jax.grad(ref_loss, argnums=(0, 1))(rp, jnp.asarray(x))

    tp = {k: torch.from_numpy(v).requires_grad_(True)
          for k, v in params.items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    out = moe.moe_ffn(tp, tx, pcfg)
    (out * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(r_out),
                               rtol=TOL, atol=TOL, err_msg="output")
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(r_gx), rtol=TOL,
                               atol=TOL, err_msg="grad x")
    for k in params:
        np.testing.assert_allclose(tp[k].grad.numpy(), np.asarray(r_gp[k]),
                                   rtol=TOL, atol=TOL, err_msg=f"grad {k}")
    return rcfg, params, x


def _choices(cfg, params, x):
    """The reference's top-k experts (B, C, k) of every whole chunk."""
    C = min(cfg.moe.chunk, x.shape[1])
    xs = x[:, : x.shape[1] // C * C]
    keeps = []
    for i in range(xs.shape[1] // C):
        xc = jnp.asarray(xs[:, i * C:(i + 1) * C])
        logits = jnp.einsum("bcd,de->bce", xc, jnp.asarray(params["router"]))
        _, idx = jax.lax.top_k(logits, cfg.moe.top_k)
        keeps.append(np.asarray(idx))
    return keeps


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "moonshot-v1-16b-a3b"])
@pytest.mark.parametrize("capacity_factor", [4.0, 1.0, 0.5])
def test_moe_matches_the_reference_with_and_without_drops(arch,
                                                           capacity_factor):
    """chunk 8, S 32: four chunks a row; at capacity_factor 4 nothing is
    dropped, at 1.0 and 0.5 choices past an expert's capacity are, and a
    different dropped set would change the output by O(1)."""
    kw = dict(capacity_factor=capacity_factor)
    if arch == "moonshot-v1-16b-a3b":
        kw.update(n_experts=16, top_k=6)     # Moonshot's k / E ratio
    cfg, params, x = _run_both(arch, 2, 32, seed=1, **kw)
    # drops happen where the test says they do
    E, k = cfg.moe.n_experts, cfg.moe.top_k
    cap = max(1, int(8 * k / E * capacity_factor))
    counts = [np.bincount(idx[b].reshape(-1), minlength=E).max()
              for idx in _choices(cfg, params, x) for b in range(2)]
    assert (max(counts) > cap) == (capacity_factor < 4.0)


@pytest.mark.parametrize("S", [13, 21])
def test_moe_padded_tail_chunk(S):
    """S % chunk != 0: the reference pads the tail and masks the padding
    out of routing."""
    _run_both("mixtral-8x7b", 2, S, seed=2, capacity_factor=1.0)


def test_moe_tied_router_logits_take_the_lower_expert_first():
    """Router columns 1 and 2 equal: every token ties between experts 1
    and 2; lax.top_k takes the lower index first, and so must the port
    (torch.topk promises no order), or the gates and the capacity order
    change."""
    cfg, params, x = _run_both("mixtral-8x7b", 2, 16, seed=3, tie=(1, 2),
                               capacity_factor=1.0)
    logits = torch.from_numpy(x) @ torch.from_numpy(params["router"])
    vals, idx = moe.top_k_lower_first(logits, 4)
    tied = vals[..., 1:] == vals[..., :-1]
    assert bool(tied.any())
    assert bool((idx[..., 1:] > idx[..., :-1])[tied].all())
    assert bool((logits[..., 1] == logits[..., 2]).all())


def test_moe_decode_case_one_token():
    """S = 1 (a decode step): one chunk of one token, capacity 1."""
    _run_both("mixtral-8x7b", 3, 1, seed=4, capacity_factor=1.25)
    _run_both("moonshot-v1-16b-a3b", 2, 1, seed=5, n_experts=16, top_k=6)

"""RWKV6's LM training against the reference (the checks of
``test_torch_train.py`` at ``rwkv6-3b``: loss and every leaf's gradient
under each remat policy, attention implementation and cross-entropy
chunking, and three-step trajectories of ``make_train_step``), and the
autograd Function around the RWKV6 linear attention kernel against
``jax.grad`` of the reference's ``rwkv_scan``, at reduced size on the CPU,
float32 compute.  Tolerances as in ``test_torch_train.py``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import rwkv as ref_rwkv
from repro_torch.kernels.linattn import rwkv_linattn
from repro_torch.models import rwkv
from test_torch_train import REMATS, check_loss_and_grads, check_trajectory


@pytest.mark.parametrize("arch", ["rwkv6-3b"])
@pytest.mark.parametrize("remat", REMATS)
@pytest.mark.parametrize("attn_impl", ["chunked", "full"])
@pytest.mark.parametrize("loss_chunk", [8, None])
def test_train_loss_and_grads_match_reference(arch, remat, attn_impl,
                                              loss_chunk):
    check_loss_and_grads(arch, remat, attn_impl, loss_chunk)


@pytest.mark.parametrize("arch", ["rwkv6-3b"])
@pytest.mark.parametrize("accum", [1, 4])
def test_train_step_trajectory_matches_reference(arch, accum):
    check_trajectory(arch, accum)


def test_rwkv_function_grads_match_reference():
    """rwkv_scan from a zero state (the linear-attention Function on the
    CPU) against jax.grad of the reference's rwkv_scan: gradients of r, k,
    v, logw and the per-head u."""
    rng = np.random.default_rng(8)
    B, S, H, D = 2, 24, 3, 16
    r, k, v = (rng.normal(size=(B, S, H, D)).astype(np.float32)
               for _ in range(3))
    logw = -np.exp(rng.uniform(-3, 1, size=(B, S, H, D))).astype(np.float32)
    u = rng.normal(size=(H, D)).astype(np.float32) * 0.5
    dout = rng.normal(size=(B, S, H, D)).astype(np.float32)

    def ref(*a):
        o, _ = ref_rwkv.rwkv_scan(*a)
        return jnp.sum(o * dout)
    r_val = ref(r, k, v, logw, u)
    r_grads = jax.grad(ref, argnums=(0, 1, 2, 3, 4))(r, k, v, logw, u)
    ts = [torch.from_numpy(a).requires_grad_(True)
          for a in (r, k, v, logw, u)]
    before = rwkv_linattn.plain_backwards
    out, state = rwkv.rwkv_scan(*ts)
    assert out.grad_fn is not None
    val = torch.sum(out * torch.from_numpy(dout))
    val.backward()
    assert rwkv_linattn.plain_backwards == before + 1
    np.testing.assert_allclose(val.item(), float(r_val), rtol=1e-5,
                               atol=1e-5)
    for name, t, g in zip("r k v logw u".split(), ts, r_grads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g),
                                   rtol=1e-5, atol=1e-5, err_msg=name)


def test_rwkv_function_state_gradient():
    """A loss on the final state too: its gradient flows back through the
    recurrence (the reference's scan carries it)."""
    rng = np.random.default_rng(9)
    BH, S, D = 4, 10, 16
    a = [rng.normal(size=(BH, S, D)).astype(np.float32) for _ in range(3)]
    lw = -np.exp(rng.uniform(-3, 0, size=(BH, S, D))).astype(np.float32)
    u = rng.normal(size=(D,)).astype(np.float32)
    ts = [torch.from_numpy(x).requires_grad_(True) for x in (*a, lw, u)]
    out, state = rwkv_linattn(*ts)
    (out.sum() + state.square().sum()).backward()

    def ref(r_, k_, v_, w_, u_):
        o, st = ref_rwkv.rwkv_scan(r_[:, :, None], k_[:, :, None],
                                   v_[:, :, None], w_[:, :, None],
                                   u_[None])
        return jnp.sum(o) + jnp.sum(st * st)
    r_grads = jax.grad(ref, argnums=(0, 1, 2, 3, 4))(*a, lw, u)
    for t, g in zip(ts, r_grads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g),
                                   rtol=1e-5, atol=1e-5)

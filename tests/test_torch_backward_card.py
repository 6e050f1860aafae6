"""The backward kernels of B5 and B6 (``csrc/flash_attention_bwd.cu``,
``csrc/rwkv_linattn_bwd.cu``) on the card against their plain backward in
float64, elementwise within ``FLASH_TOL[dtype] x (1 + |ref|)`` and
``LINATTN_TOL x (1 + |ref|)``; a kernel has no CPU path, so without a card
the test skips.  On the card: ``python -m pytest -q
tests/test_torch_backward_card.py`` (``chip_smoke.py --phases kernels``
holds the same kernels at the training main-path shapes)."""
import numpy as np
import pytest
import torch

from repro_torch.kernels.flash import (flash_attention_backward,
                                       flash_attention_backward_plain)
from repro_torch.kernels.linattn import (rwkv_linattn_backward,
                                         rwkv_linattn_backward_plain)

FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 3e-2}
LINATTN_TOL = 2e-4


def within(got, ref, tol):
    return float(((got.double() - ref).abs()
                  / (tol * (1 + ref.abs()))).max()) <= 1.0


@pytest.mark.card
def test_backward_kernels_match_the_plain_backward_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the backward kernels have no CPU "
                    "path")
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    launched = flash_attention_backward.launches
    for (B, S, Skv, H, KV, D, causal, window, dtype) in [
            (1, 128, 128, 16, 8, 128, True, None, torch.bfloat16),
            (2, 37, 37, 4, 1, 16, True, 5, torch.float32),
            (1, 20, 70, 4, 2, 64, False, None, torch.float32),
            (1, 40, 40, 4, 1, 256, True, 16, torch.bfloat16)]:
        q = torch.from_numpy(rng.normal(size=(B, S, H, D))).to(dev, dtype)
        k, v = (torch.from_numpy(rng.normal(size=(B, Skv, KV, D)))
                .to(dev, dtype) for _ in range(2))
        dout = torch.from_numpy(rng.normal(size=(B, S, H, D))).to(dev,
                                                                   dtype)
        kw = dict(causal=causal, window=window)
        got = flash_attention_backward(q, k, v, dout, **kw)
        want = flash_attention_backward_plain(
            *(t.double() for t in (q, k, v, dout)), **kw)
        for g, w in zip(got, want):
            assert g.dtype == dtype and within(g, w, FLASH_TOL[dtype])
    assert flash_attention_backward.launches == launched + 4
    launched = rwkv_linattn_backward.launches
    for (BH, S, D, H, grads) in [(40, 128, 64, 40, "both"),
                                 (6, 70, 16, 1, "dout"),
                                 (4, 33, 32, 2, "dstate")]:
        r, k, v = (torch.from_numpy(rng.normal(size=(BH, S, D))).float()
                   .to(dev) for _ in range(3))
        logw = torch.from_numpy(-np.exp(rng.uniform(-3, 1, (BH, S, D)))
                                ).float().to(dev)
        u = torch.from_numpy(0.5 * rng.normal(
            size=(D,) if H == 1 else (H, D))).float().to(dev)
        dout = None if grads == "dstate" else torch.randn(
            BH, S, D, device=dev)
        dstate = None if grads == "dout" else torch.randn(
            BH, D, D, device=dev)
        got = rwkv_linattn_backward(r, k, v, logw, u, dout, dstate)
        want = rwkv_linattn_backward_plain(
            *(t.double() for t in (r, k, v, logw, u)),
            *(None if t is None else t.double() for t in (dout, dstate)))
        for g, w in zip(got, want):
            assert g.shape == w.shape and within(g, w, LINATTN_TOL)
    assert rwkv_linattn_backward.launches == launched + 3

"""Public wrapper of the flash attention kernel, GQA-aware (the port of
``repro/kernels/flash/ops.py``)."""
from __future__ import annotations

import torch

from .. import _build
from .._launch import check_tensor
from .ref import mha_ref

#: head dims the kernel is compiled for (csrc/flash_attention.cu)
HEAD_DIMS = (16, 32, 64, 128)
_DTYPE_IDS = {torch.float32: 0, torch.bfloat16: 1}


def flash_attention_plain(q, k, v, *, causal=True, window=None, scale=None):
    """The plain version in the model's layout: q (B, S, H, D), k/v
    (B, Skv, KV, D) -> (B, S, H, D).  The KV heads are expanded with
    ``repeat_interleave`` (query head h reads KV head h // (H // KV), the
    reference's ``jnp.repeat``) and handed to :func:`mha_ref`."""
    B, S, H, D = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    G = H // KV
    if G > 1:
        k = k.repeat_interleave(G, dim=2)
        v = v.repeat_interleave(G, dim=2)
    qf = q.transpose(1, 2).reshape(B * H, S, D)
    kf = k.transpose(1, 2).reshape(B * H, Skv, D)
    vf = v.transpose(1, 2).reshape(B * H, Skv, D)
    of = mha_ref(qf, kf, vf, causal=causal, window=window, scale=scale)
    return of.reshape(B, H, S, D).transpose(1, 2)


def flash_attention(q, k, v, *, causal=True, window=None, scale=None):
    """Causal / sliding-window softmax attention with GQA.

    q: (B, S, H, D); k, v: (B, Skv, KV, D), contiguous, H a multiple of
    KV, float32 or bfloat16 (all three alike).  Returns (B, S, H, D) in
    q's dtype; float32 inside, scale ``D ** -0.5`` by default, masked
    scores at -1e30, the row sum clamped at 1e-30 -- the semantics of
    ``flash_attention_pallas``.  Any S and Skv (the kernel masks the
    ragged last tile itself).

    A CUDA tensor launches the CUDA kernel (no copy of the KV heads: query
    head h reads KV head h // (H // KV) in place) or raises; the plain
    version runs only for tensors that lie on the CPU.
    """
    if not isinstance(q, torch.Tensor) or q.dim() != 4:
        raise ValueError("q must be a (B, S, H, D) tensor")
    B, S, H, D = q.shape
    if k.dim() != 4 or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"k has shape {tuple(k.shape)}; expected "
                         f"({B}, Skv, KV, {D})")
    Skv, KV = k.shape[1], k.shape[2]
    if KV < 1 or H % KV:
        raise ValueError(f"{H} query heads are not a multiple of {KV} KV "
                         "heads")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if q.dtype not in _DTYPE_IDS:
        raise TypeError(f"flash_attention takes float32 or bfloat16, got "
                        f"{q.dtype}")
    dev = q.device
    check_tensor("q", q, (B, S, H, D), q.dtype, dev)
    check_tensor("k", k, (B, Skv, KV, D), q.dtype, dev)
    check_tensor("v", v, (B, Skv, KV, D), q.dtype, dev)
    if dev.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     scale=scale)
    if dev.type != "cuda":
        raise NotImplementedError(f"flash_attention has no path for {dev}")
    if D not in HEAD_DIMS:
        raise NotImplementedError(
            f"the flash attention kernel is compiled for head dims "
            f"{HEAD_DIMS}, not {D}")
    return _launch(q, k, v, causal, window,
                   float(scale if scale is not None else D ** -0.5))


#: number of CUDA kernel launches made by this wrapper (and nothing else)
flash_attention.launches = 0


def _launch(q, k, v, causal, window, scale):
    B, S, H, D = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    if B * H == 0 or S == 0:
        return out
    lib = _build.load_library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, S, Skv, H, KV, D, scale, int(bool(causal)),
            -1 if window is None else int(window), _DTYPE_IDS[q.dtype],
            stream)
    _build.check_launch(lib, code, "flash_attention")
    flash_attention.launches += 1
    return out

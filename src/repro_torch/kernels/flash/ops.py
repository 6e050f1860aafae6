"""Public wrapper of the flash attention kernels, GQA-aware (the port of
``repro/kernels/flash/ops.py``).

Two routes, chosen by :func:`flash_route` from (dtype, head dim) alone:
``"tc"`` -- bfloat16 at D 64 / 128 / 256, the tensor-core kernel
(``csrc/flash_attention_tc.cu``: wgmma, TMA, P rounded to bf16 before
P V); ``"simt"`` -- everything else (float32, D 16 / 32), the CUDA-core
kernel (``csrc/flash_attention.cu``, float32 inside).

Training: when q, k or v requires a gradient, :func:`flash_attention`
runs as the autograd Function :class:`FlashAttention`, on the CPU too.
Its forward is the kernel (the plain version on the CPU); its backward is
:func:`flash_attention_backward`: on the card the two kernels of
``csrc/flash_attention_bwd.cu`` (float32 on the CUDA cores, from the
saved q, k, v), on the CPU
:func:`flash_attention_backward_plain` -- autograd through the plain
version, counted in ``flash_attention.plain_backwards``.  The reference
differentiates its pure-JAX ``chunked_attention`` and has no backward
kernel; the backward kernels replace no TPU kernel."""
from __future__ import annotations

import torch

from .. import _build
from .._launch import check_tensor, count_meta
from .ref import mha_ref

#: head dims the kernel is compiled for (csrc/flash_attention.cu)
HEAD_DIMS = (16, 32, 64, 128, 256)
#: head dims of the tensor-core route (csrc/flash_attention_tc.cu)
TC_HEAD_DIMS = (64, 128, 256)
_DTYPE_IDS = {torch.float32: 0, torch.bfloat16: 1}
ROUTES = ("tc", "simt")


def flash_route(dtype, head_dim: int) -> str:
    """The kernel a CUDA call takes: ``"tc"`` (tensor cores) for bfloat16
    at head dims 64, 128 and 256, ``"simt"`` (CUDA cores, float32 inside)
    otherwise -- TF32 products would not hold float32's tolerance."""
    return ("tc" if dtype == torch.bfloat16 and head_dim in TC_HEAD_DIMS
            else "simt")


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
    ragged last tile itself).  On the ``"tc"`` route (:func:`flash_route`)
    q k^T is formed from the bf16 operands and p is rounded to bf16 before
    p v -- one bf16 rounding more than float32 inside -- and on the card
    q, k, v must start on 16-byte boundaries (TMA reads them).

    A CUDA tensor launches the route's CUDA kernel (no copy of the KV
    heads: query head h reads KV head h // (H // KV) in place) or raises;
    the plain version runs only for tensors that lie on the CPU.  A meta
    tensor (the dry run) gets an output of the right shape and its work
    counted (:func:`_meta`).
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
    if dev.type not in ("cpu", "cuda", "meta"):
        raise NotImplementedError(f"flash_attention has no path for {dev}")
    if dev.type == "cuda" and D not in HEAD_DIMS:
        raise NotImplementedError(
            f"the flash attention kernel is compiled for head dims "
            f"{HEAD_DIMS}, not {D}")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttention.apply(q, k, v, causal, window, scale)
    return _forward(q, k, v, causal, window, scale)


def _forward(q, k, v, causal, window, scale):
    """The kernel of :func:`flash_route`'s route on checked CUDA arguments
    (the plain version on the CPU)."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     scale=scale)
    if q.device.type == "meta":
        return _meta(q, k, v, causal, window)
    D = q.shape[3]
    route = flash_route(q.dtype, D)
    if route == "tc":
        check_tma_alignment(q, k, v)
    return _launch(q, k, v, causal, window,
                   float(scale if scale is not None else D ** -0.5), route)


def attention_pairs(S: int, Skv: int, causal: bool, window) -> int:
    """The (query, key) pairs the mask keeps: query i reads keys j <= i
    (causal) within ``window`` (i - j < window), as the plain version
    masks them."""
    if not causal:
        return S * Skv
    w = min(Skv, window if window is not None else Skv)
    ramp = min(S, w)                  # queries i < w read i + 1 keys
    return ramp * (ramp + 1) // 2 + (S - ramp) * w


def _meta(q, k, v, causal, window):
    """The meta path (shapes only, for the dry run): the output's shape,
    and the kernel's work -- 4 B H D FLOPs a kept (query, key) pair, q, k,
    v and the output once each -- added to ``_launch.META_WORK``."""
    B, S, H, D = q.shape
    out = torch.empty_like(q)
    count_meta(4 * B * H * D * attention_pairs(S, k.shape[1], causal,
                                               window), q, k, v, out)
    return out


class FlashAttention(torch.autograd.Function):
    """Forward: the kernel (:func:`_forward`).  Backward:
    :func:`flash_attention_backward` from the saved q, k, v."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale):
        ctx.save_for_backward(q, k, v)
        ctx.args = (causal, window, scale)
        return _forward(q, k, v, causal, window, scale)

    @staticmethod
    def backward(ctx, dout):
        q, k, v = ctx.saved_tensors      # unpacked once (checkpointing)
        causal, window, scale = ctx.args
        grads = flash_attention_backward(
            q, k, v, dout.to(q.dtype).contiguous(), causal=causal,
            window=window, scale=scale)
        need = ctx.needs_input_grad[:3]
        return (*(g if n else None for g, n in zip(grads, need)), None,
                None, None)


def flash_attention_backward_plain(q, k, v, dout, *, causal=True,
                                   window=None, scale=None):
    """The plain backward: (dq, dk, dv) of :func:`flash_attention_plain`
    for the output gradient ``dout``, by autograd through it recomputed
    from q, k, v (float32 inside, float64 for float64 inputs; gradients in
    the inputs' dtype, the GQA heads' dk / dv summed in that dtype)."""
    with torch.enable_grad():
        ins = [t.detach().requires_grad_(True) for t in (q, k, v)]
        out = flash_attention_plain(*ins, causal=causal, window=window,
                                    scale=scale)
        return torch.autograd.grad(out, ins, dout)


#: FLOPs per kept (query, key) pair and head dim of the backward kernels:
#: the dq kernel's two passes (q.k, dout.v; q.k, dout.v, ds.k) and the
#: dk / dv kernel's q.k, dout.v, ds^T.q, p^T.dout, 2 flops each
BACKWARD_FLOPS = 18


def flash_attention_backward(q, k, v, dout, *, causal=True, window=None,
                             scale=None):
    """(dq, dk, dv) of :func:`flash_attention` for the output gradient
    ``dout``: q, dout (B, S, H, D), k, v (B, Skv, KV, D), contiguous, one
    dtype (float32 or bfloat16); gradients in that dtype, float32 inside
    (each row's softmax statistics and rowsum(p dp) recomputed from the
    scores), dk / dv summed over the H / KV query heads of each KV head
    before they are rounded.  The semantics of autograd through the plain
    version: masked scores get no gradient, a query row with no unmasked
    key gets zero gradients.

    A CUDA tensor launches the two kernels of
    ``csrc/flash_attention_bwd.cu`` or raises; a CPU tensor takes
    :func:`flash_attention_backward_plain` (counted in
    ``flash_attention.plain_backwards``); a meta tensor (the dry run)
    gets outputs of the right shape and the kernels' work counted."""
    B, S, H, D = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    dev = q.device
    if q.dtype not in _DTYPE_IDS:
        raise TypeError(f"flash_attention_backward takes float32 or "
                        f"bfloat16, got {q.dtype}")
    for name, t, shape in (("q", q, (B, S, H, D)), ("k", k, (B, Skv, KV, D)),
                           ("v", v, (B, Skv, KV, D)),
                           ("dout", dout, (B, S, H, D))):
        check_tensor(name, t, shape, q.dtype, dev)
    if KV < 1 or H % KV:
        raise ValueError(f"{H} query heads are not a multiple of {KV} KV "
                         "heads")
    if dev.type == "cpu":
        flash_attention.plain_backwards += 1
        return flash_attention_backward_plain(q, k, v, dout, causal=causal,
                                              window=window, scale=scale)
    if dev.type == "meta":
        grads = tuple(torch.empty_like(t) for t in (q, k, v))
        count_meta(BACKWARD_FLOPS * B * H * D * attention_pairs(
            S, Skv, causal, window), q, k, v, dout, *grads)
        return grads
    if dev.type != "cuda":
        raise NotImplementedError(
            f"flash_attention_backward has no path for {dev}")
    if D not in HEAD_DIMS:
        raise NotImplementedError(
            f"the flash attention backward kernels are compiled for head "
            f"dims {HEAD_DIMS}, not {D}")
    return _backward_launch(q, k, v, dout, causal, window, float(
        scale if scale is not None else D ** -0.5))


def check_tma_alignment(q, k, v):
    """Raise unless q, k and v start on 16-byte boundaries: the
    tensor-core kernel reads them by TMA (a CUDA constraint; the plain
    version on the CPU has none)."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.data_ptr() % 16:
            raise ValueError(
                f"{name} starts at a 16-byte misaligned address; the "
                "tensor-core route reads it by TMA (pass a fresh "
                "contiguous tensor)")


#: number of CUDA kernel launches made by this wrapper (and nothing else),
#: in all, per route and per "route/head dim"; and of backward calls that
#: took the plain backward (tensors on the CPU)
flash_attention.launches = 0
flash_attention.launches_by_route = dict.fromkeys(ROUTES, 0)
flash_attention.launches_by_head_dim = {}
flash_attention.plain_backwards = 0
#: backward calls that launched the backward kernels (one a call), per
#: route (one: the CUDA cores) and per kernel (each launch of each)
flash_attention_backward.launches = 0
flash_attention_backward.launches_by_route = {"simt": 0}
flash_attention_backward.launches_by_kernel = {"dq": 0, "dkv": 0}


def _launch(q, k, v, causal, window, scale, route):
    """Launch the kernel of ``route`` on checked CUDA arguments.  The
    wrapper passes :func:`flash_route`'s choice; ``chip_smoke.py`` also
    passes ``"simt"`` for a bf16 call the tensor-core route takes, to time
    the route that the main path took before."""
    B, S, H, D = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    if B * H == 0 or S == 0:
        return out
    lib = _build.load_library()
    win = -1 if window is None else int(window)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        if route == "tc":
            code = lib.flash_attention_tc_launch(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                B, S, Skv, H, KV, D, scale, int(bool(causal)), win, stream)
        else:
            code = lib.flash_attention_launch(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                B, S, Skv, H, KV, D, scale, int(bool(causal)), win,
                _DTYPE_IDS[q.dtype], stream)
    _build.check_launch(lib, code, f"flash_attention ({route} route)")
    flash_attention.launches += 1
    flash_attention.launches_by_route[route] += 1
    by_dim = flash_attention.launches_by_head_dim
    by_dim[f"{route}/{D}"] = by_dim.get(f"{route}/{D}", 0) + 1
    return out


def _backward_launch(q, k, v, dout, causal, window, scale):
    """The two backward kernels on checked CUDA arguments: the dq kernel
    (which also writes each row's log-sum-exp and rowsum(p dp) to a
    float32 scratch), then the dk / dv kernel that reads them."""
    B, S, H, D = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    if B * H == 0 or S == 0 or Skv == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    lse = torch.empty((B * H, S), dtype=torch.float32, device=q.device)
    delta = torch.empty_like(lse)
    lib = _build.load_library()
    win = -1 if window is None else int(window)
    dims = (B, S, Skv, H, KV, D, scale, int(bool(causal)), win,
            _DTYPE_IDS[q.dtype])
    by_kernel = flash_attention_backward.launches_by_kernel
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.flash_attention_bwd_dq_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            dq.data_ptr(), lse.data_ptr(), delta.data_ptr(), *dims, stream)
        _build.check_launch(lib, code, "flash_attention backward (dq)")
        by_kernel["dq"] += 1
        code = lib.flash_attention_bwd_dkv_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            *dims, stream)
        _build.check_launch(lib, code, "flash_attention backward (dk, dv)")
        by_kernel["dkv"] += 1
    flash_attention_backward.launches += 1
    flash_attention_backward.launches_by_route["simt"] += 1
    return dq, dk, dv

"""Public wrapper of the chunked RWKV6 linear-attention kernels (the port of
``repro/kernels/linattn/ops.py``).

Two routes, chosen by :func:`linattn_route` from the head dim and the
chunk alone: ``"tc"`` (``csrc/rwkv_linattn_tc.cu``) -- the three matrix
terms on the tensor cores in 3xTF32, 16-token sub-chunks for the scores --
at head dim 64 with chunks of 64 tokens, which is every RWKV6 prefill;
``"simt"`` (``csrc/rwkv_linattn.cu``) -- float32 FMAs on the CUDA cores --
for head dims 16 / 32 or smaller chunks.  Both compute the same function.

Training: when an input requires a gradient, :func:`rwkv_linattn` runs as
the autograd Function :class:`RwkvLinattn`, on the CPU too.  Its forward
is the kernel (the plain version on the CPU); its backward is
:func:`rwkv_linattn_backward`, the gradient of the exact recurrence for r,
k, v, logw and u: on the card the two kernels of
``csrc/rwkv_linattn_bwd.cu`` (a forward sweep writing state checkpoints,
then a reverse sweep recomputing each chunk's states), on the CPU
:func:`rwkv_linattn_backward_plain` -- autograd through
:func:`rwkv_linattn_ref` (the reference's ``rwkv_scan``), counted in
``rwkv_linattn.plain_backwards``.  The reference differentiates
``rwkv_scan`` with ``jax.grad``; the backward kernels replace no TPU
kernel.
"""
from __future__ import annotations

import math

import torch

from .. import _build
from .._launch import check_tensor, count_meta
from .ref import rwkv_linattn_ref

#: head dims the kernels are compiled for (csrc/rwkv_linattn.cu; the
#: tensor-core kernel takes 64 only)
HEAD_DIMS = (16, 32, 64)
MAX_CHUNK = 64
ROUTES = ("tc", "simt")
#: the one head dim and chunk of the tensor-core kernel
TC_HEAD_DIM = 64
TC_CHUNK = 64


def linattn_route(D: int, chunk: int) -> str:
    """The kernel a CUDA call takes, by head dim and chunk alone:
    ``"tc"`` at D = ``TC_HEAD_DIM`` with chunks of ``TC_CHUNK`` tokens
    (any S: a short sequence is one zero-padded chunk), else ``"simt"``."""
    return "tc" if (D, chunk) == (TC_HEAD_DIM, TC_CHUNK) else "simt"


#: FLOPs a token, row and D^2 of the recurrence: the state update
#: w * S + k^T v (3) and the output r (S + u k^T v) (5)
RECURRENCE_FLOPS = 8


def rwkv_linattn(r, k, v, logw, u, *, chunk=64):
    """Chunked RWKV6 linear attention from a zero state.

    r, k, v, logw: (BH, S, D) contiguous, rows ordered b * H + h, logw
    <= 0; u: (D,) shared by every row (the Pallas kernel's signature) or
    (H, D) per head (row bh reads ``u[bh % H]``).  The kernel computes in
    float32; inputs of another float dtype are cast.  Returns (out
    (BH, S, D) in r's dtype, final state (BH, D, D) float32).  ``chunk``
    tokens per chunk (at most 64, and at most S); S need not be a multiple
    of it.

    A CUDA tensor launches the route's CUDA kernel (:func:`linattn_route`)
    or raises; the plain version (the exact sequential recurrence) runs
    only for tensors that lie on the CPU.  A meta tensor (the dry run)
    gets outputs of the right shape and its work counted in
    ``_launch.META_WORK``.
    """
    if not isinstance(r, torch.Tensor) or r.dim() != 3:
        raise ValueError("r must be a (BH, S, D) tensor")
    BH, S, D = r.shape
    dev = r.device
    for name, t in (("k", k), ("v", v), ("logw", logw)):
        check_tensor(name, t, (BH, S, D), t.dtype, dev)
    check_tensor("r", r, (BH, S, D), r.dtype, dev)
    if u.dim() == 1:
        check_tensor("u", u, (D,), u.dtype, dev)
        H = 1
    elif u.dim() == 2:
        H = u.shape[0]
        check_tensor("u", u, (H, D), u.dtype, dev)
        if H < 1 or BH % H:
            raise ValueError(f"{BH} rows are not a multiple of {H} heads")
    else:
        raise ValueError(f"u must be (D,) or (H, D), got {tuple(u.shape)}")
    if not 1 <= chunk <= MAX_CHUNK:
        raise ValueError(f"chunk must be in [1, {MAX_CHUNK}], got {chunk}")
    if dev.type not in ("cpu", "cuda", "meta"):
        raise NotImplementedError(f"rwkv_linattn has no path for {dev}")
    if dev.type == "cuda" and D not in HEAD_DIMS:
        raise NotImplementedError(
            f"the linear-attention kernel is compiled for head dims "
            f"{HEAD_DIMS}, not {D}")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (r, k, v, logw, u)):
        return RwkvLinattn.apply(r, k, v, logw, u, chunk)
    return _forward(r, k, v, logw, u, chunk)


def _forward(r, k, v, logw, u, chunk):
    """The route's kernel on checked CUDA arguments (the plain version on
    the CPU); returns (out in r's dtype, state)."""
    if r.device.type == "cpu":
        out, state = rwkv_linattn_ref(r, k, v, logw, u)
        return out.to(r.dtype), state
    BH, S, D = r.shape
    if r.device.type == "meta":
        out = torch.empty_like(r)
        state = torch.empty((BH, D, D), dtype=torch.float32, device="meta")
        count_meta(RECURRENCE_FLOPS * BH * S * D * D, r, k, v, logw, u,
                   out, state)
        return out, state
    H = u.shape[0] if u.dim() == 2 else 1
    route = linattn_route(D, chunk)
    out, state = _launch(*(t.float().contiguous() for t in (r, k, v, logw)),
                         u.float().reshape(H, D).contiguous(), H,
                         TC_CHUNK if route == "tc" else min(chunk, S), route)
    return out.to(r.dtype), state


class RwkvLinattn(torch.autograd.Function):
    """Forward: the kernel (:func:`_forward`).  Backward:
    :func:`rwkv_linattn_backward` from the saved inputs."""

    @staticmethod
    def forward(ctx, r, k, v, logw, u, chunk):
        ctx.save_for_backward(r, k, v, logw, u)
        ctx.set_materialize_grads(False)
        return _forward(r, k, v, logw, u, chunk)

    @staticmethod
    def backward(ctx, dout, dstate):
        grads = rwkv_linattn_backward(*ctx.saved_tensors, dout, dstate)
        need = ctx.needs_input_grad[:5]
        return (*(g if n else None for g, n in zip(grads, need)), None)


def rwkv_linattn_backward_plain(r, k, v, logw, u, dout, dstate):
    """The plain backward: (dr, dk, dv, dlogw, du) of
    :func:`rwkv_linattn_ref` for the gradients ``dout`` of the output and
    ``dstate`` of the final state (either may be None: zero), by autograd
    through it recomputed from the inputs -- float32 inside, float64 for
    float64 inputs; gradients in the inputs' dtypes."""
    dtype = torch.float64 if r.dtype == torch.float64 else torch.float32
    with torch.enable_grad():
        ins = [t.detach().requires_grad_(True) for t in (r, k, v, logw, u)]
        out, state = rwkv_linattn_ref(*ins, dtype=dtype)
        pairs = [(o, d.to(o.dtype)) for o, d in ((out.to(r.dtype), dout),
                                                 (state, dstate))
                 if d is not None]
        got = [None] * len(ins)
        if pairs:
            outs, douts = zip(*pairs)
            got = torch.autograd.grad(outs, ins, douts, allow_unused=True)
    return tuple(torch.zeros_like(t) if g is None else g
                 for t, g in zip(ins, got))


#: FLOPs a token, row and D^2 of the backward kernels: the forward sweep's
#: state update (3) and dr (2); the reverse sweep's recompute (3), dk (2),
#: dlogw (2), dv (3) and the update of the state's gradient (3)
BACKWARD_FLOPS = 18


def backward_chunk(S: int) -> int:
    """Tokens a chunk of the backward's reverse sweep: ceil(sqrt(S)) (at
    most MAX_CHUNK), so that its two float32 scratches -- ceil(S / C)
    state checkpoints and C recomputed states a row -- are both
    O(sqrt(S) D^2) floats a row."""
    return max(1, min(MAX_CHUNK, math.isqrt(max(S - 1, 0)) + 1))


def rwkv_linattn_backward(r, k, v, logw, u, dout, dstate):
    """(dr, dk, dv, dlogw, du) of :func:`rwkv_linattn` (from a zero state)
    for the gradients ``dout`` (BH, S, D) of the output and ``dstate``
    (BH, D, D) of the final state, either None for zero; each gradient in
    its input's dtype and shape (du summed over the rows of its head, or
    over every row for a (D,) u).

    A CUDA tensor launches the two kernels of ``csrc/rwkv_linattn_bwd.cu``
    (float32 inside) or raises; a CPU tensor takes
    :func:`rwkv_linattn_backward_plain` (counted in
    ``rwkv_linattn.plain_backwards``); a meta tensor (the dry run) gets
    outputs of the right shape and the kernels' work counted."""
    BH, S, D = r.shape
    dev = r.device
    for name, t in (("r", r), ("k", k), ("v", v), ("logw", logw)):
        check_tensor(name, t, (BH, S, D), t.dtype, dev)
    H = u.shape[0] if u.dim() == 2 else 1
    check_tensor("u", u, (H, D) if u.dim() == 2 else (D,), u.dtype, dev)
    if BH % H:
        raise ValueError(f"{BH} rows are not a multiple of {H} heads")
    for name, t, shape in (("dout", dout, (BH, S, D)),
                           ("dstate", dstate, (BH, D, D))):
        if t is not None and (tuple(t.shape) != shape or t.device != dev):
            raise ValueError(f"{name} is {tuple(t.shape)} on {t.device}; "
                             f"expected {shape} on {dev}")
    if dev.type == "cpu":
        rwkv_linattn.plain_backwards += 1
        return rwkv_linattn_backward_plain(r, k, v, logw, u, dout, dstate)
    ins = (r, k, v, logw, u)
    if dev.type == "meta":
        grads = tuple(torch.empty_like(t) for t in ins)
        count_meta(BACKWARD_FLOPS * BH * S * D * D, *ins,
                   *(t for t in (dout, dstate) if t is not None), *grads)
        return grads
    if dev.type != "cuda":
        raise NotImplementedError(
            f"rwkv_linattn_backward has no path for {dev}")
    if D not in HEAD_DIMS:
        raise NotImplementedError(
            f"the linear-attention backward kernels are compiled for head "
            f"dims {HEAD_DIMS}, not {D}")
    grads = _backward_launch(
        *(t.float().contiguous() for t in (r, k, v, logw)),
        u.float().reshape(H, D).contiguous(),
        *(None if t is None else t.float().contiguous()
          for t in (dout, dstate)), H, backward_chunk(S))
    return tuple(g.reshape(t.shape).to(t.dtype) for g, t in zip(grads, ins))


#: number of CUDA kernel launches made by this wrapper (and nothing else),
#: in all and per route; and of backward calls that took the plain
#: backward (tensors on the CPU)
rwkv_linattn.launches = 0
rwkv_linattn.launches_by_route = dict.fromkeys(ROUTES, 0)
rwkv_linattn.plain_backwards = 0
#: backward calls that launched the backward kernels (one a call), per
#: route (one: the CUDA cores) and per kernel (each launch of each)
rwkv_linattn_backward.launches = 0
rwkv_linattn_backward.launches_by_route = {"simt": 0}
rwkv_linattn_backward.launches_by_kernel = {"forward_sweep": 0,
                                            "reverse_sweep": 0}


def _launch(r, k, v, logw, u, H, C, route):
    """Launch one route on float32 contiguous inputs; ``chip_smoke.py``
    also calls it with ``route="simt"`` at the main-path shape, to time
    the route the tensor-core kernel replaced."""
    BH, S, D = r.shape
    out = torch.empty_like(r)
    state = torch.empty((BH, D, D), dtype=torch.float32, device=r.device)
    if BH == 0 or S == 0:
        return out, state.zero_()
    lib = _build.load_library()
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream().cuda_stream
        launch = {"tc": lib.rwkv_linattn_tc_launch,
                  "simt": lib.rwkv_linattn_launch}[route]
        code = launch(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), logw.data_ptr(),
            u.data_ptr(), out.data_ptr(), state.data_ptr(), BH, S, D, H, C,
            stream)
    _build.check_launch(lib, code, f"rwkv_linattn ({route})")
    rwkv_linattn.launches += 1
    rwkv_linattn.launches_by_route[route] += 1
    return out, state


def _backward_launch(r, k, v, logw, u, dout, dstate, H, C):
    """The two backward kernels on float32 contiguous CUDA arguments
    (``dout`` / ``dstate`` None: zero): the forward sweep (dr, each row's
    du terms and a state checkpoint every C tokens), then the reverse
    sweep (dk, dv, dlogw, du).  Returns (dr, dk, dv, dlogw, du (H, D))."""
    BH, S, D = r.shape
    dr, dk, dv, dlogw = (torch.empty_like(r) for _ in range(4))
    du = torch.empty((H, D), dtype=torch.float32, device=r.device)
    if BH == 0 or S == 0:
        return dr.zero_(), dk.zero_(), dv.zero_(), dlogw.zero_(), du.zero_()
    ck = torch.empty((BH, -(-S // C), D, D), dtype=torch.float32,
                     device=r.device)
    states = torch.empty((BH, C, D, D), dtype=torch.float32,
                         device=r.device)
    du_rows = torch.empty((BH, D), dtype=torch.float32, device=r.device)
    lib = _build.load_library()

    def ptr(t):
        return None if t is None else t.data_ptr()
    by_kernel = rwkv_linattn_backward.launches_by_kernel
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.rwkv_linattn_bwd_forward_launch(
            *map(ptr, (r, k, v, logw, u, dout, dr, du_rows, ck)), BH, S, D,
            H, C, stream)
        _build.check_launch(lib, code, "rwkv_linattn backward (forward "
                            "sweep)")
        by_kernel["forward_sweep"] += 1
        code = lib.rwkv_linattn_bwd_reverse_launch(
            *map(ptr, (r, k, v, logw, u, dout, dstate, ck, du_rows, dk, dv,
                       dlogw, du, states)), BH, S, D, H, C, stream)
        _build.check_launch(lib, code, "rwkv_linattn backward (reverse "
                            "sweep)")
        by_kernel["reverse_sweep"] += 1
    rwkv_linattn_backward.launches += 1
    rwkv_linattn_backward.launches_by_route["simt"] += 1
    return dr, dk, dv, dlogw, du

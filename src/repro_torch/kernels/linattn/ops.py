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
``torch.autograd.grad`` through the exact recurrence
(:func:`rwkv_linattn_ref`, the reference's ``rwkv_scan``) recomputed from
the saved inputs, so gradients reach r, k, v, logw and u.  Backward calls
are counted in ``rwkv_linattn.plain_backwards``, apart from the forward
launches.
"""
from __future__ import annotations

import torch

from .. import _build
from .._launch import check_tensor
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
    only for tensors that lie on the CPU.
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
    if dev.type not in ("cpu", "cuda"):
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
    H = u.shape[0] if u.dim() == 2 else 1
    route = linattn_route(D, chunk)
    out, state = _launch(*(t.float().contiguous() for t in (r, k, v, logw)),
                         u.float().reshape(H, D).contiguous(), H,
                         TC_CHUNK if route == "tc" else min(chunk, S), route)
    return out.to(r.dtype), state


class RwkvLinattn(torch.autograd.Function):
    """Forward: the kernel (:func:`_forward`).  Backward: autograd through
    :func:`rwkv_linattn_ref` recomputed from the saved inputs."""

    @staticmethod
    def forward(ctx, r, k, v, logw, u, chunk):
        ctx.save_for_backward(r, k, v, logw, u)
        ctx.set_materialize_grads(False)
        return _forward(r, k, v, logw, u, chunk)

    @staticmethod
    def backward(ctx, dout, dstate):
        rwkv_linattn.plain_backwards += 1
        need = ctx.needs_input_grad[:5]
        with torch.enable_grad():
            ins = [t.detach().requires_grad_(n)
                   for t, n in zip(ctx.saved_tensors, need)]
            out, state = rwkv_linattn_ref(*ins)
            outs, douts = zip(*[(o, d) for o, d in ((out.to(ins[0].dtype),
                                                     dout), (state, dstate))
                                if d is not None])
            wrt = [t for t in ins if t.requires_grad]
            got = iter(torch.autograd.grad(outs, wrt, douts,
                                           allow_unused=True))
        grads = []
        for t, n in zip(ins, need):
            g = next(got) if n else None
            grads.append(torch.zeros_like(t) if n and g is None else g)
        return (*grads, None)


#: number of CUDA kernel launches made by this wrapper (and nothing else),
#: in all and per route; and of backward calls (autograd through the
#: exact recurrence, on any device)
rwkv_linattn.launches = 0
rwkv_linattn.launches_by_route = dict.fromkeys(ROUTES, 0)
rwkv_linattn.plain_backwards = 0


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

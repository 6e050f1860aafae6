"""Public wrapper of the chunked RWKV6 linear-attention kernel (the port of
``repro/kernels/linattn/ops.py``)."""
from __future__ import annotations

import torch

from .. import _build
from .._launch import check_tensor
from .ref import rwkv_linattn_ref

#: head dims the kernel is compiled for (csrc/rwkv_linattn.cu)
HEAD_DIMS = (16, 32, 64)
MAX_CHUNK = 64


def rwkv_linattn(r, k, v, logw, u, *, chunk=64):
    """Chunked RWKV6 linear attention from a zero state.

    r, k, v, logw: (BH, S, D) contiguous, rows ordered b * H + h, logw
    <= 0; u: (D,) shared by every row (the Pallas kernel's signature) or
    (H, D) per head (row bh reads ``u[bh % H]``).  The kernel computes in
    float32; inputs of another float dtype are cast.  Returns (out
    (BH, S, D) in r's dtype, final state (BH, D, D) float32).  ``chunk``
    tokens per chunk (at most 64, and at most S); S need not be a multiple
    of it.

    A CUDA tensor launches the CUDA kernel or raises; the plain version
    (the exact sequential recurrence) runs only for tensors that lie on
    the CPU.
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
    if dev.type == "cpu":
        out, state = rwkv_linattn_ref(r, k, v, logw, u)
        return out.to(r.dtype), state
    if dev.type != "cuda":
        raise NotImplementedError(f"rwkv_linattn has no path for {dev}")
    if D not in HEAD_DIMS:
        raise NotImplementedError(
            f"the linear-attention kernel is compiled for head dims "
            f"{HEAD_DIMS}, not {D}")
    out, state = _launch(*(t.float().contiguous() for t in (r, k, v, logw)),
                         u.float().reshape(H, D).contiguous(), H,
                         min(chunk, S))
    return out.to(r.dtype), state


#: number of CUDA kernel launches made by this wrapper (and nothing else)
rwkv_linattn.launches = 0


def _launch(r, k, v, logw, u, H, C):
    BH, S, D = r.shape
    out = torch.empty_like(r)
    state = torch.empty((BH, D, D), dtype=torch.float32, device=r.device)
    if BH == 0 or S == 0:
        return out, state.zero_()
    lib = _build.load_library()
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.rwkv_linattn_launch(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), logw.data_ptr(),
            u.data_ptr(), out.data_ptr(), state.data_ptr(), BH, S, D, H, C,
            stream)
    _build.check_launch(lib, code, "rwkv_linattn")
    rwkv_linattn.launches += 1
    return out, state

"""Argument checks and launch geometry shared by the kernel wrappers."""
from __future__ import annotations

import torch

LOSS_IDS = {"hinge": 0, "squared": 1}
#: dynamic shared memory a block may use on sm_90, less the kernels'
#: static scratch (mirrors ``kMaxDynamicSmem`` in csrc/common.cuh)
MAX_DYNAMIC_SMEM = 232448 - 2048


def check_loss(loss: str, what: str) -> int:
    if loss not in LOSS_IDS:
        raise NotImplementedError(
            f"{what} covers losses {tuple(LOSS_IDS)}, not {loss!r}; use "
            f"local_backend='ref' for {loss}")
    return LOSS_IDS[loss]


def check_tensor(name: str, t, shape, dtype, device):
    """Raise unless ``t`` is a contiguous tensor of exactly this shape,
    dtype and device -- the kernels index raw pointers."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor, got {type(t)}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if t.device != device:
        raise ValueError(f"{name} lies on {t.device}, expected {device} "
                         "(all arguments of one call share a device)")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous (strides "
                         f"{t.stride()} for shape {tuple(t.shape)})")


def block_threads(m: int) -> int:
    """Threads per block for a resident vector of ``m`` floats: about
    four elements a thread, a whole number of warps, 32..256."""
    warps = -(-m // 128)
    return 32 * max(1, min(8, warps))


def check_smem(nbytes: int, what: str):
    if nbytes > MAX_DYNAMIC_SMEM:
        raise ValueError(
            f"{what} needs {nbytes} bytes of shared memory per block, over "
            f"the {MAX_DYNAMIC_SMEM} a block can use on this architecture; "
            "partition the features into more blocks (larger Q)")

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


def is_per_cell(*scalars) -> bool:
    """True when any of the step's scalars is a tensor -- per cell (or
    per tenant, broadcast over the grid) -- rather than one number."""
    return any(isinstance(v, torch.Tensor) for v in scalars)


def scalar_arg(v) -> float:
    """The kernels' scalar argument for a step scalar: the number itself,
    or 0.0 when it is a tensor (the kernel then reads ``cell_params``)."""
    return 0.0 if isinstance(v, torch.Tensor) else float(v)


def per_cell(v, lead, device) -> torch.Tensor:
    """A scalar, or a tensor broadcastable to the cell grid ``lead`` --
    ``(P, Q)``, or ``(P, Q, T)`` with a tenant axis, so a per-tenant
    ``(T,)`` vector applies to every cell of its tenant -- as one
    float32 value per cell, flat in cell order ``(p * Q + q) * T + t``."""
    return torch.as_tensor(v, dtype=torch.float32,
                           device=device).expand(lead).reshape(-1)


#: where each argument of the four solver wrappers takes the tenant axis:
#: right after the grid axes it varies over -- blocks ``(P, Q, T, ...)``,
#: row vectors and ``lo`` ``(P, T, ...)``, ``w0 (Q, T, m_q)``, SVRG
#: windows and orders ``(P, Q, T, ...)``.  In the wrappers' argument
#: order, ``lo`` last.
TENANT_AXES = {
    "sdca_epoch": {"x": 2, "y": 1, "mask": 1, "alpha0": 1, "w0": 1,
                   "idx": 1},
    "sdca_epoch_sparse": {"cols": 2, "vals": 2, "y": 1, "mask": 1,
                          "alpha0": 1, "w0": 1, "idx": 1},
    "svrg_inner": {"x": 2, "y": 1, "mask": 1, "z_anchor": 1,
                   "w_anchor": 2, "mu": 2, "idx": 2, "lo": 1},
    "svrg_inner_sparse": {"cols": 2, "vals": 2, "y": 1, "mask": 1,
                          "z_anchor": 1, "w_anchor": 2, "mu": 2, "idx": 2,
                          "lo": 1},
}


def tenant_axes(name: str):
    """The tenant axis of each argument of wrapper ``name``, in order."""
    return tuple(TENANT_AXES[name].values())


def cell_index(P: int, Q: int, T: int, device):
    """The kernels' decode of the flat cell index ``c = (p*Q + q)*T + t``:
    ``(cells, row, col)`` -- ``arange(P*Q*T)``, each cell's row group
    ``p*T + t`` (its slice of the ``(P, T, n_p)`` row vectors and of
    ``lo``) and its column group ``q*T + t`` (its slice of ``w0
    (Q, T, m_q)``).  T = 1 is the grid without a tenant axis."""
    c = torch.arange(P * Q * T, device=device)
    t = c % T
    return c, (c // (Q * T)) * T + t, ((c // T) % Q) * T + t


def cell_params(lead, device, *scalars) -> torch.Tensor:
    """``(cells, len(scalars))`` float32, contiguous: the per-cell
    scalars the kernels read (``cell_params`` of ``csrc/*.cu``), one row
    per cell in cell order."""
    return torch.stack([per_cell(v, lead, device) for v in scalars],
                       dim=1).contiguous()


def block_threads(m: int) -> int:
    """Threads per block for a resident vector of ``m`` floats: about
    four elements a thread, a whole number of warps, 32..256."""
    warps = -(-m // 128)
    return 32 * max(1, min(8, warps))


def ell_threads(k: int, m: int = 0, max_warps: int = 8) -> int:
    """Threads per block for a kernel that walks ELL rows of ``k`` slots
    and, where it also sweeps a dense vector of ``m`` floats every step,
    that vector: a warp per 32 slots and per 128 elements, at least four
    warps, at most ``max_warps``."""
    warps = max(4, -(-k // 32), -(-m // 128))
    return 32 * min(max_warps, warps)


def check_smem(nbytes: int, what: str):
    if nbytes > MAX_DYNAMIC_SMEM:
        raise ValueError(
            f"{what} needs {nbytes} bytes of shared memory per block, over "
            f"the {MAX_DYNAMIC_SMEM} a block can use on this architecture; "
            "partition the features into more blocks (larger Q)")

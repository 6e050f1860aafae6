"""Hand-written CUDA kernels (Hopper, sm_90a) for the cell-local hot spots.

  sdca/    local dual coordinate ascent epoch (paper Algorithm 2)
  svrg/    RADiSA inner loop (paper Algorithm 3 steps 7-10)

Each package: ``ops.py`` (the public wrapper: checks its arguments,
launches the CUDA kernel for tensors on a CUDA device or raises, and
takes the plain PyTorch version only for tensors that lie on the CPU)
and ``ref.py`` (the plain PyTorch version of the same batched function).
The CUDA sources live in ``repro_torch/csrc``; ``_build`` compiles them
with ``nvcc`` at first use into one shared library with a plain C
interface, loaded through ``ctypes``.
"""
from ._build import build_info, load_library

__all__ = ["build_info", "load_library"]

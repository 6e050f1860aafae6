"""Hand-written CUDA kernels (Hopper, sm_90a): the solvers' cell-local hot
spots and the LM prefill's two attention kernels.

  sdca/    local dual coordinate ascent epoch (paper Algorithm 2), on
           dense blocks and on padded-ELL sparse cells
  svrg/    RADiSA / SFK inner loop (paper Algorithm 3 steps 7-10), on
           dense blocks and on padded-ELL sparse cells
  flash/   causal / sliding-window flash attention with GQA (the LM
           prefill's attention, ``models/attention.py::chunked_attention``)
  linattn/ chunked RWKV6 linear attention (the LM prefill's time mix,
           ``models/rwkv.py::rwkv_scan``)

Each package: ``ops.py`` (the public wrapper of its kernel: checks
its arguments, launches the CUDA kernel for tensors on a CUDA device or
raises, and takes the plain PyTorch version only for tensors that lie on
the CPU), ``ref.py`` (the plain PyTorch version of the same batched
function) and, for sdca/ and svrg/, ``sparse.py`` (the sparse kernel's
wrapper and plain version, under the same rules).
The CUDA sources live in ``repro_torch/csrc``; ``_build`` compiles them
with ``nvcc`` at first use into one shared library with a plain C
interface, loaded through ``ctypes``.
"""
from ._build import build_info, load_library

__all__ = ["build_info", "load_library"]

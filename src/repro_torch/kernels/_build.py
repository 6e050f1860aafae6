"""Build and load the CUDA kernels of ``repro_torch/csrc``.

The sources are compiled with ``nvcc`` for ``sm_90a`` at first use --
never at import time -- into ``<checkout>/build/repro_torch/<hash>/``,
keyed on a hash of the sources and the compiler flags, so an unchanged
tree reuses its library and an edited source gets a new one.  Every
source is compiled by its own ``nvcc`` process, all started together,
and the objects are linked into one shared library with a plain C
interface that ``ctypes`` loads.  PyTorch's headers are not involved,
which keeps a build at a few seconds.

There is no fallback: a machine that is asked to launch a kernel and has
no ``nvcc`` gets an error that says so.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
#: <checkout>/build -- listed in .gitignore
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LIB_NAME = "librepro_torch_kernels.so"

_PTR, _INT, _FLT = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
#: C entry points and their argument types (pointers and the stream are
#: c_void_p: ctypes would otherwise pass them as 32-bit ints)
_SIGNATURES = {
    "sdca_epoch_launch": (
        [_PTR] * 6 + [_PTR] * 2          # x y mask alpha0 w0 idx | dalpha w_out
        + [_INT] * 6                      # P Q T n_p m_q steps
        + [_FLT] * 4 + [_INT]             # lam n q_scale beta use_beta
        + [_PTR]                          # cell_params (null: use scalars)
        #                                   (P*Q*T, 3 | 2) in cell order
        + [_INT] * 2 + [_PTR]),           # loss threads stream
    "sdca_epoch_cluster_launch": (
        [_PTR] * 6 + [_PTR] * 2          # x y mask alpha0 w0 idx | dalpha w_out
        + [_INT] * 6                      # P Q T n_p m_q steps
        + [_FLT] * 4 + [_INT]             # lam n q_scale beta use_beta
        + [_PTR]                          # cell_params (null: use scalars)
        + [_INT] * 6                      # loss cluster threads per_thread
        #                                   slice smem
        + [_PTR]),                        # stream
    "svrg_inner_launch": (
        [_PTR] * 8 + [_PTR]               # x y mask z_a w_a mu idx lo | w_out
        + [_INT] * 7                      # P Q T n_p m_x m_sub L
        + [_FLT] * 2                      # lam eta
        + [_PTR]                          # cell_params (null: use scalars)
        + [_INT] * 2 + [_PTR]),           # loss threads stream
    "svrg_inner_ring_launch": (
        [_PTR] * 8 + [_PTR]               # x y mask z_a w_a mu idx lo | w_out
        + [_INT] * 7                      # P Q T n_p m_x m_sub L
        + [_FLT] * 2                      # lam eta
        + [_PTR]                          # cell_params (null: use scalars)
        + [_INT] * 5                      # loss warps per_thread ring smem
        + [_PTR]),                        # stream
    "sdca_epoch_sparse_launch": (
        [_PTR] * 7 + [_PTR] * 2          # cols vals y mask alpha0 w0 idx
        #                                  | dalpha w_out
        + [_INT] * 7                      # P Q T n_p k m_q steps
        + [_FLT] * 4 + [_INT]             # lam n q_scale beta use_beta
        + [_PTR]                          # cell_params (null: use scalars)
        + [_INT] * 2 + [_PTR]),           # loss threads stream
    "sdca_epoch_sparse_ahead_launch": (
        [_PTR] * 7 + [_PTR] * 2          # cols vals y mask alpha0 w0 idx
        #                                  | dalpha w_out
        + [_INT] * 7                      # P Q T n_p k m_q steps
        + [_FLT] * 4 + [_INT]             # lam n q_scale beta use_beta
        + [_PTR]                          # cell_params (null: use scalars)
        + [_INT] * 5                      # loss depth cluster threads smem
        + [_PTR]),                        # stream
    "svrg_inner_sparse_launch": (
        [_PTR] * 9 + [_PTR] * 2          # cols vals y mask z_a w_a mu idx lo
        #                                  | w_out g_scratch
        + [_INT] * 7                      # P Q T n_p k m_sub L
        + [_FLT] * 2                      # lam eta
        + [_PTR]                          # cell_params (null: use scalars)
        + [_INT] * 2 + [_PTR]),           # loss threads stream
    "svrg_inner_sparse_cluster_launch": (
        [_PTR] * 9 + [_PTR]               # cols vals y mask z_a w_a mu idx lo
        #                                  | w_out
        + [_INT] * 7                      # P Q T n_p k m_sub L
        + [_FLT] * 2                      # lam eta
        + [_PTR]                          # cell_params (null: use scalars)
        + [_INT] * 5                      # loss cluster threads slice smem
        + [_PTR]),                        # stream
    "flash_attention_tc_launch": (
        [_PTR] * 4                        # q k v | out
        + [_INT] * 6                      # B S Skv H KV D
        + [_FLT] + [_INT] * 2 + [_PTR]),  # scale causal window stream
    "flash_attention_launch": (
        [_PTR] * 4                        # q k v | out
        + [_INT] * 6                      # B S Skv H KV D
        + [_FLT] + [_INT] * 3 + [_PTR]),  # scale causal window dtype stream
    "rwkv_linattn_launch": (
        [_PTR] * 5 + [_PTR] * 2          # r k v logw u | out state
        + [_INT] * 5 + [_PTR]),           # BH S D H C stream
    "rwkv_linattn_tc_launch": (
        [_PTR] * 5 + [_PTR] * 2          # r k v logw u | out state
        + [_INT] * 5 + [_PTR]),           # BH S D H C stream
    "flash_attention_bwd_dq_launch": (
        [_PTR] * 4 + [_PTR] * 3          # q k v dout | dq lse delta
        + [_INT] * 6                      # B S Skv H KV D
        + [_FLT] + [_INT] * 3 + [_PTR]),  # scale causal window dtype stream
    "flash_attention_bwd_dkv_launch": (
        [_PTR] * 6 + [_PTR] * 2          # q k v dout lse delta | dk dv
        + [_INT] * 6                      # B S Skv H KV D
        + [_FLT] + [_INT] * 3 + [_PTR]),  # scale causal window dtype stream
    "rwkv_linattn_bwd_forward_launch": (
        [_PTR] * 6 + [_PTR] * 3          # r k v logw u dout | dr du_rows ck
        + [_INT] * 5 + [_PTR]),           # BH S D H C stream
    "rwkv_linattn_bwd_reverse_launch": (
        [_PTR] * 9                        # r k v logw u dout dstate ck du_rows
        + [_PTR] * 5                      # | dk dv dlogw du states
        + [_INT] * 5 + [_PTR]),           # BH S D H C stream
}


def _find_nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if home and (Path(home) / "bin" / "nvcc").exists():
            return str(Path(home) / "bin" / "nvcc")
    raise RuntimeError(
        "the CUDA kernels of repro_torch are compiled from "
        f"{CSRC} at first use, but no nvcc was found (PATH, CUDA_HOME, "
        "/usr/local/cuda); install the CUDA toolkit, or run on the CPU "
        "by passing device='cpu'.  There is no fallback to the plain "
        "PyTorch versions for tensors on a CUDA device.")


def _sources():
    srcs = sorted(CSRC.glob("*.cu"))
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    return srcs


def _source_hash(srcs) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in srcs + sorted(CSRC.glob("*.cuh")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def _run_all(cmds):
    """Start every command at once, wait for all, return their outputs;
    raise with the compiler's message if one fails."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    for cmd, proc, out in zip(cmds, procs, outs):
        if proc.returncode != 0:
            raise RuntimeError(f"kernel build failed ({proc.returncode}): "
                               f"{' '.join(map(str, cmd))}\n{out}")
    return outs


@functools.lru_cache(maxsize=None)
def _load():
    """Build (if this tree's library is not there yet) and load.
    Returns ``(CDLL, info dict)``; cached for the life of the process."""
    srcs = _sources()
    digest = _source_hash(srcs)
    out_dir = BUILD_ROOT / digest
    lib_path = out_dir / LIB_NAME
    info = {"source_hash": digest, "library_path": str(lib_path),
            "sources": [str(s.relative_to(CSRC.parents[2])) for s in srcs],
            "nvcc_version": None, "build_seconds": 0.0, "cached": True,
            "ptxas": ""}
    if not lib_path.exists():
        nvcc = _find_nvcc()
        t0 = time.perf_counter()
        out_dir.mkdir(parents=True, exist_ok=True)
        objs = [out_dir / (s.stem + ".o") for s in srcs]
        logs = _run_all([[nvcc, *NVCC_FLAGS, "-c", str(s), "-o", str(o)]
                         for s, o in zip(srcs, objs)])
        tmp = out_dir / f"{LIB_NAME}.{os.getpid()}.tmp"
        _run_all([[nvcc, "-shared", "-o", str(tmp), *map(str, objs)]])
        os.replace(tmp, lib_path)          # atomic: no half-written library
        version = _run_all([[nvcc, "--version"]])[0].strip().splitlines()
        info.update(nvcc_version=version[-2] if len(version) > 1
                    else version[-1],
                    build_seconds=time.perf_counter() - t0, cached=False,
                    ptxas="\n".join(logs))
    lib = ctypes.CDLL(str(lib_path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.rt_error_string.argtypes = [ctypes.c_int]
    lib.rt_error_string.restype = ctypes.c_char_p
    return lib, info


def load_library() -> ctypes.CDLL:
    """The shared library of kernels, built from the sources at first use."""
    return _load()[0]


def build_info() -> dict:
    """What was built and how: source hash, nvcc version, build seconds
    (0.0 when an earlier build of the same sources was reused), library
    path and the resource usage ``ptxas -v`` reported.  Builds the
    library if this process has not loaded it yet."""
    return dict(_load()[1])


def check_launch(lib, code: int, what: str):
    """Raise if a C entry point returned a CUDA error code."""
    if code != 0:
        msg = lib.rt_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA launch failed with error "
                           f"{code} ({msg})")

#!/usr/bin/env python3
"""Chip check of the PyTorch/CUDA port: the quickest proof that the port
still starts on the GPU.

    python3 chip_smoke.py            # needs one NVIDIA GPU (sm_90) and nvcc

Drives ``repro_torch`` (and nothing of the JAX package) through its normal
entry points on the card, at the full width of the paper's Part 1 instance
(7 x 4 grid of 2000 x 3000 blocks, n = 14 000, m = 12 000, hinge,
lambda = 1e-2).  Phases, each printing one line of JSON; any failure is an
exception and a non-zero exit:

  env          a CUDA device or an error; card name and power limit; TF32 off
  build        build the kernels from ``src/repro_torch/csrc`` and load them
  kernels      each kernel against its plain PyTorch version ON THE CARD, over
               the shape sweep of the unit tests and at the main-path shape
  d3ca_full    ``repro_torch.launch.optimize.main`` -- D3CA, full width
  radisa_full  the same with RADiSA
  cpu_vs_card  small case: port on the card (kernels) vs port on the CPU
  timing       CUDA-event times per kernel (beside its plain version and its
               roofline bound) and per outer iteration of each solver

Before the last line it prints the card's name and power limit as
``nvidia-smi`` gives them, and one JSON object ``{"kernels": [...]}`` with
every kernel's launches on the main path, error against its plain version,
times and bound.  The last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.

``--phases a,b`` runs a subset (``env`` and ``build`` always run); the
summary lines then hold what those phases measured.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch import kernels  # noqa: E402
from repro_torch.core import (ArrayIndexSource, D3CAConfig,  # noqa: E402
                              GeneratorIndexSource, RADiSAConfig, get_solver,
                              partition)
from repro_torch.core.partition import (blocks_times_cols,  # noqa: E402
                                        rows_times_blocks)
from repro_torch.data import make_svm_data  # noqa: E402
from repro_torch.kernels.sdca import sdca_epoch, sdca_epoch_plain  # noqa: E402
from repro_torch.kernels.svrg import svrg_inner, svrg_inner_plain  # noqa: E402
from repro_torch.launch import optimize  # noqa: E402

PHASES = ("kernels", "d3ca_full", "radisa_full", "cpu_vs_card", "timing")

# the paper's Part 1 instance at full width (configs/svm_paper.py, "7x4")
P, Q, N, M, LAM = 7, 4, 14000, 12000, 1e-2
OUTER_ITERS = 10
REF_EPOCHS = 20          # serial SDCA epochs for f*, through the SDCA kernel

SWEEP_TOL = 1e-5         # rtol = atol, as in the unit tests
# At the main-path shape a launch chains 2000 dependent steps and the kernel
# sums each inner product in another order than the plain version (strided
# per-thread partial sums, warp shuffles, FMA contraction), so rounding
# differences of ~1e-7 per step compound along the chain, and for the hinge
# loss a step whose margin lies within rounding of the kink takes the other
# branch.  Errors are therefore judged relative to the largest entry of the
# reference result, at 1e-4 (measured on an H100: about 1e-6).
MAIN_TOL = 1e-4

# published peaks of one H100 SXM: device memory rate and float32 rate
# outside the tensor cores (neither kernel holds a matrix product)
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12

KERNEL_META = {
    "sdca_epoch": {
        "route": "cuda", "source": "src/repro_torch/csrc/sdca_epoch.cu",
        "replaces": "src/repro/kernels/sdca/sdca.py:139"},
    "svrg_inner": {
        "route": "cuda", "source": "src/repro_torch/csrc/svrg_inner.cu",
        "replaces": "src/repro/kernels/svrg/svrg.py:81"},
}


def emit(phase: str, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def cuda_ms(fn, reps: int = 5, warmup: int = 1):
    """Median CUDA-event time of ``fn()`` in milliseconds."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------

def sdca_inputs(rng, P_, Q_, n_p, m_q, steps, dev, masked_tail=2):
    x = rng.normal(size=(P_, Q_, n_p, m_q)).astype(np.float32)
    y = np.where(rng.random((P_, n_p)) < 0.5, -1.0, 1.0).astype(np.float32)
    mask = np.ones((P_, n_p), np.float32)
    if masked_tail:
        mask[-1, -masked_tail:] = 0.0
        y[-1, -masked_tail:] = 0.0
        x[-1, :, -masked_tail:] = 0.0
    a0 = (rng.uniform(0, 0.5, (P_, n_p)) * (y > 0)).astype(np.float32)
    w0 = (rng.normal(size=(Q_, m_q)) * 0.1).astype(np.float32)
    idx = rng.integers(0, n_p, (P_, steps)).astype(np.int32)
    return [torch.from_numpy(a).to(dev) for a in (x, y, mask, a0, w0, idx)]


def svrg_inputs(rng, P_, Q_, n_p, m_x, m_sub, L, dev, lo=None):
    x = rng.normal(size=(P_, Q_, n_p, m_x)).astype(np.float32)
    y = np.where(rng.random((P_, n_p)) < 0.5, -1.0, 1.0).astype(np.float32)
    mask = np.ones((P_, n_p), np.float32)
    mask[-1, -2:] = 0.0
    wa = (rng.normal(size=(P_, Q_, m_sub)) * 0.2).astype(np.float32)
    za = rng.normal(size=(P_, n_p)).astype(np.float32)
    mu = (rng.normal(size=(P_, Q_, m_sub)) * 0.05).astype(np.float32)
    idx = rng.integers(0, n_p, (P_, Q_, L)).astype(np.int32)
    out = [torch.from_numpy(a).to(dev) for a in (x, y, mask, za, wa, mu, idx)]
    lo_t = None if lo is None else torch.tensor(lo, dtype=torch.int32,
                                                device=dev)
    return out, lo_t


def check_index_range(idx, n_p):
    """``0 <= idx < n_p`` is the caller's contract of both kernels (and
    ``0 <= lo <= m_x - m_sub`` that of the SVRG window: pass the window
    offsets with ``n_p = m_x - m_sub + 1``)."""
    if int(idx.min()) < 0 or int(idx.max()) >= n_p:
        raise AssertionError(f"index out of range [0, {n_p})")


def compare(name, got, want, tol, relative_to_max=False):
    """Max abs error over all outputs; raises when over the tolerance."""
    worst = 0.0
    for g, w in zip(got, want):
        if not torch.isfinite(g).all():
            raise AssertionError(f"{name}: kernel output is not finite")
        err = (g - w).abs()
        worst = max(worst, float(err.max()))
        if relative_to_max:
            ok = float(err.max()) <= tol * max(1.0, float(w.abs().max()))
        else:
            ok = bool((err <= tol + tol * w.abs()).all())
        if not ok:
            raise AssertionError(
                f"{name}: kernel and plain version disagree, max abs err "
                f"{float(err.max()):.3e} (tol {tol}, max |ref| "
                f"{float(w.abs().max()):.3e})")
    return worst


def full_problem(dev):
    """The 7 x 4 instance partitioned on the card, with a feasible dual
    point and its primal image as the state the kernels start from."""
    X, y = make_svm_data(N, M, seed=0)
    data = partition(X, y, P, Q, m_multiple=P * Q, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    alpha = 0.3 * torch.rand((P, data.n_p), generator=gen, device=dev) \
        * data.y_blocks
    w = rows_times_blocks(alpha * data.mask, data.x_blocks).sum(0) / (LAM * N)
    return data, alpha.contiguous(), w.contiguous()


def svrg_main_inputs(data, w, t=1):
    """What RADiSA's step hands the SVRG kernel at outer iteration ``t``."""
    m_sub = data.m_q // P
    src = GeneratorIndexSource(0, P=P, Q=Q, n_p=data.n_p, device=data.device)
    z = blocks_times_cols(data.x_blocks, w).sum(1)
    y, mask = data.y_blocks, data.mask
    gz = torch.where(y * z < 1.0, -y, torch.zeros_like(y)) * mask
    mu = rows_times_blocks(gz, data.x_blocks).sum(0) / N + LAM * w
    lo = (src.radisa_perm(t) * m_sub).to(torch.int32)
    cols = lo.long()[:, None] + torch.arange(m_sub, device=w.device)
    w_anchor = w[:, cols].transpose(0, 1).contiguous()
    mu_sub = mu[:, cols].transpose(0, 1).contiguous()
    eta = RADiSAConfig().eta(t + 3)      # a mid-run step size (t = 4)
    return (data.x_blocks, y, mask, z.contiguous(), w_anchor, mu_sub,
            src.svrg_rows(t)), lo, eta


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_env():
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA device: "
                           "torch.cuda.is_available() is False")
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 matmuls are on; the port is float32")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    emit("env", card=smi, torch=torch.__version__, cuda=torch.version.cuda,
         allow_tf32=torch.backends.cuda.matmul.allow_tf32,
         capability=list(torch.cuda.get_device_capability(0)))
    return smi


def phase_build():
    t0 = time.perf_counter()
    info = kernels.build_info()
    usage = [ln for ln in info.pop("ptxas").splitlines()
             if "registers" in ln or "spill" in ln]
    emit("build", seconds=time.perf_counter() - t0, **info,
         ptxas=usage)


def phase_kernels(dev, results):
    rng = np.random.default_rng(7)
    checks = []

    # -- the unit tests' shape sweep, one cell and a small grid ------------
    for (n_p, m_q, steps) in [(8, 8, 8), (24, 16, 50), (64, 128, 64),
                              (17, 9, 33)]:
        for grid in [(1, 1), (3, 2)]:
            args = sdca_inputs(rng, *grid, n_p, m_q, steps, dev)
            check_index_range(args[5], n_p)
            for loss in ("hinge", "squared"):
                for beta in (None, float(m_q)):
                    kw = dict(lam=0.2, n=200, Q=3, loss=loss, beta=beta)
                    err = compare(f"sdca_epoch{grid}{(n_p, m_q, steps)}",
                                  sdca_epoch(*args, **kw),
                                  sdca_epoch_plain(*args, **kw), SWEEP_TOL)
                    checks.append(("sdca_epoch", err))
    # one cell alone, in the unbatched shapes of the TPU kernel's signature
    args = sdca_inputs(rng, 1, 1, 17, 9, 33, dev)
    kw = dict(lam=0.2, n=200, Q=3, loss="hinge")
    got = sdca_epoch(*(a[0, 0] if a.dim() == 4 else a[0] for a in args), **kw)
    want = sdca_epoch_plain(*args, **kw)
    checks.append(("sdca_epoch", compare(
        "sdca_epoch unbatched", got, (want[0][0, 0], want[1][0, 0]),
        SWEEP_TOL)))
    # the serial-SDCA shape: one cell, m = 12 000 -> 144 KB of dynamic
    # shared memory, over the 48 KB that needs no opt-in
    args = sdca_inputs(rng, 1, 1, 500, M, 500, dev, masked_tail=0)
    args[0] = args[0] / float(np.sqrt(M))
    kw = dict(lam=0.2, n=500, Q=1, loss="hinge")
    checks.append(("sdca_epoch", compare(
        "sdca_epoch one cell m=12000", sdca_epoch(*args, **kw),
        sdca_epoch_plain(*args, **kw), SWEEP_TOL)))

    for (n_p, m_sub, L) in [(16, 8, 20), (40, 32, 64), (13, 5, 11)]:
        for grid in [(1, 1), (3, 2)]:
            for windowed in (False, True):
                # a window that starts at a column that is no multiple of 4
                m_x = 3 * m_sub if windowed else m_sub
                lo = [(m_sub * ((p + 1) % 3)) for p in range(grid[0])] \
                    if windowed else None
                args, lo_t = svrg_inputs(rng, *grid, n_p, m_x, m_sub, L, dev,
                                         lo=lo)
                check_index_range(args[6], n_p)
                if windowed:
                    check_index_range(lo_t, m_x - m_sub + 1)
                for loss in ("hinge", "squared"):
                    kw = dict(lam=0.1, eta=0.03, loss=loss, lo=lo_t)
                    err = compare(
                        f"svrg_inner{grid}{(n_p, m_sub, L)} lo={lo}",
                        [svrg_inner(*args, **kw)],
                        [svrg_inner_plain(*args, **kw)], SWEEP_TOL)
                    checks.append(("svrg_inner", err))
    torch.cuda.synchronize()

    # -- the main-path shape: 28 cells of 2000 x 3003 -----------------------
    data, alpha, w = full_problem(dev)
    src = GeneratorIndexSource(0, P=P, Q=Q, n_p=data.n_p, device=dev)
    idx = src.sdca_rows(1)
    check_index_range(idx, data.n_p)
    sargs = (data.x_blocks, data.y_blocks, data.mask, alpha, w, idx)
    skw = dict(lam=LAM, n=N, Q=Q, loss="hinge")
    main_err = {"sdca_epoch": compare(
        "sdca_epoch main-path shape", sdca_epoch(*sargs, **skw),
        sdca_epoch_plain(*sargs, **skw), MAIN_TOL, relative_to_max=True)}
    vargs, lo, eta = svrg_main_inputs(data, w)
    check_index_range(vargs[6], data.n_p)
    check_index_range(lo, data.m_q - data.m_q // P + 1)
    vkw = dict(lam=LAM, eta=eta, loss="hinge", lo=lo)
    main_err["svrg_inner"] = compare(
        "svrg_inner main-path shape", [svrg_inner(*vargs, **vkw)],
        [svrg_inner_plain(*vargs, **vkw)], MAIN_TOL, relative_to_max=True)
    torch.cuda.synchronize()

    summary = []
    for name in KERNEL_META:
        sweep = [e for k, e in checks if k == name]
        results[name].update(max_abs_err=main_err[name], tol=MAIN_TOL,
                             sweep_cases=len(sweep),
                             sweep_max_abs_err=max(sweep),
                             sweep_tol=SWEEP_TOL, ok=True)
        summary.append({"name": name, **{k: results[name][k] for k in (
            "max_abs_err", "tol", "sweep_cases", "sweep_max_abs_err",
            "sweep_tol", "ok")}})
    emit("kernels", checks=summary,
         main_shape={"cells": P * Q, "n_p": data.n_p, "m_q": data.m_q,
                     "steps": data.n_p, "m_sub": data.m_q // P})
    del data, alpha, w, sargs, vargs
    torch.cuda.empty_cache()


def run_solver_full(solver: str, expect_dual: bool):
    """One full-width solve through the CLI's ``main``; returns its
    history and the launch-count deltas."""
    before = (sdca_epoch.launches, svrg_inner.launches)
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, f"{solver}.json")
        t0 = time.perf_counter()
        summary = optimize.main([
            "--solver", solver, "--mesh", f"{P}x{Q}", "--n", str(N), "--m",
            str(M), "--lam", str(LAM), "--iters", str(OUTER_ITERS),
            "--ref-epochs", str(REF_EPOCHS), "--json-out", out])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        with open(out) as fh:
            history = json.load(fh)["history"]
    delta = (sdca_epoch.launches - before[0], svrg_inner.launches - before[1])
    if summary["device"] != "cuda" or summary["local_backend"] != "kernel":
        raise AssertionError(f"{solver}: not on the card / kernel backend: "
                             f"{summary}")
    if summary["iters"] != OUTER_ITERS or len(history) != OUTER_ITERS:
        raise AssertionError(f"{solver}: ran {summary['iters']} iterations")
    vals = [h["objective"] for h in history]
    if expect_dual:
        vals += [h["duality_gap"] for h in history]
    if not all(np.isfinite(v) for v in vals):
        raise AssertionError(f"{solver}: non-finite history {history}")
    if not history[-1]["objective"] < history[0]["objective"]:
        raise AssertionError(f"{solver}: objective did not decrease: "
                             f"{vals[:OUTER_ITERS]}")
    return summary, history, delta, wall


def phase_d3ca_full():
    summary, history, delta, wall = run_solver_full("d3ca", expect_dual=True)
    g0, g1 = history[0]["duality_gap"], history[-1]["duality_gap"]
    if not (g1 > 0 and g1 < g0):
        raise AssertionError(f"d3ca: duality gap {g0} -> {g1}")
    if delta != (OUTER_ITERS + REF_EPOCHS, 0):
        raise AssertionError(f"d3ca: launch deltas {delta}; expected "
                             f"({OUTER_ITERS} + {REF_EPOCHS} epochs, 0)")
    emit("d3ca_full", objective_first=history[0]["objective"],
         objective_last=history[-1]["objective"], gap_first=g0, gap_last=g1,
         rel_opt_last=history[-1]["rel_opt"], launches_sdca=delta[0],
         launches_svrg=delta[1], solve_s=summary["total_s"], wall_s=wall,
         peak_mem_bytes=torch.cuda.max_memory_allocated())


def phase_radisa_full():
    summary, history, delta, wall = run_solver_full("radisa",
                                                    expect_dual=False)
    if delta != (REF_EPOCHS, OUTER_ITERS):
        raise AssertionError(f"radisa: launch deltas {delta}; expected "
                             f"({REF_EPOCHS} epochs, {OUTER_ITERS})")
    emit("radisa_full", objective_first=history[0]["objective"],
         objective_last=history[-1]["objective"],
         rel_opt_last=history[-1]["rel_opt"], launches_sdca=delta[0],
         launches_svrg=delta[1], solve_s=summary["total_s"], wall_s=wall,
         peak_mem_bytes=torch.cuda.max_memory_allocated())


def phase_cpu_vs_card():
    """3 x 2 grid, n = 200, m = 60, 4 iterations, one index stream: the
    port on the card through the kernels vs the port on the CPU through
    their plain versions."""
    Ps, Qs, n, m, iters = 3, 2, 200, 60, 4
    X, y = make_svm_data(n, m, seed=0)
    n_p = -(-n // Ps)
    rng = np.random.default_rng(3)
    streams = dict(
        sdca={t: rng.integers(0, n_p, (Ps, n_p)).astype(np.int32)
              for t in range(1, iters + 1)},
        svrg={t: rng.integers(0, n_p, (Ps, Qs, n_p)).astype(np.int32)
              for t in range(1, iters + 1)},
        perm={t: rng.permutation(Ps) for t in range(1, iters + 1)})
    worst = {}
    for name, cfg in (("d3ca", D3CAConfig(lam=0.1, outer_iters=iters)),
                      ("radisa", RADiSAConfig(lam=0.1, outer_iters=iters,
                                              gamma=0.05))):
        out = {}
        for dev in ("cuda", "cpu"):
            solver = get_solver(name)(
                local_backend="kernel", device=dev,
                index_source=ArrayIndexSource(device=dev, **streams))
            out[dev] = solver.solve("hinge", X, y, P=Ps, Q=Qs, cfg=cfg)
        w_card, w_cpu = out["cuda"].w.cpu(), out["cpu"].w
        if not torch.isfinite(w_card).all() or w_card.shape != (m,):
            raise AssertionError(f"{name}: bad w on the card")
        err = float((w_card - w_cpu).abs().max())
        if not torch.allclose(w_card, w_cpu, rtol=1e-5, atol=1e-5):
            raise AssertionError(f"{name}: card vs CPU differ by {err:.3e}")
        worst[name] = err
    emit("cpu_vs_card", max_abs_err=worst, tol=1e-5)


def bounds(name, args, m_cols, flops_per_elem):
    """Roofline bound of one launch from THIS run's inputs: the bytes are
    the distinct rows each cell samples (its window columns only) read
    once, the small vectors read once and the outputs written once; the
    operations are ``flops_per_elem`` per visited row element."""
    x, idx = args[0], args[-1]
    Pn, Qn, n_p, _ = x.shape
    steps = idx.shape[-1]
    flat = idx.reshape(-1, steps).long()
    distinct = int(sum(int(torch.unique(r).numel()) for r in flat))
    cells_per_stream = (Pn * Qn) // flat.shape[0]
    row_bytes = distinct * cells_per_stream * m_cols * 4
    small = sum(int(a.numel()) * 4 for a in args[1:])
    out_bytes = Pn * Qn * m_cols * 4 + (Pn * Qn * n_p * 4
                                        if name == "sdca_epoch" else 0)
    t_bytes = (row_bytes + small + out_bytes) / PEAK_BYTES_PER_S
    t_ops = Pn * Qn * steps * m_cols * flops_per_elem / PEAK_F32_FLOPS
    return {"bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes_moved": row_bytes + small + out_bytes}


def time_solver(name, dev, X, y, iters=5):
    """ms per outer iteration of the grid engine (step only, no history),
    by CUDA events around ``iters`` steps after a warm-up step."""
    cfg_cls = D3CAConfig if name == "d3ca" else RADiSAConfig
    solver = get_solver(name)(device=dev)
    prog = solver.program("hinge", X, y, P=P, Q=Q,
                          cfg=cfg_cls(lam=LAM, outer_iters=iters))
    state = prog.step(1, prog.state)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for t in range(2, 2 + iters):
        state = prog.step(t, state)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_timing(dev, results):
    data, alpha, w = full_problem(dev)
    src = GeneratorIndexSource(0, P=P, Q=Q, n_p=data.n_p, device=dev)
    sargs = (data.x_blocks, data.y_blocks, data.mask, alpha, w,
             src.sdca_rows(1))
    skw = dict(lam=LAM, n=N, Q=Q, loss="hinge")
    vargs, lo, eta = svrg_main_inputs(data, w)
    vkw = dict(lam=LAM, eta=eta, loss="hinge", lo=lo)

    # plain, kernel, kernel, plain -- on one card, in one process
    plain_s = [cuda_ms(lambda: sdca_epoch_plain(*sargs, **skw), reps=3)]
    kern_s = [cuda_ms(lambda: sdca_epoch(*sargs, **skw), reps=7)]
    plain_v = [cuda_ms(lambda: svrg_inner_plain(*vargs, **vkw), reps=3)]
    kern_v = [cuda_ms(lambda: svrg_inner(*vargs, **vkw), reps=7)]
    kern_v.append(cuda_ms(lambda: svrg_inner(*vargs, **vkw), reps=7))
    plain_v.append(cuda_ms(lambda: svrg_inner_plain(*vargs, **vkw), reps=3))
    kern_s.append(cuda_ms(lambda: sdca_epoch(*sargs, **skw), reps=7))
    plain_s.append(cuda_ms(lambda: sdca_epoch_plain(*sargs, **skw), reps=3))

    # per step: dot (2) + norm (2) + update (2) flops per row element;
    # SVRG: subtract + dot (3) + update (6)
    results["sdca_epoch"].update(
        ms=statistics.median(kern_s), plain_ms=statistics.median(plain_s),
        library_ms=None, **bounds("sdca_epoch", sargs, data.m_q, 6))
    results["svrg_inner"].update(
        ms=statistics.median(kern_v), plain_ms=statistics.median(plain_v),
        library_ms=None, **bounds("svrg_inner", vargs, data.m_q // P, 9))
    del data, alpha, w, sargs, vargs
    torch.cuda.empty_cache()

    X, y = make_svm_data(N, M, seed=0)
    X, y = torch.from_numpy(X).to(dev), torch.from_numpy(y).to(dev)
    solvers = {}
    for name, kernel in (("d3ca", "sdca_epoch"), ("radisa", "svrg_inner")):
        ms_iter = time_solver(name, dev, X, y)
        solvers[name] = {"ms_per_outer_iter": ms_iter,
                         "kernel": kernel,
                         "kernel_share": results[kernel]["ms"] / ms_iter}
    emit("timing", solvers=solvers,
         kernels={k: {f: v[f] for f in ("ms", "plain_ms", "bound_ms",
                                        "bound_by", "bytes_moved")}
                  for k, v in results.items()})


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of: " + ", ".join(PHASES))
    args = ap.parse_args(argv)
    phases = [p for p in args.phases.split(",") if p]
    unknown = set(phases) - set(PHASES)
    if unknown:
        ap.error(f"unknown phases {sorted(unknown)}")

    smi = phase_env()
    dev = torch.device("cuda")
    phase_build()
    results = {name: {"name": name, **meta, "launches": 0,
                      "max_abs_err": None, "ms": None, "plain_ms": None,
                      "bound_ms": None, "bound_by": None, "library_ms": None}
               for name, meta in KERNEL_META.items()}
    if "kernels" in phases:
        phase_kernels(dev, results)

    # the main path: every count to 0 just before, read just after
    sdca_epoch.launches = 0
    svrg_inner.launches = 0
    if "d3ca_full" in phases:
        phase_d3ca_full()
    if "radisa_full" in phases:
        phase_radisa_full()
    results["sdca_epoch"]["launches"] = sdca_epoch.launches
    results["svrg_inner"]["launches"] = svrg_inner.launches
    if set(phases) >= {"d3ca_full", "radisa_full"}:
        for name, res in results.items():
            if res["launches"] < 1:
                raise AssertionError(f"the main path never launched {name}")

    if "cpu_vs_card" in phases:
        phase_cpu_vs_card()
    if "timing" in phases:
        phase_timing(dev, results)

    print(smi, flush=True)
    print(json.dumps({"kernels": list(results.values())}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

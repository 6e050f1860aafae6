#!/usr/bin/env python3
"""Chip check of the PyTorch/CUDA port: the quickest proof that the port
still starts on the GPU.

    python3 chip_smoke.py            # needs one NVIDIA GPU (sm_90) and nvcc

Drives ``repro_torch`` (and nothing of the JAX package) through its normal
entry points on the card, at the full width of two instances of the paper
-- the dense Part 1 instance (7 x 4 grid of 2000 x 3000 blocks, n = 14 000,
m = 12 000, hinge, lambda = 1e-2) and the sparse news20 profile of Part 2
(``configs/svm_paper.py`` REAL_DATASETS["news20"]: n = 19 996,
m = 1 355 191 at density 3.4e-4, lambda = 1e-4, padded-ELL cells on the
same 7 x 4 grid) -- and of the LM architectures served through the serving
CLI's ``main`` with random weights from a seed: Qwen3-1.7B (all 28 layers)
on the continuous-batching engine with its paged KV cache, RWKV6-3B (all 32
layers) on the static loop, and the other families (Mixtral, RecurrentGemma,
Llama-3.2-Vision, MusicGen, the int8 cache), depth cut only where one card's
memory forces it.  Phases, each printing one line of
JSON; any failure is an exception and a non-zero exit.  The kernels
phase and the LM paths of at most 40 GB of the card's memory run in two
more processes of this script (``SIDES``), beside the solver paths; their
lines are printed when they have ended, before the LM paths that fill the
card and the grid phases, which run alone, as cpu_vs_card and the timing
do:

  env                 a CUDA device or an error; card name and power limit;
                      TF32 off
  build               build the kernels from ``src/repro_torch/csrc``, load
  kernels             each kernel, on every route of its wrapper, against
                      its plain PyTorch version ON THE CARD, over the shape
                      sweep of the unit tests, the edge cases of each route
                      and the main-path shape, and every solver route
                      with a tenant axis (T = 1 and 3, a distinct lambda in
                      every cell; T = 1 bitwise the scalar launch), and
                      each solver kernel at the fleets' main-path shape
                      (T tenants' cells in one launch), and the RWKV6
                      linear attention at its main shape against the
                      exact recurrence in float64 at several input draws
                      (``linattn_draws`` line), and each SDCA kernel on
                      every route with a row gate as its mask (one row
                      partition on, 5 % of rows on, all off -- all off
                      must leave dalpha 0 and w bitwise w0), and B5 and
                      B6 as training calls them (their autograd Functions
                      at the training shapes: forward against the plain
                      version, gradients bitwise the plain version's), and
                      B5 at the other families' shapes (head dim 256 on
                      both routes, non-causal XATTN, window 4096) at unit
                      and peaked q, each query row also held to its own
                      scale (``row_check``) --
                      the first
                      call to make after touching a ``.cu`` file
                      (``--phases kernels``)
  d3ca_full           ``repro_torch.launch.optimize.main`` -- D3CA, dense
  radisa_full         the same with RADiSA
  d3ca_sparse_full    D3CA, ``--block-format sparse`` on the news20 profile
  radisa_sparse_full  the same with RADiSA
  sfk_sparse_full     the same with SFK
  serve_qwen3_full    ``repro_torch.launch.serve.main`` -- Qwen3-1.7B, bf16,
                      greedy, 16 requests of 128..1024 prompt tokens over 8
                      slots; every prefill attention layer is the flash
                      attention kernel
  serve_rwkv6_full    the same CLI with RWKV6-3B: the engine refuses the
                      recurrent mixer and the static loop runs 8 prompts of
                      512 tokens; every prefill time mix is the linear
                      attention kernel
  train_qwen3_full    Qwen3-1.7B training (bf16 compute, random weights
                      from seed 0, batch 8 x 128 tokens in 8 microbatches,
                      remat "nothing") at full width and depth (28
                      layers: the four float32 copies on the card): 3
                      steps of the train step the CLI builds (the CLI
                      itself, its checkpoint and --resume run in
                      train_mesh_full); every layer of
                      every microbatch launches the flash attention
                      kernel twice (forward and the checkpoint's
                      recompute) and differentiates its plain version
                      once.  Before the counted run the first step is
                      taken through the kernels and again with the plain
                      versions tapped in: loss, gradient norm and every
                      leaf's gradient compared, none zero, and every
                      flash call of the kernels' step held against the
                      plain version on its own inputs
  train_rwkv6_full    RWKV6-3B at 2 of its 32 layers (see TRAIN_PATHS): 3
                      steps of the train step the CLI builds, then the
                      CLI at 2 layers (2 steps, a checkpoint, --resume
                      for 2); the linear attention kernel in every time
                      mix; its bf16 gradients are compared, and held in
                      float32 at 2 layers beside a rounding control
  serve_mixtral_full  the serving CLI's ``main`` (``get_config`` patched to
                      cut depth) -- Mixtral-8x7B at 4 of 32 layers (MoE,
                      sliding window 4096) on the paged engine with the
                      Qwen3 trace: 4 flash launches a prefill
  serve_recurrentgemma_full
                      RecurrentGemma-9B, all 38 layers (RG-LRU + LOCAL):
                      the static loop, 4 prompts of 3072 tokens (the 2048
                      window wraps in prefill and in the ring decode); 12
                      flash launches at head dim 256, every one `tc`
  serve_vlm_full      Llama-3.2-Vision-90B at one period (5 of 100 layers:
                      4 ATTN + 1 XATTN) over 1024 stub encoder states, 4
                      prompts of 512: 4 causal launches, 1 non-causal
  serve_musicgen_full MusicGen-large, all 48 layers, through the embedding
                      frontend: 8 x 512 frames, 48 launches at head dim 64
  serve_qwen3_int8_full
                      Qwen3-1.7B with the int8 KV cache (static loop),
                      then the bf16 cache's static loop on the same
                      weights: first greedy tokens equal, agreement after
  train_mixtral_full  3 steps of the train step the CLI builds (its
                      batches, AdamW, batch 8 x 128 in 8 microbatches,
                      remat "nothing") for Mixtral at 2 of 32 layers;
                      before the counted window the first step through
                      the kernels and through the plain versions (loss and
                      grad norm; every leaf in float32, since its routing
                      flips with bf16 rounding; every flash call of the
                      bf16 step held against the plain version on its own
                      inputs; every leaf's gradient -- the router's too --
                      non-zero); peak against the four float32 copies
  train_recurrentgemma_full
                      the same for RecurrentGemma at 5 of 38 layers (a
                      period and the RG-LRU remainder; lam's gradient),
                      every leaf held in bf16
  train_musicgen_full the same for MusicGen at 12 of 48 layers (frame
                      embeddings in), every leaf held in bf16
  fleet_dense_full    ``repro_torch.launch.fleet`` (``main``'s ``parse_args``
                      and ``run``) -- 4 tenants of the dense instance
                      (seeds 0-3, lambda 1e-2 * 0.5^(t mod 3)) with D3CA,
                      RADiSA and ADMM (rho = lambda): one launch of each
                      solver kernel per outer step for all tenants; every
                      tenant within 1e-6 of its solo solve on the card
                      (relative to the largest entry; the solo solves run
                      before the launch counts go to 0)
  fleet_sparse_full   the same with 2 news20-profile tenants, D3CA and
                      RADiSA
  admm_full           ``optimize.main --solver admm`` on the dense
                      instance: no kernel launch
  online_full         ``repro_torch.launch.online`` (``main``'s
                      ``parse_args`` and ``run``) -- the online service at
                      the dense instance's width: a window of 14 000 x
                      12 000 on the card, 30 rounds of 500 rows (the ring
                      wraps at round 28), two gated D3CA passes an update
                      on the solver's timed path (the service's registry
                      goes to ``Solver.update``, which calibrates first:
                      30 x (2 + 8) B1 launches, cluster at G = 1), the
                      passes of three rounds against the plain version,
                      frozen duals
                      outside each batch, recovery from the checkpoints
                      bitwise; the all-ones gate bitwise the ungated solve;
                      update, swap, scoring and checkpoint times
  online_sparse_full  ``Solver("d3ca", block_format="sparse")`` on the
                      news20 profile: a cold solve and a gated ``update``
                      of 1000 rows, 4 B3 launches against the plain version
  comm_full           the comm policies through ``get_solver(...)(
                      compression=, topology=).solve`` and the CLI's
                      ``--compression`` / ``--topology``: D3CA at the
                      dense instance under None, identity (bitwise None),
                      int8, fp8, topk:0.1 (exact wire bytes, objective
                      gap within its predicted band of None, every int8
                      codec call held to the codec's definition), two
                      controls without error feedback that those checks
                      must refuse, the adaptive schedule against f*,
                      RADiSA int8, pods=2 at Part 1 "4x2" (identity within
                      1e-5 of flat, int8 converging, its pod codec calls
                      held as above, B1's first and last launch of each
                      solve against the plain version), sparse D3CA int8
                      and RADiSA topk:0.1 on the news20 profile; ms per
                      outer iteration under each codec
  obs_full            the observability slice at full width: D3CA at
                      Part 1 through the CLI under --trace --metrics
                      --health --flight-recorder --listen 127.0.0.1:0
                      (/metrics parsed and /healthz read during the
                      solve, the span tree, exact registry counts, w
                      bitwise the untraced solve, B1's 10 + 8 + 20
                      launches and its first and last cell launch
                      against the plain version), RADiSA int8 with a
                      tracer and a registry (B2's 18 ring launches, the
                      error-feedback norms, codec times), the online CLI
                      under its telemetry flags and again with untimed
                      updates (update ms and staleness both ways), four
                      dense D3CA fleet tenants under the fleet CLI's
                      flags, and 4 Qwen3 requests through the serving CLI
                      under --trace --health --flight-recorder beside an
                      untraced run (28 flash launches a prefill span,
                      tok/s both ways)
  fleet_mesh_full     the fleet, the online service and scoring on one
                      process grid of 7 x 4 ranks on the card (gloo;
                      mesh_full, next, runs on the same grid): the fleets
                      of fleet_dense_full and
                      fleet_sparse_full through the fleet CLI under
                      ``--engine shard_map`` for 2 outer iterations (one
                      launch a rank an outer step for all tenants, every
                      tenant within 1e-5 of the grid-engine fleet's,
                      tenant 0 of its solo mesh solve, each kernel's
                      first and last launch on ranks (0, 0) and (6, 3)
                      against its plain version), the online CLI under
                      ``--engine shard_map`` for 1 round of
                      online_full's window (each version within
                      1e-5 of the grid engine's stream, duals outside the
                      batch unmoved) and its scorer on the grid (margins
                      within 1e-5 of X @ w); ms per outer iteration,
                      distribution, update and scoring times
  mesh_full           the solvers' mesh engines on that grid: D3CA /
                      RADiSA / ADMM / news20 D3CA under shard_map, async
                      and overlap, each within 1e-5 of the grid engine's
                      solve
  examples_full       the six examples (``main`` of examples/torch_*.py)
                      on the card at their own sizes: quickstart (300
                      serial SDCA epochs, 15 D3CA and 15 RADiSA
                      iterations, 60 of ADMM), the grid example on 4 x 2
                      ranks (mesh_full's grid), trace_solve (timed path), online_loop (12
                      rounds, recovery), serve_lm (reduced Mixtral: B5 at
                      head dim 16 on the ``simt`` route) and lm_train
                      (``--small`` for 60 steps, then the ~100M config
                      for 20 steps: B5 ``tc`` at head dim 64); one line an
                      example with the card beside its numbers
  train_mesh_full     Qwen3-1.7B at full width (4 of 28 layers, see
                      MESH_TRAIN_DEPTH) trained over a
                      2 x 2 (data, model) grid of 4 ranks sharing the card
                      (``make_train_step`` on a sharded model: FSDP over
                      "data", heads / d_ff / vocabulary over "model"):
                      the first step against the one-device step from the
                      same weights in bf16 and (before the counted window,
                      at 2 layers) in float32 -- loss, gradient norm, the
                      share of parameter entries whose step went another
                      way, overall and in the worst leaf, each within
                      MESH_TRAIN_LIMITS; a one-device control with B5's
                      plain version beside it -- and every rank's B5 calls
                      of the first step against the plain version on
                      their own q / k / v; 2 steps (step ms, tokens/s,
                      each rank's peak against its share of the four
                      float32 copies, wire bytes equal to the count from
                      the specs), every rank's attention on 8 of the 16
                      query heads; then the training CLI with --mesh 2,2
                      at 2 layers (a step, a checkpoint in a tmpfs) and
                      --resume on one device, whose restored parameters
                      must equal the grid's bitwise
  train_mesh_families_full
                      the other families at full width on the same grid
                      (see MESH_FAMILIES): Mixtral-8x7B at 1 layer (4
                      experts a rank), RWKV6-3B at 2 (B6 on 20 of 40 heads)
                      and MusicGen-large at 4 (frame embeddings): each
                      family's float32 first step against one device
                      (before the counted window, MESH_TRAIN_LIMITS), then
                      2 bf16 steps from there with every rank's B5 / B6
                      calls of the first held against the plain version,
                      wire bytes equal to the count from the specs, the
                      ranks' heads and (Mixtral) routing, each rank's peak
                      against its share, step ms and tokens/s
  serve_mesh_full     Qwen3-1.7B at full width and all 28 layers, bf16,
                      served over the same grid (``make_prefill_step`` /
                      ``make_decode_step`` on a sharded model; see
                      SERVE_MESH_*): 4 prompts of 256 tokens, a cache of
                      512, 16 decode steps; every step's logits against
                      the one-device run from the same weights within
                      twice its bf16-against-float32 spread, a float32
                      pass at 2 layers within 1e-5 of the largest logit
                      (before the counted window), every rank's B5 calls
                      of the first prefill against the plain version, the
                      wire bytes of every step and of the views gathered
                      once against ``serve_wire_bytes``; then
                      RecurrentGemma-9B at one period (B5 at head dim 256,
                      the one KV head's cache split by length), RWKV6-3B at
                      2 layers (B6 on 20 of 40 heads) and Mixtral-8x7B at 1;
                      prefill and decode-step ms, tokens/s, each rank's
                      peak
  cpu_vs_card        small cases, dense and sparse solvers and reduced
                      LM configs of every family (and the int8 cache):
                      port on the card (kernels) vs port on
                      the CPU, in float32 (prefill, decode and one train
                      step), and a reduced Qwen3 prefill in
                      bfloat16 at head dim 64 (the tensor-core route);
                      D3CA under None / identity (bitwise) and int8
  timing              CUDA-event times per kernel (beside its plain version,
                      its roofline bound, the route it replaced on the main
                      path where it has two and, where one PyTorch call
                      computes the same function, that call), each kernel,
                      replaced route and library call timed two ways:
                      ``ms`` with the host's launch latency inside, and
                      ``device_ms`` with the call enqueued before the
                      clock starts (the device's time alone); the dense
                      SDCA epoch at both main-path shapes, each solver
                      kernel at the fleets' T tenants; and per outer
                      iteration of each solver and each fleet (beside T x
                      the solo's, with the device's busy time and idle
                      share in a step, and solves per second); peak
                      device memory of the
                      sparse path; Qwen3 prefill and decode step, RWKV6
                      prefill; B5 at the other families' shapes
                      (RecurrentGemma's head dim 256 on both routes,
                      Vision's non-causal XATTN, Mixtral's window 4096)
                      beside SDPA with the same mask

Each full-width phase is a main path: every launch counter is set to 0
just before it and read just after, and it must have launched exactly the
kernels it names as often as it says: the solvers once per outer
iteration (plus serial-SDCA epochs for f* where the dense phases compute
it), the Qwen3 server 28 times per prefill, the RWKV6 loop 32 times,
the other families once per attention layer of a prefill, training
twice per period layer and microbatch and once per remainder layer (its
backward calls through the plain versions are counted apart).  B5 also
counts its launches per route and head dim; none at head dim 256 may take
the CUDA-core route on a main path.  All
six wrappers have two routes and count launches per route too, and every
main-path launch must take the new route: flash attention and RWKV6
linear attention the tensor-core route (``tc``), the dense SDCA epoch
(at both of its shapes, the D3CA cells and the serial-SDCA epochs for f*)
and the sparse SVRG inner loop the cluster route, the dense SVRG inner
loop the ring route and the sparse SDCA epoch the lookahead route.  The
replaced routes are held against the plain versions and timed beside
them, off the main paths.  The dense
SDCA epoch also counts its launches per cluster size, which must be 1 CTA
a cell for each D3CA iteration and 16 for each serial epoch.

Before the last line it prints the card's name and power limit as
``nvidia-smi`` gives them, and one JSON object ``{"kernels": [...]}`` with
every kernel's launches on the main paths, error against its plain
version, times, bound, launches and source per route and, for the dense
SDCA epoch, the same per main-path shape.  The last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.

Every synthetic instance (``make_svm_data`` and the sparse generators) is
made once a run and handed again to every later phase or CLI that asks
for the same arguments (``DataMemo``); a ``data_memo`` line after the
phases says how many seconds that saved.

``--phases a,b`` runs a subset (``env`` and ``build`` always run); the
summary lines then hold what those phases measured.
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import functools
import gc
import importlib
import importlib.util
import io
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import types
import urllib.request

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))
# the grid's ranks call this script's rank-side functions by module name
sys.modules.setdefault("chip_smoke", sys.modules[__name__])

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch import kernels  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.svm_paper import REAL_DATASETS  # noqa: E402
from repro_torch.core import (ADMMConfig, ArrayIndexSource,  # noqa: E402
                              D3CAConfig, GeneratorIndexSource, RADiSAConfig,
                              SFKConfig,
                              Solver, SyncComm, ell_gather, ell_scatter_add, get_loss,
                              get_solver, objective, partition,
                              partition_sparse, serial_sdca)
from repro_torch.core.compress import (Codec, Int8Codec,  # noqa: E402
                                       TopKCodec)
from repro_torch.core.d3ca import (d3ca_cell_program,  # noqa: E402
                                   d3ca_simulated_program)
from repro_torch.core.partition import (blocks_times_cols,  # noqa: E402
                                        rows_times_blocks)
from repro_torch.core.radisa import (cut_windows,  # noqa: E402
                                     radisa_simulated_program)
from repro_torch.core.sfk import sfk_simulated_program  # noqa: E402
from repro_torch.data import (csr_from_dense,  # noqa: E402
                              make_sparse_svm_csr, make_sparse_svm_data,
                              make_svm_data)
from repro_torch.kernels.sdca import (sdca_epoch,  # noqa: E402
                                      sdca_epoch_plain, sdca_epoch_sparse,
                                      sdca_epoch_sparse_plain, sdca_route,
                                      sdca_sparse_route)
from repro_torch.kernels._launch import tenant_axes  # noqa: E402
from repro_torch.kernels.sdca import ops as sdca_ops  # noqa: E402
from repro_torch.kernels.sdca import sparse as sdca_sparse  # noqa: E402
from repro_torch.kernels.flash import (flash_attention,  # noqa: E402
                                       flash_attention_plain, flash_route)
from repro_torch.kernels.flash import ops as flash_ops  # noqa: E402
from repro_torch.kernels.linattn import (linattn_route,  # noqa: E402
                                         rwkv_linattn, rwkv_linattn_ref)
from repro_torch.kernels.linattn import ops as linattn_ops  # noqa: E402
from repro_torch.kernels.svrg import (svrg_inner,  # noqa: E402
                                      svrg_inner_plain, svrg_inner_sparse,
                                      svrg_inner_sparse_plain, svrg_route,
                                      svrg_sparse_route)
from repro_torch.kernels.svrg import ops as svrg_ops  # noqa: E402
from repro_torch.kernels.svrg import sparse as svrg_sparse  # noqa: E402
from repro_torch.fleet import FleetSolver, solo_config  # noqa: E402
from repro_torch.launch import fleet as fleet_cli  # noqa: E402
from repro_torch.launch import online as online_cli  # noqa: E402
from repro_torch.launch import optimize  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.launch.steps import (_largest_divisor_leq,  # noqa: E402
                                      clear_grads, loss_and_grads,
                                      make_decode_step, make_prefill_step,
                                      make_train_step)
from repro_torch.launch import mesh_serve, mesh_train  # noqa: E402
from repro_torch.launch.mesh import (close_grids, make_mesh,  # noqa: E402
                                     process_grid)
from repro_torch.models import Transformer, reduced  # noqa: E402
from repro_torch.models import attention as lm_attention  # noqa: E402
from repro_torch.models import rwkv as lm_rwkv  # noqa: E402
from repro_torch.sharding import resident  # noqa: E402
from repro_torch.optim import (AdamWConfig, adamw_init,  # noqa: E402
                               global_norm, warmup_cosine)
from repro_torch.core.util import tree_leaves as tree_leaves_sorted  # noqa: E402
from repro_torch.data import (synthetic_lm_batch,  # noqa: E402
                              synthetic_token_batch)
from repro_torch.obs import (HealthMonitor, ObsServer,  # noqa: E402
                             Registry, Tracer, load_bundle,
                             parse_prometheus_text)
from repro_torch.obs.phases import calibrate_phases  # noqa: E402
from repro_torch.serve import InferenceEngine  # noqa: E402
from repro_torch.serve.scoring import LinearScorer  # noqa: E402
from repro_torch.models.transformer import param_shapes, tree_map  # noqa: E402
from repro_torch.serve.cache import (PagedCacheConfig,  # noqa: E402
                                     make_paged_arenas)

MAIN_PATHS = ("d3ca_full", "radisa_full", "d3ca_sparse_full",
              "radisa_sparse_full", "sfk_sparse_full", "serve_qwen3_full",
              "serve_rwkv6_full", "train_qwen3_full", "train_rwkv6_full",
              "serve_mixtral_full", "serve_vlm_full", "serve_musicgen_full",
              "serve_qwen3_int8_full", "train_musicgen_full",
              "fleet_dense_full", "fleet_sparse_full",
              "admm_full", "online_full", "online_sparse_full", "comm_full",
              "obs_full", "serve_recurrentgemma_full", "train_mixtral_full",
              "train_recurrentgemma_full", "fleet_mesh_full", "mesh_full",
              "examples_full", "train_mesh_full",
              "train_mesh_families_full", "serve_mesh_full")
PHASES = ("kernels", *MAIN_PATHS, "cpu_vs_card", "timing")

# the paper's Part 1 instance at full width (configs/svm_paper.py, "7x4")
P, Q, N, M, LAM = 7, 4, 14000, 12000, 1e-2
OUTER_ITERS = 10
REF_EPOCHS = 20          # serial SDCA epochs for f*, through the SDCA kernel

# the news20 profile of the paper's Part 2 on the same 7 x 4 grid: nothing
# is cut but depth (OUTER_ITERS); f* is skipped by the CLI's own rule
NEWS20 = REAL_DATASETS["news20"]
N20, M20, DENS20, LAM20 = (NEWS20["n"], NEWS20["m"], NEWS20["density"],
                           NEWS20["lam"])
# the sparse path never forms a dense block grid (that would be 108 GB)
SPARSE_PEAK_LIMIT = 2e9

# the fleets: T tenants of the dense Part 1 instance (tenant t: seed t,
# lambda = LAM * 0.5 ** (t % 3)) and of the news20 profile (LAM20 * 0.5 **
# t); every tenant's final iterates are held against its solo solve of the
# same seed on the card, relative to the largest entry
FLEET_T_DENSE = 4
FLEET_T_SPARSE = 2
FLEET_TOL = 1e-6

# the online service at the Part 1 width: a window of N rows of M features
# on the same 7 x 4 grid, batches of ONLINE_BATCH rows (the ring wraps at
# round N / ONLINE_BATCH = 28), ONLINE_PASSES gated passes an update, a
# checkpoint of every published version
ONLINE_ROUNDS, ONLINE_BATCH, ONLINE_PASSES = 30, 500, 2
#: the rows each round scores (the stream makes them on the host, ~1.2 s a
#: round at 4096; the accuracy gate below holds at 1024 with a standard
#: error of 0.014)
ONLINE_SCORE_BATCH = 1024
ONLINE_ARGV = ["--m", str(M), "--capacity", str(N), "--mesh", f"{P}x{Q}",
               "--loss", "hinge", "--lam", str(LAM), "--passes",
               str(ONLINE_PASSES), "--batch", str(ONLINE_BATCH),
               "--score-batch", str(ONLINE_SCORE_BATCH)]
#: the rounds whose launches are held against the plain version: the first,
#: the first after the wrap, the last
ONLINE_CHECKED = (0, N // ONLINE_BATCH, ONLINE_ROUNDS - 1)
#: the accuracy the served model must beat at the end.  The stream has n / m
#: = 1.17 rows a feature in the window, and the reference's own CLI on the
#: same stream at a tenth of the width (repro.launch.online --m 1200
#: --capacity 1400 --batch 50, the same ratios) serves 0.738 at its last
#: round: a linear model learned from so few rows a feature generalises no
#: better, so 0.9 is out of reach of the algorithm, not of the port
ONLINE_MIN_ACC = 0.65
#: the sparse online update: this many consecutive rows from the middle of
#: row partition 3 of the news20 profile
ONLINE_SPARSE_ROWS = 1000

# the comm policies at the Part 1 width (comm_full): the lossy codecs, and
# the band (low, high) in which the relative objective gap of each must lie
# after OUTER_ITERS D3CA iterations against the uncompressed solve
# (PERF.md section 6, written before the runs: int8 / fp8 within 1 % either
# way; top-k 10 % of each cell between +50 % and +125 %, which a top-k
# without error feedback must leave)
COMM_CODECS = ("int8", "fp8", "topk:0.1")
COMM_GAP_BAND = {"int8": (-1e-2, 1e-2), "fp8": (-1e-2, 1e-2),
                 "topk:0.1": (0.5, 1.25)}
#: exact wire bytes an outer step, 28 cells x (dalpha of n_p = 2000 +
#: w_contrib of m_q = 3003): f32 4 B an entry; int8 / fp8 1 B an entry + a
#: 4 B scale a cell; top-k 8 B per kept entry (200 + 301 a cell)
COMM_BYTES = {None: 560336, "identity": 560336, "int8": 140308,
              "fp8": 140308, "topk:0.1": 112224}
#: hierarchical reductions at Part 1 "4x2" (configs/svm_paper.py PART1[0],
#: 8000 x 6000 at full block size 2000 x 3000): P = 7 admits no pods but
#: 7 of one; flat against pods=2:identity within COMM_TOPO_TOL relative to
#: the largest entry
COMM_TOPO = (4, 2, 8000, 6000)
COMM_TOPO_TOL = 1e-5
#: pods=2:int8 against flat: the relative objective gap it may leave
#: (predicted in PERF.md; RADiSA int8's gap against uncompressed RADiSA is
#: reported, not bounded: ten iterations at gamma = 1 are far from its
#: optimum, where a codec moves the trajectory either way)
COMM_TOPO_GAP = 1e-2
#: the 4 x 2 launches of each topology solve held against the plain
#: version (MAIN_TOL relative to the largest entry): the first and last
COMM_TOPO_CHECKED = (0, OUTER_ITERS - 1)
#: wire bytes an outer step at 4 x 2 under pods=2:int8 -- dalpha (flat, over
#: the model axis) 8 x 2000 x 4; w_contrib within pods 8 x 3000 x 4 and
#: across pods 2 pods x 2 feature blocks x (3000 + 4)
COMM_TOPO_BYTES = 64000 + 96000 + 12016
#: D3CA / RADiSA outer steps timed under each codec (after one warm-up)
COMM_TIMING_STEPS = 5

SWEEP_TOL = 1e-5         # rtol = atol, as in the unit tests
# At the main-path shape a launch chains 2000 dependent steps and the kernel
# sums each inner product in another order than the plain version (strided
# per-thread partial sums, warp shuffles, FMA contraction), so rounding
# differences of ~1e-7 per step compound along the chain, and for the hinge
# loss a step whose margin lies within rounding of the kink takes the other
# branch.  Errors are therefore judged relative to the largest entry of the
# reference result, at 1e-4 (measured on an H100: about 1e-6).
MAIN_TOL = 1e-4

# published peaks of one H100 SXM: device memory rate, float32 rate
# outside the tensor cores (no solver kernel holds a matrix product), the
# dense bf16 tensor-core rate (what bounds attention's products) and the
# dense TF32 one (RWKV6 linear attention's products)
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_TF32_FLOPS = 495e12

# the LM serving paths: the CLI's flags, and the shapes each kernel gets
QWEN3_ARGV = ["--arch", "qwen3-1.7b", "--requests", "16", "--slots", "8",
              "--prompt-len", "128", "--prompt-len-max", "1024", "--gen",
              "32", "--page-size", "16", "--num-pages", "1024",
              "--max-seq-len", "2048"]
RWKV6_ARGV = ["--arch", "rwkv6-3b", "--requests", "8", "--prompt-len", "512",
              "--gen", "32", "--max-seq-len", "544"]
# Qwen3 prefill of one 1024-token bucket: (B, S, H, KV, D), bf16, causal
FLASH_MAIN = (1, 1024, 16, 8, 128)
# RWKV6 prefill of 8 prompts of 512 tokens: (B, S, H, D), u per head
LINATTN_MAIN = (8, 512, 40, 64)
#: B5's main-path shapes in the other families, (B, S, Skv, H, KV, D,
#: causal, window): RecurrentGemma's LOCAL layers in the 4 x 3072 prefill
#: (head dim 256, one KV head, window 2048), Llama-3.2-Vision's XATTN
#: layer (4 x 512 queries over 1024 encoder states, non-causal), and
#: Mixtral's sliding window of 4096 where it bites (one 8192-token prompt)
FLASH_FAMILY_SHAPES = {
    "recurrentgemma_local": (4, 3072, 3072, 16, 1, 256, True, 2048),
    "vlm_xattn": (4, 512, 1024, 64, 8, 128, False, None),
    "mixtral_window": (1, 8192, 8192, 32, 8, 128, True, 4096),
}
#: the scale of q in the peaked draw at those shapes: scaled scores of
#: standard deviation 3, so a few keys carry each row's weight and the
#: running maximum moves from tile to tile (the unit draw spreads a row's
#: weight over hundreds of keys, where each output is a few hundredths)
FLASH_PEAKED_Q = 3.0
# tests/test_kernels.py's tolerances (rtol = atol): flash f32 / bf16, and
# the chunked linear attention against the exact recurrence
FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 3e-2}
LINATTN_TOL = 2e-4
# input draws of the main-shape check of the linear attention, each held
# against the exact recurrence in float64
LINATTN_DRAWS = 6
# card vs CPU on the reduced LM configs, float32: relative to the largest
# entry (the kernels sum in another order than the plain versions)
LM_CARD_CPU_TOL = 1e-4
# the same in bfloat16 (prefill logits relative to the largest logit), the
# bf16 tolerance of tests/test_torch_lm_model.py
LM_CARD_CPU_BF16_TOL = 5e-2

# LM training (train_*_full), at the reference CLI's defaults -- batch 8 of
# 128 tokens, the config's train_accum 8 (8 microbatches of 1),
# remat_policy "nothing", bf16 compute: TRAIN_FULL_STEPS counted steps at
# full width and the depth of the phase's ``TrainPath``, and, where it
# names one, the training CLI's ``main``: steps and a checkpoint, then
# --resume for TRAIN_RESUME_STEPS (see ``TrainPath``).  A checkpoint
# (parameters, mu, nu in float32) of Qwen3-1.7B is 24.4 GB and of RWKV6-3B
# 36.8 GB, and the resume's save is written before the first is deleted;
# they go to a folder in TRAIN_CKPT_ROOT, a tmpfs (the machine that runs
# this script takes at most 45 GiB of disk writes a run), so they live in
# host memory: Qwen3's two (48.8 GB) fit beside the process, RWKV6's
# (73.6 GB) would not
TRAIN_BATCH, TRAIN_SEQ = 8, 128
TRAIN_FULL_STEPS = 3
TRAIN_STEPS, TRAIN_RESUME_STEPS = 2, 2
TRAIN_CKPT_ROOT = "/dev/shm"
#: the first step on the card through the kernels against the same step
#: with the plain versions tapped in, in bfloat16 compute: the loss and the
#: gradient norm relative to their value, each leaf's gradient relative to
#: its largest entry (the bf16 tolerance of the LM card-vs-CPU check)
TRAIN_LOSS_TOL = 1e-2
TRAIN_GRAD_TOL = 5e-2
#: where the bf16 gradients cannot be held leaf by leaf (``TrainPath``'s
#: ``bf16_grads``), the gradients in float32 compute at full width and the
#: depth TRAIN_F32_DEPTH (the first layers of the same weights; all of
#: them where the phase has fewer) on the first microbatch, the kernels
#: against the plain versions, to TRAIN_GRAD_TOL_F32 -- far below the O(1)
#: error of a missing gradient
TRAIN_F32_DEPTH = 4
TRAIN_GRAD_TOL_F32 = 1e-2
#: peak device memory of a training phase over the four float32 copies of
#: the parameters (parameters, gradients, AdamW's mu and nu), at most:
#: the backward's per-leaf temporaries and a microbatch's activations on
#: top (PERF.md's prediction: 1.05-1.2)
TRAIN_PEAK_FACTOR = 1.3

KERNEL_META = {
    "sdca_epoch": {
        "route": "cuda",
        "source": "src/repro_torch/csrc/sdca_epoch_cluster.cu",
        "sources": {"cluster": "src/repro_torch/csrc/sdca_epoch_cluster.cu",
                    "block": "src/repro_torch/csrc/sdca_epoch.cu"},
        "replaces": "src/repro/kernels/sdca/sdca.py:139"},
    "svrg_inner": {
        "route": "cuda", "source": "src/repro_torch/csrc/svrg_inner_ring.cu",
        "sources": {"ring": "src/repro_torch/csrc/svrg_inner_ring.cu",
                    "block": "src/repro_torch/csrc/svrg_inner.cu"},
        "replaces": "src/repro/kernels/svrg/svrg.py:81"},
    "sdca_epoch_sparse": {
        "route": "cuda",
        "source": "src/repro_torch/csrc/sdca_epoch_sparse_ahead.cu",
        "sources": {
            "lookahead": "src/repro_torch/csrc/sdca_epoch_sparse_ahead.cu",
            "block": "src/repro_torch/csrc/sdca_epoch_sparse.cu"},
        "replaces": "src/repro/kernels/sdca/sparse.py:138"},
    "svrg_inner_sparse": {
        "route": "cuda",
        "source": "src/repro_torch/csrc/svrg_inner_sparse.cu",
        "replaces": "src/repro/kernels/svrg/sparse.py:120"},
    "flash_attention": {
        "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention_tc.cu",
        "sources": {"tc": "src/repro_torch/csrc/flash_attention_tc.cu",
                    "simt": "src/repro_torch/csrc/flash_attention.cu"},
        "replaces": "src/repro/kernels/flash/flash.py:81"},
    "rwkv_linattn": {
        "route": "cuda",
        "source": "src/repro_torch/csrc/rwkv_linattn_tc.cu",
        "sources": {"tc": "src/repro_torch/csrc/rwkv_linattn_tc.cu",
                    "simt": "src/repro_torch/csrc/rwkv_linattn.cu"},
        "replaces": "src/repro/kernels/linattn/linattn.py:80"},
}
#: each kernel's wrapper, whose ``launches`` counts its CUDA launches
WRAPPERS = {"sdca_epoch": sdca_epoch, "svrg_inner": svrg_inner,
            "sdca_epoch_sparse": sdca_epoch_sparse,
            "svrg_inner_sparse": svrg_inner_sparse,
            "flash_attention": flash_attention,
            "rwkv_linattn": rwkv_linattn}
#: the solver kernels' plain versions
PLAINS = {"sdca_epoch": sdca_epoch_plain, "svrg_inner": svrg_inner_plain,
          "sdca_epoch_sparse": sdca_epoch_sparse_plain,
          "svrg_inner_sparse": svrg_inner_sparse_plain}
#: the route every main-path launch of each wrapper must take
MAIN_ROUTES = {"flash_attention": "tc", "svrg_inner_sparse": "cluster",
               "sdca_epoch": "cluster", "rwkv_linattn": "tc",
               "svrg_inner": "ring", "sdca_epoch_sparse": "lookahead"}
#: (main-shape tolerance, sweep tolerance) per kernel, as ``compare`` uses
#: them (the solver kernels' main shapes relative to the largest entry)
TOLS = {"sdca_epoch": (MAIN_TOL, SWEEP_TOL),
        "svrg_inner": (MAIN_TOL, SWEEP_TOL),
        "sdca_epoch_sparse": (MAIN_TOL, SWEEP_TOL),
        "svrg_inner_sparse": (MAIN_TOL, SWEEP_TOL),
        "flash_attention": (FLASH_TOL[torch.bfloat16],
                            {"float32": FLASH_TOL[torch.float32],
                             "bfloat16": FLASH_TOL[torch.bfloat16]}),
        "rwkv_linattn": (LINATTN_TOL, LINATTN_TOL)}


def emit(phase: str, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


# device cycles (~1 ms) the card spins before a queued timing, longer than
# the host takes to enqueue one kernel call
QUEUE_CYCLES = 2_000_000


def cuda_ms(fn, reps: int = 5, warmup: int = 1, queued: bool = False):
    """Median CUDA-event time of ``fn()`` in milliseconds.  ``queued``: the
    card first spins for ``QUEUE_CYCLES``, so that the start event, the
    call and the end event are all enqueued before the start event fires
    -- the time is then the device's alone, without the host's launch
    latency (for one kernel call that is tens of microseconds)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if queued:
            torch.cuda._sleep(QUEUE_CYCLES)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def both_ms(fn, reps: int):
    """``fn()`` timed both ways, one right after the other: ``(launch ms,
    device ms)`` -- without ``queued`` (the host's launch latency inside:
    what a caller that waits for one call sees) and with it (the device's
    time alone).  Compare two calls within one of the two, never across."""
    return cuda_ms(fn, reps=reps), cuda_ms(fn, reps=reps, queued=True)


def plain_loop_ms(fn):
    """One call of a solver kernel's plain version, CUDA-event timed: a
    Python loop of one step a row (1-2 s a call at the main-path shapes,
    where a first call's own costs are lost in the loop), so one call
    without a warm-up is taken on each side of the kernel's timings."""
    return cuda_ms(fn, reps=1, warmup=0)


def medians(pairs, key: str) -> dict:
    """``{key: median launch ms, <key with ms -> device_ms>: median device
    ms}`` of a list of :func:`both_ms` pairs."""
    return {key: statistics.median(p[0] for p in pairs),
            key.replace("ms", "device_ms"):
                statistics.median(p[1] for p in pairs)}


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
    """Max abs error over all outputs; raises when over the tolerance
    (``relative_to_max``: over ``tol`` times the largest entry of that
    output's plain result, or 1)."""
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


def row_check(got, want, tol):
    """B5's output (B, S, H, D) against its plain version one query row
    (a position of a head) at a time, each row's largest error over
    ``tol`` times that row's largest entry: the rows' scale differs by
    orders (a row that sees one key copies it, one that sees thousands
    averages them), so a limit of the output's own scale in every row.
    Returns (max abs error, the worst row's share of its limit), as
    0-d tensors on the device (no synchronisation)."""
    err = (got.float() - want.float()).abs().amax(-1)
    limit = (tol * want.float().abs().amax(-1)).clamp_min(1e-30)
    return err.max(), (err / limit).max()


def main_check(label, got, want):
    """A solver kernel at a main-path shape against its plain version,
    each output judged relative to its own largest entry at MAIN_TOL: per
    output (``dalpha`` and ``w``, or ``w``) the max abs error beside the
    largest entry of the plain result (``max_abs_ref``) and their ratio
    (``rel_err``); at the top level the output with the largest ratio."""
    got = (got,) if torch.is_tensor(got) else tuple(got)
    want = (want,) if torch.is_tensor(want) else tuple(want)
    names = ("dalpha", "w") if len(want) == 2 else ("w",)
    each = {}
    for n, g, w in zip(names, got, want):
        err = compare(f"{label} {n}", [g], [w], MAIN_TOL,
                      relative_to_max=True)
        ref = float(w.abs().max())
        each[n] = {"max_abs_err": err, "max_abs_ref": ref,
                   "rel_err": err / max(ref, 1e-30)}
    worst = max(each.values(), key=lambda v: v["rel_err"])
    return {**worst, "outputs": each, "tol": MAIN_TOL,
            "relative_to_max": True}


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


def ell_cells(rng, P_, Q_, n_p, m_q, k, zero_cell=None):
    """(P, Q, n_p, k) padded-ELL cells: a random number of distinct columns
    per row, padding slots (col 0, val 0); row 0 of every cell holds a
    real entry at column 0 beside its col-0 padding, row 1 holds one
    column twice (a LIBSVM line may); ``zero_cell`` (p, q) is an all-zero
    feature block."""
    cols = np.zeros((P_, Q_, n_p, k), np.int32)
    vals = np.zeros((P_, Q_, n_p, k), np.float32)
    for p in range(P_):
        for q in range(Q_):
            if (p, q) == zero_cell:
                continue
            for i in range(n_p):
                r = int(rng.integers(1, min(k, m_q) + 1))
                if i == 0:
                    r = max(1, min(r, k - 1))
                    c = np.r_[0, rng.choice(np.arange(1, m_q), size=r - 1,
                                            replace=False)]
                else:
                    c = rng.choice(m_q, size=r, replace=False)
                c = np.sort(c)
                if i == 1 and r >= 2:
                    c[1] = c[0]
                cols[p, q, i, :r] = c
                vals[p, q, i, :r] = rng.normal(size=r)
    return cols, vals


def sdca_sparse_inputs(rng, P_, Q_, n_p, m_q, k, steps, dev, zero_cell=None):
    cols, vals = ell_cells(rng, P_, Q_, n_p, m_q, k, zero_cell)
    y = np.where(rng.random((P_, n_p)) < 0.5, -1.0, 1.0).astype(np.float32)
    mask = np.ones((P_, n_p), np.float32)
    mask[-1, -2:] = 0.0                                  # masked tail
    a0 = (rng.uniform(0, 0.5, (P_, n_p)) * (y > 0)).astype(np.float32)
    w0 = (rng.normal(size=(Q_, m_q)) * 0.1).astype(np.float32)
    idx = rng.integers(0, n_p, (P_, steps)).astype(np.int32)
    return [torch.from_numpy(a).to(dev)
            for a in (cols, vals, y, mask, a0, w0, idx)]


def svrg_sparse_inputs(rng, P_, Q_, n_p, m_q, m_sub, k, L, dev, lo=None,
                       zero_cell=None):
    cols, vals = ell_cells(rng, P_, Q_, n_p, m_q, k, zero_cell)
    y = np.where(rng.random((P_, n_p)) < 0.5, -1.0, 1.0).astype(np.float32)
    mask = np.ones((P_, n_p), np.float32)
    mask[-1, -2:] = 0.0
    za = rng.normal(size=(P_, n_p)).astype(np.float32)
    wa = (rng.normal(size=(P_, Q_, m_sub)) * 0.2).astype(np.float32)
    mu = (rng.normal(size=(P_, Q_, m_sub)) * 0.05).astype(np.float32)
    idx = rng.integers(0, n_p, (P_, Q_, L)).astype(np.int32)
    out = [torch.from_numpy(a).to(dev)
           for a in (cols, vals, y, mask, za, wa, mu, idx)]
    lo_t = None if lo is None else torch.tensor(lo, dtype=torch.int32,
                                                device=dev)
    return out, lo_t


def svrg_cluster_inputs(rng, P_, Q_, n_p, m_q, m_sub, k, L, dev, lo):
    """``svrg_sparse_inputs`` with the cluster route's edge cases: row 2 of
    every cell all padding, row 3 holding the columns on both sides of
    every slice boundary of the window (and the window's own ends), row 1
    a column twice; steps visit rows 1-3 often."""
    args, lo_t = svrg_sparse_inputs(rng, P_, Q_, n_p, m_q, m_sub, k, L, dev,
                                    lo=lo)
    cols, vals, idx = args[0], args[1], args[7]
    sl = svrg_sparse.cluster_slice(m_sub)
    for p in range(P_):
        off = 0 if lo is None else lo[p]
        edge = sorted({off + c for r in range(1, svrg_sparse.CLUSTER_SIZE)
                       for c in (r * sl - 1, r * sl) if 0 <= c < m_sub}
                      | {off, off + m_sub - 1, max(off - 1, 0),
                         min(off + m_sub, m_q - 1)})[:k]
        cols[p, :, 2] = 0
        vals[p, :, 2] = 0.0
        cols[p, :, 3] = 0
        vals[p, :, 3] = 0.0
        cols[p, :, 3, :len(edge)] = torch.tensor(edge, dtype=torch.int32)
        vals[p, :, 3, :len(edge)] = torch.from_numpy(
            rng.normal(size=len(edge)).astype(np.float32)).to(dev)
    idx[..., ::3] = 3
    idx[..., 1::5] = 2
    idx[..., 2::7] = 1
    return args, lo_t


# the cluster route's sweep: (n_p, m_q, m_sub, k, L, window offsets per row
# partition).  Windows that do not divide by 8, narrower than 8 columns,
# and slices for every register budget of the kernel (8 to 64 columns a
# thread: m_sub 1001, 20 000, 60 000, 100 000, 131 072)
SVRG_CLUSTER_SWEEP = [
    (16, 24, 13, 20, 40, [0, 5, 11]), (16, 40, 5, 16, 40, [3, 0, 35]),
    (24, 1100, 1001, 24, 64, [99, 0, 50]), (20, 20000, 20000, 32, 60, None),
    (16, 61000, 60000, 24, 48, [1000, 7, 0]),
    (12, 100000, 100000, 20, 40, None), (12, 131072, 131072, 20, 30, None),
]
# the block route at RADiSA-avg width on the news20 profile (a whole
# 338 800-column feature block), at a reduced row count
SVRG_BLOCK_WIDE = (64, 338800, 338800, 40, 64)


@functools.lru_cache(maxsize=1)
def news20_problem(dev):
    """The news20 profile cut into 7 x 4 padded-ELL cells on the card (made
    once, shared by the kernels and timing phases)."""
    csr, y = make_sparse_svm_csr(N20, M20, density=DENS20, seed=0)
    return partition_sparse(csr, y, P, Q, m_multiple=P * Q, device=dev)


def news20_state(data):
    """A feasible dual point and its primal image, as the sparse kernels'
    starting state at the main-path shape."""
    dev = data.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    alpha = 0.3 * torch.rand((P, data.n_p), generator=gen, device=dev) \
        * data.y_blocks
    w = ell_scatter_add(data.m_q, data.cols, data.vals,
                        (alpha * data.mask)[:, None, :]).sum(0) / (LAM20 * N20)
    return alpha.contiguous(), w.contiguous()


def sdca_sparse_main_inputs(data, alpha, w, t=1):
    src = GeneratorIndexSource(0, P=P, Q=Q, n_p=data.n_p, device=data.device)
    return (data.cols, data.vals, data.y_blocks, data.mask, alpha, w,
            src.sdca_rows(t))


def svrg_sparse_main_inputs(data, w, t=1):
    """What sparse RADiSA's step hands the kernel at outer iteration t."""
    src = GeneratorIndexSource(0, P=P, Q=Q, n_p=data.n_p, device=data.device)
    z = ell_gather(w, data.cols, data.vals).sum(1)
    y, mask = data.y_blocks, data.mask
    gz = torch.where(y * z < 1.0, -y, torch.zeros_like(y)) * mask
    mu = ell_scatter_add(data.m_q, data.cols, data.vals,
                         gz[:, None, :]).sum(0) / N20 + LAM20 * w
    lo, _, w_anchor, mu_sub = cut_windows(w, mu, src.radisa_perm(t),
                                          data.m_q // P)
    eta = RADiSAConfig().eta(t + 3)      # a mid-run step size (t = 4)
    return (data.cols, data.vals, y, mask, z.contiguous(), w_anchor, mu_sub,
            src.svrg_rows(t)), lo, eta


def sdca_block(args, kw):
    """One sdca_epoch launch on the block route, which the wrapper no
    longer takes at these shapes (its private ``_launch``, past its route
    choice): its sweep stays, as in earlier slices."""
    return sdca_ops._launch(
        *args, lam=kw["lam"], n=kw["n"], Q=kw["Q"],
        loss_id=sdca_ops.check_loss(kw["loss"], "sdca_epoch"),
        beta=kw.get("beta"), route="block")


def svrg_block(args, kw):
    """One svrg_inner launch on the block route, which the wrapper no
    longer takes at the ring route's shapes (its private ``_launch``)."""
    return svrg_route_launch(args, kw, "block")


def svrg_route_launch(args, kw, route):
    """One svrg_inner launch on ``route``, past the wrapper's route
    choice."""
    kw = dict(kw)
    lo = kw.pop("lo", None)
    return svrg_ops._launch(*args, lo, lam=kw["lam"], eta=kw["eta"],
                            loss_id=svrg_ops.check_loss(kw["loss"],
                                                        "svrg_inner"),
                            route=route)


def sparse_route_launch(args, kw, route):
    """One sdca_epoch_sparse launch on ``route``, past the wrapper's route
    choice."""
    return sdca_sparse._launch(
        *args, lam=kw["lam"], n=kw["n"], Q=kw["Q"],
        loss_id=sdca_sparse.check_loss(kw["loss"], "sdca_epoch_sparse"),
        beta=kw.get("beta"), route=route)


def sdca_cluster_of(fn):
    """Call ``fn`` (one sdca_epoch call) and return the cluster size its
    launch took, read from the wrapper's per-size counter."""
    before = dict(sdca_epoch.launches_by_cluster)
    out = fn()
    grew = [g for g, v in sdca_epoch.launches_by_cluster.items()
            if v != before[g]]
    if len(grew) != 1 or sdca_epoch.launches_by_cluster[grew[0]] \
            != before[grew[0]] + 1:
        raise AssertionError(f"expected one cluster launch: {before} -> "
                             f"{sdca_epoch.launches_by_cluster}")
    return grew[0], out


def repeated_rows(idx, R=4):
    """``idx`` (steps on the last axis) with a row visited twice in a row,
    three times in a row, R steps apart and R + 1 steps apart, in every
    cell's order."""
    idx = idx.clone()
    steps = idx.shape[-1]
    for h, back in ((5, 1), (9, 1), (10, 2), (20, R), (31, R + 1), (33, R)):
        if h < steps:
            idx[..., h] = idx[..., h - back]
    return idx


#: the cluster route's sweep: (grid, n_p, m_q, steps) at both cluster
#: sizes of the wrapper's table -- widths 9, 17 and 3003 on one CTA, 4097
#: (15 slices of 257 columns and one of 242) and the serial-SDCA width on
#: 16 -- none of which divides by G * E; step counts below the ring, not
#: a multiple of it, and (300) enough for 75 turns of the four slots of
#: the exchange between CTAs
SDCA_CLUSTER_SWEEP = [((3, 2), 24, 9, 101), ((3, 2), 40, 17, 64),
                      ((2, 2), 40, 3003, 3), ((1, 2), 40, 3003, 150),
                      ((2, 2), 40, 4097, 3), ((1, 2), 40, 4097, 150),
                      ((1, 1), 300, M, 300)]


def sdca_cluster_sweep(rng, dev, checks):
    """The cluster route through the public wrapper at every cluster
    size of its table (read from its counter): masked rows, exact and
    beta denominators, hinge and squared, repeated indices."""
    seen = set()
    for (grid, n_p, m_q, steps) in SDCA_CLUSTER_SWEEP:
        if sdca_route(n_p, m_q, steps) != "cluster":
            raise AssertionError(f"m_q={m_q} is not a cluster case")
        args = sdca_inputs(rng, *grid, n_p, m_q, steps, dev, masked_tail=3)
        args[5] = repeated_rows(args[5])
        check_index_range(args[5], n_p)
        if m_q > 1000:
            args[0] = args[0] / float(np.sqrt(m_q))
        for loss in ("hinge", "squared"):
            for beta in (None, float(m_q)):
                kw = dict(lam=0.2, n=200, Q=3, loss=loss, beta=beta)
                G, got = sdca_cluster_of(lambda: sdca_epoch(*args, **kw))
                seen.add(G)
                checks.append(("sdca_epoch", compare(
                    f"sdca_epoch cluster G={G} {grid}{(n_p, m_q, steps)} "
                    f"{loss} beta={beta}", got,
                    sdca_epoch_plain(*args, **kw), SWEEP_TOL)))
    if seen != set(sdca_ops.CLUSTER_SIZES):
        raise AssertionError(f"the sweep took cluster sizes {sorted(seen)}")
    torch.cuda.synchronize()


#: the ring route's sweep: (grid, n_p, m_x, m_sub, L, window offsets per
#: row partition) -- windows that start off a 16-byte boundary (lo 1, 3, 5,
#: 7, 87, 429, 858), widths that divide by no thread count (13, 100, 429,
#: 513 on four warps, 2000), a whole row as the window, step counts 0 and 3
#: (below the ring) and 150
SVRG_RING_SWEEP = [((3, 2), 16, 20, 13, 40, [1, 5, 7]),
                   ((3, 2), 24, 110, 100, 70, [3, 10, 0]),
                   ((2, 2), 40, 3003, 429, 150, [1, 429]),
                   ((1, 2), 30, 3003, 429, 3, [858]),
                   ((2, 1), 20, 600, 513, 60, [87, 1]),
                   ((1, 2), 24, 2000, 2000, 50, None),
                   ((2, 2), 8, 20, 16, 0, [0, 3])]


def svrg_ring_sweep(rng, dev, checks):
    """The ring route through the public wrapper, at both warp counts of
    its table: masked rows, hinge and squared, rows repeated 1, 2, 4 and 5
    steps apart."""
    warps_seen = set()
    for (grid, n_p, m_x, m_sub, L, los) in SVRG_RING_SWEEP:
        if svrg_route(m_sub, L) != "ring":
            raise AssertionError(f"m_sub={m_sub}, L={L} is not a ring case")
        args, lo_t = svrg_inputs(rng, *grid, n_p, m_x, m_sub, L, dev,
                                 lo=los)
        args[0] = args[0] / float(np.sqrt(m_sub))   # eta ||x||^2 < 1
        args[6] = repeated_rows(args[6])
        if L:
            check_index_range(args[6], n_p)
        if lo_t is not None:
            check_index_range(lo_t, m_x - m_sub + 1)
        warps_seen.add(svrg_ops.svrg_ring_warps(m_sub))
        for loss in ("hinge", "squared"):
            kw = dict(lam=0.1, eta=0.03, loss=loss, lo=lo_t)
            want = [svrg_inner_plain(*args, **kw)]
            label = f"svrg_inner ring{grid}{(n_p, m_x, m_sub, L)} lo={los}"
            checks.append(("svrg_inner", compare(
                f"{label} {loss}", [svrg_inner(*args, **kw)], want,
                SWEEP_TOL)))
    if warps_seen != set(svrg_ops.RING_WARPS):
        raise AssertionError(f"the ring sweep took warps {warps_seen}")
    torch.cuda.synchronize()


def shuffled_slots(rng, args):
    """``sdca_sparse_inputs``' cells with the slots of every ELL row in a
    random order: unsorted LIBSVM rows, padding between real entries."""
    cols, vals = args[0], args[1]
    order = torch.from_numpy(np.argsort(rng.random(cols.shape), axis=-1)
                             ).to(cols.device)
    return [torch.gather(cols, -1, order).contiguous(),
            torch.gather(vals, -1, order).contiguous(), *args[2:]]


def repeated_at(idx, distances, start=12, gap=6):
    """``idx`` with step ``start + gap * t`` visiting the row of the step
    ``distances[t]`` before it (the steps that exist)."""
    idx = idx.clone()
    for t, back in enumerate(distances):
        h = start + gap * t
        if h < idx.shape[-1]:
            idx[..., h] = idx[..., h - back]
    return idx


#: the lookahead route's sweep: (grid, n_p, m_q, k, steps) -- ELL rows of
#: 2, 4 and 10 16-byte words, a block narrower than a row (m_q = 20 < 2 k:
#: rows share most columns, every overlap counts), a wide block, step
#: counts 3 (below the deepest lookahead) and 50 / 150 (past the ring)
SPARSE_AHEAD_SWEEP = [((3, 2), 24, 20, 16, 50), ((3, 2), 40, 128, 40, 150),
                      ((2, 2), 17, 9, 8, 3), ((1, 2), 64, 5000, 40, 100)]


def sparse_ahead_sweep(rng, dev, checks):
    """The lookahead route through the public wrapper: unsorted rows,
    padding slots, a column twice in a row, an all-zero feature block,
    masked rows, hinge and squared, exact and beta denominators, and rows
    repeated 1 .. D + 1 steps apart (D the lookahead depth)."""
    D = sdca_sparse.AHEAD_DEPTH
    for (grid, n_p, m_q, k, steps) in SPARSE_AHEAD_SWEEP:
        if sdca_sparse_route(n_p, k, steps) != "lookahead":
            raise AssertionError(f"k={k} is not a lookahead case")
        args = shuffled_slots(rng, sdca_sparse_inputs(
            rng, *grid, n_p, m_q, k, steps, dev,
            zero_cell=(1, 1) if grid == (3, 2) else None))
        check_index_range(args[0], m_q)
        args[6] = repeated_at(args[6], range(1, D + 2))
        check_index_range(args[6], n_p)
        for loss in ("hinge", "squared"):
            for beta in (None, float(k)):
                kw = dict(lam=0.2, n=200, Q=3, loss=loss, beta=beta)
                checks.append(("sdca_epoch_sparse", compare(
                    f"sdca_epoch_sparse lookahead{grid}"
                    f"{(n_p, m_q, k, steps)} {loss} beta={beta}",
                    sdca_epoch_sparse(*args, **kw),
                    sdca_epoch_sparse_plain(*args, **kw), SWEEP_TOL)))
    torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# row gates: the online service's updates hand the SDCA kernels a mask that
# is off on most rows (mask * gate, core/d3ca.py)
# ---------------------------------------------------------------------------

#: the gated sweep's cases: (kernel, route, grid, n_p, m_q, k or None,
#: steps, cluster size of B1's cluster route or None)
GATED_SWEEP = [
    ("sdca_epoch", "cluster", (3, 2), 24, 17, None, 64, 1),
    ("sdca_epoch", "cluster", (2, 2), 40, 4097, None, 150, 16),
    ("sdca_epoch", "block", (3, 2), 17, 9, None, 33, None),
    ("sdca_epoch_sparse", "lookahead", (3, 2), 24, 20, 16, 50, None),
    ("sdca_epoch_sparse", "block", (3, 2), 17, 9, 7, 33, None),
]


def gate_masks(rng, mask):
    """The gates of the sweep, each times the row mask of the inputs:
    one row partition on and the rest off, 5 % of the rows on at random,
    every row off."""
    one = torch.zeros_like(mask)
    one[mask.shape[0] // 2] = 1.0
    few = torch.from_numpy((rng.random(tuple(mask.shape)) < 0.05)
                           .astype(np.float32)).to(mask.device)
    return {"one partition": one * mask, "5 % of rows": few * mask,
            "all off": torch.zeros_like(mask)}


def gated_sweep(rng, dev, checks):
    """B1 (cluster at G = 1 and 16, block) and B3 (lookahead, block) with
    the gates of :func:`gate_masks` as their row mask, against their
    plain versions within SWEEP_TOL; with every row off, dalpha must be 0
    exactly and w_out bitwise w0 in every cell.  Returns one record a
    case."""
    out = []
    for name, route, grid, n_p, m_q, k, steps, G in GATED_SWEEP:
        if name == "sdca_epoch":
            args = sdca_inputs(rng, *grid, n_p, m_q, steps, dev,
                               masked_tail=3)
            args[5] = repeated_rows(args[5])
            if m_q > 1000:
                args[0] = args[0] / float(np.sqrt(m_q))
            mask_at = 2
            routed = sdca_route(n_p, m_q, steps)
        else:
            args = shuffled_slots(rng, sdca_sparse_inputs(
                rng, *grid, n_p, m_q, k, steps, dev, zero_cell=(1, 1)))
            args[6] = repeated_at(args[6], range(1, sdca_sparse.AHEAD_DEPTH
                                                 + 2))
            mask_at = 3
            routed = sdca_sparse_route(n_p, k, steps)
        if route != "block" and routed != route or (
                G is not None and sdca_ops.sdca_cluster_size(m_q) != G):
            raise AssertionError(f"{name} {(n_p, m_q, k, steps)} is not a "
                                 f"{route} G={G} case")
        for label, gate in gate_masks(rng, args[mask_at]).items():
            gargs = list(args)
            gargs[mask_at] = gate
            for loss in ("hinge", "squared"):
                for beta in (None, float(k or m_q)):
                    kw = dict(lam=0.2, n=200, Q=3, loss=loss, beta=beta)
                    if route == "block":
                        got = (sdca_block(gargs, kw) if name == "sdca_epoch"
                               else sparse_route_launch(gargs, kw, "block"))
                    elif G is not None:
                        took, got = sdca_cluster_of(
                            lambda: sdca_epoch(*gargs, **kw))
                        if took != G:
                            raise AssertionError(f"{name}: G = {took}")
                    else:
                        got = WRAPPERS[name](*gargs, **kw)
                    err = compare(f"{name} {route} G={G} gated ({label}) "
                                  f"{grid}{(n_p, m_q, k, steps)} {loss} "
                                  f"beta={beta}", got,
                                  PLAINS[name](*gargs, **kw), SWEEP_TOL)
                    checks.append((name, err))
                    if label == "all off":
                        w0 = gargs[mask_at + 2]
                        if not bool((got[0] == 0).all()) or not torch.equal(
                                got[1].view(torch.int32),
                                w0.expand_as(got[1]).view(torch.int32)):
                            raise AssertionError(
                                f"{name} {route} G={G}: a gated-off row "
                                "moved its dual or w")
                    out.append({"kernel": name, "route": route,
                                "cluster": G, "gate": label, "loss": loss,
                                "beta": beta is not None,
                                "max_abs_err": err})
    torch.cuda.synchronize()
    return out


# ---------------------------------------------------------------------------
# the tenant axis: T problems of one shape in one launch, a distinct lam in
# every cell (the fleet's runtime branch of the four solver kernels)
# ---------------------------------------------------------------------------

def stack_tenants(name, per_tenant):
    """T argument lists of one kernel (each a problem of the same shape)
    -> one list with the tenant axis (``kernels._launch.TENANT_AXES``),
    contiguous."""
    return [torch.stack(arrs, dim=ax).contiguous()
            for arrs, ax in zip(zip(*per_tenant), tenant_axes(name))]


def drop_tenant(name, args):
    """The T = 1 arguments without their tenant axis."""
    return [a.squeeze(ax).contiguous()
            for a, ax in zip(args, tenant_axes(name))]


def one_launch(name, fn):
    """``fn()`` must make exactly one launch of ``name``, whatever T."""
    before = WRAPPERS[name].launches
    out = fn()
    if WRAPPERS[name].launches != before + 1:
        raise AssertionError(f"{name}: {WRAPPERS[name].launches - before} "
                             "launches for one call")
    return out


def cell_scalars(rng, lead, lo, hi, dev):
    return torch.from_numpy(rng.uniform(lo, hi, lead).astype(np.float32)
                            ).to(dev)


def tenant_case(rng, dev, checks, name, label, make, call, plain, kw_of):
    """One route of one solver kernel at T = 1 and T = 3, a distinct lam
    (and beta) in every cell, against its plain version; at T = 1 the
    launch with per-cell scalars (all equal) must also give bitwise the
    output of the scalar launch of the same arguments without a tenant
    axis."""
    for T in (1, 3):
        per = [make() for _ in range(T)]
        lo = None
        if isinstance(per[0], tuple):            # SVRG: (args, lo)
            lo = torch.stack([p[1] for p in per], dim=1).contiguous()
            per = [p[0] for p in per]
        args = stack_tenants(name, per)
        lead = tuple(args[0].shape[:3])
        for kw in kw_of(lead):
            kw = dict(kw, **({} if lo is None else {"lo": lo}))
            got = one_launch(name, lambda: call(args, kw))
            want = plain(*args, **kw)
            got, want = ((got,), (want,)) if torch.is_tensor(got) \
                else (got, want)
            checks.append((name, compare(
                f"{name} {label} T={T} per-cell lam {tuple(args[0].shape)} "
                f"{kw.get('loss')} beta={kw.get('beta') is not None}",
                got, want, SWEEP_TOL)))
            if T != 1:
                continue
            same = {k: (torch.full(lead, float(v.flatten()[0]), device=dev)
                        if torch.is_tensor(v) and v.dtype == torch.float32
                        and k != "lo" else v) for k, v in kw.items()}
            scal = {k: (float(v.flatten()[0]) if torch.is_tensor(v)
                        and v.dtype == torch.float32 and k != "lo" else v)
                    for k, v in kw.items()}
            if lo is not None:
                scal["lo"] = lo[:, 0].contiguous()
            per_cell = call(args, same)
            scalar = call(drop_tenant(name, args), scal)
            per_cell = (per_cell,) if torch.is_tensor(per_cell) else per_cell
            scalar = (scalar,) if torch.is_tensor(scalar) else scalar
            for a, b in zip(per_cell, scalar):
                if not torch.equal(a[:, :, 0], b):
                    raise AssertionError(
                        f"{name} {label}: T = 1 with per-cell scalars is "
                        "not bitwise the scalar launch")


def tenant_kernel_checks(rng, dev, checks):
    """Every route of the four solver kernels with a tenant axis (T = 1
    and 3) and a distinct lam -- and, for SDCA, beta -- in every cell:
    B1 block (forced past the wrapper's route choice, as its sweep above)
    and cluster at both cluster sizes, B2 ring and block (forced), B3
    lookahead and block, B4 block (forced) and cluster.  The counters
    must see one launch a call."""
    def sdca_kw(loss_beta):
        def kws(lead):
            out = []
            for loss, beta in loss_beta:
                kw = dict(lam=cell_scalars(rng, lead, 0.05, 0.5, dev),
                          n=cell_scalars(rng, lead, 150, 250, dev), Q=3,
                          loss=loss)
                if beta is not None:
                    kw["beta"] = cell_scalars(rng, lead, 0.8 * beta,
                                              1.2 * beta, dev)
                out.append(kw)
            return out
        return kws

    def svrg_kw(lead):
        return [dict(lam=cell_scalars(rng, lead, 0.05, 0.3, dev),
                     eta=cell_scalars(rng, lead, 0.01, 0.04, dev), loss=loss)
                for loss in ("hinge", "squared")]

    def sdca_call(route=None):
        def call(args, kw):
            if route == "block":
                return sdca_block(args, kw)
            return sdca_epoch(*args, **kw)
        return call

    for label, (grid, n_p, m_q, steps), G in (
            ("cluster G=1", ((3, 2), 24, 17, 64), 1),
            ("cluster G=16", ((1, 2), 40, 4097, 150), 16),
            ("block", ((3, 2), 17, 9, 33), None)):
        if G is not None and (sdca_route(n_p, m_q, steps) != "cluster" or
                              sdca_ops.sdca_cluster_size(m_q) != G):
            raise AssertionError(f"{m_q} columns are not a G={G} case")

        def make(grid=grid, n_p=n_p, m_q=m_q, steps=steps):
            args = sdca_inputs(rng, *grid, n_p, m_q, steps, dev)
            if m_q > 1000:
                args[0] = args[0] / float(np.sqrt(m_q))
            args[5] = repeated_rows(args[5])
            return args
        before = dict(sdca_epoch.launches_by_cluster)
        tenant_case(rng, dev, checks, "sdca_epoch", label, make,
                    sdca_call("block" if G is None else None),
                    sdca_epoch_plain,
                    sdca_kw([("hinge", None), ("squared", None),
                             ("hinge", float(m_q))]))
        if G is not None and sdca_epoch.launches_by_cluster[G] == before[G]:
            raise AssertionError(f"no sdca_epoch launch at G={G}")

    if svrg_route(5, 11) != "ring" or svrg_route(5, 37) != "ring" \
            or sdca_sparse_route(17, 8, 33) != "lookahead" \
            or sdca_sparse_route(17, 7, 33) != "block":
        raise AssertionError("the B2 / B3 tenant cases left their routes")
    tenant_case(rng, dev, checks, "svrg_inner", "ring",
                lambda: svrg_inputs(rng, 3, 2, 13, 15, 5, 11, dev,
                                    lo=[5, 10, 1]),
                lambda args, kw: svrg_inner(*args, **kw), svrg_inner_plain,
                svrg_kw)
    tenant_case(rng, dev, checks, "sdca_epoch_sparse", "block",
                lambda: sdca_sparse_inputs(rng, 3, 2, 17, 9, 7, 33, dev,
                                           zero_cell=(1, 1)),
                lambda args, kw: sdca_epoch_sparse(*args, **kw),
                sdca_epoch_sparse_plain,
                sdca_kw([("hinge", None), ("squared", None),
                         ("hinge", 7.0)]))
    n_p, m_q, m_sub, k, L, los = SVRG_CLUSTER_SWEEP[2]
    if svrg_sparse_route(m_sub, k) != "cluster":
        raise AssertionError("the tenant case is not on the cluster route")
    tenant_case(rng, dev, checks, "svrg_inner_sparse", "cluster",
                lambda: svrg_cluster_inputs(rng, 3, 2, n_p, m_q, m_sub, k,
                                            L, dev, los),
                lambda args, kw: svrg_inner_sparse(*args, **kw),
                svrg_inner_sparse_plain, svrg_kw)

    def sparse_block(args, kw):
        kw = dict(kw)
        lo = kw.pop("lo", None)
        return svrg_sparse._launch(*args, lo, loss_id=0 if kw.pop("loss")
                                   == "hinge" else 1, route="block", **kw)
    tenant_case(rng, dev, checks, "svrg_inner_sparse", "block",
                lambda: svrg_sparse_inputs(rng, 3, 2, 13, 15, 5, 5, 11, dev,
                                           lo=[5, 10, 1], zero_cell=(2, 0)),
                sparse_block, svrg_inner_sparse_plain, svrg_kw)

    # the routes added last: B2 ring with repeated rows and B2 block
    # (forced), B3 lookahead on unsorted rows with rows repeated 1 .. D + 1
    # steps apart
    def svrg_make():
        args, lo = svrg_inputs(rng, 3, 2, 13, 15, 5, 37, dev,
                               lo=[5, 10, 1])
        args[6] = repeated_rows(args[6])
        return args, lo
    tenant_case(rng, dev, checks, "svrg_inner", "ring", svrg_make,
                lambda args, kw: svrg_inner(*args, **kw), svrg_inner_plain,
                svrg_kw)
    tenant_case(rng, dev, checks, "svrg_inner", "block", svrg_make,
                svrg_block, svrg_inner_plain, svrg_kw)

    def ahead_make():
        args = shuffled_slots(rng, sdca_sparse_inputs(
            rng, 3, 2, 17, 9, 8, 33, dev, zero_cell=(1, 1)))
        args[6] = repeated_at(args[6], range(1, sdca_sparse.AHEAD_DEPTH + 2),
                              start=4, gap=5)
        return args
    tenant_case(rng, dev, checks, "sdca_epoch_sparse", "lookahead",
                ahead_make, lambda args, kw: sdca_epoch_sparse(*args, **kw),
                sdca_epoch_sparse_plain,
                sdca_kw([("hinge", None), ("squared", None),
                         ("hinge", 8.0)]))
    torch.cuda.synchronize()


def fleet_lams(base, T):
    """The fleets' per-tenant lambda: ``base * 0.5 ** (t % 3)``."""
    return [base * 0.5 ** (t % 3) for t in range(T)]


def dense_tenants(data, alpha, w, T):
    """B1's and B2's main-path inputs for T tenants of the dense instance,
    as a fleet hands them over: tenant t at ``fleet_lams(LAM, T)[t]``
    with its primal image scaled to that lambda, its own coordinate
    orders and window offsets (outer iteration 1 + t of the seed-0
    source), lambda (and n) as per-tenant (T,) tensors.  Per kernel:
    (per-tenant argument lists, per-tenant lo or None, keywords)."""
    lams = fleet_lams(LAM, T)
    dev = data.device
    src = GeneratorIndexSource(0, P=P, Q=Q, n_p=data.n_p, device=dev)
    lam_t = torch.tensor(lams, device=dev)
    sdca = [(data.x_blocks, data.y_blocks, data.mask, alpha, w * (LAM / lam),
             src.sdca_rows(1 + t)) for t, lam in enumerate(lams)]
    svrg = [svrg_main_inputs(data, w * (LAM / lam), t=1 + t)
            for t, lam in enumerate(lams)]
    return {
        "sdca_epoch": (sdca, None, dict(
            lam=lam_t, n=torch.full((T,), float(N), device=dev), Q=Q,
            loss="hinge")),
        "svrg_inner": ([a for a, _, _ in svrg], [lo for _, lo, _ in svrg],
                       dict(lam=lam_t, eta=svrg[0][2], loss="hinge"))}


def sparse_tenants(sp, alpha, w, T):
    """B3's and B4's main-path inputs for T news20 tenants, as
    :func:`dense_tenants` makes B1's and B2's."""
    lams = fleet_lams(LAM20, T)
    dev = sp.device
    lam_t = torch.tensor(lams, device=dev)
    sdca = [sdca_sparse_main_inputs(sp, alpha, w * (LAM20 / lam), t=1 + t)
            for t, lam in enumerate(lams)]
    svrg = [svrg_sparse_main_inputs(sp, w * (LAM20 / lam), t=1 + t)
            for t, lam in enumerate(lams)]
    return {
        "sdca_epoch_sparse": (sdca, None, dict(
            lam=lam_t, n=torch.full((T,), float(N20), device=dev), Q=Q,
            loss="hinge")),
        "svrg_inner_sparse": ([a for a, _, _ in svrg],
                              [lo for _, lo, _ in svrg],
                              dict(lam=lam_t, eta=svrg[0][2], loss="hinge"))}


def stacked(name, per, los, kw):
    """One launch's arguments and keywords from :func:`dense_tenants` /
    :func:`sparse_tenants`: the tenants stacked on their tenant axes."""
    kw = dict(kw)
    if los is not None:
        kw["lo"] = torch.stack(los, dim=tenant_axes(name)[-1]).contiguous()
    return stack_tenants(name, per), kw


#: the route each solver kernel's fleet launches take at the main path's
#: shapes (and, for B1, the cluster size)
FLEET_ROUTES = {"sdca_epoch": ("cluster", 1), "svrg_inner": ("ring", None),
                "sdca_epoch_sparse": ("lookahead", None),
                "svrg_inner_sparse": ("cluster", None)}


def tenant_main_check(name, tenants):
    """One solver kernel at the fleet's main-path shape -- T tenants'
    cells in one launch, per-tenant scalars -- against its plain
    version, relative to the largest entry at MAIN_TOL, on the route
    (and cluster size) the fleet phases take."""
    per, los, kw = tenants[name]
    args, kw = stacked(name, per, los, kw)
    T = args[0].shape[2]
    route, G = FLEET_ROUTES[name]
    before = route_counts(name)
    if name == "sdca_epoch":
        took, got = sdca_cluster_of(
            lambda: one_launch(name, lambda: sdca_epoch(*args, **kw)))
        if took != G:
            raise AssertionError(f"{name} at T={T}: cluster size {took}")
    else:
        got = one_launch(name, lambda: WRAPPERS[name](*args, **kw))
    if route_counts(name)[route] != before[route] + 1:
        raise AssertionError(f"{name} at T={T} did not take the {route!r} "
                             "route")
    res = main_check(f"{name} main-path shape, T={T} tenants "
                     f"{tuple(args[0].shape)}", got,
                     PLAINS[name](*args, **kw))
    del args, got
    torch.cuda.synchronize()
    return {"T": T, "route": route, "cluster": G, **res}


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

#: the card's name and power limit as nvidia-smi gives them (phase_env)
CARD = {}


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
    CARD["line"] = smi
    emit("env", card=smi, torch=torch.__version__, cuda=torch.version.cuda,
         allow_tf32=torch.backends.cuda.matmul.allow_tf32,
         capability=list(torch.cuda.get_device_capability(0)))
    return smi


def ptxas_usage(log):
    """Per kernel (mangled name): registers, shared memory and spills as
    ``ptxas -v`` reported them."""
    usage, name = {}, None
    for ln in log.splitlines():
        if "Function properties for " in ln:
            name = ln.split("Function properties for ")[1].strip()
            usage[name] = {}
        elif name and "spill" in ln:
            usage[name]["spill"] = ln.strip()
        elif name and "Used " in ln and "registers" in ln:
            usage[name]["used"] = ln.split("Used ", 1)[1].strip()
            name = None
    return usage


def phase_build():
    t0 = time.perf_counter()
    info = kernels.build_info()
    usage = ptxas_usage(info.pop("ptxas"))
    emit("build", seconds=time.perf_counter() - t0, **info, ptxas=usage)


def phase_kernels(dev, results):
    rng = np.random.default_rng(7)
    checks = []
    reset_counts()

    # -- the unit tests' shape sweep, one cell and a small grid, on both
    # routes: the wrapper's (cluster, one CTA a cell at these widths) and
    # the block route the wider shapes of earlier slices took
    for (n_p, m_q, steps) in [(8, 8, 8), (24, 16, 50), (64, 128, 64),
                              (17, 9, 33)]:
        for grid in [(1, 1), (3, 2)]:
            args = sdca_inputs(rng, *grid, n_p, m_q, steps, dev)
            check_index_range(args[5], n_p)
            for loss in ("hinge", "squared"):
                for beta in (None, float(m_q)):
                    kw = dict(lam=0.2, n=200, Q=3, loss=loss, beta=beta)
                    want = sdca_epoch_plain(*args, **kw)
                    label = f"sdca_epoch{grid}{(n_p, m_q, steps)} {loss}"
                    checks.append(("sdca_epoch", compare(
                        label, sdca_epoch(*args, **kw), want, SWEEP_TOL)))
                    checks.append(("sdca_epoch", compare(
                        label + " block", sdca_block(args, kw), want,
                        SWEEP_TOL)))
    # one cell alone, in the unbatched shapes of the TPU kernel's signature
    args = sdca_inputs(rng, 1, 1, 17, 9, 33, dev)
    kw = dict(lam=0.2, n=200, Q=3, loss="hinge")
    got = sdca_epoch(*(a[0, 0] if a.dim() == 4 else a[0] for a in args), **kw)
    want = sdca_epoch_plain(*args, **kw)
    checks.append(("sdca_epoch", compare(
        "sdca_epoch unbatched", got, (want[0][0, 0], want[1][0, 0]),
        SWEEP_TOL)))
    # the serial-SDCA shape: one cell, m = 12 000, at 500 steps (cluster
    # route, the table's cluster size; block route: 144 KB of dynamic
    # shared memory, over the 48 KB that needs no opt-in)
    args = sdca_inputs(rng, 1, 1, 500, M, 500, dev, masked_tail=0)
    args[0] = args[0] / float(np.sqrt(M))
    kw = dict(lam=0.2, n=500, Q=1, loss="hinge")
    if sdca_route(500, M, 500) != "cluster":
        raise AssertionError("the serial-SDCA width is not a cluster case")
    want = sdca_epoch_plain(*args, **kw)
    checks.append(("sdca_epoch", compare(
        "sdca_epoch one cell m=12000", sdca_epoch(*args, **kw), want,
        SWEEP_TOL)))
    checks.append(("sdca_epoch", compare(
        "sdca_epoch one cell m=12000 block", sdca_block(args, kw), want,
        SWEEP_TOL)))
    sdca_cluster_sweep(rng, dev, checks)
    del args, want

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
                    want = [svrg_inner_plain(*args, **kw)]
                    label = f"svrg_inner{grid}{(n_p, m_sub, L)} lo={lo}"
                    checks.append(("svrg_inner", compare(
                        label, [svrg_inner(*args, **kw)], want, SWEEP_TOL)))
                    checks.append(("svrg_inner", compare(
                        label + " block", [svrg_block(args, kw)], want,
                        SWEEP_TOL)))
    svrg_ring_sweep(rng, dev, checks)

    # -- the main-path shape: 28 cells of 2000 x 3003 -----------------------
    data, alpha, w = full_problem(dev)
    src = GeneratorIndexSource(0, P=P, Q=Q, n_p=data.n_p, device=dev)
    idx = src.sdca_rows(1)
    check_index_range(idx, data.n_p)
    sargs = (data.x_blocks, data.y_blocks, data.mask, alpha, w, idx)
    skw = dict(lam=LAM, n=N, Q=Q, loss="hinge")
    main_err = {"sdca_epoch": main_check(
        "sdca_epoch main-path shape", sdca_epoch(*sargs, **skw),
        sdca_epoch_plain(*sargs, **skw))}
    vargs, lo, eta = svrg_main_inputs(data, w)
    check_index_range(vargs[6], data.n_p)
    check_index_range(lo, data.m_q - data.m_q // P + 1)
    vkw = dict(lam=LAM, eta=eta, loss="hinge", lo=lo)
    want = svrg_inner_plain(*vargs, **vkw)
    main_err["svrg_inner"] = main_check("svrg_inner main-path shape",
                                        svrg_inner(*vargs, **vkw), want)
    del want
    # -- the same kernels as the dense fleet launches them: 4 tenants' cells
    # (B1: 112 CTAs, one wave) with per-tenant lambda and n in one launch
    tenants = dense_tenants(data, alpha, w, FLEET_T_DENSE)
    for name in ("sdca_epoch", "svrg_inner"):
        results[name]["tenant_main"] = tenant_main_check(name, tenants)
    del tenants
    torch.cuda.synchronize()

    # -- the sparse kernels over the unit tests' sweep: hinge / squared,
    # exact / beta, masked tail, k not a multiple of 32, col-0 entries
    # beside col-0 padding, a repeated column, an all-zero feature block
    for (n_p, m_q, k, steps) in [(8, 8, 3, 8), (24, 16, 5, 50),
                                 (64, 128, 40, 64), (17, 9, 7, 33)]:
        for grid, zero in [((1, 1), None), ((3, 2), (1, 1))]:
            args = sdca_sparse_inputs(rng, *grid, n_p, m_q, k, steps, dev,
                                      zero_cell=zero)
            check_index_range(args[6], n_p)
            check_index_range(args[0], m_q)
            for loss in ("hinge", "squared"):
                for beta in (None, float(k)):
                    kw = dict(lam=0.2, n=200, Q=3, loss=loss, beta=beta)
                    want = sdca_epoch_sparse_plain(*args, **kw)
                    label = f"sdca_epoch_sparse{grid}{(n_p, m_q, k, steps)}"
                    checks.append(("sdca_epoch_sparse", compare(
                        label, sdca_epoch_sparse(*args, **kw), want,
                        SWEEP_TOL)))
                    if sdca_sparse_route(n_p, k, steps) != "block":
                        checks.append(("sdca_epoch_sparse", compare(
                            label + " block",
                            sparse_route_launch(args, kw, "block"), want,
                            SWEEP_TOL)))
    sparse_ahead_sweep(rng, dev, checks)
    # (n_p, m_q, m_sub, k, L, window offsets per row partition): the whole
    # block, windows at 8 / 16 / 0, misaligned windows at 5 / 10 / 1
    for (n_p, m_q, m_sub, k, L, los) in [
            (16, 24, 24, 6, 20, None), (16, 24, 8, 6, 20, [8, 16, 0]),
            (40, 32, 32, 9, 64, None), (13, 15, 5, 5, 11, [5, 10, 1])]:
        for grid, zero in [((1, 1), None), ((3, 2), (2, 0))]:
            lo = None if los is None else los[:grid[0]]
            args, lo_t = svrg_sparse_inputs(rng, *grid, n_p, m_q, m_sub, k,
                                            L, dev, lo=lo, zero_cell=zero)
            check_index_range(args[7], n_p)
            check_index_range(args[0], m_q)
            for loss in ("hinge", "squared"):
                kw = dict(lam=0.1, eta=0.03, loss=loss, lo=lo_t)
                err = compare(
                    f"svrg_inner_sparse{grid}{(n_p, m_sub, k, L)} lo={lo}",
                    [svrg_inner_sparse(*args, **kw)],
                    [svrg_inner_sparse_plain(*args, **kw)], SWEEP_TOL)
                checks.append(("svrg_inner_sparse", err))
    for (n_p, m_q, m_sub, k, L, los) in SVRG_CLUSTER_SWEEP:
        if svrg_sparse_route(m_sub, k) != "cluster":
            raise AssertionError(f"m_sub={m_sub}, k={k} is not a cluster case")
        grid = (3, 2) if m_sub < 30000 else (1, 2)
        lo = None if los is None else los[:grid[0]]
        args, lo_t = svrg_cluster_inputs(rng, *grid, n_p, m_q, m_sub, k, L,
                                         dev, lo)
        check_index_range(args[7], n_p)
        check_index_range(args[0], m_q)
        if lo_t is not None:
            check_index_range(lo_t, m_q - m_sub + 1)
        for loss in ("hinge", "squared"):
            kw = dict(lam=0.1, eta=0.03, loss=loss, lo=lo_t)
            checks.append(("svrg_inner_sparse", compare(
                f"svrg_inner_sparse cluster{grid}{(n_p, m_sub, k, L)} lo={lo}",
                [svrg_inner_sparse(*args, **kw)],
                [svrg_inner_sparse_plain(*args, **kw)], SWEEP_TOL)))
    n_p, m_q, m_sub, k, L = SVRG_BLOCK_WIDE
    if svrg_sparse_route(m_sub, k) != "block":
        raise AssertionError(f"m_sub={m_sub} is not a block-route case")
    args, _ = svrg_sparse_inputs(rng, 1, 1, n_p, m_q, m_sub, k, L, dev)
    for loss in ("hinge", "squared"):
        kw = dict(lam=0.1, eta=0.03, loss=loss)
        checks.append(("svrg_inner_sparse", compare(
            f"svrg_inner_sparse block {(n_p, m_sub, k, L)}",
            [svrg_inner_sparse(*args, **kw)],
            [svrg_inner_sparse_plain(*args, **kw)], SWEEP_TOL)))
    del args
    torch.cuda.synchronize()

    # -- the sparse main-path shape: 28 news20 cells, k = 168, 2857 steps,
    # RADiSA windows of 48 400 columns.  Judged like the dense main shape,
    # relative to the largest entry at MAIN_TOL: the kernels sum each row's
    # inner product in another order than the plain version, rounding
    # differences compound along the chain of 2857 dependent steps, and a
    # hinge margin within rounding of the kink takes the other branch.
    sp = news20_problem(dev)
    alpha20, w20 = news20_state(sp)
    sargs = sdca_sparse_main_inputs(sp, alpha20, w20)
    check_index_range(sargs[6], sp.n_p)
    skw = dict(lam=LAM20, n=N20, Q=Q, loss="hinge")
    want = sdca_epoch_sparse_plain(*sargs, **skw)
    main_err["sdca_epoch_sparse"] = main_check(
        "sdca_epoch_sparse main-path shape", sdca_epoch_sparse(*sargs, **skw),
        want)
    del want
    vargs, lo, eta = svrg_sparse_main_inputs(sp, w20)
    check_index_range(vargs[7], sp.n_p)
    vkw = dict(lam=LAM20, eta=eta, loss="hinge", lo=lo)
    main_err["svrg_inner_sparse"] = main_check(
        "svrg_inner_sparse main-path shape",
        svrg_inner_sparse(*vargs, **vkw),
        svrg_inner_sparse_plain(*vargs, **vkw))
    # -- and as the sparse fleet launches them: 2 news20 tenants (B4: 56
    # clusters of 8 CTAs, two waves)
    tenants = sparse_tenants(sp, alpha20, w20, FLEET_T_SPARSE)
    for name in ("sdca_epoch_sparse", "svrg_inner_sparse"):
        results[name]["tenant_main"] = tenant_main_check(name, tenants)
    del tenants
    torch.cuda.synchronize()

    tenant_kernel_checks(rng, dev, checks)
    gated = gated_sweep(rng, dev, checks)
    lm_kernel_checks(rng, dev, checks, main_err)
    train_function_checks(rng, dev, checks)

    summary = []
    for name in KERNEL_META:
        sweep = [e for k, e in checks if k == name]
        by_route = route_counts(name)
        if not all(by_route.values()):
            raise AssertionError(f"{name}: a route was never checked: "
                                 f"{by_route}")
        main = main_err[name]
        if isinstance(main, dict):        # beside its largest entry
            results[name].update({k: main[k] for k in main if k in (
                "max_abs_err", "max_abs_ref", "rel_err", "outputs",
                "max_abs_err_vs_plain_f32", "reference", "draws")})
        else:
            results[name]["max_abs_err"] = main
        results[name].update(tol=TOLS[name][0],
                             sweep_cases=len(sweep),
                             sweep_max_abs_err=max(sweep),
                             sweep_tol=TOLS[name][1],
                             checked_launches_by_route=by_route, ok=True)
        summary.append({"name": name, **{k: results[name].get(k) for k in (
            "max_abs_err", "max_abs_ref", "rel_err", "outputs",
            "max_abs_err_vs_plain_f32", "reference", "draws", "tol",
            "tenant_main", "sweep_cases", "sweep_max_abs_err",
            "sweep_tol", "checked_launches_by_route", "ok")}})
    results["flash_attention"]["shapes"] = main_err["flash_shapes"]
    emit("kernels", checks=summary,
         main_shape={"cells": P * Q, "n_p": data.n_p, "m_q": data.m_q,
                     "steps": data.n_p, "m_sub": data.m_q // P},
         sparse_main_shape={"cells": P * Q, "n_p": sp.n_p, "k": sp.k,
                            "m_q": sp.m_q, "steps": sp.n_p,
                            "m_sub": sp.m_q // P},
         flash_main_shape=dict(zip("B S H KV D".split(), FLASH_MAIN)),
         linattn_main_shape=dict(zip("B S H D".split(), LINATTN_MAIN)),
         gated_sweep={"cases": len(gated),
                      "max_abs_err": max(g["max_abs_err"] for g in gated),
                      "all_off_exact": sum(g["gate"] == "all off"
                                           for g in gated),
                      "by": sorted({(g["kernel"], g["route"], g["cluster"])
                                    for g in gated}, key=str)})
    del data, alpha, w, sargs, vargs, alpha20, w20
    torch.cuda.empty_cache()


def flash_inputs(rng, B, S, H, KV, D, dtype, dev, Skv=None):
    """q (B, S, H, D), k / v (B, Skv, KV, D) (Skv = S by default): normal
    draws, so that the scaled scores have unit variance, rounded to
    ``dtype`` on the card."""
    Skv = S if Skv is None else Skv
    return [torch.from_numpy(rng.normal(size=shape).astype(np.float32))
            .to(dev, dtype)
            for shape in ((B, S, H, D), (B, Skv, KV, D), (B, Skv, KV, D))]


# the tensor-core route's own sweep, bf16: (B, S, Skv, H, KV, D, causal,
# window) -- ragged S (multiples of 16 and odd), Skv != S both ways, GQA
# ratios 1 / 2 / 4, head dims 64 / 128, windows of 1, 48 and 100 keys
FLASH_TC_SWEEP = [
    (1, 80, 80, 4, 4, 128, True, None), (2, 37, 37, 4, 2, 64, True, None),
    (1, 129, 129, 8, 2, 128, True, 48), (2, 208, 208, 4, 1, 64, True, 100),
    (1, 100, 40, 4, 2, 128, True, None), (1, 48, 130, 4, 4, 64, False, None),
    (2, 64, 200, 8, 2, 128, False, 48), (1, 333, 333, 4, 1, 128, True, 1),
    (1, 16, 16, 2, 1, 64, True, None), (1, 1, 70, 4, 2, 128, False, None),
    (3, 190, 190, 4, 2, 64, True, 48), (1, 257, 257, 4, 4, 128, False, 100),
]


# the tensor-core route's own sweep, D 64: (BH, S, heads of u or None,
# constant logw or None for the model's range)
LINATTN_TC_SWEEP = [
    (2, 37, None, None), (3, 5, 3, None), (2, 1, None, None),
    (4, 130, 2, None), (2, 200, None, -50.0), (2, 77, 2, 0.0),
    (5, 16, 5, None), (2, 64, None, -50.0),
]


def linattn_simt(r, k, v, lw, u, chunk=64):
    """The CUDA-core route, forced past the wrapper's route choice."""
    H = 1 if u.dim() == 1 else u.shape[0]
    return linattn_ops._launch(r, k, v, lw, u.reshape(H, -1).contiguous(),
                               H, min(chunk, r.shape[1]), "simt")


def linattn_inputs(rng, BH, S, D, dev, heads=None, logw=None):
    """r, k, v (BH, S, D) normal; logw the model's decay range
    -exp(clip(normal, -20, 4)) floored at -8 (or the given constant);
    u (D,) or (heads, D)."""
    r, k, v = (rng.normal(size=(BH, S, D)).astype(np.float32)
               for _ in range(3))
    if logw is None:
        lw = np.maximum(-np.exp(np.clip(rng.normal(size=(BH, S, D)), -20, 4)),
                        -8.0).astype(np.float32)
    else:
        lw = np.full((BH, S, D), logw, np.float32)
    u = (0.5 * rng.normal(size=(D,) if heads is None else (heads, D))
         ).astype(np.float32)
    return [torch.from_numpy(a).to(dev) for a in (r, k, v, lw, u)]


def plain_by_heads(q, k, v, *, causal=True, window=None, group=2):
    """B5's plain version ``group`` KV heads (and their query heads) at a
    time: the same numbers as one call, a fraction of its float32
    scores."""
    KV, G = k.shape[2], q.shape[2] // k.shape[2]
    return torch.cat([flash_attention_plain(
        q[:, :, i * G:(i + group) * G].contiguous(),
        k[:, :, i:i + group].contiguous(), v[:, :, i:i + group].contiguous(),
        causal=causal, window=window) for i in range(0, KV, group)], dim=2)


def lm_kernel_checks(rng, dev, checks, main_err):
    """B5 and B6 against their plain versions on the card: the unit
    tests' sweeps (tests/test_kernels.py), ragged lengths, head dim 128,
    the extreme decay, and the main-path shapes."""
    # the unit tests' sweep: float32 and D 16 / 32 on the CUDA-core route,
    # bfloat16 at D 64 / 128 on the tensor-core route
    for (B, S, H, KV, D) in [(2, 128, 4, 2, 32), (1, 256, 2, 2, 64),
                             (2, 64, 8, 1, 16), (1, 80, 4, 2, 128),
                             (2, 200, 4, 1, 64), (1, 80, 2, 2, 16)]:
        for window in (None, 48):
            for dtype, tol in FLASH_TOL.items():
                q, k, v = flash_inputs(rng, B, S, H, KV, D, dtype, dev)
                kw = dict(causal=True, window=window)
                checks.append(("flash_attention", compare(
                    f"flash_attention{(B, S, H, KV, D)} w={window} {dtype} "
                    f"{flash_route(dtype, D)}",
                    [flash_attention(q, k, v, **kw).float()],
                    [flash_attention_plain(q, k, v, **kw).float()], tol)))
    for (B, S, Skv, H, KV, D, causal, window) in FLASH_TC_SWEEP:
        q, k, v = flash_inputs(rng, B, S, H, KV, D, torch.bfloat16, dev,
                               Skv=Skv)
        kw = dict(causal=causal, window=window)
        checks.append(("flash_attention", compare(
            f"flash_attention tc {(B, S, Skv, H, KV, D)} causal={causal} "
            f"w={window}", [flash_attention(q, k, v, **kw).float()],
            [flash_attention_plain(q, k, v, **kw).float()],
            FLASH_TOL[torch.bfloat16])))
    q, k, v = flash_inputs(rng, 1, 40, 4, 2, 32, torch.float32, dev)
    checks.append(("flash_attention", compare(
        "flash_attention non-causal",
        [flash_attention(q, k, v, causal=False)],
        [flash_attention_plain(q, k, v, causal=False)],
        FLASH_TOL[torch.float32])))
    # query rows with no unmasked key (window 5, S 200 > Skv + 4): both
    # routes and the plain version give them 0; whole outputs compared
    S, Skv, window = 200, 10, 5
    for dtype, D, causal in ((torch.bfloat16, 128, False),
                             (torch.bfloat16, 64, True),
                             (torch.float32, 64, False),
                             (torch.bfloat16, 32, True)):
        q, k, v = flash_inputs(rng, 1, S, 4, 2, D, dtype, dev, Skv=Skv)
        kw = dict(causal=causal, window=window)
        checks.append(("flash_attention", compare(
            f"flash_attention {flash_route(dtype, D)} rows without a key "
            f"{(S, Skv, D)} {dtype} causal={causal} w={window}",
            [flash_attention(q, k, v, **kw).float()],
            [flash_attention_plain(q, k, v, **kw).float()],
            FLASH_TOL[dtype])))
    torch.cuda.synchronize()
    q, k, v = flash_inputs(rng, *FLASH_MAIN, torch.bfloat16, dev)
    main_err["flash_attention"] = compare(
        f"flash_attention main-path shape {FLASH_MAIN}",
        [flash_attention(q, k, v).float()],
        [flash_attention_plain(q, k, v).float()], FLASH_TOL[torch.bfloat16])
    del q, k, v
    # the other families' main-path shapes: bf16 on the tensor-core route
    # (the main path's) and float32 on the CUDA-core route at head dim 256;
    # the plain version a KV head group at a time (the same function: heads
    # are independent), so its float32 scores fit beside the inputs.  Two
    # draws each, unit q (flat rows) and q at FLASH_PEAKED_Q (peaked rows),
    # held elementwise to FLASH_TOL and row by row to FLASH_TOL of the
    # row's largest entry (``row_check``)
    shapes = {}
    for label, (B, S, Skv, H, KV, D, causal, window) in \
            FLASH_FAMILY_SHAPES.items():
        shapes[label] = {"shape": dict(zip(
            "B S Skv H KV D causal window".split(),
            (B, S, Skv, H, KV, D, causal, window)))}
        for dtype in ((torch.bfloat16, torch.float32) if D == 256
                      else (torch.bfloat16,)):
            route = flash_route(dtype, D)
            for draw, q_scale in (("unit", 1.0), ("peaked", FLASH_PEAKED_Q)):
                q, k, v = flash_inputs(rng, B, S, H, KV, D, torch.float32,
                                       dev, Skv=Skv)
                q, k, v = (q * q_scale).to(dtype), k.to(dtype), v.to(dtype)
                kw = dict(causal=causal, window=window)
                name = f"flash_attention {label} {dtype} {route} {draw} q"
                got = flash_attention(q, k, v, **kw)
                want = plain_by_heads(q, k, v, **kw)
                err = compare(name, [got.float()], [want.float()],
                              FLASH_TOL[dtype])
                _, ratio = row_check(got, want, FLASH_TOL[dtype])
                ratio = float(ratio)
                if ratio > 1.0:
                    raise AssertionError(
                        f"{name}: a row's error is {ratio:.3f} of "
                        f"{FLASH_TOL[dtype]} x its largest entry")
                checks.append(("flash_attention", err))
                shapes[label][f"{route}_{draw}"] = {
                    "max_abs_err": err, "row_ratio": ratio,
                    "max_abs_ref": float(want.float().abs().max())}
                del q, k, v, got, want
                torch.cuda.empty_cache()
            shapes[label][f"{route}_tol"] = FLASH_TOL[dtype]
            shapes[label][f"{route}_max_abs_err"] = max(
                shapes[label][f"{route}_{d}"]["max_abs_err"]
                for d in ("unit", "peaked"))
    main_err["flash_shapes"] = shapes

    # the unit tests' sweep (the two D 64 / chunk 64 cases now on the
    # tensor-core route, and on the CUDA-core route they took before)
    for (BH, S, D, chunk) in [(2, 64, 16, 16), (3, 128, 32, 32),
                              (1, 256, 64, 64), (2, 96, 16, 32),
                              (2, 100, 64, 64), (3, 37, 32, 16)]:
        r, k, v, lw, u = linattn_inputs(rng, BH, S, D, dev)
        want = rwkv_linattn_ref(r, k, v, lw, u)
        checks.append(("rwkv_linattn", compare(
            f"rwkv_linattn{(BH, S, D, chunk)} {linattn_route(D, chunk)}",
            rwkv_linattn(r, k, v, lw, u, chunk=chunk), want, LINATTN_TOL)))
        if linattn_route(D, chunk) == "tc":
            checks.append(("rwkv_linattn", compare(
                f"rwkv_linattn{(BH, S, D, chunk)} simt",
                linattn_simt(r, k, v, lw, u, chunk), want, LINATTN_TOL)))
    r, k, v, lw, u = linattn_inputs(rng, 1, 64, 16, dev, logw=-50.0)
    checks.append(("rwkv_linattn", compare(           # raises if not finite
        "rwkv_linattn logw=-50", rwkv_linattn(r, k, v, lw, u, chunk=16),
        rwkv_linattn_ref(r, k, v, lw, u), LINATTN_TOL)))
    r, k, v, lw, u = linattn_inputs(rng, 6, 70, 64, dev, heads=3)
    checks.append(("rwkv_linattn", compare(
        "rwkv_linattn per-head u", rwkv_linattn(r, k, v, lw, u),
        rwkv_linattn_ref(r, k, v, lw, u), LINATTN_TOL)))
    # the tensor-core route's own sweep: S not a multiple of 16 or 64, S
    # below 16 (one zero-padded chunk), per-head u, the extreme decay, no
    # decay at all
    for (BH, S, heads, logw) in LINATTN_TC_SWEEP:
        if linattn_route(64, 64) != "tc":
            raise AssertionError("D 64 / chunk 64 is not the tc route")
        r, k, v, lw, u = linattn_inputs(rng, BH, S, 64, dev, heads=heads,
                                        logw=logw)
        checks.append(("rwkv_linattn", compare(       # raises if not finite
            f"rwkv_linattn tc {(BH, S, 64)} heads={heads} logw={logw}",
            rwkv_linattn(r, k, v, lw, u), rwkv_linattn_ref(r, k, v, lw, u),
            LINATTN_TOL)))
    torch.cuda.synchronize()
    main_err["rwkv_linattn"] = linattn_main_check(rng, dev)
    torch.cuda.synchronize()


def train_function_checks(rng, dev, checks):
    """B5 and B6 as training calls them, at the training main-path shapes:
    the autograd Function's forward (the kernel, on its main route)
    against the plain version, and its gradients against the plain
    version's own autograd gradients for the same output gradient --
    bitwise, since the Function's backward is autograd through that very
    plain version, recomputed from the saved inputs."""
    for kernel, plain, arch in (
            ("flash_attention", plain_flash, "qwen3-1.7b"),
            ("rwkv_linattn", plain_linattn, "rwkv6-3b")):
        fn = WRAPPERS[kernel]
        ins = train_function_inputs(rng, get_config(arch), kernel, dev)
        by_route = dict(fn.launches_by_route)
        out = fn(*ins)
        out = out if torch.is_tensor(out) else out[0]
        if fn.launches_by_route[MAIN_ROUTES[kernel]] != \
                by_route[MAIN_ROUTES[kernel]] + 1:
            raise AssertionError(f"{kernel}: the training call left the "
                                 f"{MAIN_ROUTES[kernel]!r} route")
        want = plain(*ins)
        want = want if torch.is_tensor(want) else want[0]
        if out.grad_fn is None or "Backward" not in type(out.grad_fn).__name__:
            raise AssertionError(f"{kernel}: no autograd Function in the "
                                 f"graph ({out.grad_fn})")
        tol = (FLASH_TOL[torch.bfloat16] if kernel == "flash_attention"
               else LINATTN_TOL)
        err = compare(f"{kernel} training forward {tuple(out.shape)}",
                      [out.detach().float()], [want.detach().float()], tol)
        dout = torch.randn_like(out)
        before = fn.plain_backwards
        got = torch.autograd.grad(out, ins, dout)
        ref = torch.autograd.grad(want, ins, dout)
        if fn.plain_backwards != before + 1:
            raise AssertionError(f"{kernel}: backward not counted")
        for i, (g, r) in enumerate(zip(got, ref)):
            if not torch.equal(g, r):
                raise AssertionError(
                    f"{kernel}: gradient {i} of the Function differs from "
                    f"the plain version's by "
                    f"{float((g.float() - r.float()).abs().max()):.3e}")
        checks.append((kernel, err))
        emit("train_function", kernel=kernel, shape=list(out.shape),
             forward_max_abs_err=err, tol=tol, grads_bitwise=True)


def linattn_main_check(rng, dev):
    """B6 at the main-path shape, at LINATTN_DRAWS input draws: the kernel
    and the plain recurrence in float32 each against the plain recurrence
    in float64, per output (out, state): max abs error, largest entry, and
    the worst element's share of the elementwise bound LINATTN_TOL (1 +
    |ref|) (``ratio``).  Every draw is read and printed before any is
    judged; the kernel must be within the bound of the float64 recurrence
    everywhere."""
    B, S, H, D = LINATTN_MAIN

    def reading(a, ref):
        err = (a.double() - ref).abs()
        return {"max_abs_err": float(err.max()),
                "max_abs_ref": float(ref.abs().max()),
                "ratio": float((err / (LINATTN_TOL
                                       * (1 + ref.abs()))).max())}
    draws = []
    for _ in range(LINATTN_DRAWS):
        r, k, v, lw, u = linattn_inputs(rng, B * H, S, D, dev, heads=H)
        got = rwkv_linattn(r, k, v, lw, u)
        if not all(torch.isfinite(g).all() for g in got):
            raise AssertionError("rwkv_linattn: kernel output is not finite")
        f32 = rwkv_linattn_ref(r, k, v, lw, u)
        f64 = rwkv_linattn_ref(r, k, v, lw, u, dtype=torch.float64)
        draws.append({name: {"kernel": reading(g, e), "plain_f32":
                             reading(p, e), "kernel_vs_plain_f32":
                             reading(g, p.double())}
                      for name, g, p, e in zip(("out", "state"), got, f32,
                                               f64)})
        del got, f32, f64
    emit("linattn_draws", shape=dict(zip("B S H D".split(), LINATTN_MAIN)),
         tol=LINATTN_TOL, draws=draws)
    worst = max(d[o]["kernel"]["ratio"] for d in draws for o in d)
    if worst > 1.0:
        raise AssertionError(
            f"rwkv_linattn main-path shape {LINATTN_MAIN}: kernel and the "
            f"float64 recurrence disagree ({worst:.3f} of the bound)")
    return {"max_abs_err": max(d[o]["kernel"]["max_abs_err"]
                               for d in draws for o in d),
            "max_abs_err_vs_plain_f32": max(
                d[o]["kernel_vs_plain_f32"]["max_abs_err"]
                for d in draws for o in d),
            "reference": "float64 recurrence", "draws": len(draws)}


#: the process grids a main path drives: their workers' launches
#: (``ProcessGrid.worker_launches``) count with this process's own
MESH_GRIDS = []


def launch_counts():
    return {name: fn.launches + sum(
        g.worker_launches.get(name, {}).get("launches", 0)
        for g in MESH_GRIDS) for name, fn in WRAPPERS.items()}


def counts_by(name, counter):
    """Launches of one wrapper per route (``launches_by_route``) or
    cluster size (``launches_by_cluster``), this process's and the
    MESH_GRIDS workers'."""
    out = dict(getattr(WRAPPERS[name], counter))
    for g in MESH_GRIDS:
        for r, n in g.worker_launches.get(name, {}).get(counter, {}).items():
            out[r] = out.get(r, 0) + n
    return out


def route_counts(name):
    """Launches of one wrapper per route."""
    return counts_by(name, "launches_by_route")


def reset_counts():
    for fn in WRAPPERS.values():
        fn.launches = 0
        if hasattr(fn, "plain_backwards"):
            fn.plain_backwards = 0
        for by in ("launches_by_route", "launches_by_cluster",
                   "launches_by_head_dim"):
            for r in getattr(fn, by, {}):
                getattr(fn, by)[r] = 0
    for g in MESH_GRIDS:
        g.worker_launches = {}


def run_solver_full(solver: str, expect_dual: bool, sparse: bool = False,
                    ref_epochs: int = REF_EPOCHS):
    """One full-width solve through the CLI's ``main``; returns its
    summary, history, what it wrote to stderr and its wall time."""
    if sparse:
        flags = ["--dataset", "sparse", "--block-format", "sparse",
                 "--n", str(N20), "--m", str(M20), "--density", str(DENS20),
                 "--lam", str(LAM20)]
    else:
        flags = ["--n", str(N), "--m", str(M), "--lam", str(LAM),
                 "--ref-epochs", str(ref_epochs)]
    err = io.StringIO()
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, f"{solver}.json")
        t0 = time.perf_counter()
        with contextlib.redirect_stderr(err):
            summary = optimize.main([
                "--solver", solver, "--mesh", f"{P}x{Q}", *flags,
                "--iters", str(OUTER_ITERS), "--json-out", out])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        with open(out) as fh:
            history = json.load(fh)["history"]
    sys.stderr.write(err.getvalue())
    if summary["device"] != "cuda" or summary["local_backend"] != "kernel":
        raise AssertionError(f"{solver}: not on the card / kernel backend: "
                             f"{summary}")
    if summary["block_format"] != ("sparse" if sparse else "dense"):
        raise AssertionError(f"{solver}: block format {summary}")
    if summary["iters"] != OUTER_ITERS or len(history) != OUTER_ITERS:
        raise AssertionError(f"{solver}: ran {summary['iters']} iterations")
    vals = [h["objective"] for h in history]
    if expect_dual:
        vals += [h["duality_gap"] for h in history]
    if not all(np.isfinite(v) for v in vals):
        raise AssertionError(f"{solver}: non-finite history {history}")
    return summary, history, err.getvalue(), wall


def check_descent(solver, history, dual):
    if not history[-1]["objective"] < history[0]["objective"]:
        raise AssertionError(f"{solver}: objective did not decrease: "
                             f"{[h['objective'] for h in history]}")
    if dual:
        g0, g1 = history[0]["duality_gap"], history[-1]["duality_gap"]
        if not (g1 > 0 and g1 < g0):
            raise AssertionError(f"{solver}: duality gap {g0} -> {g1}")


def phase_d3ca_full():
    summary, history, _, wall = run_solver_full("d3ca", expect_dual=True)
    check_descent("d3ca", history, dual=True)
    emit("d3ca_full", objective_first=history[0]["objective"],
         objective_last=history[-1]["objective"],
         gap_first=history[0]["duality_gap"],
         gap_last=history[-1]["duality_gap"],
         rel_opt_last=history[-1]["rel_opt"], solve_s=summary["total_s"],
         wall_s=wall, peak_mem_bytes=torch.cuda.max_memory_allocated())
    return {"sdca_epoch": OUTER_ITERS + REF_EPOCHS}


def phase_radisa_full():
    summary, history, _, wall = run_solver_full("radisa", expect_dual=False)
    check_descent("radisa", history, dual=False)
    emit("radisa_full", objective_first=history[0]["objective"],
         objective_last=history[-1]["objective"],
         rel_opt_last=history[-1]["rel_opt"], solve_s=summary["total_s"],
         wall_s=wall, peak_mem_bytes=torch.cuda.max_memory_allocated())
    return {"sdca_epoch": REF_EPOCHS, "svrg_inner": OUTER_ITERS}


def sparse_full(name, solver, kernel, dual):
    """The news20 profile at full width through ``optimize.main``: CSR in,
    padded-ELL cells on the card, no f* (densifying it would take
    108 GB), peak device memory under ``SPARSE_PEAK_LIMIT``."""
    summary, history, err, wall = run_solver_full(solver, expect_dual=dual,
                                                  sparse=True)
    if "skipping f* reference" not in err or summary["rel_opt"] is not None:
        raise AssertionError(f"{solver}: f* was not skipped: {err!r}")
    if dual:
        check_descent(solver, history, dual=True)
    peak = torch.cuda.max_memory_allocated()
    if peak >= SPARSE_PEAK_LIMIT:
        raise AssertionError(f"{solver}: peak device memory {peak} B; the "
                             "sparse path densified something")
    fields = dict(objective_first=history[0]["objective"],
                  objective_last=history[-1]["objective"])
    if dual:
        fields.update(gap_first=history[0]["duality_gap"],
                      gap_last=history[-1]["duality_gap"])
    emit(name, **fields, n=summary["n"], m=summary["m"],
         block_format=summary["block_format"], solve_s=summary["total_s"],
         wall_s=wall, peak_mem_bytes=peak)
    return {kernel: OUTER_ITERS}


def phase_admm_full():
    """The paper's ADMM baseline (rho = lambda) at full width on the dense
    instance through the CLI's ``main``: no kernel (its inner solve is the
    cached Cholesky factor of each column block), no f* (the serial-SDCA
    reference would launch the SDCA kernel)."""
    summary, history, _, wall = run_solver_full("admm", expect_dual=False,
                                                ref_epochs=0)
    check_descent("admm", history, dual=False)
    emit("admm_full", objective_first=history[0]["objective"],
         objective_last=history[-1]["objective"], solve_s=summary["total_s"],
         wall_s=wall, peak_mem_bytes=torch.cuda.max_memory_allocated())
    return {}


def fleet_argv(solver, sparse, iters=OUTER_ITERS):
    """The fleet CLI's flags at a fleet phase's configuration (``iters``
    outer iterations)."""
    if sparse:
        size = ["--block-format", "sparse", "--tenants", str(FLEET_T_SPARSE),
                "--n", str(N20), "--m", str(M20), "--density", str(DENS20),
                "--lam", str(LAM20)]
    else:
        size = ["--tenants", str(FLEET_T_DENSE), "--n", str(N), "--m",
                str(M), "--lam", str(LAM)]
    return ["--solver", solver, "--mesh", f"{P}x{Q}", *size, "--iters",
            str(iters), "--check-every", "1", "--seed", "0"]


def fleet_config(solver, lam, iters=OUTER_ITERS):
    cls = get_solver(solver).config_cls
    kw = {"lam": lam, "outer_iters": iters}
    if solver == "admm":
        kw["rho"] = lam
    return cls(**kw)


#: the solvers of each fleet phase
FLEET_SOLVERS = {False: ("d3ca", "radisa", "admm"), True: ("d3ca", "radisa")}


@functools.lru_cache(maxsize=1)
def fleet_tenants(sparse):
    """The fleet CLI's tenants at a fleet phase's configuration (made as
    its ``run`` makes them)."""
    return fleet_cli.make_tenants(
        fleet_cli.parse_args(fleet_argv("d3ca", sparse)))


def fleet_solos(sparse):
    """Every tenant's solo solve on the card for each solver of a fleet
    phase, the result its fleet tenant is held against: {solver:
    {tenant: (w, alpha)}}.  Made before the phase's launch counts go to
    0, so that only the fleets' own launches are counted."""
    bf = "sparse" if sparse else "dense"
    out = {}
    for solver in FLEET_SOLVERS[sparse]:
        cfg = fleet_config(solver, LAM20 if sparse else LAM)
        out[solver] = {}
        for p in fleet_tenants(sparse):
            res = get_solver(solver)(block_format=bf).solve(
                p.loss_name, p.X, p.y, P=P, Q=Q, cfg=solo_config(cfg, p),
                record_history=False)
            out[solver][p.tenant_id] = (res.w, res.alpha)
            del res
    gc.collect()
    torch.cuda.empty_cache()
    return out


def run_fleet_full(solver, sparse, solos):
    """One fleet at full width through the fleet CLI (its ``main``'s
    ``parse_args`` and ``run``, the latter told to hand back each
    tenant's result): its launches (in all, per route, per cluster size),
    peak device memory and wall time; every tenant's objective must fall
    and be finite, and its final w (and alpha) must lie within
    ``FLEET_TOL`` of its solo solve of the same seed on the card
    (``solos``), relative to the largest entry."""
    def snap():
        return (launch_counts(), {k: route_counts(k) for k in WRAPPERS},
                dict(sdca_epoch.launches_by_cluster))
    got = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    c0, r0, g0 = snap()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        summary = fleet_cli.run(
            fleet_cli.parse_args(fleet_argv(solver, sparse)),
            on_result=lambda p, r: got.append((p, r)))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    c1, r1, g1 = snap()
    T = FLEET_T_SPARSE if sparse else FLEET_T_DENSE
    if summary["device"] != "cuda" or summary["local_backend"] != "kernel" \
            or len(got) != T or summary["buckets"] != 1:
        raise AssertionError(f"fleet {solver}: {summary}")
    tenants, worst, exact = [], 0.0, True
    for p, res in got:
        hist = [h["objective"] for h in res.history]
        if len(hist) != OUTER_ITERS or not all(np.isfinite(hist)) \
                or not hist[-1] < hist[0]:
            raise AssertionError(f"fleet {solver} {p.tenant_id}: "
                                 f"objective {hist}")
        errs = {}
        for f, b in zip(("w", "alpha"), solos[solver][p.tenant_id]):
            if b is None:
                continue
            a = getattr(res, f)
            errs[f] = float((a - b).abs().max()) / max(
                float(b.abs().max()), 1e-30)
            exact = exact and bool(torch.equal(a, b))
        worst = max(worst, *errs.values())
        tenants.append({"tenant": p.tenant_id, "lam": p.lam,
                        "seed": p.seed, "objective_first": hist[0],
                        "objective_last": hist[-1],
                        "rel_err_vs_solo": errs})
    if worst > FLEET_TOL:
        raise AssertionError(f"fleet {solver}: a tenant lies {worst:.3e} "
                             f"(relative) from its solo solve: {tenants}")
    del got
    gc.collect()
    torch.cuda.empty_cache()
    return {"tenants": tenants, "max_rel_err_vs_solo": worst,
            "bitwise_equal_to_solo": exact, "wall_s": wall,
            "solves_per_s": summary["solves_per_s"], "peak_mem_bytes": peak,
            "launches": {k: c1[k] - c0[k] for k in WRAPPERS},
            "routes": {k: {r: r1[k][r] - r0[k][r] for r in r1[k]}
                       for k in WRAPPERS},
            "sdca_clusters": {g: g1[g] - g0[g] for g in g1}}


def check_fleet_launches(name, res, want, route=None, cluster=None):
    """Exact launches of one fleet: ``want`` {kernel: n}, all of them on
    ``route`` (a two-route wrapper) and, for B1, at cluster size
    ``cluster``."""
    full = {k: want.get(k, 0) for k in WRAPPERS}
    if res["launches"] != full:
        raise AssertionError(f"{name}: launches {res['launches']}; "
                             f"expected {full}")
    for k, n in want.items():
        if route is not None and res["routes"][k][route] != n:
            raise AssertionError(f"{name}: {k} by route {res['routes'][k]}")
    if cluster is not None and res["sdca_clusters"] != {
            g: (OUTER_ITERS if g == cluster else 0)
            for g in sdca_ops.CLUSTER_SIZES}:
        raise AssertionError(f"{name}: B1 by cluster size "
                             f"{res['sdca_clusters']}")


def phase_fleet_dense_full(solos):
    """Four tenants of the dense Part 1 instance (seeds 0-3, lambda = 1e-2
    * 0.5 ** (t mod 3)) through the fleet CLI, with D3CA, RADiSA and ADMM
    (rho = lambda): 10 B1 launches on the cluster route at one CTA a cell
    for all 4 x 28 D3CA cells, 10 B2 launches on the ring route for
    RADiSA, none for ADMM;
    ``solos``: :func:`fleet_solos`."""
    out = {}
    for solver, want, route, cluster in (
            ("d3ca", {"sdca_epoch": OUTER_ITERS}, "cluster", 1),
            ("radisa", {"svrg_inner": OUTER_ITERS}, "ring", None),
            ("admm", {}, None, None)):
        res = run_fleet_full(solver, False, solos)
        check_fleet_launches(f"fleet_dense_full {solver}", res, want,
                             route, cluster)
        out[solver] = res
    emit("fleet_dense_full", tenants=FLEET_T_DENSE, **out)
    return {"sdca_epoch": OUTER_ITERS, "svrg_inner": OUTER_ITERS}


def phase_fleet_sparse_full(solos):
    """Two tenants of the news20 profile (seeds 0-1, lambda = 1e-4 * 0.5 **
    t) through the fleet CLI, with D3CA (10 B3 launches, all on the
    lookahead route) and RADiSA (10 B4 launches, all on the cluster
    route); peak device memory under T times
    the solo sparse limit; ``solos``: :func:`fleet_solos`."""
    out = {}
    for solver, want, route in (
            ("d3ca", {"sdca_epoch_sparse": OUTER_ITERS}, "lookahead"),
            ("radisa", {"svrg_inner_sparse": OUTER_ITERS}, "cluster")):
        res = run_fleet_full(solver, True, solos)
        check_fleet_launches(f"fleet_sparse_full {solver}", res, want,
                             route)
        if res["peak_mem_bytes"] >= FLEET_T_SPARSE * SPARSE_PEAK_LIMIT:
            raise AssertionError(f"fleet_sparse_full {solver}: peak device "
                                 f"memory {res['peak_mem_bytes']} B")
        out[solver] = res
    emit("fleet_sparse_full", tenants=FLEET_T_SPARSE, **out)
    return {"sdca_epoch_sparse": OUTER_ITERS,
            "svrg_inner_sparse": OUTER_ITERS}


@contextlib.contextmanager
def tap(name, on_launch, module="repro_torch.kernels.sdca"):
    """Pass every call of the kernel wrapper ``name`` that its callers
    take from ``module`` (``core/local.py`` takes the solver kernels from
    ``repro_torch.kernels.sdca`` / ``.svrg`` at each call, the model
    takes flash attention from ``repro_torch.models.attention``) on to
    the real wrapper, then hand ``on_launch(args, kwargs, outputs)`` what
    it got and gave.  The wrapper's counters are untouched; restored on
    exit."""
    pkg = importlib.import_module(module)
    real = getattr(pkg, name)

    def wrapper(*args, **kw):
        out = real(*args, **kw)
        on_launch(args, kw, out)
        return out
    setattr(pkg, name, wrapper)
    try:
        yield
    finally:
        setattr(pkg, name, real)


def run_online(argv, on_start=None, on_round=None):
    """The online CLI's ``main`` (its ``parse_args`` and ``run``, the
    latter with its hooks) on the card; returns its summary."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        summary = online_cli.run(online_cli.parse_args(argv),
                                 on_start=on_start, on_round=on_round)
    if summary["device"] != "cuda" or summary["backend"] != "kernel":
        raise AssertionError(f"online: not on the card / kernels: {summary}")
    return summary


def gated_rows(mask):
    return int((mask != 0).sum())


def phase_online_full():
    """The online service at the Part 1 width through the online CLI: a
    window of N x M on the card, 7 x 4 cells of 2000 x 3003, batches of
    ONLINE_BATCH rows (the ring wraps at round N / ONLINE_BATCH, so the
    overwritten rows are gated on with a stale warm-start alpha), two
    gated D3CA passes an update, each update on the solver's timed path
    (the service's registry goes to ``Solver.update``, which calibrates
    the update's program first: OBS_CALIB more launches).  Checks:
    ONLINE_ROUNDS * (ONLINE_PASSES + OBS_CALIB) B1 launches, all cluster
    at G = 1, each gating on exactly the batch's rows; the passes of the
    rounds ONLINE_CHECKED against the plain version (MAIN_TOL relative to
    the largest entry); alpha outside each update's
    touched rows equal to its warm start; objective over the filled rows
    below round 1's, accuracy over ONLINE_MIN_ACC; a second run on the
    same checkpoint directory recovers the last version with w bitwise;
    outside the CLI, the all-ones gate is bitwise the ungated solve."""
    taken, rounds, events, checked = [], [], [], []
    state = {"round": 0}

    def check_taken():
        # (b) each pass of a checked round against its plain version,
        # after the round's update was timed (the calibration's launches
        # come first: the passes are the last ONLINE_PASSES)
        for r, args, kw, out in taken[-ONLINE_PASSES:]:
            checked.append({"round": r, **main_check(
                f"online_full round {r} sdca_epoch", out,
                sdca_epoch_plain(*args, **kw))})
        taken.clear()

    def on_launch(args, kw, out):
        if gated_rows(args[2]) != ONLINE_BATCH:
            raise AssertionError(f"online_full: a launch gated "
                                 f"{gated_rows(args[2])} rows on")
        if state["round"] in ONLINE_CHECKED:
            taken.append((state["round"], args, kw, out))

    def on_start(svc):
        state["svc"] = svc
        state["alpha"] = svc.book.current().alpha
        real = svc.solver.update

        def timed(*args, **kw):
            s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            s.record()
            res = real(*args, **kw)
            e.record()
            events.append((s, e))
            return res
        svc.solver.update = timed

    def on_round(r, svc, rec):
        # (c) the duals outside the batch's rows equal their warm start
        cur = svc.book.current()
        rows = torch.from_numpy((r * ONLINE_BATCH + np.arange(ONLINE_BATCH))
                                % N).to(svc.device)
        off = torch.ones(N, dtype=torch.bool, device=svc.device)
        off[rows] = False
        if cur.version != r + 1 or not torch.equal(cur.alpha[off],
                                                   state["alpha"][off]):
            raise AssertionError(f"online_full round {r}: version "
                                 f"{cur.version}, or a dual outside the "
                                 "batch's rows moved")
        rounds.append({**rec, "rows_moved": int(
            (cur.alpha[rows] != state["alpha"][rows]).sum())})
        state["alpha"] = cur.alpha
        state["round"] = r + 1
        if r != ONLINE_ROUNDS - 1:   # the last round's after the summary
            check_taken()

    c0, g0 = launch_counts(), dict(sdca_epoch.launches_by_cluster)
    with tempfile.TemporaryDirectory() as ck:
        t0 = time.perf_counter()
        with tap("sdca_epoch", on_launch):
            summary = run_online([*ONLINE_ARGV, "--rounds",
                                  str(ONLINE_ROUNDS), "--ckpt-dir", ck],
                                 on_start, on_round)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        check_taken()
        want = ONLINE_ROUNDS * (ONLINE_PASSES + OBS_CALIB)
        launched = launch_counts()["sdca_epoch"] - c0["sdca_epoch"]
        at_g1 = sdca_epoch.launches_by_cluster[1] - g0[1]
        if launched != want or at_g1 != want:
            raise AssertionError(f"online_full: {launched} B1 launches, "
                                 f"{at_g1} at G = 1; expected {want}")
        if sorted({c["round"] for c in checked}) != sorted(ONLINE_CHECKED) \
                or len(checked) != ONLINE_PASSES * len(ONLINE_CHECKED):
            raise AssertionError(f"online_full: checked {len(checked)} "
                                 "launches")
        svc = state.pop("svc")
        last = svc.book.current()
        update_ms = [s.elapsed_time(e) for s, e in events]
        hist = {k.split("{")[0]: v for k, v in
                svc.registry.snapshot()["histograms"].items()}
        # (d) the model learned
        f0, f1 = rounds[0]["f"], rounds[-1]["f"]
        acc0, acc1 = rounds[0]["acc"], rounds[-1]["acc"]
        if not (np.isfinite(f1) and f1 < f0 and acc1 > ONLINE_MIN_ACC):
            raise AssertionError(f"online_full: objective {f0} -> {f1}, "
                                 f"accuracy {acc0} -> {acc1}")
        # (e) a restart recovers the last version, w bitwise
        got = []
        again = run_online([*ONLINE_ARGV, "--rounds", "2", "--ckpt-dir", ck],
                           on_start=lambda s: got.append(s.book.current()))
        rec = got[0]
        if rec.version != ONLINE_ROUNDS or rec.trained_seq != \
                last.trained_seq or not torch.equal(
                    rec.w.view(torch.int32), last.w.view(torch.int32)) \
                or again["version"] != ONLINE_ROUNDS + 2:
            raise AssertionError(f"online_full: recovered version "
                                 f"{rec.version}, then {again['version']}")
        # checkpoint write: one snapshot tree, synchronously, host clock
        mgr = CheckpointManager(os.path.join(ck, "timing"), keep_n=1)
        tree = {"w": last.w, "alpha": last.alpha,
                "trained_seq": np.asarray(last.trained_seq, np.int64)}
        ck_ms = []
        for i in range(3):
            t1 = time.perf_counter()
            mgr.save(i + 1, tree)
            ck_ms.append(1e3 * (time.perf_counter() - t1))
    # the all-ones gate against no gate, outside the CLI, on the window
    cfg = D3CAConfig(lam=LAM, outer_iters=2)
    solver = get_solver("d3ca")()
    X, y = svc.store.X, svc.store.y
    plain = solver.solve("hinge", X, y, P=P, Q=Q, cfg=cfg,
                         record_history=False)
    ones = solver.solve("hinge", X, y, P=P, Q=Q, cfg=cfg,
                        record_history=False,
                        row_gate=torch.ones(N, device=X.device))
    if not (torch.equal(plain.w.view(torch.int32), ones.w.view(torch.int32))
            and torch.equal(plain.alpha.view(torch.int32),
                            ones.alpha.view(torch.int32))):
        raise AssertionError("online_full: the all-ones gate is not bitwise "
                             "the ungated solve")
    emit("online_full", rounds=ONLINE_ROUNDS, batch=ONLINE_BATCH,
         passes=ONLINE_PASSES, capacity=summary["store_capacity"],
         launches=launched, launches_at_g1=at_g1,
         checked_launches=checked,
         worst_rel_err=max(c["rel_err"] for c in checked),
         objective_first=f0, objective_last=f1, acc_first=acc0,
         acc_last=acc1, rows_moved=[r["rows_moved"] for r in rounds],
         recovered_version=rec.version, ones_gate_bitwise=True,
         wall_s=wall)
    emit("online_full_times",
         update_ms_by_cuda_events={"p50": statistics.median(update_ms),
                                   "max": max(update_ms),
                                   "first": update_ms[0],
                                   "all": update_ms},
         update_s_host=hist["online/update_s"],
         swap_s_host=hist["online/swap_s"],
         score_rows_per_s=summary["score_rows_per_sec"],
         ckpt_write_ms={"median": statistics.median(ck_ms), "all": ck_ms},
         staleness_s_end=summary["staleness_s"],
         version_lag_end=summary["version_lag"], peak_mem_bytes=peak)
    del svc, X, y, plain, ones, last, rec, got
    gc.collect()
    torch.cuda.empty_cache()
    return {"sdca_epoch": want + 2 * (ONLINE_PASSES + OBS_CALIB)
            + 2 * cfg.outer_iters}


def phase_online_sparse_full():
    """The news20 profile through ``Solver("d3ca",
    block_format="sparse")`` on the CSR matrix: a cold 2-iteration solve,
    then ``update`` of ONLINE_SPARSE_ROWS consecutive rows from the middle
    of row partition 3, 2 passes.  Checks: 4 B3 launches (all lookahead,
    by the main path's route check), each against its plain version
    (MAIN_TOL relative to the largest entry), the update's gating on
    exactly the touched rows; alpha outside them equal to the cold
    solve's; peak device memory under SPARSE_PEAK_LIMIT."""
    csr, y = make_sparse_svm_csr(N20, M20, density=DENS20, seed=0)
    n_p = -(-N20 // P)
    start = 3 * n_p + n_p // 2
    touched = np.arange(start, start + ONLINE_SPARSE_ROWS)
    solver = get_solver("d3ca")(block_format="sparse")
    cfg = D3CAConfig(lam=LAM20, outer_iters=2)
    taken = []
    with tap("sdca_epoch_sparse", lambda a, kw, out: taken.append(
            (a, kw, out))):
        cold = solver.solve("hinge", csr, y, P=P, Q=Q, cfg=cfg,
                            record_history=False)
        torch.cuda.synchronize()
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0 = time.perf_counter()
        s.record()
        res = solver.update("hinge", csr, y, touched=touched,
                            warm_start=cold, P=P, Q=Q, cfg=cfg, passes=2,
                            record_history=False)
        e.record()
        torch.cuda.synchronize()
        host_ms = 1e3 * (time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    if peak >= SPARSE_PEAK_LIMIT:
        raise AssertionError(f"online_sparse_full: peak device memory {peak}"
                             " B; the sparse path densified something")
    off = torch.ones(N20, dtype=torch.bool, device=res.alpha.device)
    off[torch.from_numpy(touched).to(off.device)] = False
    moved = int((res.alpha[~off] != cold.alpha[~off]).sum())
    if not torch.equal(res.alpha[off], cold.alpha[off]) or moved == 0:
        raise AssertionError("online_sparse_full: a dual outside the "
                             f"touched rows moved, or none inside ({moved})")
    if len(taken) != 4 or [gated_rows(a[3]) for a, _, _ in taken[2:]] != \
            [ONLINE_SPARSE_ROWS] * 2:
        raise AssertionError(f"online_sparse_full: {len(taken)} launches")
    checked = [main_check(f"online_sparse_full launch {i}", out,
                          sdca_epoch_sparse_plain(*a, **kw))
               for i, (a, kw, out) in enumerate(taken)]
    del taken
    emit("online_sparse_full", n=N20, m=M20, touched=[int(touched[0]),
                                                      int(touched[-1])],
         checked_launches=checked,
         worst_rel_err=max(c["rel_err"] for c in checked),
         rows_moved=moved, update_ms_by_cuda_events=s.elapsed_time(e),
         update_ms_host=host_ms, peak_mem_bytes=peak)
    del cold, res, csr
    gc.collect()
    torch.cuda.empty_cache()
    return {"sdca_epoch_sparse": 2 * cfg.outer_iters}


def solve_counted(name, X, y, grid, cfg, f_star=None, **knobs):
    """One solve through ``get_solver(name)(**knobs).solve`` on the card;
    returns the result and the launches it made, by kernel and route."""
    before = {k: route_counts(k) for k in WRAPPERS}
    res = get_solver(name)(**knobs).solve("hinge", X, y, P=grid[0],
                                          Q=grid[1], cfg=cfg, f_star=f_star)
    torch.cuda.synchronize()
    made = {}
    for k in WRAPPERS:
        by = {r: n - before[k][r] for r, n in route_counts(k).items()
              if n != before[k][r]}
        if by:
            made[k] = by
    return res, made


def comm_checked(label, res, made, kernel, route, bytes_per_step=None,
                 dual=False):
    """A compressed solve's contract: OUTER_ITERS launches of its kernel on
    the main route and no other launch, finite iterates, the cumulative
    wire bytes of every history entry, a falling objective (and gap)."""
    want = {kernel: {route: OUTER_ITERS}}
    if made != want:
        raise AssertionError(f"{label}: launches {made}; expected {want}")
    acct = res.comm_bytes
    if bytes_per_step is not None and acct["bytes_per_step"] != \
            bytes_per_step:
        raise AssertionError(f"{label}: {acct['bytes_per_step']} B a step; "
                             f"expected {bytes_per_step}")
    if [h["comm_bytes"] for h in res.history] != [
            acct["bytes_per_step"] * t for t in range(1, OUTER_ITERS + 1)]:
        raise AssertionError(f"{label}: cumulative wire bytes "
                             f"{[h['comm_bytes'] for h in res.history]}")
    vals = [h["objective"] for h in res.history]
    if not (all(np.isfinite(vals)) and torch.isfinite(res.w).all()):
        raise AssertionError(f"{label}: non-finite result {vals}")
    check_descent(label, res.history, dual=dual)
    return vals[-1]


class Int8WithoutFeedback(Int8Codec):
    """The int8 codec with its error feedback dropped: a faulty codec,
    the control that comm_full's int8 codec check must refuse."""
    name = "int8-no-ef"
    stateful = False


class TopKWithoutFeedback(TopKCodec):
    """top-k with its error feedback dropped (the dropped 90 % never
    travels): the control that the top-k objective band must refuse."""
    stateful = False

    @property
    def name(self):
        return f"topk:{self.frac:g}-no-ef"


@contextlib.contextmanager
def codec_tap(calls):
    """Record every ``Codec.apply`` a solve makes (the policy codecs and
    the cross-pod one; identity has its own ``apply``) as ``(value, err
    in, decoded, err out)``, cloned.  Restored on exit."""
    real = Codec.apply

    def apply(self, value, err=None):
        deq, new_err = real(self, value, err)
        calls.append(tuple(None if v is None else v.clone()
                           for v in (value, err, deq, new_err)))
        return deq, new_err
    Codec.apply = apply
    try:
        yield
    finally:
        Codec.apply = real


def int8_codec_faults(calls):
    """What the int8 codec calls of one solve (``codec_tap``) break of the
    codec's definition, held per call and per cell of its blocked payload
    ``(A, B, *cell)``: a residual comes out; the residual that goes in is
    zero at a collective's first step and the previous step's after; the
    decoded payload plus the new residual is the payload plus the old one;
    every decoded cell is integer codes of |code| <= 127 times ONE scale,
    max |payload + old residual| / 127 over the cell, and lies within half
    that scale of payload + old residual.  Returns the faults, one line
    each (empty for a sound codec)."""
    faults, last = [], {}
    for i, (value, err, deq, new) in enumerate(calls):
        key = tuple(value.shape)
        if new is None or err is None:
            faults.append(f"call {i} {key}: no error-feedback residual")
            continue
        want = last.get(key, torch.zeros_like(err))
        if not torch.equal(err, want):
            faults.append(f"call {i} {key}: the residual in is not the "
                          "last one out")
        last[key] = new
        t = value.to(torch.float32) + err
        if float((deq + new - t).abs().max()) > 1e-6 * float(
                t.abs().max()):
            faults.append(f"call {i} {key}: decoded + residual is not "
                          "payload + old residual")
        scale = t.reshape(*key[:2], -1).abs().amax(-1) / 127 + 1e-12
        scale = scale.reshape(*key[:2], *([1] * (t.dim() - 2)))
        codes = deq / scale
        off = float((codes - codes.round()).abs().max())
        if off > 1e-3 or float(codes.abs().max()) > 127 + 1e-3:
            faults.append(f"call {i} {key}: not integer codes of one scale "
                          f"a cell (off by {off:.3e})")
        over = float(((t - deq).abs() / scale).max())
        if over > 0.5 + 1e-3:
            faults.append(f"call {i} {key}: {over:.3e} scales from the "
                          "payload")
    return faults


def objective_gap(f, f_base):
    return (f - f_base) / abs(f_base)


def rel_diff(a, b):
    """Largest difference relative to the largest entry of ``b``."""
    return float((a - b).abs().max() / b.abs().max())


def comm_timing(name, X, y, cfg, codecs):
    """ms per outer iteration (CUDA events, COMM_TIMING_STEPS steps after
    a warm-up step) of ``name`` under each codec, in the order given and
    back again; each program is built, timed and dropped in turn."""
    samples = {c: [] for c in codecs}
    for c in (*codecs, *reversed(codecs)):
        prog = get_solver(name)(compression=c).program(
            "hinge", X, y, P=P, Q=Q, cfg=cfg)
        samples[c].append(time_program(prog, iters=COMM_TIMING_STEPS))
        del prog
    ms = {str(c): statistics.median(v) for c, v in samples.items()}
    base = ms[str(codecs[0])]
    return {"ms": ms, "codec_ms": {c: v - base for c, v in ms.items()
                                   if c != str(codecs[0])}}


def phase_comm_full():
    """The comm policies (compressed and hierarchical reductions) through
    ``get_solver(...)(compression=, topology=).solve`` and the CLI, at the
    Part 1 width (7 x 4, 14 000 x 12 000) and on the news20 profile: None
    against identity bitwise, the exact wire bytes, each codec's objective
    gap to the uncompressed solve within its predicted band, the int8
    codec held to its definition call by call, two controls without error
    feedback refused, the adaptive schedule's stages, pods=2 at 4 x 2
    against flat with B1 at that shape against its plain version, and ms
    per outer iteration under each codec."""
    t0 = time.perf_counter()
    out = {}
    Xn, yn = make_svm_data(N, M, seed=0)
    X, y = torch.as_tensor(Xn, device="cuda"), torch.as_tensor(yn,
                                                                device="cuda")
    del Xn, yn
    cfg = D3CAConfig(lam=LAM, outer_iters=OUTER_ITERS)
    runs, final, applied = {}, {}, []
    for comp in (None, "identity", *COMM_CODECS):
        with codec_tap(applied if comp == "int8" else []):
            res, made = solve_counted("d3ca", X, y, (P, Q), cfg,
                                      compression=comp)
        final[str(comp)] = comm_checked(f"d3ca/{comp}", res, made,
                                        "sdca_epoch", "cluster",
                                        COMM_BYTES[comp], dual=True)
        if res.comm_bytes["uncompressed_bytes_per_step"] != COMM_BYTES[None]:
            raise AssertionError(f"d3ca/{comp}: uncompressed bytes "
                                 f"{res.comm_bytes}")
        runs[comp] = res
    for f in ("w", "alpha"):
        if not torch.equal(getattr(runs[None], f),
                           getattr(runs["identity"], f)):
            raise AssertionError(f"d3ca: {f} under identity is not bitwise "
                                 "the uncompressed solve's")
    gaps = {c: objective_gap(final[c], final["None"]) for c in COMM_CODECS}
    for c, g in gaps.items():
        lo, hi = COMM_GAP_BAND[c]
        if not lo <= g <= hi:
            raise AssertionError(f"d3ca/{c}: objective {final[c]} is "
                                 f"{g:.3e} off the uncompressed "
                                 f"{final['None']} (band {lo}, {hi})")
    # int8 held to its definition on every call of the solve: 2
    # collectives x OUTER_ITERS steps, each cell on its own scale
    faults = int8_codec_faults(applied)
    if len(applied) != 2 * OUTER_ITERS or faults:
        raise AssertionError(f"d3ca/int8: {len(applied)} codec calls; "
                             f"{faults[:4]}")
    # the controls: without error feedback, int8 must fail the codec check
    # and top-k must leave its objective band
    control = {}
    for codec, kind in ((Int8WithoutFeedback(), "int8"),
                        (TopKWithoutFeedback(0.1), "topk:0.1")):
        calls = []
        with codec_tap(calls):
            res, made = solve_counted("d3ca", X, y, (P, Q), cfg,
                                      compression=codec)
        if made != {"sdca_epoch": {"cluster": OUTER_ITERS}} or \
                res.comm_bytes["bytes_per_step"] != COMM_BYTES[kind] or \
                not torch.isfinite(res.w).all():
            raise AssertionError(f"control {codec.name}: launches {made}, "
                                 f"{res.comm_bytes['bytes_per_step']} B")
        g = objective_gap(res.history[-1]["objective"], final["None"])
        lo, hi = COMM_GAP_BAND[kind]
        refused = int8_codec_faults(calls) if kind == "int8" else \
            ([f"gap {g:.3e} off the band"] if not lo <= g <= hi else [])
        if not refused:
            raise AssertionError(f"control {codec.name}: passed the checks "
                                 f"that must refuse it (gap {g:.3e})")
        control[codec.name] = {"objective_last": res.history[-1][
            "objective"], "gap": g, "refused_by": refused[0]}
    out["d3ca"] = {"objective_last": final, "gap": gaps,
                   "int8_codec_calls_checked": len(applied),
                   "control": control,
                   "bytes_per_step": {str(c): runs[c].comm_bytes[
                       "bytes_per_step"] for c in runs}}
    del runs, applied

    # the adaptive schedule against f* (REF_EPOCHS serial epochs)
    w_ref, _ = serial_sdca("hinge", X, y, lam=LAM, epochs=REF_EPOCHS,
                           device="cuda")
    f_star = float(objective("hinge", X, y, w_ref, LAM))
    res, made = solve_counted("d3ca", X, y, (P, Q), cfg, f_star=f_star,
                              compression="adaptive")
    if made != {"sdca_epoch": {"cluster": OUTER_ITERS}} or \
            res.iters != OUTER_ITERS:
        raise AssertionError(f"d3ca/adaptive: {res.iters} iterations, "
                             f"launches {made}")
    check_descent("d3ca/adaptive", res.history, dual=True)
    out["adaptive"] = {
        "spec": res.compression, "f_star": f_star,
        "stages": [[h["iter"], h["stage"], h["codec"]] for h in res.history],
        "rel_opt_last": res.history[-1]["rel_opt"],
        "comm_bytes_total": res.history[-1]["comm_bytes"]}

    # RADiSA under int8 against uncompressed RADiSA
    rcfg = RADiSAConfig(lam=LAM, outer_iters=OUTER_ITERS)
    rfinal = {}
    for comp in (None, "int8"):
        res, made = solve_counted("radisa", X, y, (P, Q), rcfg,
                                  compression=comp)
        rfinal[str(comp)] = comm_checked(f"radisa/{comp}", res, made,
                                         "svrg_inner", "ring")
    out["radisa"] = {"objective_last": rfinal,
                     "gap": objective_gap(rfinal["int8"], rfinal["None"])}

    # timing: ms per outer iteration under each codec
    out["timing"] = {
        "d3ca": comm_timing("d3ca", X, y, cfg, (None, *COMM_CODECS)),
        "radisa": comm_timing("radisa", X, y, rcfg, (None, "int8"))}
    del X, y

    # hierarchical reductions at Part 1 "4x2"
    Pt, Qt, nt, mt = COMM_TOPO
    Xn, yn = make_svm_data(nt, mt, seed=0)
    X, y = torch.as_tensor(Xn, device="cuda"), torch.as_tensor(yn,
                                                                device="cuda")
    del Xn, yn
    topo, checked, pod_calls = {}, [], []
    seen = {"n": 0}

    def on_launch(args, kw, got):
        # B1 at the 4 x 2 shape (8 cells of 2000 x 3000) against its plain
        # version on the same inputs, as the launch is made
        i = seen["n"] % OUTER_ITERS
        seen["n"] += 1
        if i in COMM_TOPO_CHECKED:
            checked.append({"launch": i, "shape": list(args[0].shape),
                            **main_check(f"comm_full 4x2 launch {i}", got,
                                         sdca_epoch_plain(*args, **kw))})
    for spec in (None, "pods=2:identity", "pods=2:int8"):
        with tap("sdca_epoch", on_launch), \
                codec_tap(pod_calls if spec == "pods=2:int8" else []):
            res, made = solve_counted("d3ca", X, y, (Pt, Qt), cfg,
                                      topology=spec)
        comm_checked(f"d3ca 4x2/{spec}", res, made, "sdca_epoch", "cluster",
                     dual=True)
        topo[str(spec)] = res
    flat, ident, int8 = topo.values()
    err = max(rel_diff(ident.w, flat.w), rel_diff(ident.alpha, flat.alpha))
    if err > COMM_TOPO_TOL:
        raise AssertionError(f"pods=2:identity against flat: {err:.3e}")
    tgap = objective_gap(int8.history[-1]["objective"],
                         flat.history[-1]["objective"])
    if abs(tgap) > COMM_TOPO_GAP or \
            int8.comm_bytes["bytes_per_step"] != COMM_TOPO_BYTES:
        raise AssertionError(f"pods=2:int8: gap {tgap:.3e}, wire "
                             f"{int8.comm_bytes['bytes_per_step']} B a step")
    # the cross-pod codec: once a step, on the (pods, Q, m_q) partials
    faults = int8_codec_faults(pod_calls)
    if len(pod_calls) != OUTER_ITERS or faults:
        raise AssertionError(f"pods=2:int8: {len(pod_calls)} codec calls; "
                             f"{faults[:4]}")
    if len(checked) != 3 * len(COMM_TOPO_CHECKED):
        raise AssertionError(f"comm_full 4x2: {len(checked)} launches "
                             "checked")
    out["topology"] = {
        "grid": f"{Pt}x{Qt}", "n": nt, "m": mt,
        "identity_vs_flat_rel_err": err, "int8_gap": tgap,
        "sdca_epoch_checked": checked,
        "tiers": {str(s): {k: r.comm_bytes.get(k) for k in (
            "bytes_per_step", "intra_bytes_per_step",
            "inter_bytes_per_step")} for s, r in topo.items()}}
    del X, y, topo, flat, ident, int8, pod_calls

    # the CLI's --compression at 7 x 4 and --topology at 4 x 2
    cli = {}
    for flags, comp, topo_spec, want in (
            (["--mesh", f"{P}x{Q}", "--n", str(N), "--m", str(M),
              "--compression", "int8"], "int8", None, COMM_BYTES["int8"]),
            (["--mesh", f"{Pt}x{Qt}", "--n", str(nt), "--m", str(mt),
              "--topology", "pods=2:int8"], None, "pods=2:int8:ring",
             COMM_TOPO_BYTES)):
        before = route_counts("sdca_epoch")["cluster"]
        summary = optimize.main(["--solver", "d3ca", "--lam", str(LAM),
                                 "--iters", str(OUTER_ITERS),
                                 "--ref-epochs", "0", *flags])
        made = route_counts("sdca_epoch")["cluster"] - before
        if (summary["compression"], summary["topology"]) != (comp, topo_spec) \
                or summary["comm_bytes_per_step"] != want \
                or summary["comm_bytes_total"] != OUTER_ITERS * want \
                or made != OUTER_ITERS or summary["device"] != "cuda":
            raise AssertionError(f"optimize {flags}: {summary}, {made} "
                                 "launches")
        cli[comp or topo_spec] = {k: summary[k] for k in (
            "objective", "comm_bytes_per_step", "comm_bytes_total")}
    out["cli"] = cli
    gc.collect()
    torch.cuda.empty_cache()

    # the news20 profile: sparse D3CA int8 (B3) and sparse RADiSA topk (B4)
    torch.cuda.reset_peak_memory_stats()
    csr, y20 = make_sparse_svm_csr(N20, M20, density=DENS20, seed=0)
    sparse = {}
    for name, cfg20, comp, kernel, route, dual in (
            ("d3ca", D3CAConfig(lam=LAM20, outer_iters=OUTER_ITERS), "int8",
             "sdca_epoch_sparse", "lookahead", True),
            ("radisa", RADiSAConfig(lam=LAM20, outer_iters=OUTER_ITERS),
             "topk:0.1", "svrg_inner_sparse", "cluster", False)):
        res, made = solve_counted(name, csr, y20, (P, Q), cfg20,
                                  compression=comp, block_format="sparse")
        sparse[f"{name}/{comp}"] = {
            "objective_first": res.history[0]["objective"],
            "objective_last": comm_checked(f"{name} sparse/{comp}", res,
                                           made, kernel, route, dual=dual),
            "bytes_per_step": res.comm_bytes["bytes_per_step"],
            "uncompressed_bytes_per_step":
                res.comm_bytes["uncompressed_bytes_per_step"]}
    peak = torch.cuda.max_memory_allocated()
    if peak >= SPARSE_PEAK_LIMIT:
        raise AssertionError(f"comm_full sparse: peak device memory {peak} B")
    out["news20"] = {**sparse, "peak_mem_bytes": peak}
    emit("comm_full", **out, wall_s=time.perf_counter() - t0)
    timed = len(COMM_CODECS) + 1
    return {"sdca_epoch": (len(COMM_CODECS) + 2 + 2 + 1 + 3 + 2) * OUTER_ITERS
            + REF_EPOCHS + 2 * timed * (COMM_TIMING_STEPS + 1),
            "svrg_inner": 2 * OUTER_ITERS + 4 * (COMM_TIMING_STEPS + 1),
            "sdca_epoch_sparse": OUTER_ITERS,
            "svrg_inner_sparse": OUTER_ITERS}


def phase_d3ca_sparse_full():
    return sparse_full("d3ca_sparse_full", "d3ca", "sdca_epoch_sparse", True)


def phase_radisa_sparse_full():
    return sparse_full("radisa_sparse_full", "radisa", "svrg_inner_sparse",
                       False)


def phase_sfk_sparse_full():
    return sparse_full("sfk_sparse_full", "sfk", "svrg_inner_sparse", False)


def serve_json(text):
    """The summary JSON block the serving CLI prints (``{`` to ``}`` on
    lines of their own)."""
    lines = text.splitlines()
    start = lines.index("{")
    return json.loads("\n".join(lines[start:lines.index("}", start) + 1]))


def run_serve(argv):
    """The serving CLI's ``main`` at full width; returns its outputs, what
    it printed and its wall time."""
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        outputs = serve.main(argv)
    torch.cuda.synchronize()
    return outputs, buf.getvalue(), time.perf_counter() - t0


def check_outputs(name, outputs, n, gen, vocab):
    if sorted(outputs) != list(range(n)):
        raise AssertionError(f"{name}: served {sorted(outputs)}")
    for rid, toks in outputs.items():
        toks = np.asarray(toks)
        if toks.shape != (gen,) or toks.min() < 0 or toks.max() >= vocab:
            raise AssertionError(f"{name}: request {rid} gave {toks}")


def phase_serve_qwen3_full():
    """Qwen3-1.7B at full width (28 layers, bf16 compute, greedy) through
    the continuous-batching engine: every admitted request is one prefill
    of its prompt padded to a multiple of 16 tokens, 28 flash attention
    launches; decode attention over the paged arena is plain PyTorch."""
    outputs, text, wall = run_serve(QWEN3_ARGV)
    summ = serve_json(text)
    vocab = get_config("qwen3-1.7b").vocab
    check_outputs("serve_qwen3_full", outputs, 16, 32, vocab)
    if summ["requests_finished"] != 16 or summ["rejections"]:
        raise AssertionError(f"serve_qwen3_full: {summ}")
    emit("serve_qwen3_full", tokens_per_sec=summ["tokens_per_sec"],
         ttft_p50_s=summ["ttft_s"]["p50"],
         latency_p99_s=summ["latency_s"]["p99"],
         generated_tokens=summ["generated_tokens"],
         elapsed_s=summ["elapsed_s"], prefills=summ["prefills"],
         decode_steps=summ["decode_steps"],
         preemptions=summ["preemptions"], wall_s=wall,
         peak_mem_bytes=torch.cuda.max_memory_allocated(),
         first_tokens=[int(t) for t in outputs[0][:8]])
    return {"flash_attention": 28 * summ["prefills"]}


def phase_serve_rwkv6_full():
    """RWKV6-3B at full width (32 layers, bf16 compute) through the same
    CLI: the paged engine refuses the recurrent mixer and the static loop
    prefills 8 prompts of 512 tokens at once (32 linear attention
    launches), then decodes 32 tokens with the plain recurrence."""
    outputs, text, wall = run_serve(RWKV6_ARGV)
    if "falling back to the static loop" not in text:
        raise AssertionError(f"serve_rwkv6_full: engine path? {text!r}")
    check_outputs("serve_rwkv6_full", outputs, 8, 32,
                  get_config("rwkv6-3b").vocab)
    emit("serve_rwkv6_full", wall_s=wall, generated_tokens=8 * 32,
         tokens_per_sec=8 * 32 / wall,
         peak_mem_bytes=torch.cuda.max_memory_allocated(),
         first_tokens=[int(t) for t in outputs[0][:8]])
    return {"rwkv_linattn": 32}


# ---------------------------------------------------------------------------
# train_*_full: LM training at full width and depth through the train CLI
# ---------------------------------------------------------------------------

def plain_flash(q, k, v, *, causal=True, window=None, scale=None):
    return flash_attention_plain(q, k, v, causal=causal, window=window,
                                 scale=scale)


def plain_linattn(r, k, v, logw, u, *, chunk=64):
    out, state = rwkv_linattn_ref(r, k, v, logw, u)
    return out.to(r.dtype), state


def leaf_paths(tree, prefix=""):
    """Leaf paths in the sorted order of ``tree_leaves_sorted``."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree)
                for p in leaf_paths(tree[k], f"{prefix}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [p for i, v in enumerate(tree)
                for p in leaf_paths(v, f"{prefix}/{i}")]
    return [prefix]


def train_function_inputs(rng, cfg, kernel, dev, requires_grad=True):
    """One training call's inputs of B5 or B6 at ``cfg``'s training shape
    (one microbatch: a sequence of TRAIN_SEQ tokens): B5 q (1, TRAIN_SEQ,
    heads, head dim) and k / v at the KV heads in bf16, B6 r, k, v, logw
    (heads, TRAIN_SEQ, head dim) float32 and u per head."""
    if kernel == "flash_attention":
        ins = flash_inputs(rng, 1, TRAIN_SEQ, cfg.n_heads, cfg.n_kv, cfg.hd,
                           torch.bfloat16, dev)
    else:
        ins = linattn_inputs(rng, cfg.rwkv_heads, TRAIN_SEQ,
                             cfg.rwkv_head_dim, dev, heads=cfg.rwkv_heads)
    return [t.requires_grad_(requires_grad) for t in ins]


def function_backward_ms(rng, cfg, kernel, dev):
    """CUDA-event ms of one forward of the kernel's autograd Function
    (the kernel) and of one backward (autograd through the plain
    version) at ``cfg``'s training shape."""
    fn = WRAPPERS[kernel]
    ins = train_function_inputs(rng, cfg, kernel, dev)
    out = fn(*ins)
    out = out if torch.is_tensor(out) else out[0]
    dout = torch.randn_like(out)
    fwd = cuda_ms(lambda: fn(*ins), reps=10)
    bwd = cuda_ms(lambda: torch.autograd.grad(out, ins, dout,
                                              retain_graph=True), reps=5)
    return {"forward_ms": fwd, "backward_ms": bwd}


def f64_linattn(r, k, v, logw, u, *, chunk=64):
    """The plain recurrence in float64, cast back: a forward that differs
    from ``plain_linattn`` by rounding alone (the conditioning control)."""
    out, state = rwkv_linattn_ref(r, k, v, logw, u, dtype=torch.float64)
    return out.to(r.dtype), state.float()


def grad_diffs(grads, ref):
    """Each leaf's largest gradient difference relative to the largest
    entry of ``ref``'s leaf, and the worst (relative error, path)."""
    out, worst = {}, (-1.0, None)
    for path, g, r in zip(leaf_paths(grads), tree_leaves_sorted(grads),
                          tree_leaves_sorted(ref)):
        rel = float((g - r).abs().max()) / max(float(r.abs().max()), 1e-30)
        out[path] = rel
        worst = max(worst, (rel, path))
    return out, worst


def step_compare(model, params, batch, tap_a, tap_b):
    """One step's (loss, gradients) with the model's B5 / B6 calls taken by
    ``tap_a`` and by ``tap_b`` (None: the kernels), compared."""
    res = []
    for tap in (tap_a, tap_b):
        with contextlib.ExitStack() as stack:
            if tap is not None:
                stack.enter_context(patched(lm_attention, "flash_attention",
                                            tap[0]))
                stack.enter_context(patched(lm_rwkv, "rwkv_linattn",
                                            tap[1]))
            t0 = time.perf_counter()
            loss, grads = loss_and_grads(model, params, batch)
            gn = float(global_norm(grads))
            torch.cuda.synchronize()
            res.append((float(loss), grads, gn, time.perf_counter() - t0))
            clear_grads(params)
    (la, ga, na, sa), (lb, gb, nb, sb) = res
    leaves_out, worst = grad_diffs(ga, gb)
    return ga, {"loss": la, "loss_ref": lb,
                "loss_rel_err": abs(la - lb) / abs(lb), "grad_norm": na,
                "grad_norm_ref": nb, "grad_norm_rel_err": abs(na - nb) / nb,
                "worst_leaf": worst[1], "worst_leaf_rel_err": worst[0],
                "leaf_rel_err": leaves_out, "step_s": [sa, sb]}


PLAIN = (plain_flash, plain_linattn)


def held_flash(record):
    """B5 as the model calls it (the kernel), each call's output also
    held against the plain version on the same q, k, v, row by row
    (``row_check`` at FLASH_TOL of bf16): (max abs error, the worst row's
    share of its limit) appended to ``record``.  The plain version
    launches nothing, so the counts are those of the kernel alone."""
    def call(q, k, v, *, causal=True, window=None, scale=None):
        out = flash_attention(q, k, v, causal=causal, window=window,
                              scale=scale)
        with torch.no_grad():
            want = flash_attention_plain(q, k, v, causal=causal,
                                         window=window, scale=scale)
            record.append(row_check(out, want, FLASH_TOL[torch.bfloat16]))
        return out
    return call


#: a training phase: its arch at ``depth`` layers (None: all); the kernel
#: its layers launch; ``cli``, the training CLI's part -- None (none),
#: "counted" (the CLI at the phase's depth: its TRAIN_FULL_STEPS steps and
#: a checkpoint are the counted steps, then --resume for
#: TRAIN_RESUME_STEPS), or a depth (TRAIN_FULL_STEPS steps of
#: ``make_train_step``, then the CLI at that many layers for TRAIN_STEPS
#: steps and the resume); ``bf16_grads``, what of the first step's bf16
#: gradients is held against the plain versions -- "leaves" (each leaf to
#: TRAIN_GRAD_TOL, the norm to TRAIN_LOSS_TOL), "norm" (the norm alone;
#: the leaves in float32, see TRAIN_F32_DEPTH) or None (neither; the
#: leaves in float32); ``f32_control``, the taps of a float32 rounding
#: control printed beside the float32 check, or None
TrainPath = collections.namedtuple(
    "TrainPath", "arch depth kernel cli bf16_grads f32_control")
#: Qwen3-1.7B's 3 counted steps at full depth; its training CLI, with a
#: checkpoint and --resume on one device, runs in train_mesh_full (at full
#: depth, with two checkpoints of 24.4 GB, this phase took 101.4 s of a
#: 967.7-s run of the script on NVIDIA H100 80GB HBM3, 700.00 W); RWKV6-3B
#: at 2 of its 32 layers and its CLI at 2, cut to keep the script inside
#: its time limit (at 32 its steps, first-step comparison and profile took
#: 276 s of a 1411-s run, at 8 the phase 79.3 s of a 1268.9-s one, at 4
#: with its CLI at 4 57.6 s of a 1230.6-s one, on NVIDIA H100 80GB HBM3,
#: 700.00 W; two full checkpoints, 73.6 GB, do not fit host memory beside
#: the process); its bf16 gradients at random init move by as much as they
#: are large under forwards that differ by rounding alone (the plain
#: recurrence in float32 or float64), so they are held in float32 beside
#: that control.  Mixtral-8x7B at 2 of 32 layers (23.2 GB of float32
#: copies a layer): its top-2 routing is discontinuous, and where the
#: tensor-core route's rounding of P to bf16 moves a token's router logits
#: across a tie the token changes experts and the bf16 gradients move by
#: O(0.1) of their largest entry (0.33 at w_gate, same card), so its
#: leaves are held in float32 and its B5 calls one by one (``held_flash``).
#: RecurrentGemma-9B at 5 of 38 (one (rglru, rglru, local) period and the
#: two remainder layers); MusicGen-large at 12 of its 48 layers (at 48 the
#: phase took 42.4 s of a 1210.9-s run, at 24 24.0 s of a 1230.6-s one,
#: same card)
TRAIN_PATHS = {
    "train_qwen3_full": TrainPath("qwen3-1.7b", None, "flash_attention",
                                  None, "leaves", None),
    "train_rwkv6_full": TrainPath("rwkv6-3b", 2, "rwkv_linattn", 2, None,
                                  (plain_flash, f64_linattn)),
    "train_mixtral_full": TrainPath("mixtral-8x7b", 2, "flash_attention",
                                    None, "norm", None),
    "train_recurrentgemma_full": TrainPath(
        "recurrentgemma-9b", 5, "flash_attention", None, "leaves", None),
    "train_musicgen_full": TrainPath("musicgen-large", 12,
                                     "flash_attention", None, "leaves",
                                     None),
}


def train_setup(name):
    """Before the counted window: the main path's first step (init(0), the
    CLI's batch 0, bf16) on the card through the kernels, and again with
    the plain versions tapped in -- loss, gradient norm and every leaf's
    gradient compared as ``TrainPath.bf16_grads`` says, no leaf's
    gradient (the router's and RG-LRU's lam included) zero or not finite
    on the kernels' path, and every B5 call of the kernels' step held
    against the plain version on its own inputs (``held_flash``).  Then a
    microbatch's time and the device's busy share, and one Function
    call's forward and backward timed at the phase's shape."""
    path = TRAIN_PATHS[name]
    dev = torch.device("cuda")
    cfg = family_config(path.arch, path.depth)
    model = Transformer(cfg, device=dev)
    params = model.init(0)
    n_params = sum(p.numel() for p in tree_leaves_sorted(params))
    batch = synthetic_lm_batch(cfg, 0, batch=TRAIN_BATCH, seq=TRAIN_SEQ)
    calls = []
    grads, first = step_compare(model, params, batch,
                                (held_flash(calls), rwkv_linattn), PLAIN)
    bad_leaves = [p for p, g in zip(leaf_paths(grads),
                                    tree_leaves_sorted(grads))
                  if not torch.isfinite(g).all() or float(g.abs().max()) == 0]
    del grads
    bad = bool(bad_leaves) or first["loss_rel_err"] > TRAIN_LOSS_TOL
    if path.bf16_grads:
        bad |= first["grad_norm_rel_err"] > TRAIN_LOSS_TOL
    if path.bf16_grads == "leaves":
        bad |= first["worst_leaf_rel_err"] > TRAIN_GRAD_TOL
    if calls:
        errs, ratios = (torch.stack(c) for c in zip(*calls))
        first["flash_calls"] = {"calls": len(calls),
                                "max_abs_err": float(errs.max()),
                                "row_ratio": float(ratios.max()),
                                "tol": FLASH_TOL[torch.bfloat16]}
        bad |= first["flash_calls"]["row_ratio"] > 1.0
    mb = {k: v[:1] for k, v in batch.items()}
    if path.bf16_grads != "leaves":
        # the first microbatch in float32 at TRAIN_F32_DEPTH layers (of a
        # one-kind pattern): the kernels against the plain versions
        depth = min(TRAIN_F32_DEPTH, cfg.n_layers)
        cut = Transformer(dataclasses.replace(
            cfg, compute_dtype="float32", n_layers=depth), device=dev)
        cut_params = params if depth == cfg.n_layers else dict(
            params, periods=[tree_map(lambda a: a[:depth].clone(), t)
                             for t in params["periods"]])
        key = f"float32_depth{depth}_first_microbatch"
        _, first[key] = step_compare(cut, cut_params, mb, None, PLAIN)
        first[key]["tol"] = TRAIN_GRAD_TOL_F32
        bad |= first[key]["worst_leaf_rel_err"] > TRAIN_GRAD_TOL_F32
        if path.f32_control:
            _, first[f"float32_depth{depth}_control_first_microbatch"] = \
                step_compare(cut, cut_params, mb, PLAIN, path.f32_control)
        del cut, cut_params

    # where a microbatch's time goes: its forward, recompute and backward
    # (no optimizer), CUDA-event ms beside the device's busy time
    def microbatch():
        loss_and_grads(model, params, mb)
        clear_grads(params)
    mb_ms = cuda_ms(microbatch, reps=3)
    first.update(leaves=len(first["leaf_rel_err"]), dtype=cfg.compute_dtype,
                 tol={"loss": TRAIN_LOSS_TOL, "grad": TRAIN_GRAD_TOL},
                 bf16_grads_held=path.bf16_grads,
                 zero_or_nonfinite_leaves=bad_leaves,
                 microbatch={"ms": mb_ms, **with_idle(
                     mb_ms, device_busy(microbatch, 1))})
    emit(f"{name}_first_step", **first)
    if bad:
        raise AssertionError(f"{name}: first step through the kernels and "
                             "through the plain versions disagree, or a "
                             f"gradient is zero (see the {name}_first_step "
                             "line)")
    del model, params
    gc.collect()
    torch.cuda.empty_cache()
    timing = function_backward_ms(np.random.default_rng(12), cfg,
                                  path.kernel, dev)
    gc.collect()
    torch.cuda.empty_cache()
    return {"first": first, "n_params": n_params, "function": timing}


def phase_train(name, setup):
    """LM training on the card at full width and the depth of the phase's
    ``TrainPath``: TRAIN_FULL_STEPS steps of the train step the CLI builds
    (``make_train_step``, AdamW at the CLI's schedule, the CLI's batches:
    frame embeddings for MusicGen), or of the CLI itself, and the CLI's
    checkpoint and --resume where the path names it (see TRAIN_CKPT_ROOT).
    The first step is the one the set-up held against the plain versions.
    Every kernel layer of a period launches the kernel twice a microbatch
    (the forward and the checkpoint's recompute, "nothing" remat), a
    remainder layer once, and each runs its backward once through the
    plain version.  Peak device memory against the four float32 copies
    (gate TRAIN_PEAK_FACTOR)."""
    path = TRAIN_PATHS[name]
    dev = torch.device("cuda")
    cfg = family_config(path.arch, path.depth)
    acc = _largest_divisor_leq(TRAIN_BATCH, cfg.train_accum)
    in_periods, in_rem = kernel_layers(cfg, path.kernel)
    launches = backwards = 0

    full = []
    if path.cli != "counted":
        model = Transformer(cfg, device=dev)
        params = model.init(0)
        opt = adamw_init(params)
        train_step = make_train_step(model, AdamWConfig(lr=warmup_cosine(
            3e-3, 20, TRAIN_FULL_STEPS)))
        for s in range(TRAIN_FULL_STEPS):
            batch = synthetic_lm_batch(cfg, s, batch=TRAIN_BATCH,
                                       seq=TRAIN_SEQ)
            t0 = time.perf_counter()
            params, opt, m = train_step(params, opt, batch)
            full.append({"step": s, "loss": float(m["loss"]),
                         "grad_norm": float(m["grad_norm"]),
                         "time_s": time.perf_counter() - t0})
        del model, params, opt
        gc.collect()
        torch.cuda.empty_cache()
        launches += acc * TRAIN_FULL_STEPS * (2 * in_periods + in_rem)
        backwards += acc * TRAIN_FULL_STEPS * (in_periods + in_rem)

    cli = None
    if path.cli is not None:
        # the CLI: steps, a checkpoint, --resume
        counted = path.cli == "counted"
        cli_cfg = cfg if counted else family_config(path.arch, path.cli)
        first_steps = TRAIN_FULL_STEPS if counted else TRAIN_STEPS
        ckpt = tempfile.mkdtemp(prefix="train_ckpt_", dir=TRAIN_CKPT_ROOT)
        argv = ["--arch", path.arch, "--batch", str(TRAIN_BATCH), "--seq",
                str(TRAIN_SEQ), "--ckpt-dir", ckpt, "--ckpt-every", "1000"]
        try:
            walls = []
            with contextlib.redirect_stdout(io.StringIO()), \
                    patched(train_cli, "get_config", lambda a: cli_cfg):
                for extra in (["--steps", str(first_steps)],
                              ["--steps", str(TRAIN_RESUME_STEPS),
                               "--resume"]):
                    t0 = time.perf_counter()
                    hist = train_cli.main(argv + extra)
                    torch.cuda.synchronize()
                    walls.append((time.perf_counter() - t0, hist))
                    gc.collect()
                    torch.cuda.empty_cache()
            ckpt_bytes = sum(os.path.getsize(os.path.join(b, f))
                             for b, _, fs in os.walk(ckpt) for f in fs)
        finally:
            shutil.rmtree(ckpt, ignore_errors=True)
        (wall1, h1), (wall2, h2) = walls
        if counted:
            full = h1
        steps = [h["step"] for h in h1 + h2]
        if steps != list(range(first_steps + TRAIN_RESUME_STEPS)):
            raise AssertionError(f"{name}: CLI steps {steps}; the resume "
                                 f"must continue at {first_steps}")
        for h in h1 + h2:
            if not (np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"])):
                raise AssertionError(f"{name}: CLI step {h['step']}: {h}")
        p, r = kernel_layers(cli_cfg, path.kernel)
        launches += acc * len(steps) * (2 * p + r)
        backwards += acc * len(steps) * (p + r)
        cli = {"layers": cli_cfg.n_layers, "steps": steps,
               "losses": [h["loss"] for h in h1 + h2],
               "step_ms": [1e3 * h["time_s"] for h in h1 + h2],
               "wall_s": [wall1, wall2],
               # the walls outside the steps: build, init, restore, save
               "outside_steps_s": [wall1 - sum(h["time_s"] for h in h1),
                                   wall2 - sum(h["time_s"] for h in h2)],
               "ckpt_bytes": ckpt_bytes}
    peak = torch.cuda.max_memory_allocated()
    for h in full:
        if not (np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"])):
            raise AssertionError(f"{name}: step {h['step']}: {h}")
    first = setup["first"]
    if abs(full[0]["loss"] - first["loss"]) > 1e-5 * first["loss"] or \
            abs(full[0]["grad_norm"] - first["grad_norm"]) > \
            1e-5 * first["grad_norm"]:
        raise AssertionError(f"{name}: the first step {full[0]} is not the "
                             f"checked one ({first['loss']}, "
                             f"{first['grad_norm']})")
    got = WRAPPERS[path.kernel].plain_backwards
    if got != backwards:
        raise AssertionError(f"{name}: {got} plain backward calls, "
                             f"expected {backwards}")
    reckoned = 4 * 4 * setup["n_params"]
    if not reckoned <= peak <= TRAIN_PEAK_FACTOR * reckoned:
        raise AssertionError(f"{name}: peak {peak} B against the four "
                             f"float32 copies' {reckoned} B")
    step_s = statistics.median(h["time_s"] for h in full[1:])
    fn = setup["function"]
    emit(name, arch=path.arch, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
         microbatches=acc, remat=cfg.remat_policy, layers=cfg.n_layers,
         full_layers=get_config(path.arch).n_layers,
         n_params=setup["n_params"], step_ms=1e3 * step_s,
         step_ms_each=[1e3 * h["time_s"] for h in full],
         tokens_per_sec=TRAIN_BATCH * TRAIN_SEQ / step_s,
         losses=[h["loss"] for h in full],
         grad_norms=[h["grad_norm"] for h in full],
         peak_mem_bytes=peak, reckoned_bytes=reckoned,
         peak_over_reckoned=peak / reckoned, launches=launches,
         plain_backwards=backwards, function=fn,
         plain_backward_share=fn["backward_ms"] * (in_periods + in_rem)
         * acc / (1e3 * step_s),
         kernel_forward_share=fn["forward_ms"] * (2 * in_periods + in_rem)
         * acc / (1e3 * step_s), cli=cli)
    return {path.kernel: launches}


# ---------------------------------------------------------------------------
# the other LM families (MoE, RG-LRU + LOCAL, XATTN, the embedding frontend,
# the int8 KV cache): serving and training at full width, depth cut only
# where one card's 80 GB forces it
# ---------------------------------------------------------------------------

#: the mixer kinds whose layers call each LM kernel over a sequence
KERNEL_KINDS = {"flash_attention": ("attn", "local", "xattn"),
                "rwkv_linattn": ("rwkv",)}


def family_config(arch, depth=None, **kw):
    """``get_config(arch)`` at ``depth`` layers (None: its own), with
    ``kw`` replaced."""
    cfg = get_config(arch)
    if depth:
        kw["n_layers"] = depth
    return dataclasses.replace(cfg, **kw) if kw else cfg


def kernel_layers(cfg, kernel="flash_attention"):
    """(the kernel's layers in full periods, its layers in the remainder)
    of ``cfg``: a prefill launches it once a layer; a training microbatch
    twice a period layer (the forward and the checkpoint's recompute,
    remat "nothing") and once a remainder layer."""
    kinds = KERNEL_KINDS[kernel]
    n_full, n_rem = cfg.n_periods()
    kp = len(cfg.pattern)
    return (n_full * sum(k in kinds for k in cfg.pattern),
            sum(cfg.pattern[r % kp] in kinds for r in range(n_rem)))


#: the serving phases of the other families: (the serving CLI's argv,
#: depth (None: full), config overrides, whether the CLI must take the
#: static loop).  Mixtral at 4 of its 32 layers on the paged engine with
#: the Qwen3 trace (16 requests of 128-1024 tokens, 32 new, 8 slots);
#: RecurrentGemma at full depth on the static loop, 4 prompts of 3072 so
#: that its LOCAL layers' 2048-token window bites in prefill and in the
#: ring decode; Llama-3.2-Vision at one period (5 of 100 layers: 4 ATTN +
#: 1 XATTN) over 1024 stub encoder states, 4 prompts of 512; MusicGen at
#: full depth through the embedding frontend, 8 x 512 frames; Qwen3-1.7B
#: with the int8 KV cache (the engine refuses int8 pages: static loop)
SERVE_FAMILIES = {
    "serve_mixtral_full": (["--arch", "mixtral-8x7b", *QWEN3_ARGV[2:]], 4,
                           {}, False),
    "serve_recurrentgemma_full": (
        ["--arch", "recurrentgemma-9b", "--requests", "4", "--prompt-len",
         "3072", "--gen", "32", "--max-seq-len", "3104"], None, {}, True),
    "serve_vlm_full": (
        ["--arch", "llama-3.2-vision-90b", "--requests", "4",
         "--prompt-len", "512", "--gen", "32", "--max-seq-len", "544"], 5,
        {}, True),
    "serve_musicgen_full": (
        ["--arch", "musicgen-large", "--requests", "8", "--prompt-len",
         "512", "--gen", "32", "--max-seq-len", "544"], None, {}, True),
    "serve_qwen3_int8_full": (
        ["--arch", "qwen3-1.7b", "--requests", "8", "--prompt-len", "512",
         "--gen", "32", "--max-seq-len", "544"], None,
        {"kv_cache_dtype": "int8"}, True),
}


def serve_family(name):
    """One of ``SERVE_FAMILIES`` through the serving CLI's ``main``, its
    config cut as the table says (``get_config`` patched in the CLI):
    every request served with ``--gen`` tokens in the vocabulary, every
    prefill's logits finite, and the static loop taken where it must be.
    Returns (outputs, B5 launches, the emitted fields)."""
    argv, depth, over, static = SERVE_FAMILIES[name]
    arch = argv[1]
    n, gen = int(argv[argv.index("--requests") + 1]), 32
    finite = {"prefill": [], "decode": []}
    real = {"prefill": Transformer.prefill,
            "decode": Transformer.decode_step,
            "paged": Transformer.decode_step_paged}

    def watched(kind):
        def call(self, *a, **kw):
            out = real[kind](self, *a, **kw)
            finite["prefill" if kind == "prefill" else "decode"].append(
                bool(torch.isfinite(out[0]).all()))
            return out
        return call
    with patched(serve, "get_config",
                 lambda a: family_config(a, depth, **over)), \
            patched(Transformer, "prefill", watched("prefill")), \
            patched(Transformer, "decode_step", watched("decode")), \
            patched(Transformer, "decode_step_paged", watched("paged")):
        outputs, text, wall = run_serve(argv)
    cfg = family_config(arch, depth, **over)
    took_static = "falling back to the static loop" in text
    if took_static != static or not all(finite["prefill"] +
                                        finite["decode"]):
        raise AssertionError(f"{name}: static loop {took_static} (expected "
                             f"{static}), logits finite {finite}")
    check_outputs(name, outputs, n, gen, cfg.vocab)
    per_prefill = sum(kernel_layers(cfg))
    fields = {"arch": arch, "layers": cfg.n_layers,
              "full_layers": get_config(arch).n_layers,
              "path": "static loop" if static else "paged engine",
              "wall_s": wall, "peak_mem_bytes":
              torch.cuda.max_memory_allocated(),
              "first_tokens": [int(t) for t in outputs[0][:8]],
              "distinct_tokens": len({int(t) for o in outputs.values()
                                      for t in o}),
              "logit_calls": {k: len(v) for k, v in finite.items()}}
    if static:
        prefills = 1
        fields.update(generated_tokens=n * gen,
                      tokens_per_sec=n * gen / wall)
    else:
        summ = serve_json(text)
        if summ["requests_finished"] != n or summ["rejections"]:
            raise AssertionError(f"{name}: {summ}")
        prefills = summ["prefills"]
        fields.update(tokens_per_sec=summ["tokens_per_sec"],
                      ttft_p50_s=summ["ttft_s"]["p50"],
                      latency_p99_s=summ["latency_s"]["p99"],
                      generated_tokens=summ["generated_tokens"],
                      elapsed_s=summ["elapsed_s"],
                      decode_steps=summ["decode_steps"],
                      preemptions=summ["preemptions"])
    fields.update(prefills=prefills, flash_per_prefill=per_prefill)
    return outputs, per_prefill * prefills, fields


def phase_serve_mixtral_full():
    _, launches, fields = serve_family("serve_mixtral_full")
    emit("serve_mixtral_full", **fields)
    return {"flash_attention": launches}


def phase_serve_recurrentgemma_full():
    _, launches, fields = serve_family("serve_recurrentgemma_full")
    emit("serve_recurrentgemma_full", **fields)
    return {"flash_attention": launches}


def phase_serve_vlm_full():
    _, launches, fields = serve_family("serve_vlm_full")
    emit("serve_vlm_full", **fields)
    return {"flash_attention": launches}


def phase_serve_musicgen_full():
    _, launches, fields = serve_family("serve_musicgen_full")
    emit("serve_musicgen_full", **fields)
    return {"flash_attention": launches}


def phase_serve_qwen3_int8_full():
    """Qwen3-1.7B with the int8 KV cache through the CLI (the static
    loop), then the same loop (``legacy_generate``, the same weights and
    prompts) with the bf16 cache: the greedy tokens compared.  The first
    token of each request comes from the prefill's logits, which the
    cache does not touch, so it must agree; later ones read the cache."""
    outputs, launches, fields = serve_family("serve_qwen3_int8_full")
    gc.collect()
    torch.cuda.empty_cache()
    argv = SERVE_FAMILIES["serve_qwen3_int8_full"][0]
    args = serve.build_parser().parse_args(argv)
    cfg = get_config("qwen3-1.7b")
    model = Transformer(cfg, device=torch.device("cuda"))
    bf16 = serve.legacy_generate(cfg, model, model.init(0), args)
    del model
    a = np.stack([outputs[i] for i in sorted(outputs)])
    b = np.stack([bf16[i] for i in sorted(bf16)])
    if not np.array_equal(a[:, 0], b[:, 0]):
        raise AssertionError(f"serve_qwen3_int8_full: first tokens {a[:, 0]}"
                             f" against the bf16 cache's {b[:, 0]}")
    same = a == b
    diverge = [int(np.argmin(r)) if not r.all() else int(r.size)
               for r in same]
    emit("serve_qwen3_int8_full", **fields,
         agree_share=float(same.mean()),
         agree_share_by_position=[float(x) for x in same.mean(0)],
         first_divergence=diverge)
    return {"flash_attention": launches + sum(kernel_layers(cfg))}


# ---------------------------------------------------------------------------
# obs_full: the timed (traced / registered) paths at full width
# ---------------------------------------------------------------------------

#: steps ``obs/phases.py::calibrate_phases`` makes from a program's initial
#: state on the timed path: a warm-up and 3 timed calls of ``step``, then
#: of ``local_step`` -- each one launch of the solver kernel
OBS_CALIB = 2 * (1 + 3)
#: the outer iteration of the traced CLI solve during which the endpoint
#: is scraped (from inside the solve, through the monitor's poll)
OBS_FETCH_AT = 5
OBS_ONLINE_ROUNDS = 10
#: scoring rows a round of the online runs (not a width: the stream's rows
#: are made on the host, and 4096 a round would dominate the phase)
OBS_SCORE_BATCH = 512
OBS_SERVE_REQUESTS = 4
OBS_SERVE_ARGV = [a if a != "16" else str(OBS_SERVE_REQUESTS)
                  for a in QWEN3_ARGV]


@contextlib.contextmanager
def patched(owner, name, value):
    """Set ``owner.name`` to ``value`` for the block; restored on exit."""
    real = getattr(owner, name)
    setattr(owner, name, value)
    try:
        yield real
    finally:
        setattr(owner, name, real)


class DataMemo:
    """The port's synthetic data generators, each instance made once a run:
    a call with arguments seen before hands back the arrays made then (no
    consumer writes into them), and adds the seconds that making them took
    to ``saved_s``.  Installed in ``main`` into every module that calls a
    generator; the phases' timers (and the CLIs') start after their data
    is made, so only the phases' wall times move."""
    MAKERS = ("make_svm_data", "make_sparse_svm_csr", "make_sparse_svm_data")

    def __init__(self):
        self.made, self.hits, self.saved_s, self.made_s = {}, 0, 0.0, 0.0

    def wrap(self, fn):
        def call(*a, **kw):
            key = (fn.__name__, a, tuple(sorted(kw.items())))
            if key in self.made:
                out, took = self.made[key]
                self.hits += 1
                self.saved_s += took
                return out
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            took = time.perf_counter() - t0
            self.made[key] = (out, took)
            self.made_s += took
            return out
        return call

    def install(self):
        owners = (sys.modules[__name__], sys.modules["repro_torch.data"],
                  optimize, fleet_cli)
        real = {name: getattr(owners[0], name) for name in self.MAKERS}
        wrapped = {name: self.wrap(fn) for name, fn in real.items()}
        for owner in owners:
            for name in self.MAKERS:
                if hasattr(owner, name):
                    setattr(owner, name, wrapped[name])

    def report(self):
        return {"instances": len(self.made), "made_s": self.made_s,
                "hits": self.hits, "saved_s": self.saved_s}


def first_last(keep):
    """An ``on_launch`` for :func:`tap` keeping the first and the last
    launch's (args, kwargs, outputs) in ``keep``."""
    def on_launch(args, kw, out):
        if not keep:
            keep.append((args, kw, out))
        keep[1:] = [(args, kw, out)]
    return on_launch


def held_first_last(label, keep, plain):
    """The first and last kept launch against the plain version."""
    if len(keep) != 2:
        raise AssertionError(f"{label}: kept {len(keep)} launches")
    return [main_check(f"{label} {which}", out, plain(*args, **kw))
            for which, (args, kw, out) in zip(("first", "last"), keep)]


def read_jsonl(path):
    with open(path) as fh:
        return [json.loads(line) for line in fh]


def fetch(url):
    """(status, body) of one GET on the loopback endpoint."""
    with urllib.request.urlopen(url, timeout=10) as r:
        return r.status, r.read().decode()


def bitwise(a, b):
    return a.shape == b.shape and torch.equal(a.view(torch.int32),
                                              b.view(torch.int32))


def obs_setup():
    """What ``obs_full`` is held against, made before its counters go to
    0: the untraced dense D3CA solve of the CLI's seed (its w, and ms per
    outer iteration of its program by CUDA events) and f* of every fleet
    tenant (serial SDCA, REF_EPOCHS epochs)."""
    Xn, yn = make_svm_data(N, M, seed=0)
    X, y = torch.as_tensor(Xn, device="cuda"), torch.as_tensor(
        yn, device="cuda")
    del Xn, yn
    cfg = D3CAConfig(lam=LAM, outer_iters=OUTER_ITERS)
    solver = get_solver("d3ca")()
    w = solver.solve("hinge", X, y, P=P, Q=Q, cfg=cfg,
                     record_history=False).w
    ms = time_program(solver.program("hinge", X, y, P=P, Q=Q, cfg=cfg))
    f_star = {}
    for t in fleet_tenants(False):
        Xt = torch.as_tensor(t.X, device="cuda")
        yt = torch.as_tensor(t.y, device="cuda")
        w_ref, _ = serial_sdca("hinge", Xt, yt, lam=t.lam,
                               epochs=REF_EPOCHS)
        f_star[t.tenant_id] = float(objective("hinge", Xt, yt, w_ref,
                                              t.lam))
        del Xt, yt, w_ref
    torch.cuda.synchronize()
    return {"X": X, "y": y, "w": w, "untraced_ms": ms, "f_star": f_star}


def obs_d3ca_cli(setup, tmp):
    """Dense D3CA at Part 1 through ``optimize.main`` under every
    telemetry flag: the endpoint scraped during the solve, the span tree,
    the registry, w bitwise the untraced solve, B1's launches exact and
    its first and last cell launch against the plain version."""
    trace = os.path.join(tmp, "d3ca.json")
    bundle = os.path.join(tmp, "d3ca.bundle.json")
    servers, scraped, results, keep = [], {}, [], []
    polls = [0]

    def start(self):
        servers.append(self)
        return real_start(self)

    def poll(self):
        status = real_poll(self)
        polls[0] += 1
        if polls[0] == OBS_FETCH_AT:
            url = servers[0].url
            code, text = fetch(url + "/metrics")
            scraped["metrics"] = (code, parse_prometheus_text(text))
            code, text = fetch(url + "/healthz")
            scraped["healthz"] = (code, json.loads(text))
        return status

    def solve(self, *args, **kw):
        res = real_solve(self, *args, **kw)
        results.append(res)
        return res

    def on_launch(args, kw, out):
        if tuple(args[0].shape[:2]) == (P, Q):    # the cells, not f*
            first_last(keep)(args, kw, out)

    g0 = dict(sdca_epoch.launches_by_cluster)
    r0 = route_counts("sdca_epoch")
    buf = io.StringIO()
    with patched(ObsServer, "start", start) as real_start, \
            patched(HealthMonitor, "poll", poll) as real_poll, \
            patched(Solver, "solve", solve) as real_solve, \
            tap("sdca_epoch", on_launch), contextlib.redirect_stdout(buf):
        summary = optimize.main([
            "--solver", "d3ca", "--mesh", f"{P}x{Q}", "--n", str(N),
            "--m", str(M), "--lam", str(LAM), "--ref-epochs",
            str(REF_EPOCHS), "--iters", str(OUTER_ITERS), "--trace", trace,
            "--metrics", "--health", "--flight-recorder", bundle,
            "--listen", "127.0.0.1:0"])
    torch.cuda.synchronize()
    labels = "{engine=simulated,solver=d3ca}"
    # the endpoint, scraped from inside the solve
    code, prom = scraped["metrics"]
    hcode, health = scraped["healthz"]
    if code != 200 or prom.get("solver_iters") is None or hcode != 200 \
            or health["status"] != "ok":
        raise AssertionError(f"obs_full d3ca: scrape {code} {prom}, "
                             f"healthz {hcode} {health}")
    # the span tree: 10 outer_iter, each with one step, one local_solve and
    # one comm/<name> a collective, inside the step's interval
    events = read_jsonl(os.path.splitext(trace)[0] + ".jsonl")
    spans = [e for e in events if e["dur"] is not None]
    outer = [e for e in spans if e["name"] == "outer_iter"]
    if [e["args"]["iter"] for e in outer] != list(range(1, OUTER_ITERS + 1)):
        raise AssertionError(f"obs_full d3ca: outer_iter spans {outer}")
    colls = ("dalpha", "w_contrib")
    for t in range(1, OUTER_ITERS + 1):
        def of(name):
            return [e for e in spans if e["name"] == name
                    and e.get("args", {}).get("iter") == t]
        (step,) = of("step")
        inner = of("local_solve") + [c for n in colls for c in of(f"comm/{n}")]
        if len(inner) != 1 + len(colls) or any(
                e["ts"] < step["ts"] - 1e-9 or e["ts"] + e["dur"] >
                step["ts"] + step["dur"] + 1e-9 for e in inner):
            raise AssertionError(f"obs_full d3ca: iteration {t}: step "
                                 f"{step}, inside it {inner}")
    (calib,) = [e for e in spans if e["name"] == "calibrate"]
    steps_ms = 1e3 * sum(e["dur"] for e in spans if e["name"] == "step")
    # the registry
    counters = summary["metrics"]["counters"]
    per_step = summary["comm_bytes_per_step"]
    if counters["solver/iters" + labels] != OUTER_ITERS \
            or per_step != COMM_BYTES[None] \
            or counters["solver/comm_bytes" + labels] != OUTER_ITERS \
            * per_step:
        raise AssertionError(f"obs_full d3ca: registry {counters}, "
                             f"{per_step} B a step")
    payload = load_bundle(bundle)
    # bitwise the untraced solve; B1's launches exact
    (res,) = results
    if not bitwise(res.w, setup["w"]):
        raise AssertionError("obs_full d3ca: the traced w is not bitwise "
                             "the untraced solve's")
    at = {g: sdca_epoch.launches_by_cluster[g] - g0[g] for g in g0}
    by = {r: n - r0[r] for r, n in route_counts("sdca_epoch").items()}
    want = {1: OUTER_ITERS + OBS_CALIB, 16: REF_EPOCHS}
    if at != want or by["cluster"] != sum(want.values()):
        raise AssertionError(f"obs_full d3ca: B1 by cluster size {at}, by "
                             f"route {by}; expected {want}, all cluster")
    checked = held_first_last("obs_full d3ca sdca_epoch", keep,
                              sdca_epoch_plain)
    h = res.history[0]
    return {"local_frac": h["local_s"] / h["step_s"],
            "calibration_s": calib["dur"],
            "traced_ms_per_iter": steps_ms / OUTER_ITERS,
            "untraced_ms_per_iter_cuda_events": setup["untraced_ms"],
            "host_s_per_iter": statistics.median(
                e["host_s"] for e in res.history),
            "phases_line": [ln for ln in buf.getvalue().splitlines()
                            if ln.startswith("[optimize] phases")],
            "scrape": {"solver_iters_at_scrape": sum(
                prom["solver_iters"].values()), "healthz": health["status"]},
            "events": len(events),
            # --trace wins over the recorder (``ObsPlane.tracer_or``, as
            # in the reference): the exit bundle holds the metrics
            "bundle_metrics": sorted(payload["metrics"]),
            "comm_bytes": counters["solver/comm_bytes" + labels],
            "w_bitwise_untraced": True, "launches_by_cluster": at,
            "checked_launches": checked}


def obs_radisa_int8(setup):
    """RADiSA under int8 through ``get_solver`` with a tracer and a
    registry: a comm span per collective and iteration, finite non-zero
    error-feedback norms, the codec timings, B2 exact on ``ring``."""
    tr, reg = Tracer(), Registry()
    keep = []
    r0 = route_counts("svrg_inner")
    with tap("svrg_inner", first_last(keep), "repro_torch.kernels.svrg"):
        res = get_solver("radisa")(compression="int8").solve(
            "hinge", setup["X"], setup["y"], P=P, Q=Q,
            cfg=RADiSAConfig(lam=LAM, outer_iters=OUTER_ITERS), tracer=tr,
            registry=reg)
    torch.cuda.synchronize()
    by = {r: n - r0[r] for r, n in route_counts("svrg_inner").items()}
    if by["ring"] != OUTER_ITERS + OBS_CALIB or sum(by.values()) != by["ring"]:
        raise AssertionError(f"obs_full radisa: B2 by route {by}")
    names = ("z", "grad", "dw")
    spans = {n: len(tr.spans(f"comm/{n}")) for n in names}
    gauges = reg.snapshot()["gauges"]
    lab = "{engine=simulated,solver=radisa}"
    ef = {n: gauges[f"compress/ef_norm/{n}{lab}"] for n in names}
    codec_s = {n: gauges[f"compress/codec_s/{n}{lab}"] for n in names}
    if set(spans.values()) != {OUTER_ITERS} or not all(
            np.isfinite(v) and v > 0 for v in ef.values()):
        raise AssertionError(f"obs_full radisa: comm spans {spans}, EF "
                             f"norms {ef}")
    h = res.history[0]
    return {"comm_spans": spans, "ef_norm": ef, "codec_s": codec_s,
            "local_frac": h["local_s"] / h["step_s"],
            "traced_ms_per_iter": 1e3 * tr.total("step") / OUTER_ITERS,
            "objective_last": res.history[-1]["objective"],
            "launches_ring": by["ring"],
            "checked_launches": held_first_last(
                "obs_full radisa svrg_inner", keep, svrg_inner_plain)}


def obs_online(tmp):
    """The online CLI at the ``online_full`` width under ``--trace
    --metrics --health --max-staleness 60 --max-lag 10000``: the spans of
    every round, the monitor OK; then the same stream with ``update``
    given no registry (nor tracer), the untimed path, to read both ways'
    update ms (CUDA events) and staleness."""
    argv = [a if a != str(ONLINE_SCORE_BATCH) else str(OBS_SCORE_BATCH)
            for a in ONLINE_ARGV]
    argv += ["--rounds", str(OBS_ONLINE_ROUNDS)]
    runs = {}
    for way in ("registry", "none"):
        events, stale = [], []
        trace = os.path.join(tmp, f"online-{way}.json")

        def on_start(svc, way=way, events=events):
            real = svc.solver.update

            def timed(*args, **kw):
                if way == "none":
                    kw = {**kw, "registry": None, "tracer": None}
                s, e = (torch.cuda.Event(enable_timing=True)
                        for _ in range(2))
                s.record()
                res = real(*args, **kw)
                e.record()
                events.append((s, e))
                return res
            svc.solver.update = timed

        def on_round(r, svc, rec, stale=stale):
            stale.append(rec["staleness_s"])
            svc.score(np.ones((4, M), np.float32))   # an online/score span

        flags = ([] if way == "none" else
                 ["--trace", trace, "--metrics", "--health",
                  "--max-staleness", "60", "--max-lag", "10000"])
        summary = run_online([*argv, *flags], on_start, on_round)
        runs[way] = {"summary": summary,
                     "update_ms": [s.elapsed_time(e) for s, e in events],
                     "staleness_s": stale}
    got = runs["registry"]
    summary = got["summary"]
    tops = [e["name"] for e in read_jsonl(os.path.join(
        tmp, "online-registry.jsonl")) if e["depth"] == 0]
    want = ["online/ingest", "online/update", "online/swap",
            "online/score"] * OBS_ONLINE_ROUNDS
    crit = {k: v for k, v in summary["metrics"]["counters"].items()
            if k.startswith("health/transitions") and "status=crit" in k}
    if tops != want or summary["obs"]["health"]["status"] != "ok" or crit:
        raise AssertionError(f"obs_full online: spans {tops}, health "
                             f"{summary['obs']['health']}, {crit}")
    return {way: {"update_ms_p50": statistics.median(r["update_ms"]),
                  "update_ms_all": r["update_ms"],
                  "staleness_s_p50": statistics.median(r["staleness_s"])}
            for way, r in runs.items()} | {
        "health": summary["obs"]["health"]["status"]}


def obs_fleet(setup, tmp):
    """Four dense D3CA tenants through the fleet CLI under ``--trace
    --metrics --health --min-tenants 2`` (each tenant given its f*): the
    fleet spans, ``fleet/rel_opt`` per tenant, the monitor OK."""
    trace = os.path.join(tmp, "fleet.json")
    argv = [*fleet_argv("d3ca", False), "--trace", trace, "--metrics",
            "--health", "--min-tenants", "2"]

    def tenants(args, **kw):
        return [dataclasses.replace(t, f_star=setup["f_star"][t.tenant_id])
                for t in fleet_tenants(False)]
    buf = io.StringIO()
    with patched(fleet_cli, "make_tenants", tenants), \
            contextlib.redirect_stdout(buf):
        summary = fleet_cli.run(fleet_cli.parse_args(argv))
    torch.cuda.synchronize()
    names = [e["name"] for e in read_jsonl(os.path.splitext(trace)[0]
                                           + ".jsonl")]
    count = {n: names.count(n) for n in ("fleet/pack", "fleet/step",
                                         "fleet/unpack")}
    gauges = summary["metrics"]["gauges"]
    rel = {k: v for k, v in gauges.items() if k.startswith("fleet/rel_opt")}
    if count != {"fleet/pack": 1, "fleet/step": OUTER_ITERS,
                 "fleet/unpack": OUTER_ITERS} \
            or len(rel) != FLEET_T_DENSE \
            or not all(np.isfinite(v) for v in rel.values()) \
            or summary["obs"]["health"]["status"] != "ok":
        raise AssertionError(f"obs_full fleet: spans {count}, rel_opt "
                             f"{rel}, health {summary['obs']['health']}")
    return {"spans": count, "rel_opt": rel,
            "solves_per_s": summary["solves_per_s"]}


def obs_serve(tmp):
    """Qwen3-1.7B (all 28 layers) through the serving CLI under
    ``--trace --health --flight-recorder``, the first OBS_SERVE_REQUESTS
    requests of ``serve_qwen3_full``'s mix, between two untraced runs of
    the same requests (the first one warms the process up; tok/s is
    compared with the second): a prefill span per request with 28 flash
    launches each, a finish instant per request, the first and last flash
    launch of the traced run against the plain version."""
    _, text, _ = run_serve(OBS_SERVE_ARGV)
    cold = serve_json(text)
    trace = os.path.join(tmp, "serve.json")
    bundle = os.path.join(tmp, "serve.bundle.json")
    per_prefill, keep = [], []

    def prefill(self, *args, **kw):
        n0 = flash_attention.launches
        out = real_prefill(self, *args, **kw)
        per_prefill.append(flash_attention.launches - n0)
        return out
    with patched(InferenceEngine, "_prefill", prefill) as real_prefill, \
            tap("flash_attention", first_last(keep),
                "repro_torch.models.attention"):
        outputs, text, wall = run_serve([*OBS_SERVE_ARGV, "--trace", trace,
                                         "--health", "--flight-recorder",
                                         bundle])
    traced = serve_json(text)
    _, text, _ = run_serve(OBS_SERVE_ARGV)
    plain = serve_json(text)
    with open(trace) as fh:
        evs = json.load(fh)["traceEvents"]
    prefills = sum(e["name"] == "prefill" and e["ph"] == "X" for e in evs)
    finishes = sum(e["name"] == "finish" and e["ph"] == "i" for e in evs)
    n = OBS_SERVE_REQUESTS
    if prefills != n or finishes != n or per_prefill != [28] * n \
            or traced["requests_finished"] != n:
        raise AssertionError(f"obs_full serve: {prefills} prefill spans, "
                             f"{finishes} finish instants, flash launches "
                             f"a prefill {per_prefill}")
    checked = []
    for which, (args, kw, out) in zip(("first", "last"), keep):
        err = compare(f"obs_full serve flash {which}", [out],
                      [flash_attention_plain(*args, **kw)],
                      FLASH_TOL[torch.bfloat16])
        checked.append({"max_abs_err": err, "shape": list(out.shape)})
    return {"tokens_per_sec_traced": traced["tokens_per_sec"],
            "tokens_per_sec_untraced": plain["tokens_per_sec"],
            "tokens_per_sec_untraced_cold": cold["tokens_per_sec"],
            "ttft_p50_s_traced": traced["ttft_s"]["p50"],
            "ttft_p50_s_untraced": plain["ttft_s"]["p50"],
            "prefill_spans": prefills, "finish_instants": finishes,
            "bundle_schema_ok": bool(load_bundle(bundle)),
            "checked_launches": checked, "wall_s": wall,
            "prefills": cold["prefills"] + traced["prefills"]
            + plain["prefills"]}


def phase_obs_full(setup):
    """The observability slice at full width, through the entry points a
    user calls (see the docstrings of the ``obs_*`` parts)."""
    t0 = time.perf_counter()
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        out["d3ca_cli"] = obs_d3ca_cli(setup, tmp)
        out["radisa_int8"] = obs_radisa_int8(setup)
        setup.pop("X"), setup.pop("y")
        gc.collect()
        torch.cuda.empty_cache()
        out["online"] = obs_online(tmp)
        out["fleet"] = obs_fleet(setup, tmp)
        gc.collect()
        torch.cuda.empty_cache()
        out["serve"] = obs_serve(tmp)
    emit("obs_full", **out, wall_s=time.perf_counter() - t0)
    gc.collect()
    torch.cuda.empty_cache()
    return {"sdca_epoch": sum(SDCA_SHAPE_LAUNCHES["obs_full"].values()),
            "svrg_inner": OUTER_ITERS + OBS_CALIB,
            "flash_attention": 28 * out["serve"]["prefills"]}


# ---------------------------------------------------------------------------
# mesh_full: the mesh engines, one process grid of P x Q ranks on the card
# ---------------------------------------------------------------------------

#: the reduction delay of the async and overlap solves
MESH_TAU = 2
#: async tau = 2's duality gap after OUTER_ITERS at Part 1, two-sided,
#: written before the first run: the delay rule emulated on the grid
#: engine at 1/5 and 1/10 of the Part 1 width (7 x 4) ended within 3 % of
#: the synchronous gap, which d3ca_full reads as 0.346
MESH_TAU2_GAP = (0.25, 0.45)
#: the mesh's iterates against the grid engine's, relative to the largest
#: entry (summation order: gloo's all-reduce against a blocked sum)
MESH_TOL = 1e-5
#: the ranks whose first and last B1 launch of each session are held
#: against the plain version on their own device: cells (0, 0), (6, 3)
MESH_TAPPED = (0, P * Q - 1)
MESH_TIMING_STEPS = 5
#: each gloo collective's support of a CUDA tensor, probed in a process of
#: its own (one rank)
GLOO_CUDA_PROBE = r"""
import datetime, json, torch, torch.distributed as dist
store = dist.TCPStore("127.0.0.1", 0, 1, is_master=True,
                      wait_for_workers=False)
dist.init_process_group("gloo", store=store, rank=0, world_size=1,
                        timeout=datetime.timedelta(seconds=60))
x = torch.ones(4, device="cuda")
calls = {
    "all_reduce": lambda: dist.all_reduce(x),
    "all_reduce_async": lambda: dist.all_reduce(x, async_op=True).wait(),
    "broadcast": lambda: dist.broadcast(x, 0),
    "all_gather": lambda: dist.all_gather([torch.empty_like(x)], x),
    "gather": lambda: dist.gather(x, [torch.empty_like(x)], dst=0)}
out = {}
for name, call in calls.items():
    try:
        call()
        torch.cuda.synchronize()
        out[name] = True
    except Exception as e:
        out[name] = f"{type(e).__name__}: {str(e)[:160]}"
print(json.dumps(out))
dist.destroy_process_group()
"""


@contextlib.contextmanager
def wire_clock(spent):
    """Host seconds this rank spends in the process wire: copying each
    payload to its pinned host buffer (a wait for the device: the
    context's turn on the card) and in each gloo all-reduce call (the
    dispatch alone when it is asynchronous); counts in ``spent``.
    Restored on exit."""
    from repro_torch.core import comm as comm_mod
    wire = comm_mod.ProcessWire
    to_host = wire.__dict__["_to_host"]            # the staticmethod
    all_reduce = comm_mod.dist.all_reduce

    def timed(fn, key):
        def call(*a, **kw):
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            spent[f"{key}_s"] += time.perf_counter() - t0
            spent[f"{key}_calls"] += 1
            return out
        return call
    spent.update(to_host_s=0.0, to_host_calls=0, all_reduce_s=0.0,
                 all_reduce_calls=0)
    wire._to_host = staticmethod(timed(to_host.__func__, "to_host"))
    comm_mod.dist.all_reduce = timed(all_reduce, "all_reduce")
    try:
        yield
    finally:
        wire._to_host = to_host
        comm_mod.dist.all_reduce = all_reduce


@contextlib.contextmanager
def mesh_rank_hook(rank):
    """The rank hook of mesh_full's grids (``ProcessGrid.rank_hook``): each
    rank's peak device memory in a session and its time in the wire
    (:func:`wire_clock`), and on the MESH_TAPPED ranks B1's first and last
    launch of the session held against the plain version on the rank's
    device (through :func:`tap`)."""
    report, keep = {"wire": {}}, []
    torch.cuda.reset_peak_memory_stats()
    watch = (tap("sdca_epoch", first_last(keep)) if rank in MESH_TAPPED
             else contextlib.nullcontext())
    with watch, wire_clock(report["wire"]):
        yield report
    torch.cuda.synchronize()
    report["peak_bytes"] = torch.cuda.max_memory_allocated()
    if keep:
        report["held"] = held_first_last(f"mesh rank {rank}", keep,
                                         sdca_epoch_plain)


def rel_err(a, b):
    """max |a - b| / max |b|."""
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def mesh_held(label, got, want, fields=("w", "alpha")):
    """A mesh solve's iterates against the grid engine's, MESH_TOL
    relative to the largest entry."""
    out = {}
    for f in fields:
        g, w = getattr(got, f), getattr(want, f)
        if g is None and w is None:
            continue
        if g.shape != w.shape or not torch.isfinite(g).all():
            raise AssertionError(f"{label}: bad {f} {tuple(g.shape)}")
        out[f] = rel_err(g, w)
        if out[f] > MESH_TOL:
            raise AssertionError(f"{label}: {f} is {out[f]:.3e} off the "
                                 f"grid engine's (relative to its largest "
                                 f"entry; tol {MESH_TOL})")
    return out


def mesh_cli(flags, grid=(P, Q), sparse=False, ref_epochs=0):
    """One mesh solve through the CLI's ``main`` on the card; returns its
    summary, history, the SolveResult the CLI got and the wall time."""
    if sparse:
        data = ["--dataset", "sparse", "--block-format", "sparse", "--n",
                str(N20), "--m", str(M20), "--density", str(DENS20),
                "--lam", str(LAM20)]
    else:
        data = ["--n", str(N), "--m", str(M), "--lam", str(LAM),
                "--ref-epochs", str(ref_epochs)]
    got = []
    real = Solver.solve

    def solve(self, *a, **kw):
        res = real(self, *a, **kw)
        got.append(res)
        return res
    err = io.StringIO()
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "mesh.json")
        t0 = time.perf_counter()
        with patched(Solver, "solve", solve), \
                contextlib.redirect_stderr(err):
            summary = optimize.main([*flags, "--mesh", f"{grid[0]}x{grid[1]}",
                                     *data, "--iters", str(OUTER_ITERS),
                                     "--json-out", out])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        with open(out) as fh:
            history = json.load(fh)["history"]
    sys.stderr.write(err.getvalue())
    if (summary["device"], summary["local_backend"], summary["iters"],
            len(got)) != ("cuda", "kernel", OUTER_ITERS, 1):
        raise AssertionError(f"mesh {flags}: {summary}")
    return summary, history, got[0], wall


def mps_active():
    """Whether the card runs an MPS server (its compute apps list one)."""
    apps = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid,process_name",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    return "mps-server" in apps


def grid_ms_per_iter(X, y, steps=MESH_TIMING_STEPS):
    """The grid engine's D3CA ms per outer iteration at Part 1, by the host
    clock around a step and a device wait, the median after a warm-up."""
    prog = get_solver("d3ca")().program("hinge", X, y, P=P, Q=Q,
                                        cfg=D3CAConfig(lam=LAM))
    state = prog.step(1, prog.state)
    torch.cuda.synchronize()
    ms = []
    for t in range(2, steps + 2):
        t0 = time.perf_counter()
        state = prog.step(t, state)
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(ms), ms


class DelayRule(SyncComm):
    """The bounded-staleness rule emulated in one process on the grid
    engine's blocked reductions: the value applied at step t is the one
    computed at step max(1, t - tau), looked up in the whole history of
    reductions (``past[name][s - 1]`` is step s's)."""

    def __init__(self, *a, tau, t, past, **kw):
        super().__init__(*a, **kw)
        self.tau, self.t, self.past = tau, t, past

    def _exec(self, point, value):
        self.past.setdefault(point.name, []).append(
            self._reduce(point, value))
        return self.past[point.name][max(1, self.t - self.tau) - 1]


def d3ca_delay_rule(X, y, tau):
    """Dense D3CA at Part 1 on the card's grid engine under
    :class:`DelayRule`, with the grid engine's own orders and kernels:
    what async tau's iterates must be, up to summation order."""
    cfg = D3CAConfig(lam=LAM, outer_iters=OUTER_ITERS)
    data = partition(X, y, P, Q, m_multiple=P * Q, device="cuda")
    source = GeneratorIndexSource(cfg.seed, P=P, Q=Q, n_p=data.n_p,
                                  device="cuda")
    prog = d3ca_cell_program(get_loss("hinge"), cfg, n=data.n,
                             index_source=source, m_q=data.m_q)
    gdata = (data.x_blocks, data.y_blocks, data.mask)
    state = (torch.zeros(P, data.n_p, device="cuda"),
             torch.zeros(Q, data.m_q, device="cuda"))
    past = {}
    for t in range(1, OUTER_ITERS + 1):
        comm = DelayRule(prog.schedule, {"data": P, "model": Q}, tau=tau,
                         t=t, past=past, device="cuda")
        state = prog.cell(comm, t, gdata, state)
        comm.finalize()
    return types.SimpleNamespace(
        w=data.w_from_blocks(state[1]),
        alpha=data.alpha_from_blocks(state[0] * data.mask))


def mesh_setup():
    """What mesh_full is held against, made before its counted window: the
    gloo probe (started now, read at the end), the 7 x 4 grid (its spawn),
    the grid engine's solves of the same problems on the card (and dense
    D3CA under the delay rule at tau = MESH_TAU), its ms per outer
    iteration, and one mesh program's block distribution (no step)."""
    t0 = time.perf_counter()
    probe = subprocess.Popen([sys.executable, "-c", GLOO_CUDA_PROBE],
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                             text=True)
    # fleet_mesh_full's 7 x 4 grid where it ran first (no second spawn)
    grid = process_grid(P, Q, device="cuda")
    grid.rank_hook = mesh_rank_hook
    if grid not in MESH_GRIDS:
        MESH_GRIDS.append(grid)
    # the arguments of the CLI's own call: DataMemo hands its solves these
    # arrays
    Xn, yn = make_svm_data(N, M, seed=0)
    X, y = torch.as_tensor(Xn, device="cuda"), torch.as_tensor(yn,
                                                                device="cuda")
    ref = {
        "d3ca": get_solver("d3ca")().solve(
            "hinge", X, y, P=P, Q=Q,
            cfg=D3CAConfig(lam=LAM, outer_iters=OUTER_ITERS)),
        "radisa": get_solver("radisa")().solve(
            "hinge", X, y, P=P, Q=Q,
            cfg=RADiSAConfig(lam=LAM, outer_iters=OUTER_ITERS)),
        "admm": get_solver("admm")().solve(
            "hinge", X, y, P=P, Q=Q,
            cfg=ADMMConfig(lam=LAM, rho=LAM, outer_iters=OUTER_ITERS))}
    csr, y20 = make_sparse_svm_csr(N20, M20, density=DENS20, seed=0)
    ref["d3ca_sparse"] = get_solver("d3ca")(block_format="sparse").solve(
        "hinge", csr, y20, P=P, Q=Q,
        cfg=D3CAConfig(lam=LAM20, outer_iters=OUTER_ITERS))
    ref["d3ca_async2"] = d3ca_delay_rule(X, y, MESH_TAU)
    tP, tQ, tN, tM = COMM_TOPO
    Xt, yt = make_svm_data(tN, tM, seed=0)
    ref["flat_4x2"] = get_solver("d3ca")().solve(
        "hinge", Xt, yt, P=tP, Q=tQ,
        cfg=D3CAConfig(lam=LAM, outer_iters=OUTER_ITERS))
    grid_ms, grid_steps = grid_ms_per_iter(X, y)
    torch.cuda.synchronize()
    # the blocks reach every rank's device: a program built, its
    # iterates gathered once (every rank holds its block), no step
    t1 = time.perf_counter()
    prog = get_solver("d3ca")(engine="shard_map").program(
        "hinge", X, y, P=P, Q=Q, cfg=D3CAConfig(lam=LAM))
    prog.w_of(prog.state)
    distribute_s = time.perf_counter() - t1
    prog.close()
    return {"grid": grid, "ref": ref, "X": X, "y": y, "Xt": Xt, "yt": yt,
            "probe": probe, "grid_ms": grid_ms, "grid_steps": grid_steps,
            "distribute_s": distribute_s, "setup_s": time.perf_counter() - t0}


def phase_mesh_full(setup):
    """The mesh engines at Part 1's full width: one process grid of 7 x 4
    ranks on the card (gloo, pinned host staging), D3CA through the CLI
    under ``--engine shard_map`` (f* on the controller), ``async`` at tau =
    0 (bitwise shard_map) and 2 (not bitwise shard_map, within MESH_TOL of
    the delay rule emulated on the grid engine, its gap in MESH_TAU2_GAP),
    ``overlap`` at tau = 2 (bitwise async), RADiSA, sparse D3CA on the news20 profile and
    ADMM, each held against the grid engine's solve within MESH_TOL;
    B1's first and last launch of ranks (0, 0) and (6, 3) against the
    plain version; ms per outer iteration between barriers beside the grid
    engine's, the exchange's share by the LocalComm calibration; then
    pods=2:identity at 4 x 2 against the flat solve."""
    t0 = time.perf_counter()
    grid, ref = setup["grid"], setup["ref"]
    out = {"grid": f"{P}x{Q}", "ranks": P * Q, "spawn_s": grid.spawn_s,
           "spawn_start_s": grid.start_s,
           "distribute_s": setup["distribute_s"],
           "setup_s": setup["setup_s"]}
    peaks, held = {}, {}

    def reports(label, tapped):
        """Each rank's report of the last session: its peak memory, and
        on a dense D3CA session the tapped ranks' held launches."""
        for r, rep in grid.reports.items():
            peaks[r] = max(peaks.get(r, 0), rep.get("peak_bytes", 0))
            if "held" in rep:
                held[f"{label} rank {r}"] = [h["rel_err"]
                                             for h in rep["held"]]
        got = sorted(r for r, rep in grid.reports.items() if "held" in rep)
        if len(grid.reports) != P * Q or \
                got != (sorted(MESH_TAPPED) if tapped else []):
            raise AssertionError(f"{label}: reports of ranks "
                                 f"{sorted(grid.reports)}, held on {got}")

    runs, walls = {}, {}
    for label, flags, kw in (
            ("d3ca", ["--engine", "shard_map"], dict(ref_epochs=REF_EPOCHS)),
            ("d3ca_async0", ["--engine", "async", "--staleness", "0"], {}),
            ("d3ca_async2", ["--engine", "async", "--staleness",
                             str(MESH_TAU)], {}),
            ("d3ca_overlap2", ["--engine", "overlap", "--staleness",
                               str(MESH_TAU)], {}),
            ("radisa", ["--solver", "radisa", "--engine", "shard_map"], {}),
            ("d3ca_sparse", ["--engine", "shard_map"], dict(sparse=True)),
            ("admm", ["--solver", "admm", "--engine", "shard_map"], {})):
        summary, history, res, walls[label] = mesh_cli(flags, **kw)
        runs[label] = (summary, history, res)
        reports(label, tapped=label in ("d3ca", "d3ca_async0",
                                        "d3ca_async2", "d3ca_overlap2"))
    err = {name: mesh_held(f"mesh {name}", runs[name][2], ref[name])
           for name in ("d3ca", "radisa", "d3ca_sparse", "admm")}
    if "rel_opt" not in runs["d3ca"][1][-1]:
        raise AssertionError("mesh d3ca: no f* through the CLI")
    sync, a0 = runs["d3ca"][2], runs["d3ca_async0"][2]
    a2, o2 = runs["d3ca_async2"][2], runs["d3ca_overlap2"][2]
    for label, (x, y_) in {"async tau 0 vs shard_map": (a0, sync),
                           f"overlap vs async tau {MESH_TAU}": (o2, a2)
                           }.items():
        if not (bitwise(x.w, y_.w) and bitwise(x.alpha, y_.alpha)):
            raise AssertionError(f"mesh d3ca: {label} is not bitwise")
    # the delay is real: tau = 2 is not the synchronous trajectory, and it
    # is the delay rule's
    if bitwise(a2.w, sync.w):
        raise AssertionError(f"mesh d3ca: async tau {MESH_TAU} is bitwise "
                             "shard_map: no reduction was delayed")
    err["d3ca_async2_vs_delay_rule"] = mesh_held(
        f"mesh d3ca async tau {MESH_TAU} against the delay rule", a2,
        ref["d3ca_async2"])
    gap2 = a2.history[-1]["duality_gap"]
    lo, hi = MESH_TAU2_GAP
    if not (lo <= gap2 <= hi and gap2 < a2.history[0]["duality_gap"]):
        raise AssertionError(f"mesh d3ca async tau {MESH_TAU}: gap {gap2} "
                             f"after {OUTER_ITERS} iterations (band {lo}, "
                             f"{hi})")
    for label, (summary, history, res) in runs.items():
        check_descent(f"mesh {label}", history,
                      dual=label.startswith("d3ca") and "async2" not in label
                      and "overlap" not in label)

    # ms per outer iteration between barriers, and the exchange's share by
    # the calibration against the LocalComm twin
    prog = get_solver("d3ca")(engine="shard_map").program(
        "hinge", setup["X"], setup["y"], P=P, Q=Q, cfg=D3CAConfig(lam=LAM))
    split = calibrate_phases(prog)
    state = prog.step(1, prog.state)
    grid.barrier()
    steps = []
    for t in range(2, MESH_TIMING_STEPS + 2):
        t1 = time.perf_counter()
        state = prog.step(t, state)
        grid.barrier()
        steps.append(1e3 * (time.perf_counter() - t1))
    prog.close()
    reports("d3ca_timing", tapped=True)
    # where a rank's exchange goes, over the calibration's 4 steps and the
    # 6 timed ones (2 all-reduces a step): mean ms a call, over the ranks
    wire = [rep["wire"] for rep in grid.reports.values()]
    out["wire_ms_per_call"] = {
        k: {"mean": 1e3 * statistics.mean(w[f"{k}_s"] / w[f"{k}_calls"]
                                          for w in wire),
            "max": 1e3 * max(w[f"{k}_s"] / w[f"{k}_calls"] for w in wire),
            "calls_per_rank": wire[0][f"{k}_calls"]}
        for k in ("to_host", "all_reduce")}
    free, total = torch.cuda.mem_get_info()
    out.update(
        ms_per_outer_iter={"mesh": statistics.median(steps),
                           "mesh_steps": steps, "grid": setup["grid_ms"],
                           "grid_steps": setup["grid_steps"],
                           "method": "host clock between grid barriers "
                                     "(grid engine: around a device wait), "
                                     f"median of {MESH_TIMING_STEPS} after "
                                     "a warm-up"},
        calibration={"step_s": split.step_s, "local_s": split.local_s,
                     "local_frac": split.local_frac,
                     "exchange_share": 1.0 - split.local_frac},
        card_total_bytes=total, card_used_bytes_with_grid=total - free,
        mps_active=mps_active())

    # pods=2:identity on Part 1 "4x2", against the flat solve
    close_grids()
    tP, tQ, tN, tM = COMM_TOPO
    t1 = time.perf_counter()
    g4 = process_grid(tP, tQ, device="cuda")
    g4.rank_hook = mesh_rank_hook
    MESH_GRIDS.append(g4)
    out["spawn_4x2_s"] = time.perf_counter() - t1
    pods = get_solver("d3ca")(engine="shard_map",
                              topology="pods=2:identity").solve(
        "hinge", setup["Xt"], setup["yt"], P=tP, Q=tQ,
        cfg=D3CAConfig(lam=LAM, outer_iters=OUTER_ITERS))
    err["pods=2:identity_4x2"] = mesh_held("mesh pods=2 4x2", pods,
                                           ref["flat_4x2"])
    held.update({f"pods rank {r}": [h["rel_err"] for h in rep["held"]]
                 for r, rep in g4.reports.items() if "held" in rep})
    # the 4 x 2 grid stays up: examples_full, next, runs the grid example
    # on it (no second spawn); the next phase with another grid closes it

    probe_out, probe_err = setup["probe"].communicate(timeout=120)
    try:
        gloo_cuda = json.loads(probe_out.strip().splitlines()[-1])
    except (ValueError, IndexError):
        gloo_cuda = {"probe_failed": probe_err[-400:]}
    out.update(
        rel_err=err, held_first_last=held,
        tau={"async0_bitwise_shard_map": True,
             f"overlap{MESH_TAU}_bitwise_async{MESH_TAU}": True,
             f"async{MESH_TAU}_bitwise_shard_map": False,
             f"async{MESH_TAU}_gap_last": gap2,
             f"async{MESH_TAU}_gap_band": list(MESH_TAU2_GAP),
             "shard_map_gap_last": sync.history[-1]["duality_gap"]},
        objective_last={k: v[0]["objective"] for k, v in runs.items()},
        wall_s_by_solve=walls,
        peak_bytes_by_rank=[peaks.get(r, 0) for r in range(P * Q)],
        gloo_cuda=gloo_cuda, wall_s=time.perf_counter() - t0)
    emit("mesh_full", **out)
    # 4 dense D3CA solves, the calibration and the timed steps on 28
    # ranks, the 4 x 2 solve on 8; f* on the controller; RADiSA and sparse
    # D3CA on 28 ranks
    return {"sdca_epoch": MESH_D3CA_CELLS + REF_EPOCHS,
            "svrg_inner": P * Q * OUTER_ITERS,
            "sdca_epoch_sparse": P * Q * OUTER_ITERS}


#: B1's launches on mesh_full's cells, summed over the ranks: 4 solves of
#: OUTER_ITERS, a calibration (OBS_CALIB) and a warm-up + the timed steps
#: on the 7 x 4 grid, one solve on the 4 x 2 grid
MESH_D3CA_CELLS = (P * Q * (4 * OUTER_ITERS + OBS_CALIB + 1
                            + MESH_TIMING_STEPS)
                   + COMM_TOPO[0] * COMM_TOPO[1] * OUTER_ITERS)


# ---------------------------------------------------------------------------
# fleet_mesh_full: the fleet, the online service and scoring on the mesh
# ---------------------------------------------------------------------------

#: the fleets of fleet_mesh_full: (sparse, solver, its kernel) -- the
#: fleet phases' configurations, on the 7 x 4 process grid, each for
#: FLEET_MESH_ITERS outer iterations, every tenant's objective checked at
#: every one (depth cut from 10 for the script's time limit: 0.8-1.4 s an
#: iteration in run BV, most of it the objective check)
FLEET_MESH = ((False, "d3ca", "sdca_epoch"), (False, "radisa", "svrg_inner"),
              (False, "admm", None), (True, "d3ca", "sdca_epoch_sparse"),
              (True, "radisa", "svrg_inner_sparse"))
FLEET_MESH_ITERS = 2
#: online_full's window and batches on the mesh, depth cut to these rounds
#: (cut from 5, then from 3 (35.8 s for 3 in run BV), to keep the script
#: inside its time limit)
FLEET_MESH_ROUNDS = 1
#: request rows a grid scoring call takes, and the calls timed
SCORE_ROWS, SCORE_CALLS = 4096, 3
#: the wrapper module core/local.py takes each solver kernel from
KERNEL_MODULES = {"sdca_epoch": "repro_torch.kernels.sdca",
                  "sdca_epoch_sparse": "repro_torch.kernels.sdca",
                  "svrg_inner": "repro_torch.kernels.svrg",
                  "svrg_inner_sparse": "repro_torch.kernels.svrg"}


@contextlib.contextmanager
def fleet_mesh_rank_hook(rank, hold=True):
    """The rank hook of fleet_mesh_full's grid: each rank's peak device
    memory in a session and, on the MESH_TAPPED ranks (``hold``: not in
    the set-up's reference solves), the first and last launch of every
    solver kernel the session made held against its plain version on the
    rank's device (a failing check fails the rank, and so the phase)."""
    report, keeps = {}, {name: [] for name in KERNEL_MODULES}
    torch.cuda.reset_peak_memory_stats()
    with contextlib.ExitStack() as taps:
        if hold and rank in MESH_TAPPED:
            for name, module in KERNEL_MODULES.items():
                taps.enter_context(tap(name, first_last(keeps[name]),
                                       module))
        yield report
    torch.cuda.synchronize()
    report["peak_bytes"] = torch.cuda.max_memory_allocated()
    report["held"] = {
        name: [h["rel_err"] for h in held_first_last(
            f"fleet_mesh rank {rank} {name}", keep, PLAINS[name])]
        for name, keep in keeps.items() if keep}


def fleet_mesh_key(sparse, solver):
    return solver + ("_sparse" if sparse else "")


def timed_steps(step, barrier, steps_ms):
    """``step`` that waits for a barrier of the grid (every rank's device
    done) after each outer step and appends the step's ms, by the host
    clock, to ``steps_ms``."""
    def timed(*args):
        t0 = time.perf_counter()
        out = step(*args)
        barrier()
        steps_ms.append(1e3 * (time.perf_counter() - t0))
        return out
    return timed


def step_ms(steps_ms):
    """The median ms of the timed steps after the first (a warm-up)."""
    return statistics.median(steps_ms[1:])


def fleet_mesh_setup():
    """What fleet_mesh_full is held against, made before its counted
    window: the 7 x 4 grid (its spawn), each fleet on the grid engine and
    its ms per outer iteration there, tenant 0's solo mesh solve (a
    program stepped FLEET_MESH_ITERS times, its steps timed as the fleet's),
    and the online stream of fleet_mesh_full on the grid engine (every
    version's w)."""
    t0 = time.perf_counter()
    grid = process_grid(P, Q, device="cuda")
    # the reference solves' peaks, without holds: the phase holds the
    # same kernels in its own sessions
    grid.rank_hook = functools.partial(fleet_mesh_rank_hook, hold=False)
    if grid not in MESH_GRIDS:
        MESH_GRIDS.append(grid)
    ref = {}
    for sparse, solver, _ in FLEET_MESH:
        t1 = time.perf_counter()
        problems = fleet_tenants(sparse)
        p0 = problems[0]
        bf = "sparse" if sparse else "dense"
        cfg = fleet_config(solver, LAM20 if sparse else LAM,
                           FLEET_MESH_ITERS)
        fleet = FleetSolver(solver=solver, block_format=bf)
        flat = fleet.solve_batch(problems, P=P, Q=Q, cfg=cfg,
                                 record_history=False)
        grid_fleet_ms = time_fleet(fleet.program(problems, P=P, Q=Q,
                                                 cfg=cfg))
        prog = get_solver(solver)(engine="shard_map", block_format=bf)\
            .program(p0.loss_name, p0.X, p0.y, mesh=grid,
                     cfg=solo_config(cfg, p0))
        steps, state = [], prog.state
        step = timed_steps(prog.step, grid.barrier, steps)
        for t in range(1, FLEET_MESH_ITERS + 1):
            state = step(t, state)
        solo = (prog.w_of(state),
                prog.alpha_of(state) if prog.alpha_of else None)
        prog.close()
        ref[fleet_mesh_key(sparse, solver)] = {
            "grid": [(r.w, r.alpha) for r in flat], "solo": solo,
            "grid_fleet_ms": grid_fleet_ms, "solo_mesh_ms": step_ms(steps),
            "solo_peaks": {r: rep["peak_bytes"]
                           for r, rep in grid.reports.items()},
            "setup_s": time.perf_counter() - t1}
        del flat, solo, prog, state
        gc.collect()
        torch.cuda.empty_cache()
    grid.rank_hook = fleet_mesh_rank_hook
    online = []
    run_online([*ONLINE_ARGV, "--rounds", str(FLEET_MESH_ROUNDS)],
               on_round=lambda r, svc, rec: online.append(
                   svc.book.current().w))
    gc.collect()
    torch.cuda.empty_cache()
    return {"grid": grid, "ref": ref, "online": online,
            "setup_s": time.perf_counter() - t0}


def fleet_mesh_reports(grid, label, peaks, held, kernel):
    """The last session's rank reports: peak memory per rank into
    ``peaks``, and the tapped ranks' held launches of ``kernel`` (which
    both tapped ranks must have made) into ``held``."""
    if len(grid.reports) != P * Q:
        raise AssertionError(f"{label}: reports of ranks "
                             f"{sorted(grid.reports)}")
    for r, rep in grid.reports.items():
        peaks[r] = max(peaks.get(r, 0), rep["peak_bytes"])
        for name, errs in rep["held"].items():
            held[f"{label} rank {r} {name}"] = errs
    tapped = sorted(r for r, rep in grid.reports.items()
                    if kernel in rep["held"])
    if kernel is not None and tapped != sorted(MESH_TAPPED):
        raise AssertionError(f"{label}: {kernel} held on ranks {tapped}")


def run_fleet_mesh(grid, sparse, solver, kernel, ref, peaks, held):
    """One fleet through the fleet CLI under ``--engine shard_map``: its
    launches summed over the ranks (one a rank per outer step for all the
    tenants), every tenant within MESH_TOL of the grid-engine fleet's,
    tenant 0 within MESH_TOL of its solo mesh solve.  Timed inside the
    CLI's run (``FleetSolver.program`` wrapped): the pack and the block
    distribution (the program built, then every rank's iterates gathered
    once, so every rank holds its blocks) and each outer step up to a
    barrier of the grid, beside the grid engine's fleet and T x the solo
    mesh step."""
    label = f"fleet_mesh {fleet_mesh_key(sparse, solver)}"
    times, steps = {}, []
    real_program = FleetSolver.program

    def program(self, *a, **kw):
        t0 = time.perf_counter()
        prog = real_program(self, *a, **kw)
        times["pack_s"] = time.perf_counter() - t0
        prog.unpack(prog.state)
        times["pack_and_distribution_s"] = time.perf_counter() - t0
        return dataclasses.replace(
            prog, step=timed_steps(prog.step, grid.barrier, steps))

    def snap():
        return (launch_counts(), {k: route_counts(k) for k in WRAPPERS},
                counts_by("sdca_epoch", "launches_by_cluster"))
    got = []
    c0, r0, g0 = snap()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), \
            patched(FleetSolver, "program", program):
        summary = fleet_cli.run(
            fleet_cli.parse_args([*fleet_argv(solver, sparse,
                                             FLEET_MESH_ITERS),
                                  "--engine", "shard_map"]),
            on_result=lambda p, r: got.append((p, r)))
    torch.cuda.synchronize()
    c1, r1, g1 = snap()
    T = FLEET_T_SPARSE if sparse else FLEET_T_DENSE
    if (summary["device"], summary["engine"], summary["local_backend"],
            len(got), summary["buckets"], len(steps)) != (
                "cuda", "shard_map", "kernel", T, 1, FLEET_MESH_ITERS):
        raise AssertionError(f"{label}: {summary}, {len(steps)} steps")
    want = {k: (P * Q * FLEET_MESH_ITERS if k == kernel else 0)
            for k in WRAPPERS}
    launched = {k: c1[k] - c0[k] for k in WRAPPERS}
    if launched != want:
        raise AssertionError(f"{label}: launches {launched}; expected "
                             f"{want}")
    if kernel is not None:
        main = MAIN_ROUTES[kernel]
        if r1[kernel][main] - r0[kernel][main] != want[kernel]:
            raise AssertionError(f"{label}: {kernel} by route {r1[kernel]}")
    if kernel == "sdca_epoch" and g1.get(1, 0) - g0.get(1, 0) != \
            want[kernel]:
        raise AssertionError(f"{label}: B1 by cluster size {g1}")
    fleet_mesh_reports(grid, label, peaks, held, kernel)
    errs = []
    for i, (p, res) in enumerate(got):
        hist = [h["objective"] for h in res.history]
        if len(hist) != FLEET_MESH_ITERS or not all(np.isfinite(hist)) \
                or not hist[-1] < hist[0]:
            raise AssertionError(f"{label} {p.tenant_id}: objective {hist}")
        errs.append(mesh_held(f"{label} {p.tenant_id} against the grid "
                              "engine's fleet", res, types.SimpleNamespace(
                                  w=ref["grid"][i][0],
                                  alpha=ref["grid"][i][1])))
    solo_err = mesh_held(f"{label} tenant 0 against its solo mesh solve",
                         got[0][1], types.SimpleNamespace(
                             w=ref["solo"][0], alpha=ref["solo"][1]))
    return {"tenants": T, "rel_err_vs_grid_fleet": errs,
            "tenant0_rel_err_vs_solo_mesh": solo_err,
            "launches": launched[kernel] if kernel else 0,
            "solves_per_s": summary["solves_per_s"],
            "solve_wall_s": summary["total_s"],
            "objective_last": [r.history[-1]["objective"] for _, r in got],
            **times, "ms_per_outer_iter": step_ms(steps),
            "steps_ms": steps, "grid_engine_fleet_ms": ref["grid_fleet_ms"],
            "solo_mesh_ms": ref["solo_mesh_ms"],
            "T_x_solo_mesh_ms": T * ref["solo_mesh_ms"],
            "setup_s": ref["setup_s"]}


def phase_fleet_mesh_full(setup):
    """The fleet, the online service and scoring on the mesh at full width:
    one process grid of 7 x 4 ranks on the card.  The fleets of
    fleet_dense_full (T = 4 Part 1 tenants: D3CA, RADiSA, ADMM with rho =
    lambda) and fleet_sparse_full (T = 2 news20 tenants: D3CA, RADiSA)
    through the fleet CLI under ``--engine shard_map`` for FLEET_MESH_ITERS
    outer iterations: one launch a rank an outer step for all the tenants
    (28 x 2 a solver, summed from the ranks), every tenant within
    MESH_TOL of the same tenant of the grid-engine fleet, tenant 0 within
    MESH_TOL of its solo mesh solve,
    the first and last launch of each kernel on ranks (0, 0) and (6, 3)
    against its plain version; each fleet's pack and block distribution
    and ms per outer iteration beside the grid engine's fleet and T x the
    solo mesh step.  Then the online CLI under ``--engine shard_map`` at
    online_full's window for FLEET_MESH_ROUNDS rounds, its scorer on the
    grid: every version's w within MESH_TOL of the same stream on the
    grid engine, the duals outside each batch unmoved, the update's ms
    and the share of it that partitions the window and hands the blocks
    to the ranks; the grid scorer's margins within 1e-5 of X @ w on the
    card (relative to the largest), its rows/s against one device's."""
    t0 = time.perf_counter()
    grid, ref = setup["grid"], setup["ref"]
    peaks, held, fleets = {}, {}, {}
    for sparse, solver, kernel in FLEET_MESH:
        key = fleet_mesh_key(sparse, solver)
        fleets[key] = run_fleet_mesh(grid, sparse, solver, kernel, ref[key],
                                     peaks, held)
        gc.collect()
        torch.cuda.empty_cache()
    fleet_tenants.cache_clear()

    # the online service on the mesh, its scorer on the grid
    state, rounds, update_s, program_s = {}, [], [], []

    def on_start(svc):
        state["svc"] = svc
        state["alpha"] = svc.book.current().alpha
        solver, real_update = svc.solver, svc.solver.update
        real_program = solver.program

        def update(*a, **kw):
            t1 = time.perf_counter()
            res = real_update(*a, **kw)
            update_s.append(time.perf_counter() - t1)
            return res

        def program(*a, **kw):
            t1 = time.perf_counter()
            prog = real_program(*a, **kw)
            program_s.append(time.perf_counter() - t1)
            return prog
        solver.update, solver.program = update, program

    def on_round(r, svc, rec):
        cur = svc.book.current()
        rows = torch.from_numpy((r * ONLINE_BATCH + np.arange(ONLINE_BATCH))
                                % N).to(svc.device)
        off = torch.ones(N, dtype=torch.bool, device=svc.device)
        off[rows] = False
        if cur.version != r + 1 or not torch.equal(cur.alpha[off],
                                                   state["alpha"][off]):
            raise AssertionError(f"fleet_mesh online round {r}: version "
                                 f"{cur.version}, or a dual outside the "
                                 "batch's rows moved")
        err = rel_err(cur.w, setup["online"][r])
        if not (torch.isfinite(cur.w).all() and err <= MESH_TOL):
            raise AssertionError(f"fleet_mesh online round {r}: w is "
                                 f"{err:.3e} off the grid engine's stream")
        rounds.append({"version": cur.version, "rel_err_w": err,
                       "f": rec["f"], "acc": rec["acc"]})
        state["alpha"] = cur.alpha
        fleet_mesh_reports(grid, f"fleet_mesh online round {r}", peaks,
                           held, "sdca_epoch")

    c0 = launch_counts()["sdca_epoch"]
    t1 = time.perf_counter()
    summary = run_online([*ONLINE_ARGV, "--rounds", str(FLEET_MESH_ROUNDS),
                          "--engine", "shard_map"], on_start, on_round)
    online_wall = time.perf_counter() - t1
    want = P * Q * FLEET_MESH_ROUNDS * (ONLINE_PASSES + OBS_CALIB)
    online_launches = launch_counts()["sdca_epoch"] - c0
    if online_launches != want or summary["engine"] != "shard_map":
        raise AssertionError(f"fleet_mesh online: {online_launches} B1 "
                             f"launches (expected {want}); {summary}")
    svc = state.pop("svc")
    if svc.scorer.mesh is not grid:
        raise AssertionError("fleet_mesh online: the scorer is not on the "
                             "grid")
    # the grid scorer against X @ w on the card, and against one device
    gen = torch.Generator(device="cuda")
    gen.manual_seed(7)
    Xs = torch.randn(SCORE_ROWS, M, device="cuda", generator=gen)
    w = svc.scorer.w
    margins = torch.from_numpy(svc.scorer.score(Xs))
    score_err = rel_err(margins, (Xs @ w).cpu())
    if score_err > 1e-5:
        raise AssertionError(f"fleet_mesh scoring: margins {score_err:.3e} "
                             "off X @ w (relative to the largest)")
    one = LinearScorer(w, loss="hinge")
    one.score(Xs)
    rates = {}
    for label, sc in (("grid", svc.scorer), ("one_device", one)):
        t1 = time.perf_counter()
        for _ in range(SCORE_CALLS):
            sc.score(Xs)
        rates[label] = SCORE_CALLS * SCORE_ROWS / (time.perf_counter() - t1)
    del svc, Xs, one, margins
    gc.collect()
    torch.cuda.empty_cache()
    emit("fleet_mesh_full", grid=f"{P}x{Q}", ranks=P * Q,
         spawn_s=grid.spawn_s, setup_s=setup["setup_s"], fleets=fleets,
         held_first_last=held,
         peak_bytes_by_rank=[peaks.get(r, 0) for r in range(P * Q)],
         solo_mesh_peak_bytes_by_rank={k: [v["solo_peaks"].get(r, 0)
                                           for r in range(P * Q)]
                                       for k, v in ref.items()},
         online={"rounds": rounds, "launches": online_launches,
                 "update_s": {"p50": statistics.median(update_s),
                              "all": update_s},
                 "partition_and_handoff_s": {
                     "p50": statistics.median(program_s),
                     "all": program_s},
                 "wall_s": online_wall},
         scoring={"rows": SCORE_ROWS, "rel_err": score_err,
                  "rows_per_s": rates},
         wall_s=time.perf_counter() - t0)
    # the 7 x 4 grid stays up, its ranks' cached memory released: mesh_full,
    # next, runs on it
    grid.call("chip_smoke:_rank_release", mesh=None)
    per_fleet = P * Q * FLEET_MESH_ITERS
    return {"sdca_epoch": per_fleet + want, "svrg_inner": per_fleet,
            "sdca_epoch_sparse": per_fleet, "svrg_inner_sparse": per_fleet}


#: B1's main-path shapes by the cluster size their launches take (counted
#: by the wrapper where it launches): 1 CTA a D3CA cell, 16 a serial epoch
# ---------------------------------------------------------------------------
# LM training over a (data, model) grid of ranks sharing the card
# ---------------------------------------------------------------------------

#: Qwen3-1.7B at full width on a 2 x 2 (data, model) grid, at
#: MESH_TRAIN_DEPTH of its 28 layers: MESH_TRAIN_STEPS steps, then the
#: training CLI with --mesh 2,2 at MESH_TRAIN_CLI_DEPTH layers (a step and
#: a checkpoint) and --resume on one device.  Depth cut for the script's
#: time limit: at 28 layers a step took 19.7 s (NVIDIA H100 80GB HBM3,
#: 700.00 W): gloo moves every view through host memory.
MESH_TRAIN_GRID = (2, 2)
MESH_TRAIN_DEPTH, MESH_TRAIN_STEPS = 4, 2
MESH_TRAIN_CLI_DEPTH = 2
#: the grid's float32 first step (before the counted window: float32 B5
#: calls take the ``simt`` route) at MESH_TRAIN_F32_DEPTH layers
MESH_TRAIN_F32_DEPTH = 2
#: the grid's first step against the one-device step from the same
#: weights, by compute dtype: the relative error of the loss and of the
#: gradient norm, and the share of parameter entries whose first AdamW
#: step went another way than one device's (they differ by more than the
#: step's rate: a gradient entry near zero whose sign rounding decided),
#: over all entries and in the worst leaf -- each at most its limit.  In
#: bfloat16 the 2-way model split rounds the partial products of wo and
#: w_down before their sum where one device rounds the sum once; in
#: float32 only the order of sums differs.  Each limit lies between the
#: sound grid's reading and the least reading of the planted faults of
#: ``tools/mesh_train_faults.py`` (a skipped data-axis reduce-scatter, a
#: wrong KV head pick), both taken on the card (NVIDIA H100 80GB HBM3,
#: 700.00 W; PERF.md, section 6): bf16 sound 2.6e-5 / 1.2e-5 / 9.4e-4 /
#: 7.8e-3, the faults' least 5.3e-4 (the KV pick; a skipped reduce-scatter
#: leaves the forward's loss as it is) / 1.1e-3 / 0.15 / 0.25; float32
#: sound 7.8e-8 / 0 / 0 / 0, the faults' least 1.2e-3 / 3.6e-4 / 0.13 /
#: 0.27
MESH_TRAIN_LIMITS = {
    "bfloat16": {"loss": 1e-4, "grad_norm": 1e-4, "share": 0.01,
                 "worst_leaf_share": 0.05},
    "float32": {"loss": 1e-5, "grad_norm": 1e-5, "share": 1e-4,
                "worst_leaf_share": 1e-3}}


def mesh_train_opt():
    return AdamWConfig(lr=warmup_cosine(3e-3, 20, MESH_TRAIN_STEPS))


def host_leaves(params):
    return [t.detach().to("cpu", copy=True) for t in
            tree_leaves_sorted(params)]


def flip_share(got, want, rate):
    """Share of entries (and the worst leaf's) differing by more than
    ``rate``, and the largest difference (host leaves compared on the
    card, a leaf at a time)."""
    n = flips = 0
    worst, big = 0.0, 0.0
    for g, w in zip(got, want):
        d = (g.to("cuda").float() - w.to("cuda").float()).abs()
        f = int((d > rate).sum())
        n += d.numel()
        flips += f
        worst = max(worst, f / d.numel())
        big = max(big, float(d.max()))
    return {"share": flips / n, "worst_leaf_share": worst,
            "max_abs_diff": big}


def one_device_first_steps(cfg, batch, control=True):
    """The one-device first step from init(0) (B5's kernel) and, with
    ``control``, its control (B5's plain version: a correct attention
    that rounds otherwise): loss, gradient norm and the parameters after
    the step (host memory; the control's compared at once)."""
    model = Transformer(cfg, device=torch.device("cuda"))
    out = {}
    runs = (("one", None), ("control", plain_flash))[:2 if control else 1]
    for name, attn in runs:
        params = model.init(0)
        opt = adamw_init(params)
        with contextlib.ExitStack() as stack:
            if attn is not None:
                stack.enter_context(patched(lm_attention, "flash_attention",
                                            attn))
            params, opt, m = make_train_step(model, mesh_train_opt())(
                params, opt, batch)
        out[name] = {"loss": float(m["loss"]),
                     "grad_norm": float(m["grad_norm"]),
                     "params": host_leaves(params)}
        del params, opt
        gc.collect()
        torch.cuda.empty_cache()
    if control:
        out["control"]["flips"] = flip_share(out["control"].pop("params"),
                                             out["one"]["params"],
                                             float(mesh_train_opt().lr(1)))
    return out


def held_first_step(got, one, control, limits):
    """The grid's first step (loss, gradient norm, parameters) against the
    one-device step, the control's distances beside (None: no control);
    ``over``: the readings above their ``limits``."""
    rate = float(mesh_train_opt().lr(1))

    def rel(a, b):
        return abs(a - b) / b
    held = {"loss": rel(got["loss"], one["loss"]),
            "grad_norm": rel(got["grad_norm"], one["grad_norm"]),
            **flip_share(got["params"], one["params"], rate)}
    held["control"] = control and {
        "loss": rel(control["loss"], one["loss"]),
        "grad_norm": rel(control["grad_norm"], one["grad_norm"]),
        **control["flips"]}
    held.update(rate=rate, limits=limits,
                over=sorted(k for k, v in limits.items() if held[k] > v))
    return held


def held_linattn(record):
    """B6 as the model calls it (the kernel), each call's output also held
    against the plain version (the exact recurrence) on the same inputs:
    (max abs error, its share of LINATTN_TOL times the plain output's
    largest entry) appended to ``record``.  The plain version launches
    nothing."""
    def call(r, k, v, logw, u, *, chunk=64):
        out, state = rwkv_linattn(r, k, v, logw, u, chunk=chunk)
        with torch.no_grad():
            want, _ = rwkv_linattn_ref(r.float(), k.float(), v.float(),
                                       logw.float(), u.float())
            err = (out.float() - want).abs().max()
            record.append((err, err / (LINATTN_TOL * want.abs().max())
                           .clamp_min(1e-30)))
        return out, state
    return call


#: where a rank's LM kernels are reached, and their holding wrappers
HELD = {"flash_attention": (lm_attention, "flash_attention", held_flash),
        "rwkv_linattn": (lm_rwkv, "rwkv_linattn", held_linattn)}


def _rank_hold(ctx, mesh, on: bool, kernel="flash_attention"):
    """On a rank: from ``on``, every call of ``kernel`` (B5 or B6) held
    against its plain version (``HELD``); then (``on`` False) the calls
    put back and every rank's (calls, max abs error, worst share of its
    limit) gathered to rank 0."""
    owner, attr, wrap = HELD[kernel]
    if on:
        calls = []
        ctx.resident["held"] = (calls, getattr(owner, attr))
        setattr(owner, attr, wrap(calls))
        return None
    calls, real = ctx.resident.pop("held")
    setattr(owner, attr, real)
    mine = [len(calls), 0.0, 0.0]
    if calls:
        errs, ratios = (torch.stack(c) for c in zip(*calls))
        mine[1:] = float(errs.max()), float(ratios.max())
    got = ([None] * torch.distributed.get_world_size() if ctx.rank == 0
           else None)
    torch.distributed.gather_object(mine, got, dst=0)
    return got


def _rank_release(ctx, mesh):
    """On a rank: its cached free device memory released to the card."""
    gc.collect()
    torch.cuda.empty_cache()


def grid_steps(cfg, steps, hold_flash=False):
    """``steps`` steps of Qwen3 at ``cfg`` on the grid from init(0), on the
    CLI's batches: each step's loss, gradient norm, seconds and wire bytes
    (checked against ``mesh_train.wire_bytes``), the parameters after the
    first (host memory), the ranks' peaks and attention heads; with
    ``hold_flash``, every rank's B5 calls of the first step held against
    the plain version (``rank_flash``)."""
    mesh = make_mesh(MESH_TRAIN_GRID, ("data", "model"))
    model = Transformer(cfg, device=torch.device("cuda"), mesh=mesh)
    t0 = time.perf_counter()
    params, opt = mesh_train.init_on_mesh(model, 0)
    gc.collect()
    torch.cuda.empty_cache()
    out = {"init_s": time.perf_counter() - t0, "hist": []}
    mesh_train.memory_peaks(mesh, reset=True)
    step = make_train_step(model, mesh_train_opt())
    want = mesh_train.wire_bytes(model, TRAIN_BATCH, TRAIN_SEQ)
    hold = "chip_smoke:_rank_hold"
    for s in range(steps):
        batch = synthetic_lm_batch(cfg, s, batch=TRAIN_BATCH, seq=TRAIN_SEQ)
        if hold_flash and s == 0:
            resident.call(mesh, hold, on=True)
        t1 = time.perf_counter()
        params, opt, m = step(params, opt, batch)
        out["hist"].append({"loss": float(m["loss"]),
                            "grad_norm": float(m["grad_norm"]),
                            "time_s": time.perf_counter() - t1})
        if hold_flash and s == 0:
            out["rank_flash"] = resident.call(mesh, hold, on=False)
        if step.last["wire"] != want:
            raise AssertionError(f"train_mesh_full: step {s} wire bytes "
                                 f"{step.last['wire']}, counted from the "
                                 f"specs {want}")
        if s == 0:
            t1 = time.perf_counter()
            out["first_params"] = [torch.from_numpy(a) for a in
                                   tree_leaves_sorted(
                                       resident.gather_tree(params))]
            out["gather_s"] = time.perf_counter() - t1
    out.update(wire=want, peaks=mesh_train.memory_peaks(mesh, reset=True),
               heads=mesh_train.attention_heads(model))
    resident.free(params)
    resident.free(opt)
    return out


def grid_first_step(cfg, one_device, dtype):
    """The grid's first step at ``cfg`` held against ``one_device`` (from
    :func:`one_device_first_steps`) at ``MESH_TRAIN_LIMITS[dtype]``, with
    the seconds of its init, step and gather."""
    run = grid_steps(cfg, 1)
    held = held_first_step({**run["hist"][0],
                            "params": run.pop("first_params")},
                           one_device["one"], one_device.get("control"),
                           MESH_TRAIN_LIMITS[dtype])
    held["grid_s"] = {"init": run["init_s"], "step": run["hist"][0]["time_s"],
                      "gather": run["gather_s"]}
    return held


def mesh_train_setup():
    """Before the counted window: the 2 x 2 grid's spawn; the float32
    first step at MESH_TRAIN_F32_DEPTH layers on one device and on the
    grid, held (float32 B5 calls take the ``simt`` route, so not on the
    main path; no control: in float32 the grid reads one device's step
    but for the order of its sums); the one-device bf16 first step at
    MESH_TRAIN_DEPTH layers and its control, to host memory."""
    t0 = time.perf_counter()
    close_grids()
    grid = process_grid(*MESH_TRAIN_GRID, device="cuda")
    MESH_GRIDS.append(grid)
    spawn_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cfg32 = family_config("qwen3-1.7b", MESH_TRAIN_F32_DEPTH,
                          compute_dtype="float32")
    f32 = one_device_first_steps(cfg32, synthetic_lm_batch(
        cfg32, 0, batch=TRAIN_BATCH, seq=TRAIN_SEQ), control=False)
    one_device32_s = time.perf_counter() - t0
    held32 = grid_first_step(cfg32, f32, "float32")
    held32["one_device_s"] = one_device32_s
    del f32
    f32_s = time.perf_counter() - t0
    cfg = family_config("qwen3-1.7b", MESH_TRAIN_DEPTH)
    batch = synthetic_lm_batch(cfg, 0, batch=TRAIN_BATCH, seq=TRAIN_SEQ)
    t0 = time.perf_counter()
    bf16 = one_device_first_steps(cfg, batch)
    return {"cfg": cfg, **bf16, "one_device_s": time.perf_counter() - t0,
            "spawn_s": spawn_s, "float32": held32, "float32_s": f32_s,
            "n_params": sum(t.numel() for t in bf16["one"]["params"])}


def phase_train_mesh_full(setup):
    """Qwen3-1.7B at full width trained over the 2 x 2 (data, model) grid
    of ranks on the card (``make_train_step`` on a sharded model): the
    first step against the one-device step of the set-up (loss, gradient
    norm, every parameter; the control beside) and every rank's B5 calls
    of it against the plain version on their own q / k / v, step s and
    tokens/s, each rank's peak memory against its share of the four
    float32 copies, the wire bytes of every step against the count made
    from the specs, every rank's attention on H / M = 8 query heads; then
    the training CLI with --mesh 2,2 (a checkpoint in TRAIN_CKPT_ROOT) and
    --resume on one device, whose restored parameters must be the grid's,
    bitwise.  Every B5 call is counted on the ranks (``worker_launches``):
    a rank runs its 4 rows as 4 microbatch pieces, each launching B5 twice
    a layer (forward and recompute).  The set-up's float32 first step is
    judged here too."""
    cfg = setup["cfg"]
    world = math.prod(MESH_TRAIN_GRID)
    run = grid_steps(cfg, MESH_TRAIN_STEPS, hold_flash=True)
    if run["heads"] != [(cfg.n_heads // 2, cfg.n_kv // 2)] * world:
        raise AssertionError(f"train_mesh_full: ranks' attention heads "
                             f"{run['heads']}")
    acc = _largest_divisor_leq(TRAIN_BATCH, cfg.train_accum)
    pieces = len(mesh_train.pieces(TRAIN_BATCH // MESH_TRAIN_GRID[0], 0, acc,
                                   TRAIN_BATCH // acc))
    held = held_first_step({**run["hist"][0],
                            "params": run.pop("first_params")},
                           setup["one"], setup["control"],
                           MESH_TRAIN_LIMITS["bfloat16"])
    del setup["one"]["params"]
    # each rank: a forward and a recompute a layer of each of its pieces
    rank_flash = {"calls": [c for c, _, _ in run["rank_flash"]],
                  "max_abs_err": max(e for _, e, _ in run["rank_flash"]),
                  "row_ratio": max(r for _, _, r in run["rank_flash"]),
                  "tol": FLASH_TOL[torch.bfloat16]}
    flash_bad = (rank_flash["calls"] != [2 * pieces * cfg.n_layers] * world
                 or rank_flash["row_ratio"] > 1.0)

    # the CLI: --mesh 2,2 with a checkpoint, --resume on one device
    cli_cfg = family_config("qwen3-1.7b", MESH_TRAIN_CLI_DEPTH)
    ckpt = tempfile.mkdtemp(prefix="mesh_ckpt_", dir=TRAIN_CKPT_ROOT)
    seen = []

    class Seen(train_cli.Trainer):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            seen.append(self)

        def restore(self, shardings=None):
            step = super().restore(shardings)
            self.restored = host_leaves(self.params)
            return step
    argv = ["--arch", "qwen3-1.7b", "--batch", str(TRAIN_BATCH), "--seq",
            str(TRAIN_SEQ), "--ckpt-dir", ckpt, "--ckpt-every", "1000",
            "--steps", "1"]
    try:
        walls = []
        with contextlib.redirect_stdout(io.StringIO()), \
                patched(train_cli, "get_config", lambda a: cli_cfg), \
                patched(train_cli, "Trainer", Seen):
            for extra in (["--mesh", "2,2"], ["--resume"]):
                t1 = time.perf_counter()
                hist = train_cli.main(argv + extra)
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t1, hist))
                if len(seen) == 1:
                    saved = [torch.from_numpy(a) for a in tree_leaves_sorted(
                        resident.gather_tree(seen[0].params))]
                    resident.free(seen[0].params)
                    resident.free(seen[0].opt_state)
                gc.collect()
                torch.cuda.empty_cache()
        ckpt_bytes = sum(os.path.getsize(os.path.join(b, f))
                         for b, _, fs in os.walk(ckpt) for f in fs)
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    same = all(torch.equal(a, b) for a, b in zip(saved, seen[1].restored))
    steps = [h["step"] for _, hist in walls for h in hist]
    if not same or steps != [0, 1]:
        raise AssertionError(f"train_mesh_full: CLI steps {steps}, restored "
                             f"parameters equal to the grid's: {same}")
    del saved, seen

    reckoned = 16 * setup["n_params"] / world
    step_s = statistics.median(h["time_s"] for h in run["hist"][1:])
    emit("train_mesh_full", arch="qwen3-1.7b", grid=list(MESH_TRAIN_GRID),
         batch=TRAIN_BATCH, seq=TRAIN_SEQ, microbatches=acc,
         pieces_per_rank=pieces, layers=cfg.n_layers,
         full_layers=get_config("qwen3-1.7b").n_layers,
         n_params=setup["n_params"],
         one_device_steps_s=setup["one_device_s"], spawn_s=setup["spawn_s"],
         init_s=run["init_s"], first_step_gather_s=run["gather_s"],
         step_ms=1e3 * step_s, tokens_per_sec=TRAIN_BATCH * TRAIN_SEQ
         / step_s, step_ms_each=[1e3 * h["time_s"] for h in run["hist"]],
         losses=[h["loss"] for h in run["hist"]],
         grad_norms=[h["grad_norm"] for h in run["hist"]],
         peak_bytes=run["peaks"], share_bytes=reckoned,
         peak_over_share=[p / reckoned for p in run["peaks"]],
         wire_bytes_per_step=run["wire"], rank_heads=run["heads"],
         first_step=held, rank_flash=rank_flash,
         float32_first_step={**setup["float32"],
                             "layers": MESH_TRAIN_F32_DEPTH,
                             "seconds": setup["float32_s"]},
         cli={"layers": cli_cfg.n_layers, "steps": steps,
              "wall_s": [w for w, _ in walls], "ckpt_bytes": ckpt_bytes,
              "restored_equal": same})
    if held["over"] or setup["float32"]["over"] or flash_bad:
        raise AssertionError(
            "train_mesh_full: the grid's first step is not the one-device "
            f"step: bfloat16 {held}, float32 {setup['float32']}, the ranks' "
            f"B5 calls {rank_flash}")
    return {"flash_attention": 2 * world * pieces * (
        cfg.n_layers * MESH_TRAIN_STEPS + cli_cfg.n_layers)
            + 2 * acc * cli_cfg.n_layers}


#: the other families at full width on train_mesh_full's 2 x 2 grid: arch,
#: depth, the kernel its layers launch.  Mixtral-8x7B at 1 of 32 layers
#: (E = 8 over M = 2: 4 experts a rank; B5 on 16 of 32 query, 4 of 8 KV
#: heads), RWKV6-3B at 2 of 32 (B6 on 20 of 40 heads), MusicGen-large at 4
#: of 48 (frame embeddings; B5 on 16 of 32 heads): a rank's share of
#: the four float32 copies of each, 16 bytes a parameter over 4 ranks,
#: lies on the one card beside the others' views (PERF.md, section 7:
#: RecurrentGemma-9B and Llama-3.2-Vision-90B do not fit)
MESH_FAMILIES = (("mixtral-8x7b", 1, "flash_attention"),
                 ("rwkv6-3b", 2, "rwkv_linattn"),
                 ("musicgen-large", 4, "flash_attention"))
MESH_FAMILY_STEPS = 2


def mesh_families_setup():
    """Before the counted window, on train_mesh_full's 2 x 2 grid (spawned
    here when that phase did not run): each family's float32 first step
    on one device and on the grid from init(0), held at
    MESH_TRAIN_LIMITS["float32"] (float32 B5 calls take the ``simt``
    route, so not on the main path; Mixtral's routing flips under bf16
    rounding, so every family is held in float32).  The grid's parameters
    and AdamW state after that step stay on the ranks for the counted
    steps."""
    t0 = time.perf_counter()
    grid = process_grid(*MESH_TRAIN_GRID, device="cuda")
    if grid not in MESH_GRIDS:
        MESH_GRIDS.append(grid)
    mesh = make_mesh(MESH_TRAIN_GRID, ("data", "model"))
    resident.call(mesh, "chip_smoke:_rank_release")
    out = {"mesh": mesh, "grid_s": time.perf_counter() - t0, "families": {}}
    for arch, depth, _ in MESH_FAMILIES:
        t0 = time.perf_counter()
        cfg32 = family_config(arch, depth, compute_dtype="float32")
        batch = synthetic_lm_batch(cfg32, 0, batch=TRAIN_BATCH,
                                   seq=TRAIN_SEQ)
        one = one_device_first_steps(cfg32, batch, control=False)
        one_s = time.perf_counter() - t0
        model = Transformer(cfg32, device=torch.device("cuda"), mesh=mesh)
        t1 = time.perf_counter()
        params, opt = mesh_train.init_on_mesh(model, 0)
        gc.collect()
        torch.cuda.empty_cache()
        init_s = time.perf_counter() - t1
        step = make_train_step(model, mesh_train_opt())
        t1 = time.perf_counter()
        params, opt, m = step(params, opt, batch)
        step_s = time.perf_counter() - t1
        want = mesh_train.wire_bytes(model, TRAIN_BATCH, TRAIN_SEQ)
        if step.last["wire"] != want:
            raise AssertionError(f"train_mesh_families_full: {arch} float32 "
                                 f"step wire bytes {step.last['wire']}, "
                                 f"counted from the specs {want}")
        t1 = time.perf_counter()
        first = [torch.from_numpy(a) for a in
                 tree_leaves_sorted(resident.gather_tree(params))]
        gather_s = time.perf_counter() - t1
        held = held_first_step({"loss": float(m["loss"]),
                                "grad_norm": float(m["grad_norm"]),
                                "params": first}, one["one"], None,
                               MESH_TRAIN_LIMITS["float32"])
        n_params = sum(t.numel() for t in first)
        del one, first
        resident.call(mesh, "chip_smoke:_rank_release")
        gc.collect()
        torch.cuda.empty_cache()
        held.update(layers=depth, seconds={
            "one_device": one_s, "init": init_s, "step": step_s,
            "gather": gather_s, "all": time.perf_counter() - t0})
        out["families"][arch] = {"params": params, "opt": opt,
                                 "n_params": n_params, "float32": held}
    return out


def phase_train_mesh_families_full(setup):
    """Mixtral-8x7B (1 layer), RWKV6-3B (2) and MusicGen-large (4) at full
    width trained over train_mesh_full's 2 x 2 (data, model) grid
    (``make_train_step`` on a sharded model, bf16, batch 8 x 128 in 8
    microbatches: 4 pieces a rank): MESH_FAMILY_STEPS steps each from the
    set-up's float32 first step (its gate is judged here), the first with
    every rank's B5 / B6 calls held against the plain version on their
    own inputs; each step's wire bytes equal to the count from the specs;
    every rank's attention on 16 query heads (Mixtral 4 KV heads, its 4
    experts; MusicGen 16) or RWKV6's time mix on 20 heads; the experts
    every rank chose equal across each "model" group; each rank's peak
    against its share of the four float32 copies; step ms and tokens/s.
    Every B5 / B6 call is counted on the ranks: a rank's 4 pieces launch
    the kernel twice a layer (forward and recompute)."""
    mesh = setup["mesh"]
    world = math.prod(MESH_TRAIN_GRID)
    launches = {"flash_attention": 0, "rwkv_linattn": 0}
    report, bad = {}, []
    hold = "chip_smoke:_rank_hold"
    for arch, depth, kernel in MESH_FAMILIES:
        fam = setup["families"].pop(arch)
        params, opt = fam["params"], fam["opt"]
        cfg = family_config(arch, depth)
        model = Transformer(cfg, device=torch.device("cuda"), mesh=mesh)
        step = make_train_step(model, mesh_train_opt())
        want = mesh_train.wire_bytes(model, TRAIN_BATCH, TRAIN_SEQ)
        acc = _largest_divisor_leq(TRAIN_BATCH, cfg.train_accum)
        pieces = len(mesh_train.pieces(TRAIN_BATCH // MESH_TRAIN_GRID[0], 0,
                                       acc, TRAIN_BATCH // acc))
        per, rem = kernel_layers(cfg, kernel)
        calls = pieces * (2 * per + rem)
        mesh_train.memory_peaks(mesh, reset=True)
        hist, routes = [], None
        for s in range(MESH_FAMILY_STEPS):
            batch = synthetic_lm_batch(cfg, 1 + s, batch=TRAIN_BATCH,
                                       seq=TRAIN_SEQ)
            if s == 0:
                resident.call(mesh, hold, on=True, kernel=kernel)
            # the experts every rank's dispatches choose in the first step
            record = s == 0 and cfg.moe is not None
            t0 = time.perf_counter()
            with (mesh_train.expert_routes(mesh) if record
                  else contextlib.nullcontext()) as seen:
                params, opt, m = step(params, opt, batch)
            routes = seen if record else routes
            hist.append({"loss": float(m["loss"]),
                         "grad_norm": float(m["grad_norm"]),
                         "time_s": time.perf_counter() - t0})
            if s == 0:
                held = resident.call(mesh, hold, on=False, kernel=kernel)
            if step.last["wire"] != want:
                raise AssertionError(
                    f"train_mesh_families_full: {arch} step {s} wire bytes "
                    f"{step.last['wire']}, counted from the specs {want}")
        peaks = mesh_train.memory_peaks(mesh, reset=True)
        heads = mesh_train.attention_heads(model)
        scans = mesh_train.scan_widths(model)
        resident.free(params)
        resident.free(opt)
        del params, opt
        resident.call(mesh, "chip_smoke:_rank_release")
        launches[kernel] += world * calls * MESH_FAMILY_STEPS
        tol = (FLASH_TOL[torch.bfloat16] if kernel == "flash_attention"
               else LINATTN_TOL)
        rank_calls = {"calls": [c for c, _, _ in held],
                      "max_abs_err": max(e for _, e, _ in held),
                      "worst_share_of_limit": max(r for _, _, r in held),
                      "tol": tol}
        if kernel == "flash_attention":
            kv = cfg.n_kv // 2 if cfg.n_kv % 2 == 0 else cfg.n_kv
            split_ok = heads == [(cfg.n_heads // 2, kv)] * world
        else:
            split_ok = scans == [("rwkv", cfg.rwkv_heads // 2)] * world
        routes_ok = routes is None or (
            routes[0] == routes[1] and routes[2] == routes[3]
            and len(routes[0]) > 0)
        finite = all(np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"])
                     for h in hist)
        f32 = fam["float32"]
        if (rank_calls["calls"] != [calls] * world
                or rank_calls["worst_share_of_limit"] > 1.0 or not split_ok
                or not routes_ok or not finite or f32["over"]):
            bad.append(arch)
        share = 16 * fam["n_params"] / world
        step_s = hist[-1]["time_s"]
        report[arch] = {
            "layers": depth, "full_layers": get_config(arch).n_layers,
            "n_params": fam["n_params"], "kernel": kernel,
            "microbatches": acc, "pieces_per_rank": pieces,
            "step_ms": 1e3 * step_s,
            "tokens_per_sec": TRAIN_BATCH * TRAIN_SEQ / step_s,
            "step_ms_each": [1e3 * h["time_s"] for h in hist],
            "losses": [h["loss"] for h in hist],
            "grad_norms": [h["grad_norm"] for h in hist],
            "peak_bytes": peaks, "share_bytes": share,
            "peak_over_share": [p / share for p in peaks],
            "wire_bytes_per_step": want, "rank_heads": heads,
            "rank_scans": scans, "rank_calls": rank_calls,
            "routes_equal_in_model_groups": routes_ok,
            "expert_choices_per_rank": (None if routes is None else
                                        [sum(len(r) for r in rr)
                                         for rr in routes]),
            "float32_first_step": f32}
    emit("train_mesh_families_full", grid=list(MESH_TRAIN_GRID),
         batch=TRAIN_BATCH, seq=TRAIN_SEQ, steps=MESH_FAMILY_STEPS,
         setup_grid_s=setup["grid_s"], families=report)
    if bad:
        raise AssertionError(
            f"train_mesh_families_full: {bad} failed a check (the float32 "
            "first step against one device, the ranks' kernel calls, heads "
            "or routing, finite steps); see the train_mesh_families_full "
            "line")
    return launches


# ---------------------------------------------------------------------------
# LM prefill and decode over the (data, model) grid
# ---------------------------------------------------------------------------

#: Qwen3-1.7B at full width and all 28 layers, bf16, served over
#: train_mesh_full's 2 x 2 grid (``make_prefill_step`` /
#: ``make_decode_step`` on a sharded model): SERVE_MESH_BATCH prompts of
#: SERVE_MESH_PROMPT tokens into a cache of SERVE_MESH_CACHE positions,
#: then SERVE_MESH_DECODE decoded tokens, each step fed the one-device
#: step's greedy token (the grid and one device read the same inputs)
SERVE_MESH_BATCH, SERVE_MESH_PROMPT = 4, 256
SERVE_MESH_CACHE, SERVE_MESH_DECODE = 512, 16
#: the grid's bf16 logits against one device's from the same weights: the
#: largest difference over every step's logits at most
#: SERVE_MESH_SPREAD_FACTOR times the one-device bf16-against-float32
#: spread on the same inputs (the largest difference of those two runs'
#: logits; PERF.md, section 6, fixes the factor before the run)
SERVE_MESH_SPREAD_FACTOR = 2.0
#: ... and a float32 pass at SERVE_MESH_F32_DEPTH layers (before the counted
#: window: float32 B5 calls take the ``simt`` route) within
#: SERVE_MESH_F32_TOL of the largest logit
SERVE_MESH_F32_DEPTH, SERVE_MESH_F32_TOL = 2, 1e-5
#: the other families at full width and reduced depth on the same grid:
#: arch, depth, the kernel its prefill launches.  RecurrentGemma-9B at one
#: period (RG-LRU x 2 and LOCAL: B5 at head dim 256 on 8 of 16 query heads,
#: its one KV head's cache split by length -- 256 of the 512 slots a rank,
#: the second rank's empty until the decode reaches them), RWKV6-3B at 2
#: layers (B6 on 20 of 40 heads), Mixtral-8x7B at 1 (B5 on 16 of 32 query,
#: 4 of 8 KV heads)
SERVE_MESH_FAMILIES = (("recurrentgemma-9b", 3, "flash_attention"),
                       ("rwkv6-3b", 2, "rwkv_linattn"),
                       ("mixtral-8x7b", 1, "flash_attention"))


def serve_mesh_batch(cfg):
    rng = np.random.default_rng(17)
    return {"tokens": rng.integers(0, cfg.vocab, (
        SERVE_MESH_BATCH, SERVE_MESH_PROMPT)).astype(np.int32)}


def one_device_serve(cfg, batch, inputs=None):
    """The one-device prefill and SERVE_MESH_DECODE decode steps of ``cfg``
    from init(0) on the card: every step's logits (host, float32) and the
    inputs of every step (the prompt, then each step's greedy token unless
    ``inputs`` gives them)."""
    model = Transformer(cfg, device=torch.device("cuda"))
    params = model.compute_params(model.init(0))
    prefill = make_prefill_step(model, SERVE_MESH_CACHE)
    decode = make_decode_step(model)
    logits, cache = prefill(params, batch)
    outs, ins = [logits.float().cpu()], [batch]
    for s in range(SERVE_MESH_DECODE):
        inp = inputs[1 + s] if inputs is not None else {
            "tokens": outs[-1][:, -1].argmax(-1).numpy().astype(
                np.int32)[:, None]}
        logits, cache = decode(params, cache, inp)
        outs.append(logits.float().cpu())
        ins.append(inp)
    del model, params, cache
    gc.collect()
    torch.cuda.empty_cache()
    return {"logits": outs, "inputs": ins}


def logit_distance(got, want):
    """The largest absolute difference over every step's logits, and the
    largest logit of ``want``."""
    return (max(float((g - w).abs().max()) for g, w in zip(got, want)),
            max(float(w.abs().max()) for w in want))


def grid_serve(mesh, cfg, inputs, kernel=None):
    """``cfg`` from init(0) (made on the ranks) served over the grid: a
    prefill (the views gathered, every rank's ``kernel`` calls held
    against the plain version), a second prefill (the views held), then a
    decode step for each of ``inputs[1:]``; each step's wire bytes against
    ``serve_wire_bytes``; seconds, peaks, the ranks' heads."""
    model = Transformer(cfg, device=torch.device("cuda"), mesh=mesh)
    t0 = time.perf_counter()
    params = mesh_train.init_params_on_mesh(model, 0)
    out = {"init_s": time.perf_counter() - t0}
    mesh_train.memory_peaks(mesh, reset=True)
    prefill = make_prefill_step(model, SERVE_MESH_CACHE)
    decode = make_decode_step(model)
    B, S = inputs[0]["tokens"].shape
    want = {k: mesh_serve.serve_wire_bytes(model, B, n, k)
            for k, n in (("prefill", S), ("decode", SERVE_MESH_CACHE))}
    hold = "chip_smoke:_rank_hold"
    if kernel:
        resident.call(mesh, hold, on=True, kernel=kernel)
    t0 = time.perf_counter()
    _, cache = prefill(params, inputs[0])
    out["first_prefill_s"] = time.perf_counter() - t0
    if kernel:
        out["rank_calls"] = resident.call(mesh, hold, on=False,
                                          kernel=kernel)
    views = prefill.last["views"]
    wires = [prefill.last["wire"]]
    mesh_serve.free_cache(cache)
    t0 = time.perf_counter()
    logits, cache = prefill(params, inputs[0])
    out["prefill_s"] = time.perf_counter() - t0
    gathered = [views["gathered"], prefill.last["views"]["gathered"]]
    wires.append(prefill.last["wire"])
    outs, dec_s = [logits.float().cpu()], []
    for inp in inputs[1:]:
        t0 = time.perf_counter()
        logits, cache = decode(params, cache, inp)
        dec_s.append(time.perf_counter() - t0)
        outs.append(logits.float().cpu())
        wires.append(decode.last["wire"])
    mesh_serve.free_cache(cache)
    bad_wire = [i for i, w in enumerate(wires)
                if w != want["prefill" if i < 2 else "decode"]["step"]]
    if (bad_wire or gathered != [True, False]
            or views["wire"] != want["prefill"]["views"]):
        raise AssertionError(
            f"serve_mesh_full: {cfg.name} wire bytes of steps {bad_wire} "
            f"({wires}), views gathered {gathered} ({views['wire']}); "
            f"counted from the specs {want}")
    out.update(
        logits=outs, decode_s=dec_s, views_s=views["s"],
        views_wire=views["wire"], wire=want,
        peaks=mesh_train.memory_peaks(mesh, reset=True),
        heads=mesh_train.attention_heads(model),
        scans=mesh_train.scan_widths(model),
        n_params=sum(math.prod(h.shape) for h in tree_leaves_sorted(params)))
    resident.free(params)
    resident.call(mesh, "chip_smoke:_rank_release")
    return out


def serve_mesh_setup():
    """Before the counted window: train_mesh_full's 2 x 2 grid (spawned
    here when no earlier phase did); Qwen3-1.7B's one-device bf16 prefill
    and decode steps from init(0) (their greedy tokens are both runs'
    inputs) and float32 ones on the same inputs (the bf16 spread the
    grid's limit scales); a float32 pass at SERVE_MESH_F32_DEPTH layers on
    one device and on the grid, held at SERVE_MESH_F32_TOL; the other
    families' one-device bf16 runs."""
    start = t0 = time.perf_counter()
    grid = process_grid(*MESH_TRAIN_GRID, device="cuda")
    if grid not in MESH_GRIDS:
        MESH_GRIDS.append(grid)
    mesh = make_mesh(MESH_TRAIN_GRID, ("data", "model"))
    resident.call(mesh, "chip_smoke:_rank_release")
    out = {"mesh": mesh, "grid_s": time.perf_counter() - t0}
    t0 = time.perf_counter()
    cfg = family_config("qwen3-1.7b")
    one = one_device_serve(cfg, serve_mesh_batch(cfg))
    one32 = one_device_serve(dataclasses.replace(
        cfg, compute_dtype="float32"), one["inputs"][0], one["inputs"])
    spread, _ = logit_distance(one["logits"], one32["logits"])
    del one32
    out.update(one=one, spread=spread, one_device_s=time.perf_counter() - t0)
    t0 = time.perf_counter()
    cfg32 = family_config("qwen3-1.7b", SERVE_MESH_F32_DEPTH,
                          compute_dtype="float32")
    ref32 = one_device_serve(cfg32, serve_mesh_batch(cfg32))
    got32 = grid_serve(mesh, cfg32, ref32["inputs"])
    err, top = logit_distance(got32["logits"], ref32["logits"])
    out["float32"] = {"layers": SERVE_MESH_F32_DEPTH, "max_abs_diff": err,
                      "largest_logit": top, "share_of_limit":
                          err / (SERVE_MESH_F32_TOL * top),
                      "seconds": time.perf_counter() - t0}
    out["families"] = {}
    for arch, depth, _ in SERVE_MESH_FAMILIES:
        fcfg = family_config(arch, depth)
        out["families"][arch] = one_device_serve(fcfg,
                                                 serve_mesh_batch(fcfg))
    out["setup_s"] = time.perf_counter() - start
    return out


def phase_serve_mesh_full(setup):
    """Qwen3-1.7B at full width and all 28 layers, bf16, served over the
    2 x 2 (data, model) grid (``make_prefill_step`` / ``make_decode_step``
    on a sharded model: a rank's 2 rows, its 8 of 16 query heads and 4 of 8
    KV heads, the cache's KV heads over "model"): the views gathered at
    the first prefill and held, SERVE_MESH_DECODE decode steps; every
    step's logits against the one-device run of the set-up within
    SERVE_MESH_SPREAD_FACTOR times its bf16-against-float32 spread, the
    greedy tokens reported; every rank's B5 calls of the first prefill
    against the plain version; the wire bytes of every step and of the
    views against ``serve_wire_bytes``; prefill and decode-step seconds,
    tokens/s, each rank's peak.  Then SERVE_MESH_FAMILIES the same way
    (their logits' distance from one device reported: Mixtral's routing
    moves with bf16 rounding), and the set-up's float32 pass is judged.
    Every B5 / B6 call is counted on the ranks: a prefill launches the
    kernel once a layer on each rank, a decode step never."""
    mesh = setup["mesh"]
    world = math.prod(MESH_TRAIN_GRID)
    launches = {"flash_attention": 0, "rwkv_linattn": 0}
    report, bad = {}, []
    runs = [("qwen3-1.7b", None, "flash_attention", setup["one"])] + [
        (arch, depth, kernel, setup["families"][arch])
        for arch, depth, kernel in SERVE_MESH_FAMILIES]
    for arch, depth, kernel, one in runs:
        cfg = family_config(arch, depth)
        run = grid_serve(mesh, cfg, one["inputs"], kernel)
        per, rem = kernel_layers(cfg, kernel)
        calls = per + rem                       # one a layer a prefill
        launches[kernel] += 2 * world * calls
        err, top = logit_distance(run["logits"], one["logits"])
        agree = [int((g[:, -1].argmax(-1) == w[:, -1].argmax(-1)).sum())
                 for g, w in zip(run["logits"], one["logits"])]
        held = run["rank_calls"]
        tol = (FLASH_TOL[torch.bfloat16] if kernel == "flash_attention"
               else LINATTN_TOL)
        rank_calls = {"calls": [c for c, _, _ in held],
                      "max_abs_err": max(e for _, e, _ in held),
                      "worst_share_of_limit": max(r for _, _, r in held),
                      "tol": tol}
        if kernel == "flash_attention":
            kv = cfg.n_kv // 2 if cfg.n_kv % 2 == 0 else cfg.n_kv
            split_ok = run["heads"] == [(cfg.n_heads // 2, kv)] * world
        else:
            split_ok = run["scans"] == [("rwkv", cfg.rwkv_heads // 2)] * world
        dec_s = statistics.median(run["decode_s"])
        row = {"layers": cfg.n_layers,
               "full_layers": get_config(arch).n_layers,
               "n_params": run["n_params"], "kernel": kernel,
               "init_s": run["init_s"],
               "first_prefill_s": run["first_prefill_s"],
               "views_s": run["views_s"], "views_wire": run["views_wire"],
               "prefill_ms": 1e3 * run["prefill_s"],
               "prefill_tokens_per_sec": SERVE_MESH_BATCH * SERVE_MESH_PROMPT
               / run["prefill_s"],
               "decode_step_ms": 1e3 * dec_s,
               "decode_tokens_per_sec": SERVE_MESH_BATCH / dec_s,
               "decode_step_ms_each": [1e3 * s for s in run["decode_s"]],
               "peak_bytes": run["peaks"],
               "wire_bytes": run["wire"], "rank_heads": run["heads"],
               "rank_scans": run["scans"], "rank_calls": rank_calls,
               "logits_max_abs_diff": err, "largest_logit": top,
               "greedy_agree": agree,
               "grid_greedy_tokens": [g[:, -1].argmax(-1).tolist()
                                      for g in run["logits"]]}
        finite = all(torch.isfinite(g).all() for g in run["logits"])
        ok = (finite and split_ok and rank_calls["calls"] == [calls] * world
              and rank_calls["worst_share_of_limit"] <= 1.0)
        if arch == "qwen3-1.7b":
            limit = SERVE_MESH_SPREAD_FACTOR * setup["spread"]
            row.update(one_device_bf16_f32_spread=setup["spread"],
                       limit=limit, share_of_limit=err / limit)
            ok = ok and err <= limit
        if not ok:
            bad.append(arch)
        report[arch] = row
    f32 = setup["float32"]
    if f32["share_of_limit"] > 1.0:
        bad.append("float32")
    emit("serve_mesh_full", grid=list(MESH_TRAIN_GRID),
         batch=SERVE_MESH_BATCH, prompt=SERVE_MESH_PROMPT,
         cache=SERVE_MESH_CACHE, decode_steps=SERVE_MESH_DECODE,
         setup_s=setup["setup_s"], grid_s=setup["grid_s"],
         one_device_s=setup["one_device_s"], float32=f32, runs=report)
    if bad:
        raise AssertionError(
            f"serve_mesh_full: {bad} failed a check (logits against one "
            "device, the ranks' kernel calls, heads, finite logits, the "
            "float32 pass); see the serve_mesh_full line")
    return launches


# ---------------------------------------------------------------------------
# examples_full: the six examples of examples/torch_*.py on the card
# ---------------------------------------------------------------------------

#: the grid example's grid (its default --mesh)
EXAMPLE_GRID = (4, 2)
#: steps of the ~100M config (the example's default is 300; at 20 its
#: mean loss of the last 5 is below the first 5's, as the example asserts
#: from 10 steps on: not at 10, where the learning rate is still warming)
EXAMPLE_100M_STEPS = 20
#: the SDCA kernel's launches of the solver examples at their own sizes,
#: every one at 1 CTA a cell (rows of at most 400 columns): quickstart
#: (300 serial epochs for f*, 15 D3CA iterations), the grid example (200
#: serial epochs, 15 iterations on each of its 8 ranks), trace_solve (10
#: iterations and the timed path's OBS_CALIB calibration steps),
#: online_loop (12 updates of 2 passes, each on the timed path, and the
#: warm and the cold update of 2 passes, untimed)
EXAMPLE_SDCA = ((300 + 15) + (200 + 15 * EXAMPLE_GRID[0] * EXAMPLE_GRID[1])
                + (10 + OBS_CALIB) + 12 * (2 + OBS_CALIB) + 2 * 2)
#: the SVRG kernel's: RADiSA's 15 iterations in quickstart and on each
#: rank of the grid example
EXAMPLE_SVRG = 15 + 15 * EXAMPLE_GRID[0] * EXAMPLE_GRID[1]


def load_example(name):
    """The module ``examples/torch_<name>.py``, loaded by path."""
    path = os.path.join(ROOT, "examples", f"torch_{name}.py")
    spec = importlib.util.spec_from_file_location(f"torch_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_example(name, argv):
    """``main(argv)`` of ``examples/torch_<name>.py``, as a user runs it;
    its result, what it printed and its wall time."""
    mod = load_example(name)
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        out = mod.main(argv)
    torch.cuda.synchronize()
    return out, buf.getvalue(), time.perf_counter() - t0


#: where each kernel's callers take it from (see :func:`tap`)
EXAMPLE_TAPS = {"sdca_epoch": "repro_torch.kernels.sdca",
                "svrg_inner": "repro_torch.kernels.svrg",
                "flash_attention": "repro_torch.models.attention"}


@contextlib.contextmanager
def example_taps(*names):
    """Keep the first and the last call this process makes of each named
    kernel wrapper inside the block (inputs and outputs detached):
    ``{name: [(args, kwargs, outputs), ...]}``."""
    def detached(x):
        if torch.is_tensor(x):
            return x.detach()
        return tuple(map(detached, x)) if isinstance(x, tuple) else x

    def keeper(keep):
        def on_launch(args, kw, out):
            call = (detached(tuple(args)), kw, detached(out))
            keep[min(len(keep), 1):] = [call]
        return on_launch
    keeps = {name: [] for name in names}
    with contextlib.ExitStack() as stack:
        for name in names:
            stack.enter_context(tap(name, keeper(keeps[name]),
                                    EXAMPLE_TAPS[name]))
        yield keeps


def sdca_plain_any(x, y, mask, alpha0, w0, idx, **kw):
    """B1's plain version for a call in either of the wrapper's forms:
    the grid's (P, Q, n_p, m_q) or one block (n_p, m_q), as the serial
    SDCA epochs for f* call it."""
    if x.dim() != 2:
        return sdca_epoch_plain(x, y, mask, alpha0, w0, idx, **kw)
    dalpha, w = sdca_epoch_plain(x[None, None], y[None], mask[None],
                                 alpha0[None], w0[None], idx[None], **kw)
    return dalpha[0, 0], w[0, 0]


def example_holds(label, keeps):
    """Each kept call against the plain version on its own inputs: the
    solver kernels relative to each output's largest entry
    (``main_check``, MAIN_TOL), B5 one query row at a time at FLASH_TOL
    of its dtype (``row_check``; a share of the limit over 1 fails).
    The plain versions launch nothing."""
    out = {}
    for name, keep in keeps.items():
        if name != "flash_attention":
            out[name] = held_first_last(
                f"{label} {name}", keep,
                sdca_plain_any if name == "sdca_epoch" else PLAINS[name])
            continue
        if len(keep) != 2:
            raise AssertionError(f"{label}: kept {len(keep)} B5 calls")
        out[name] = []
        for args, kw, got in keep:
            with torch.no_grad():
                want = flash_attention_plain(*args, **kw)
            err, share = row_check(got, want, FLASH_TOL[got.dtype])
            if float(share) > 1.0:
                raise AssertionError(f"{label} flash_attention: worst row "
                                     f"{float(share)} of its limit")
            out[name].append({"shape": list(got.shape),
                              "dtype": str(got.dtype).split(".")[-1],
                              "max_abs_err": float(err),
                              "share_of_limit": float(share)})
    return out


def examples_setup():
    """Before the counted window: the grid example's 4 x 2 grid on the
    card (mesh_full's, where it ran just before, else its spawn; the
    example then finds it memoized), without mesh_full's rank hook."""
    t0 = time.perf_counter()
    grid = process_grid(*EXAMPLE_GRID, device="cuda")
    grid.rank_hook = None
    if grid not in MESH_GRIDS:
        MESH_GRIDS.append(grid)
    return {"grid": grid, "grid_s": time.perf_counter() - t0}


def example_lm_launches(cfg, batch, steps):
    """B5's launches and route for ``steps`` training steps of ``cfg`` at
    ``batch`` rows (see ``kernel_layers``)."""
    in_periods, in_rem = kernel_layers(cfg)
    acc = _largest_divisor_leq(batch, cfg.train_accum)
    return (acc * steps * (2 * in_periods + in_rem),
            flash_route(cfg.cdtype, cfg.head_dim))


def phase_examples_full(setup):
    """The six examples as a user runs them (``main`` of
    ``examples/torch_*.py``, every one on the card, its default device), at
    their own sizes: quickstart (SDCA and SVRG kernels), the grid example
    on EXAMPLE_GRID ranks (both, on every rank), trace_solve (SDCA, timed
    path), online_loop (SDCA with the row gate as its mask), serve_lm
    (reduced Mixtral on the engine: B5 at head dim 16, the ``simt`` route,
    the only one at that width) and lm_train, ``--small`` (B5 ``simt``)
    and then the ~100M config for EXAMPLE_100M_STEPS steps (B5 ``tc`` at
    head dim 64).  One line an example, with the card beside its numbers;
    gated: every solver's rel-opt falls, the traced objective falls,
    recovery resumes at the newest persisted version, every request
    finishes, ``--small`` learns and the 100M losses are finite.  The
    first and the last call of each kernel an example makes in this
    process (the grid example: rank 0's) are held against the plain
    version on their own inputs (``held``)."""
    card = CARD["line"]

    def line(example, wall, **fields):
        emit("examples_full", example=example, wall_s=wall, card=card,
             **fields)

    # 1. quickstart: f*, every solver's rel-opt each 5 iterations
    with example_taps("sdca_epoch", "svrg_inner") as keeps:
        out, _, wall = run_example("quickstart", [])
    printed = {}
    for name, hist in out["history"].items():
        printed[name] = [h["rel_opt"] for h in hist if h["iter"] % 5 == 0]
        if not (np.all(np.isfinite(printed[name]))
                and printed[name][-1] < printed[name][0]):
            raise AssertionError(f"quickstart {name}: rel-opt {printed}")
    line("quickstart", wall, f_star=out["f_star"], rel_opt=out["rel_opt"],
         rel_opt_printed=printed, held=example_holds("quickstart", keeps))

    # 2. the grid example: rel-opt of each solver below that of w = 0
    with example_taps("sdca_epoch", "svrg_inner") as keeps:
        out, text, wall = run_example("svm_doubly_distributed", [])
    if out["grid"] is not setup["grid"]:
        raise AssertionError(f"grid example ran on {out['grid']}")
    rel0 = (1.0 - out["f_star"]) / abs(out["f_star"])
    for name in ("d3ca", "radisa"):
        r = out[name]["rel_opt"]
        if not (np.isfinite(r) and r < rel0):
            raise AssertionError(f"grid example {name}: rel-opt {r} (at w "
                                 f"= 0: {rel0})")
    line("svm_doubly_distributed", wall, f_star=out["f_star"],
         ranks=out["grid"].world, rel_opt_at_zero=rel0,
         rel_opt={k: out[k]["rel_opt"] for k in ("d3ca", "radisa")},
         grid_spawn_s=setup["grid_s"], mesh=text.splitlines()[0],
         held_rank0=example_holds("svm_doubly_distributed", keeps))

    # 3. trace_solve: the phase split of every iteration, span totals
    with tempfile.TemporaryDirectory() as tmp, \
            example_taps("sdca_epoch") as keeps:
        out, _, wall = run_example("trace_solve", [
            "--out", os.path.join(tmp, "trace.json")])
    hist = out["history"]
    if not (len(hist) == 10 and hist[-1]["objective"] < hist[0]["objective"]
            and out["events"] > 0
            and all(out["spans"][k] > 0 for k in ("solve", "calibrate",
                                                  "local_solve"))):
        raise AssertionError(f"trace_solve: {hist} {out['spans']}")
    line("trace_solve", wall, objective=[h["objective"] for h in hist],
         **{f"{k}_ms_median": 1e3 * statistics.median(h[f"{k}_s"]
                                                      for h in hist)
            for k in ("step", "local", "comm", "host")},
         span_s=out["spans"], events=out["events"],
         held=example_holds("trace_solve", keeps))

    # 4. online_loop: staleness and lag a round, recovery
    with tempfile.TemporaryDirectory() as tmp, \
            example_taps("sdca_epoch") as keeps:
        out, _, wall = run_example("online_loop", ["--ckpt-dir", tmp])
    rounds = out["rounds"]
    if not (out["recovered"] == out["newest"] == len(rounds) == 12
            and out["weights_match"]
            and all(0 <= r["staleness_s"] < 60 and r["version_lag"] == 0
                    for r in rounds)):
        raise AssertionError(f"online_loop: {out}")
    hists = out["snapshot"]["histograms"]
    line("online_loop", wall, recovered_version=out["recovered"],
         staleness_s=[r["staleness_s"] for r in rounds],
         version=[r["version"] for r in rounds],
         objective=[r["objective"] for r in rounds],
         accuracy=[r["accuracy"] for r in rounds],
         f_warm=out["f_warm"], f_cold=out["f_cold"],
         update_s_p50={k: v["p50"] for k, v in hists.items()
                       if k.startswith(("online/update_s",
                                        "online/swap_s"))},
         held=example_holds("online_loop", keeps))

    # 5. serve_lm: reduced Mixtral, 6 requests over 3 slots
    with example_taps("flash_attention") as keeps:
        out, _, wall = run_example("serve_lm", [])
    s = out["summary"]
    cfg = reduced(get_config("mixtral-8x7b"))
    check_outputs("serve_lm", out["outputs"], 6, 12, cfg.vocab)
    if s["requests_finished"] != 6 or s["rejections"]:
        raise AssertionError(f"serve_lm: {s}")
    serve_n = sum(kernel_layers(cfg)) * s["prefills"]
    line("serve_lm", wall, tokens_per_sec=s["tokens_per_sec"],
         ttft_p50_s=s["ttft_s"]["p50"], latency_p99_s=s["latency_s"]["p99"],
         prefills=s["prefills"], decode_steps=s["decode_steps"],
         generated_tokens=s["generated_tokens"],
         held=example_holds("serve_lm", keeps))
    launches = {flash_route(cfg.cdtype, cfg.head_dim): serve_n}

    # 6. lm_train: --small, then the ~100M config
    with tempfile.TemporaryDirectory(dir=TRAIN_CKPT_ROOT) as tmp:
        with example_taps("flash_attention") as keeps_small:
            small, _, wall_small = run_example("lm_train", [
                "--small", "--ckpt-dir", os.path.join(tmp, "small")])
        with example_taps("flash_attention") as keeps_big:
            big, _, wall_big = run_example("lm_train", [
                "--steps", str(EXAMPLE_100M_STEPS), "--ckpt-dir",
                os.path.join(tmp, "100m")])
    losses = small["losses"]
    if not (small["learned"] and len(losses) == 60
            and np.mean(losses[-5:]) < np.mean(losses[:5])):
        raise AssertionError(f"lm_train --small: {losses}")
    if not (len(big["losses"]) == EXAMPLE_100M_STEPS
            and np.all(np.isfinite(big["losses"]))):
        raise AssertionError(f"lm_train 100M: {big['losses']}")
    cfg100 = load_example("lm_train").config_100m()
    line("lm_train", wall_small + wall_big,
         small={"loss_first5": float(np.mean(losses[:5])),
                "loss_last5": float(np.mean(losses[-5:])),
                "step_ms": small["step_ms"],
                "tokens_per_s": small["tokens_per_s"], "wall_s": wall_small,
                "held": example_holds("lm_train --small", keeps_small)},
         config_100m={"params": sum(t.numel() for t in tree_leaves_sorted(
                          param_shapes(cfg100))),
                      "steps": EXAMPLE_100M_STEPS, "step_ms": big["step_ms"],
                      "tokens_per_s": big["tokens_per_s"],
                      "loss_first": big["losses"][0],
                      "loss_last": big["losses"][-1], "wall_s": wall_big,
                      "held": example_holds("lm_train 100M", keeps_big)})
    for cfg_, batch, steps in ((reduced(get_config("qwen3-1.7b")), 4, 60),
                               (cfg100, 8, EXAMPLE_100M_STEPS)):
        n, route = example_lm_launches(cfg_, batch, steps)
        launches[route] = launches.get(route, 0) + n
    return {"sdca_epoch": EXAMPLE_SDCA, "svrg_inner": EXAMPLE_SVRG,
            "flash_attention": sum(launches.values()),
            "routes": {"flash_attention": launches}}


SDCA_SHAPE_OF_CLUSTER = {1: "d3ca_cells", 16: "serial"}
#: B1's launches on each main path, by shape
SDCA_SHAPE_LAUNCHES = {
    "d3ca_full": {"d3ca_cells": OUTER_ITERS, "serial": REF_EPOCHS},
    "radisa_full": {"serial": REF_EPOCHS},
    # the fleet's launches take 1 CTA a cell too, for 4 x 28 cells
    "fleet_dense_full": {"d3ca_cells": OUTER_ITERS},
    # two passes an update over 30 + 2 rounds, and 2 + 2 iterations of the
    # all-ones gate against no gate
    # every update takes the timed path (the service's registry goes to
    # Solver.update): two passes and a calibration of OBS_CALIB steps
    # over 30 + 2 rounds, and 2 + 2 iterations of the all-ones gate
    # against no gate
    "online_full": {"d3ca_cells": (ONLINE_PASSES + OBS_CALIB)
                    * (ONLINE_ROUNDS + 2) + 4},
    # 5 codecs + 2 controls + adaptive at 7 x 4, 3 topologies at 4 x 2, 2
    # CLI solves, and 2 x 4 timed programs of a warm-up and
    # COMM_TIMING_STEPS steps; f* for the adaptive schedule
    "comm_full": {"d3ca_cells": (len(COMM_CODECS) + 2 + 2 + 1 + 3 + 2)
                  * OUTER_ITERS + 2 * (len(COMM_CODECS) + 1)
                  * (COMM_TIMING_STEPS + 1),
                  "serial": REF_EPOCHS},
    # the traced CLI solve (10 + a calibration; f* on 16), the online CLI
    # twice (updates timed, then untimed), the fleet
    "obs_full": {"d3ca_cells": OUTER_ITERS + OBS_CALIB + OBS_ONLINE_ROUNDS
                 * (ONLINE_PASSES + OBS_CALIB) + OBS_ONLINE_ROUNDS
                 * ONLINE_PASSES + OUTER_ITERS, "serial": REF_EPOCHS},
    # every rank launches for its own cell (1 CTA): summed over the ranks
    "mesh_full": {"d3ca_cells": MESH_D3CA_CELLS, "serial": REF_EPOCHS},
    # a rank's T = 4 tenant cells in one launch (1 CTA each): the fleet
    # and the online updates (passes and calibration)
    "fleet_mesh_full": {"d3ca_cells": P * Q * (
        FLEET_MESH_ITERS + FLEET_MESH_ROUNDS * (ONLINE_PASSES + OBS_CALIB))},
    # the examples' rows are at most 400 columns wide: every launch, the
    # serial epochs for f* too, on 1 CTA a cell
    "examples_full": {"d3ca_cells": EXAMPLE_SDCA}}


#: what a main path is held against that must be made before its counted
#: window (the fleets' solo solves), handed to its phase
PHASE_SETUP = {**{name: functools.partial(train_setup, name)
                  for name in TRAIN_PATHS},
               "fleet_dense_full": lambda: fleet_solos(False),
               "fleet_sparse_full": lambda: fleet_solos(True),
               "obs_full": obs_setup, "mesh_full": mesh_setup,
               "fleet_mesh_full": fleet_mesh_setup,
               "train_mesh_full": mesh_train_setup,
               "train_mesh_families_full": mesh_families_setup,
               "serve_mesh_full": serve_mesh_setup,
               "examples_full": examples_setup}


def run_main_path(name, phase, results):
    """Drive one main path with every launch counter at 0 just before and
    read just after; it must have launched exactly the kernels it names,
    as often as it says, and every launch of a two-route wrapper must have
    taken its main route (``MAIN_ROUTES``), or the split by route the
    phase names under ``routes`` (examples_full: B5 at head dim 16, which
    only the ``simt`` route serves, beside ``tc`` at 64).  Its ``PHASE_SETUP``, if any,
    runs before the counters go to 0."""
    setup = [PHASE_SETUP[name]()] if name in PHASE_SETUP else []
    reset_counts()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    expected = phase(*setup)
    counts = launch_counts()
    want = {k: expected.get(k, 0) for k in WRAPPERS}
    if counts != want:
        raise AssertionError(f"{name}: launches {counts}; expected {want}")
    split = expected.get("routes", {})
    for k, route in MAIN_ROUTES.items():
        by = route_counts(k)
        if k in split:
            want_by = {r: split[k].get(r, 0) for r in by}
            if by != want_by:
                raise AssertionError(f"{name}: {k} launches by route {by}; "
                                     f"expected {want_by}")
        elif by[route] != counts[k]:
            raise AssertionError(f"{name}: {k} launches by route {by}; all "
                                 f"{counts[k]} must take the {route!r} route")
    for k, v in counts.items():
        results[k]["launches"] += v
        for r, n in route_counts(k).items():
            results[k]["routes"][r] += n
    # B5 by head dim: every launch at D = 256 (RecurrentGemma's LOCAL
    # layers) on the tensor-core route, as every other main-path launch
    by_dim = counts_by("flash_attention", "launches_by_head_dim")
    if by_dim.get("simt/256"):
        raise AssertionError(f"{name}: flash_attention at head dim 256 on "
                             f"the simt route: {by_dim}")
    dims = results["flash_attention"].setdefault("launches_by_head_dim", {})
    for key, n in by_dim.items():
        if n:
            dims[key] = dims.get(key, 0) + n
    # B1 runs at two shapes, told apart by the cluster size each launch
    # took: OUTER_ITERS D3CA iterations on 1 CTA a cell and REF_EPOCHS
    # serial epochs for f* on 16
    by_cluster = counts_by("sdca_epoch", "launches_by_cluster")
    by_shape = {SDCA_SHAPE_OF_CLUSTER[g]: v for g, v in by_cluster.items()}
    want = {shape: SDCA_SHAPE_LAUNCHES.get(name, {}).get(shape, 0)
            for shape in SDCA_SHAPE_OF_CLUSTER.values()}
    if by_shape != want:
        raise AssertionError(f"{name}: sdca_epoch launches by shape "
                             f"{by_shape}, by cluster size "
                             f"{by_cluster}; expected "
                             f"{want}")
    for shape, n in by_shape.items():
        results["sdca_epoch"]["shapes"][shape]["launches"] += n


def card_vs_cpu(name, cfg, X, y, grid, streams, block_format):
    """One solve on the card through the kernels and one on the CPU
    through their plain versions, with the same index streams; returns
    the largest difference of w (and alpha)."""
    out = {}
    for dev in ("cuda", "cpu"):
        solver = get_solver(name)(
            local_backend="kernel", device=dev, block_format=block_format,
            index_source=ArrayIndexSource(device=dev, **streams))
        out[dev] = solver.solve("hinge", X, y, P=grid[0], Q=grid[1],
                                cfg=cfg)
    worst = 0.0
    for f in ("w", "alpha"):
        card, cpu = getattr(out["cuda"], f), getattr(out["cpu"], f)
        if card is None:
            continue
        card = card.cpu()
        if not torch.isfinite(card).all() or card.shape != cpu.shape:
            raise AssertionError(f"{name}/{block_format}: bad {f} on the "
                                 "card")
        err = float((card - cpu).abs().max())
        if not torch.allclose(card, cpu, rtol=1e-5, atol=1e-5):
            raise AssertionError(f"{name}/{block_format}: card vs CPU {f} "
                                 f"differ by {err:.3e}")
        worst = max(worst, err)
    return worst


def phase_cpu_vs_card():
    """Small cases, 4 iterations, one set of index streams each: the port
    on the card through the kernels vs the port on the CPU through their
    plain versions.  Dense: 3 x 2 grid, n = 200, m = 60, D3CA and RADiSA.
    Sparse: the unit tests' edge instance (120 x 41 at 15 % density,
    feature block q = 1 all zero) on a 4 x 2 grid, D3CA, RADiSA and SFK."""
    iters = 4
    rng = np.random.default_rng(3)

    def streams(Ps, Qs, n):
        n_p = -(-n // Ps)
        ts = range(1, iters + 1)
        return dict(
            sdca={t: rng.integers(0, n_p, (Ps, n_p)).astype(np.int32)
                  for t in ts},
            svrg={t: rng.integers(0, n_p, (Ps, Qs, n_p)).astype(np.int32)
                  for t in ts},
            perm={t: rng.permutation(Ps) for t in ts},
            sample={t: (rng.random((Ps, n_p)) < 0.5).astype(np.float32)
                    for t in ts})

    cfgs = {"d3ca": D3CAConfig(lam=0.1, outer_iters=iters),
            "radisa": RADiSAConfig(lam=0.1, outer_iters=iters, gamma=0.05),
            "sfk": SFKConfig(lam=0.1, outer_iters=iters, gamma=0.05)}
    X, y = make_svm_data(200, 60, seed=0)
    dense_streams = streams(3, 2, 200)
    worst = {name: card_vs_cpu(name, cfgs[name], X, y, (3, 2),
                               dense_streams, "dense")
             for name in ("d3ca", "radisa")}
    Xs, ys = make_sparse_svm_data(120, 41, density=0.15, seed=7)
    Xs[:, 24:] = 0.0
    sparse_streams = streams(4, 2, 120)
    worst_sparse = {name: card_vs_cpu(name, cfg, csr_from_dense(Xs), ys,
                                      (4, 2), sparse_streams, "sparse")
                    for name, cfg in cfgs.items()}
    emit("cpu_vs_card", max_abs_err=worst, sparse_max_abs_err=worst_sparse,
         tol=1e-5, comm=comm_card_vs_cpu(cfgs["d3ca"], X, y, dense_streams),
         comm_tol=COMM_CARD_CPU_TOL, lm=lm_card_vs_cpu(torch.device("cuda")),
         lm_tol=LM_CARD_CPU_TOL,
         lm_bf16=lm_card_vs_cpu_bf16(torch.device("cuda")),
         lm_bf16_tol=LM_CARD_CPU_BF16_TOL,
         train=train_card_vs_cpu(torch.device("cuda")),
         train_tol=LM_CARD_CPU_TOL)


def train_card_vs_cpu(dev):
    """Reduced Qwen3 and RWKV6, float32 compute, the same weights and batch
    on both sides: one train step (batch 4 of 32 tokens, 4 microbatches,
    AdamW) on the card through the kernels (their CUDA-core routes at head
    dim 16) and on the CPU through the plain versions: loss, gradient norm
    and every parameter after the step, relative to their largest entry."""
    out = {}
    for arch in ("qwen3-1.7b", "rwkv6-3b"):
        cfg = reduced(get_config(arch), compute_dtype="float32")
        batch = synthetic_token_batch(0, batch=4, seq=32, vocab=cfg.vocab)
        res = {}
        for d, device in (("cpu", torch.device("cpu")), ("card", dev)):
            model = Transformer(cfg, device=device)
            params = tree_map(lambda t: t.to(device),
                              Transformer(cfg, device="cpu").init(0))
            step = make_train_step(model, AdamWConfig(lr=1e-3), 4)
            params, _, m = step(params, adamw_init(params), batch)
            res[d] = ([m["loss"], m["grad_norm"]]
                      + tree_leaves_sorted(params))
        worst = 0.0
        for a, b in zip(res["cpu"], res["card"]):
            b = b.cpu()
            err = float((a - b).abs().max())
            scale = max(1.0, float(a.abs().max()))
            if not torch.isfinite(b).all() or err > LM_CARD_CPU_TOL * scale:
                raise AssertionError(f"{arch} train step: card vs CPU "
                                     f"differ by {err:.3e}")
            worst = max(worst, err / scale)
        out[arch] = worst
    return out


#: int8 D3CA on the card against the CPU, relative to the largest entry of
#: w and alpha.  The codec's inputs differ by ~1e-7 relative between the
#: kernels and their plain versions (other summation orders), so a code can
#: land one quantum (1/127 of its cell's largest entry) apart where it sits
#: on a rounding boundary; error feedback returns that quantum on the next
#: step, so the iterates stay within about one quantum: two are allowed
COMM_CARD_CPU_TOL = 2 / 127


def comm_card_vs_cpu(cfg, X, y, streams):
    """D3CA on the small dense case under ``compression=None``,
    ``"identity"`` and ``"int8"``, on the card through the kernels and on
    the CPU through their plain versions, with the same index streams:
    None and identity bitwise on each device, int8 card against CPU within
    COMM_CARD_CPU_TOL."""
    res = {}
    for dev in ("cuda", "cpu"):
        for comp in (None, "identity", "int8"):
            solver = get_solver("d3ca")(
                device=dev, compression=comp,
                index_source=ArrayIndexSource(device=dev, **streams))
            res[dev, comp] = solver.solve("hinge", X, y, P=3, Q=2, cfg=cfg)
        for f in ("w", "alpha"):
            if not torch.equal(getattr(res[dev, None], f),
                               getattr(res[dev, "identity"], f)):
                raise AssertionError(f"cpu_vs_card: {f} under identity is "
                                     f"not bitwise None's on {dev}")
    err = max(rel_diff(getattr(res["cuda", "int8"], f).cpu(),
                       getattr(res["cpu", "int8"], f)) for f in ("w", "alpha"))
    if err > COMM_CARD_CPU_TOL:
        raise AssertionError(f"cpu_vs_card: int8 card against CPU {err:.3e}")
    return {"int8_rel_err": err, "none_vs_identity": "bitwise"}


def lm_card_vs_cpu_bf16(dev):
    """Reduced Qwen3 at head dim 64 in bfloat16 compute, the same weights on
    both sides: prefill logits of 2 prompts of 40 tokens, on the card
    through the tensor-core flash route (one launch per layer) and on the
    CPU through the plain version, relative to the largest logit."""
    cfg = reduced(get_config("qwen3-1.7b"), compute_dtype="bfloat16",
                  head_dim=64)
    models = {"cpu": Transformer(cfg, device="cpu"),
              "card": Transformer(cfg, device=dev)}
    params = {"cpu": models["cpu"].init(0)}
    params["card"] = tree_map(lambda t: t.to(dev), params["cpu"])
    toks = torch.as_tensor(np.random.default_rng(6).integers(0, cfg.vocab,
                                                             (2, 40)))
    before = flash_attention.launches_by_route["tc"]
    logits = {d: models[d].prefill(params[d], {"tokens": toks}, 48)[0]
              .float().cpu() for d in models}
    launched = flash_attention.launches_by_route["tc"] - before
    if launched != cfg.n_layers:
        raise AssertionError(f"bf16 prefill: {launched} tensor-core flash "
                             f"launches, expected {cfg.n_layers}")
    err = float((logits["card"] - logits["cpu"]).abs().max())
    scale = float(logits["cpu"].abs().max())
    if not torch.isfinite(logits["card"]).all() or \
            err > LM_CARD_CPU_BF16_TOL * scale:
        raise AssertionError(f"bf16 prefill: card vs CPU logits differ by "
                             f"{err:.3e} (largest logit {scale:.3e})")
    return err / scale


#: the reduced configs held card against CPU: (arch, overrides)
LM_CARD_CPU = [("qwen3-1.7b", {}), ("rwkv6-3b", {}), ("mixtral-8x7b", {}),
               ("moonshot-v1-16b-a3b", {}),
               ("recurrentgemma-9b", {"n_layers": 5}),
               ("llama-3.2-vision-90b", {}), ("musicgen-large", {}),
               ("qwen3-1.7b", {"kv_cache_dtype": "int8"})]


def lm_inputs(cfg, rng, B, S):
    """A prefill batch of ``cfg``'s frontend on the CPU: tokens or frame
    embeddings, and stub encoder states for XATTN layers."""
    b = {}
    if cfg.embed_input == "tokens":
        b["tokens"] = torch.as_tensor(rng.integers(0, cfg.vocab, (B, S)))
    else:
        b["embeds"] = torch.as_tensor(rng.normal(
            size=(B, S, cfg.d_model)).astype(np.float32))
    if cfg.encoder_len:
        b["encoder"] = torch.as_tensor(rng.normal(
            size=(B, cfg.encoder_len, cfg.d_model)).astype(np.float32))
    return b


def lm_card_vs_cpu(dev):
    """The reduced configs of ``LM_CARD_CPU`` (every family, the int8
    cache), float32 compute, the same weights and inputs on both sides:
    prefill of 2 prompts of 40 positions (the kernels on the card, not a
    multiple of their 64-token tiles; the 16-token windows wrap) then 4
    greedy decode steps; logits and every cache leaf relative to their
    largest entry (int8 cache values within one quantum: the k / v they
    quantize differ by rounding), and the greedy tokens equal."""
    out = {}
    for arch, over in LM_CARD_CPU:
        cfg = reduced(get_config(arch), compute_dtype="float32", **over)
        models = {"cpu": Transformer(cfg, device="cpu"),
                  "card": Transformer(cfg, device=dev)}
        params = {"cpu": models["cpu"].init(0)}
        params["card"] = tree_map(lambda t: t.to(dev), params["cpu"])
        rng = np.random.default_rng(5)
        batch = lm_inputs(cfg, rng, 2, 40)
        res = {d: models[d].prefill(params[d], batch, 48) for d in models}
        worst = 0.0
        for step in range(5):
            (lc, cc), (lg, cg) = res["cpu"], res["card"]
            leaves = [(lc, lg)] + [
                (a, b) for key in ("periods", "remainder")
                for a, b in zip(tree_leaves(cc[key]), tree_leaves(cg[key]))]
            for a, b in leaves:
                b = b.cpu()
                if a.dtype == torch.int8:
                    if int((a.int() - b.int()).abs().max()) > 1:
                        raise AssertionError(f"{arch} step {step}: int8 "
                                             "cache values differ by more "
                                             "than one quantum")
                    continue
                err = float((a - b).abs().max())
                scale = max(1.0, float(a.abs().max()))
                if not torch.isfinite(b).all() or err > LM_CARD_CPU_TOL * scale:
                    raise AssertionError(f"{arch} {over} step {step}: card "
                                         f"vs CPU differ by {err:.3e}")
                worst = max(worst, err / scale)
            nxt = {d: torch.argmax(res[d][0][:, -1], dim=-1) for d in res}
            if not torch.equal(nxt["cpu"], nxt["card"].cpu()):
                raise AssertionError(f"{arch} step {step}: greedy tokens "
                                     f"{nxt['cpu']} vs {nxt['card']}")
            if step < 4:
                step_in = ({"tokens": nxt["cpu"][:, None]}
                           if cfg.embed_input == "tokens" else
                           lm_inputs(cfg, rng, 2, 1))
                res = {d: models[d].decode_step(params[d], res[d][1],
                                                dict(step_in))
                       for d in res}
        out[arch + "".join(f" {k}={v}" for k, v in over.items())] = worst
    return out


def tree_leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


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
    ops = Pn * Qn * steps * m_cols * flops_per_elem
    t_ops = ops / PEAK_F32_FLOPS
    return {"bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes_moved": row_bytes + small + out_bytes, "flops": ops}


def sparse_bounds(name, args, lo=None):
    """Roofline bound of one sparse launch from THIS run's inputs.  Bytes:
    the nonzeros (column id + value, 8 B) of the distinct rows each cell
    samples, the small inputs read once, the outputs written once.
    Operations: 6 flops per nonzero of every sampled row for SDCA (dot,
    norm, scatter); for SVRG 5 per in-window nonzero (correction,
    scatter) plus the dense window pass the algorithm states, 6 flops per
    window element every step."""
    cols, vals, idx = args[0], args[1], args[-1]
    Pn, Qn, n_p, _ = cols.shape
    nnz_row = (vals != 0).sum(-1)                        # (P, Q, n_p)
    small = sum(int(a.numel()) * 4 for a in args[2:])
    if lo is not None:
        small += int(lo.numel()) * 4
    if name == "sdca_epoch_sparse":
        steps, m_out = idx.shape[1], args[5].shape[1]
        rows = idx.long()[:, None, :].expand(Pn, Qn, steps)
        ops = 6 * int(torch.gather(nnz_row, 2, rows).sum())
        distinct = sum(int(nnz_row[p, :, torch.unique(idx[p].long())].sum())
                       for p in range(Pn))
        out_bytes = Pn * Qn * (n_p + m_out) * 4
    else:
        L, m_out = idx.shape[2], args[5].shape[2]
        pa = torch.arange(Pn, device=cols.device)[:, None, None]
        qa = torch.arange(Qn, device=cols.device)[None, :, None]
        c = cols[pa, qa, idx.long()].long()              # (P, Q, L, k)
        v = vals[pa, qa, idx.long()]
        rel = c - (0 if lo is None else lo.long()[:, None, None, None])
        inwin = int(((rel >= 0) & (rel < m_out) & (v != 0)).sum())
        del c, v, rel
        ops = 5 * inwin + 6 * Pn * Qn * L * m_out
        distinct = sum(int(nnz_row[p, q, torch.unique(idx[p, q].long())]
                           .sum()) for p in range(Pn) for q in range(Qn))
        out_bytes = Pn * Qn * m_out * 4
    nbytes = distinct * 8 + small + out_bytes
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, ops / PEAK_F32_FLOPS
    return {"bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes_moved": nbytes, "flops": ops}


def gated_timing(fn, args, kw, mask_at, start, rows):
    """One SDCA launch at a main-path shape with ``rows`` consecutive rows
    from global row ``start`` gated on (the row mask times the gate, as an
    online update hands it over), timed both ways beside the ungated
    launch, in turns: ungated, gated, gated, ungated."""
    mask = args[mask_at]
    gate = torch.zeros(mask.numel(), device=mask.device)
    gate[start: start + rows] = 1.0
    gated = list(args)
    gated[mask_at] = (mask.reshape(-1) * gate).reshape(mask.shape)
    plain = [both_ms(lambda: fn(*args, **kw), reps=5)]
    gpairs = [both_ms(lambda: fn(*gated, **kw), reps=5) for _ in range(2)]
    plain.append(both_ms(lambda: fn(*args, **kw), reps=5))
    return {"rows_on": gated_rows(gated[mask_at]), **medians(gpairs, "ms"),
            **medians(plain, "ungated_ms")}


def time_program(prog, iters=5):
    """ms per outer iteration of a grid-engine program (step only, no
    history), by CUDA events around ``iters`` steps after a warm-up
    step."""
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


def time_fleet(prog, iters=5):
    """ms per outer iteration of a fleet program (every tenant active),
    as :func:`time_program` times a solo one."""
    active = torch.ones(prog.n_tenants, device="cuda")
    state = prog.step(1, active, prog.state)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for t in range(2, 2 + iters):
        state = prog.step(t, active, state)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def tenant_timing(name, tenants, bound_of, prev=None):
    """One solver kernel at a fleet's main-path shape (T tenants' cells in
    one launch, per-tenant scalars: :func:`dense_tenants` /
    :func:`sparse_tenants`), timed both ways -- and, where ``prev(args,
    kw)`` launches the route it replaced, that route beside it (kernel,
    replaced, replaced, kernel).  Its bound is that of the tenants' work
    together: the bytes and the operations that ``bound_of(args, lo)``
    counts in each tenant's inputs of this run, summed."""
    per, los, kw = tenants[name]
    parts = [bound_of(a, None if los is None else los[t])
             for t, a in enumerate(per)]
    nbytes = sum(b["bytes_moved"] for b in parts)
    ops = sum(b["flops"] for b in parts)
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, ops / PEAK_F32_FLOPS
    args, kw = stacked(name, per, los, kw)
    pairs = [both_ms(lambda: WRAPPERS[name](*args, **kw), reps=5)]
    extra = {}
    if prev is not None:
        prev_pairs = [both_ms(lambda: prev(args, kw), reps=3)
                      for _ in range(2)]
        extra = {"prev_route": "block",
                 **medians(prev_pairs, "prev_route_ms")}
    pairs.append(both_ms(lambda: WRAPPERS[name](*args, **kw), reps=5))
    del args
    torch.cuda.empty_cache()
    return {"T": len(per), **medians(pairs, "ms"), **extra,
            "bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes_moved": nbytes, "flops": ops}


def step_busy(step, state):
    """:func:`device_busy` of one outer step, ``step(state) -> state``."""
    box = [state]

    def one():
        box[0] = step(box[0])
    return device_busy(one)


def fleet_timing(dev):
    """Each fleet of the fleet phases at its configuration: ms per outer
    iteration of the fleet beside T x the solo's (tenant 0), what the
    device does in one step of each (``torch.profiler``: busy ms, idle
    share, kernels a step, the five longest), and solves
    per second of one fleet solve of the T tenants (10 iterations, no
    history; packing included) against T solo solves one after the
    other (partitioning included)."""
    out = {}
    for sparse, T, solvers in ((False, FLEET_T_DENSE,
                                ("d3ca", "radisa", "admm")),
                               (True, FLEET_T_SPARSE, ("d3ca", "radisa"))):
        problems = fleet_tenants(sparse)
        bf = "sparse" if sparse else "dense"
        for solver in solvers:
            cfg = fleet_config(solver, LAM20 if sparse else LAM)
            fleet = FleetSolver(solver=solver, block_format=bf)
            solo = get_solver(solver)(block_format=bf)
            p0 = problems[0]
            prog = fleet.program(problems, P=P, Q=Q, cfg=cfg)
            active = torch.ones(T, device="cuda")
            fleet_ms = time_fleet(prog)
            fleet_busy = with_idle(fleet_ms, step_busy(
                lambda st: prog.step(2, active, st), prog.state))
            del prog
            gc.collect()
            torch.cuda.empty_cache()
            prog = solo.program(p0.loss_name, p0.X, p0.y, P=P, Q=Q,
                                cfg=solo_config(cfg, p0))
            solo_ms = time_program(prog)
            solo_busy = with_idle(solo_ms, step_busy(
                lambda st: prog.step(2, st), prog.state))
            del prog
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fleet.solve_batch(problems, P=P, Q=Q, cfg=cfg,
                              record_history=False)
            torch.cuda.synchronize()
            fleet_s = time.perf_counter() - t0
            gc.collect()
            torch.cuda.empty_cache()
            t0 = time.perf_counter()
            for p in problems:
                solo.solve(p.loss_name, p.X, p.y, P=P, Q=Q,
                           cfg=solo_config(cfg, p), record_history=False)
            torch.cuda.synchronize()
            solo_s = time.perf_counter() - t0
            gc.collect()
            torch.cuda.empty_cache()
            out[solver + ("_sparse" if sparse else "")] = {
                "tenants": T, "ms_per_outer_iter": fleet_ms,
                "solo_ms_per_outer_iter": solo_ms,
                "T_x_solo_ms_per_outer_iter": T * solo_ms,
                "device": fleet_busy, "solo_device": solo_busy,
                "fleet_solve_s": fleet_s, "solo_solves_s": solo_s,
                "fleet_solves_per_s": T / fleet_s,
                "solo_solves_per_s": T / solo_s}
        del problems
        gc.collect()
    return out


def serial_timing(X, y, dev):
    """B1 at the serial-SDCA shape: one epoch of the f* reference on the
    whole instance (one cell of 14 000 x 12 000, 14 000 steps, the first
    epoch's state: alpha = 0, w = 0, a random permutation), on the
    wrapper's route and the block route, beside the plain version (one
    call: a 14 000-step Python loop), which the kernel's result is also
    held against."""
    n = X.shape[0]
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    idx = torch.randperm(n, generator=gen, device=dev).to(torch.int32)
    args = [X[None, None], y.float()[None], torch.ones((1, n), device=dev),
            torch.zeros((1, n), device=dev), torch.zeros((1, M), device=dev),
            idx[None]]
    kw = dict(lam=LAM, n=n, Q=1, loss="hinge")
    if sdca_route(n, M, n) != "cluster":
        raise AssertionError("the serial-SDCA shape is not on the cluster "
                             "route")
    kern = [both_ms(lambda: sdca_epoch(*args, **kw), reps=5)]
    prev = [both_ms(lambda: sdca_block(args, kw), reps=3)]
    prev.append(both_ms(lambda: sdca_block(args, kw), reps=3))
    kern.append(both_ms(lambda: sdca_epoch(*args, **kw), reps=5))
    t0 = time.perf_counter()
    want = sdca_epoch_plain(*args, **kw)
    torch.cuda.synchronize()
    plain_ms = 1e3 * (time.perf_counter() - t0)
    G, got = sdca_cluster_of(lambda: sdca_epoch(*args, **kw))
    return {**medians(kern, "ms"), "plain_ms": plain_ms,
            "plain_clock": "host, one call",
            **main_check("sdca_epoch serial-SDCA shape", got, want),
            "prev_route": "block", **medians(prev, "prev_route_ms"),
            "cluster": G, **bounds("sdca_epoch", args, M, 6),
            "shape": {"cells": 1, "n_p": n, "m_q": M, "steps": n}}


def phase_timing(dev, results):
    split, t_split = {}, [time.perf_counter()]

    def lap(name):
        now = time.perf_counter()
        split[name] = now - t_split[0]
        t_split[0] = now
    data, alpha, w = full_problem(dev)
    src = GeneratorIndexSource(0, P=P, Q=Q, n_p=data.n_p, device=dev)
    sargs = (data.x_blocks, data.y_blocks, data.mask, alpha, w,
             src.sdca_rows(1))
    skw = dict(lam=LAM, n=N, Q=Q, loss="hinge")
    vargs, lo, eta = svrg_main_inputs(data, w)
    vkw = dict(lam=LAM, eta=eta, loss="hinge", lo=lo)

    # plain, kernel, kernel, plain -- on one card, in one process; between
    # them the block route (the main path's before this slice)
    plain_s = [plain_loop_ms(lambda: sdca_epoch_plain(*sargs, **skw))]
    kern_s = [both_ms(lambda: sdca_epoch(*sargs, **skw), reps=7)]
    prev_s = [both_ms(lambda: sdca_block(sargs, skw), reps=5)]
    # B2: plain, ring, block, block, ring, plain
    plain_v = [plain_loop_ms(lambda: svrg_inner_plain(*vargs, **vkw))]
    kern_v = [both_ms(lambda: svrg_inner(*vargs, **vkw), reps=7)]
    prev_v = [both_ms(lambda: svrg_block(vargs, vkw), reps=5)]
    prev_v.append(both_ms(lambda: svrg_block(vargs, vkw), reps=5))
    kern_v.append(both_ms(lambda: svrg_inner(*vargs, **vkw), reps=7))
    plain_v.append(plain_loop_ms(lambda: svrg_inner_plain(*vargs, **vkw)))
    prev_s.append(both_ms(lambda: sdca_block(sargs, skw), reps=5))
    kern_s.append(both_ms(lambda: sdca_epoch(*sargs, **skw), reps=7))
    plain_s.append(plain_loop_ms(lambda: sdca_epoch_plain(*sargs, **skw)))

    # per step: dot (2) + norm (2) + update (2) flops per row element;
    # SVRG: subtract + dot (3) + update (6)
    cells = {**medians(kern_s, "ms"), "plain_ms": statistics.median(plain_s),
             "prev_route": "block", **medians(prev_s, "prev_route_ms"),
             "cluster": sdca_cluster_of(
                 lambda: sdca_epoch(*sargs, **skw))[0],
             **bounds("sdca_epoch", sargs, data.m_q, 6),
             "shape": {"cells": P * Q, "n_p": data.n_p, "m_q": data.m_q,
                       "steps": data.n_p}}
    results["sdca_epoch"].update(library_ms=None, **{
        k: cells[k] for k in ("ms", "device_ms", "plain_ms", "prev_route",
                              "prev_route_ms", "prev_route_device_ms",
                              "bound_ms", "bound_by", "bytes_moved")})
    results["sdca_epoch"]["shapes"]["d3ca_cells"].update(cells)
    # the online update's launch: the same cells with ONLINE_BATCH rows
    # gated on (it walks every step all the same; PERF.md section 7)
    results["sdca_epoch"]["shapes"]["d3ca_cells"]["gated"] = gated_timing(
        sdca_epoch, sargs, skw, 2, 0, ONLINE_BATCH)
    results["svrg_inner"].update(
        **medians(kern_v, "ms"), plain_ms=statistics.median(plain_v),
        library_ms=None, prev_route="block", **medians(prev_v, "prev_route_ms"),
        **bounds("svrg_inner", vargs, data.m_q // P, 9))
    tenants = dense_tenants(data, alpha, w, FLEET_T_DENSE)
    results["sdca_epoch"]["tenants"] = tenant_timing(
        "sdca_epoch", tenants,
        lambda a, lo: bounds("sdca_epoch", a, data.m_q, 6))
    results["svrg_inner"]["tenants"] = tenant_timing(
        "svrg_inner", tenants,
        lambda a, lo: bounds("svrg_inner", a, data.m_q // P, 9), svrg_block)
    del data, alpha, w, sargs, vargs, tenants
    torch.cuda.empty_cache()
    lap("dense_kernels")

    X, y = make_svm_data(N, M, seed=0)
    X, y = torch.from_numpy(X).to(dev), torch.from_numpy(y).to(dev)
    results["sdca_epoch"]["shapes"]["serial"].update(serial_timing(X, y, dev))
    solvers = {}
    for name, kernel, cfg in (("d3ca", "sdca_epoch", D3CAConfig(lam=LAM)),
                              ("radisa", "svrg_inner",
                               RADiSAConfig(lam=LAM))):
        prog = get_solver(name)(device=dev).program("hinge", X, y, P=P, Q=Q,
                                                    cfg=cfg)
        ms_iter = time_program(prog)
        solvers[name] = {"ms_per_outer_iter": ms_iter,
                         "kernel": kernel,
                         "kernel_share": results[kernel]["ms"] / ms_iter}
    del X, y, prog
    torch.cuda.empty_cache()
    lap("serial_and_dense_solvers")

    # -- the sparse path: news20 profile, 28 padded-ELL cells
    torch.cuda.reset_peak_memory_stats()
    sp = news20_problem(dev)
    sp_shape = (sp.n_p, sp.k, sp.m_q, 8 * sp.cols.numel())
    alpha20, w20 = news20_state(sp)
    sargs = sdca_sparse_main_inputs(sp, alpha20, w20)
    skw = dict(lam=LAM20, n=N20, Q=Q, loss="hinge")
    vargs, lo, eta = svrg_sparse_main_inputs(sp, w20)
    vkw = dict(lam=LAM20, eta=eta, loss="hinge", lo=lo)
    # B3: plain, lookahead, block, block, lookahead, plain
    plain_s = [plain_loop_ms(lambda: sdca_epoch_sparse_plain(*sargs, **skw))]
    kern_s = [both_ms(lambda: sdca_epoch_sparse(*sargs, **skw), reps=7)]
    prev_s = [both_ms(lambda: sparse_route_launch(sargs, skw, "block"),
                      reps=5)]
    prev_s.append(both_ms(lambda: sparse_route_launch(sargs, skw, "block"),
                          reps=5))
    if svrg_sparse_route(vargs[5].shape[2], sp.k) != "cluster":
        raise AssertionError("the news20 window is not on the cluster route")

    def block_route():            # the route the main path took before
        return svrg_sparse._launch(*vargs, lo, lam=LAM20, eta=eta,
                                   loss_id=0, route="block")
    plain_v = [plain_loop_ms(lambda: svrg_inner_sparse_plain(*vargs, **vkw))]
    kern_v = [both_ms(lambda: svrg_inner_sparse(*vargs, **vkw), reps=7)]
    prev_v = [both_ms(block_route, reps=5), both_ms(block_route, reps=5)]
    kern_v.append(both_ms(lambda: svrg_inner_sparse(*vargs, **vkw), reps=7))
    plain_v.append(plain_loop_ms(
        lambda: svrg_inner_sparse_plain(*vargs, **vkw)))
    kern_s.append(both_ms(lambda: sdca_epoch_sparse(*sargs, **skw), reps=7))
    plain_s.append(plain_loop_ms(
        lambda: sdca_epoch_sparse_plain(*sargs, **skw)))
    results["sdca_epoch_sparse"]["gated"] = gated_timing(
        sdca_epoch_sparse, sargs, skw, 3, 3 * sp.n_p + sp.n_p // 2,
        ONLINE_SPARSE_ROWS)
    results["sdca_epoch_sparse"].update(
        **medians(kern_s, "ms"), plain_ms=statistics.median(plain_s),
        library_ms=None, prev_route="block", **medians(prev_s, "prev_route_ms"),
        **sparse_bounds("sdca_epoch_sparse", sargs))
    results["svrg_inner_sparse"].update(
        **medians(kern_v, "ms"), plain_ms=statistics.median(plain_v),
        library_ms=None, prev_route="block",
        **medians(prev_v, "prev_route_ms"),
        **sparse_bounds("svrg_inner_sparse", vargs, lo))
    # the tenant timings' stacked inputs stay out of the sparse path's peak
    peak_before = torch.cuda.max_memory_allocated()
    tenants = sparse_tenants(sp, alpha20, w20, FLEET_T_SPARSE)
    for name, prev in (("sdca_epoch_sparse",
                        lambda a, kw: sparse_route_launch(a, kw, "block")),
                       ("svrg_inner_sparse", None)):
        results[name]["tenants"] = tenant_timing(
            name, tenants, functools.partial(sparse_bounds, name), prev)
    torch.cuda.reset_peak_memory_stats()
    del sargs, vargs, alpha20, w20, tenants
    hinge = get_loss("hinge")
    for name, kernel, build in (
            ("d3ca_sparse", "sdca_epoch_sparse",
             lambda: d3ca_simulated_program(hinge, sp,
                                            D3CAConfig(lam=LAM20))),
            ("radisa_sparse", "svrg_inner_sparse",
             lambda: radisa_simulated_program(hinge, sp,
                                              RADiSAConfig(lam=LAM20))),
            ("sfk_sparse", "svrg_inner_sparse",
             lambda: sfk_simulated_program(hinge, sp,
                                           SFKConfig(lam=LAM20)))):
        ms_iter = time_program(build())
        solvers[name] = {"ms_per_outer_iter": ms_iter, "kernel": kernel,
                         "kernel_share": results[kernel]["ms"] / ms_iter}
    sparse_peak = max(peak_before, torch.cuda.max_memory_allocated())
    del sp
    news20_problem.cache_clear()
    gc.collect()
    torch.cuda.empty_cache()
    lap("sparse")
    fleets = fleet_timing(dev)
    lap("fleets")
    lm = lm_timing(dev, results)
    lap("lm")
    emit("timing", split_s=split, solvers=solvers, fleets=fleets,
         sparse_peak_mem_bytes=sparse_peak,
         sparse_cells={"P": P, "Q": Q, "n_p": sp_shape[0], "k": sp_shape[1],
                       "m_q": sp_shape[2], "ell_bytes": sp_shape[3]},
         lm=lm,
         kernels={k: {f: v.get(f) for f in (
             "ms", "device_ms", "plain_ms", "library_ms", "library_device_ms",
             "bound_ms", "bound_by", "bytes_moved", "prev_route",
             "prev_route_ms", "prev_route_device_ms", "shapes",
             "tenants")}
                  for k, v in results.items()})


def flash_pairs(S, Skv, causal, window):
    """Unmasked (query, key) pairs of one head: query i sees keys
    [max(0, i - window + 1), i] (causal) or up to Skv - 1 (not)."""
    i = np.arange(S)
    hi = np.minimum(i + 1, Skv) if causal else np.full(S, Skv)
    lo = np.maximum(i - window + 1, 0) if window is not None else 0
    return int(np.maximum(hi - lo, 0).sum())


def flash_bound(B, S, H, KV, D, nbytes_el, Skv=None, causal=True,
                window=None):
    """Least time of one flash attention call: q, k, v read once and out
    written once; 4 D flops (q.k and p.v) per unmasked (query, key) pair
    (``flash_pairs``: S (S + 1) / 2 a head when causal without a window),
    at the bf16 tensor-core peak."""
    Skv = S if Skv is None else Skv
    nbytes = nbytes_el * B * D * (2 * S * H + 2 * Skv * KV)
    flops = 4 * D * flash_pairs(S, Skv, causal, window) * B * H
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / PEAK_BF16_FLOPS
    return {"bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes_moved": nbytes, "flops": flops}


def linattn_bound(BH, S, D, C=64, sub=16):
    """Least time of one chunked linear attention call, for the work of
    the tensor-core route: r, k, v, logw read once, out and the state
    written once.  Per chunk of c tokens in sub-chunks of ``sub``: on the
    tensor cores, as three TF32 products each (3xTF32: a third of the
    TF32 peak), r.S0 and the state update 2 c D^2 each, scores times v
    c (c - 1) D, and the scores of token pairs in different sub-chunks
    2 D each; on the CUDA cores at the float32 peak, the scores of pairs
    within a sub-chunk (an exp, a multiply and an FMA a channel: 4 D),
    the bonus 4 c D, the decays 4 c D and the state decay D^2.  The two
    kinds of core run at once, so the operations take the longer of
    their two times."""
    nbytes = 4 * (5 * BH * S * D + BH * D * D)
    tc_flops = simt_flops = 0
    for t0 in range(0, S, C):
        c = min(C, S - t0)
        pairs = c * (c - 1) // 2
        diag = sum(b * (b - 1) // 2
                   for b in (min(sub, c - s) for s in range(0, c, sub)))
        tc_flops += 4 * c * D * D + 2 * pairs * D + 2 * (pairs - diag) * D
        simt_flops += 4 * diag * D + 8 * c * D + D * D
    tc_flops *= BH
    simt_flops *= BH
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = max(3 * tc_flops / PEAK_TF32_FLOPS, simt_flops / PEAK_F32_FLOPS)
    return {"bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes_moved": nbytes, "flops": tc_flops + simt_flops,
            "tensor_core_flops": tc_flops}


def device_busy(fn, reps=1):
    """What the device does during ``fn()``, by ``torch.profiler``: the
    kernels' own device time per call (ms), the kernels launched per
    call, and the five kernels with the most device time (name, ms per
    call).  Against the call's CUDA-event time this gives the device's
    idle share.  One traced call after a warm-up by default: the trace's
    processing on the host is the cost, and it grows with the calls."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    # the kernels themselves (the operators that launch them report the
    # same device time again)
    evts = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    evts.sort(key=lambda e: -e.self_device_time_total)
    return {"busy_ms": sum(e.self_device_time_total for e in evts)
            / 1e3 / reps,
            "kernels_per_call": sum(e.count for e in evts) / reps,
            "top": [[e.key[:80], e.self_device_time_total / 1e3 / reps]
                    for e in evts[:5]]}


def with_idle(ms, busy):
    busy = dict(busy)
    busy["idle_share"] = 1.0 - busy["busy_ms"] / ms if busy["busy_ms"] \
        else None                  # no device time seen: not measured
    return busy


def flash_family_timing(rng, dev, results):
    """B5 at the other families' main-path shapes (``FLASH_FAMILY_SHAPES``):
    kernel, forced CUDA-core route (D 256), plain version (a KV head group
    at a time), SDPA on the expanded heads with the same mask, and the
    bound of this shape's unmasked pairs."""
    for label, (B, S, Skv, H, KV, D, causal, window) in \
            FLASH_FAMILY_SHAPES.items():
        q, k, v = flash_inputs(rng, B, S, H, KV, D, torch.bfloat16, dev,
                               Skv=Skv)
        G = H // KV
        qs, ks, vs = (q.transpose(1, 2),
                      k.repeat_interleave(G, 2).transpose(1, 2),
                      v.repeat_interleave(G, 2).transpose(1, 2))
        qp = torch.arange(S, device=dev)[:, None]
        kp = torch.arange(Skv, device=dev)[None, :]
        mask = None
        if window is not None:
            mask = (qp - kp < window) & ((qp >= kp) if causal else True)
        kw = dict(causal=causal, window=window)

        def kernel():
            return flash_attention(q, k, v, **kw)

        def library():
            if mask is None:
                return torch.nn.functional.scaled_dot_product_attention(
                    qs, ks, vs, is_causal=causal)
            return torch.nn.functional.scaled_dot_product_attention(
                qs, ks, vs, attn_mask=mask)
        kern = [both_ms(kernel, reps=10)]
        lib = [both_ms(library, reps=10), both_ms(library, reps=10)]
        kern.append(both_ms(kernel, reps=10))
        plain = cuda_ms(lambda: plain_by_heads(q, k, v, **kw), reps=2)
        row = {**medians(kern, "ms"), "plain_ms": plain,
               **medians(lib, "library_ms"),
               **flash_bound(B, S, H, KV, D, 2, Skv=Skv, causal=causal,
                             window=window)}
        if D == 256:
            def simt_route():
                return flash_ops._launch(q, k, v, causal, window,
                                         D ** -0.5, "simt")
            row.update(medians([both_ms(simt_route, reps=3)],
                               "simt_route_ms"))
        results["flash_attention"].setdefault("shapes", {}).setdefault(
            label, {}).update(row)
        del q, k, v, qs, ks, vs, mask
        torch.cuda.empty_cache()


def lm_timing(dev, results):
    """B5 and B6 at their main-path shapes (kernel, plain version and, for
    B5, ``F.scaled_dot_product_attention`` on the expanded heads -- timed
    here only, the port never calls it), then the full-width models:
    Qwen3 prefill of one 1024-token bucket and one paged decode step of 8
    slots, RWKV6 prefill of 8 x 512 tokens."""
    rng = np.random.default_rng(11)
    B, S, H, KV, D = FLASH_MAIN
    q, k, v = flash_inputs(rng, B, S, H, KV, D, torch.bfloat16, dev)
    G = H // KV
    qs, ks, vs = (q.transpose(1, 2),
                  k.repeat_interleave(G, 2).transpose(1, 2),
                  v.repeat_interleave(G, 2).transpose(1, 2))
    if flash_route(q.dtype, D) != "tc":
        raise AssertionError("the Qwen3 prefill shape is not on the "
                             "tensor-core route")

    def simt_route():             # the route the main path took before
        return flash_ops._launch(q, k, v, True, None, D ** -0.5, "simt")
    plain = [cuda_ms(lambda: flash_attention_plain(q, k, v), reps=5)]
    kern = [both_ms(lambda: flash_attention(q, k, v), reps=20)]
    prev = [both_ms(simt_route, reps=20)]

    def library():
        return torch.nn.functional.scaled_dot_product_attention(
            qs, ks, vs, is_causal=True)
    lib = [both_ms(library, reps=20), both_ms(library, reps=20)]
    prev.append(both_ms(simt_route, reps=20))
    kern.append(both_ms(lambda: flash_attention(q, k, v), reps=20))
    plain.append(cuda_ms(lambda: flash_attention_plain(q, k, v), reps=5))
    results["flash_attention"].update(
        **medians(kern, "ms"), plain_ms=statistics.median(plain),
        **medians(lib, "library_ms"), prev_route="simt",
        **medians(prev, "prev_route_ms"),
        **flash_bound(B, S, H, KV, D, 2))
    del q, k, v, qs, ks, vs

    flash_family_timing(rng, dev, results)

    Bl, Sl, Hl, Dl = LINATTN_MAIN
    r, k, v, lw, u = linattn_inputs(rng, Bl * Hl, Sl, Dl, dev, heads=Hl)
    if linattn_route(Dl, 64) != "tc":
        raise AssertionError("the RWKV6 prefill shape is not on the "
                             "tensor-core route")
    plain = [cuda_ms(lambda: rwkv_linattn_ref(r, k, v, lw, u), reps=3)]
    kern = [both_ms(lambda: rwkv_linattn(r, k, v, lw, u), reps=20)]
    prev = [both_ms(lambda: linattn_simt(r, k, v, lw, u), reps=10),
            both_ms(lambda: linattn_simt(r, k, v, lw, u), reps=10)]
    kern.append(both_ms(lambda: rwkv_linattn(r, k, v, lw, u), reps=20))
    plain.append(cuda_ms(lambda: rwkv_linattn_ref(r, k, v, lw, u), reps=3))
    results["rwkv_linattn"].update(
        **medians(kern, "ms"), plain_ms=statistics.median(plain),
        library_ms=None, prev_route="simt", **medians(prev, "prev_route_ms"),
        **linattn_bound(Bl * Hl, Sl, Dl))
    del r, k, v, lw, u

    out = {}
    # Qwen3-1.7B: prefill of one bucket, then a decode step of 8 slots
    model = Transformer(get_config("qwen3-1.7b"), device=dev)
    params = model.compute_params(model.init(0))
    toks = torch.as_tensor(rng.integers(0, model.cfg.vocab, (1, S)),
                           device=dev)
    pc = PagedCacheConfig(page_size=16, num_pages=1024)
    arenas = make_paged_arenas(model.cfg, pc, dev)
    slots, max_pages = 8, pc.pages_for(2048)
    bt = torch.arange(slots * max_pages, device=dev).reshape(
        slots, max_pages) % pc.num_pages
    lengths = torch.full((slots,), 600, device=dev)
    active = torch.ones(slots, dtype=torch.bool, device=dev)
    step_toks = torch.zeros((slots, 1), dtype=torch.long, device=dev)

    def prefill():
        return model.prefill(params, {"tokens": toks}, S, last_pos=S - 1,
                             linear_cache=True)

    def decode():
        return model.decode_step_paged(params, arenas, {"tokens": step_toks},
                                       bt, lengths, active)
    pre_ms = cuda_ms(prefill, reps=5)
    dec_ms = cuda_ms(decode, reps=10)
    out["qwen3"] = {"prefill_ms": pre_ms, "prefill_tokens": S,
                    "decode_step_ms": dec_ms, "decode_slots": slots,
                    "decode_kv_len": 600,
                    "flash_share_of_prefill":
                        28 * results["flash_attention"]["device_ms"]
                        / pre_ms,
                    "prefill_device": with_idle(pre_ms, device_busy(prefill)),
                    "decode_device": with_idle(dec_ms, device_busy(decode))}
    del model, params, arenas
    gc.collect()
    torch.cuda.empty_cache()

    # RWKV6-3B: prefill of 8 prompts of 512 tokens
    model = Transformer(get_config("rwkv6-3b"), device=dev)
    params = model.compute_params(model.init(0))
    toks = torch.as_tensor(rng.integers(0, model.cfg.vocab, (Bl, Sl)),
                           device=dev)

    def rwkv_prefill():
        return model.prefill(params, {"tokens": toks}, Sl + 32)
    pre_ms = cuda_ms(rwkv_prefill, reps=5)
    out["rwkv6"] = {"prefill_ms": pre_ms, "prefill_tokens": Bl * Sl,
                    "linattn_share_of_prefill":
                        32 * results["rwkv_linattn"]["ms"] / pre_ms,
                    "prefill_device": with_idle(pre_ms,
                                                device_busy(rwkv_prefill))}
    del model, params
    gc.collect()
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# side runs: phases a second process of this script drives beside this one
# ---------------------------------------------------------------------------

#: the phases two other processes of this script drive while this one runs
#: the solver paths: the kernels phase (checks only), and the LM paths of
#: at most 40 GB of the card's memory, whose steps are host-bound as the
#: solver paths' are (the card idles most of the time in all of them).
#: Each side counts its launches as this process does.
SIDES = (("kernels",),
         ("serve_qwen3_full", "serve_rwkv6_full", "train_qwen3_full",
          "train_rwkv6_full", "serve_mixtral_full", "serve_vlm_full",
          "serve_musicgen_full", "serve_qwen3_int8_full",
          "train_musicgen_full"))
#: the phases that run once the sides have ended, alone on the card: the
#: LM paths that take up to 67 GB of its memory, and the ones that start
#: process grids (then cpu_vs_card and the timing)
ALONE_PATHS = ("serve_recurrentgemma_full", "train_mixtral_full",
               "train_recurrentgemma_full", "fleet_mesh_full", "mesh_full",
               "examples_full", "train_mesh_full",
               "train_mesh_families_full", "serve_mesh_full")
#: what the kernels phase sets on a kernel's entry of the kernels line
KERNELS_PHASE_KEYS = ("max_abs_err", "max_abs_ref", "rel_err", "outputs",
                      "max_abs_err_vs_plain_f32", "reference", "draws",
                      "tol", "tenant_main", "sweep_cases",
                      "sweep_max_abs_err", "sweep_tol",
                      "checked_launches_by_route", "ok")


class SideRun:
    """``python3 chip_smoke.py --phases <phases> --side-out <json>`` in a
    process of its own, started now: it prints into a file, and writes
    its kernels line's entries (the launches of its main paths, the
    kernels phase's readings) to the json when it ends."""

    def __init__(self, phases):
        self.phases = tuple(phases)
        self.dir = tempfile.mkdtemp(prefix="chip_side_")
        self.out = os.path.join(self.dir, "results.json")
        self.log = open(os.path.join(self.dir, "stdout.txt"), "w+")
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--phases",
             ",".join(self.phases), "--side-out", self.out],
            stdout=self.log, cwd=ROOT)

    def join(self, results):
        """Wait for the side, print its lines (phase_time lines marked
        ``"side": true``; its env and build lines are this run's) and add
        its counts to ``results``; raise if it failed."""
        rc = self.proc.wait()
        waited = time.perf_counter() - self.t0
        self.log.seek(0)
        lines = self.log.read().splitlines()
        for ln in lines:
            try:
                rec = json.loads(ln)
            except ValueError:
                rec = None
            if isinstance(rec, dict) and rec.get("phase") in ("env",
                                                              "build"):
                continue
            if isinstance(rec, dict) and rec.get("phase") == "phase_time":
                ln = json.dumps({**rec, "side": True})
            print(ln, flush=True)
        if rc != 0:
            raise AssertionError(f"the side run of {list(self.phases)} "
                                 f"failed (exit {rc}); its error output "
                                 "is above")
        with open(self.out) as fh:
            side = json.load(fh)
        add_side(results, side, readings="kernels" in self.phases)
        emit("side_run", phases=list(self.phases), seconds=waited)

    def stop(self):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()
        self.log.close()
        shutil.rmtree(self.dir, ignore_errors=True)


def add_side(results, side, readings):
    """Add a side run's launches to ``results`` -- in all, by route, by
    head dim and, for B1, by shape -- and, when it ran the kernels phase
    (``readings``), take over that phase's readings."""
    for name, res in side.items():
        mine = results[name]
        mine["launches"] += res["launches"]
        for r, n in res["routes"].items():
            mine["routes"][r] += n
        if res.get("launches_by_head_dim"):
            dims = mine.setdefault("launches_by_head_dim", {})
            for key, n in res["launches_by_head_dim"].items():
                dims[key] = dims.get(key, 0) + n
        if name == "sdca_epoch":
            for shape, v in res["shapes"].items():
                mine["shapes"][shape]["launches"] += v["launches"]
        if readings:
            mine.update({k: res[k] for k in KERNELS_PHASE_KEYS if k in res})
            if name == "flash_attention":
                mine["shapes"] = res["shapes"]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of: " + ", ".join(PHASES))
    ap.add_argument("--side-out", metavar="JSON",
                    help="a side run (see SideRun): drive --phases alone "
                         "and write the kernels line's entries to JSON in "
                         "place of the last lines")
    args = ap.parse_args(argv)
    phases = [p for p in args.phases.split(",") if p]
    unknown = set(phases) - set(PHASES)
    if unknown:
        ap.error(f"unknown phases {sorted(unknown)}")

    smi = phase_env()
    dev = torch.device("cuda")
    phase_build()
    sides = []
    if not args.side_out:
        for group in SIDES:
            beside = [p for p in group if p in phases]
            if beside and set(phases) - set(beside):
                sides.append(SideRun(beside))
    try:
        return run_phases(args, phases, smi, dev, sides)
    finally:
        for side in sides:
            side.stop()


def run_phases(args, phases, smi, dev, sides):
    """The phases of ``main`` after the build, the sides' ones left to
    them."""
    memo = DataMemo()
    memo.install()
    results = {name: {"name": name, **meta, "launches": 0,
                      "routes": dict.fromkeys(route_counts(name), 0),
                      "max_abs_err": None, "ms": None, "plain_ms": None,
                      "bound_ms": None, "bound_by": None, "library_ms": None}
               for name, meta in KERNEL_META.items()}
    results["sdca_epoch"]["shapes"] = {"d3ca_cells": {"launches": 0},
                                       "serial": {"launches": 0}}
    t_start = time.perf_counter()

    def timed(name, fn, *a):
        t0 = time.perf_counter()
        fn(*a)
        emit("phase_time", of=name, seconds=time.perf_counter() - t0,
             since_start_s=time.perf_counter() - t_start)

    here = set(phases) - {p for side in sides for p in side.phases}

    def join_sides():
        while sides:
            sides[0].join(results)
            sides.pop(0).stop()

    if "kernels" in here:
        timed("kernels", phase_kernels, dev, results)

    # the main paths: every count to 0 just before each, read just after
    for name in MAIN_PATHS:
        if name in ALONE_PATHS:
            join_sides()
        if name in here:
            phase = (functools.partial(phase_train, name)
                     if name in TRAIN_PATHS else globals()[f"phase_{name}"])
            timed(name, run_main_path, name, phase, results)
    join_sides()
    if args.side_out:
        with open(args.side_out, "w") as fh:
            json.dump(results, fh)
        return 0
    if set(phases) >= set(MAIN_PATHS):
        for name, res in results.items():
            if res["launches"] < 1:
                raise AssertionError(f"the main path never launched {name}")

    if "cpu_vs_card" in phases:
        timed("cpu_vs_card", phase_cpu_vs_card)
    if "timing" in phases:
        timed("timing", phase_timing, dev, results)
    emit("data_memo", **memo.report())

    print(smi, flush=True)
    print(json.dumps({"kernels": list(results.values())}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

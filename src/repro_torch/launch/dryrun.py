"""Dry run of every (arch x shape x mesh) cell (the port of
``repro/launch/dryrun.py``): what one device of a production mesh would
do in one step, counted without a device.

The production meshes (16 x 16 and 2 x 16 x 16, ``launch/mesh.py::
make_production_mesh``) describe layouts; they never launch.  So for
every cell this runs rank 0's step -- the same code a launched rank runs:
``launch/mesh_train.py::rank_train_step``, or the rank's views and
``Transformer.prefill`` / ``decode_step`` of ``launch/mesh_serve.py`` --
on the ``meta`` device:

  1. every tree of the cell from ``launch/steps.py::input_specs``, each
     leaf the rank's block (its ``local_shape``) as a meta tensor, on a
     ``RankMesh`` of the production shape whose process groups are
     :class:`~repro_torch.sharding.collectives.CountingGroup` stand-ins:
     every collective counts its bytes and moves nothing;
  2. the step under ``torch.utils.flop_counter.FlopCounterMode`` and a
     dispatch mode that adds up the bytes of every operand and result of
     every operation that is not a view; the kernels' meta paths add
     their own FLOPs and bytes (``kernels/_launch.py::META_WORK``);
  3. the record, in the reference's keys, into ``REPRO_DRYRUN_DIR``
     (default ``experiments/dryrun_torch/``, beside -- never over -- the
     reference's ``experiments/dryrun/``).

``flops`` and ``bytes_accessed`` are the rank's whole step (the port
counts every layer and microbatch it runs: no scan body counted once);
``FlopCounterMode`` counts the matrix products (an element-wise
operation counts no FLOPs there), the kernels' meta paths their own;
``collectives`` holds the bytes counted from the specs
(``roofline/collectives.py``), which the run's counted bytes must equal
(the cell fails otherwise); ``memory`` holds the rank's parameter,
optimizer, view, batch and cache bytes against one card's 80 GB --
activations and temporaries are not tracked.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen3-1.7b --shape decode_32k
  python -m repro_torch.launch.dryrun --arch granite-20b --multi-pod
  python -m repro_torch.launch.dryrun --all     # both meshes
  python -m repro_torch.launch.dryrun --all --multi-pod
  python -m repro_torch.launch.dryrun --calib --arch qwen3-1.7b
  python -m repro_torch.launch.dryrun --paper d3ca [--backend kernel]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode

from ..configs import ARCHS, get_config
from ..core.util import tree_leaves, tree_unflatten
from ..kernels import _launch
from ..models.config import LM_SHAPES
from ..models.transformer import Transformer
from ..optim import AdamWConfig
from ..roofline import (HW_H100, collective_bytes, roofline_terms,
                        step_collectives)
from ..sharding import collectives as coll
from .mesh import RankMesh, make_production_mesh
from .mesh_serve import gather_views
from .steps import cache_specs, input_specs

#: one card's memory, the bound ``memory`` is held against
DEVICE_BYTES = 80e9
META = torch.device("meta")


def out_dir() -> str:
    return os.environ.get("REPRO_DRYRUN_DIR", os.path.join(
        os.path.dirname(__file__), "../../../experiments/dryrun_torch"))


def cell_skip_reason(cfg, shape):
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return ("full softmax attention is O(S) memory per decoded token at "
                "S=524288; skipped per assignment rules (DESIGN.md §5)")
    return None


# ---------------------------------------------------------------------------
# a rank that is never launched
# ---------------------------------------------------------------------------

class _Context:
    """What a ``RankMesh`` reads of a rank's context: the grid's shape,
    the rank (0), the meta device, and counting groups of the right
    sizes."""

    def __init__(self, mesh):
        self.P, self.Q = mesh.batch_size, mesh.model_size
        self.rank = 0
        self.device = META

    def group(self, axis: str):
        return coll.CountingGroup(self.Q if axis == "model" else self.P)

    def pod_group(self, G: int):
        return coll.CountingGroup(self.P // G)

    def cross_group(self, G: int):
        return coll.CountingGroup(G)


class _RankMesh(RankMesh):
    def world(self):
        return coll.CountingGroup(self.size)


class _Bytes(TorchDispatchMode):
    """The bytes of every operand and result of every operation that is
    not a view."""

    def __init__(self):
        super().__init__()
        self.total = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not func.is_view:
            flat, _ = tree_flatten((args, kwargs or {}, out))
            self.total += sum(t.numel() * t.element_size() for t in flat
                              if isinstance(t, torch.Tensor))
        return out


def _count(run):
    """``run()`` counted: (FLOPs, bytes accessed, wire bytes by kind,
    collective calls by kind)."""
    _launch.META_WORK.update(flops=0.0, bytes=0.0)
    wire, calls = dict(coll.WIRE), dict(coll.CALLS)
    with FlopCounterMode(display=False) as flops, _Bytes() as nbytes:
        run()
    return (float(flops.get_total_flops()) + _launch.META_WORK["flops"],
            float(nbytes.total) + _launch.META_WORK["bytes"],
            {k: coll.WIRE[k] - wire[k] for k in coll.WIRE},
            {k: coll.CALLS[k] - calls[k] for k in coll.CALLS})


def _blocks(structs):
    """A tree of meta tensors of the structs' local shapes."""
    return tree_unflatten(structs, [
        torch.empty(s.local_shape, dtype=s.dtype, device=META)
        for s in tree_leaves(structs)])


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def _view_bytes(model: Transformer, blocks) -> int:
    """The float32 views a training step gathers (the blocks grown by the
    axes each leaf's plan gathers over)."""
    total = 0
    for pl, b in zip(tree_leaves(model.view_plans), tree_leaves(blocks)):
        n = b.numel()
        for _, axes, _ in pl.gathers:
            n *= pl.mesh.group_size(axes)
        total += n * 4
    return total


def rank_step(cfg, shape, mesh) -> dict:
    """Rank 0's step of cell (``cfg``, ``shape``) on ``mesh``, counted on
    the meta device: its ``flops``, ``bytes_accessed``, ``collectives``
    (from the specs, equal to the counted bytes), ``memory``."""
    from .mesh_train import rank_train_step
    t0 = time.perf_counter()
    cell = input_specs(cfg, shape, mesh)
    rm = _RankMesh(mesh, _Context(mesh))
    model = Transformer(cfg, mesh=rm)
    params = _blocks(cell.params)
    batch = _blocks(cell.batch)
    mem = {"params_bytes": _nbytes(params), "batch_bytes": _nbytes(batch)}
    once = None
    if shape.kind == "train":
        state = {"count": torch.zeros((), dtype=torch.int32, device=META),
                 "mu": _blocks(cell.params), "nu": _blocks(cell.params)}
        opt = {f.name: getattr(AdamWConfig(), f.name)
               for f in dataclasses.fields(AdamWConfig) if f.name != "lr"}
        pieces = []

        def run():
            pieces.append(rank_train_step(model, rm, params, state, batch,
                                          None, 1e-3, opt)[4])
        mem["opt_bytes"] = 2 * mem["params_bytes"] + 4
        mem["views_bytes"] = mem["view_grads_bytes"] = _view_bytes(
            model, params)
    else:
        before = dict(coll.WIRE)
        with torch.no_grad():
            views = gather_views(model, tree_leaves(params))
        once = {k: coll.WIRE[k] - before[k] for k in coll.WIRE}
        mem["views_bytes"] = _nbytes(views)
        cache_structs = cache_specs(model, dataclasses.replace(
            shape, kind="decode"), mesh)
        blocks = _blocks({"periods": cache_structs["periods"],
                          "remainder": cache_structs["remainder"]})
        mem["cache_bytes"] = _nbytes(blocks)

        def run():
            with torch.no_grad():
                if shape.kind == "prefill":
                    model.prefill(views, batch, shape.seq)
                else:
                    model.decode_step(views, {"pos": shape.seq - 1,
                                              "cache_len": shape.seq,
                                              **blocks}, batch)
    build_s = time.perf_counter() - t0
    flops, nbytes, wire, calls = _count(run)
    described = Transformer(cfg, device="meta", mesh=mesh)
    spec = step_collectives(described, shape)
    counted = collective_bytes(wire, calls)
    if counted["by_kind_bytes"] != spec["by_kind_bytes"] or (
            once is not None
            and collective_bytes(once)["by_kind_bytes"]
            != spec["once"]["by_kind_bytes"]):
        raise RuntimeError(
            f"{cfg.name} x {shape.name}: the step handed {wire} (views "
            f"{once}) to its collectives, the specs count {spec}")
    spec["by_kind_count"] = counted["by_kind_count"]
    total = sum(v for k, v in mem.items())
    mem.update(total_bytes=total, device_bytes=DEVICE_BYTES,
               fits=total <= DEVICE_BYTES,
               counted=sorted(k for k in mem if k.endswith("_bytes")
                              and k not in ("total_bytes",
                                            "device_bytes")),
               not_counted="activations and temporaries (not tracked)")
    out = {"flops": flops, "bytes_accessed": nbytes, "collectives": spec,
           "memory": mem, "build_s": round(build_s, 2),
           "trace_s": round(time.perf_counter() - t0 - build_s, 2)}
    if shape.kind == "train":
        out["pieces"] = pieces[0]
    return out


# ---------------------------------------------------------------------------
# the cells
# ---------------------------------------------------------------------------

def _mesh_name(multi_pod: bool) -> str:
    return "2x16x16" if multi_pod else "16x16"


def run_cell(arch: str, shape_name: str, multi_pod: bool, save: bool = True):
    cfg = get_config(arch)
    shape = next(s for s in LM_SHAPES if s.name == shape_name)
    skip = cell_skip_reason(cfg, shape)
    mesh_name = _mesh_name(multi_pod)
    result = {"arch": cfg.name, "shape": shape.name, "mesh": mesh_name,
              "kind": shape.kind}
    if skip:
        result["status"] = "skipped"
        result["reason"] = skip
        _save(result, f"{arch}__{shape_name}__{mesh_name}.json", save)
        print(f"[dryrun] {cfg.name} x {shape.name} x {mesh_name}: SKIP "
              f"({skip})")
        return result
    got = rank_step(cfg, shape, make_production_mesh(multi_pod=multi_pod))
    result["status"] = "ok"
    result.update(got)
    if shape.kind == "train":
        result["accum_steps"] = cfg.train_accum
    result["roofline"] = roofline_terms(
        result["flops"], result["bytes_accessed"],
        result["collectives"]["total_bytes"], HW_H100)
    _save(result, f"{arch}__{shape_name}__{mesh_name}.json", save)
    print(f"[dryrun] {cfg.name} x {shape.name} x {mesh_name}: OK "
          f"(trace {result['trace_s']:.1f}s, GFLOP "
          f"{result['flops'] / 1e9:.1f}, coll GB "
          f"{result['collectives']['total_bytes'] / 1e9:.3f}, memory GB "
          f"{result['memory']['total_bytes'] / 1e9:.2f})")
    return result


def _save(result, name: str, save: bool):
    if not save:
        return
    os.makedirs(out_dir(), exist_ok=True)
    with open(os.path.join(out_dir(), name), "w") as fh:
        json.dump(result, fh, indent=1)


def run_calibration(arch: str, shape_name: str, save: bool = True):
    """Count 1 and 2 pattern periods (every layer its own, full
    attention, one microbatch, one cross-entropy pass) on the 16 x 16
    mesh: the difference B - A is one period's cost (compute, bytes, wire
    bytes), as the reference's calibration has it."""
    cfg = get_config(arch)
    shape = next(s for s in LM_SHAPES if s.name == shape_name)
    if cell_skip_reason(cfg, shape):
        return None
    k = len(cfg.pattern)
    mesh = make_production_mesh(multi_pod=False)
    out = {"arch": cfg.name, "shape": shape.name, "variants": {}}
    for label, layers in (("A", k), ("B", 2 * k)):
        ccfg = dataclasses.replace(
            cfg, n_layers=layers, unroll=True, attn_impl="full",
            train_accum=1, loss_chunk=None)
        got = rank_step(ccfg, shape, mesh)
        out["variants"][label] = {
            "layers": layers, "flops": got["flops"],
            "bytes_accessed": got["bytes_accessed"],
            "collectives": got["collectives"], "trace_s": got["trace_s"]}
        print(f"[calib] {arch} x {shape_name} {label}({layers}L): "
              f"GFLOP {got['flops'] / 1e9:.2f}")
    _save(out, f"{arch}__{shape_name}__calib.json", save)
    return out


# ---------------------------------------------------------------------------
# the paper's own workload
# ---------------------------------------------------------------------------

class _Indices:
    """A rank's coordinate orders on the meta device (their values never
    matter to a count)."""

    def __init__(self, steps: int):
        self.steps = steps

    def sdca_rows(self, t):
        return torch.zeros((1, self.steps), dtype=torch.int32, device=META)

    def svrg_rows(self, t):
        return torch.zeros((1, 1, self.steps), dtype=torch.int32,
                           device=META)

    def radisa_perm(self, t):
        return torch.zeros((1,), dtype=torch.int64, device=META)


def _paper_comm(schedule, sizes):
    """A ``Comm`` for one rank's cell whose collectives count each cell
    payload (an all-reduce for psum / pmean, an all-gather of the group's
    cells for allgather) and reduce the rank's one cell as the grid
    engine would (shapes only)."""
    from ..core.comm import Comm, GridWire

    class Counting(Comm):
        def _exec(self, point, value):
            n = value[0, 0].numel() * value.element_size()
            kind = "all_gather" if point.op == "allgather" else "all_reduce"
            coll.WIRE[kind] += n * (sizes[point.axis] if kind == "all_gather"
                                    else 1)
            coll.CALLS[kind] += 1
            return self.wire.reduce(point, value)
    return Counting(schedule, sizes, device="meta",
                    wire=GridWire({"data": 1, "model": 1}))


def run_paper_cell(algo: str = "d3ca", multi_pod: bool = False,
                   save: bool = True, block_n: int = 40960,
                   block_m: int = 5120, inner_steps: int = None,
                   local_backend: str = "ref"):
    """The paper's doubly distributed hinge SVM at production mesh scale:
    one (block_n x block_m) block a device (the paper's weak-scaling cell,
    40k x 5k), one rank's cell of the solver's program
    (``get_solver(algo)``'s config; the D3CA or RADiSA cell program with
    ``local_backend`` "ref" -- the plain step loop -- or "kernel" -- the
    CUDA kernels' meta paths) for one outer step, its declared collectives
    counted.  ``full`` is the step with one local epoch of ``inner``
    steps; ``calib_A`` / ``calib_B`` the step with 1 and 2.  Every inner
    step does the same work, so for the plain loop ``full`` is counted as
    ``A + (inner - 1) (B - A)`` (exact; tracing 40 960 steps would take
    minutes)."""
    from ..core.d3ca import d3ca_cell_program
    from ..core.losses import get_loss
    from ..core.radisa import radisa_cell_program
    from ..core.solver import get_solver

    mesh = make_production_mesh(multi_pod=multi_pod)
    Pn, Qn = mesh.batch_size, mesh.model_size
    n, m = Pn * block_n, Qn * block_m
    mesh_name = _mesh_name(multi_pod)
    inner = inner_steps or block_n
    loss = get_loss("hinge")
    config_cls = get_solver(algo).config_cls
    sizes = {"data": Pn, "model": Qn}

    def f32(*shape):
        return torch.empty(shape, dtype=torch.float32, device=META)

    def count(steps):
        if algo == "d3ca":
            prog = d3ca_cell_program(
                loss, config_cls(lam=1e-2, local_steps=steps), n=n,
                index_source=_Indices(steps), local_backend=local_backend)
            state = (f32(1, block_n), f32(1, block_m))
        else:
            prog = radisa_cell_program(
                loss, config_cls(lam=1e-3, L=steps), n=n, m_q=block_m,
                index_source=_Indices(steps), local_backend=local_backend)
            state = f32(1, block_m)
        data = (f32(1, 1, block_n, block_m), f32(1, block_n),
                f32(1, block_n))
        comm = _paper_comm(prog.schedule, sizes)
        t0 = time.perf_counter()
        flops, nbytes, wire, calls = _count(
            lambda: prog.cell(comm, 1, data, state))
        return {"steps": int(steps), "trace_s": round(time.perf_counter()
                                                      - t0, 2),
                "flops": flops, "bytes_accessed": nbytes,
                "collectives": collective_bytes(wire, calls),
                "memory": {"block_bytes": block_n * block_m * 4}}

    a, b = count(1), count(2)
    if local_backend == "kernel":
        full = count(inner)
    else:
        full = dict(a, steps=int(inner), extrapolated=True)
        for key in ("flops", "bytes_accessed"):
            full[key] = a[key] + (inner - 1) * (b[key] - a[key])
    result = {"arch": f"paper-svm-{algo}", "shape": f"{block_n}x{block_m}",
              "mesh": mesh_name, "kind": "paper", "status": "ok",
              "P": Pn, "Q": Qn, "inner_steps": inner,
              "local_backend": local_backend,
              "full": full, "calib_A": a, "calib_B": b}
    suffix = "" if local_backend == "ref" else f"__{local_backend}"
    _save(result, f"paper_svm_{algo}__{mesh_name}{suffix}.json", save)
    print(f"[dryrun] paper-svm-{algo} x {mesh_name}: OK "
          f"(GFLOP {full['flops'] / 1e9:.2f}, coll GB "
          f"{full['collectives']['total_bytes'] / 1e9:.3f})")
    return result


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--calib", action="store_true",
                    help="run the per-period cost calibration instead")
    ap.add_argument("--paper", choices=["d3ca", "radisa"], default=None,
                    help="dry-run the paper's SVM workload instead")
    ap.add_argument("--backend", choices=["ref", "kernel"], default="ref",
                    help="cell-local solver backend for --paper (as the "
                    "optimize CLI names them)")
    args = ap.parse_args(argv)

    if args.paper:
        run_paper_cell(args.paper, multi_pod=args.multi_pod,
                       local_backend=args.backend)
        return 0
    if args.all:
        # every cell of both production meshes (of the two-pod one alone
        # with --multi-pod; the calibration is the 16 x 16 mesh's)
        meshes = (True,) if args.multi_pod else (False, True)
        ok = True
        for arch in ARCHS:
            for shape in LM_SHAPES:
                for multi_pod in ((False,) if args.calib else meshes):
                    try:
                        if args.calib:
                            run_calibration(arch, shape.name)
                        else:
                            run_cell(arch, shape.name, multi_pod)
                    except Exception as e:
                        ok = False
                        print(f"[dryrun] {arch} x {shape.name} x "
                              f"{_mesh_name(multi_pod)}: FAIL {e!r}",
                              file=sys.stderr)
        return 0 if ok else 1
    if args.arch is None:
        ap.error("--arch is needed (or --all / --paper)")
    if args.calib:
        run_calibration(args.arch, args.shape or "train_4k")
    else:
        run_cell(args.arch, args.shape or "train_4k", args.multi_pod)
    return 0


if __name__ == "__main__":
    sys.exit(main())

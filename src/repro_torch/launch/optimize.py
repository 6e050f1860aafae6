"""CLI over the unified solver framework (``repro_torch.core.solver``).

Run D3CA, RADiSA, SFK or ADMM on a synthetic dataset (or a LIBSVM file)
on the single-device grid engine, or on a process grid of P x Q ranks,
one block each (``--engine shard_map|sync|async|overlap``):

  # the paper's Part 1 instance at full width, on the card, through the
  # CUDA kernels (the defaults: --device cuda --backend kernel)
  PYTHONPATH=src python -m repro_torch.launch.optimize \\
      --solver d3ca --mesh 7x4 --n 14000 --m 12000 --lam 1e-2 --iters 10

  # news20-profile sparse data at full width: CSR all the way down,
  # padded-ELL cells on the card (f* is skipped: densifying 19 996 x
  # 1 355 191 for serial SDCA would need 108 GB)
  PYTHONPATH=src python -m repro_torch.launch.optimize \\
      --solver radisa --dataset sparse --block-format sparse --n 19996 \\
      --m 1355191 --density 3.4e-4 --lam 1e-4 --mesh 7x4 --iters 10

  # a small instance on the CPU (plain PyTorch versions of the kernels)
  PYTHONPATH=src python -m repro_torch.launch.optimize \\
      --solver sfk --mesh 3x2 --n 200 --m 60 --iters 4 --device cpu

  # the paper's ADMM baseline (rho = lam), and a fan-out of 3 synthetic
  # instances (seeds seed .. seed + 2) through one batched fleet solve
  PYTHONPATH=src python -m repro_torch.launch.optimize \\
      --solver admm --mesh 3x2 --n 200 --m 60 --iters 4 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.optimize \\
      --problems 3 --mesh 3x2 --n 200 --m 60 --iters 4 --device cpu

  # the same fan-out on the mesh: one block of every instance a rank
  PYTHONPATH=src python -m repro_torch.launch.optimize \\
      --problems 3 --mesh 3x2 --n 200 --m 60 --iters 4 --device cpu \\
      --engine shard_map

Prints one line per outer iteration (objective, duality gap when the
solver has a dual, relative optimality when --ref-epochs > 0) and a
final JSON summary.

  # compressed and hierarchical reductions (exact bytes-on-wire in the
  # summary): int8 codecs with error feedback on every collective, and
  # pods of 2 row partitions with an int8 codec across pods
  PYTHONPATH=src python -m repro_torch.launch.optimize \\
      --solver d3ca --mesh 4x2 --n 200 --m 60 --iters 4 \\
      --compression int8 --topology pods=2:int8 --device cpu

  # telemetry: Chrome-trace spans of the solve (data prep, calibration,
  # every outer iteration, the local solve and one span per collective),
  # the metrics snapshot and the health verdicts in the summary, a live
  # /metrics /healthz /varz endpoint and a postmortem bundle on exit
  PYTHONPATH=src python -m repro_torch.launch.optimize \\
      --solver d3ca --mesh 3x2 --n 200 --m 60 --iters 4 --device cpu \\
      --trace /tmp/solve.json --metrics --health \\
      --listen 127.0.0.1:0 --flight-recorder /tmp/solve.bundle.json

  # the mesh engines: P x Q ranks over gloo, one block each (on the CPU
  # here; --force-host-devices N asks for N CPU ranks, N >= P * Q), with
  # synchronous reductions, or reductions applied 2 steps late, or
  # dispatched asynchronously with the same delay
  PYTHONPATH=src python -m repro_torch.launch.optimize \\
      --solver d3ca --mesh 3x2 --n 200 --m 60 --iters 4 --device cpu \\
      --engine shard_map
  PYTHONPATH=src python -m repro_torch.launch.optimize \\
      --solver d3ca --mesh 3x2 --n 200 --m 60 --iters 4 --device cpu \\
      --engine overlap --staleness 2 --force-host-devices 6

``--staleness N > 0`` needs ``--engine async`` or ``overlap`` and is
refused elsewhere with the reference's message; ``--problems N`` takes
``--engine simulated`` or ``shard_map`` / ``sync`` (the fleet refuses the
async engines with the reference's ``ValueError``).
"""
from __future__ import annotations

import argparse
import json
import sys
import time

from repro_torch.core import get_solver, objective, serial_sdca
from repro_torch.core.util import as_tensor
from repro_torch.data import (CSRMatrix, load_libsvm, load_libsvm_csr,
                              make_sparse_svm_csr, make_sparse_svm_data,
                              make_svm_data)
from repro_torch.obs import fleet_rules, solver_rules

from .obs import add_trace_metrics_flags, close_plane, open_plane

#: serial SDCA for f* densifies a CSR input; above this many entries the
#: reference's rule skips it
DENSE_REF_LIMIT = 20_000_000


def _parse_mesh(s: str):
    try:
        p, q = s.lower().split("x")
        return int(p), int(q)
    except ValueError:
        raise argparse.ArgumentTypeError(f"--mesh expects PxQ, got {s!r}")


def build_parser():
    ap = argparse.ArgumentParser(
        prog="repro_torch.launch.optimize",
        description="Doubly distributed solver CLI (PyTorch/CUDA port)")
    ap.add_argument("--solver", default="d3ca",
                    help="d3ca | radisa | sfk | admm (see get_solver)")
    ap.add_argument("--engine", default="simulated",
                    choices=["simulated", "shard_map", "sync", "async",
                             "overlap"],
                    help="simulated = the grid on one device; shard_map "
                         "(alias: sync) = a process grid of P x Q ranks, "
                         "one block each, synchronous reductions over "
                         "gloo; async = the same grid with "
                         "bounded-staleness reductions (--staleness); "
                         "overlap = async dispatch, each reduction awaited "
                         "when it is consumed")
    ap.add_argument("--backend", default="kernel", choices=["kernel", "ref"],
                    help="cell-local solver backend: the CUDA kernels "
                         "(plain PyTorch versions on the CPU) or the plain "
                         "per-step loop")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; fails without a card) | cpu")
    ap.add_argument("--mesh", type=_parse_mesh, default=(4, 2),
                    metavar="PxQ", help="grid shape, e.g. 4x2")
    ap.add_argument("--block-format", default="dense",
                    choices=["dense", "sparse"],
                    help="per-cell data layout: dense (n_p, m_q) tiles or "
                         "padded-ELL sparse cells (memory ~ nnz)")
    ap.add_argument("--dataset", default="dense",
                    choices=["dense", "sparse", "libsvm"])
    ap.add_argument("--libsvm-path", default=None,
                    help="path for --dataset libsvm (streamed into CSR "
                         "when --block-format sparse)")
    ap.add_argument("--n", type=int, default=1600)
    ap.add_argument("--m", type=int, default=400)
    ap.add_argument("--density", type=float, default=0.05,
                    help="nonzero fraction for --dataset sparse")
    ap.add_argument("--loss", default="hinge",
                    choices=["hinge", "squared", "logistic"])
    ap.add_argument("--lam", type=float, default=1e-1)
    ap.add_argument("--iters", type=int, default=15)
    ap.add_argument("--tol", type=float, default=None,
                    help="early-stopping tolerance (see Solver.solve)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ref-epochs", type=int, default=100,
                    help="serial SDCA epochs for f*; 0 skips rel-opt")
    ap.add_argument("--json-out", default=None,
                    help="write the summary JSON here as well")
    ap.add_argument("--problems", type=int, default=1,
                    help="N > 1: solve N synthetic instances (seeds seed "
                         ".. seed + N - 1) in ONE batched fleet solve "
                         "(repro_torch.fleet.FleetSolver)")
    add_comm_flags(ap)
    add_trace_metrics_flags(
        ap, trace_help="trace the solve and write Chrome-trace JSON here "
                       "(open in chrome://tracing or ui.perfetto.dev); "
                       "spans cover data prep, every outer iteration, "
                       "the cell-local solve and one span per declared "
                       "collective.  OUT.jsonl is written next to it "
                       "with the raw events",
        metrics_help="record solver metrics into a registry and print "
                     "its snapshot in the summary JSON")
    ap.add_argument("--force-host-devices", type=int, default=None,
                    metavar="N",
                    help="N CPU ranks for the mesh engines (needs --device "
                         "cpu; a P x Q mesh needs N >= P * Q)")
    return ap


def add_comm_flags(ap):
    """``--staleness`` / ``--compression`` / ``--topology``, as the
    reference's CLIs take them."""
    ap.add_argument("--staleness", type=int, default=0, metavar="TAU",
                    help="async/overlap engines only: apply every declared "
                         "reduction with delay TAU outer iterations (0 = "
                         "synchronous, identical to shard_map)")
    ap.add_argument("--compression", default=None, metavar="SPEC",
                    help="compress the declared collectives: a codec for "
                         "all of them ('int8', 'fp8', 'topk:0.1', "
                         "'identity'), per-collective "
                         "('w_contrib=int8,dalpha=identity'), or an "
                         "adaptive schedule "
                         "('adaptive[:topk:0.25->int8][@slope=..]') that "
                         "switches codec stages as convergence flattens; "
                         "codecs carry error feedback, and the summary "
                         "reports exact bytes-on-wire (default: no "
                         "compression)")
    ap.add_argument("--topology", default=None, metavar="SPEC",
                    help="hierarchical reductions, e.g. 'pods=2:int8': "
                         "full-precision sums within each pod, "
                         "codec-compressed across pods (default: flat)")


def check_staleness(ap, args):
    """The reference's refusal of ``--staleness`` outside the async /
    overlap engines."""
    if args.staleness < 0:
        ap.error(f"--staleness {args.staleness} is negative; the reduction "
                 "delay tau must be >= 0 (0 = synchronous)")
    if args.staleness > 0 and args.engine not in ("async", "overlap"):
        ap.error(f"--staleness {args.staleness} only works with "
                 f"--engine async or --engine overlap; --engine "
                 f"{args.engine} applies every reduction synchronously "
                 "(pass --engine async/overlap, or drop --staleness)")


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    ap = build_parser()
    args = ap.parse_args(argv)

    check_staleness(ap, args)
    try:
        cls = get_solver(args.solver)
    except KeyError as e:
        ap.error(str(e.args[0]))
    P, Q = args.mesh
    check_host_devices(ap, args, P, Q)
    if args.problems > 1:
        return _fanout(ap, args, cls, P, Q)
    # raises when the card is asked for (the default) and there is none,
    # before any rank of a mesh engine starts
    solver = cls(engine=args.engine, local_backend=args.backend,
                 device=args.device, block_format=args.block_format,
                 staleness=args.staleness, compression=args.compression,
                 topology=args.topology)
    sparse_fmt = args.block_format == "sparse"

    if args.dataset == "dense":
        X, y = make_svm_data(args.n, args.m, seed=args.seed)
    elif args.dataset == "libsvm":
        if not args.libsvm_path:
            ap.error("--dataset libsvm needs --libsvm-path")
        X, y = (load_libsvm_csr if sparse_fmt else load_libsvm)(
            args.libsvm_path)
    elif sparse_fmt:
        # CSR all the way down: the dense matrix is never materialised
        X, y = make_sparse_svm_csr(args.n, args.m, density=args.density,
                                   seed=args.seed)
    else:
        X, y = make_sparse_svm_data(args.n, args.m, density=args.density,
                                    seed=args.seed)
    if not isinstance(X, CSRMatrix):
        X = as_tensor(X, solver.device)
    y = as_tensor(y, solver.device)

    f_star = None
    if args.ref_epochs > 0:
        n_, m_ = X.shape
        if isinstance(X, CSRMatrix) and n_ * m_ > DENSE_REF_LIMIT:
            print(f"[optimize] skipping f* reference: densifying "
                  f"{n_}x{m_} for serial SDCA would need "
                  f"{n_ * m_ * 4 / 1e9:.1f} GB (pass --ref-epochs 0 to "
                  "silence)", file=sys.stderr)
        else:
            X_ref = X.toarray() if isinstance(X, CSRMatrix) else X
            w_ref, _ = serial_sdca(args.loss, X_ref, y, lam=args.lam,
                                   epochs=args.ref_epochs,
                                   device=solver.device)
            f_star = float(objective(args.loss, as_tensor(X_ref,
                                                          solver.device),
                                     y, w_ref, args.lam))

    cfg = _config(cls, args)
    stale = (f" staleness={args.staleness}"
             if args.engine in ("async", "overlap") else "")
    comp = (f" compression={solver.compression_spec}"
            if solver.compression is not None else "")
    if solver.topology is not None:
        comp += f" topology={solver.topology_spec}"
    print(f"[optimize] {args.solver} engine={solver.engine}{stale}{comp} "
          f"backend={args.backend} device={solver.device} "
          f"block_format={solver.block_format} grid={P}x{Q} "
          f"{args.dataset}({X.shape[0]}x{X.shape[1]}) loss={args.loss} "
          f"lam={args.lam}")
    tracer, registry, plane = open_plane(
        args, rules=solver_rules,
        meta={"cli": "optimize", "solver": args.solver,
              "engine": solver.engine})
    with plane.crash_guard():
        res = solver.solve(args.loss, X, y, P=P, Q=Q, cfg=cfg,
                           tol=args.tol, f_star=f_star,
                           tracer=plane.tracer_or(tracer),
                           registry=registry, monitor=plane.monitor)
    if res.comm_bytes is not None:
        acct = res.comm_bytes
        detail = ", ".join(
            f"{name}: {c['bytes_per_step']}B/step [{c['codec']}]"
            for name, c in acct["collectives"].items())
        print(f"[optimize] wire: {acct['bytes_per_step']} B/step "
              f"(uncompressed {acct['uncompressed_bytes_per_step']}) -- "
              f"{detail}")
    for h in res.history:
        line = (f"  t={h['iter']:3d}  {h['time_s']:7.2f}s  "
                f"f={h['objective']:.6f}")
        if "duality_gap" in h:
            line += f"  gap={h['duality_gap']:.3e}"
        if "rel_opt" in h:
            line += f"  rel_opt={h['rel_opt']:.4f}"
        print(line)
    phased = [h for h in res.history if "local_s" in h]
    if phased:
        tot = sum(h["step_s"] + h["host_s"] for h in phased)
        loc = sum(h["local_s"] for h in phased)
        com = sum(h["comm_s"] for h in phased)
        hst = sum(h["host_s"] for h in phased)
        line = (f"[optimize] phases: local {100 * loc / tot:.1f}% / "
                f"comm {100 * com / tot:.1f}% / host "
                f"{100 * hst / tot:.1f}% of {tot:.3f}s measured")
        if any("comm_exposed_s" in h for h in phased):
            exp = sum(h.get("comm_exposed_s", 0.0) for h in phased)
            hid = sum(h.get("comm_hidden_s", 0.0) for h in phased)
            line += (f" (comm exposed {100 * exp / tot:.1f}% / "
                     f"hidden {100 * hid / tot:.1f}%)")
        print(line)

    summary = {
        "solver": res.solver, "engine": res.engine,
        "local_backend": res.local_backend, "device": res.device,
        "block_format": res.block_format, "P": P, "Q": Q,
        "n": int(X.shape[0]), "m": int(X.shape[1]), "loss": args.loss,
        "lam": args.lam, "iters": res.iters, "converged": res.converged,
        "objective": res.history[-1]["objective"] if res.history else None,
        "rel_opt": res.history[-1].get("rel_opt") if res.history else None,
        "total_s": res.history[-1]["time_s"] if res.history else None,
        "staleness": res.staleness,
        "compression": res.compression,
        "topology": res.topology,
        "comm_bytes_per_step": (res.comm_bytes or {}).get("bytes_per_step"),
        "comm_bytes_total": (res.history[-1].get("comm_bytes")
                             if res.history else None),
    }
    close_plane(summary, tracer, registry, plane, args.trace, "optimize")
    print(json.dumps(summary, indent=1))
    if args.json_out:
        with open(args.json_out, "w") as fh:
            json.dump({"summary": summary, "history": res.history}, fh,
                      indent=1)
    return summary


def check_host_devices(ap, args, P, Q):
    """``--force-host-devices N``: N CPU ranks, so it needs ``--device
    cpu``, and a mesh engine's P x Q grid needs N >= P * Q (the
    reference's mesh fails the same way with too few host devices)."""
    n = args.force_host_devices
    if n is None:
        return
    if args.device != "cpu":
        ap.error(f"--force-host-devices {n} makes {n} CPU ranks; it needs "
                 f"--device cpu (got --device {args.device})")
    if args.engine != "simulated" and n < P * Q:
        ap.error(f"--force-host-devices {n}: the {P}x{Q} mesh of --engine "
                 f"{args.engine} needs {P * Q} ranks, one per block")


def _config(cls, args):
    cfg_kw = {"lam": args.lam, "outer_iters": args.iters}
    if args.solver == "admm":
        cfg_kw["rho"] = args.lam       # the paper sets rho = lam
    return cls.config_cls(**cfg_kw)


def _fanout(ap, args, cls, P, Q):
    """--problems N: one batched fleet solve over N synthetic instances,
    made as the fleet CLI makes its tenants, all at ``--lam``."""
    from repro_torch.fleet import FleetSolver

    from . import fleet as fleet_cli

    if args.dataset == "libsvm":
        ap.error("--problems fans out synthetic instances; use --dataset "
                 "dense or sparse (one libsvm file is one problem)")
    try:
        # raises when the card is asked for (the default) and there is
        # none; refuses compression / topology as the reference does
        fleet = FleetSolver(solver=args.solver, engine=args.engine,
                            local_backend=args.backend,
                            block_format=args.block_format,
                            compression=args.compression,
                            topology=args.topology, device=args.device)
    except ValueError as e:
        ap.error(str(e))
    probs = fleet_cli.make_tenants(args, count=args.problems,
                                   lam_of=lambda i: args.lam, prefix="p")
    cfg = _config(cls, args)
    print(f"[optimize] {args.solver} engine={fleet.engine} "
          f"backend={args.backend} device={fleet.device} "
          f"block_format={args.block_format} grid={P}x{Q} "
          f"problems={args.problems} {args.dataset}({args.n}x{args.m}) "
          f"loss={args.loss} lam={args.lam} (fleet fan-out)")
    tracer, registry, plane = open_plane(
        args, rules=fleet_rules,
        meta={"cli": "optimize", "solver": args.solver,
              "engine": fleet.engine, "problems": args.problems})
    t0 = time.perf_counter()
    with plane.crash_guard():
        results = fleet.solve_batch(probs, P=P, Q=Q, cfg=cfg, tol=args.tol,
                                    tracer=plane.tracer_or(tracer),
                                    registry=registry)
    total_s = time.perf_counter() - t0
    entries = fleet_cli.report(
        probs, {p.tenant_id: r for p, r in zip(probs, results)})
    return fleet_cli.finish(args, close_plane({
        "solver": args.solver, "engine": fleet.engine,
        "local_backend": args.backend, "device": str(fleet.device),
        "block_format": args.block_format, "P": P, "Q": Q,
        "n": args.n, "m": args.m, "loss": args.loss, "lam": args.lam,
        "problems": args.problems, "total_s": total_s,
        "solves_per_s": args.problems / total_s, "results": entries,
    }, tracer, registry, plane, args.trace, "optimize"))


if __name__ == "__main__":
    main()

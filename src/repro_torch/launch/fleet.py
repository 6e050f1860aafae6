"""Multi-tenant fleet CLI over :mod:`repro_torch.fleet`.

Solve many independent tenant problems in one batched program: on the
single-device grid engine every outer step launches each solver kernel
once for all tenants' cells; on the mesh (``--engine shard_map``, alias
``sync``) a process grid of P x Q ranks holds one block of every tenant
per rank, and each rank launches each kernel once a step for its cells.

  # the paper's Part 1 instance, four tenants, on the card
  PYTHONPATH=src python -m repro_torch.launch.fleet \\
      --solver d3ca --tenants 4 --n 14000 --m 12000 --mesh 7x4 \\
      --lam 1e-2 --iters 10

  # news20-profile sparse tenants: CSR all the way down, padded-ELL
  # cells on the card
  PYTHONPATH=src python -m repro_torch.launch.fleet \\
      --solver radisa --block-format sparse --tenants 2 --n 19996 \\
      --m 1355191 --density 3.4e-4 --lam 1e-4 --mesh 7x4 --iters 10

  # a small fleet on the CPU; mixed shapes make two buckets, and round r
  # warm-starts every tenant from its round r-1 result
  PYTHONPATH=src python -m repro_torch.launch.fleet \\
      --tenants 8 --shape-mix --rounds 2 --device cpu

  # --publish-snapshots pushes each tenant's iterates into its own online
  # SnapshotBook + LinearScorer after every round
  PYTHONPATH=src python -m repro_torch.launch.fleet \\
      --tenants 4 --rounds 3 --publish-snapshots --device cpu

Tenant i gets ``lam * 0.5 ** (i % 3)`` and seed ``seed + i``.  Dense
tenants come from ``make_svm_data``; with ``--block-format sparse`` they
are made as CSR by ``make_sparse_svm_csr`` and never densified.  Prints
one line per tenant per round and a final JSON summary.

  # telemetry: fleet/pack|step|unpack spans, the fleet gauges and the
  # health verdicts (a bucket of fewer than --min-tenants tenants warns)
  PYTHONPATH=src python -m repro_torch.launch.fleet \\
      --tenants 4 --device cpu --trace /tmp/fleet.json --metrics \\
      --health --min-tenants 2

  # the mesh: one block of every tenant per rank, all tenants sharing
  # each step's collectives (on the CPU: N >= P * Q ranks)
  PYTHONPATH=src python -m repro_torch.launch.fleet \\
      --engine shard_map --mesh 2x2 --tenants 4 --device cpu \\
      --force-host-devices 4
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from repro_torch.core import get_solver
from repro_torch.core.util import resolve_device
from repro_torch.data import (make_sparse_svm_csr, make_sparse_svm_data,
                               make_svm_data)
from repro_torch.fleet import FleetProblem, FleetScheduler
from repro_torch.obs import fleet_rules
from repro_torch.online import SnapshotBook
from repro_torch.serve.scoring import LinearScorer

from .obs import add_trace_metrics_flags, close_plane, open_plane
from .optimize import check_host_devices


def _parse_mesh(s: str):
    try:
        p, q = s.lower().split("x")
        return int(p), int(q)
    except ValueError:
        raise argparse.ArgumentTypeError(f"--mesh expects PxQ, got {s!r}")


def build_parser():
    ap = argparse.ArgumentParser(
        prog="repro_torch.launch.fleet",
        description="Multi-tenant batched solves (PyTorch/CUDA port): one "
                    "program, and one launch of each solver kernel per "
                    "outer step, for T tenants")
    ap.add_argument("--solver", default="d3ca",
                    help="d3ca | radisa | sfk | admm")
    ap.add_argument("--engine", default="simulated",
                    choices=["simulated", "shard_map", "sync"],
                    help="simulated = the grid on one device; shard_map "
                         "(alias: sync) = a process grid of P x Q ranks, "
                         "one block of every tenant each.  The "
                         "async/overlap engines are rejected by the fleet "
                         "path (per-build ring state has no tenant axis)")
    ap.add_argument("--backend", default="kernel", choices=["kernel", "ref"],
                    help="cell-local solver backend: the CUDA kernels "
                         "(plain PyTorch versions on the CPU) or the plain "
                         "per-step loop")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; fails without a card) | cpu")
    ap.add_argument("--block-format", default="dense",
                    choices=["dense", "sparse"])
    ap.add_argument("--mesh", type=_parse_mesh, default=(2, 2),
                    metavar="PxQ", help="grid shape, e.g. 2x2")
    ap.add_argument("--tenants", type=int, default=8, metavar="T")
    ap.add_argument("--n", type=int, default=256)
    ap.add_argument("--m", type=int, default=64)
    ap.add_argument("--density", type=float, default=0.05,
                    help="nonzero fraction for --block-format sparse data")
    ap.add_argument("--loss", default="hinge",
                    choices=["hinge", "squared", "logistic"])
    ap.add_argument("--lam", type=float, default=1.0,
                    help="base regularization; tenant i uses "
                         "lam * 0.5^(i mod 3)")
    ap.add_argument("--iters", type=int, default=6)
    ap.add_argument("--tol", type=float, default=None,
                    help="per-tenant early stopping (converged tenants "
                         "freeze exactly; the batch stops when all froze)")
    ap.add_argument("--check-every", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rounds", type=int, default=1,
                    help="resubmit every tenant this many times; round "
                         "r warm-starts from round r-1 (warm registry)")
    ap.add_argument("--max-tenants", type=int, default=None,
                    help="cap tenants per batched solve (bigger buckets "
                         "split into chunks)")
    ap.add_argument("--shape-mix", action="store_true",
                    help="give every other tenant 50%% more rows, "
                         "exercising the scheduler's shape buckets")
    ap.add_argument("--publish-snapshots", action="store_true",
                    help="publish every tenant result into a per-tenant "
                         "online SnapshotBook and refresh its "
                         "LinearScorer (the serving hand-off)")
    ap.add_argument("--json-out", default=None,
                    help="write the summary JSON here as well")
    ap.add_argument("--min-tenants", type=int, default=2,
                    help="--health: WARN when a shape bucket runs with "
                         "fewer tenants than this (starved bucket)")
    add_trace_metrics_flags(
        ap, trace_help="trace the run (fleet/pack, fleet/step, "
                       "fleet/unpack spans) and write Chrome-trace JSON "
                       "here",
        metrics_help="record fleet gauges (tenants per bucket, active "
                     "tenants, per-tenant rel_opt) and print the registry "
                     "snapshot in the summary JSON")
    ap.add_argument("--force-host-devices", type=int, default=None,
                    metavar="N",
                    help="N CPU ranks for --engine shard_map (needs "
                         "--device cpu; a P x Q mesh needs N >= P * Q)")
    return ap


def make_tenants(args, *, count=None, lam_of=None, prefix="tenant"):
    """Synthetic tenants from the parsed flags: tenant i has seed ``seed +
    i``, ``lam_of(i)`` (default the fleet's rule ``lam * 0.5 ** (i %
    3)``) and ``n`` rows (``n + n // 2`` every other one with
    ``--shape-mix``).  Sparse tenants (``--block-format sparse``, or the
    optimize CLI's ``--dataset sparse``) are CSR (``make_sparse_svm_csr``)
    on sparse blocks, never densified, and ``make_sparse_svm_data`` on
    dense ones; the rest ``make_svm_data``."""
    count = args.tenants if count is None else count
    lam_of = lam_of or (lambda i: args.lam * 0.5 ** (i % 3))
    sparse_rows = getattr(args, "dataset", args.block_format) == "sparse"
    problems = []
    for i in range(count):
        n = args.n + (args.n // 2 if getattr(args, "shape_mix", False)
                      and i % 2 else 0)
        seed = args.seed + i
        if sparse_rows and args.block_format == "sparse":
            X, y = make_sparse_svm_csr(n, args.m, density=args.density,
                                       seed=seed)
        elif sparse_rows:
            X, y = make_sparse_svm_data(n, args.m, density=args.density,
                                        seed=seed)
        else:
            X, y = make_svm_data(n, args.m, seed=seed)
        problems.append(FleetProblem(
            tenant_id=f"{prefix}{i}", loss_name=args.loss, X=X, y=y,
            lam=lam_of(i), seed=seed))
    return problems


class TenantSnapshots:
    """``--publish-snapshots``: one online :class:`SnapshotBook` and one
    :class:`LinearScorer` per tenant, on the device of its results, each
    fed every result of its tenant (``publish`` is the scheduler's
    ``on_result``)."""

    def __init__(self, loss: str):
        self.loss = loss
        self.books, self.scorers = {}, {}

    def publish(self, tid, res):
        if tid not in self.books:
            dev = res.w.device
            self.books[tid] = SnapshotBook(torch.zeros_like(res.w),
                                           device=dev)
            self.scorers[tid] = LinearScorer(res.w, loss=self.loss,
                                             device=dev)
        snap = self.books[tid].publish(res.w, res.alpha,
                                       trained_seq=res.iters)
        self.scorers[tid].update_weights(snap.w, snap.version)


def report(problems, results, label="", snapshots=None):
    """Print one line per tenant and return its summary entries (with
    the version of its published snapshot, given ``snapshots``)."""
    entries = []
    for p in problems:
        res = results[p.tenant_id]
        obj = res.history[-1]["objective"] if res.history else None
        entries.append({"tenant": p.tenant_id, "lam": p.lam, "seed": p.seed,
                        "n": p.n, "m": p.m, "iters": res.iters,
                        "converged": res.converged, "objective": obj})
        if snapshots is not None:
            entries[-1]["snapshot_version"] = \
                snapshots.books[p.tenant_id].current().version
        print(f"  {label}{p.tenant_id:>10} lam={p.lam:<8g} seed={p.seed} "
              f"n={p.n} iters={res.iters} "
              + (f"f={obj:.6f}" if obj is not None else "f=?")
              + (" converged" if res.converged else ""))
    return entries


def finish(args, summary):
    """Print the summary JSON, write it to ``--json-out`` and return it."""
    print(json.dumps(summary, indent=1))
    if args.json_out:
        with open(args.json_out, "w") as fh:
            json.dump(summary, fh, indent=1)
    return summary


def parse_args(argv=None):
    """The CLI's flags; exits 2 on an unknown solver or a
    ``--force-host-devices`` the mesh cannot use."""
    ap = build_parser()
    args = ap.parse_args(sys.argv[1:] if argv is None else argv)
    check_host_devices(ap, args, *args.mesh)
    try:
        get_solver(args.solver)
    except KeyError as e:
        ap.error(str(e.args[0]))
    return args


def run(args, on_result=None, snapshots=None):
    """The CLI's work on parsed flags: every round's fleet solves.
    ``on_result(problem, result)`` fires for every tenant of every round
    with its :class:`~repro_torch.fleet.FleetProblem` and its
    ``SolveResult`` (``main`` passes none).  With
    ``--publish-snapshots`` every result is published into ``snapshots``
    (a :class:`TenantSnapshots`, made here when not given) first.
    Returns the summary dict it prints."""
    cls = get_solver(args.solver)
    P, Q = args.mesh
    cfg_kw = {"lam": args.lam, "outer_iters": args.iters}
    if args.solver == "admm":
        cfg_kw["rho"] = args.lam
    cfg = cls.config_cls(**cfg_kw)

    problems = make_tenants(args)
    by_id = {p.tenant_id: p for p in problems}
    if not args.publish_snapshots:
        snapshots = None
    elif snapshots is None:
        snapshots = TenantSnapshots(args.loss)

    def handle(tid, res):
        if snapshots is not None:
            snapshots.publish(tid, res)
        if on_result is not None:
            on_result(by_id[tid], res)
    # a missing card raises here, before the plane starts an endpoint
    resolve_device(args.device)
    tracer, registry, plane = open_plane(
        args, rules=lambda: fleet_rules(min_tenants=args.min_tenants),
        meta={"cli": "fleet", "solver": args.solver,
              "engine": args.engine, "tenants": args.tenants})
    try:
        # raises when the card is asked for (the default) and there is none
        sched = FleetScheduler(
            P=P, Q=Q, solver=args.solver, engine=args.engine,
            local_backend=args.backend,
            block_format=args.block_format, cfg=cfg, tol=args.tol,
            check_every=args.check_every, max_tenants=args.max_tenants,
            device=args.device,
            on_result=(None if on_result is None and snapshots is None
                       else handle),
            tracer=plane.tracer_or(tracer), registry=registry,
            monitor=plane.monitor)
    except ValueError as e:
        plane.finalize()            # stop the endpoint before exiting
        build_parser().error(str(e))

    print(f"[fleet] {args.solver} engine={sched.fleet.engine} "
          f"backend={args.backend} device={sched.fleet.device} "
          f"block_format={args.block_format} grid={P}x{Q} "
          f"tenants={args.tenants} loss={args.loss} rounds={args.rounds}")

    entries = {}
    buckets = 0
    t0 = time.perf_counter()
    with plane.crash_guard():
        for r in range(args.rounds):
            for p in problems:
                sched.submit(p)
            buckets = len(sched.buckets())
            results = sched.run()
            for e in report(problems, results, label=f"round={r} ",
                            snapshots=snapshots):
                entries[e["tenant"]] = e
    total_s = time.perf_counter() - t0

    solves = args.tenants * args.rounds
    return finish(args, close_plane({
        "solver": args.solver, "engine": sched.fleet.engine,
        "local_backend": args.backend, "device": str(sched.fleet.device),
        "block_format": args.block_format, "P": P, "Q": Q,
        "loss": args.loss, "tenants": args.tenants,
        "rounds": args.rounds, "buckets": buckets,
        "total_s": total_s, "solves_per_s": solves / total_s,
        "results": list(entries.values()),
    }, tracer, registry, plane, args.trace, "fleet"))


def main(argv=None):
    """Run the CLI; returns the summary dict it prints."""
    return run(parse_args(argv))


if __name__ == "__main__":
    main()

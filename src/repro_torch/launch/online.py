"""CLI over the online learning service (:mod:`repro_torch.online`).

Drives a synthetic observation stream through the full request
lifecycle -- admission queue, grid store on the device, warm-started
gated D3CA passes, snapshot publish, live scoring -- and prints a
per-round staleness/throughput report plus a final JSON summary:

  # the paper's Part 1 width on the card: a 7 x 4 grid of 2000 x 3003
  # cells, a window of 14 000 rows that wraps at round 28
  PYTHONPATH=src python -m repro_torch.launch.online \\
      --m 12000 --capacity 14000 --mesh 7x4 --lam 1e-2 --passes 2 \\
      --rounds 30 --batch 500 --score-batch 4096

  # a small stream on the CPU
  PYTHONPATH=src python -m repro_torch.launch.online \\
      --m 64 --capacity 512 --mesh 2x2 --rounds 20 --batch 32 --device cpu

  # persist every published version and recover from the newest one
  # (a directory either package wrote)
  PYTHONPATH=src python -m repro_torch.launch.online --ckpt-dir CKPT ...

The stream is the reference CLI's: numpy's generator seeded by
``--seed``, rows normal, labels the sign of ``x . w*`` plus 0.1 noise
with ``w*`` evenly spaced in [-1, 1].  The per-round objective over the
filled rows is computed on the device, where the window lies.

``--compression SPEC`` and ``--topology SPEC`` go into every update's
solve verbatim (each update starts from zero error feedback, as the
reference's does).  Telemetry: ``--trace OUT.json`` writes the
``online/ingest|update|swap|score`` spans (each update's solve tree
inside), ``--metrics`` puts the service's registry snapshot in the
summary, ``--health`` evaluates ``online_rules`` (``--max-staleness``
seconds, ``--max-lag`` observations) and ``--listen`` /
``--flight-recorder`` start the plane (``launch/obs.py``):

  PYTHONPATH=src python -m repro_torch.launch.online \\
      --m 64 --capacity 512 --mesh 2x2 --rounds 20 --batch 32 --device cpu \\
      --trace /tmp/online.json --metrics --health --listen 127.0.0.1:0

The mesh engines (``--engine shard_map | sync | async | overlap``) run
every update on a process grid of P x Q ranks, and the live scorer on the
same grid; on the CPU, ``--force-host-devices N`` (N >= P * Q) with
``--device cpu``:

  PYTHONPATH=src python -m repro_torch.launch.online \\
      --m 64 --capacity 512 --mesh 2x2 --rounds 20 --batch 32 --device cpu \\
      --engine shard_map --force-host-devices 4

``--staleness N > 0`` needs the async engines and is refused as the
optimizer CLI refuses it.
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from repro_torch.checkpoint import CheckpointManager
from repro_torch.core import get_loss, get_solver
from repro_torch.core.util import resolve_device
from repro_torch.launch.optimize import (add_comm_flags, check_host_devices,
                                         check_staleness)
from repro_torch.obs import online_rules
from repro_torch.online import OnlineConfig, OnlineSolverService

from .mesh import process_grid
from .obs import add_trace_metrics_flags, close_plane, open_plane


def _parse_mesh(s: str):
    try:
        p, q = s.lower().split("x")
        return int(p), int(q)
    except ValueError:
        raise argparse.ArgumentTypeError(f"--mesh expects PxQ, got {s!r}")


def build_parser():
    ap = argparse.ArgumentParser(
        prog="repro_torch.launch.online",
        description="Streaming doubly distributed solver service CLI "
                    "(PyTorch/CUDA port)")
    ap.add_argument("--solver", default="d3ca",
                    help="row-gate-capable solver (d3ca)")
    ap.add_argument("--engine", default="simulated",
                    choices=["simulated", "shard_map", "sync", "async",
                             "overlap"],
                    help="simulated = the grid on one device; the others "
                         "run every update on a process grid of P x Q "
                         "ranks (see repro_torch.launch.optimize) and "
                         "score on it")
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
    ap.add_argument("--m", type=int, default=64, help="feature dimension")
    ap.add_argument("--capacity", type=int, default=512,
                    help="observation window (GridStore rows)")
    ap.add_argument("--loss", default="hinge",
                    choices=["hinge", "squared", "logistic"])
    ap.add_argument("--lam", type=float, default=1e-2)
    ap.add_argument("--passes", type=int, default=2,
                    help="warm-started outer iterations per drained batch")
    ap.add_argument("--rounds", type=int, default=20,
                    help="stream rounds (each: submit, update, score)")
    ap.add_argument("--batch", type=int, default=32,
                    help="observations per stream round")
    ap.add_argument("--score-batch", type=int, default=128,
                    help="scoring requests per round")
    ap.add_argument("--queue-capacity", type=int, default=4096)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=None,
                    help="persist published versions here (and recover "
                         "from the newest before streaming)")
    ap.add_argument("--json-out", default=None)
    add_comm_flags(ap)
    ap.add_argument("--max-staleness", type=float, default=60.0,
                    help="--health: CRIT when the served snapshot is "
                         "older than this many seconds")
    ap.add_argument("--max-lag", type=float, default=10_000,
                    help="--health: CRIT when the served model trails "
                         "the stream by more than this many admitted "
                         "observations")
    add_trace_metrics_flags(
        ap, trace_help="write Chrome-trace JSON of the "
                       "ingest/update/swap/score spans",
        metrics_help="include the service's metrics snapshot (staleness "
                     "gauge, update/swap histograms, throughput counters) "
                     "in the summary JSON")
    ap.add_argument("--force-host-devices", type=int, default=None,
                    metavar="N",
                    help="N CPU ranks for the mesh engines (needs --device "
                         "cpu; a P x Q mesh needs N >= P * Q)")
    return ap


def parse_args(argv=None):
    """The CLI's flags; exits 2 on an unknown solver, a ``--staleness``
    outside the async engines or a ``--force-host-devices`` the mesh
    cannot use."""
    ap = build_parser()
    args = ap.parse_args(sys.argv[1:] if argv is None else argv)
    check_staleness(ap, args)
    check_host_devices(ap, args, *args.mesh)
    try:
        get_solver(args.solver)
    except KeyError as e:
        ap.error(str(e.args[0]))
    return args


def run(args, on_start=None, on_round=None):
    """The CLI's work on parsed flags.  ``on_start(service)`` fires once,
    after recovery and before the first round; ``on_round(r, service,
    record)`` after every round with that round's printed values
    (``main`` passes neither).  Returns the summary dict it prints."""
    P, Q = args.mesh
    manager = (CheckpointManager(args.ckpt_dir, keep_n=3) if args.ckpt_dir
               else None)
    cls = get_solver(args.solver)
    config = OnlineConfig(
        m=args.m, capacity=args.capacity, P=P, Q=Q, loss=args.loss,
        solver=args.solver, engine=args.engine, local_backend=args.backend,
        block_format=args.block_format, staleness=args.staleness,
        compression=args.compression, topology=args.topology,
        solver_cfg=cls.config_cls(lam=args.lam), passes=args.passes,
        queue_capacity=args.queue_capacity)
    # a missing card raises here, before the plane starts an endpoint
    resolve_device(args.device)
    tracer, registry, plane = open_plane(
        args, rules=lambda: online_rules(max_staleness_s=args.max_staleness,
                                         max_lag=args.max_lag),
        meta={"cli": "online", "solver": args.solver,
              "engine": args.engine})
    # raises when the card is asked for (the default) and there is none
    mesh = (None if args.engine == "simulated"
            else process_grid(P, Q, device=args.device))
    svc = OnlineSolverService(config, mesh=mesh, manager=manager,
                              device=args.device,
                              tracer=plane.tracer_or(tracer),
                              registry=registry, monitor=plane.monitor)
    recovered = svc.recover()
    if recovered is not None:
        print(f"[online] recovered snapshot version {recovered} from "
              f"{args.ckpt_dir}")
    if on_start is not None:
        on_start(svc)

    rng = np.random.default_rng(args.seed)
    w_star = np.linspace(-1.0, 1.0, args.m).astype(np.float32)
    loss = get_loss(args.loss)

    def stream(b):
        X = rng.normal(size=(b, args.m)).astype(np.float32)
        y = np.sign(X @ w_star + 0.1 * rng.normal(size=b))
        y = np.where(y == 0, 1.0, y).astype(np.float32)
        return X, y

    print(f"[online] {args.solver} engine={args.engine} "
          f"backend={args.backend} device={svc.device} grid={P}x{Q} "
          f"m={args.m} capacity={svc.store.capacity} passes={args.passes} "
          f"loss={args.loss} lam={args.lam}")
    f = float("nan")
    with plane.crash_guard():
        for r in range(args.rounds):
            svc.submit(*stream(args.batch))
            version = svc.run_pending()
            Xs, ys = stream(args.score_batch)
            acc = float(np.mean(svc.predict(Xs) * ys > 0)) \
                if args.loss != "logistic" else float("nan")
            st = svc.store
            f = float(loss.objective(st.X, st.y, svc.book.current().w,
                                     args.lam, mask=st.filled_mask))
            record = {"version": version, "filled": st.filled, "f": f,
                      "acc": acc, "lag": svc.version_lag,
                      "staleness_s": svc.staleness_s}
            print(f"  round={r:3d} version={version} "
                  f"filled={st.filled}/{st.capacity} "
                  f"f={f:.5f} acc={acc:.3f} lag={record['lag']} "
                  f"staleness={record['staleness_s'] * 1e3:.1f}ms")
            if on_round is not None:
                on_round(r, svc, record)
    if manager is not None:
        svc.book.flush()

    summary = dict(svc.stats())
    summary.update(solver=args.solver, engine=args.engine,
                   backend=args.backend, device=str(svc.device),
                   block_format=args.block_format, P=P, Q=Q, m=args.m,
                   loss=args.loss, lam=args.lam, passes=args.passes,
                   rounds=args.rounds, batch=args.batch, objective=f)
    close_plane(summary, tracer, registry, plane, args.trace, "online")
    print(json.dumps(summary, indent=1))
    if args.json_out:
        with open(args.json_out, "w") as fh:
            json.dump(summary, fh, indent=1)
    return summary


def main(argv=None):
    """Run the CLI; returns the summary dict it prints."""
    return run(parse_args(argv))


if __name__ == "__main__":
    main()

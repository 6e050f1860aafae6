"""CLI over the unified solver framework (``repro_torch.core.solver``).

Run D3CA or RADiSA on a synthetic dense dataset on the single-device
grid engine:

  # the paper's Part 1 instance at full width, on the card, through the
  # CUDA kernels (the defaults: --device cuda --backend kernel)
  PYTHONPATH=src python -m repro_torch.launch.optimize \\
      --solver d3ca --mesh 7x4 --n 14000 --m 12000 --lam 1e-2 --iters 10

  # a small instance on the CPU (plain PyTorch versions of the kernels)
  PYTHONPATH=src python -m repro_torch.launch.optimize \\
      --solver radisa --mesh 3x2 --n 200 --m 60 --iters 4 --device cpu

Prints one line per outer iteration (objective, duality gap when the
solver has a dual, relative optimality when --ref-epochs > 0) and a
final JSON summary.

The flags of layers that are not ported yet (mesh engines, sparse block
format, staleness, compression, topology, fleet fan-out, libsvm / sparse
datasets, tracing and the observability plane) are still parsed, so that
asking for one fails by name instead of being ignored.
"""
from __future__ import annotations

import argparse
import json
import sys

from repro_torch.core import get_solver, objective, serial_sdca
from repro_torch.core.solver import not_ported_message
from repro_torch.core.util import as_tensor
from repro_torch.data import make_svm_data

#: flags of the reference CLI whose layer is not ported: (flag, argparse
#: dest -- the key into ``core.solver.NOT_PORTED`` --, the value that
#: means "not asked for")
_NOT_PORTED_FLAGS = (
    ("--engine", "engine", "simulated"),
    ("--staleness", "staleness", 0),
    ("--compression", "compression", None),
    ("--topology", "topology", None),
    ("--block-format", "block_format", "dense"),
    ("--dataset", "dataset", "dense"),
    ("--libsvm-path", "libsvm_path", None),
    ("--problems", "problems", 1),
    ("--force-host-devices", "force_host_devices", None),
    ("--trace", "trace", None),
    ("--metrics", "metrics", False),
    ("--listen", "listen", None),
    ("--health", "health", False),
    ("--flight-recorder", "flight_recorder", None),
)


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
                    help="d3ca | radisa (see get_solver)")
    ap.add_argument("--backend", default="kernel", choices=["kernel", "ref"],
                    help="cell-local solver backend: the CUDA kernels "
                         "(plain PyTorch versions on the CPU) or the plain "
                         "per-step loop")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; fails without a card) | cpu")
    ap.add_argument("--mesh", type=_parse_mesh, default=(4, 2),
                    metavar="PxQ", help="grid shape, e.g. 4x2")
    ap.add_argument("--dataset", default="dense",
                    choices=["dense", "sparse", "libsvm"])
    ap.add_argument("--n", type=int, default=1600)
    ap.add_argument("--m", type=int, default=400)
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
    # parsed only to be refused by name (see _NOT_PORTED_FLAGS)
    ap.add_argument("--engine", default="simulated", help=argparse.SUPPRESS)
    ap.add_argument("--staleness", type=int, default=0,
                    help=argparse.SUPPRESS)
    ap.add_argument("--problems", type=int, default=1,
                    help=argparse.SUPPRESS)
    ap.add_argument("--block-format", default="dense",
                    help=argparse.SUPPRESS)
    ap.add_argument("--force-host-devices", type=int, default=None,
                    help=argparse.SUPPRESS)
    for flag in ("--compression", "--topology", "--libsvm-path", "--trace",
                 "--listen", "--flight-recorder"):
        ap.add_argument(flag, default=None, help=argparse.SUPPRESS)
    for flag in ("--metrics", "--health"):
        ap.add_argument(flag, action="store_true", help=argparse.SUPPRESS)
    return ap


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    ap = build_parser()
    args = ap.parse_args(argv)

    for flag, dest, unset in _NOT_PORTED_FLAGS:
        if getattr(args, dest) != unset:
            ap.error(not_ported_message(dest,
                                        f"{flag} {getattr(args, dest)}"))

    try:
        cls = get_solver(args.solver)
    except (KeyError, NotImplementedError) as e:
        ap.error(str(e.args[0]))
    P, Q = args.mesh
    # raises when the card is asked for (the default) and there is none
    solver = cls(local_backend=args.backend, device=args.device)

    X, y = make_svm_data(args.n, args.m, seed=args.seed)
    X, y = as_tensor(X, solver.device), as_tensor(y, solver.device)

    f_star = None
    if args.ref_epochs > 0:
        w_ref, _ = serial_sdca(args.loss, X, y, lam=args.lam,
                               epochs=args.ref_epochs, device=solver.device)
        f_star = float(objective(args.loss, X, y, w_ref, args.lam))

    cfg = cls.config_cls(lam=args.lam, outer_iters=args.iters)
    print(f"[optimize] {args.solver} engine={solver.engine} "
          f"backend={args.backend} device={solver.device} "
          f"block_format={solver.block_format} grid={P}x{Q} "
          f"{args.dataset}({X.shape[0]}x{X.shape[1]}) loss={args.loss} "
          f"lam={args.lam}")
    res = solver.solve(args.loss, X, y, P=P, Q=Q, cfg=cfg, tol=args.tol,
                       f_star=f_star)
    for h in res.history:
        line = (f"  t={h['iter']:3d}  {h['time_s']:7.2f}s  "
                f"f={h['objective']:.6f}")
        if "duality_gap" in h:
            line += f"  gap={h['duality_gap']:.3e}"
        if "rel_opt" in h:
            line += f"  rel_opt={h['rel_opt']:.4f}"
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
    }
    print(json.dumps(summary, indent=1))
    if args.json_out:
        with open(args.json_out, "w") as fh:
            json.dump({"summary": summary, "history": res.history}, fh,
                      indent=1)
    return summary


if __name__ == "__main__":
    main()

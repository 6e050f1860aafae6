"""Production-path example on the PyTorch/CUDA port: D3CA and RADiSA on a
P x Q process grid, one (observation, feature) block per rank -- the
counterpart of ``examples/svm_doubly_distributed.py``, whose shard_map
engines run on a mesh of devices.

The grid is ``repro_torch.launch.mesh``'s: rank 0 is this process, ranks
1..P*Q-1 are forked from one spawned parent; every rank holds its cell's
block on ``--device`` (on a one-card machine every rank shares the card)
and runs its local solve in the SDCA (D3CA) or SVRG (RADiSA) kernel, and
the reductions over the grid's rows and columns are collectives.

    PYTHONPATH=src python examples/torch_svm_doubly_distributed.py
    PYTHONPATH=src python examples/torch_svm_doubly_distributed.py \\
        --device cpu --mesh 2x2 --n 400 --m 100

``--device`` defaults to ``cuda`` and raises on a machine without a card.
The defaults of ``--mesh``, ``--n``, ``--m`` and ``--epochs`` are the
reference example's.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

from repro_torch.core import (D3CAConfig, RADiSAConfig,  # noqa: E402
                              get_solver, objective, rel_opt,
                              resolve_device, serial_sdca)
from repro_torch.core.util import as_tensor  # noqa: E402
from repro_torch.data import make_svm_data  # noqa: E402
from repro_torch.launch.mesh import process_grid  # noqa: E402


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--mesh", default="4x2", help="P x Q ranks")
    ap.add_argument("--n", type=int, default=1600)
    ap.add_argument("--m", type=int, default=400)
    ap.add_argument("--epochs", type=int, default=200,
                    help="serial SDCA epochs for the reference optimum")
    return ap


def main(argv=None, *, streams=None):
    """Run the example; returns ``f_star``, and per solver its ``w`` (on
    the CPU), ``objective`` and ``rel_opt``, and the grid it ran on.

    ``streams`` optionally gives the random coordinate orders:
    ``{"serial": (epochs, n) visiting orders, "d3ca": index source,
    "radisa": index source}`` (the tests inject the reference's)."""
    args = build_parser().parse_args(argv)
    streams = streams or {}
    P, Q = (int(v) for v in args.mesh.lower().split("x"))
    device = resolve_device(args.device)
    X, y = make_svm_data(args.n, args.m, seed=0)
    lam = 1e-1
    Xd, yd = as_tensor(X, device), as_tensor(y, device)
    w_star, _ = serial_sdca("hinge", X, y, lam=lam, epochs=args.epochs,
                            perms=streams.get("serial"), device=device)
    f_star = float(objective("hinge", Xd, yd, w_star, lam))

    grid = process_grid(P, Q, device=device)
    print(f"mesh: {{'data': {P}, 'model': {Q}}} over {grid.world} ranks "
          f"on {device.type}")
    out = {"f_star": f_star, "grid": grid}
    for name, label, cfg in (
            ("d3ca", "D3CA  ", D3CAConfig(lam=lam, outer_iters=15)),
            ("radisa", "RADiSA", RADiSAConfig(lam=lam, gamma=0.05,
                                              outer_iters=15))):
        solver = get_solver(name)(engine="shard_map", device=device,
                                  index_source=streams.get(name))
        res = solver.solve("hinge", X, y, mesh=grid, cfg=cfg,
                           record_history=False)
        f = float(objective("hinge", Xd, yd, res.w, lam))
        r = float(rel_opt(f, f_star))
        print(f"{label} rel-opt: {r:.4f}")
        out[name] = {"w": res.w.detach().cpu().numpy(), "objective": f,
                     "rel_opt": r}
    return out


if __name__ == "__main__":
    main()

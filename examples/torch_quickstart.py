"""Quickstart on the PyTorch/CUDA port (``repro_torch``): the paper's doubly
distributed setting, the counterpart of ``examples/quickstart.py``.

Trains a hinge-loss SVM whose data matrix is partitioned BOTH across
observations (P=4) and features (Q=2) -- no cell sees a full row or a full
column of the data -- with all three optimizers, and prints their
convergence against a serial reference.  The serial SDCA epochs and the
D3CA cells run the SDCA kernel, RADiSA's cells the SVRG kernel; ADMM has
none.

    PYTHONPATH=src python examples/torch_quickstart.py            # the card
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu

``--device`` defaults to ``cuda`` and raises on a machine without a card.
``--n``, ``--m`` and ``--epochs`` (serial SDCA epochs for f*) cut the
problem; their defaults are the reference example's.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

from repro_torch.core import (ADMMConfig, D3CAConfig, RADiSAConfig,  # noqa: E402
                              admm_simulated, d3ca_simulated, objective,
                              partition, radisa_simulated, rel_opt,
                              resolve_device, serial_sdca)
from repro_torch.core.util import as_tensor  # noqa: E402
from repro_torch.data import make_svm_data  # noqa: E402


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--n", type=int, default=1200)
    ap.add_argument("--m", type=int, default=360)
    ap.add_argument("--epochs", type=int, default=300,
                    help="serial SDCA epochs for the reference optimum")
    return ap


def main(argv=None, *, streams=None):
    """Run the example; returns what it printed as numbers: ``f_star``,
    and per solver its ``history`` (every outer iteration's objective and
    rel-opt) and last ``rel_opt``.

    ``streams`` optionally gives the random coordinate orders:
    ``{"serial": (epochs, n) visiting orders, "d3ca": index source,
    "radisa": index source}`` (the tests inject the reference's)."""
    args = build_parser().parse_args(argv)
    streams = streams or {}
    device = resolve_device(args.device)

    # 1. the paper's synthetic binary classification data (§IV)
    X, y = make_svm_data(n=args.n, m=args.m, seed=0)
    lam = 1e-1
    Xd, yd = as_tensor(X, device), as_tensor(y, device)

    # 2. reference optimum from long serial SDCA
    w_star, _ = serial_sdca("hinge", X, y, lam=lam, epochs=args.epochs,
                            perms=streams.get("serial"), device=device)
    f_star = float(objective("hinge", Xd, yd, w_star, lam))
    print(f"f* = {f_star:.5f}")

    # 3. doubly distributed partition: P=4 observation x Q=2 feature blocks
    data = partition(X, y, P=4, Q=2, device=device)

    # 4. the two proposed methods + the ADMM baseline
    history = {}

    def report(name):
        hist = history.setdefault(name, [])

        def cb(t, w, *_):
            f = float(objective("hinge", Xd, yd, w, lam))
            r = float(rel_opt(f, f_star))
            hist.append({"iter": int(t), "objective": f, "rel_opt": r})
            if t % 5 == 0:
                print(f"  {name} iter {t:3d}: rel-opt {r:.4f}")
        return cb

    print("D3CA (dual coordinate ascent):")
    d3ca_simulated("hinge", data, D3CAConfig(lam=lam, outer_iters=15),
                   callback=report("d3ca"), index_source=streams.get("d3ca"))
    print("RADiSA (SGD x CD + SVRG):")
    radisa_simulated("hinge", data,
                     RADiSAConfig(lam=lam, gamma=0.05, outer_iters=15),
                     callback=report("radisa"),
                     index_source=streams.get("radisa"))
    print("block-splitting ADMM (baseline):")
    admm_simulated("hinge", data, ADMMConfig(lam=lam, rho=lam,
                                             outer_iters=60),
                   callback=report("admm"))
    return {"f_star": f_star, "history": history,
            "rel_opt": {k: h[-1]["rel_opt"] for k, h in history.items()}}


if __name__ == "__main__":
    main()

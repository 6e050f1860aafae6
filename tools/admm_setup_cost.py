"""Setup cost of the grid engine's dense ADMM at Part 1 (7 x 4 blocks of
2000 x 3003, hinge, lambda = rho = 1e-2): the seconds and the peak device
memory of building the column blocks' Cholesky factors
(``admm_setup_simulated``: the Gram matrices and their factors), and the
peak memory and seconds of a whole 10-iteration solve through
``Solver.solve`` -- for the ``repro_torch`` that ``PYTHONPATH`` names::

    PYTHONPATH=src python3 tools/admm_setup_cost.py

Peak memory is ``torch.cuda.max_memory_allocated`` above what was
allocated before (the data and its blocks); setup seconds are the median
of ``--reps`` builds after a warm-up build, each ended by a device wait.
Run it against two trees (``PYTHONPATH=<tree>/src``) in one call to
compare them on one card.  Prints one JSON line, with the card's name and
power limit.
"""
import argparse
import json
import statistics
import subprocess
import time

import torch

import repro_torch
from repro_torch.core import ADMMConfig, get_solver, partition
from repro_torch.core.admm import admm_setup_simulated
from repro_torch.data import make_svm_data


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=14000)
    ap.add_argument("--m", type=int, default=12000)
    ap.add_argument("--mesh", default="7x4")
    ap.add_argument("--lam", type=float, default=1e-2)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)
    P, Q = (int(v) for v in args.mesh.split("x"))
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip().splitlines()
    Xn, yn = make_svm_data(args.n, args.m, seed=0)
    X, y = torch.as_tensor(Xn, device=dev), torch.as_tensor(yn, device=dev)
    data = partition(X, y, P, Q, m_multiple=P * Q, device=dev)
    cfg = ADMMConfig(lam=args.lam, rho=args.lam, outer_iters=args.iters)

    def measured(fn):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0,
                torch.cuda.max_memory_allocated() - base, out)

    measured(lambda: admm_setup_simulated(data, cfg))        # warm-up
    setups = [measured(lambda: admm_setup_simulated(data, cfg))[:2]
              for _ in range(args.reps)]
    solve_s, solve_peak, res = measured(lambda: get_solver("admm")().solve(
        "hinge", X, y, P=P, Q=Q, cfg=cfg))
    print(json.dumps({
        "repro_torch": repro_torch.__file__,
        "card": card, "mesh": f"{P}x{Q}", "n": args.n, "m": args.m,
        "m_q": data.m_q,
        "setup_s": statistics.median(s for s, _ in setups),
        "setup_s_all": [s for s, _ in setups],
        "setup_peak_bytes": max(b for _, b in setups),
        "solve_s": solve_s, "solve_peak_bytes": solve_peak,
        "objective_last": res.history[-1]["objective"]}))


if __name__ == "__main__":
    main()

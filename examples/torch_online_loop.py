"""Worked online-learning example on the PyTorch/CUDA port: stream
observations through the admission queue into warm-started gated D3CA
passes while the live scorer keeps serving, then inspect staleness and
the snapshot history -- the counterpart of ``examples/online_loop.py``.

    PYTHONPATH=src python examples/torch_online_loop.py [--rounds 12]
    PYTHONPATH=src python examples/torch_online_loop.py --device cpu

What it shows:

  * the request lifecycle -- ``submit`` (admission), ``run_pending``
    (ring-store insert, gated incremental solve, atomic snapshot
    publish + scorer swap), ``predict`` (serving the last published
    version);
  * why warm starts matter: the same batch folded in with and without
    the previous iterates;
  * the staleness gauge / version-lag bookkeeping and the
    ``online/update_s`` / ``online/swap_s`` histograms;
  * checkpoint-backed recovery: a second service resumes from the
    newest persisted snapshot.

The window, the solves, the snapshots and the scorer live on
``--device``; every gated pass is one launch of the SDCA kernel with the
row gate as its mask.  ``--device`` defaults to ``cuda`` and raises on a
machine without a card.  ``--ckpt-dir`` defaults to a new temporary
folder.
"""
import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.checkpoint.manager import CheckpointManager  # noqa: E402
from repro_torch.core import D3CAConfig, objective, resolve_device  # noqa: E402
from repro_torch.obs import Registry  # noqa: E402
from repro_torch.online import OnlineConfig, OnlineSolverService  # noqa: E402


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--rounds", type=int, default=12)
    ap.add_argument("--batch", type=int, default=24)
    ap.add_argument("--m", type=int, default=32)
    ap.add_argument("--ckpt-dir", default=None,
                    help="snapshot folder (default: a new temporary one)")
    return ap


def main(argv=None, *, streams=None):
    """Run the example; returns per round its ``version``, ``filled``
    rows, ``objective``, ``accuracy``, ``staleness_s`` and
    ``version_lag``; the warm and cold objectives; the registry
    ``snapshot``; and the ``recovered`` version and whether its weights
    match.

    ``streams`` optionally gives ``{"d3ca": index source}`` for every
    update (the tests inject the reference's orders)."""
    args = build_parser().parse_args(argv)
    streams = streams or {}
    device = resolve_device(args.device)

    rng = np.random.default_rng(0)
    w_star = np.linspace(-1.0, 1.0, args.m).astype(np.float32)

    def stream(b):
        X = rng.normal(size=(b, args.m)).astype(np.float32)
        y = np.where(X @ w_star >= 0, 1.0, -1.0).astype(np.float32)
        return X, y

    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(prefix="online_ck_")
    reg = Registry()
    svc = OnlineSolverService(
        OnlineConfig(m=args.m, capacity=256, P=2, Q=2, loss="hinge",
                     solver_cfg=D3CAConfig(lam=1e-2), passes=2),
        manager=CheckpointManager(ckpt_dir, keep_n=3), registry=reg,
        device=device, index_source=streams.get("d3ca"))

    # 1. the streaming loop: admit -> update -> serve
    rounds = []
    print("round  version  filled   objective   accuracy  staleness")
    for r in range(args.rounds):
        svc.submit(*stream(args.batch))
        version = svc.run_pending()
        Xs, ys = stream(128)
        acc = float(np.mean(svc.predict(Xs) * ys > 0))
        mask = svc.store.filled_mask > 0
        f = float(objective("hinge", svc.store.X[mask], svc.store.y[mask],
                            svc.book.current().w, 1e-2))
        stale = svc.staleness_s
        print(f"  {r:3d}  {version:7d}  {svc.store.filled:4d}/"
              f"{svc.store.capacity}   {f:.6f}   {acc:.3f}    "
              f"{stale * 1e3:6.1f} ms")
        rounds.append({"round": r, "version": version,
                       "filled": svc.store.filled, "objective": f,
                       "accuracy": acc, "staleness_s": stale,
                       "version_lag": svc.version_lag})

    # 2. warm start vs cold: fold one more batch in both ways
    cur = svc.book.current()
    Xb, yb = stream(args.batch)
    touched = svc.store.insert(Xb, yb)
    warm = svc.solver.update("hinge", svc.store.X, svc.store.y,
                             touched=touched, warm_start=(cur.w, cur.alpha),
                             P=2, Q=2, cfg=D3CAConfig(lam=1e-2), passes=2)
    zeros = (torch.zeros_like(cur.w), torch.zeros_like(cur.alpha))
    cold = svc.solver.update("hinge", svc.store.X, svc.store.y,
                             touched=touched, warm_start=zeros,
                             P=2, Q=2, cfg=D3CAConfig(lam=1e-2), passes=2)
    mask = svc.store.filled_mask > 0
    f_warm = float(objective("hinge", svc.store.X[mask], svc.store.y[mask],
                             warm.w, 1e-2))
    f_cold = float(objective("hinge", svc.store.X[mask], svc.store.y[mask],
                             cold.w, 1e-2))
    print(f"\nsame gated passes, warm f={f_warm:.6f} vs cold "
          f"f={f_cold:.6f} (warm start carries the converged dual)")

    # 3. the service's metrics: staleness gauge + update/swap histograms
    snap = reg.snapshot()
    print("\nonline metrics:")
    for k, v in snap["counters"].items():
        if k.startswith("online/"):
            print(f"  {k:<55s} {v:.0f}")
    for k, v in snap["gauges"].items():
        if k.startswith("online/"):
            print(f"  {k:<55s} {v:.4f}")
    for k, h in snap["histograms"].items():
        if k.startswith("online/"):
            print(f"  {k:<55s} p50={h['p50'] * 1e3:.2f} ms "
                  f"(n={h['count']})")

    # 4. crash recovery: a fresh service resumes from the newest
    #    persisted snapshot (write-to-tmp + atomic rename on disk)
    svc.book.flush()
    svc2 = OnlineSolverService(
        OnlineConfig(m=args.m, capacity=256, P=2, Q=2),
        manager=CheckpointManager(ckpt_dir, keep_n=3), device=device)
    v = svc2.recover()
    same = bool(torch.allclose(svc2.book.current().w,
                               svc.book.current().w))
    print(f"\nrecovered version {v} from {ckpt_dir} "
          f"(weights match: {same})")
    return {"rounds": rounds, "f_warm": f_warm, "f_cold": f_cold,
            "snapshot": snap, "recovered": v, "weights_match": same,
            "newest": svc.book.current().version, "ckpt_dir": ckpt_dir}


if __name__ == "__main__":
    main()

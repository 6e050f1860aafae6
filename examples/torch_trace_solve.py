"""Worked observability example on the PyTorch/CUDA port: trace a D3CA
solve, attribute its wall-clock to local-solve / communication / host
phases, and export a Chrome trace you can open in https://ui.perfetto.dev
-- the counterpart of ``examples/trace_solve.py``.

    PYTHONPATH=src python examples/torch_trace_solve.py [--out trace.json]
    PYTHONPATH=src python examples/torch_trace_solve.py --device cpu

What it shows:

  * ``Tracer`` spans around the whole solve (data prep, the calibration
    of the phase split, every outer iteration, the synthesized
    per-collective spans named after the solver's declared
    ``CommSchedule`` collectives);
  * a ``Registry`` collecting the same run as counters / gauges /
    histograms;
  * the per-iteration ``step_s`` / ``local_s`` / ``comm_s`` / ``host_s``
    fields that telemetry adds to ``SolveResult.history``.

Every local solve is one launch of the SDCA kernel for the 2 x 2 cells;
a traced solve waits for the device after every step, so the times are
the card's work and not its launch.  ``--device`` defaults to ``cuda``
and raises on a machine without a card.
"""
import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

from repro_torch.core import D3CAConfig, get_solver, resolve_device  # noqa: E402
from repro_torch.data import make_svm_data  # noqa: E402
from repro_torch.obs import Registry, Tracer  # noqa: E402

#: the spans whose totals the example prints, as the reference's does
SPANS = ("data_prep", "calibrate", "outer_iter", "step", "local_solve",
         "comm/dalpha", "comm/w_contrib", "observe")


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--out", default="trace.json",
                    help="Chrome-trace JSON path (a .jsonl raw-event "
                         "log is written next to it)")
    ap.add_argument("--iters", type=int, default=10)
    return ap


def main(argv=None, *, streams=None):
    """Run the example; returns the solve's ``history``, the ``spans``'
    totals in seconds, the registry ``snapshot``, the number of
    ``events`` and the paths written.

    ``streams`` optionally gives ``{"d3ca": index source}`` (the tests
    inject the reference's orders)."""
    args = build_parser().parse_args(argv)
    streams = streams or {}
    device = resolve_device(args.device)

    X, y = make_svm_data(800, 200, seed=0)
    cfg = D3CAConfig(lam=1e-1, outer_iters=args.iters, local_steps=64)
    solver = get_solver("d3ca")(engine="simulated", device=device,
                                index_source=streams.get("d3ca"))

    tracer, reg = Tracer(), Registry()
    res = solver.solve("hinge", X, y, P=2, Q=2, cfg=cfg,
                       tracer=tracer, registry=reg)

    # 1. the per-phase fields telemetry added to the solve history
    print("per-iteration phase attribution:")
    for h in res.history:
        print(f"  t={h['iter']:3d}  step {h['step_s'] * 1e3:7.3f} ms"
              f"  = local {h['local_s'] * 1e3:7.3f}"
              f"  + comm {h['comm_s'] * 1e3:7.3f}"
              f"  (obs host {h['host_s'] * 1e3:7.3f} ms)"
              f"   f={h['objective']:.6f}")

    # 2. span totals straight off the tracer
    solve_s = tracer.total("solve")
    print(f"\nspan totals over {solve_s * 1e3:.1f} ms of solve:")
    spans = {"solve": solve_s}
    for name in SPANS:
        t = spans[name] = tracer.total(name)
        print(f"  {name:<14s} {t * 1e3:8.2f} ms  ({100 * t / solve_s:5.1f}%)")

    # 3. the registry snapshot
    snap = reg.snapshot()
    print("\nregistry snapshot (counters + a few gauges):")
    print(json.dumps({"counters": snap["counters"],
                      "gauges": snap["gauges"]}, indent=1))

    # 4. export: drag args.out into ui.perfetto.dev (or chrome://tracing)
    tracer.write_chrome_trace(args.out)
    base, _ = os.path.splitext(args.out)
    tracer.write_jsonl(base + ".jsonl")
    print(f"\nwrote {args.out} (+ {base}.jsonl) -- "
          f"{len(tracer.events)} events; open in https://ui.perfetto.dev")
    return {"history": res.history, "spans": spans, "snapshot": snap,
            "events": len(tracer.events),
            "paths": [args.out, base + ".jsonl"]}


if __name__ == "__main__":
    main()

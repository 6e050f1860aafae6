"""Where a Python script's wall time goes, by sampling its main thread.

    python3 tools/wall_profile.py --out build/wall_profile.json \\
        -- chip_smoke.py --phases kernels,timing

runs the script as ``__main__`` (its arguments after ``--``) while a
daemon thread reads the main thread's stack every ``--interval`` seconds.
Each sample adds the interval to every distinct function on the stack
(inclusive time) and to the innermost one (self time).  Only frames of
files under this checkout are counted, so the library code a function
calls is charged to it.  Processes the script starts are not sampled:
a controller waiting on them is charged for the wait.  The JSON written
to ``--out`` lists the functions by inclusive seconds; the script's own
exit code is passed on.
"""
from __future__ import annotations

import argparse
import collections
import json
import os
import runpy
import sys
import threading
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _label(code):
    path = os.path.relpath(code.co_filename, ROOT)
    return f"{path}:{code.co_firstlineno}:{code.co_name}"


def _sampler(thread_id, interval, incl, self_, stop):
    while not stop.wait(interval):
        frame = sys._current_frames().get(thread_id)
        seen, inner = set(), None
        while frame is not None:
            code = frame.f_code
            if code.co_filename.startswith(ROOT) \
                    and "tools/wall_profile" not in code.co_filename:
                label = _label(code)
                inner = inner or label
                seen.add(label)
            frame = frame.f_back
        for label in seen:
            incl[label] += interval
        if inner:
            self_[inner] += interval


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", required=True)
    ap.add_argument("--interval", type=float, default=0.05)
    ap.add_argument("--top", type=int, default=400)
    ap.add_argument("script")
    ap.add_argument("args", nargs=argparse.REMAINDER)
    args = ap.parse_args()
    incl = collections.Counter()
    self_ = collections.Counter()
    stop = threading.Event()
    thread = threading.Thread(
        target=_sampler, daemon=True,
        args=(threading.get_ident(), args.interval, incl, self_, stop))
    sys.argv = [args.script, *[a for a in args.args if a != "--"]]
    sys.path.insert(0, os.path.dirname(os.path.abspath(args.script)))
    t0 = time.perf_counter()
    thread.start()
    code = 0
    try:
        runpy.run_path(os.path.abspath(args.script), run_name="__main__")
    except SystemExit as exc:
        code = exc.code if isinstance(exc.code, int) else int(bool(exc.code))
    finally:
        stop.set()
        thread.join()
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"wall_s": time.perf_counter() - t0,
                       "interval_s": args.interval,
                       "inclusive_s": incl.most_common(args.top),
                       "self_s": self_.most_common(args.top)}, f, indent=1)
    sys.exit(code)


if __name__ == "__main__":
    main()

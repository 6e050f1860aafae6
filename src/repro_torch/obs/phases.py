"""Per-phase time attribution for engine programs (the port of the
reference's ``repro/obs/phases.py``, timed on the device).

An outer iteration's time decomposes into

  * ``local_s`` -- the cell-local solve (the kernel work),
  * ``comm_s``  -- the declared collectives (reductions + codecs),
  * ``host_s``  -- host bookkeeping (objective/gap eval, scheduling).

The kernels of a step run asynchronously to the host and no one of them
can be timed from inside the step, so the split is measured
*differentially*: every grid program also carries ``local_step`` -- the
SAME cell program with every collective executed cell-locally
(:class:`~repro_torch.core.comm.LocalComm`: same result shapes, no
reduction) -- which costs the local math without the reductions.
``comm_s = step_s - local_s`` is then the communication share, split
across the named collectives in proportion to their exact bytes on the
wire (the program's ``comm_bytes`` accounting).

:func:`calibrate_phases` measures the split once per program (a warm-up
and ``reps`` timed steps of each variant, the minimum of each);
:meth:`PhaseSplit.attribute` then prices every later iteration from its
measured ``step_s`` alone.  On a CUDA device each timed call is bracketed
by two CUDA events on the current stream and waited for; on the CPU the
operations are synchronous and the host clock reads them.

Overlap-aware attribution: programs of the overlap engine
(``EngineProgram.overlap`` with ``staleness = tau > 0``) consume each
reduction tau steps after dispatch, so up to tau steps of local solve can
hide the wire.  For those programs :meth:`PhaseSplit.attribute` further
splits ``comm_s`` into ``comm_hidden_s`` (up to ``tau * local_s``) and
``comm_exposed_s`` (the rest, which extends the critical path) by
:func:`repro_torch.core.comm_model.overlap_split`.

On a process grid (``repro_torch.launch.mesh``) the controller times its
own rank: a step ends when rank 0's reductions are complete, and the
collective-free twin ends when every rank's device has finished it (a
device wait on each rank, then a barrier of the grid), so ``local_s`` is
the slowest rank's local solve.

:func:`bench_codecs` times each compressed collective's codec on a zero
payload of the blocked shape ``(P', Q', *cell)`` the engine hands it: the
grid engine codes all P x Q cells of a collective in one call, a rank of a
process grid its one cell, so that call is what one step of the codec
costs.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional

import torch


def device_of(tree) -> Optional[torch.device]:
    """The device of the first tensor in a (nested tuple / list / dict)
    state, or None when it holds no tensor."""
    if torch.is_tensor(tree):
        return tree.device
    items = tree.values() if isinstance(tree, dict) else (
        tree if isinstance(tree, (tuple, list)) else ())
    for leaf in items:
        dev = device_of(leaf)
        if dev is not None:
            return dev
    return None


def wait_for(device: Optional[torch.device]):
    """Block until the work queued on ``device`` finished: a CUDA
    synchronize; nothing for the CPU, whose operations are synchronous."""
    if device is not None and device.type == "cuda":
        torch.cuda.synchronize(device)


def _timeit(fn, reps: int, device: Optional[torch.device]) -> float:
    """Seconds of one ``fn()``, the minimum of ``reps`` calls (calibration
    wants the noise floor): CUDA-event time on a CUDA device, the host
    clock after the call elsewhere."""
    ts = []
    cuda = device is not None and device.type == "cuda"
    for _ in range(reps):
        if cuda:
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            fn()
            end.record()
            end.synchronize()
            ts.append(start.elapsed_time(end) / 1e3)
        else:
            t0 = time.perf_counter()
            fn()
            ts.append(time.perf_counter() - t0)
    return min(ts)


@dataclasses.dataclass(frozen=True)
class PhaseSplit:
    """Calibrated local/comm split of one engine program."""

    #: fraction of a step spent in the cell-local solve (0..1)
    local_frac: float
    #: each named collective's share of the comm fraction (sums to 1)
    comm_shares: Dict[str, float]
    #: calibration measurements, for provenance
    step_s: float
    local_s: float
    #: reduction delay tau of the program (0 = synchronous)
    staleness: int = 0
    #: True for overlap-engine programs: comm_s further splits into
    #: hidden (overlapped with the local solve) and exposed shares
    overlap: bool = False

    def attribute(self, step_s: float) -> dict:
        """Split one measured step duration into phases::

            {"local_s": ..., "comm_s": ...,
             ["comm_hidden_s": ..., "comm_exposed_s": ...,]
             "collectives": {name: seconds}}

        ``comm_s`` is clamped at 0 (a local twin measured slower than the
        step reads as no communication, not a negative one)."""
        local = step_s * self.local_frac
        comm = max(step_s - local, 0.0)
        out = {"local_s": local, "comm_s": comm,
               "collectives": {name: comm * share
                               for name, share in self.comm_shares.items()}}
        if self.overlap and self.staleness > 0:
            from ..core.comm_model import overlap_split
            out.update(overlap_split(comm, local, self.staleness))
        return out


def calibrate_phases(prog, *, reps: int = 3) -> Optional[PhaseSplit]:
    """Measure a program's local/comm split (see module docstring).

    Returns None when the program carries no ``local_step``; callers then
    emit only the undivided ``step`` span.  Both variants step from
    ``prog.state`` -- a warm-up and ``reps`` timed calls each, so
    ``2 * (1 + reps)`` steps that launch the program's kernels.  A step
    writes nothing into its input state and its index draws depend on
    ``(seed, t)`` alone, so a calibrated solve returns bitwise the
    iterates of an uncalibrated one.
    """
    local_step = getattr(prog, "local_step", None)
    if local_step is None:
        return None
    state = prog.state
    dev = device_of(state)
    prog.step(1, state)                         # warm-up
    wait_for(dev)
    step_s = _timeit(lambda: prog.step(1, state), reps, dev)
    local_step(1, state)
    wait_for(dev)
    local_s = _timeit(lambda: local_step(1, state), reps, dev)
    local_frac = min(local_s / step_s, 1.0) if step_s > 0 else 1.0

    acct = getattr(prog, "comm_bytes", None) or {}
    coll = acct.get("collectives", {})
    total_bytes = sum(c["bytes_per_step"] for c in coll.values())
    if coll and total_bytes > 0:
        shares = {name: c["bytes_per_step"] / total_bytes
                  for name, c in coll.items()}
    elif coll:                      # all-zero payloads: split evenly
        shares = {name: 1.0 / len(coll) for name in coll}
    else:
        shares = {}
    return PhaseSplit(local_frac=local_frac, comm_shares=shares,
                      step_s=step_s, local_s=local_s,
                      staleness=int(getattr(prog, "staleness", 0)),
                      overlap=bool(getattr(prog, "overlap", False)))


def bench_codecs(policy, acct: dict, *, grid, device="cuda",
                 reps: int = 3) -> Dict[str, float]:
    """Seconds of one codec call of each *compressed* collective.

    ``policy`` is a CompressionPolicy (duck-typed: ``codec_for(name)``),
    ``acct`` the program's wire accounting, whose per-collective entries
    carry the per-cell payload shape (``payload_shape`` /
    ``payload_dtype``), and ``grid`` the ``(P, Q)`` extents: each codec is
    timed on a zero ``(P, Q, *payload_shape)`` payload (with a zero
    residual when it carries error feedback), one call for all cells, as
    the engine calls it.  Identity-codec collectives are skipped (their
    apply returns its input).
    """
    device = torch.device(device)
    out: Dict[str, float] = {}
    for name, cell in acct.get("collectives", {}).items():
        codec = policy.codec_for(name)
        if codec.name == "identity" or "payload_shape" not in cell:
            continue
        x = torch.zeros((*grid, *cell["payload_shape"]),
                        dtype=getattr(torch, cell["payload_dtype"]),
                        device=device)
        err = (torch.zeros(x.shape, dtype=torch.float32, device=device)
               if codec.stateful else None)
        codec.apply(x, err)                     # warm-up
        wait_for(device)
        out[name] = _timeit(lambda c=codec: c.apply(x, err), reps, device)
    return out

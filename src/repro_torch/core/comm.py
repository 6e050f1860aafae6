"""CommSchedule: communication policy as a first-class solver axis.

The paper's doubly distributed optimizers are all "local sub-problem
solves stitched together by cross-node reductions".  This module makes
the reduction points explicit:

  * a solver's program constructor *declares* its collectives once::

        sched = (CommSchedule()
                 .pmean("dalpha", axis="model")   # step 6 dual average
                 .psum("w_contrib", axis="data")) # step 9 primal-dual map

  * its step math *executes* them by name through a :class:`Comm` handed
    in by the engine::

        a_new = a + comm("dalpha", dalpha) / Pn
        w_new = comm("w_contrib", contrib) / (lam * n)

  * the engine picks the executor: :class:`SyncComm` applies every
    reduction immediately, optionally as a two-level hierarchical
    reduction over pods (``set_topology``); :class:`StaleComm` applies
    it with bounded staleness tau (the value returned at outer step t is
    the reduction computed at ``max(1, t - tau)``, carried in a FIFO ring
    of the engine state); :class:`OverlapComm` keeps StaleComm's
    consumption contract and dispatches each reduction asynchronously,
    awaiting it when its slot is read tau steps later;
    :class:`~repro_torch.core.compress.CompressedComm` wraps any of them
    to run every payload through its codec first, and :class:`LocalComm`
    runs every point cell-locally (the timing twin of a step).

Axes are *logical* ("data" = observation partitions, "model" = feature
partitions).  A payload arrives as one blocked tensor ``(P', Q', ...)``
whose leading axes are the cells the executing process holds, and a
*wire* carries out the reductions over them:

  * :class:`GridWire` -- the single-device grid engine: all P x Q cells
    are leading batch axes, a reduction over "data" sums out axis 0 and
    one over "model" axis 1, and the result is returned once, without
    the replicas a per-cell execution would hold (``(P, Q, n_p)`` reduced
    over "model" is ``(P, n_p)``);
  * :class:`ProcessWire` -- one rank of a process grid
    (``repro_torch.launch.mesh``): the rank holds ONE cell, so a payload
    leads with ``(1, 1)``, and a reduction over "model" is an all-reduce
    over the rank's row of the grid, one over "data" an all-reduce over
    its column (``torch.distributed`` over gloo).  Tensors on a CUDA
    device travel through pinned host buffers, the wire of this engine.

The executors read the global extents P and Q for the math
(``axis_size``) and the wire's leading extents for the shapes.

Every executor records the exact bytes ONE cell put on the wire per
executed point (``wire_bytes``), and, when the engine declares the
per-cell payload shapes, refuses a payload whose trailing shape differs
from the declared one -- the wire accounting and the error-feedback
buffers are sized from those declarations before the first step.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

from .util import resolve_device

LOGICAL_AXES = ("data", "model")
OPS = ("psum", "pmean", "allgather")
#: position of each logical axis among a blocked payload's leading axes
BLOCK_AXIS = {"data": 0, "model": 1}


@dataclasses.dataclass(frozen=True)
class Collective:
    """One declared reduction point of a solver program."""

    name: str
    op: str        # "psum" | "pmean" | "allgather"
    axis: str      # logical grid axis reduced over: "data" | "model"

    def __post_init__(self):
        if self.op not in OPS:
            raise ValueError(f"collective {self.name!r}: op={self.op!r}; "
                             f"expected one of {OPS}")
        if self.axis not in LOGICAL_AXES:
            raise ValueError(f"collective {self.name!r}: axis={self.axis!r}; "
                             f"expected one of {LOGICAL_AXES}")

    @property
    def result_axis(self) -> str:
        """Logical axis the reduction *result* still varies over."""
        return "model" if self.axis == "data" else "data"


class CommSchedule:
    """Ordered declaration of a solver's named reduction points."""

    def __init__(self):
        self._points: Dict[str, Collective] = {}

    # -- declaration (chainable) --------------------------------------------
    def _add(self, name: str, op: str, axis: str) -> "CommSchedule":
        if name in self._points:
            raise ValueError(f"collective {name!r} declared twice")
        self._points[name] = Collective(name, op, axis)
        return self

    def psum(self, name: str, *, axis: str) -> "CommSchedule":
        """Declare a sum-reduction over a logical grid axis."""
        return self._add(name, "psum", axis)

    def pmean(self, name: str, *, axis: str) -> "CommSchedule":
        """Declare a mean-reduction over a logical grid axis."""
        return self._add(name, "pmean", axis)

    def allgather(self, name: str, *, axis: str) -> "CommSchedule":
        """Declare a gather over a logical grid axis: every cell receives
        the values of all cells along that axis."""
        return self._add(name, "allgather", axis)

    # -- lookup --------------------------------------------------------------
    def __getitem__(self, name: str) -> Collective:
        try:
            return self._points[name]
        except KeyError:
            raise KeyError(
                f"reduction {name!r} is not declared in this CommSchedule "
                f"(declared: {sorted(self._points)}); declare it with "
                ".psum(name, axis=...) / .pmean(name, axis=...) in the "
                "function that builds the program") from None

    def __contains__(self, name: str) -> bool:
        return name in self._points

    def __iter__(self):
        return iter(self._points.values())

    @property
    def names(self) -> Tuple[str, ...]:
        """The declared collective names, in declaration order."""
        return tuple(self._points)


class Comm:
    """Executor handed to a step: runs the declared collectives.

    ``sizes`` gives the logical grid extents (P, Q) as static ints;
    ``payload_shapes`` (optional) maps each collective to the per-cell
    shape its payload must have (the shape without the grid axes);
    ``wire`` carries out the reductions (:class:`GridWire` over ``sizes``
    by default, :class:`ProcessWire` on a rank of a process grid).  One
    instance serves one outer step; :meth:`finalize` then checks that
    every declared point ran exactly once.
    """

    def __init__(self, schedule: CommSchedule, sizes: Dict[str, int],
                 device="cuda", payload_shapes: Optional[dict] = None,
                 wire=None):
        self.schedule = schedule
        self.sizes = dict(sizes)
        self.device = resolve_device(device)
        self.payload_shapes = payload_shapes
        self.wire = wire if wire is not None else GridWire(self.sizes)
        self._executed: set = set()
        #: exact payload bytes one cell put on the wire, per collective
        #: (executors that shrink the payload -- CompressedComm -- record
        #: their own number; everyone else the uncompressed size).  The
        #: solvers and the metrics registry (``solver/comm_bytes``) read
        #: the build-time ``wire_accounting``, which the tests hold equal
        #: to this per-step record
        self.wire_bytes: Dict[str, int] = {}

    # -- step-facing API -----------------------------------------------------
    def __call__(self, name: str, value):
        """Execute the declared collective ``name`` on the blocked
        payload ``value`` of shape ``(P, Q, ...)``.

        Raises:
          KeyError: when ``name`` was never declared in the schedule.
          ValueError: when the same point is executed twice in one outer
            step, the payload's leading axes are not the grid, or its
            per-cell shape is not the declared one.
        """
        point = self.schedule[name]
        if name in self._executed:
            raise ValueError(f"reduction {name!r} executed twice in one "
                             "step; declare a second point instead")
        self._executed.add(name)
        grid = self.wire.lead          # the cells this executor holds
        if tuple(value.shape[:2]) != grid:
            raise ValueError(
                f"reduction {name!r}: payload of shape {tuple(value.shape)} "
                f"does not lead with the {grid[0]}x{grid[1]} grid")
        cell = tuple(value.shape[2:])
        if self.payload_shapes is not None \
                and cell != tuple(self.payload_shapes[name]):
            raise ValueError(
                f"reduction {name!r}: per-cell payload {cell} differs from "
                f"the declared {tuple(self.payload_shapes[name])}; the "
                "wire accounting and error-feedback buffers were sized "
                "from the declaration")
        out = self._exec(point, value)
        if name not in self.wire_bytes:
            self.wire_bytes[name] = math.prod(cell) * value.element_size()
        return out

    def axis_index(self, axis: str) -> torch.Tensor:
        """Indices of the cells held along a logical axis: ``arange(P)``
        or ``arange(Q)`` on the grid engine (all cells are present at
        once), the rank's own ``[p]`` or ``[q]`` on a process grid."""
        return self.wire.axis_index(axis, self.device)

    def axis_size(self, axis: str) -> int:
        """Static extent of a logical grid axis (P or Q)."""
        return self.sizes[axis]

    def finalize(self):
        """Check the schedule contract: every declared point ran once."""
        missing = set(self.schedule.names) - self._executed
        if missing:
            raise ValueError(
                f"declared reductions never executed: {sorted(missing)}; "
                "the step must run every point of its CommSchedule exactly "
                "once per outer step")

    # -- engine-facing -------------------------------------------------------
    def _exec(self, point: Collective, value):
        raise NotImplementedError


class SyncComm(Comm):
    """Apply every reduction immediately (the paper's synchronous outer
    loop): a sum or mean over the cells along the collective's logical
    axis, carried out by the executor's wire.

    All reduction executors (this one, :class:`StaleComm`,
    :class:`OverlapComm`) funnel the wire operation through
    :meth:`_reduce`, so the hierarchical reduction below composes with
    every consumption policy.

    **Hierarchical reduction** (``set_topology``): with a
    :class:`~repro_torch.core.comm_model.Topology` of ``pods = G > 1``, a
    psum/pmean over the pod-split logical axis ("data") runs in two
    levels.  Pods are contiguous ranges of P: each pod's P // G cells are
    summed in full precision (the wire's ``pod_partial``), each ``(pod,
    q)`` partial goes through the cross-pod codec, and the decoded
    partials are summed over pods (``cross_pod``; then divided by P for
    pmean) -- the cheap fat link carries full floats, the thin link the
    codec payload.  Every cell of a pod holds the same partial and
    residual, so the grid engine runs the codec once per pod (residual
    ``(G, Q, *cell)``) and a rank of a process grid runs it on its own
    copy (residual ``(1, 1, *cell)``).  A stateful codec's residual is
    one buffer per collective in ``hier_ef_in`` / ``hier_ef_out``,
    distinct from a policy codec's (that one compresses each cell's
    payload before any reduction; this one the intra-pod partial sum).
    Allgathers and the "model" collectives stay flat.
    """

    #: two-level reduction disabled until ``set_topology`` is called
    topology = None

    def set_topology(self, topology, codec, ef: Optional[dict] = None):
        """Enable hierarchical reduction over ``topology.axis``.

        ``codec`` is the cross-pod codec instance; ``ef`` maps collective
        name -> its error-feedback residual (required for stateful
        codecs)."""
        pods = topology.pods
        if self.sizes[topology.axis] % pods:
            raise ValueError(f"topology pods={pods} does not divide "
                             f"{topology.axis} extent "
                             f"{self.sizes[topology.axis]}")
        self.topology = topology
        self._hier_codec = codec
        self.hier_ef_in = dict(ef or {})
        #: updated residuals, read by the engine after the step
        self.hier_ef_out: Dict[str, torch.Tensor] = {}

    def _hierarchical(self, point: Collective) -> bool:
        topo = self.topology
        return (topo is not None and topo.pods > 1
                and point.axis == topo.axis and point.op != "allgather")

    def _reduce(self, point: Collective, value):
        """The wire operation: fresh reduction of this step's value."""
        if self._hierarchical(point):
            return self._reduce_hierarchical(point, value)
        return self.wire.reduce(point, value)

    def _dispatch(self, point: Collective, value):
        """Start the wire operation; returns a handle whose ``wait()``
        gives :meth:`_reduce`'s result.  The two-level reduction runs its
        codec between its levels, so it completes here."""
        if self._hierarchical(point):
            return Ready(self._reduce_hierarchical(point, value))
        return self.wire.dispatch(point, value)

    def _reduce_hierarchical(self, point: Collective, value):
        G = self.topology.pods
        # intra-pod: full-precision sum over each pod's P // G cells
        part = self.wire.pod_partial(value, G)
        codec = self._hier_codec
        if codec.stateful:
            try:
                err = self.hier_ef_in[point.name]
            except KeyError:
                raise KeyError(
                    f"no cross-pod error-feedback residual for reduction "
                    f"{point.name!r}; the engine allocates one per "
                    "pod-split collective at build time") from None
            deq, new_err = codec.apply(part, err)
            self.hier_ef_out[point.name] = new_err
        else:
            deq, _ = codec.apply(part)
        # cross-pod: the decoded partials summed over pods
        out = self.wire.cross_pod(deq.to(part.dtype), G)
        if point.op == "pmean":
            out = out / self.sizes[point.axis]
        return out

    def _exec(self, point: Collective, value):
        return self._reduce(point, value)


class StaleComm(SyncComm):
    """Bounded-staleness executor (the async engine's policy).

    The reduction result *applied* at outer step t is the one *computed*
    at step ``max(1, t - tau)``.  Each point carries a FIFO ring of tau
    slots in the engine state (``bufs``: name -> tuple of tau result
    tensors): slot ``(t-1) % tau`` holds the reduction of step
    ``t - tau``, which is read just before the fresh value replaces it.

    **Warm-up** (``docs/consistency.md``): at t = 1 every ring slot is
    seeded with the *first* reduction, so steps 1..tau+1 all consume step
    1's value -- never zeros from initialization and never a partially
    filled ring.

    The fresh collective still executes every step; only the consumption
    is delayed.  ``tau = 0`` never touches a buffer and returns the fresh
    value, so the async engine at zero staleness is the sync engine, bit
    for bit.  ``wire_bytes`` is additive: every step puts exactly one
    payload per declared point on the wire, whatever the policy.
    """

    def __init__(self, schedule: CommSchedule, sizes: Dict[str, int], *,
                 tau: int, t: int, bufs: Optional[dict] = None,
                 device="cuda", payload_shapes: Optional[dict] = None,
                 wire=None):
        super().__init__(schedule, sizes, device=device,
                         payload_shapes=payload_shapes, wire=wire)
        if tau < 0:
            raise ValueError(f"staleness tau={tau} must be >= 0")
        self.tau = int(tau)
        self.t = int(t)
        self.bufs_in = bufs or {}
        #: the rings after this step, read by the engine
        self.bufs_out: Dict[str, tuple] = {}

    def _ring(self, point: Collective):
        try:
            return self.bufs_in[point.name]
        except KeyError:
            raise KeyError(
                f"no staleness buffer for reduction {point.name!r}; the "
                "async engine allocates one per declared point at build "
                "time -- was the schedule changed after program "
                "construction?") from None

    def _exec(self, point, value):
        fresh = self._reduce(point, value)
        if self.tau == 0:
            return fresh
        ring = self._ring(point)
        if self.t == 1:
            self.bufs_out[point.name] = (fresh,) * self.tau
            return fresh
        slot = (self.t - 1) % self.tau
        self.bufs_out[point.name] = ring[:slot] + (fresh,) + ring[slot + 1:]
        return ring[slot]

    def finalize(self):
        super().finalize()
        if self.tau and set(self.bufs_out) != set(self.schedule.names):
            raise ValueError("staleness buffers out of sync with schedule")


class OverlapComm(StaleComm):
    """Communication-overlap executor (the overlap engine's policy).

    Same consumption contract as :class:`StaleComm` -- the value applied
    at step t is the reduction *dispatched* at step ``max(1, t - tau)``
    -- but the wire runs behind the local solve: each step dispatches its
    fresh reduction (an asynchronous all-reduce on a process grid) into
    the ring slot that is consumed tau steps later, and waits for a
    slot's reduction only when it reads it.  At t = 1 there is nothing in
    flight, so the first dispatch is awaited at once and seeds every
    slot.  The ring slots hold the handles (``wait() -> tensor``) of the
    dispatched reductions.

    Consumption timing equals :class:`StaleComm`'s, so overlap changes
    wall-clock, never numerics: equal tau gives the async engine's
    iterates bit for bit, and tau = 0 the sync engine's.  Error-feedback
    residuals of a composed :class:`CompressedComm` live with the
    dispatch step: the codec encodes the payload before the wire sees it.
    """

    #: engines key off this to keep the dispatch window open
    overlap = True

    def _exec(self, point, value):
        if self.tau == 0:
            return self._reduce(point, value)
        ring = self._ring(point)
        handle = self._dispatch(point, value)
        if self.t == 1:
            fresh = handle.wait()
            self.bufs_out[point.name] = (Ready(fresh),) * self.tau
            return fresh
        slot = (self.t - 1) % self.tau
        self.bufs_out[point.name] = ring[:slot] + (handle,) + ring[slot + 1:]
        return ring[slot].wait()


def drain(bufs: dict):
    """Wait for every reduction still in flight in overlap rings
    ``{name: (handle, ...)}`` (the end of an overlap solve)."""
    for ring in bufs.values():
        for h in ring:
            h.wait()


class Ready:
    """The handle of a reduction that has completed: ``wait()`` returns
    its result."""

    def __init__(self, value):
        self.value = value

    def wait(self):
        return self.value


class GridWire:
    """The reductions of the single-device grid engine: sums over the
    leading block axes of a payload ``(P, Q, *cell)``; every result is
    ready when returned."""

    def __init__(self, sizes: Dict[str, int]):
        self.lead = (sizes["data"], sizes["model"])

    def axis_index(self, axis: str, device) -> torch.Tensor:
        return torch.arange(self.lead[BLOCK_AXIS[axis]], device=device)

    def reduce(self, point: Collective, value):
        dim = BLOCK_AXIS[point.axis]
        if point.op == "psum":
            return value.sum(dim=dim)
        if point.op == "pmean":
            return value.mean(dim=dim)
        # allgather: the cells along `dim` each receive all of them; with
        # replicas dropped that is the payload with `dim` moved behind
        # the axis the result still varies over
        return value.movedim(dim, 1) if dim == 0 else value

    def dispatch(self, point: Collective, value):
        return Ready(self.reduce(point, value))

    def pod_partial(self, value, G: int):
        """``(P, Q, *cell)`` -> ``(G, Q, *cell)``: each pod's cells
        summed."""
        return value.reshape(G, value.shape[0] // G,
                             *value.shape[1:]).sum(dim=1)

    def cross_pod(self, part, G: int):
        """``(G, Q, *cell)`` -> ``(Q, *cell)``: the pods' partials
        summed."""
        return part.sum(dim=0)


class _InFlight:
    """An asynchronous all-reduce on a process grid: ``wait()`` finishes
    it and returns its result on the rank's device."""

    def __init__(self, work, host, finish):
        self.work, self.host, self.finish = work, host, finish
        self.value = None

    def wait(self):
        if self.value is None:
            self.work.wait()
            self.value = self.finish(self.host)
            self.work = self.host = None
        return self.value


class ProcessWire:
    """The reductions of one rank of a process grid
    (:class:`repro_torch.launch.mesh.RankContext`): the rank holds one
    cell, so a payload is ``(1, 1, *cell)``; a reduction over "model"
    all-reduces the cell's value over the rank's row group, one over
    "data" over its column group, and a pod-split reduction over the
    rank's pod group and then its cross-pod group (ranks of one column
    at the same place in their pods).

    Collectives run on gloo.  A payload on a CUDA device is staged
    through a pinned host buffer (copied there, reduced there, copied
    back), which is the wire of this engine; the rank's compute stays on
    its device.
    """

    def __init__(self, ctx):
        self.ctx = ctx
        self.lead = (1, 1)

    def axis_index(self, axis: str, device) -> torch.Tensor:
        own = self.ctx.p if axis == "data" else self.ctx.q
        return torch.tensor([own], device=device)

    # -- staging ---------------------------------------------------------------
    @staticmethod
    def _to_host(value):
        """A contiguous host tensor of ``value`` that nothing else holds
        (the collective writes its result into it)."""
        if value.device.type == "cuda":
            host = torch.empty(value.shape, dtype=value.dtype,
                               pin_memory=True)
            host.copy_(value)
            return host
        return value.contiguous().clone()

    def _back(self, host):
        if self.ctx.device.type == "cuda":
            return host.to(self.ctx.device, non_blocking=True)
        return host

    # -- reductions -------------------------------------------------------------
    def _all_reduce(self, value, group, async_op: bool, scale=None):
        host = self._to_host(value)

        def finish(h):
            out = self._back(h)
            return out / scale if scale is not None else out
        work = dist.all_reduce(host, group=group, async_op=async_op)
        handle = _InFlight(work, host, finish) if async_op else None
        return handle if async_op else finish(host)

    def _cell(self, point: Collective, value):
        """The cell's value with the reduced block axis (extent 1)
        summed out, and the process group of that axis."""
        dim = BLOCK_AXIS[point.axis]
        return value.sum(dim=dim), self.ctx.group(point.axis)

    def all_reduce(self, value, axis: str):
        """The sum of ``value`` over the rank's group of ``axis`` -- a
        reduction outside any schedule (ADMM's setup)."""
        return self._all_reduce(value, self.ctx.group(axis), False)

    def reduce(self, point: Collective, value):
        if point.op == "allgather":
            return self._allgather(point, value)
        cell, group = self._cell(point, value)
        scale = (self.ctx.sizes[point.axis] if point.op == "pmean"
                 else None)
        return self._all_reduce(cell, group, False, scale)

    def dispatch(self, point: Collective, value):
        if point.op == "allgather":
            return Ready(self._allgather(point, value))
        cell, group = self._cell(point, value)
        scale = (self.ctx.sizes[point.axis] if point.op == "pmean"
                 else None)
        return self._all_reduce(cell, group, True, scale)

    def _allgather(self, point: Collective, value):
        """Every cell along the axis receives all of them: ``(1, E,
        *cell)`` in axis order, E the axis extent."""
        cell, group = self._cell(point, value)
        host = self._to_host(cell)
        parts = [torch.empty_like(host)
                 for _ in range(self.ctx.sizes[point.axis])]
        dist.all_gather(parts, host, group=group)
        return self._back(torch.stack(parts, dim=1))

    def pod_partial(self, value, G: int):
        """The pod's partial sum, ``(1, 1, *cell)`` on every rank of it."""
        part = self._all_reduce(value.sum(dim=0), self.ctx.pod_group(G),
                                False)
        return part.unsqueeze(0)

    def cross_pod(self, part, G: int):
        """The pods' decoded partials summed: ``(1, *cell)``."""
        return self._all_reduce(part.sum(dim=0), self.ctx.cross_group(G),
                                False)


class LocalComm(Comm):
    """Collective-free executor for per-phase time attribution.

    Every declared point runs CELL-LOCALLY with the result shape of
    :meth:`SyncComm._reduce` and no reduction work: a psum or pmean over
    a block axis returns the payload's first cell along it
    (``value.select(dim, 0)``, made contiguous as a reduction's result
    is: a copy of one cell's payload where the reduction reads all of
    them), an allgather returns what ``SyncComm`` returns (a reordering
    of the payload, which is no reduction).  The
    numbers are wrong on purpose; a program built with this executor
    (``EngineProgram.local_step``) is only ever timed, never consumed:
    the difference between stepping the real program and this one is the
    communication cost (:func:`repro_torch.obs.phases.calibrate_phases`).
    The per-cell payload check of :class:`Comm` still applies.
    """

    def _exec(self, point: Collective, value):
        dim = BLOCK_AXIS[point.axis]
        if point.op == "allgather":
            return value.movedim(dim, 1) if dim == 0 else value
        return value.select(dim, 0).contiguous()


def hier_ef_names(schedule: CommSchedule, topology) -> Tuple[str, ...]:
    """Names of collectives that need a cross-pod error-feedback residual
    under ``topology``: the psum/pmean points over the pod-split axis,
    when the cross-pod codec is stateful."""
    if topology is None or topology.pods <= 1:
        return ()
    from .compress import get_codec
    if not get_codec(topology.codec).stateful:
        return ()
    return tuple(p.name for p in schedule
                 if p.axis == topology.axis and p.op != "allgather")

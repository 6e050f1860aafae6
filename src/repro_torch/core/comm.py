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
    reduction over pods (``set_topology``),
    :class:`~repro_torch.core.compress.CompressedComm` wraps it to run
    every payload through its codec first, and :class:`LocalComm` runs
    every point cell-locally (the timing twin of a step).  The bounded-staleness and
    overlapping executors of the reference serve its mesh engines only
    and come with them (ROADMAP queue A, multi-device engines).

Axes are *logical* ("data" = observation partitions, "model" = feature
partitions).  On the single-device grid engine the P x Q cells are
leading batch axes: a per-cell payload arrives as one blocked tensor
``(P, Q, ...)``, a reduction over "data" sums out axis 0 and one over
"model" axis 1, and the result is returned once, without the replicas a
per-cell execution would hold (``(P, Q, n_p)`` reduced over "model" is
``(P, n_p)``).

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
    shape its payload must have (the shape without the grid axes).  One
    instance serves one outer step; :meth:`finalize` then checks that
    every declared point ran exactly once.
    """

    def __init__(self, schedule: CommSchedule, sizes: Dict[str, int],
                 device="cuda", payload_shapes: Optional[dict] = None):
        self.schedule = schedule
        self.sizes = dict(sizes)
        self.device = resolve_device(device)
        self.payload_shapes = payload_shapes
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
        grid = (self.sizes["data"], self.sizes["model"])
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
        """Cell indices along a logical axis: ``arange(P)`` or
        ``arange(Q)`` (all cells are present at once on the grid engine)."""
        return torch.arange(self.sizes[axis], device=self.device)

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
    loop): a sum or mean over the block axis the collective's logical
    axis maps to.

    **Hierarchical reduction** (``set_topology``): with a
    :class:`~repro_torch.core.comm_model.Topology` of ``pods = G > 1``, a
    psum/pmean over the pod-split logical axis ("data") runs in two
    levels.  Pods are contiguous ranges of P: the payload ``(P, Q, ...)``
    is viewed as ``(G, P // G, Q, ...)`` and summed in full precision
    over each pod's cells, each ``(pod, q)`` partial goes through the
    cross-pod codec, and the decoded partials are summed over pods (then
    divided by P for pmean) -- the cheap fat link carries full floats,
    the thin link the codec payload.  Every cell of a pod would hold the
    same partial and residual, so the codec runs once per pod, and a
    stateful codec's residual is one ``(G, Q, *cell)`` buffer per
    collective in ``hier_ef_in`` / ``hier_ef_out``, distinct from a
    policy codec's (that one compresses each cell's payload before any
    reduction; this one the intra-pod partial sum).  Allgathers and the
    "model" collectives stay flat.
    """

    #: two-level reduction disabled until ``set_topology`` is called
    topology = None

    def set_topology(self, topology, codec, ef: Optional[dict] = None):
        """Enable hierarchical reduction over ``topology.axis``.

        ``codec`` is the cross-pod codec instance; ``ef`` maps collective
        name -> its ``(G, Q, *cell)`` error-feedback residual (required
        for stateful codecs)."""
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

    def _reduce(self, point: Collective, value):
        """The wire operation: fresh reduction of this step's value."""
        topo = self.topology
        if (topo is not None and topo.pods > 1 and point.axis == topo.axis
                and point.op != "allgather"):
            return self._reduce_hierarchical(point, value)
        dim = BLOCK_AXIS[point.axis]
        if point.op == "psum":
            return value.sum(dim=dim)
        if point.op == "pmean":
            return value.mean(dim=dim)
        # allgather: the cells along `dim` each receive all of them; with
        # replicas dropped that is the payload with `dim` moved behind
        # the axis the result still varies over
        return value.movedim(dim, 1) if dim == 0 else value

    def _reduce_hierarchical(self, point: Collective, value):
        G = self.topology.pods
        # intra-pod: full-precision sum over each pod's P // G cells
        part = value.reshape(G, value.shape[0] // G,
                             *value.shape[1:]).sum(dim=1)
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
        out = deq.to(part.dtype).sum(dim=0)
        if point.op == "pmean":
            out = out / self.sizes[point.axis]
        return out

    def _exec(self, point: Collective, value):
        return self._reduce(point, value)


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

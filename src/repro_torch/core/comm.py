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

  * the engine picks the executor.  This slice has one: :class:`SyncComm`
    applies every reduction immediately.  The bounded-staleness,
    overlapping, compressed and hierarchical executors of the reference
    are not ported yet (ROADMAP queue A, comm policies); they slot in
    here without touching the solvers.

Axes are *logical* ("data" = observation partitions, "model" = feature
partitions).  On the single-device grid engine the P x Q cells are
leading batch axes: a per-cell payload arrives as one blocked tensor
``(P, Q, ...)``, a reduction over "data" sums out axis 0 and one over
"model" axis 1, and the result is returned once, without the replicas a
per-cell execution would hold (``(P, Q, n_p)`` reduced over "model" is
``(P, n_p)``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

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

    ``sizes`` gives the logical grid extents (P, Q) as static ints.
    One instance serves one outer step; :meth:`finalize` then checks
    that every declared point ran exactly once.
    """

    def __init__(self, schedule: CommSchedule, sizes: Dict[str, int],
                 device="cuda"):
        self.schedule = schedule
        self.sizes = dict(sizes)
        self.device = resolve_device(device)
        self._executed: set = set()

    # -- step-facing API -----------------------------------------------------
    def __call__(self, name: str, value):
        """Execute the declared collective ``name`` on the blocked
        payload ``value`` of shape ``(P, Q, ...)``.

        Raises:
          KeyError: when ``name`` was never declared in the schedule.
          ValueError: when the same point is executed twice in one outer
            step, or the payload's leading axes are not the grid.
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
        return self._exec(point, value)

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
    axis maps to."""

    def _exec(self, point: Collective, value):
        dim = BLOCK_AXIS[point.axis]
        if point.op == "psum":
            return value.sum(dim=dim)
        if point.op == "pmean":
            return value.mean(dim=dim)
        # allgather: the cells along `dim` each receive all of them; with
        # replicas dropped that is the payload with `dim` moved behind
        # the axis the result still varies over
        return value.movedim(dim, 1) if dim == 0 else value

"""Engine executors for the unified solver framework (``core/solver.py``).

An *engine* is how the P x Q block grid of the paper is executed.  Each
solver contributes ONE :class:`CellProgram` -- its step math plus a
:class:`~repro_torch.core.comm.CommSchedule` declaring every cross-cell
reduction as a named collective.  Two executors run it:

  * ``"simulated"`` -- :func:`grid_program`: the grid is the leading
    (P, Q) axes of blocked tensors on one device, the declared
    collectives are reductions over those axes, and the cell-local
    kernels take all cells of one outer step in one launch;
  * ``"shard_map"`` (alias ``"sync"``), ``"async"`` and ``"overlap"`` --
    :func:`mesh_program`: one block per rank of a process grid
    (:mod:`repro_torch.launch.mesh`), the same cell program run by every
    rank on its one cell (blocked tensors leading with ``(1, 1)``), the
    declared collectives all-reduces over the rank's row or column of the
    grid (:class:`~repro_torch.core.comm.ProcessWire`).  ``"async"``
    applies them with bounded staleness tau
    (:class:`~repro_torch.core.comm.StaleComm`), ``"overlap"`` with the
    same delays and asynchronous dispatch
    (:class:`~repro_torch.core.comm.OverlapComm`).  The controller (rank
    0) drives the grid through :func:`bind_mesh_program`'s
    :class:`EngineProgram`, like any other program.

Orthogonally, a :class:`~repro_torch.core.compress.CompressionPolicy`
(``compression=``) routes every declared collective's payload through a
codec with error feedback, and a ``topology="pods=G[:codec]"`` runs the
reductions over "data" in two levels (full precision within each pod,
the pod codec across pods).  Every program reports its exact
bytes-on-wire (``EngineProgram.comm_bytes``), computed at build time from
the per-cell payload shapes each :class:`CellProgram` declares.

The executor produces an :class:`EngineProgram` -- initial state, outer
step, extractors for the global primal (and dual) iterates.  Everything
else (the outer loop, history, early stopping, warm starts) lives once
in the shared outer loop (``drive`` / ``Solver.solve``).
"""
from __future__ import annotations

import dataclasses
import importlib
import time
from typing import Any, Callable, Optional

import torch

from .comm import (BLOCK_AXIS, CommSchedule, LocalComm, OverlapComm,
                   ProcessWire, Ready, StaleComm, SyncComm, drain,
                   hier_ef_names)
from .comm_model import Topology, hierarchical_accounting
from .compress import CompressedComm, as_policy, get_codec, wire_accounting
from .indices import CellIndexSource
from .util import resolve_device


@dataclasses.dataclass
class EngineProgram:
    """One algorithm bound to one engine: state + step + extractors.

    The uniform handle ``Solver.program`` returns and ``drive`` runs.

    Attributes:
      state: the initial engine state (blocked iterates).
      step: ``(t, state) -> state`` advancing one outer iteration; ``t``
        is the 1-based iteration counter.
      w_of: ``state -> (m,)`` -- the assembled global primal iterate
        (trimmed of any grid padding).
      alpha_of: ``state -> (n,)`` global dual, or None for primal-only
        solvers.
      comm_bytes: exact per-step wire accounting of the program's
        declared collectives (see
        ``repro_torch.core.compress.wire_accounting``), or None for a
        program built outside the grid binding.
      ef_of: ``state -> {collective: error-feedback residual}`` when the
        program carries residuals (stateful codecs); None otherwise.  The
        timed ``Solver.solve`` path reads it into the registry's
        ``compress/ef_norm/<name>`` gauges.
      local_step: ``(t, state) -> state``, the same cell program with
        every collective run cell-locally
        (:class:`~repro_torch.core.comm.LocalComm`), on the solver state
        without any comm state; its result is wrong by design and only
        ever timed (``repro_torch.obs.phases.calibrate_phases``).  None
        for a program built outside the grid binding.
      staleness: the reduction delay tau the program was built with (0 =
        synchronous).
      overlap: True for the overlap engine at tau > 0: reductions are
        dispatched and awaited tau steps later, so the driver waits only
        for the iterates between steps.
      sync_of: ``state -> the substate that must be complete at an
        observation`` (the iterates, without the reductions in flight);
        None means the whole state.
      close: ``close()``, set on a process grid's program: ends the
        grid's session and collects the ranks' launch counts and hook
        reports.  ``Solver.solve`` calls it when the solve ends; a session
        left open is ended when the grid opens its next one.
      set_data: ``set_data(leaf, value)``, set on a process grid's
        program: leaf ``leaf`` (its index, or its name when the program
        was bound with ``data_names``) of the blocked data tuple becomes
        ``value``, a global tensor of the leaf's layout, every rank
        taking its cell (one DATA command).  The next step reads it.
    """

    state: Any
    step: Callable[[int, Any], Any]
    w_of: Callable[[Any], torch.Tensor]
    alpha_of: Optional[Callable[[Any], torch.Tensor]] = None
    comm_bytes: Optional[dict] = None
    ef_of: Optional[Callable[[Any], dict]] = None
    local_step: Optional[Callable[[int, Any], Any]] = None
    staleness: int = 0
    overlap: bool = False
    sync_of: Optional[Callable[[Any], Any]] = None
    close: Optional[Callable[[], Any]] = None
    set_data: Optional[Callable[[Any, torch.Tensor], None]] = None


def drive(prog: EngineProgram, outer_iters: int, observe=None, *,
          tracer=None, on_step=None, monitor=None):
    """Run the outer loop.  ``observe(t, state) -> bool`` is called after
    every step; returning True stops early.  Returns
    (final state, iterations run, stopped_early).

    Telemetry (all optional, default off -- the untimed loop makes no
    device sync and no launch beyond the steps' own):

      * ``tracer`` -- a :class:`repro_torch.obs.Tracer`; each iteration
        becomes an ``outer_iter`` span with ``step`` / ``observe``
        children, and the step waits for the device inside its span, so
        the span measures the step's device work, not its launches;
      * ``on_step(t, t_begin, step_s)`` -- fires after every timed step
        (the solver uses it to synthesize per-collective attribution
        spans and per-iteration phase fields);
      * ``monitor`` -- a :class:`repro_torch.obs.HealthMonitor`; its
        rate-limited ``poll()`` runs once per iteration (health rules only
        read the registry, so the iterates are untouched).
    """
    tracing = tracer is not None and getattr(tracer, "enabled", False)
    state = prog.state
    done = 0
    if not tracing and on_step is None:
        for t in range(1, outer_iters + 1):
            state = prog.step(t, state)
            done = t
            if monitor is not None:
                monitor.poll()
            if observe is not None and observe(t, state):
                return state, done, True
        return state, done, False

    from ..obs.phases import device_of, wait_for
    from ..obs.trace import NULL_TRACER
    tr = tracer if tracing else NULL_TRACER
    clock = tracer.clock if tracing else time.perf_counter
    # the overlap engine's iterates alone are waited for, never the
    # reductions in flight (sync_of); every other program waits for all
    sync = prog.sync_of if prog.sync_of is not None else (lambda s: s)
    dev = device_of(sync(state))
    for t in range(1, outer_iters + 1):
        with tr.span("outer_iter", iter=t):
            with tr.span("step", iter=t):
                # t0 taken INSIDE the span so the attribution spans
                # on_step synthesizes at t0 nest within it
                t0 = clock()
                state = prog.step(t, state)
                wait_for(dev)
                step_s = clock() - t0
            if on_step is not None:
                on_step(t, t0, step_s)
            done = t
            if monitor is not None:
                monitor.poll()
            if observe is not None:
                with tr.span("observe", iter=t):
                    stop = observe(t, state)
                if stop:
                    return state, done, True
    return state, done, False


def drive_with_callback(prog: EngineProgram, outer_iters: int, callback=None,
                        pass_alpha: bool = False):
    """Outer loop of the ``*_simulated`` wrappers: relay each iterate to
    ``callback(t, w[, alpha])``, ignoring its return value (these
    callbacks never early-stop).  Returns the final state."""
    observe = None
    if callback is not None:
        def observe(t, state):
            if pass_alpha:
                callback(t, prog.w_of(state), prog.alpha_of(state))
            else:
                callback(t, prog.w_of(state))
            return False
    state, _, _ = drive(prog, outer_iters, observe)
    return state


@dataclasses.dataclass(frozen=True)
class CellProgram:
    """One solver's step math plus its communication contract.

    ``cell(comm, t, data, state) -> state`` operates on BLOCKED tensors --
    every per-cell array of the reference carries the grid axes it varies
    over as leading axes, in (data, model) order -- and performs every
    cross-cell reduction through the :class:`~repro_torch.core.comm.Comm`
    it is handed, never with an inline sum over a grid axis.

    ``state_specs`` names the grid axes each state leaf leads with --
    ``("data",)``, ``("model",)`` or ``("data", "model")`` per leaf (a
    bare spec for a single-tensor state) -- which is where the fleet path
    (``repro_torch.fleet``) puts its tenant axis.

    ``payload_shapes(data, state) -> {name: per-cell shape}`` declares
    what each collective's payload looks like in one cell (without the
    grid axes), from the data and state shapes alone: the engine sizes
    the wire accounting and the error-feedback buffers from it before the
    first step (running a probe step would launch the kernels), and the
    executor refuses a payload that differs.  None skips both.
    """

    schedule: CommSchedule
    cell: Callable[..., Any]
    state_specs: Any = None
    payload_shapes: Optional[Callable[[Any, Any], dict]] = None


def cached_build(cache, key, build):
    """Memoize ``build()`` under ``key`` in ``cache`` (a plain dict owned
    by the caller); ``cache=None`` just calls ``build()``."""
    if cache is None:
        return build()
    if key not in cache:
        cache[key] = build()
    return cache[key]


#: error-feedback dict key prefix for the cross-pod (topology) codec
#: residuals -- keeps them distinct from a CompressionPolicy residual on
#: the same collective name inside the one ``ef`` dict
POD_EF = "pod:"


def _norm_topology(topology):
    """None | spec | Topology -> Topology with pods > 1, else None."""
    if topology is None:
        return None
    topo = Topology.from_spec(topology)
    if topo.pods <= 1:
        return None
    if topo.axis != "data":
        raise ValueError(f"topology splits axis {topo.axis!r}; the engines "
                         "only pod-split the 'data' axis")
    return topo


def grid_program(cellprog: CellProgram, Pn: int, Qn: int, *,
                 compression=None, topology=None, comm_local: bool = False,
                 device="cuda"):
    """Single-device grid executor.  Returns ``step(t, data, state) ->
    state`` where ``data``/``state`` are blocked: the P x Q grid is the
    leading axes of the operands and the declared collectives run as
    reductions over them, through a fresh :class:`SyncComm` per step whose
    exactly-once contract is checked after the step.

    With ``compression`` (a :class:`~repro_torch.core.compress.
    CompressionPolicy` or its spec) every payload runs through its codec
    under a :class:`~repro_torch.core.compress.CompressedComm`; with a
    ``topology`` of ``pods > 1`` the reductions over "data" run in two
    levels (see :class:`SyncComm`).  Either one changes the step to
    ``step(t, data, (state, ef)) -> (state, ef)``, where ``ef`` maps each
    stateful policy collective to its ``(P, Q, *cell)`` residual and each
    pod-split collective under a stateful pod codec, keyed
    ``"pod:<name>"``, to its ``(G, Q, *cell)`` one (allocate with
    :func:`grid_bind_state`).  With both None the step and the state are
    exactly the uncompressed program's.

    ``comm_local=True`` builds the timing twin of the uncompressed step
    (``EngineProgram.local_step``): the same cell program under a
    :class:`~repro_torch.core.comm.LocalComm`, every collective
    cell-local, same shapes, no reduction.  It cannot compose with a
    compression policy (a local program puts nothing on the wire), and a
    topology is ignored (the twin runs no reduction at all).
    """
    sizes = {"data": Pn, "model": Qn}
    sched = cellprog.schedule
    device = resolve_device(device)
    if comm_local and compression is not None:
        raise ValueError("comm_local measures the collective-free step; "
                         "it cannot compose with a compression policy")
    topo = None if comm_local else _norm_topology(topology)
    if topo is not None and Pn % topo.pods:
        raise ValueError(f"topology pods={topo.pods} does not divide "
                         f"P={Pn}")
    policy = as_policy(compression)
    if policy is not None:
        policy.validate(sched)

    # the declared per-cell payload shapes, taken once from the first
    # step's operands: a built step (cached ones too) serves one problem
    # shape, so every later step is held to the same declaration
    declared = {}

    def shapes_of(data, state):
        if cellprog.payload_shapes is None:
            return None
        if not declared:
            declared.update(cellprog.payload_shapes(data, state))
        return declared

    if policy is None and topo is None:
        comm_cls = LocalComm if comm_local else SyncComm

        def step(t, data, state):
            comm = comm_cls(sched, sizes, device=device,
                            payload_shapes=shapes_of(data, state))
            out = cellprog.cell(comm, t, data, state)
            comm.finalize()
            return out

        return step

    hier_codec = get_codec(topo.codec) if topo is not None else None

    def step_c(t, data, full_state):
        state, ef = full_state
        inner = SyncComm(sched, sizes, device=device,
                         payload_shapes=shapes_of(data, state))
        if topo is not None:
            inner.set_topology(
                topo, hier_codec,
                ef={k[len(POD_EF):]: v for k, v in ef.items()
                    if k.startswith(POD_EF)})
        comm = inner
        if policy is not None:
            comm = CompressedComm(
                inner, policy,
                ef={k: v for k, v in ef.items() if not k.startswith(POD_EF)})
        out = cellprog.cell(comm, t, data, state)
        comm.finalize()
        ef_out = dict(comm.ef_out) if policy is not None else {}
        if topo is not None:
            ef_out.update({POD_EF + k: v
                           for k, v in inner.hier_ef_out.items()})
        return out, ef_out

    return step_c


def grid_bind_state(cellprog: CellProgram, data, state0, *, Pn: int, Qn: int,
                    compression=None, topology=None, device="cuda"):
    """Engine-state plumbing shared by the grid program constructors.

    The per-cell payload shapes ``cellprog`` declares yield both the wire
    accounting and (when the policy carries error feedback) the zero
    residuals -- one ``(P, Q, *cell)`` f32 buffer per stateful-codec
    collective, matching :func:`grid_program`'s ``ef`` operand.  With a
    hierarchical ``topology`` the cross-pod codec's residuals join the
    same dict under ``"pod:"``-prefixed keys, one ``(G, Q, *cell)``
    buffer each (one per pod and feature block: the intra-pod partial sum
    has the per-cell payload shape), and the accounting is rewritten
    into intra/inter-pod tiers.  Returns ``(full_state0, unwrap, acct)``
    where ``unwrap`` recovers the solver state from the full engine state
    (identity when no comm state is carried, so the uncompressed state
    layout is untouched)."""
    device = resolve_device(device)
    topo = _norm_topology(topology)
    policy = as_policy(compression)
    sizes = {"data": Pn, "model": Qn}
    shapes = cellprog.payload_shapes(data, state0)
    acct = wire_accounting(cellprog.schedule, shapes, sizes, policy)
    acct = hierarchical_accounting(acct, topo, sizes)
    if policy is None and topo is None:
        return state0, (lambda s: s), acct

    def zeros(lead, name):
        return torch.zeros((*lead, *shapes[name]), dtype=torch.float32,
                           device=device)

    ef0 = {}
    if policy is not None:
        ef0.update({name: zeros((Pn, Qn), name)
                    for name in policy.stateful_names(cellprog.schedule)})
    for name in hier_ef_names(cellprog.schedule, topo):
        ef0[POD_EF + name] = zeros((topo.pods, Qn), name)
    return (state0, ef0), (lambda s: s[0]), acct


# ---------------------------------------------------------------------------
# mesh engines: one block per rank of a process grid
# ---------------------------------------------------------------------------

#: the grid axes a leaf of blocked data or state leads with
CELL, ROW, COL = ("data", "model"), ("data",), ("model",)


def resolve(path: str):
    """``"module:function"`` -> the function."""
    module, name = path.split(":")
    return getattr(importlib.import_module(module), name)


def _leaves(tree, specs):
    """``[(leaf, spec), ...]`` of a state or data tuple (a bare tensor
    with a bare spec is one leaf)."""
    if torch.is_tensor(tree):
        return [(tree, specs)]
    return list(zip(tree, specs))


def _rebuild(tree, leaves):
    return leaves[0] if torch.is_tensor(tree) else tuple(leaves)


def cell_of(leaf, spec, p: int, q: int):
    """Cell (p, q)'s part of a blocked leaf that leads with the grid axes
    ``spec``, keeping those axes (extent 1)."""
    if spec == CELL:
        return leaf[p:p + 1, q:q + 1]
    if spec == ROW:
        return leaf[p:p + 1]
    if spec == COL:
        return leaf[q:q + 1]
    return leaf


def _ring_zeros(point, lead, sizes, cell, device):
    """A zero slot of a staleness ring: the result shape of ``point`` on a
    payload ``(*lead, *cell)``."""
    other = lead[1 - BLOCK_AXIS[point.axis]]
    extra = (sizes[point.axis],) if point.op == "allgather" else ()
    return torch.zeros((other, *extra, *cell), device=device)


@dataclasses.dataclass
class MeshJob:
    """What one rank of a process grid needs to build its part of a mesh
    program (picklable: it travels to the worker processes).

    Attributes:
      make_cell: ``"module:function"`` building the solver's
        :class:`CellProgram` from ``cell_kw`` (plus ``index_source=``).
      cell_kw: the keyword arguments of ``make_cell``, with the GLOBAL n
        and m_q (the cell program's math reads the global extents).
      index_source: the whole-grid index source (None when the solver
        draws none); each rank consumes its cell's view of it
        (:class:`~repro_torch.core.indices.CellIndexSource`).
      data, state: the rank's cell of the blocked data tuple and of the
        initial solver state, each leaf keeping its grid axes (extent 1).
      state_specs: the grid axes of each state leaf (``CellProgram``'s).
      setup, setup_kw: optional ``"module:function"`` run once on the
        rank as ``setup(ctx, data, **setup_kw) -> data`` before the first
        step (ADMM's factorization).
      staleness, compression, overlap, topology: the engine knobs.
      hook: the grid's ``rank_hook`` (see ``launch/mesh.py``).
    """

    make_cell: str
    cell_kw: dict
    index_source: Any
    data: tuple
    state: Any
    state_specs: Any
    setup: Optional[str] = None
    setup_kw: Optional[dict] = None
    staleness: int = 0
    compression: Any = None
    overlap: bool = False
    topology: Any = None
    hook: Any = None


@dataclasses.dataclass
class RankProgram:
    """One rank's part of a mesh program: ``state = (solver state, comm
    state)``, ``step(t, state)``, the collective-free twin
    ``local_step(t, state)``, ``export(state, what)`` -- the iterates
    (``what=0``) or the error-feedback residuals (``what=1``) as one flat
    float32 tensor, in the order every rank uses --, ``drain(state)``,
    which waits for the reductions still in flight, and ``set_data(i,
    cell)``, which replaces leaf i of the rank's data tuple (after the
    setup hook) with its new cell."""

    state: Any
    step: Callable[[int, Any], Any]
    local_step: Callable[[int, Any], Any]
    export: Callable[[Any, int], torch.Tensor]
    drain: Callable[[Any], None]
    set_data: Callable[[int, torch.Tensor], None]


def _on(tree, device):
    if torch.is_tensor(tree):
        return tree.to(device).contiguous()
    return tuple(_on(leaf, device) for leaf in tree)


def mesh_step_fn(cellprog: CellProgram, ctx, *, staleness: int = 0,
                 compression=None, overlap: bool = False, topology=None,
                 comm_local: bool = False):
    """Rank-local executor of a mesh program.  Returns ``step(t, data,
    (state, cbufs)) -> (state, cbufs)`` for the rank ``ctx`` (a
    :class:`repro_torch.launch.mesh.RankContext`), whose ``data`` and
    ``state`` are the rank's one cell (leading grid axes of extent 1).
    ``cbufs`` is the communication state -- ``{}`` when no policy needs
    one, else up to three dicts:

      * ``"stale"`` (``staleness = tau > 0``): one FIFO ring of tau
        reduction results per collective (:class:`StaleComm`, or
        :class:`OverlapComm` under ``overlap=True``, whose slots hold the
        dispatched reductions);
      * ``"ef"`` (a policy with stateful codecs): one ``(1, 1, *cell)``
        error-feedback residual per compressed collective;
      * ``"hier_ef"`` (a topology with pods > 1 and a stateful pod codec):
        the rank's ``(1, 1, *cell)`` cross-pod residual per pod-split
        collective.

    ``comm_local=True`` builds the timing twin: every collective
    cell-local (:class:`LocalComm`), on the solver state alone, returning
    the solver state."""
    sizes = dict(ctx.sizes)
    sched = cellprog.schedule
    wire = ProcessWire(ctx)
    device = ctx.device
    if comm_local and (staleness or compression is not None):
        raise ValueError("comm_local measures the collective-free step; "
                         "it cannot compose with staleness or compression")
    topo = None if comm_local else _norm_topology(topology)
    if topo is not None and sizes["data"] % topo.pods:
        raise ValueError(f"topology pods={topo.pods} does not divide "
                         f"P={sizes['data']}")
    policy = as_policy(compression)
    if policy is not None:
        policy.validate(sched)
    hier_codec = get_codec(topo.codec) if topo is not None else None
    hnames = hier_ef_names(sched, topo)
    ef_names = policy.stateful_names(sched) if policy is not None else ()
    declared = {}

    def shapes_of(data, state):
        if cellprog.payload_shapes is None:
            return None
        if not declared:
            declared.update(cellprog.payload_shapes(data, state))
        return declared

    if comm_local:
        def local(t, data, state):
            comm = LocalComm(sched, sizes, device=device,
                             payload_shapes=shapes_of(data, state),
                             wire=wire)
            out = cellprog.cell(comm, t, data, state)
            comm.finalize()
            return out
        return local

    def step(t, data, full_state):
        state, cbufs = full_state
        shapes = shapes_of(data, state)
        if staleness:
            inner = (OverlapComm if overlap else StaleComm)(
                sched, sizes, tau=staleness, t=t, bufs=cbufs["stale"],
                device=device, payload_shapes=shapes, wire=wire)
        else:
            inner = SyncComm(sched, sizes, device=device,
                             payload_shapes=shapes, wire=wire)
        if topo is not None:
            inner.set_topology(topo, hier_codec,
                               ef=cbufs.get("hier_ef", {}))
        comm = inner
        if policy is not None:
            comm = CompressedComm(inner, policy, ef=cbufs.get("ef", {}))
        out = cellprog.cell(comm, t, data, state)
        comm.finalize()
        cb = {}
        if staleness:
            cb["stale"] = dict(inner.bufs_out)
        if ef_names:
            cb["ef"] = dict(comm.ef_out)
        if hnames:
            cb["hier_ef"] = dict(inner.hier_ef_out)
        return out, cb

    return step


def mesh_comm_state(cellprog: CellProgram, ctx, data, state, *,
                    staleness: int = 0, compression=None,
                    overlap: bool = False, topology=None) -> dict:
    """The zero communication state of a rank's mesh program (see
    :func:`mesh_step_fn`), sized from the declared payload shapes."""
    sched = cellprog.schedule
    shapes = cellprog.payload_shapes(data, state)
    lead, dev = (1, 1), ctx.device
    comm0 = {}
    if staleness:
        comm0["stale"] = {}
        for point in sched:
            zero = _ring_zeros(point, lead, ctx.sizes, shapes[point.name],
                               dev)
            comm0["stale"][point.name] = (
                (Ready(zero),) if overlap else (zero,)) * staleness
    policy = as_policy(compression)
    if policy is not None and policy.stateful_names(sched):
        comm0["ef"] = {name: torch.zeros((*lead, *shapes[name]),
                                         device=dev)
                       for name in policy.stateful_names(sched)}
    hnames = hier_ef_names(sched, _norm_topology(topology))
    if hnames:
        comm0["hier_ef"] = {name: torch.zeros((*lead, *shapes[name]),
                                              device=dev)
                            for name in hnames}
    return comm0


def build_rank_program(ctx, job: MeshJob) -> RankProgram:
    """Build rank ``ctx``'s part of a mesh program from its job, on its
    device (what every rank of a session runs, the controller too)."""
    dev = ctx.device
    kw = dict(job.cell_kw)
    if job.index_source is not None:
        kw["index_source"] = CellIndexSource(job.index_source, ctx.p, ctx.q,
                                             device=dev)
    cellprog = resolve(job.make_cell)(**kw)
    data = _on(job.data, dev)
    if job.setup is not None:
        data = resolve(job.setup)(ctx, data, **(job.setup_kw or {}))
    data = list(data)        # a DATA command replaces a leaf in place
    state0 = _on(job.state, dev)
    knobs = dict(staleness=job.staleness, compression=job.compression,
                 overlap=job.overlap, topology=job.topology)
    step = mesh_step_fn(cellprog, ctx, **knobs)
    local = mesh_step_fn(cellprog, ctx, comm_local=True)
    comm0 = mesh_comm_state(cellprog, ctx, tuple(data), state0, **knobs)
    specs = job.state_specs

    def export(full_state, what):
        state, cbufs = full_state
        if what == 0:
            leaves = [leaf for leaf, _ in _leaves(state, specs)]
        else:
            leaves = [cbufs[kind][name] for kind in ("ef", "hier_ef")
                      for name in sorted(cbufs.get(kind, {}))]
        if not leaves:
            return torch.zeros((0,), device=dev)
        return torch.cat([leaf.reshape(-1).float() for leaf in leaves])

    def drain_state(full_state):
        if job.overlap:
            drain(full_state[1].get("stale", {}))

    def set_data(i, cell):
        data[i] = cell.contiguous()

    return RankProgram(
        state=(state0, comm0),
        step=lambda t, s: step(t, tuple(data), s),
        local_step=lambda t, s: local(t, tuple(data), s[0]),
        export=export, drain=drain_state, set_data=set_data)


def _assemble(parts, template, specs, P: int, Q: int):
    """The blocked global state from every rank's exported iterates
    (``parts[r]``, rank ``r = p * Q + q``): a leaf led by "data" comes
    from the ranks (p, 0), one led by "model" from the ranks (0, q), a
    cell leaf from every rank."""
    out, off = [], 0
    for leaf, spec in _leaves(template, specs):
        size = leaf.numel()
        cell = [part[off:off + size].reshape(leaf.shape) for part in parts]
        off += size
        if spec == ROW:
            out.append(torch.cat([cell[p * Q] for p in range(P)]))
        elif spec == COL:
            out.append(torch.cat(cell[:Q]))
        else:
            out.append(torch.cat(cell).reshape(P, Q, *leaf.shape[2:]))
    return _rebuild(template, out)


def _assemble_ef(parts, template: dict, P: int, Q: int, pods: int):
    """The grid engine's ``ef`` dict from every rank's residuals: a policy
    residual ``(P, Q, *cell)`` from every rank, a pod residual ``(G, Q,
    *cell)`` (key ``"pod:<name>"``) from the first rank of each pod."""
    out, off = {}, 0
    for kind in ("ef", "hier_ef"):
        for name in sorted(template.get(kind, {})):
            shape = template[kind][name].shape
            size = template[kind][name].numel()
            cell = [part[off:off + size].reshape(shape[2:]) for part in parts]
            off += size
            if kind == "ef":
                out[name] = torch.stack(cell).reshape(P, Q, *shape[2:])
            else:
                per = P // pods
                out[POD_EF + name] = torch.stack(
                    [cell[g * per * Q + q] for g in range(pods)
                     for q in range(Q)]).reshape(pods, Q, *shape[2:])
    return out


def bind_mesh_program(grid, *, make_cell: str, cell_kw: dict, index_source,
                      data, data_specs, state0, state_specs, w_of,
                      alpha_of=None, setup: Optional[str] = None,
                      setup_kw: Optional[dict] = None, staleness: int = 0,
                      compression=None, overlap: bool = False,
                      topology=None, data_names=None) -> EngineProgram:
    """The controller's :class:`EngineProgram` of a mesh program on
    process grid ``grid``.

    ``data`` / ``state0`` are the GLOBAL blocked data tuple and initial
    solver state (host tensors, the grid engine's layout), ``data_specs``
    / ``state_specs`` their leaves' grid axes; rank (p, q) receives cell
    (p, q) of each (:func:`cell_of`).  ``w_of`` / ``alpha_of`` read the
    global iterates from the blocked solver state, as the grid engine's
    extractors do; here they run on the state gathered from the ranks,
    and their results are moved to the grid's device.

    The program's state is a :class:`repro_torch.launch.mesh.MeshState`
    handle; ``step`` broadcasts one outer step to the grid and runs rank
    0's part; ``comm_bytes`` is the grid engine's exact wire accounting
    of the same schedule, payloads and knobs (every rank puts one payload
    per collective on the wire per step, whatever the staleness);
    ``set_data`` replaces a data leaf on every rank, by index or by its
    name in ``data_names`` (one name per leaf of ``data``)."""
    from ..launch.mesh import ITERATES, RESIDUALS, MeshState, OP_GATHER, \
        OP_LOCAL, OP_STEP
    P, Q = grid.P, grid.Q
    sizes = {"data": P, "model": Q}
    topo = _norm_topology(topology)
    if topo is not None and topo.pods not in grid.pods:
        raise ValueError(f"topology pods={topo.pods} must divide P={P}")
    policy = as_policy(compression)
    cell_kw = dict(cell_kw)
    src_kw = {} if index_source is None else {"index_source": index_source}
    probe = resolve(make_cell)(**cell_kw, **src_kw)
    if policy is not None:
        policy.validate(probe.schedule)
    acct = wire_accounting(probe.schedule,
                           probe.payload_shapes(data, state0), sizes,
                           policy)
    acct = hierarchical_accounting(acct, topo, sizes)
    overlap = bool(overlap) and staleness > 0

    jobs = []
    for r in range(P * Q):
        p, q = divmod(r, Q)
        cell_data = tuple(cell_of(leaf, spec, p, q)
                          for leaf, spec in zip(data, data_specs))
        cell_state = _rebuild(state0, [cell_of(leaf, spec, p, q)
                                       for leaf, spec
                                       in _leaves(state0, state_specs)])
        jobs.append(MeshJob(
            make_cell=make_cell, cell_kw=cell_kw, index_source=index_source,
            data=cell_data, state=cell_state, state_specs=state_specs,
            setup=setup, setup_kw=setup_kw, staleness=staleness,
            compression=policy, overlap=overlap, topology=topo,
            hook=grid.rank_hook))
    session = grid.open_session(jobs)
    template = session.rank.states[0]
    dev = grid.device
    gathered = {}

    def gather(s, what):
        key = (s.sid, what)
        if key not in gathered:
            _, parts = session.command(OP_GATHER, src=s.sid, what=what)
            if what == ITERATES:
                got = _assemble(parts, template[0], state_specs, P, Q)
            else:
                got = _assemble_ef(parts, template[1], P, Q,
                                   topo.pods if topo is not None else 1)
            gathered.clear()
            gathered[key] = got
        return gathered[key]

    def step(t, s):
        sid, local = session.command(OP_STEP, t, s.sid)
        return MeshState(local, sid)

    def local_step(t, s):
        session.command(OP_LOCAL, t, s.sid)
        return s

    names = list(data_names) if data_names is not None else []

    def set_data(leaf, value):
        i = names.index(leaf) if isinstance(leaf, str) else int(leaf)
        session.put(i, value, data_specs[i])

    has_ef = bool(template[1].get("ef") or template[1].get("hier_ef"))
    return EngineProgram(
        state=MeshState(template, 0),
        step=step,
        w_of=lambda s: w_of(gather(s, ITERATES)).to(dev),
        alpha_of=(None if alpha_of is None else
                  (lambda s: alpha_of(gather(s, ITERATES)).to(dev))),
        comm_bytes=acct,
        ef_of=((lambda s: {k: v.to(dev) for k, v
                           in gather(s, RESIDUALS).items()})
               if has_ef else None),
        local_step=local_step,
        staleness=int(staleness), overlap=overlap,
        sync_of=(lambda s: s.local[0]) if overlap else None,
        close=session.close, set_data=set_data)

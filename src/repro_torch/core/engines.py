"""Engine executors for the unified solver framework (``core/solver.py``).

An *engine* is how the P x Q block grid of the paper is executed.  Each
solver contributes ONE :class:`CellProgram` -- its step math plus a
:class:`~repro_torch.core.comm.CommSchedule` declaring every cross-cell
reduction as a named collective.  This slice has one engine:

  * ``"simulated"`` -- :func:`grid_program`: the grid is the leading
    (P, Q) axes of blocked tensors on one device, the declared
    collectives are reductions over those axes, and the cell-local
    kernels take all cells of one outer step in one launch.

Orthogonally, a :class:`~repro_torch.core.compress.CompressionPolicy`
(``compression=``) routes every declared collective's payload through a
codec with error feedback, and a ``topology="pods=G[:codec]"`` runs the
reductions over "data" in two levels (full precision within each pod,
the pod codec across pods).  Every program reports its exact
bytes-on-wire (``EngineProgram.comm_bytes``), computed at build time from
the per-cell payload shapes each :class:`CellProgram` declares.

The mesh engines of the reference (shard_map, async, overlap) are not
ported yet (ROADMAP queue A, multi-device engines).

The executor produces an :class:`EngineProgram` -- initial state, outer
step, extractors for the global primal (and dual) iterates.  Everything
else (the outer loop, history, early stopping, warm starts) lives once
in the shared outer loop (``drive`` / ``Solver.solve``).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Optional

import torch

from .comm import CommSchedule, LocalComm, SyncComm, hier_ef_names
from .comm_model import Topology, hierarchical_accounting
from .compress import CompressedComm, as_policy, get_codec, wire_accounting
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
    """

    state: Any
    step: Callable[[int, Any], Any]
    w_of: Callable[[Any], torch.Tensor]
    alpha_of: Optional[Callable[[Any], torch.Tensor]] = None
    comm_bytes: Optional[dict] = None
    ef_of: Optional[Callable[[Any], dict]] = None
    local_step: Optional[Callable[[int, Any], Any]] = None


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
    dev = device_of(state)
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

"""Process grids: the paper's P x Q grid as P*Q processes, one cell each.

The reference runs its mesh engines as one program over a ``jax`` mesh of
P x Q devices (``launch/mesh.py::make_mesh`` / ``make_grid_mesh``).  The
port runs them as a ``torch.distributed`` program over a *process grid*:

  * rank ``r = p * Q + q`` owns cell (p, q) -- the block x_[p,q] that cell
    (p, q) of the grid engine sees -- on device ``cuda:(r % cards)`` (every
    rank on the one card of a one-card machine) or on the CPU;
  * rank 0 is the calling process, the controller: it holds (X, y), cuts
    the blocks, evaluates the objective and the gap from the iterates it
    gathers, and tells the other ranks what to do next; ranks 1..P*Q-1 are
    worker processes forked from one parent process, itself started with
    the ``spawn`` method: it imports the program once and never
    initializes CUDA (a fork after CUDA initialization is invalid), so
    a rank costs a fork, not an import of torch;
  * the process groups: the whole grid, every row (the ranks of one p: the
    "model" reductions), every column (one q: the "data" reductions) and,
    for every pod count G that divides P, every pod (the ranks of one
    column in one of G contiguous ranges of p) and every cross-pod group
    (the ranks of one column at the same place in their pods);
  * the collectives run on gloo: NCCL refuses two ranks of one
    communicator on one card, and the ranks of a one-card machine share
    it.

A grid is memoized like the reference's ``make_grid_mesh``
(:func:`process_grid`), so repeated solves reuse the same ranks; a
process holds one live grid at a time (one default process group), and
asking for another shape closes the current one.

**Sessions.**  A solve opens a session: the controller hands every worker
its job (its cell of the blocked data and initial state, the recipe of
the cell program, the engine knobs) through a ``torch.multiprocessing``
queue -- CPU tensors travel as shared memory, so no rank regenerates or
copies the whole matrix -- and every rank builds the same rank program
(``core/engines.py::build_rank_program``).  Then the controller drives it
by commands broadcast to the grid, which every rank executes in the same
order: ``STEP t src dst`` (one outer step from held state ``src`` into
``dst``), ``LOCAL t src`` (the collective-free timing twin, ended when
every rank's device has finished it), ``GATHER src what`` (the iterates
or the error-feedback residuals of every rank to the controller),
``BARRIER`` (every rank waits for its device, then for the others),
``DATA leaf`` (a new value of one leaf of the program's data tuple, each
rank receiving its cell of it -- how the fleet changes which tenants are
active between segments), ``CALL`` (a named function run on every rank
on the cells it receives and the rank's *resident* store, see below) and
``STOP``.  DATA and CALL carry tensors: the controller cuts the global
tensor into every rank's cell (``core/engines.py::cell_of``), broadcasts
their shapes and scatters them, one cell a rank.  Each rank holds
the initial state and the last two it made, so the timed path's
calibration can re-step from the initial state.  At ``STOP`` each worker
returns the launches its kernel wrappers counted in that session (summed
into the grid's ``worker_launches``; the controller's wrappers count only
the controller's own launches) and the report of the grid's
``rank_hook``.

**Resident state and the command lock.**  Each rank keeps a dict,
``RankContext.resident``, that outlives sessions: what a CALL stores there
(the scorer's weight blocks, ``serve/scoring.py``) stays on the rank while
solver sessions come and go.  A CALL runs in whatever session is open --
a solve's, between two of its steps -- or, when none is, in an *idle*
session the grid opens for that one command and closes after it (a rank
waits for commands only inside a session; between sessions it waits on its
job queue, where no collective can time out).  Every command, and every
opening and closing of a session, holds the grid's ``lock`` (re-entrant)
while it runs: threads that share a grid -- a scoring thread beside an
update in flight -- interleave whole commands, never parts of one, and
every rank sees the commands in the same order.  A caller that needs two
commands to see nothing in between holds ``lock`` around both.

**Failures.**  A worker that raises sends its traceback and exits at
once, which breaks its peers out of their collectives; the controller
then raises with that traceback and closes the grid, as it does when a
command fails on the controller.  An exception on the controller between
commands (in the caller's own code) leaves the ranks waiting for the next
command: the session is ended when the grid opens its next one.  Every
collective and every wait is bounded by the grid's ``timeout``.
"""
from __future__ import annotations

import atexit
import contextlib
import dataclasses
import datetime
import importlib
import math
import os
import queue
import signal
import threading
import time
import traceback
from typing import Any, Callable, Dict, NamedTuple, Optional

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from ..core.util import resolve_device

#: seconds any collective or wait of a grid may take before it fails
DEFAULT_TIMEOUT_S = 300.0

OP_STEP, OP_LOCAL, OP_GATHER, OP_BARRIER, OP_STOP, OP_DATA, OP_CALL = \
    range(7)
#: what a GATHER collects
ITERATES, RESIDUALS = 0, 1

#: the kernel wrappers whose launches the ranks count (module, name)
COUNTED = (("repro_torch.kernels.sdca.ops", "sdca_epoch"),
           ("repro_torch.kernels.sdca.sparse", "sdca_epoch_sparse"),
           ("repro_torch.kernels.svrg.ops", "svrg_inner"),
           ("repro_torch.kernels.svrg.sparse", "svrg_inner_sparse"),
           ("repro_torch.kernels.flash.ops", "flash_attention"),
           ("repro_torch.kernels.flash.ops", "flash_attention_backward"),
           ("repro_torch.kernels.linattn.ops", "rwkv_linattn"),
           ("repro_torch.kernels.linattn.ops", "rwkv_linattn_backward"))
#: the counters of a wrapper besides ``launches``: the calls that took the
#: plain backward (B5 / B6 on the CPU), and dicts of launches
_SCALARS = ("plain_backwards",)
_COUNTERS = ("launches_by_route", "launches_by_cluster",
             "launches_by_head_dim", "launches_by_kernel")


def _pod_counts(P: int):
    return [G for G in range(2, P + 1) if P % G == 0]


@dataclasses.dataclass(frozen=True)
class GridSpec:
    """What a worker needs to join its grid (picklable)."""

    P: int
    Q: int
    port: int
    device_type: str
    timeout_s: float
    controller: int           # the pid of rank 0
    threads: int              # rank 0's intra-op threads when it started

    @property
    def world(self) -> int:
        return self.P * self.Q

    @property
    def cpu_threads(self) -> int:
        """A CPU rank's intra-op threads: its share of the host's cores,
        never more than the caller itself runs (a caller held to one
        thread, beside other processes of its own, gets ranks of one)."""
        return max(1, min(self.threads, (os.cpu_count() or 1) // self.world))


class RankContext:
    """One rank's view of its grid: its cell (p, q), its device, the
    global extents and its process groups (see the module docstring)."""

    def __init__(self, spec: GridSpec, rank: int, device: torch.device):
        self.P, self.Q = spec.P, spec.Q
        self.rank = rank
        self.p, self.q = divmod(rank, spec.Q)
        self.device = device
        self.sizes = {"data": spec.P, "model": spec.Q}
        self.cpu_threads = spec.cpu_threads
        #: what CALLs keep on this rank across sessions, by key
        self.resident: Dict[str, Any] = {}
        self._groups = _make_groups(spec.P, spec.Q)

    def group(self, axis: str):
        """The group a reduction over ``axis`` runs on: the rank's column
        for "data", its row for "model"."""
        if axis == "data":
            return self._groups["col"][self.q]
        return self._groups["row"][self.p]

    def pod_group(self, G: int):
        return self._groups["pod"][(G, self.p // (self.P // G), self.q)]

    def cross_group(self, G: int):
        return self._groups["cross"][(G, self.p % (self.P // G), self.q)]

    def barrier(self):
        dist.barrier()

    def gather(self, flat: torch.Tensor):
        """Every rank's ``flat`` (float32, the same size on every rank) to
        the controller: a list in rank order there, None elsewhere."""
        host = flat.detach().to("cpu").contiguous()
        parts = ([torch.empty_like(host) for _ in range(self.P * self.Q)]
                 if self.rank == 0 else None)
        dist.gather(host, parts, dst=0)
        return parts


def _make_groups(P: int, Q: int) -> dict:
    """Every process group of a P x Q grid, made in the same order on
    every rank (``dist.new_group`` is collective)."""
    groups = {"row": {}, "col": {}, "pod": {}, "cross": {}}
    for p in range(P):
        groups["row"][p] = dist.new_group([p * Q + q for q in range(Q)])
    for q in range(Q):
        groups["col"][q] = dist.new_group([p * Q + q for p in range(P)])
    for G in _pod_counts(P):
        per = P // G
        for q in range(Q):
            for g in range(G):
                groups["pod"][(G, g, q)] = dist.new_group(
                    [(g * per + i) * Q + q for i in range(per)])
            for i in range(per):
                groups["cross"][(G, i, q)] = dist.new_group(
                    [(g * per + i) * Q + q for g in range(G)])
    return groups


def _rank_device(device_type: str, rank: int) -> torch.device:
    if device_type == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
        return dev
    return torch.device("cpu")


# ---------------------------------------------------------------------------
# launch counts and the rank hook
# ---------------------------------------------------------------------------

def launch_counts() -> dict:
    """This process's counts of the counted kernel wrappers: ``{name:
    {"launches": n, "launches_by_route": {...}, ...}}``."""
    out = {}
    for module, name in COUNTED:
        fn = getattr(importlib.import_module(module), name)
        out[name] = {"launches": fn.launches}
        out[name].update({k: getattr(fn, k) for k in _SCALARS
                          if hasattr(fn, k)})
        out[name].update({k: dict(getattr(fn, k)) for k in _COUNTERS
                          if hasattr(fn, k)})
    return out


def add_counts(a: dict, b: dict, sign: int = 1) -> dict:
    """``a + sign * b``, counter by counter, of two :func:`launch_counts`
    dicts (a new dict)."""
    out = {}
    for name in a.keys() | b.keys():
        ca, cb = a.get(name, {}), b.get(name, {})
        out[name] = {}
        for k in ca.keys() | cb.keys():
            if k == "launches" or k in _SCALARS:
                out[name][k] = ca.get(k, 0) + sign * cb.get(k, 0)
            else:
                ka, kb = ca.get(k, {}), cb.get(k, {})
                out[name][k] = {r: ka.get(r, 0) + sign * kb.get(r, 0)
                                for r in ka.keys() | kb.keys()}
    return out


def _hook_of(hook, rank: int):
    return hook(rank) if hook is not None else contextlib.nullcontext({})


class IdleJob:
    """The job of an idle session: no program, no hook -- the ranks only
    execute CALLs (and BARRIERs) until STOP."""

    hook = None


def _build(ctx, job):
    """A rank's program for ``job`` (None for an idle session)."""
    if isinstance(job, IdleJob):
        return None
    from ..core.engines import build_rank_program
    return build_rank_program(ctx, job)


def _share(obj):
    """Move every CPU tensor of a job into shared memory now, on the
    calling thread.  A queue pickles what it is given later, on its
    feeder thread, and moving a storage there swaps its memory under any
    reader -- rank 0 reads the same storages while it builds its own
    program (ADMM's setup computes its gram from them)."""
    if torch.is_tensor(obj):
        if obj.device.type == "cpu":
            obj.share_memory_()
    elif isinstance(obj, (tuple, list)):
        for v in obj:
            _share(v)
    elif isinstance(obj, dict):
        for v in obj.values():
            _share(v)
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        for f in dataclasses.fields(obj):
            _share(getattr(obj, f.name))


def _exchange(ctx, payload):
    """The tensors of a DATA or CALL command: rank 0 broadcasts the head
    (a picklable dict whose ``"cells"`` lists each tensor's cell shape and
    dtype) and scatters every rank its cell of each tensor (``payload =
    (head, [[cell of rank r for r in ranks] per tensor])`` on rank 0, None
    elsewhere).  Returns ``(head, this rank's cells on its device)``."""
    box = [payload[0] if ctx.rank == 0 else None]
    dist.broadcast_object_list(box, src=0)
    head = box[0]
    cells = []
    for i, (shape, dtype) in enumerate(head["cells"]):
        buf = torch.empty(shape, dtype=dtype)
        dist.scatter(buf, payload[1][i] if ctx.rank == 0 else None, src=0)
        cells.append(buf.to(ctx.device))
    return head, cells


# ---------------------------------------------------------------------------
# one rank's side of a session
# ---------------------------------------------------------------------------

class RankSession:
    """A rank's program and the states it holds, by id: the initial state
    (id 0) and the last two states made (the controller keeps the same
    book, so it knows what every rank holds).  An idle session has no
    program (``prog`` None) and holds no state."""

    KEEP = 2

    def __init__(self, ctx: RankContext, prog):
        self.ctx, self.prog = ctx, prog
        self.states = {0: prog.state} if prog is not None else {0: None}
        self._made = []

    def holds(self, sid: int) -> bool:
        return sid in self.states

    def execute(self, op: int, t: int, src: int, dst: int, what: int,
                payload=None):
        """Rank's part of one command; ``payload`` is rank 0's tensors of
        a DATA or CALL command (see :func:`_exchange`)."""
        if op == OP_CALL:
            from ..core.engines import resolve
            head, cells = _exchange(self.ctx, payload)
            return resolve(head["fn"])(self.ctx, *cells, **head["kw"])
        if op == OP_BARRIER:
            self._wait_all()
            return None
        if self.prog is None:
            raise ValueError(f"grid command {op} needs a program; this "
                             "session is idle")
        if op == OP_DATA:
            _, (cell,) = _exchange(self.ctx, payload)
            self.prog.set_data(what, cell)
            return None
        if op == OP_STEP:
            self.states[dst] = self.prog.step(t, self.states[src])
            self._made.append(dst)
            for old in self._made[:-self.KEEP]:
                if old != src:
                    self.states.pop(old, None)
            self._made = self._made[-self.KEEP:]
            return self.states[dst]
        if op == OP_LOCAL:
            self.prog.local_step(t, self.states[src])
            self._wait_all()
            return None
        if op == OP_GATHER:
            return self.ctx.gather(self.prog.export(self.states[src], what))
        raise ValueError(f"unknown grid command {op}")

    def _wait_all(self):
        """This rank's device work done, then every rank's."""
        if self.ctx.device.type == "cuda":
            torch.cuda.synchronize(self.ctx.device)
        self.ctx.barrier()

    def finish(self):
        """End of session: wait for every reduction still in flight."""
        if self.prog is None:
            return
        for state in self.states.values():
            self.prog.drain(state)


def _serve(ctx: RankContext, job) -> dict:
    """A worker's session: build the rank program, execute commands until
    STOP, return the launches counted and the hook's report."""
    before = launch_counts()
    with _hook_of(job.hook, ctx.rank) as report:
        session = RankSession(ctx, _build(ctx, job))
        cmd = torch.zeros(5, dtype=torch.int64)
        while True:
            dist.broadcast(cmd, src=0)
            op, t, src, dst, what = (int(v) for v in cmd)
            if op == OP_STOP:
                break
            session.execute(op, t, src, dst, what)
        session.finish()
    return {"counts": add_counts(launch_counts(), before, -1),
            "report": report}


def _join(spec: GridSpec, rank: int) -> RankContext:
    device = _rank_device(spec.device_type, rank)
    timeout = datetime.timedelta(seconds=spec.timeout_s)
    store = (None if rank == 0 else
             dist.TCPStore("127.0.0.1", spec.port, spec.world,
                           is_master=False, timeout=timeout))
    if rank != 0:
        dist.init_process_group("gloo", store=store, rank=rank,
                                world_size=spec.world, timeout=timeout)
    return RankContext(spec, rank, device)


def _alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:
        pass
    return True


def _next_job(jobs, controller: int):
    """The next job, or None to stop: when the controller says so, or
    when it has died without saying so."""
    while True:
        try:
            return jobs.get(timeout=1.0)
        except queue.Empty:
            if not _alive(controller):
                return None


def _worker(rank: int, spec: GridSpec, jobs, results):
    """Entry point of ranks 1..P*Q-1."""
    try:
        if spec.device_type == "cpu":
            torch.set_num_threads(spec.cpu_threads)
        results.put((rank, "started", None))
        ctx = _join(spec, rank)
        results.put((rank, "ready", None))
        while True:
            job = _next_job(jobs, spec.controller)
            if job is None:
                break
            results.put((rank, "done", _serve(ctx, job)))
    except BaseException:
        results.put((rank, "error", traceback.format_exc()))
        results.close()
        results.join_thread()
        os._exit(1)          # breaks the peers out of their collectives
    dist.destroy_process_group()


def _forker(spec: GridSpec, jobs, results):
    """The parent of ranks 1..P*Q-1 (started with the ``spawn`` method, so
    it has imported the program and this module and never touches a
    device): leads a process group of its own, forks every rank into it,
    reports each rank's exit code as it ends, and ends when they all
    have."""
    os.setpgrp()               # the controller ends the grid by its group
    ctx = mp.get_context("fork")
    ranks = {}
    for r in range(1, spec.world):
        proc = ctx.Process(target=_worker, args=(r, spec, jobs[r], results),
                           name=f"grid-rank-{r}")
        proc.start()
        ranks[proc.pid] = r
    while ranks:
        pid, status = os.waitpid(-1, 0)
        if pid in ranks:
            results.put((ranks.pop(pid), "exited",
                         os.waitstatus_to_exitcode(status)))


# ---------------------------------------------------------------------------
# the controller
# ---------------------------------------------------------------------------

class MeshState(NamedTuple):
    """The controller's handle of a state the grid holds: rank 0's own
    state (``local``) and the id every rank keeps it under."""

    local: Any
    sid: int


class GridError(RuntimeError):
    """A process grid failed; the message holds the failing rank's
    traceback.  The grid is closed."""


class ProcessGrid:
    """A P x Q grid of processes (see the module docstring); build with
    :func:`process_grid`.

    Attributes:
      rank_hook: None, or a picklable ``hook(rank)`` returning a context
        manager that every rank enters around its side of each session;
        the dict it yields is that rank's report, collected in
        ``reports`` when the session ends.
      reports: ``{rank: report}`` of the last finished session.
      worker_launches: the launches of the counted kernel wrappers that
        ranks 1..PQ-1 reported at the end of their sessions, summed over
        ranks and sessions since the grid started (a
        :func:`launch_counts` dict).  Rank 0's launches are in the
        controller's wrappers' own counters.
      spawn_s: seconds from the first spawn to every rank joined;
        ``start_s`` of them until every worker had imported what it runs
        (the rest: devices, the process group and its subgroups).
    """

    def __init__(self, P: int, Q: int, *, device="cuda",
                 timeout: float = DEFAULT_TIMEOUT_S):
        self.P, self.Q = int(P), int(Q)
        self.world = self.P * self.Q
        self.device = resolve_device(device)
        self.timeout = float(timeout)
        self.rank_hook: Optional[Callable] = None
        self.reports: Dict[int, dict] = {}
        self.worker_launches: Dict[str, dict] = {}
        self.closed = False
        #: held by every command and session change (see the module
        #: docstring)
        self.lock = threading.RLock()
        self._session = None
        if self.device.type == "cuda":
            # build the kernels once, before any rank could start nvcc
            from ..kernels import load_library
            load_library()
        if dist.is_initialized():
            raise RuntimeError("this process already belongs to a process "
                               "group; one process grid at a time")
        t0 = time.perf_counter()
        td = datetime.timedelta(seconds=self.timeout)
        store = dist.TCPStore("127.0.0.1", 0, self.world, is_master=True,
                              timeout=td, wait_for_workers=False)
        spec = GridSpec(self.P, self.Q, store.port, self.device.type,
                        self.timeout, os.getpid(), torch.get_num_threads())
        ctx = mp.get_context("spawn")
        self._results = ctx.Queue()
        self._jobs = {r: ctx.Queue() for r in range(1, self.world)}
        self._forker = ctx.Process(target=_forker, name="grid-ranks",
                                   args=(spec, self._jobs, self._results))
        workers = range(1, self.world)
        try:
            self._forker.start()
            # every worker alive before rank 0 blocks in the rendezvous (a
            # worker that dies there is seen at once)
            self._await({r: "started" for r in workers})
            self.start_s = time.perf_counter() - t0
            dist.init_process_group("gloo", store=store, rank=0,
                                    world_size=self.world, timeout=td)
            self.ctx = RankContext(spec, 0, self.device)
            self._await({r: "ready" for r in workers})
        except BaseException:
            self._kill()
            raise
        self.spawn_s = time.perf_counter() - t0

    @property
    def pods(self):
        """The pod counts this grid has groups for."""
        return tuple(_pod_counts(self.P))

    def __repr__(self):
        return (f"ProcessGrid({self.P}x{self.Q}, device={self.device}, "
                f"ranks={self.world})")

    # -- results from the workers ---------------------------------------------
    def _await(self, want: Dict[int, str]) -> Dict[int, Any]:
        """Wait for one message of kind ``want[rank]`` from each rank;
        raise GridError on a worker's error, death or the timeout."""
        got: Dict[int, Any] = {}
        deadline = time.monotonic() + self.timeout
        while len(got) < len(want):
            try:
                rank, kind, payload = self._results.get(timeout=0.5)
            except queue.Empty:
                if not self._forker.is_alive():
                    raise GridError(f"{self}: the ranks' parent process "
                                    f"exited (code {self._forker.exitcode})")
                if time.monotonic() > deadline:
                    raise GridError(f"{self}: no word from ranks "
                                    f"{sorted(set(want) - set(got))} in "
                                    f"{self.timeout:g} s")
                continue
            if kind == "error":
                raise GridError(f"{self}: rank {rank} "
                                f"(cell {divmod(rank, self.Q)}) failed:\n"
                                f"{payload}")
            elif kind == "exited" and rank in want and rank not in got:
                raise GridError(f"{self}: rank {rank} exited (code "
                                f"{payload}) without reporting")
            elif want.get(rank) == kind:
                got[rank] = payload
        return got

    def _worker_errors(self, wait_s: float = 2.0) -> str:
        """The tracebacks workers sent (after a failed collective)."""
        msgs = []
        deadline = time.monotonic() + wait_s
        while time.monotonic() < deadline:
            try:
                rank, kind, payload = self._results.get(timeout=0.1)
            except queue.Empty:
                if msgs:
                    break
                continue
            if kind == "error":
                msgs.append(f"rank {rank} (cell {divmod(rank, self.Q)}):\n"
                            f"{payload}")
        return "\n".join(msgs)

    # -- sessions ---------------------------------------------------------------
    def open_session(self, jobs) -> "MeshSession":
        """Hand ``jobs[r]`` to rank r, build rank 0's program and return
        the controller's session.  A session still open is closed
        first."""
        with self.lock:
            if self.closed:
                raise GridError(f"{self} is closed")
            self.close_session()
            try:
                for r in range(1, self.world):
                    _share(jobs[r])
                    self._jobs[r].put(jobs[r])
                hook = _hook_of(jobs[0].hook, 0)
                report = hook.__enter__()
                prog = _build(self.ctx, jobs[0])
            except BaseException as e:
                self.fail(e)
            self._session = MeshSession(self, prog, hook, report,
                                        idle=isinstance(jobs[0], IdleJob))
            return self._session

    def close_session(self):
        with self.lock:
            if self._session is not None:
                self._session.close()

    def barrier(self):
        """Wait until every rank of the open session has finished what it
        was given, on its device too (a clock read after this one is a
        step of the whole grid)."""
        with self.lock:
            if self._session is None:
                raise GridError(f"{self} has no open session")
            self._session.command(OP_BARRIER)

    def call(self, fn: str, leaves=(), **kw):
        """Run ``fn(ctx, *cells, **kw)`` on every rank (one CALL command)
        and return rank 0's result.  ``fn`` is a ``"module:function"``
        path; ``leaves`` are ``(tensor, spec)`` pairs -- a global tensor
        and the grid axes it leads with (``core/engines.py::cell_of``) --
        of which each rank receives its cell, on its device; ``kw`` must
        be picklable.  ``ctx`` is the rank's :class:`RankContext`, whose
        ``resident`` dict outlives sessions.  The call runs in the open
        session, or in an idle one opened and closed around it."""
        with self.lock:
            if self.closed:
                raise GridError(f"{self} is closed")
            if self._session is not None:
                return self._session.call(fn, leaves, **kw)
            session = self.open_session([IdleJob()] * self.world)
            try:
                return session.call(fn, leaves, **kw)
            finally:
                session.close()

    def fail(self, exc: BaseException):
        """Close the grid after a failure and raise GridError with what
        the workers reported (an interrupt is re-raised as it is)."""
        if isinstance(exc, GridError) or not isinstance(exc, Exception):
            self.close(force=True)
            raise exc
        told = self._worker_errors()
        self.close(force=True)
        detail = f"\n{told}" if told else ""
        raise GridError(f"{self} failed: {exc!r}{detail}") from exc

    # -- shutdown ---------------------------------------------------------------
    def _kill(self):
        """Kill the ranks' parent (so it forks no more), then its process
        group: every rank."""
        if self._forker.pid is not None:
            self._forker.kill()
            self._forker.join(timeout=5)
            try:
                os.killpg(self._forker.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
        if dist.is_initialized():
            dist.destroy_process_group()

    def close(self, force: bool = False):
        """Stop every worker and leave the process group."""
        if self.closed:
            return
        self.closed = True
        _GRIDS.pop(_key(self.P, self.Q, self.device), None)
        if force:
            self._session = None
            self._kill()
            return
        try:
            self.close_session()
        finally:
            for jobs in self._jobs.values():
                jobs.put(None)
            # the ranks end, their parent reports it and ends; read what it
            # writes while waiting, so it never blocks on a full pipe
            deadline = time.monotonic() + min(self.timeout, 30.0)
            while self._forker.is_alive() and time.monotonic() < deadline:
                try:
                    self._results.get(timeout=0.1)
                except queue.Empty:
                    pass
            self._kill()


class MeshSession:
    """The controller's side of a session (see the module docstring).
    An ``idle`` session runs no program; its end leaves the grid's
    ``reports`` as they were."""

    def __init__(self, grid: ProcessGrid, prog, hook, report,
                 idle: bool = False):
        self.grid = grid
        self.rank = RankSession(grid.ctx, prog)
        self._hook, self._report = hook, report
        self.idle = idle
        self._next = 1
        self._cmd = torch.zeros(5, dtype=torch.int64)
        self.open = True

    def command(self, op: int, t: int = 0, src: int = 0, what: int = 0,
                payload=None):
        """Broadcast one command and execute rank 0's part of it; returns
        ``(sid, rank 0's result)``.  ``payload``: the tensors of a DATA or
        CALL command (see :func:`_exchange`)."""
        with self.grid.lock:
            if not self.open:
                raise GridError("this session of the process grid has "
                                "ended (a later program opened another)")
            if not self.rank.holds(src):
                raise ValueError(
                    f"the process grid no longer holds state {src}: its "
                    f"ranks keep the initial state and the last "
                    f"{RankSession.KEEP} they made, so a mesh program "
                    "steps forward from those")
            dst = 0
            if op == OP_STEP:
                dst, self._next = self._next, self._next + 1
            try:
                self._cmd.copy_(torch.tensor([op, t, src, dst, what]))
                dist.broadcast(self._cmd, src=0)
                return dst, self.rank.execute(op, t, src, dst, what,
                                              payload)
            except BaseException as e:
                self.open = False
                self.grid.fail(e)

    def _payload(self, leaves, **head):
        """Rank 0's side of :func:`_exchange`: every rank's cell of each
        ``(tensor, spec)`` leaf, on the host."""
        from ..core.engines import cell_of
        cells = []
        for value, spec in leaves:
            host = value.detach().to("cpu")
            cells.append([cell_of(host, spec, *divmod(r, self.grid.Q))
                          .contiguous() for r in range(self.grid.world)])
        head["cells"] = [(tuple(c[0].shape), c[0].dtype) for c in cells]
        return head, cells

    def put(self, leaf: int, value, spec):
        """DATA: leaf ``leaf`` of the program's data tuple becomes each
        rank's cell of ``value`` (a global tensor leading with the grid
        axes ``spec``)."""
        self.command(OP_DATA, what=int(leaf),
                     payload=self._payload([(value, spec)]))

    def call(self, fn: str, leaves=(), **kw):
        """CALL (see :meth:`ProcessGrid.call`); rank 0's result."""
        return self.command(OP_CALL,
                            payload=self._payload(leaves, fn=fn, kw=kw))[1]

    def close(self):
        """End the session: STOP, collect every worker's launches (into
        the grid's ``worker_launches``) and hook report."""
        with self.grid.lock:
            if not self.open:
                return
            self.open = False
            self.grid._session = None
            try:
                self._cmd.copy_(torch.tensor([OP_STOP, 0, 0, 0, 0]))
                dist.broadcast(self._cmd, src=0)
                self.rank.finish()
                done = self.grid._await({r: "done"
                                         for r in range(1, self.grid.world)})
                self._hook.__exit__(None, None, None)
            except BaseException as e:
                self.grid.fail(e)
            reports = {0: self._report}
            for r, res in done.items():
                self.grid.worker_launches = add_counts(
                    self.grid.worker_launches, res["counts"])
                reports[r] = res["report"]
            if not self.idle:
                self.grid.reports = reports


# ---------------------------------------------------------------------------
# the memo
# ---------------------------------------------------------------------------

_GRIDS: Dict[tuple, ProcessGrid] = {}


def _key(P, Q, device):
    return (int(P), int(Q), str(device))


def process_grid(P: int, Q: int, *, device="cuda",
                 timeout: float = DEFAULT_TIMEOUT_S) -> ProcessGrid:
    """The P x Q process grid on ``device`` (``"cuda"``: every card of the
    machine, round robin; ``"cpu"``: P*Q CPU processes), started at first
    use and reused after.  A live grid of another shape or device is
    closed first (one default process group per process).  ``timeout``
    applies when the grid is started."""
    device = resolve_device(device)
    key = _key(P, Q, device)
    grid = _GRIDS.get(key)
    if grid is not None and not grid.closed:
        return grid
    close_grids()
    grid = ProcessGrid(P, Q, device=device, timeout=timeout)
    _GRIDS[key] = grid
    return grid


def grid_for(mesh, P, Q, *, device, engine: str) -> ProcessGrid:
    """The process grid a mesh engine runs on: ``mesh`` (checked against
    P, Q and the device type) or, without one, the memoized P x Q grid on
    ``device``."""
    if mesh is None:
        if P is None or Q is None:
            raise ValueError(f"engine={engine!r} needs a mesh or P and Q")
        return process_grid(P, Q, device=device)
    if not isinstance(mesh, ProcessGrid):
        raise TypeError(f"mesh={mesh!r}: the mesh engines take a "
                        "repro_torch.launch.mesh.ProcessGrid")
    if (P is not None and P != mesh.P) or (Q is not None and Q != mesh.Q):
        raise ValueError(f"mesh is {mesh.P}x{mesh.Q} but P={P}, Q={Q} "
                         "requested")
    if mesh.device.type != torch.device(device).type:
        raise ValueError(f"mesh runs on {mesh.device}, not on {device}")
    return mesh


def close_grids():
    """Close every live process grid of this process."""
    for grid in list(_GRIDS.values()):
        grid.close()
    _GRIDS.clear()


atexit.register(close_grids)


# ---------------------------------------------------------------------------
# named meshes (the reference's make_mesh / make_production_mesh)
# ---------------------------------------------------------------------------

#: the axes a named mesh may have, in the only order the rules read them
MESH_AXES = ("pod", "data", "model")


class Mesh:
    """A named device mesh: axis names and sizes, the counterpart of
    ``jax.make_mesh``'s result as the sharding rules read it (``shape``,
    ``axis_names``, ``size``).  It *describes* a layout; it starts no
    process.  :meth:`grid` launches the ranks a step runs on -- a
    :class:`ProcessGrid` of ``B x M`` ranks, B the product of the batch
    axes ("pod", "data") and M the "model" size, rank ``r = b * M + m``
    (b = pod * data_size + data): the "model" groups are the grid's rows,
    the "data" groups its columns, a "pod" axis the grid's cross-pod
    groups.  ``launchable=False`` (the production meshes) makes
    :meth:`grid` raise."""

    def __init__(self, shape, axes, *, device="cuda",
                 launchable: bool = True):
        shape, axes = tuple(int(s) for s in shape), tuple(axes)
        if len(shape) != len(axes) or len(set(axes)) != len(axes):
            raise ValueError(f"mesh shape {shape} and axes {axes} do not "
                             "match")
        bad = [a for a in axes if a not in MESH_AXES]
        if bad or list(axes) != sorted(axes, key=MESH_AXES.index):
            raise ValueError(f"mesh axes {axes}: a mesh has axes among "
                             f"{MESH_AXES}, in that order")
        if any(s < 1 for s in shape):
            raise ValueError(f"mesh shape {shape} has an empty axis")
        self.shape = dict(zip(axes, shape))
        self.axis_names = axes
        self.device = torch.device(device)
        self.launchable = launchable

    @property
    def size(self) -> int:
        return int(math.prod(self.shape.values()))

    @property
    def batch_size(self) -> int:
        """B: the ranks along the batch axes ("pod" x "data")."""
        return self.shape.get("pod", 1) * self.shape.get("data", 1)

    @property
    def model_size(self) -> int:
        return self.shape.get("model", 1)

    def coords(self, rank: int) -> Dict[str, int]:
        """Rank ``rank``'s index along every axis."""
        b, m = divmod(int(rank), self.model_size)
        data = self.shape.get("data", 1)
        out = {"pod": b // data, "data": b % data, "model": m}
        return {a: out[a] for a in self.axis_names}

    def grid(self) -> "ProcessGrid":
        """The process grid of this mesh (started at first use, memoized
        as :func:`process_grid` memoizes)."""
        if not self.launchable:
            raise RuntimeError(
                f"{self!r} describes a layout of {self.size} devices "
                "(spec trees, the dry run); it does not launch")
        return process_grid(self.batch_size, self.model_size,
                            device=resolve_device(self.device))

    def __eq__(self, other):
        return (isinstance(other, Mesh) and self.shape == other.shape
                and self.axis_names == other.axis_names
                and self.device == other.device)

    def __hash__(self):
        return hash((tuple(self.shape.items()), str(self.device)))

    def __repr__(self):
        return f"Mesh({self.shape}, device={self.device})"


def make_mesh(shape, axes, *, device="cuda") -> Mesh:
    """A mesh of ``shape`` over ``axes`` (``("data", "model")`` or
    ``("pod", "data", "model")``, or a prefix of those) whose ranks run on
    ``device`` when a step launches it."""
    return Mesh(shape, axes, device=device)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """16x16 single pod (256 chips) or 2x16x16 two pods (512 chips): a
    description for spec trees; launching it raises."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(shape, axes, launchable=False)


def mesh_context(mesh):
    """The reference's ``jax.set_mesh(mesh)`` context: the port's steps
    read their mesh from the model, so the context only yields it."""
    return contextlib.nullcontext(mesh)


class RankMesh:
    """One rank's view of a :class:`Mesh` on its :class:`ProcessGrid`:
    the mesh's ``shape`` / ``axis_names`` (so the rules read it as the
    mesh), the rank's ``coords``, its device, and the process group of
    any set of axes (:meth:`group`)."""

    def __init__(self, mesh: Mesh, ctx: RankContext):
        if (ctx.P, ctx.Q) != (mesh.batch_size, mesh.model_size):
            raise ValueError(f"{mesh!r} does not run on a {ctx.P}x{ctx.Q} "
                             "grid")
        self.mesh, self.ctx = mesh, ctx
        self.shape, self.axis_names = mesh.shape, mesh.axis_names
        self.size = mesh.size
        self.rank = ctx.rank
        self.coords = mesh.coords(ctx.rank)
        self.device = ctx.device

    def group(self, axes):
        """The process group of the ranks that differ from this one only
        along ``axes`` (None for no axis of extent > 1)."""
        axes = tuple(a for a in axes if self.shape.get(a, 1) > 1)
        if not axes:
            return None
        if axes == ("model",):
            return self.ctx.group("model")
        if "model" in axes:
            raise ValueError(f"no process group spans {axes}")
        if "pod" not in self.shape or set(axes) == {"pod", "data"} or (
                axes == ("pod",) and self.shape.get("data", 1) == 1) or (
                axes == ("data",) and self.shape["pod"] == 1):
            return self.ctx.group("data")
        G = self.shape["pod"]
        return (self.ctx.cross_group(G) if axes == ("pod",)
                else self.ctx.pod_group(G))

    def group_size(self, axes) -> int:
        return int(math.prod(self.shape.get(a, 1) for a in axes))

    def world(self):
        """The process group of every rank."""
        return dist.group.WORLD

    def index(self, axes) -> int:
        """This rank's place among the ranks of :meth:`group` (``axes``
        major first)."""
        i = 0
        for a in axes:
            i = i * self.shape.get(a, 1) + self.coords.get(a, 0)
        return i

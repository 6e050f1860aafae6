"""The bounded-staleness executors at executor level, no processes: the
port's ``StaleComm`` / ``OverlapComm`` on a 1 x 1 grid against the
reference's, which run under its ``mesh_program`` on a 1 x 1 mesh (the
reduction is the identity there, which isolates the delay).  Outputs are
bitwise equal at every step for tau in {0, 1, 2, 3}; the warm-up pin, the
refusal of a negative tau and the additive wire accounting are the
reference's (``tests/test_comm.py``).  Also the overlap-aware phase split
against the reference's."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.obs as J
import repro_torch.obs as T
from repro.core.comm import CommSchedule as JCommSchedule
from repro.core.engines import CellProgram as JCellProgram
from repro.core.engines import mesh_program as j_mesh_program
from repro_torch.core.comm import (CommSchedule, GridWire, OverlapComm,
                                   Ready, StaleComm, SyncComm)

STEPS = 9
SIZES = {"data": 1, "model": 1}


def _payloads(width=4, seed=0):
    """One payload per step, float32 (STEPS, width)."""
    return np.random.default_rng(seed).normal(size=(STEPS, width)) \
        .astype(np.float32)


def _reference_seen(tau, overlap=False, axis="data", op="psum"):
    """What the reference's mesh executor hands back at each step."""
    sched = getattr(JCommSchedule(), op)("probe", axis=axis)

    def cell(comm, t, data, state):
        return comm("probe", jax.lax.dynamic_index_in_dim(
            data, t - 1, 0, keepdims=False))
    prog = JCellProgram(sched, cell, data_specs=(None,), state_specs=(None,))
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    data = jnp.asarray(_payloads())
    state0 = jnp.zeros((4,))
    step, comm0, acct = j_mesh_program(prog, mesh, data, state0,
                                       staleness=tau, overlap=overlap)
    state, seen = (state0, comm0), []
    for t in range(1, STEPS + 1):
        state = step(t, data, state)
        seen.append(np.asarray(state[0]))
    return seen, acct


def _port_seen(tau, overlap=False, axis="data", op="psum"):
    """The port's executor on a 1 x 1 grid, one instance per step, its
    ring carried from step to step as the engine carries it."""
    sched = getattr(CommSchedule(), op)("probe", axis=axis)
    cls = OverlapComm if overlap else StaleComm
    zero = torch.zeros((1, 4))
    ring = {"probe": ((Ready(zero),) if overlap else (zero,)) * tau}
    seen, wire = [], []
    for t, row in enumerate(_payloads(), start=1):
        comm = cls(sched, SIZES, tau=tau, t=t, bufs=ring, device="cpu")
        out = comm("probe", torch.from_numpy(row).reshape(1, 1, 4))
        comm.finalize()
        ring = comm.bufs_out if tau else ring
        seen.append(out.reshape(4).numpy())
        wire.append(comm.wire_bytes["probe"])
    return seen, wire


@pytest.mark.parametrize("tau", [0, 1, 2, 3])
@pytest.mark.parametrize("overlap", [False, True])
def test_stale_and_overlap_executors_bitwise_the_reference(tau, overlap):
    want, acct = _reference_seen(tau, overlap)
    got, wire = _port_seen(tau, overlap)
    for t, (g, w) in enumerate(zip(got, want), start=1):
        assert g.tobytes() == w.tobytes(), (tau, overlap, t)
    # the consumption contract itself: step t applies step max(1, t-tau)'s
    rows = _payloads()
    for t, g in enumerate(got, start=1):
        assert g.tobytes() == rows[max(1, t - tau) - 1].tobytes()
    assert wire == [acct["collectives"]["probe"]["payload_bytes_per_cell"]
                    ] * STEPS


@pytest.mark.parametrize("op,axis", [("pmean", "model"), ("psum", "model"),
                                     ("pmean", "data")])
def test_stale_executor_on_other_points(op, axis):
    want, _ = _reference_seen(2, op=op, axis=axis)
    got, _ = _port_seen(2, op=op, axis=axis)
    assert [g.tobytes() for g in got] == [w.tobytes() for w in want]


def test_warmup_pins_the_first_reduction():
    """Steps 1..tau+1 consume step 1's value, never the ring's zeros or a
    partly filled ring; tau+2 consumes step 2's."""
    tau = 3
    rows = _payloads()
    for overlap in (False, True):
        got, _ = _port_seen(tau, overlap)
        assert all(g.tobytes() == rows[0].tobytes()
                   for g in got[:tau + 1])
        assert got[tau + 1].tobytes() == rows[1].tobytes()


def test_negative_tau_is_refused_as_the_reference():
    with pytest.raises(ValueError, match="must be >= 0"):
        StaleComm(CommSchedule(), SIZES, tau=-1, t=1, device="cpu")
    with pytest.raises(ValueError, match="must be >= 0"):
        OverlapComm(CommSchedule(), SIZES, tau=-1, t=1, device="cpu")


def test_a_missing_ring_is_a_keyerror():
    sched = CommSchedule().psum("probe", axis="data")
    comm = StaleComm(sched, SIZES, tau=2, t=3, bufs={}, device="cpu")
    with pytest.raises(KeyError, match="no staleness buffer"):
        comm("probe", torch.ones(1, 1, 4))


def test_overlap_comm_class_contract():
    kw = dict(tau=2, t=1, device="cpu")
    oc = OverlapComm(CommSchedule(), SIZES, **kw)
    assert oc.overlap and isinstance(oc, StaleComm)
    assert not getattr(StaleComm(CommSchedule(), SIZES, **kw), "overlap",
                       False)


def test_wire_bytes_additive_across_executors():
    """sync, stale and overlap put the same bytes on the wire a step (the
    reference's accounting of the same probe agrees)."""
    per = {}
    for label, kw in (("sync", dict(tau=0)), ("stale", dict(tau=2)),
                      ("overlap", dict(tau=2, overlap=True))):
        per[label] = _port_seen(**kw)[1]
        _, acct = _reference_seen(kw["tau"], kw.get("overlap", False))
        assert acct["bytes_per_step"] == acct["uncompressed_bytes_per_step"]
        assert per[label][0] == acct["bytes_per_step"]
    assert per["sync"] == per["stale"] == per["overlap"]


def test_stale_ring_on_a_blocked_grid_payload():
    """On the grid wire with P x Q > 1 the ring holds the blocked
    reduction, and tau = 0 is SyncComm's result bitwise."""
    sched = CommSchedule().psum("w", axis="data").pmean("a", axis="model")
    sizes = {"data": 3, "model": 2}
    rng = np.random.default_rng(1)
    vals = [torch.from_numpy(rng.normal(size=(3, 2, 5)).astype(np.float32))
            for _ in range(5)]
    ring = {"w": (torch.zeros(2, 5),) * 2, "a": (torch.zeros(3, 5),) * 2}
    for t, v in enumerate(vals, start=1):
        sync = SyncComm(sched, sizes, device="cpu")
        stale = StaleComm(sched, sizes, tau=2, t=t, bufs=ring, device="cpu")
        zero = StaleComm(sched, sizes, tau=0, t=t, device="cpu")
        assert torch.equal(zero("w", v), sync("w", v))
        out = stale("w", v), stale("a", v)
        stale.finalize()
        ring = stale.bufs_out
        src = vals[max(1, t - 2) - 1]
        assert torch.equal(out[0], src.sum(0))
        assert torch.equal(out[1], src.mean(1))
    assert GridWire(sizes).lead == (3, 2)


@pytest.mark.parametrize("tau,local_frac", [(0, 0.5), (1, 0.8), (2, 0.25),
                                            (3, 0.0)])
def test_overlap_phase_split_as_the_reference(tau, local_frac):
    kw = dict(local_frac=local_frac, comm_shares={"dalpha": 0.25,
                                                  "w_contrib": 0.75},
              step_s=1.0, local_s=local_frac, staleness=tau, overlap=True)
    for step_s in (2e-3, 1.5):
        assert T.PhaseSplit(**kw).attribute(step_s) == \
            J.PhaseSplit(**kw).attribute(step_s)

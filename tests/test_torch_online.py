"""The online slice of the port vs the reference (CPU): the admission
queue and the grid store on one insert sequence, the gated D3CA program
(dense and padded-ELL) and successive ``Solver.update`` calls, the whole
service over a stream, the scorer -- each with the reference's
``jax.random`` coordinate orders injected -- and the contracts of
``docs/consistency.md`` 7-9 inside the port: the all-ones gate is the
ungated program bit for bit, untouched duals stay frozen exactly,
primal-only solvers refuse a gate, publish and scorer swap are atomic
under concurrent threads, overload is shed, a restart recovers."""
import json
import threading

import numpy as np
import pytest
import torch

from repro.core import D3CAConfig as JD3CA
from repro.core import get_solver as j_get_solver
from repro.data import csr_from_dense as j_csr_from_dense
from repro.online import AdmissionQueue as JQueue
from repro.online import GridStore as JStore
from repro.online import OnlineConfig as JOnlineConfig
from repro.online import OnlineSolverService as JService
from repro.serve.scoring import LinearScorer as JScorer
from repro_torch.checkpoint import CheckpointManager
from repro_torch.core import D3CAConfig, get_loss, get_solver
from repro_torch.data import csr_from_dense
from repro_torch.launch import online as online_cli
from repro_torch.obs import (HealthMonitor, Registry, Tracer, load_bundle,
                             solver_rules)
from repro_torch.online import (AdmissionQueue, GridStore, OnlineConfig,
                                OnlineSolverService, QueueFullError,
                                SnapshotBook)
from repro_torch.launch.mesh import close_grids, process_grid
from repro_torch.serve import LinearScorer
from test_torch_common import (MESH_GRID_TIMEOUT, bounded,  # noqa: F401
                               d3ca_source)

LAM = 1e-2
TOL = dict(rtol=1e-5, atol=1e-5)


def _stream(rng, b, m):
    X = rng.normal(size=(b, m)).astype(np.float32)
    y = np.where(X @ np.linspace(-1.0, 1.0, m) >= 0, 1.0,
                 -1.0).astype(np.float32)
    return X, y


def _np(t):
    return None if t is None else np.asarray(
        t.cpu() if isinstance(t, torch.Tensor) else t)


# ---------------------------------------------------------------------------
# queue and store: the same semantics as the reference's
# ---------------------------------------------------------------------------

def test_queue_matches_reference_on_one_sequence():
    rng = np.random.default_rng(0)
    q, jq = AdmissionQueue(capacity=20), JQueue(capacity=20)
    events = []
    for b in (4, 6, 3, 9, 2, 1, 5):
        X, y = _stream(rng, b, 3)
        got = []
        for queue in (q, jq):
            try:
                got.append(queue.submit(X, y))
            except Exception as e:       # the two must raise alike
                got.append(type(e).__name__)
        assert got[0] == got[1]
        events.append(got[0])
    assert "QueueFullError" in events
    for max_rows in (5, None):
        a, b = q.drain(max_rows), jq.drain(max_rows)
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])
        assert a[2] == b[2]
    assert q.drain() is None and jq.drain() is None
    assert (q.admitted, q.rejected, q.seq, q.pending_rows) == (
        jq.admitted, jq.rejected, jq.seq, jq.pending_rows)
    with pytest.raises(ValueError):
        q.submit(np.zeros((4, 3)), np.zeros((5,)))


def test_store_matches_reference_across_a_wrap_and_a_giant_batch():
    rng = np.random.default_rng(1)
    st = GridStore(m=5, capacity=22, P=3, Q=2, device="cpu")
    jst = JStore(m=5, capacity=22, P=3, Q=2)
    assert (st.capacity, st.n_p) == (jst.capacity, jst.n_p) == (24, 8)
    for b in (7, 9, 6, 5, 50, 3):        # wraps at 24; 50 keeps its tail
        X, y = _stream(rng, b, 5)
        touched, j_touched = st.insert(X, y), jst.insert(X, y)
        np.testing.assert_array_equal(touched, j_touched)
        assert np.all(np.diff(touched) > 0)
        np.testing.assert_array_equal(st.touched_partitions(touched),
                                      jst.touched_partitions(j_touched))
        np.testing.assert_array_equal(_np(st.X), jst.X)
        np.testing.assert_array_equal(_np(st.y), jst.y)
        np.testing.assert_array_equal(_np(st.filled_mask), jst.filled_mask)
        assert (st.filled, st.written) == (jst.filled, jst.written)
    with pytest.raises(ValueError):
        st.insert(np.zeros((2, 4)), np.zeros(2))


# ---------------------------------------------------------------------------
# the gated program and Solver.update against the reference
# ---------------------------------------------------------------------------

def _x(X, block_format, pkg):
    if block_format == "dense":
        return X
    return (csr_from_dense if pkg == "port" else j_csr_from_dense)(X)


def _sparse_problem(n, m, seed):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, m)).astype(np.float32)
    X[rng.random((n, m)) < 0.6] = 0.0
    y = np.where(X @ rng.normal(size=m) >= 0, 1.0, -1.0).astype(np.float32)
    return X, y


@pytest.mark.parametrize("block_format", ["dense", "sparse"])
@pytest.mark.parametrize("loss", ["hinge", "squared"])
def test_gated_solve_matches_reference(block_format, loss):
    n, m, grid = 60, 24, (3, 2)
    X, y = _sparse_problem(n, m, seed=2)
    gate = (np.random.default_rng(3).random(n) < 0.4).astype(np.float32)
    kw = dict(lam=0.05, outer_iters=3, local_steps=12, seed=5)
    ref = j_get_solver("d3ca")(block_format=block_format).solve(
        loss, _x(X, block_format, "ref"), y, P=3, Q=2, cfg=JD3CA(**kw),
        row_gate=gate, record_history=False)
    got = get_solver("d3ca")(
        block_format=block_format, device="cpu",
        index_source=d3ca_source(5, n, iters=3, steps=12, grid=grid)).solve(
        loss, _x(X, block_format, "port"), y, P=3, Q=2,
        cfg=D3CAConfig(**kw), row_gate=gate, record_history=False)
    np.testing.assert_allclose(_np(got.w), np.asarray(ref.w), **TOL)
    np.testing.assert_allclose(_np(got.alpha), np.asarray(ref.alpha), **TOL)
    off = gate == 0
    assert np.all(_np(got.alpha)[off] == 0.0)    # cold start: never moved


@pytest.mark.parametrize("block_format", ["dense", "sparse"])
def test_update_chain_matches_reference_across_a_wrap(block_format):
    """Three successive updates on a ring window -- the last one across
    the wrap, with flipped labels, so that overwritten rows are gated on
    with a stale warm-start alpha -- against the reference's."""
    m, P, Q = 16, 3, 2
    rng = np.random.default_rng(4)
    st = GridStore(m=m, capacity=36, P=P, Q=Q, device="cpu")
    jst = JStore(m=m, capacity=36, P=P, Q=Q)
    cfg = dict(lam=LAM, local_steps=8, seed=2)
    solver = get_solver("d3ca")(
        block_format=block_format, device="cpu",
        index_source=d3ca_source(2, 36, iters=2, steps=8, grid=(P, Q)))
    j_solver = j_get_solver("d3ca")(block_format=block_format)
    warm = (np.zeros(m, np.float32), np.zeros(36, np.float32))
    j_warm = warm
    for b, flip in ((20, False), (10, False), (14, True)):
        X, y = _stream(rng, b, m)
        y = -y if flip else y
        touched = st.insert(X, y)
        np.testing.assert_array_equal(touched, jst.insert(X, y))
        Xw = _np(st.X)
        res = solver.update(
            "hinge", st.X if block_format == "dense" else
            csr_from_dense(Xw), st.y, touched=touched, warm_start=warm,
            P=P, Q=Q, cfg=D3CAConfig(**cfg), passes=2, record_history=False)
        j_res = j_solver.update(
            "hinge", _x(jst.X, block_format, "ref"), jst.y, touched=touched,
            warm_start=j_warm, P=P, Q=Q, cfg=JD3CA(**cfg), passes=2,
            record_history=False)
        np.testing.assert_allclose(_np(res.w), np.asarray(j_res.w), **TOL)
        np.testing.assert_allclose(_np(res.alpha), np.asarray(j_res.alpha),
                                   **TOL)
        frozen = np.setdiff1d(np.arange(36), touched)
        np.testing.assert_array_equal(_np(res.alpha)[frozen],
                                      _np(warm[1])[frozen])
        assert res.iters == 2 and res.history == []
        warm, j_warm = (res.w, res.alpha), (j_res.w, j_res.alpha)
    assert touched[0] == 0 and touched[-1] == 35          # the wrap


def test_service_matches_reference_over_a_stream():
    """Both services on one stream of 8 rounds (the ring wraps twice):
    versions, trained_seq, lag and every published w / alpha."""
    m, P, Q, cap = 12, 3, 2, 36
    kw = dict(m=m, capacity=cap, P=P, Q=Q, passes=2)
    svc = OnlineSolverService(
        OnlineConfig(**kw, solver_cfg=D3CAConfig(lam=LAM, local_steps=8)),
        device="cpu",
        index_source=d3ca_source(0, cap, iters=2, steps=8, grid=(P, Q)))
    ref = JService(JOnlineConfig(**kw, solver_cfg=JD3CA(lam=LAM,
                                                        local_steps=8)))
    rng = np.random.default_rng(5)
    for b in (5, 8, 3, 12, 7, 9, 4, 20):
        X, y = _stream(rng, b, m)
        assert svc.submit(X, y) == ref.submit(X, y)
        assert svc.version_lag == ref.version_lag == b
        assert svc.run_pending() == ref.run_pending()
        s, r = svc.book.current(), ref.book.current()
        assert (s.version, s.trained_seq) == (r.version, r.trained_seq)
        assert svc.version_lag == ref.version_lag == 0
        np.testing.assert_allclose(_np(s.w), r.w, **TOL)
        np.testing.assert_allclose(_np(s.alpha), r.alpha, **TOL)
        assert svc.scorer.w_version == s.version
    Xs, _ = _stream(rng, 70, m)
    np.testing.assert_allclose(svc.score(Xs), ref.score(Xs), **TOL)
    a, b = svc.stats(), ref.stats()
    for k in ("version", "trained_seq", "ingested", "rejected",
              "pending_rows", "version_lag", "store_filled",
              "store_capacity", "rows_scored"):
        assert a[k] == b[k], k


@pytest.mark.parametrize("loss", ["hinge", "logistic"])
def test_scorer_matches_reference(loss):
    rng = np.random.default_rng(6)
    w = rng.normal(size=10).astype(np.float32)
    X = rng.normal(size=(150, 10)).astype(np.float32)   # not a bucket
    sc = LinearScorer(w, loss=loss, device="cpu")
    ref = JScorer(w, None, loss=loss)
    assert sc.bucket == ref.bucket == 64
    np.testing.assert_allclose(sc.score(X), ref.score(X), **TOL)
    np.testing.assert_allclose(sc.predict(X), ref.predict(X), **TOL)
    assert sc.score(X).dtype == np.float32 and sc.rows_scored == 450
    w2 = rng.normal(size=10).astype(np.float32)
    sc.update_weights(w2, version=3)
    ref.update_weights(w2, version=3)
    np.testing.assert_allclose(sc.score(X[:7]), ref.score(X[:7]), **TOL)
    assert sc.w_version == 3 and sc.rows_per_sec > 0
    with pytest.raises(ValueError):
        sc.update_weights(np.zeros(9))
    with pytest.raises(ValueError):
        sc.score(np.zeros((3, 9)))


# ---------------------------------------------------------------------------
# the contracts of docs/consistency.md 7-9, inside the port
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("block_format", ["dense", "sparse"])
def test_gate_all_ones_is_bitwise_the_ungated_solve(block_format):
    X, y = _sparse_problem(48, 12, seed=2)
    Xp = _x(X, block_format, "port")
    cfg = D3CAConfig(lam=LAM, outer_iters=3, local_steps=8)
    s = get_solver("d3ca")(block_format=block_format, device="cpu")
    plain = s.solve("hinge", Xp, y, P=2, Q=2, cfg=cfg, record_history=False)
    gated = s.solve("hinge", Xp, y, P=2, Q=2, cfg=cfg, record_history=False,
                    row_gate=np.ones(48, np.float32))
    assert torch.equal(plain.w, gated.w)
    assert torch.equal(plain.alpha, gated.alpha)


@pytest.mark.parametrize("block_format", ["dense", "sparse"])
def test_gate_freezes_untouched_duals_exactly(block_format):
    X, y = _sparse_problem(48, 12, seed=2)
    Xp = _x(X, block_format, "port")
    cfg = D3CAConfig(lam=LAM, outer_iters=2, local_steps=8)
    s = get_solver("d3ca")(block_format=block_format, device="cpu")
    base = s.solve("hinge", Xp, y, P=2, Q=2, cfg=cfg, record_history=False)
    touched = np.arange(36, 48)                   # last partition only
    res = s.update("hinge", Xp, y, touched=touched,
                   warm_start=(base.w, base.alpha), P=2, Q=2, cfg=cfg,
                   passes=2, record_history=False)
    untouched = np.setdiff1d(np.arange(48), touched)
    assert torch.equal(res.alpha[untouched], base.alpha[untouched])
    assert torch.any(res.alpha[touched] != base.alpha[touched])
    assert s.program_cache is False and len(s._prog_cache) == 1


def test_row_gate_rejected_by_primal_only_solvers():
    X, y = _sparse_problem(24, 8, seed=0)
    for name in ("radisa", "sfk", "admm"):
        with pytest.raises(ValueError, match="row-gate"):
            get_solver(name)(device="cpu").solve(
                "hinge", X, y, P=2, Q=2, row_gate=np.ones(24, np.float32))
        with pytest.raises(ValueError, match="row-gate"):
            get_solver(name)(device="cpu").update(
                "hinge", X, y, touched=[0], warm_start=np.zeros(8), P=2,
                Q=2)
    with pytest.raises(ValueError, match="warm_start"):
        get_solver("d3ca")(device="cpu").update(
            "hinge", X, y, touched=[0], warm_start=None, P=2, Q=2)
    with pytest.raises(ValueError, match="row-gate"):
        OnlineSolverService(OnlineConfig(m=4, solver="radisa"), device="cpu")


def test_snapshot_publish_is_atomic_and_never_aliases_under_readers():
    book = SnapshotBook(np.zeros(4), np.zeros(6), device="cpu")
    stop = threading.Event()
    torn = []

    def reader():
        while not stop.is_set():
            s = book.current()
            if not (bool(torch.all(s.w == s.version))
                    and s.trained_seq == s.version):
                torn.append(s.version)

    threads = [threading.Thread(target=reader) for _ in range(3)]
    for th in threads:
        th.start()
    w = torch.zeros(4)
    try:
        for v in range(1, 200):
            w.fill_(float(v))                     # the solver's buffer
            book.publish(w, torch.zeros(6), v)
    finally:
        stop.set()
        for th in threads:
            th.join(timeout=30)
    assert not any(th.is_alive() for th in threads)
    assert torn == []
    snap = book.current()
    assert snap.version == 199 and snap.w.data_ptr() != w.data_ptr()
    w.fill_(-1.0)                                 # the solver writes on
    assert bool(torch.all(snap.w == 199.0))


def test_scorer_swap_is_atomic_under_concurrent_scoring():
    m = 6
    scorer = LinearScorer(np.full(m, 1.0), device="cpu", bucket=2)
    X = np.eye(m, dtype=np.float32)               # margins == w exactly
    stop = threading.Event()
    torn = []

    def reader():
        while not stop.is_set():
            margins = scorer.score(X)
            if len(set(np.round(margins, 6))) != 1:
                torn.append(margins.copy())

    threads = [threading.Thread(target=reader) for _ in range(2)]
    for th in threads:
        th.start()
    try:
        for v in range(2, 200):
            scorer.update_weights(np.full(m, float(v)), version=v)
    finally:
        stop.set()
        for th in threads:
            th.join(timeout=30)
    assert not any(th.is_alive() for th in threads)
    assert torn == [], f"mixed-version batches: {torn[:3]}"
    assert scorer.w_version == 199


def _service(**kw):
    cfg = OnlineConfig(m=10, capacity=32, P=2, Q=2,
                       solver_cfg=D3CAConfig(lam=LAM, local_steps=8),
                       passes=2, **kw)
    return OnlineSolverService(cfg, device="cpu")


def test_service_end_to_end_improves_and_tracks_lag():
    svc = _service()
    rng = np.random.default_rng(3)
    assert svc.run_pending() is None              # nothing pending
    for _ in range(4):
        svc.submit(*_stream(rng, 8, 10))
        assert svc.version_lag > 0                # admitted, not trained
        svc.run_pending()
        assert svc.version_lag == 0
    assert svc.book.current().version == 4 and svc.drain_all() == 0
    st = svc.store
    f = get_loss("hinge").objective
    w = svc.book.current().w
    assert f(st.X, st.y, w, LAM, mask=st.filled_mask) < \
        f(st.X, st.y, torch.zeros(10), LAM, mask=st.filled_mask)
    assert svc.scorer.w_version == 4 and svc.solver.device.type == "cpu"
    Xs, ys = _stream(rng, 64, 10)
    assert np.mean(svc.predict(Xs) * ys > 0) > 0.6
    snap = svc.registry.snapshot()
    c = {k.split("{")[0]: v for k, v in snap["counters"].items()}
    assert c["online/ingested"] == 32 and c["online/updates"] == 4
    assert c["online/scored"] == 64
    g = {k.split("{")[0]: v for k, v in snap["gauges"].items()}
    assert g["online/version_lag"] == 0 and g["online/staleness_s"] >= 0
    assert np.isfinite(g["online/w_norm"]) and g["online/w_norm"] > 0
    h = {k.split("{")[0]: v for k, v in snap["histograms"].items()}
    assert h["online/update_s"]["count"] == 4
    assert h["online/swap_s"]["count"] == 4


def test_service_sheds_load_and_counts_rejections():
    svc = _service(queue_capacity=8)
    rng = np.random.default_rng(4)
    svc.submit(*_stream(rng, 8, 10))
    with pytest.raises(QueueFullError):
        svc.submit(*_stream(rng, 4, 10))
    assert svc.stats()["rejected"] == 4
    c = {k.split("{")[0]: v
         for k, v in svc.registry.snapshot()["counters"].items()}
    assert c["online/rejected"] == 4


def test_service_recover_after_restart(tmp_path):
    rng = np.random.default_rng(5)
    cfg = OnlineConfig(m=10, capacity=32, P=2, Q=2,
                       solver_cfg=D3CAConfig(lam=LAM, local_steps=8))
    svc = OnlineSolverService(cfg, manager=CheckpointManager(str(tmp_path)),
                              device="cpu")
    assert svc.recover() is None
    svc.submit(*_stream(rng, 8, 10))
    svc.run_pending()
    svc.book.flush()
    w = svc.book.current().w.clone()
    svc2 = OnlineSolverService(cfg, manager=CheckpointManager(str(tmp_path)),
                               device="cpu")
    assert svc2.recover() == 1
    assert torch.equal(svc2.book.current().w, w)
    assert svc2.book.current().trained_seq == 8
    assert svc2.scorer.w_version == 1
    # the recovered alpha warm-starts the next update
    svc2.submit(*_stream(rng, 8, 10))
    assert svc2.run_pending() == 2


#: the expectation of a refusal case whose knob is now ported: it runs
PORTED = object()
#: the same, for a knob or flag of the mesh engines: it runs on a CPU
#: process grid
MESH_PORTED = object()


@pytest.mark.usefixtures("bounded")
@pytest.mark.parametrize("kw,named", [
    # the mesh knobs, once refused, run on a CPU process grid
    pytest.param(dict(mesh=True), MESH_PORTED, id="kw0-mesh"),
    # the tracer and the monitor, once refused, run
    pytest.param(dict(tracer=True), PORTED, id="kw1-tracer"),
    pytest.param(dict(monitor=True), PORTED, id="kw2-monitor"),
    pytest.param(dict(engine="shard_map"), MESH_PORTED,
                 id="kw3-engine='shard_map'"),
    # staleness and the comm policies are threaded to the solver on the
    # mesh engines too
    pytest.param(dict(staleness=2, engine="async"), MESH_PORTED,
                 id="kw4-staleness=2"),
    pytest.param(dict(compression="int8", engine="shard_map"), MESH_PORTED,
                 id="kw5-compression='int8'"),
    pytest.param(dict(topology="pods=2", engine="overlap"), MESH_PORTED,
                 id="kw6-topology='pods=2'")])
def test_service_refuses_unported_knobs_by_name(kw, named):
    """A knob whose layer is now ported runs: the tracer and the monitor
    (``PORTED``) and the mesh knobs (``MESH_PORTED``)."""
    if named is PORTED:
        return _check_tracer_or_monitor(next(iter(kw)))
    return _check_mesh_knob(kw)


def _check_mesh_knob(kw):
    """The service under a mesh knob runs three rounds on the 2 x 2 CPU
    process grid (``mesh=True``: a grid handed in, so that the scorer
    runs on it too; otherwise the memoized grid of the updates), held
    against the same service on the grid engine: every published w within
    1e-5 (gloo's reductions against a blocked sum; under int8 within two
    int8 quanta of the largest entry).  Under async tau = 2 one pass an
    update applies the first step's own reductions, so the grid engine's
    synchronous service is its counterpart."""
    kw = dict(kw)
    svc_kw = {}
    if kw.pop("mesh", False):
        svc_kw["mesh"] = process_grid(2, 2, device="cpu",
                                      timeout=MESH_GRID_TIMEOUT)
        kw["engine"] = "shard_map"
    flat_kw = {k: v for k, v in kw.items()
               if k not in ("engine", "staleness")}
    runs = []
    for cfg_kw, extra in ((flat_kw, {}), (kw, svc_kw)):
        cfg = OnlineConfig(m=8, capacity=24, P=2, Q=2,
                           solver_cfg=D3CAConfig(lam=0.1), **cfg_kw)
        svc = OnlineSolverService(cfg, device="cpu", **extra)
        rng = np.random.default_rng(0)
        ws, margins = [], []
        for _ in range(3):
            svc.submit(*_stream(rng, 6, 8))
            svc.run_pending()
            ws.append(svc.book.current().w)
            margins.append(svc.score(_stream(rng, 4, 8)[0]))
        runs.append((ws, margins, svc))
    (flat_w, flat_m, _), (mesh_w, mesh_m, svc) = runs
    assert svc.solver.engine == kw["engine"]
    assert (svc.scorer.mesh is not None) == ("mesh" in svc_kw)
    big = max(float(w.abs().max()) for w in flat_w)
    atol = 2 * big / 127 if "compression" in kw else 1e-5
    for a, b in zip(mesh_w, flat_w):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=atol)
    np.testing.assert_allclose(np.concatenate(mesh_m),
                               np.concatenate(flat_m), rtol=1e-5,
                               atol=10 * atol)


def _check_tracer_or_monitor(knob):
    """The service runs under a tracer (spans of every phase) or a health
    monitor (polled as the reference polls it), with the plain service's
    snapshots."""
    cfg = OnlineConfig(m=8, capacity=24, P=2, Q=2,
                       solver_cfg=D3CAConfig(lam=0.1))
    hook = (Tracer() if knob == "tracer" else
            HealthMonitor(Registry(), [], min_interval_s=0.0))
    kw = {knob: hook}
    if knob == "monitor":
        kw["registry"] = hook.registry
    runs = []
    for extra in ({}, kw):
        svc = OnlineSolverService(cfg, device="cpu", **extra)
        rng = np.random.default_rng(0)
        for _ in range(3):
            svc.submit(*_stream(rng, 6, 8))
            svc.run_pending()
            svc.score(_stream(rng, 4, 8)[0])
        runs.append(svc.book.current().w)
    assert torch.equal(runs[0], runs[1])
    if knob == "tracer":
        names = [e["name"] for e in hook.events if e["depth"] == 0]
        assert names == ["online/ingest", "online/update", "online/swap",
                         "online/score"] * 3
        assert len(hook.spans("solve")) == 3
    else:
        # one poll after every ingest, publish and scoring call
        assert hook.evaluations == 9


def test_update_refuses_observability_knobs_by_name():
    """``Solver.update(tracer=, registry=, monitor=)``, once refused by
    name, now runs: the timed path (spans and metrics) with bitwise the
    untimed update's iterates."""
    X, y = _sparse_problem(24, 8, seed=0)
    s = get_solver("d3ca")(device="cpu")
    kw = dict(touched=[0, 5, 13], warm_start=np.zeros(8), P=2, Q=2,
              cfg=D3CAConfig(lam=0.1), passes=2)
    plain = s.update("hinge", X, y, **kw)
    tr, reg = Tracer(), Registry()
    mon = HealthMonitor(reg, solver_rules(), min_interval_s=0.0)
    got = s.update("hinge", X, y, tracer=tr, registry=reg, monitor=mon, **kw)
    assert torch.equal(plain.w, got.w) and torch.equal(plain.alpha,
                                                       got.alpha)
    assert len(tr.spans("outer_iter")) == 2 and len(tr.spans("calibrate")) \
        == 1
    assert reg.snapshot()["histograms"][
        "solver/step_s{engine=simulated,solver=d3ca}"]["count"] == 2
    assert mon.evaluations == 2


def test_the_online_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the rule under test is "
                    "what happens without one")
    for make in (lambda: GridStore(4, 8, 2, 2),
                 lambda: SnapshotBook(np.zeros(3)),
                 lambda: LinearScorer(np.zeros(3)),
                 lambda: OnlineSolverService(OnlineConfig(m=4))):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
    with pytest.raises(RuntimeError, match="--device cpu"):
        online_cli.main(["--rounds", "1"])


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

SMALL = ["--m", "16", "--capacity", "40", "--mesh", "2x2", "--batch", "12",
         "--score-batch", "32", "--device", "cpu"]


def test_online_cli_on_the_cpu_persists_and_recovers(tmp_path, capsys):
    ck = str(tmp_path / "ck")
    rounds = []
    starts = []
    summary = online_cli.run(
        online_cli.parse_args([*SMALL, "--rounds", "5", "--ckpt-dir", ck,
                               "--json-out", str(tmp_path / "s.json")]),
        on_start=lambda svc: starts.append(svc.book.current().version),
        on_round=lambda r, svc, rec: rounds.append((r, rec)))
    assert starts == [0] and [r for r, _ in rounds] == list(range(5))
    assert summary["version"] == 5 and summary["trained_seq"] == 60
    assert summary["store_filled"] == 40 and summary["device"] == "cpu"
    assert summary["version_lag"] == 0 and summary["backend"] == "kernel"
    assert np.isfinite(summary["objective"])
    assert summary["objective"] == rounds[-1][1]["f"]
    assert json.loads((tmp_path / "s.json").read_text()) == summary
    out = capsys.readouterr().out
    assert out.count("round=") == 5 and "device=cpu" in out
    w5 = []
    again = online_cli.run(
        online_cli.parse_args([*SMALL, "--rounds", "1", "--ckpt-dir", ck]),
        on_start=lambda svc: w5.append(svc.book.current()))
    assert w5[0].version == 5 and again["version"] == 6
    assert "recovered snapshot version 5" in capsys.readouterr().out
    assert CheckpointManager(ck).all_steps() == [4, 5, 6]


@pytest.fixture(scope="module", autouse=True)
def _close_grids():
    """The mesh cases start the memoized 2 x 2 CPU grid; end it with the
    module."""
    yield
    close_grids()


@pytest.mark.usefixtures("bounded")
@pytest.mark.parametrize("flags,named", [
    pytest.param(["--engine", "shard_map"], MESH_PORTED,
                 id="flags0-'Multi-device engines'"),
    pytest.param(["--force-host-devices", "4"], MESH_PORTED,
                 id="flags1-'Multi-device engines'"),
    pytest.param(["--staleness", "2"],
                 "--staleness 2 only works with --engine async",
                 id="flags2-'Comm policies"),
    pytest.param(["--compression", "int8", "--engine", "async"],
                 MESH_PORTED, id="flags3-'Comm policies"),
    pytest.param(["--topology", "pods=2", "--engine", "shard_map"],
                 MESH_PORTED, id="flags4-'Comm policies"),
    # the observability flags, once refused, run
    pytest.param(["--trace", "TRACE"], PORTED, id="flags5-'Observability'"),
    pytest.param(["--metrics"], PORTED, id="flags6-'Observability'"),
    pytest.param(["--health"], PORTED, id="flags7-'Observability'"),
    pytest.param(["--health", "--max-lag", "5"], PORTED,
                 id="flags8-'Observability'"),
    pytest.param(["--listen", "127.0.0.1:0"], PORTED,
                 id="flags9-'Observability'"),
    pytest.param(["--flight-recorder", "BUNDLE"], PORTED,
                 id="flags10-'Observability'"),
    (["--solver", "nope"], "unknown solver"),
])
def test_online_cli_refuses_unported_flags_by_name(flags, named, capsys,
                                                   tmp_path):
    """A flag of a layer that is not ported exits 2 naming it; a flag
    whose layer is now ported (``PORTED``) runs, and its case checks what
    it made."""
    if named is PORTED:
        return _check_observability_flag(flags, tmp_path, capsys)
    if named is MESH_PORTED:
        return _check_mesh_flag(flags)
    with pytest.raises(SystemExit) as exc:
        online_cli.main([*flags, *SMALL])
    assert exc.value.code == 2
    assert named in capsys.readouterr().err


def _check_mesh_flag(flags):
    """A flag of the reference's online CLI for the mesh runs the stream:
    ``--engine E`` (with the knobs beside it) every update on the 2 x 2
    process grid and the scorer on it, against the same flags on the grid
    engine -- the objective within 1e-5 (relative; gloo's reductions
    against a blocked sum), and under int8 within 1e-3 (a payload a
    rounding away from a quantum's edge may round the other way);
    ``--force-host-devices 4`` with the grid engine, the same run
    bitwise."""
    plain_flags = [f for i, f in enumerate(flags)
                   if f != "--engine" and (i == 0 or flags[i - 1]
                                           != "--engine")]
    plain = online_cli.main([*plain_flags, *SMALL, "--rounds", "3"])
    got = online_cli.main([*flags, *SMALL, "--rounds", "3"])
    assert got["version"] == plain["version"] == 3
    if "--engine" not in flags:
        assert got["engine"] == "simulated"
        assert got["objective"] == plain["objective"]
        return
    assert got["engine"] == flags[flags.index("--engine") + 1]
    rtol = 1e-3 if "int8" in flags else 1e-5
    np.testing.assert_allclose(got["objective"], plain["objective"],
                               rtol=rtol)
    assert got["rows_scored"] == plain["rows_scored"] == 3 * 32


def _check_observability_flag(flags, tmp_path, capsys):
    """An observability flag of the reference's online CLI runs the
    stream under it and reports what it made, with the snapshots of the
    plain run."""
    key = "--max-lag" if "--max-lag" in flags else flags[0]
    flags = [str(tmp_path / "t.json") if f == "TRACE" else
             str(tmp_path / "b.json") if f == "BUNDLE" else f for f in flags]
    plain = online_cli.main([*SMALL, "--rounds", "3"])
    got = online_cli.main([*flags, *SMALL, "--rounds", "3"])
    assert got["objective"] == plain["objective"]
    if key == "--trace":
        events = json.loads((tmp_path / "t.json").read_text())["traceEvents"]
        tops = [e["name"] for e in events if e["name"].startswith("online/")]
        assert tops == ["online/ingest", "online/update", "online/swap"] * 3
        assert "[online] trace" in capsys.readouterr().out
    elif key == "--metrics":
        assert got["metrics"]["counters"][
            "online/updates{engine=simulated,solver=d3ca}"] == 3.0
    elif key == "--health":
        assert got["obs"]["health"]["status"] == "ok"
    elif key == "--max-lag":
        # a lag bound below one batch: the first ingest breaches it until
        # the update lands (later ones may fall inside the monitor's rate
        # limit), and the last verdict (after the publish) is OK
        rule = got["obs"]["health"]["rules"]["version_lag"]
        assert rule["status"] == "ok" and got["metrics"]["counters"][
            "health/transitions{rule=version_lag,status=crit}"] >= 1.0
    elif key == "--listen":
        assert got["obs"]["listen"].startswith("http://127.0.0.1:")
    else:
        assert load_bundle(str(tmp_path / "b.json"))["reason"] == "exit"

"""The port's six examples (``examples/torch_*.py``) on the CPU, held to the
JAX package on the same arrays.

Each example's ``main`` runs in-process with ``--device cpu`` (cut where
the example is slow on the CPU); its printed lines are read with the
formats of the JAX example it mirrors, and the numbers it returns are
held to the reference: the solvers with the reference's coordinate
orders injected (``ArrayIndexSource``) at 1e-5, the serving and training
CLIs on the reference's weights carried across by ``convert``, with
float32 compute in both packages."""
import contextlib
import functools
import importlib.util
import io
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import repro.core as J
import repro.obs as JO
from repro.data import make_svm_data as ref_make_svm_data
from repro.data.tokens import synthetic_token_batch
from repro.launch import serve as ref_serve_cli
from repro.launch.steps import make_train_step as ref_make_train_step
from repro.online import OnlineConfig as JOnlineConfig
from repro.online import OnlineSolverService as JService
from repro.optim import AdamWConfig as RefAdamWConfig
from repro.optim import adamw_init as ref_adamw_init
from repro.optim import warmup_cosine as ref_warmup_cosine
from repro.serve import EngineConfig as RefEngineConfig
from repro.serve import InferenceEngine as RefEngine
from repro.serve import SamplingParams as RefSamplingParams
from repro_torch.launch import serve as serve_cli
from repro_torch.launch import train as train_cli
from repro_torch.launch.mesh import close_grids, process_grid
from repro_torch.models import Transformer, reduced
from repro_torch.models.transformer import tree_map
from test_torch_common import (MESH_GRID_TIMEOUT, bounded,  # noqa: F401
                               d3ca_source, lm_pair, radisa_source,
                               serial_perms)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-5, atol=1e-5)
#: printed numbers agree to the last digit the format keeps
PRINTED = 1.5e-4
NUM = r"(-?\d+\.\d+)"


def example(name):
    """The module ``examples/torch_<name>.py``."""
    path = os.path.join(ROOT, "examples", f"torch_{name}.py")
    spec = importlib.util.spec_from_file_location(f"torch_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run(name, argv, **kw):
    """``main(argv, **kw)`` of an example; its result and printed lines."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = example(name).main(argv, **kw)
    return out, buf.getvalue().splitlines()


@pytest.fixture(scope="module", autouse=True)
def _close_at_end():
    yield
    close_grids()


def _history(rec):
    def cb(t, w, *_):
        rec.append((int(t), np.asarray(w)))
    return cb


# ---------------------------------------------------------------------------
# 1. quickstart: f*, D3CA, RADiSA and ADMM against repro.core
# ---------------------------------------------------------------------------

def test_quickstart_matches_the_reference():
    n, m, epochs, lam = 160, 48, 5, 1e-1
    streams = {"serial": serial_perms(0, epochs, n),
               "d3ca": d3ca_source(0, n, iters=15, grid=(4, 2)),
               "radisa": radisa_source(0, n, iters=15, grid=(4, 2))}
    out, lines = run("quickstart", ["--device", "cpu", "--n", str(n), "--m",
                                    str(m), "--epochs", str(epochs)],
                     streams=streams)
    X, y = ref_make_svm_data(n=n, m=m, seed=0)
    w_star, *_ = J.serial_sdca("hinge", X, y, lam=lam, epochs=epochs)
    f_star = float(J.objective("hinge", X, y, w_star, lam))
    np.testing.assert_allclose(out["f_star"], f_star, **TOL)
    data = J.partition(X, y, P=4, Q=2)
    ref = {k: [] for k in ("d3ca", "radisa", "admm")}
    J.d3ca_simulated("hinge", data, J.D3CAConfig(lam=lam, outer_iters=15),
                     callback=_history(ref["d3ca"]))
    J.radisa_simulated("hinge", data, J.RADiSAConfig(
        lam=lam, gamma=0.05, outer_iters=15), callback=_history(ref["radisa"]))
    J.admm_simulated("hinge", data, J.ADMMConfig(lam=lam, rho=lam,
                                                 outer_iters=60),
                     callback=_history(ref["admm"]))
    want_lines = [("f*", None)]
    for name, head in (("d3ca", "D3CA (dual coordinate ascent):"),
                       ("radisa", "RADiSA (SGD x CD + SVRG):"),
                       ("admm", "block-splitting ADMM (baseline):")):
        got = out["history"][name]
        assert [h["iter"] for h in got] == [t for t, _ in ref[name]]
        f_ref = [float(J.objective("hinge", X, y, w, lam))
                 for _, w in ref[name]]
        np.testing.assert_allclose([h["objective"] for h in got], f_ref,
                                   **TOL)
        assert out["rel_opt"][name] == got[-1]["rel_opt"]
        want_lines.append((head, None))
        want_lines += [(name, (t, (f - f_star) / abs(f_star)))
                       for (t, _), f in zip(ref[name], f_ref) if t % 5 == 0]
    # the reference example's lines: f"f* = {:.5f}", the headers, and
    # f"  {name} iter {t:3d}: rel-opt {:.4f}" every 5 iterations
    assert len(lines) == len(want_lines)
    for line, (kind, val) in zip(lines, want_lines):
        if kind == "f*":
            got = re.fullmatch(r"f\* = " + NUM, line)
            assert got and len(got.group(1).split(".")[1]) == 5, line
            assert abs(float(got.group(1)) - f_star) < 1e-5
        elif val is None:
            assert line == kind
        else:
            got = re.fullmatch(rf"  {kind} iter +(\d+): rel-opt " + NUM,
                               line)
            assert got and int(got.group(1)) == val[0], line
            assert f"iter {val[0]:3d}:" in line
            assert abs(float(got.group(2)) - val[1]) < PRINTED, line


# ---------------------------------------------------------------------------
# 2. the grid example at 2 x 2 against the reference's simulated engine
# ---------------------------------------------------------------------------

@pytest.mark.usefixtures("bounded")
def test_svm_doubly_distributed_on_a_grid_matches_the_reference():
    n, m, epochs, lam = 200, 40, 5, 1e-1
    process_grid(2, 2, device="cpu", timeout=MESH_GRID_TIMEOUT)
    streams = {"serial": serial_perms(0, epochs, n),
               "d3ca": d3ca_source(0, n, iters=15, grid=(2, 2)),
               "radisa": radisa_source(0, n, iters=15, grid=(2, 2))}
    out, lines = run("svm_doubly_distributed", [
        "--device", "cpu", "--mesh", "2x2", "--n", str(n), "--m", str(m),
        "--epochs", str(epochs)], streams=streams)
    X, y = ref_make_svm_data(n, m, seed=0)
    w_star, *_ = J.serial_sdca("hinge", X, y, lam=lam, epochs=epochs)
    f_star = float(J.objective("hinge", X, y, w_star, lam))
    np.testing.assert_allclose(out["f_star"], f_star, **TOL)
    assert out["grid"].world == 4
    w_d3ca, _ = J.d3ca_simulated("hinge", J.partition(X, y, 2, 2),
                                 J.D3CAConfig(lam=lam, outer_iters=15))
    w_radisa = J.radisa_simulated("hinge", J.partition(X, y, 2, 2),
                                  J.RADiSAConfig(lam=lam, gamma=0.05,
                                                 outer_iters=15))
    assert lines[0] == "mesh: {'data': 2, 'model': 2} over 4 ranks on cpu"
    for line, name, label, w in ((lines[1], "d3ca", "D3CA  ", w_d3ca),
                                 (lines[2], "radisa", "RADiSA", w_radisa)):
        np.testing.assert_allclose(out[name]["w"], np.asarray(w), **TOL)
        r = float(J.rel_opt(J.objective("hinge", X, y, w, lam), f_star))
        np.testing.assert_allclose(out[name]["rel_opt"], r, rtol=1e-4,
                                   atol=1e-5)
        got = re.fullmatch(rf"{label} rel-opt: " + NUM, line)
        assert got and abs(float(got.group(1)) - r) < PRINTED, line
    assert len(lines) == 3


# ---------------------------------------------------------------------------
# 3. trace_solve: span names and history fields are the reference's
# ---------------------------------------------------------------------------

def test_trace_solve_spans_and_history_match_the_reference(tmp_path):
    iters = 4
    trace = str(tmp_path / "trace.json")
    out, lines = run("trace_solve", ["--device", "cpu", "--iters",
                                     str(iters), "--out", trace],
                     streams={"d3ca": d3ca_source(0, 800, iters=iters,
                                                  steps=64, grid=(2, 2))})
    X, y = ref_make_svm_data(800, 200, seed=0)
    jtr, jreg = JO.Tracer(), JO.Registry()
    want = J.get_solver("d3ca")(engine="simulated").solve(
        "hinge", X, y, P=2, Q=2, cfg=J.D3CAConfig(
            lam=1e-1, outer_iters=iters, local_steps=64),
        tracer=jtr, registry=jreg)
    got = out["history"]
    assert [sorted(h) for h in got] == [sorted(h) for h in want.history]
    np.testing.assert_allclose([h["objective"] for h in got],
                               [h["objective"] for h in want.history],
                               rtol=1e-5)
    names = {e["name"] for e in jtr.events}
    assert set(example("trace_solve").SPANS) <= names
    snap = out["snapshot"]
    for kind in ("counters", "gauges", "histograms"):
        assert sorted(snap[kind]) == sorted(jreg.snapshot()[kind]), kind
    assert all(os.path.getsize(p) > 0 for p in out["paths"])
    # the reference example's lines
    assert lines[0] == "per-iteration phase attribution:"
    row = (r"  t= +(\d+)  step +{0} ms  = local +{0}  \+ comm +{0}  "
           r"\(obs host +{0} ms\)   f={0}").format(NUM)
    for t, line in enumerate(lines[1:iters + 1], start=1):
        m = re.fullmatch(row, line)
        assert m and int(m.group(1)) == t, line
    assert re.fullmatch(r"span totals over " + NUM + r" ms of solve:",
                        lines[iters + 2])
    for name, line in zip(example("trace_solve").SPANS,
                          lines[iters + 3:]):
        assert re.fullmatch(rf"  {re.escape(name)} +{NUM} ms  \( *{NUM}%\)",
                            line), line
    assert lines[-1].startswith(f"wrote {trace} (+ ")
    assert lines[-1].endswith(f"{out['events']} events; open in "
                              "https://ui.perfetto.dev")


# ---------------------------------------------------------------------------
# 4. online_loop: three rounds against the reference service
# ---------------------------------------------------------------------------

def test_online_loop_matches_the_reference_service(tmp_path):
    rounds, m, batch, lam = 3, 32, 24, 1e-2
    out, lines = run("online_loop", [
        "--device", "cpu", "--rounds", str(rounds), "--ckpt-dir",
        str(tmp_path / "ck")], streams={"d3ca": d3ca_source(
            0, 256, iters=2, grid=(2, 2))})
    rng = np.random.default_rng(0)
    w_star = np.linspace(-1.0, 1.0, m).astype(np.float32)

    def stream(b):
        X = rng.normal(size=(b, m)).astype(np.float32)
        return X, np.where(X @ w_star >= 0, 1.0, -1.0).astype(np.float32)

    ref = JService(JOnlineConfig(m=m, capacity=256, P=2, Q=2, loss="hinge",
                                 solver_cfg=J.D3CAConfig(lam=lam), passes=2),
                   registry=JO.Registry())
    row = (r"  +(\d+) +(\d+) +(\d+)/256   {0}   {0}    +{0} ms"
           .format(NUM))
    assert lines[0] == ("round  version  filled   objective   accuracy  "
                        "staleness")
    for r, (got, line) in enumerate(zip(out["rounds"], lines[1:])):
        ref.submit(*stream(batch))
        version = ref.run_pending()
        Xs, ys = stream(128)
        acc = float(np.mean(ref.predict(Xs) * ys > 0))
        mask = ref.store.filled_mask > 0
        f = float(J.objective("hinge", ref.store.X[mask], ref.store.y[mask],
                              ref.book.current().w, lam))
        assert (got["round"], got["version"], got["filled"]) == \
            (r, version, ref.store.filled)
        assert got["version_lag"] == ref.version_lag == 0
        np.testing.assert_allclose(got["objective"], f, **TOL)
        assert got["accuracy"] == acc
        assert 0.0 <= got["staleness_s"] < 60.0
        parsed = re.fullmatch(row, line)
        assert parsed and int(parsed.group(2)) == version, line
        assert abs(float(parsed.group(4)) - f) < 1e-5
    assert out["recovered"] == out["newest"] == rounds
    assert out["weights_match"] is True
    assert lines[-1] == (f"recovered version {rounds} from "
                         f"{tmp_path / 'ck'} (weights match: True)")
    assert any(re.fullmatch(r"same gated passes, warm f=" + NUM
                            + r" vs cold f=" + NUM + r" \(warm start "
                            r"carries the converged dual\)", ln)
               for ln in lines)
    hist = [k for k in out["snapshot"]["histograms"]
            if k.startswith(("online/update_s", "online/swap_s"))]
    assert len(hist) == 2
    assert out["f_warm"] <= out["f_cold"]


# ---------------------------------------------------------------------------
# 5 and 6. the LM CLIs on the reference's weights, float32 compute
# ---------------------------------------------------------------------------

@pytest.fixture
def carried(monkeypatch):
    """Make the port's CLIs build ``reduced(cfg, compute_dtype="float32")``
    with the reference's weights (``lm_pair``); returns the pair's
    reference model and parameters."""
    def carry(arch, cli):
        rmodel, rparams, _, pparams = lm_pair(arch)
        monkeypatch.setattr(cli, "reduced", functools.partial(
            reduced, compute_dtype="float32"))
        monkeypatch.setattr(Transformer, "init", lambda self, seed: tree_map(
            lambda t: t.detach().clone(), pparams))
        return rmodel, rparams
    return carry


def test_serve_lm_greedy_tokens_equal_the_reference_engine(carried):
    gen = 4
    rmodel, rparams = carried("mixtral-8x7b", serve_cli)
    out, lines = run("serve_lm", ["--device", "cpu", "--gen", str(gen)])
    reqs = ref_serve_cli.build_trace(rmodel.cfg, 6, 8, 24, gen, gen,
                                     RefSamplingParams(), seed=0)
    want = RefEngine(rmodel, rparams, RefEngineConfig(
        max_slots=3, page_size=8, num_pages=256, max_seq_len=64)).run(reqs)
    assert sorted(out["outputs"]) == sorted(want) == list(range(6))
    for rid in want:
        np.testing.assert_array_equal(out["outputs"][rid], want[rid],
                                      err_msg=f"request {rid}")
    s = out["summary"]
    assert s["requests_finished"] == 6 and s["generated_tokens"] == 6 * gen
    # the reference CLI's lines
    assert re.fullmatch(r"6 requests, 24 tokens in {0}s \({0} tok/s\); "
                        r"ttft p50 \d+ ms, latency p99 \d+ ms".format(NUM),
                        lines[0]), lines[0]
    assert lines[-1].startswith("generated token ids (first request): ")


def test_lm_train_small_losses_match_the_reference(carried, tmp_path):
    steps = 3
    rmodel, rparams = carried("qwen3-1.7b", train_cli)
    out, lines = run("lm_train", ["--small", "--steps", str(steps),
                                  "--device", "cpu", "--ckpt-dir",
                                  str(tmp_path)])
    step = jax.jit(ref_make_train_step(rmodel, RefAdamWConfig(
        lr=ref_warmup_cosine(5e-3, 20, steps))))
    p, o = rparams, ref_adamw_init(rparams)
    want = []
    for s in range(steps):
        b = synthetic_token_batch(s, batch=4, seq=64, vocab=rmodel.cfg.vocab)
        p, o, metrics = step(p, o, {k: jnp.asarray(v) for k, v in b.items()})
        want.append(float(metrics["loss"]))
    np.testing.assert_allclose(out["losses"], want, **TOL)
    assert out["learned"] is None and len(out["time_s"]) == steps
    assert out["tokens_per_s"] > 0
    assert lines[-2] == f"first 5 losses: {[round(v, 3) for v in out['losses']]}"
    assert lines[-1] == f"last 5 losses:  {[round(v, 3) for v in out['losses']]}"

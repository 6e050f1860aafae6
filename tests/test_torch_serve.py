"""The port's serving stack (``repro_torch.serve``, ``launch/serve.py``) on
the CPU: greedy tokens of the continuous-batching engine equal to the
reference engine's on the same weights and trace, the contracts of
``tests/test_serve.py`` inside the port (continuous == static greedy,
transparent preemption, admission control, duplicate rid, stop token,
page-pool invariants), sampling filters against the reference's, and the
CLI."""
import contextlib
import io
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serve import EngineConfig as RefEngineConfig
from repro.serve import InferenceEngine as RefEngine
from repro.serve import Request as RefRequest
from repro.serve.sampling import _filter_logits as ref_filter_logits
from repro_torch.launch import serve as cli
from repro_torch.obs import (HealthMonitor, Registry, Tracer, load_bundle,
                             serve_rules)
from repro_torch.serve import (EngineConfig, InferenceEngine, PagePool,
                               PagedCacheConfig, Request, RequestMetrics,
                               SamplingParams)
from repro_torch.serve.sampling import (_filter_logits, params_arrays,
                                        sample_tokens)
from test_torch_common import lm_pair


def _trace(vocab, plens, gens, seed=7):
    rng = np.random.default_rng(seed)
    return [Request(rid=i, prompt=rng.integers(0, vocab, size=p),
                    max_new_tokens=g)
            for i, (p, g) in enumerate(zip(plens, gens))]


def _model():
    _, _, model, params = lm_pair("qwen3-1.7b")
    return model, params


# ---------------------------------------------------------------------------
# PagePool / block-table invariants
# ---------------------------------------------------------------------------

def test_pages_for_and_pool_roundtrip():
    pc = PagedCacheConfig(page_size=16, num_pages=8)
    assert [pc.pages_for(n) for n in (0, 1, 16, 17)] == [1, 1, 1, 2]
    assert pc.trash_page == 8
    pool = PagePool(PagedCacheConfig(page_size=4, num_pages=6))
    a, b = pool.alloc("a", 2), pool.alloc("b", 3)
    assert len(a) == 2 and len(b) == 3 and pool.n_free == 1
    assert not set(a) & set(b)
    pool.check()
    assert pool.free("a") == 2 and pool.n_free == 3
    assert pool.free("b") == 3 and pool.n_free == 6
    pool.check()


def test_pool_double_free_atomic_alloc_and_corruption():
    pool = PagePool(PagedCacheConfig(page_size=4, num_pages=4))
    assert pool.alloc("a", 3) is not None
    assert pool.alloc("b", 2) is None            # all-or-nothing
    assert pool.n_free == 1 and pool.pages("b") == []
    pool.free("a")
    with pytest.raises(KeyError):
        pool.free("a")
    with pytest.raises(ValueError):
        pool.alloc("c", -1)
    pool.alloc("c", 2)
    pool._free.append(pool.pages("c")[0])        # simulate a double-book
    with pytest.raises(AssertionError):
        pool.check()


# ---------------------------------------------------------------------------
# sampling
# ---------------------------------------------------------------------------

def _rows(n, v, seed=0):
    return np.random.default_rng(seed).normal(size=(n, v)).astype(np.float32)


@pytest.mark.parametrize("top_k,top_p", [(0, 1.0), (1, 1.0), (5, 1.0),
                                         (0, 0.5), (7, 0.8), (40, 0.95),
                                         (0, 1e-6)])
def test_filter_logits_masks_equal_the_references(top_k, top_p):
    """Same keep-mask as the reference on the same rows, including rows
    with tied logits (a stable sort ranks ties in index order)."""
    logits = _rows(6, 40, seed=top_k)
    logits[1, 10:14] = logits[1].max()           # a four-way tie at the top
    logits[2] = np.round(logits[2], 1)           # many ties
    got = _filter_logits(torch.from_numpy(logits), top_k, top_p).numpy()
    for r in range(logits.shape[0]):
        want = np.asarray(ref_filter_logits(jnp.asarray(logits[r]),
                                            top_k, top_p))
        np.testing.assert_array_equal(got[r] > -1e29, want > -1e29,
                                      err_msg=f"row {r}")
        np.testing.assert_array_equal(got[r], want)


def test_sampling_greedy_top_k1_and_tiny_top_p_are_argmax():
    logits = torch.from_numpy(_rows(5, 32))
    out = sample_tokens(logits, *params_arrays([SamplingParams()] * 5,
                                               [0] * 5))
    assert torch.equal(out, logits.argmax(-1))
    for sp in (SamplingParams(temperature=1.0, top_k=1, seed=3),
               SamplingParams(temperature=1.0, top_p=1e-6, seed=4)):
        out = sample_tokens(logits, *params_arrays([sp] * 5, [3] * 5))
        assert torch.equal(out, logits.argmax(-1))


def test_sampling_stream_is_slot_independent_and_follows_the_distribution():
    """A request's draw depends on (seed, step), not its batch position;
    over many (seed, step) pairs the draws follow the filtered softmax."""
    logits = torch.from_numpy(_rows(1, 64, seed=2))
    p = SamplingParams(temperature=0.9, top_k=8, top_p=0.95, seed=123)
    alone = sample_tokens(logits, *params_arrays([p], [7]))[0]
    batched = sample_tokens(
        logits.repeat(3, 1),
        *params_arrays([SamplingParams(temperature=1.3, seed=5), p,
                        SamplingParams(seed=9)], [0, 7, 2]))[1]
    assert int(alone) == int(batched)
    row = torch.tensor([[2.0, 1.0, 0.0, -1.0, -9.0]])
    n = 2000
    sp = [SamplingParams(temperature=1.0, top_k=3, seed=s) for s in range(n)]
    draws = sample_tokens(row.repeat(n, 1), *params_arrays(sp, [1] * n))
    freq = np.bincount(draws.numpy(), minlength=5) / n
    want = torch.softmax(row[0, :3], 0).numpy()
    np.testing.assert_allclose(freq[:3], want, atol=0.04)
    assert freq[3:].sum() == 0                   # filtered tokens never


def test_metrics_with_fake_clock():
    t = [0.0]
    m = RequestMetrics(clock=lambda: t[0])
    m.start_request("a", 8)
    t[0] = 0.5
    m.first_token("a")
    t[0] = 2.0
    m.finish("a", 10)
    s = m.summary()
    assert s["requests_finished"] == 1 and s["generated_tokens"] == 10
    assert s["tokens_per_sec"] == pytest.approx(10 / 2.0)
    assert s["ttft_s"]["p50"] == pytest.approx(0.5)
    assert s["latency_s"]["p99"] == pytest.approx(2.0)


# ---------------------------------------------------------------------------
# the engine against the reference engine, and its contracts
# ---------------------------------------------------------------------------

def test_engine_greedy_tokens_equal_the_reference_engine():
    """Mixed prompt lengths (buckets of 8 and 16 tokens) over 2 slots with
    backfill: token for token the reference engine's output."""
    rmodel, rparams, model, params = lm_pair("qwen3-1.7b")
    plens, gens = [6, 13, 3, 9, 11], [5, 8, 4, 7, 3]
    ecfg = dict(max_slots=2, page_size=8, num_pages=32, max_seq_len=32)
    ref = RefEngine(rmodel, rparams, RefEngineConfig(**ecfg)).run(
        [RefRequest(rid=r.rid, prompt=r.prompt,
                    max_new_tokens=r.max_new_tokens)
         for r in _trace(256, plens, gens)])
    engine = InferenceEngine(model, params, EngineConfig(**ecfg))
    out = engine.run(_trace(256, plens, gens))
    assert sorted(out) == sorted(ref)
    for rid in ref:
        np.testing.assert_array_equal(out[rid], ref[rid],
                                      err_msg=f"request {rid}")
    s = engine.metrics.summary()
    assert s["prefills"] == len(plens) and s["generated_tokens"] == sum(gens)


def test_continuous_equals_static_greedy():
    model, params = _model()
    plens, gens = [6, 6, 11, 11, 3, 3], [5, 8, 4, 7, 6, 3]
    reqs = _trace(model.cfg.vocab, plens, gens)
    ref = cli.static_batch_generate(model, params, reqs, batch_size=2)
    engine = InferenceEngine(model, params, EngineConfig(
        max_slots=2, page_size=8, num_pages=32, max_seq_len=32))
    out = engine.run(reqs)
    assert sorted(out) == sorted(ref)
    for rid in ref:
        np.testing.assert_array_equal(out[rid], ref[rid],
                                      err_msg=f"request {rid}")
    engine.pool.check()
    assert engine.pool.n_free == engine.pc.num_pages   # all pages returned


def test_engine_preemption_is_transparent():
    model, params = _model()
    reqs = _trace(model.cfg.vocab, [9] * 4, [10] * 4)
    ref = cli.static_batch_generate(model, params, reqs, batch_size=4)
    engine = InferenceEngine(model, params, EngineConfig(
        max_slots=4, page_size=4, num_pages=13, max_seq_len=20,
        reserve_pages=False))
    out = engine.run(reqs)
    assert engine.metrics.preemptions > 0
    assert engine.metrics.prefills > len(reqs)        # replays re-prefill
    for rid in ref:
        np.testing.assert_array_equal(out[rid], ref[rid],
                                      err_msg=f"request {rid}")
    engine.pool.check()


def test_engine_admission_control_and_duplicate_rid():
    model, params = _model()
    engine = InferenceEngine(model, params, EngineConfig(
        max_slots=2, page_size=8, num_pages=16, max_seq_len=24,
        max_queue=2))
    assert not engine.submit(Request(rid="x", prompt=np.zeros(20, np.int32),
                                     max_new_tokens=8))      # too long
    assert engine.submit(Request(rid=0, prompt=np.zeros(4, np.int32),
                                 max_new_tokens=2))
    assert not engine.submit(Request(rid=0, prompt=np.ones(4, np.int32),
                                     max_new_tokens=2))      # duplicate
    assert engine.submit(Request(rid=1, prompt=np.zeros(4, np.int32),
                                 max_new_tokens=2))
    assert not engine.submit(Request(rid=2, prompt=np.zeros(4, np.int32),
                                     max_new_tokens=2))      # queue full
    assert engine.metrics.rejections == 3
    assert sorted(engine.run([])) == [0, 1]
    assert not engine.submit(Request(rid=1, prompt=np.zeros(4, np.int32),
                                     max_new_tokens=2))      # finished rid
    engine.pool.check()
    with pytest.raises(ValueError):
        Request(rid=3, prompt=[], max_new_tokens=2)


def test_engine_stop_token_sampling_and_registry():
    model, params = _model()
    reqs = _trace(model.cfg.vocab, [5], [12])
    ecfg = EngineConfig(max_slots=1, page_size=8, num_pages=16,
                        max_seq_len=32)
    ref = InferenceEngine(model, params, ecfg).run(reqs)
    k = next(i for i in range(1, len(ref[0])) if ref[0][i] not in ref[0][:i])
    req = Request(rid=0, prompt=reqs[0].prompt, max_new_tokens=12,
                  stop_token=int(ref[0][k]))
    np.testing.assert_array_equal(
        InferenceEngine(model, params, ecfg).run([req])[0], ref[0][: k + 1])
    # sampled requests: same seeds -> same tokens, whatever the slot count
    sp = [SamplingParams(temperature=0.8, top_k=50, seed=s) for s in (3, 4)]
    sampled = [Request(rid=i, prompt=r.prompt, max_new_tokens=6,
                       sampling=sp[i])
               for i, r in enumerate(_trace(model.cfg.vocab, [5, 7], [6, 6]))]
    reg = Registry()
    one = InferenceEngine(model, params, ecfg, registry=reg).run(sampled)
    two = InferenceEngine(model, params, EngineConfig(
        max_slots=2, page_size=8, num_pages=16, max_seq_len=32)).run(sampled)
    for rid in one:
        np.testing.assert_array_equal(one[rid], two[rid])
    snap = reg.snapshot()
    assert snap["counters"]["serve/prefills"] == 2
    assert snap["histograms"]["serve/latency_s"]["count"] == 2
    # under a tracer and a monitor the engine serves the same tokens and
    # records the reference's spans and instants
    tr = Tracer()
    mon = HealthMonitor(reg, serve_rules(), min_interval_s=0.0)
    traced = InferenceEngine(model, params, ecfg, tracer=tr,
                             monitor=mon).run(sampled)
    for rid in one:
        np.testing.assert_array_equal(one[rid], traced[rid])
    assert len(tr.spans("prefill")) == 2 and len(tr.spans("decode_step")) \
        == len(tr.spans("engine_step")) - 1 == mon.evaluations - 1
    assert [e["name"] for e in tr.events if e["dur"] is None] == \
        ["finish", "finish"]


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def _run_cli(argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = cli.main(argv)
    return out, buf.getvalue()


def test_cli_engine_path_on_the_cpu():
    out, text = _run_cli([
        "--arch", "qwen3-1.7b", "--reduced", "--requests", "4", "--slots",
        "2", "--prompt-len", "8", "--prompt-len-max", "24", "--gen", "6",
        "--page-size", "8", "--max-seq-len", "64", "--device", "cpu",
        "--metrics"])
    assert sorted(out) == [0, 1, 2, 3]
    assert all(len(v) == 6 for v in out.values())
    assert "tok/s" in text and '"serve/prefills": 4.0' in text


def test_cli_static_loop_for_cross_attention_on_the_cpu():
    """Llama-3.2-Vision (XATTN over stub encoder states) takes the static
    loop, as in the reference, and serves every request."""
    out, text = _run_cli(["--arch", "llama-3.2-vision-90b", "--reduced",
                          "--requests", "2", "--prompt-len", "12", "--gen",
                          "5", "--device", "cpu"])
    assert "falling back to the static loop" in text
    assert sorted(out) == [0, 1] and all(len(v) == 5 for v in out.values())


def test_cli_static_loop_for_rwkv_on_the_cpu():
    out, text = _run_cli(["--arch", "rwkv6-3b", "--reduced", "--requests",
                          "3", "--prompt-len", "10", "--gen", "4",
                          "--device", "cpu"])
    assert "falling back to the static loop" in text
    assert sorted(out) == [0, 1, 2] and all(len(v) == 4
                                            for v in out.values())


def test_cli_needs_device_cpu_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the rule under test is "
                    "what happens without one")
    with pytest.raises(RuntimeError, match="--device cpu"):
        cli.main(["--arch", "qwen3-1.7b", "--reduced"])


def _check_observability_flag(flags, tmp_path):
    """An observability flag of the reference's serving CLI serves the
    trace under it, token for token the plain run, and reports what it
    made."""
    key = flags[0]
    flags = [str(tmp_path / "t.json") if f == "TRACE" else
             str(tmp_path / "b.json") if f == "BUNDLE" else f for f in flags]
    argv = ["--arch", "qwen3-1.7b", "--reduced", "--requests", "3",
            "--slots", "2", "--prompt-len", "8", "--gen", "4",
            "--page-size", "8", "--max-seq-len", "32", "--device", "cpu"]
    plain, _ = _run_cli(argv)
    got, text = _run_cli([*flags, *argv])
    for rid in plain:
        np.testing.assert_array_equal(plain[rid], got[rid])
    if key == "--trace":
        events = json.loads((tmp_path / "t.json").read_text())["traceEvents"]
        assert sum(e["name"] == "prefill" for e in events) == 3
        assert sum(e["name"] == "finish" for e in events) == 3
    elif key == "--listen":
        assert "[obs] serving /metrics" in text and '"listen"' in text
    elif key == "--health":
        assert '"status": "ok"' in text
    else:
        assert load_bundle(str(tmp_path / "b.json"))["reason"] == "exit"


#: the expectation of a refusal case whose flag is now ported: it runs
PORTED = object()


def _check_ported_arch(argv):
    """A family the CLI once refused serves 3 requests of 8 positions, 4
    new tokens each: through the paged engine where it is pageable (MoE),
    else through the static loop."""
    out, text = _run_cli(argv + ["--reduced", "--device", "cpu",
                                 "--requests", "3", "--prompt-len", "8",
                                 "--gen", "4", "--page-size", "8",
                                 "--max-seq-len", "32"])
    static = argv[1] != "mixtral-8x7b"
    assert ("falling back to the static loop" in text) == static
    assert sorted(out) == [0, 1, 2] and all(len(v) == 4
                                            for v in out.values())


@pytest.mark.parametrize("argv,named", [
    # the observability flags, once refused, run
    pytest.param(["--trace", "TRACE"], PORTED, id="argv0---trace"),
    pytest.param(["--listen", "127.0.0.1:0"], PORTED, id="argv1---listen"),
    pytest.param(["--health"], PORTED, id="argv2---health"),
    pytest.param(["--flight-recorder", "BUNDLE"], PORTED,
                 id="argv3---flight-recorder"),
    # the families once refused by name (ROADMAP item 13b) serve: MoE on
    # the paged engine, RG-LRU and the embedding frontend on the static
    # loop, as in the reference
    pytest.param(["--arch", "mixtral-8x7b"], PORTED, id="argv4-MoE"),
    pytest.param(["--arch", "recurrentgemma-9b"], PORTED, id="argv5-rglru"),
    pytest.param(["--arch", "musicgen-large"], PORTED,
                 id="argv6-embeddings")])
def test_cli_refuses_unported_flags_and_archs_by_name(argv, named, capsys,
                                                      tmp_path):
    """A flag or an arch whose layer is now ported (``PORTED``) runs, and
    its case checks what it made; what is still refused would exit 2
    naming its ROADMAP item."""
    if named is PORTED and argv[0] == "--arch":
        return _check_ported_arch(argv)
    if named is PORTED:
        return _check_observability_flag(argv, tmp_path)
    with pytest.raises(SystemExit) as e:
        cli.main(argv + ["--reduced", "--device", "cpu"])
    assert e.value.code == 2
    err = capsys.readouterr().err
    assert named in err and "ROADMAP queue A item" in err

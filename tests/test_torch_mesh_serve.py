"""Every LM family's prefill and decode over a (data, model) process grid
against the reference's single device (the 1 x 2 and 2 x 2 grids, the
planted faults and the views' versions here; the 2 x 1 and (pod, data,
model) grids in ``test_torch_mesh_serve_grids.py``, which shares this
file's machinery).

On CPU ranks (gloo), float32 compute, the ten archs' reduced configs
(RecurrentGemma at 5 layers, as ``test_torch_lm_families.py`` runs it)
with the reference's ``init(0)`` weights put on the mesh
(``mesh_train.put_params``): ``make_prefill_step`` and six
``make_decode_step`` steps of the grid against the reference's jitted
single-device ``prefill`` / ``decode_step`` on the same numpy inputs
(batch 4, prompt 20, cache 28; the next tokens are the reference's
greedy choices): the logits of the prefill and of every decode step, and
the whole cache gathered from the ranks after the prefill and after the
last step, at 1e-5.  Every rank's block of every cache leaf has the shape
``cache_specs`` gives it, and each step's wire bytes equal
``mesh_serve.serve_wire_bytes``.

What the cases cover: KV heads over "model" (n_kv = 2 over M = 2), the
length split of a single KV head (granite, RecurrentGemma's LOCAL layers:
L / M slots a rank, flash-decoding merge), LOCAL's and Mixtral's ring
buffers of 16 wrapping in prefill and again in decode, a rank with no
valid slot (granite, prompt 6: the second rank's slots 14..27 are empty
through all six steps), the int8 KV cache, XATTN against the encoder
states (Vision), the embedding frontend (MusicGen), RWKV-6's state on the
rank's heads and RG-LRU's ``h`` on its channels.  Two planted faults --
the merge without the heads' maxima, and a decoded token written on every
rank of a "model" group -- must fail these checks.  The FSDP views are
gathered once per parameter version: held across steps, gathered again
after a training step, and a stale view makes the step raise."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.core.util import tree_leaves as leaves
from repro_torch.launch import mesh_serve, mesh_train
from repro_torch.launch.mesh import close_grids, make_mesh, process_grid
from repro_torch.launch.steps import (make_decode_step, make_prefill_step,
                                      make_train_step)
from repro_torch.models import Transformer
from repro_torch.optim import AdamWConfig
from repro_torch.sharding import resident
from test_torch_common import MESH_GRID_TIMEOUT, bounded, lm_pair  # noqa: F401

pytestmark = pytest.mark.usefixtures("bounded")

TOL = 1e-5
B, S, CACHE, STEPS = 4, 20, 28, 6
ARCHS = ["qwen3-1.7b", "granite-20b", "stablelm-12b", "mistral-nemo-12b",
         "rwkv6-3b", "llama-3.2-vision-90b", "mixtral-8x7b",
         "moonshot-v1-16b-a3b", "musicgen-large", "recurrentgemma-9b"]
#: what each reduced config needs to reach all of its paths
OVERRIDES = {"recurrentgemma-9b": {"n_layers": 5}}
AXES = ("data", "model")
POD_AXES = ("pod", "data", "model")


@pytest.fixture(scope="module", autouse=True)
def _close_at_end():
    yield
    close_grids()


def mesh_of(shape, axes=AXES):
    """The mesh of ``shape`` on its memoized CPU grid, started with the
    tests' bound."""
    process_grid(int(np.prod(shape[:-1])), shape[-1], device="cpu",
                 timeout=MESH_GRID_TIMEOUT)
    return make_mesh(shape, axes, device="cpu")


def _inputs(cfg, seed, rows, seq):
    rng = np.random.default_rng(seed)
    b = {}
    if cfg.embed_input == "tokens":
        b["tokens"] = rng.integers(0, cfg.vocab, (rows, seq)).astype(np.int32)
    else:
        b["embeds"] = rng.normal(size=(rows, seq, cfg.d_model)).astype(
            np.float32)
    if cfg.encoder_len:
        b["encoder"] = rng.normal(
            size=(rows, cfg.encoder_len, cfg.d_model)).astype(np.float32)
    return b


def _decode_input(cfg, logits, step):
    """The next step's input: the reference's greedy tokens, or (the
    embedding frontend) fresh frame embeddings."""
    if cfg.embed_input == "tokens":
        return {"tokens": np.asarray(jnp.argmax(logits[:, -1], -1))
                .astype(np.int32)[:, None]}
    rng = np.random.default_rng(100 + step)
    return {"embeds": rng.normal(size=(logits.shape[0], 1, cfg.d_model))
            .astype(np.float32)}


def _cache_leaves(cache):
    return leaves({"periods": cache["periods"],
                   "remainder": cache["remainder"]})


_REFS = {}


def reference(arch, prompt=S, cache_len=CACHE, **over):
    """The reference's jitted single-device prefill and ``STEPS`` decode
    steps: (inputs of every step, logits of every step, the cache's
    leaves after the prefill and after the last step), cached."""
    over = {**OVERRIDES.get(arch, {}), **over}
    key = (arch, prompt, cache_len, tuple(sorted(over.items())))
    if key not in _REFS:
        rmodel, rparams, pmodel, _ = lm_pair(arch, **over)
        cfg = pmodel.cfg
        b = _inputs(cfg, 3, B, prompt)
        logits, cache = jax.jit(lambda p, bb: rmodel.prefill(p, bb, cache_len))(
            rparams, {k: jnp.asarray(v) for k, v in b.items()})
        ins, outs = [b], [np.asarray(logits)]
        first = [np.asarray(x) for x in _cache_leaves(cache)]
        decode = jax.jit(rmodel.decode_step)
        for step in range(STEPS):
            inp = _decode_input(cfg, logits, step)
            logits, cache = decode(rparams, cache,
                                   {k: jnp.asarray(v) for k, v in inp.items()})
            ins.append(inp)
            outs.append(np.asarray(logits))
        _REFS[key] = (ins, outs, first,
                      [np.asarray(x) for x in _cache_leaves(cache)])
    return _REFS[key]


def _close_leaves(got, want, what):
    assert len(got) == len(want), what
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape and g.dtype == w.dtype, (what, i)
        np.testing.assert_allclose(g.astype(np.float32), w.astype(np.float32),
                                   rtol=TOL, atol=TOL,
                                   err_msg=f"{what} leaf {i}")


def serve_on_grid(arch, shape, axes=AXES, prompt=S, cache_len=CACHE, **over):
    """The grid's prefill and ``STEPS`` decode steps from the reference's
    weights: (model, its parameter handles, each step's logits, the cache
    gathered after the prefill and after the last step, its handles, each
    step's wire bytes and views' report)."""
    over = {**OVERRIDES.get(arch, {}), **over}
    _, rparams, pmodel, _ = lm_pair(arch, **over)
    ins = reference(arch, prompt, cache_len, **over)[0]
    model = Transformer(pmodel.cfg, device="cpu", mesh=mesh_of(shape, axes))
    params = mesh_train.put_params(model, jax.tree.map(np.asarray, rparams))
    prefill = make_prefill_step(model, cache_len)
    decode = make_decode_step(model)
    logits, cache = prefill(params, ins[0])
    outs, reports = [logits.numpy()], [prefill.last]
    first = resident.gather_leaves(_cache_leaves(cache))
    for inp in ins[1:]:
        logits, cache = decode(params, cache, inp)
        outs.append(logits.numpy())
        reports.append(decode.last)
    last = resident.gather_leaves(_cache_leaves(cache))
    return model, params, outs, (first, last), cache, reports


def check_serve(arch, shape, axes=AXES, prompt=S, cache_len=CACHE, **over):
    """The grid against the reference (see the module docstring); returns
    the grid's run."""
    run = serve_on_grid(arch, shape, axes, prompt, cache_len, **over)
    model, params, outs, (first, last), cache, reports = run
    _, r_outs, r_first, r_last = reference(arch, prompt, cache_len, **over)
    for i, (g, w) in enumerate(zip(outs, r_outs)):
        np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL,
                                   err_msg=f"logits of step {i}")
    _close_leaves(first, r_first, "cache after the prefill")
    _close_leaves(last, r_last, "cache after the last step")
    hs = _cache_leaves(cache)
    want = [h.struct.local_shape for h in hs]
    for rank, got in resident.block_shapes(
            {"periods": cache["periods"],
             "remainder": cache["remainder"]}).items():
        assert got == want, rank
    for i, rep in enumerate(reports):
        kind = "prefill" if i == 0 else "decode"
        want_wire = mesh_serve.serve_wire_bytes(
            model, B, prompt if kind == "prefill" else cache_len, kind)
        assert rep["wire"] == want_wire["step"], (i, rep["wire"])
        assert rep["views"]["gathered"] == (i == 0)
        if i == 0:
            assert rep["views"]["wire"] == want_wire["views"]
    mesh_serve.free_cache(cache)
    return run


# ---------------------------------------------------------------------------
# 1 x 2: "model" alone
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_serve_on_1x2_matches_the_reference(arch):
    model = check_serve(arch, (1, 2))[0]
    tp = model.tp
    assert tp["embed_vp"] == (model.cfg.embed_input == "tokens")
    assert tp["head_vp"]


def test_a_rank_with_no_valid_slot_on_1x2():
    """granite's one KV head over M = 2, prompt 6 of cache 28: the second
    rank's 14 slots stay empty through the six steps (its partials are
    max -inf, sum 0) and the merge stays finite and right."""
    model, _, outs, *_ = check_serve("granite-20b", (1, 2), prompt=6)
    assert model.tp["heads_local"] and not model.tp["kv_local"]
    assert all(np.isfinite(o).all() for o in outs)


# ---------------------------------------------------------------------------
# planted faults: each must fail the checks
# ---------------------------------------------------------------------------

def _merge_without_max(m, l, o, group):
    """The fault: every rank's partial summed as if its maximum were the
    group's."""
    from repro_torch.sharding import collectives as coll
    both = coll.all_reduce(torch.cat([l[..., None], o], -1), group)
    return both[..., 1:] / both[..., :1]


def _on_every_rank(slot, rows, index):
    """The fault: the slot written on every rank of the "model" group."""
    return slot % rows


FAULTS = {"merge_without_max": ("repro_torch.sharding.collectives",
                                "merge_partials", _merge_without_max),
          "written_on_every_rank": ("repro_torch.models.transformer",
                                    "owned_slot", _on_every_rank)}


def _rank_plant(ctx, mesh, fault, on: bool):
    """On every rank: plant ``fault`` (``on``) or put the real function
    back."""
    import importlib
    mod, name, bad = FAULTS[fault]
    module = importlib.import_module(mod)
    saved = ctx.resident.setdefault("planted", {})
    if on:
        saved[fault] = getattr(module, name)
        setattr(module, name, bad)
    else:
        setattr(module, name, saved.pop(fault))


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_planted_faults_fail_the_checks(fault):
    mesh = mesh_of((1, 2))
    resident.call(mesh, "test_torch_mesh_serve:_rank_plant", fault=fault,
                  on=True)
    try:
        with pytest.raises(AssertionError):
            check_serve("granite-20b", (1, 2))
    finally:
        resident.call(mesh, "test_torch_mesh_serve:_rank_plant",
                      fault=fault, on=False)
    check_serve("granite-20b", (1, 2))


# ---------------------------------------------------------------------------
# 2 x 2: "data" and "model"
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_serve_on_2x2_matches_the_reference(arch):
    check_serve(arch, (2, 2))


def test_int8_kv_cache_on_2x2():
    check_serve("qwen3-1.7b", (2, 2), kv_cache_dtype="int8")


def test_views_are_gathered_again_after_a_training_step():
    """A training step changes the parameters: the next prefill gathers
    the views again (its report says so) and its logits are the one
    device's prefill of the trained parameters."""
    arch = "qwen3-1.7b"
    _, rparams, pmodel, _ = lm_pair(arch)
    model = Transformer(pmodel.cfg, device="cpu", mesh=mesh_of((2, 2)))
    params = mesh_train.put_params(model, jax.tree.map(np.asarray, rparams))
    opt = mesh_train.init_opt(model, params)
    prefill = make_prefill_step(model, CACHE)
    ins = reference(arch)[0]
    _, cache = prefill(params, ins[0])
    mesh_serve.free_cache(cache)
    _, cache = prefill(params, ins[0])
    assert not prefill.last["views"]["gathered"]
    mesh_serve.free_cache(cache)
    batch = {"tokens": ins[0]["tokens"], "labels": ins[0]["tokens"]}
    make_train_step(model, AdamWConfig(lr=1e-2), 1)(params, opt, batch)
    logits, cache = prefill(params, ins[0])
    assert prefill.last["views"]["gathered"]
    one = Transformer(pmodel.cfg, device="cpu")
    trained = [torch.from_numpy(a) for a in resident.gather_leaves(
        leaves(params))]
    from repro_torch.core.util import tree_unflatten
    with torch.no_grad():
        want, _ = one.prefill(tree_unflatten(one.init(0), trained),
                              {"tokens": torch.from_numpy(ins[0]["tokens"])},
                              CACHE)
    np.testing.assert_allclose(logits.numpy(), want.numpy(), rtol=TOL,
                               atol=TOL)
    mesh_serve.free_cache(cache)
    resident.free(params)
    resident.free(opt)


def test_init_on_the_ranks_is_one_devices_init():
    """``init_params_on_mesh``: every rank makes init(seed) on its own
    device and keeps its blocks -- the tree one device's init makes,
    bitwise."""
    _, _, pmodel, _ = lm_pair("mixtral-8x7b")
    model = Transformer(pmodel.cfg, device="cpu", mesh=mesh_of((2, 2)))
    params = mesh_train.init_params_on_mesh(model, 3)
    want = Transformer(pmodel.cfg, device="cpu").init(3)
    for g, w in zip(resident.gather_leaves(leaves(params)), leaves(want)):
        np.testing.assert_array_equal(g, w.numpy())
    resident.free(params)


def _rank_stale(ctx, mesh, key):
    """The fault: the parameters' version moves on and the held views
    stay."""
    got = ctx.resident.setdefault("versions", {})
    got[key] = got.get(key, 0) + 1


def test_a_stale_view_makes_the_step_raise():
    """Views whose version is not the parameters' are never used (this
    ends the grid: it runs last in the file)."""
    arch = "qwen3-1.7b"
    _, rparams, pmodel, _ = lm_pair(arch)
    mesh = mesh_of((2, 2))
    model = Transformer(pmodel.cfg, device="cpu", mesh=mesh)
    params = mesh_train.put_params(model, jax.tree.map(np.asarray, rparams))
    ins = reference(arch)[0]
    _, cache = make_prefill_step(model, CACHE)(params, ins[0])
    resident.call(mesh, "test_torch_mesh_serve:_rank_stale",
                  key=leaves(params)[0].key)
    with pytest.raises(Exception, match="stale views"):
        make_decode_step(model)(params, cache, ins[1])

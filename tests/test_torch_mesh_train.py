"""LM training over a (data, model) process grid against one device.

On a 2 x 2 grid of CPU ranks (gloo), float32 compute: reduced Qwen3 (4 /
2 heads: query and KV heads split over "model") and reduced granite (one
KV head: its ``wk`` / ``wv`` split over "model" inside the head, gathered
before use) train three steps of ``make_train_step`` on a mesh, with one and with
four microbatches, against the reference's single-device jitted
``make_train_step`` and the port's own single-device step from the same
weights: loss and grad norm every step, every parameter, ``mu`` and ``nu``
after the third, at 1e-5.  Then: every rank's blocks shaped as the specs
say, each rank's attention on H / M query heads, the wire bytes of a step
equal to the count made from the specs beforehand, checkpoints that move
bitwise between 2 x 2, 4 x 1, one device and the reference, the trainer's
restore / rollback / preemption on the grid, the CLI's ``--mesh`` with
``--resume``, the refusals of a model that only describes a mesh (and of
paged decode on a mesh), and the six other families training on a 2 x 1 grid
and through the CLI's ``--mesh 2,1`` (their parity on a 2 x 2 grid:
``test_torch_mesh_families.py``, ``test_torch_mesh_moe.py``).

AdamW's eps is 1e-6 in both packages, as in ``test_torch_train.py``'s
trajectories of the other families: at the default 1e-8 an entry whose
gradient is at float32 rounding level moves by g / (|g| + eps) of the
rate, a fraction rounding decides -- the port's own one-device step then
sits 1.4 (Qwen3) and 7.0 (granite) tolerances from the reference at one
entry after three steps, with no grid involved."""
import dataclasses
import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.manager import save_tree as ref_save_tree
from repro.launch.steps import make_train_step as ref_make_train_step
from repro.optim import AdamWConfig as RefAdamWConfig
from repro.optim import adamw_init as ref_adamw_init
from repro.optim import warmup_cosine as ref_warmup_cosine
from repro_torch.checkpoint import restore_tree, save_tree
from repro_torch.configs import get_config
from repro_torch.core.util import tree_leaves as leaves
from repro_torch.core.util import tree_map
from repro_torch.data import TokenPipeline, shard_batch, synthetic_lm_batch
from repro_torch.launch import mesh_train
from repro_torch.launch import train as train_mod
from repro_torch.launch.mesh import close_grids, make_mesh, process_grid
from repro_torch.launch.steps import (batch_specs, make_train_step,
                                      opt_shardings, param_shardings)
from repro_torch.models import ShapeConfig, Transformer, reduced
from repro_torch.sharding import resident
from repro_torch.optim import AdamWConfig, adamw_init, warmup_cosine
from repro_torch.runtime import Trainer, TrainerConfig
from test_torch_common import MESH_GRID_TIMEOUT, bounded, lm_pair  # noqa: F401

pytestmark = pytest.mark.usefixtures("bounded")

TOL = 1e-5
B, S = 4, 32
#: (arch, accumulation): with accumulation 4 a rank's two rows are two
#: whole microbatches; with 1, the one microbatch spans both data ranks
CASES = [("qwen3-1.7b", 4), ("qwen3-1.7b", 1), ("granite-20b", 1),
         ("granite-20b", 4)]
FAMILIES_13D = ["mixtral-8x7b", "moonshot-v1-16b-a3b", "rwkv6-3b",
                "recurrentgemma-9b", "llama-3.2-vision-90b",
                "musicgen-large"]


def _grid(shape):
    """The memoized CPU grid of ``shape``, started with the tests' bound."""
    process_grid(*shape, device="cpu", timeout=MESH_GRID_TIMEOUT)
    return make_mesh(shape, ("data", "model"), device="cpu")


@pytest.fixture(scope="module", autouse=True)
def _close_at_end():
    yield
    close_grids()


EPS = 1e-6


def _opt():
    return AdamWConfig(lr=warmup_cosine(3e-3, 2, 10), eps=EPS)


def _close(got, want, what):
    for i, (g, w) in enumerate(zip(leaves(got), leaves(want))):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), rtol=TOL,
                                   atol=TOL, err_msg=f"{what} leaf {i}")


_RUNS = {}


def _trained(arch, acc):
    """Three steps on the 2 x 2 grid, the reference and the port's one
    device, from the reference's weights: (model, handles, each side's
    final state, metrics)."""
    key = (arch, acc)
    if key in _RUNS:
        return _RUNS[key]
    rmodel, rparams, pmodel, pparams = lm_pair(arch)
    mesh = _grid((2, 2))
    model = Transformer(pmodel.cfg, device="cpu", mesh=mesh)
    params = mesh_train.put_params(
        model, jax.tree.map(np.asarray, rparams))
    opt = mesh_train.init_opt(model, params)
    step = make_train_step(model, _opt(), acc)
    r_step = jax.jit(ref_make_train_step(
        rmodel, RefAdamWConfig(lr=ref_warmup_cosine(3e-3, 2, 10), eps=EPS),
        acc))
    one = make_train_step(pmodel, _opt(), acc)
    rp, ro = rparams, ref_adamw_init(rparams)
    p1 = tree_map(lambda t: t.detach().clone(), pparams)
    o1 = adamw_init(p1)
    metrics = []
    for s in range(3):
        b = synthetic_lm_batch(pmodel.cfg, s, batch=B, seq=S)
        rp, ro, rm = r_step(rp, ro, {k: jnp.asarray(v) for k, v in b.items()})
        p1, o1, m1 = one(p1, o1, b)
        params, opt, m = step(params, opt, b)
        metrics.append((m, m1, rm, dict(step.last)))
    _RUNS[key] = (model, params, opt, (rp, ro), (p1, o1), metrics)
    return _RUNS[key]


@pytest.mark.parametrize("arch,acc", CASES)
def test_mesh_steps_match_one_device_and_reference(arch, acc):
    model, params, opt, (rp, ro), (p1, o1), metrics = _trained(arch, acc)
    for m, m1, rm, _ in metrics:
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(m[k]), float(m1[k]), rtol=TOL,
                                       atol=TOL)
            np.testing.assert_allclose(float(m[k]), float(rm[k]), rtol=TOL,
                                       atol=TOL)
    full = resident.gather_tree(params)
    fopt = resident.gather_tree(opt)
    _close(full, p1, "param vs one device")
    _close(full, jax.tree.leaves(rp), "param vs reference")
    for k in ("mu", "nu"):
        _close(fopt[k], o1[k], f"{k} vs one device")
        _close(fopt[k], jax.tree.leaves(ro[k]), f"{k} vs reference")
    assert int(fopt["count"]) == 3


@pytest.mark.parametrize("arch,acc", CASES)
def test_mesh_blocks_heads_and_wire_bytes(arch, acc):
    """Each rank's blocks are the specs' local shapes; each rank's
    attention ran on H / M query heads (and KV / M, or granite's one KV
    head gathered whole); the wire bytes of every step are the count made
    from the specs."""
    model, params, opt, _, _, metrics = _trained(arch, acc)
    want = [h.struct.local_shape for h in leaves(params)]
    for rank, shapes in resident.block_shapes(params).items():
        assert shapes == want, rank
    cfg = model.cfg
    heads = mesh_train.attention_heads(model)
    kv = cfg.n_kv // 2 if cfg.n_kv % 2 == 0 else cfg.n_kv
    assert heads == [(cfg.n_heads // 2, kv)] * 4
    assert model.tp["heads_local"] and model.tp["ff_local"]
    assert model.tp["kv_local"] == (arch == "qwen3-1.7b")
    predicted = mesh_train.wire_bytes(model, B, S, acc)
    for *_, last in metrics:
        assert last["wire"] == predicted
    assert predicted["all_gather"] > 0 and predicted["reduce_scatter"] > 0


def test_checkpoint_saved_on_the_grid_restores_on_one_device(tmp_path):
    model, params, opt, _, _, _ = _trained("qwen3-1.7b", 4)
    tree = {"params": params, "opt": opt}
    save_tree(str(tmp_path / "ck"), tree)
    full = {"params": resident.gather_tree(params),
            "opt": resident.gather_tree(opt)}
    one = Transformer(model.cfg, device="cpu")
    like = {"params": one.init(1), "opt": adamw_init(one.init(1))}
    got = restore_tree(str(tmp_path / "ck"), like, device="cpu")
    for g, w in zip(leaves(got), leaves(full)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # back onto the same grid, in place: nothing changes
    restore_tree(str(tmp_path / "ck"), tree, device="cpu", into=True)
    for g, w in zip(leaves(resident.gather_tree(params)),
                    leaves(full["params"])):
        np.testing.assert_array_equal(g, w)


def test_trainer_on_the_grid_restore_rollback_and_preemption(tmp_path):
    _, _, pmodel, pparams = lm_pair("qwen3-1.7b")
    mesh = _grid((2, 2))
    model = Transformer(pmodel.cfg, device="cpu", mesh=mesh)
    structs = param_shardings(model, mesh)[0]

    def make(params, opt, step_fn, ckpt_every=2):
        return Trainer(TrainerConfig(ckpt_dir=str(tmp_path), ckpt_every=
                                     ckpt_every, async_ckpt=False),
                       step_fn, lambda s: synthetic_lm_batch(
                           pmodel.cfg, s, batch=B, seq=S), params, opt)
    params = mesh_train.put_params(model, pparams)
    opt = mesh_train.init_opt(model, params)
    step = make_train_step(model, _opt(), 4)
    tr = make(params, opt, step)
    tr.run(2)
    saved = resident.gather_tree(params)
    # restore(shardings=) into a fresh trainer's state on the same grid
    p2 = mesh_train.put_params(model, pparams)
    tr2 = make(p2, mesh_train.init_opt(model, p2), step)
    shardings = {"params": structs,
                 "opt": opt_shardings(structs, mesh,
                                      param_shardings(model, mesh)[2]),
                 "step": None}
    assert tr2.restore(shardings=shardings) == 2
    for g, w in zip(leaves(resident.gather_tree(p2)), leaves(saved)):
        np.testing.assert_array_equal(g, w)

    # a NaN at step 3 rolls back to step 2's checkpoint (the grid's blocks
    # written in place) and skips batch 3
    def nan_at_3(params, opt_state, batch):
        out = step(params, opt_state, batch)
        if tr3.step == 3:
            return out[0], out[1], {**out[2], "loss": torch.tensor(np.nan)}
        return out
    tr3 = make(p2, tr2.opt_state, nan_at_3, ckpt_every=100)
    tr3.step = 2
    hist = tr3.run(3)
    assert [h["step"] for h in hist] == [2, 2, 4]
    assert tr3._rollbacks == 1
    np.testing.assert_allclose(hist[0]["loss"], hist[1]["loss"], rtol=1e-6)

    # preemption: a SIGTERM during step 5 saves step 6 synchronously
    def term_at_5(params, opt_state, batch):
        if tr3.step == 5:
            os.kill(os.getpid(), signal.SIGTERM)
        return step(params, opt_state, batch)
    tr3.step_fn = term_at_5
    old = signal.getsignal(signal.SIGTERM)
    try:
        hist = tr3.run(10)
    finally:
        signal.signal(signal.SIGTERM, old)
    assert hist[-1]["step"] == 5 and tr3.ckpt.latest_step() == 6


def test_train_cli_mesh_and_resume(tmp_path, capsys):
    argv = ["--arch", "qwen3-1.7b", "--reduced", "--batch", "4", "--seq",
            "32", "--device", "cpu", "--ckpt-dir", str(tmp_path)]
    h1 = train_mod.main(argv + ["--mesh", "2,2", "--steps", "3"])
    h2 = train_mod.main(argv + ["--mesh", "2,2", "--steps", "2",
                                "--resume"])
    h3 = train_mod.main(argv + ["--steps", "1", "--resume"])
    assert [h["step"] for h in h1 + h2 + h3] == [0, 1, 2, 3, 4, 5]
    assert all(np.isfinite(h["loss"]) for h in h1 + h2 + h3)
    assert capsys.readouterr().out.count("resumed at step") == 2


def test_prefill_and_decode_on_a_mesh_refuse_by_name():
    """A model that only describes a mesh refuses prefill, decode and
    training by the rank route that runs them (their parity over a grid:
    ``test_torch_mesh_serve.py``); paged decode refuses a mesh by name --
    it runs on one device, as the reference's."""
    cfg = reduced(get_config("qwen3-1.7b"))
    model = Transformer(cfg, device="cpu",
                        mesh=make_mesh((1, 2), ("data", "model"),
                                       device="cpu"))
    toks = np.zeros((2, 8), np.int32)
    with pytest.raises(RuntimeError, match="make_prefill_step"):
        model.prefill(None, {"tokens": toks}, 16)
    with pytest.raises(RuntimeError, match="make_decode_step"):
        model.decode_step(None, {"pos": 8}, {"tokens": toks[:, :1]})
    with pytest.raises(RuntimeError, match="mesh's ranks"):
        model.train_loss(None, {"tokens": toks, "labels": toks})
    with pytest.raises(NotImplementedError, match="paged decode runs on "
                       "one device"):
        model.decode_step_paged(None, None, {"tokens": toks[:, :1]}, None,
                                None, None)


def test_token_pipeline_hands_each_rank_its_rows():
    cfg = reduced(get_config("qwen3-1.7b"))
    mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
    specs = batch_specs(cfg, ShapeConfig("t", 16, 4, "train"), mesh)
    for rank in range(4):
        c = mesh.coords(rank)
        pipe = TokenPipeline(lambda s: synthetic_lm_batch(cfg, s, batch=4,
                                                          seq=16),
                             sharding=(specs, c))
        step, got = next(pipe)
        pipe.close()
        whole = synthetic_lm_batch(cfg, step, batch=4, seq=16)
        lo = 2 * c["data"]
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(got[k], whole[k][lo:lo + 2])
        assert shard_batch(whole, specs, c)["tokens"].shape == (2, 16)


# ---------------------------------------------------------------------------
# another grid shape: 4 x 1 (these run last; the 2 x 2 grid closes)
# ---------------------------------------------------------------------------

def test_checkpoint_reshards_bitwise_onto_4x1(tmp_path):
    model, params, opt, _, _, _ = _trained("qwen3-1.7b", 4)
    save_tree(str(tmp_path / "ck"), {"params": params, "opt": opt})
    full = {"params": resident.gather_tree(params),
            "opt": resident.gather_tree(opt)}
    mesh = _grid((4, 1))
    m41 = Transformer(model.cfg, device="cpu", mesh=mesh)
    structs, _, specs = param_shardings(m41, mesh)
    shard = {"params": structs, "opt": opt_shardings(structs, mesh, specs)}
    got = restore_tree(str(tmp_path / "ck"), shard, shardings=shard,
                       device="cpu")
    assert isinstance(leaves(got)[0], resident.ShardedLeaf)
    back = {"params": resident.gather_tree(got["params"]),
            "opt": resident.gather_tree(got["opt"])}
    for g, w in zip(leaves(back), leaves(full)):
        np.testing.assert_array_equal(g, w)
    shapes = resident.block_shapes(got["params"])
    assert shapes[3] == [h.struct.local_shape
                         for h in leaves(got["params"])]


def test_reference_checkpoint_restores_onto_the_grid(tmp_path):
    rmodel, rparams, pmodel, _ = lm_pair("qwen3-1.7b")
    ref_save_tree(str(tmp_path / "ref"), {"params": rparams,
                                          "opt": ref_adamw_init(rparams)})
    mesh = _grid((4, 1))
    model = Transformer(pmodel.cfg, device="cpu", mesh=mesh)
    structs, _, specs = param_shardings(model, mesh)
    shard = {"params": structs, "opt": opt_shardings(structs, mesh, specs)}
    got = restore_tree(str(tmp_path / "ref"), shard, shardings=shard,
                       device="cpu")
    for g, w in zip(leaves(resident.gather_tree(got["params"])),
                    jax.tree.leaves(rparams)):
        np.testing.assert_array_equal(g, np.asarray(w))
    # and trains on from there as one device does
    step = make_train_step(model, _opt(), 4)
    b = synthetic_lm_batch(pmodel.cfg, 0, batch=B, seq=S)
    _, _, m = step(got["params"], got["opt"], b)
    one = make_train_step(pmodel, _opt(), 4)
    p1 = tree_map(lambda t: t.detach().clone(), lm_pair("qwen3-1.7b")[3])
    _, _, m1 = one(p1, adamw_init(p1), b)
    np.testing.assert_allclose(float(m["loss"]), float(m1["loss"]),
                               rtol=TOL, atol=TOL)
    assert dataclasses.is_dataclass(resident.ShardedLeaf)


# ---------------------------------------------------------------------------
# a 2 x 1 grid (after the 4 x 1 cases)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", FAMILIES_13D)
def test_other_families_refuse_by_name(arch, tmp_path):
    """The six families that a mesh refused by name before their sharded
    compute (the name is that case's) train on one: two steps of
    ``make_train_step`` on a 2 x 1 grid (the batch's rows -- frame
    embeddings, stub encoder states -- split over "data"), then a step of
    the CLI's ``--mesh 2,1`` and one of its ``--resume``, every loss
    finite."""
    cfg = reduced(get_config(arch))
    mesh = _grid((2, 1))
    model = Transformer(cfg, device="cpu", mesh=mesh)
    params, opt = mesh_train.init_on_mesh(model, 0)
    step = make_train_step(model, _opt())
    for s in range(2):
        params, opt, m = step(params, opt, synthetic_lm_batch(
            cfg, s, batch=2, seq=8))
        assert np.isfinite(float(m["loss"]))
        assert np.isfinite(float(m["grad_norm"]))
    resident.free(params)
    resident.free(opt)
    argv = ["--arch", arch, "--reduced", "--mesh", "2,1", "--batch", "2",
            "--seq", "8", "--device", "cpu", "--ckpt-dir", str(tmp_path)]
    hist = (train_mod.main(argv + ["--steps", "1"])
            + train_mod.main(argv + ["--steps", "1", "--resume"]))
    assert [h["step"] for h in hist] == [0, 1]
    assert all(np.isfinite(h["loss"]) for h in hist)

"""The port's fault-tolerant trainer (``repro_torch.runtime``) and token
pipeline (``repro_torch.data.tokens``) on the CPU: the cases of
``tests/test_runtime.py`` on the port's ``Trainer``; checkpoints that one
package's trainer wrote, restored by the other's, after which the next
steps match (reduced Qwen3, float32 compute: losses at 1e-5, parameters at
1e-4); ``synthetic_token_batch`` bitwise the reference's."""
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import synthetic_token_batch as ref_token_batch
from repro.launch.steps import make_train_step as ref_make_train_step
from repro.optim import AdamWConfig as RefAdamWConfig
from repro.optim import adamw_init as ref_adamw_init
from repro.runtime import Trainer as RefTrainer
from repro.runtime import TrainerConfig as RefTrainerConfig
from repro_torch.data import TokenPipeline, synthetic_token_batch
from repro_torch.launch.steps import make_train_step
from repro_torch.models.transformer import tree_map
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.core.util import tree_leaves as leaves
from repro_torch.runtime import Trainer, TrainerConfig
from test_torch_common import lm_pair

LOSS_TOL = 1e-5
PARAM_TOL = 1e-4


def quad_step_factory(poison_steps=(), slow_steps=(), delay=0.08):
    """Toy quadratic 'training': params -> params - 0.1*grad."""
    def step_fn(params, opt_state, batch):
        if int(batch["step"]) in slow_steps:
            time.sleep(delay)
        g = params["w"] - batch["target"]
        loss = torch.sum(g * g)
        if int(batch["step"]) in poison_steps:
            loss = torch.tensor(float("nan"))
        return ({"w": params["w"] - 0.1 * g}, opt_state, {"loss": loss})
    return step_fn


def make_batch(step):
    return {"step": step, "target": torch.ones(4)}


def test_loss_decreases_and_ckpt_resume(tmp_path):
    tr = Trainer(TrainerConfig(ckpt_dir=str(tmp_path), ckpt_every=5,
                               async_ckpt=False),
                 quad_step_factory(), make_batch, {"w": torch.zeros(4)}, {})
    hist = tr.run(20)
    assert hist[-1]["loss"] < hist[0]["loss"]
    # fresh trainer resumes from the synced final checkpoint
    tr2 = Trainer(TrainerConfig(ckpt_dir=str(tmp_path), ckpt_every=5),
                  quad_step_factory(), make_batch, {"w": torch.zeros(4)}, {})
    assert tr2.restore() == 20
    np.testing.assert_allclose(tr2.params["w"].numpy(),
                               tr.params["w"].numpy())


def test_nan_rollback_and_skip(tmp_path):
    tr = Trainer(TrainerConfig(ckpt_dir=str(tmp_path), ckpt_every=3,
                               async_ckpt=False),
                 quad_step_factory(poison_steps={7}), make_batch,
                 {"w": torch.zeros(4)}, {})
    hist = tr.run(15)
    steps_seen = [h["step"] for h in hist]
    assert 7 not in steps_seen          # poisoned batch skipped
    assert tr.step == 15
    assert all(np.isfinite(h["loss"]) for h in hist)


def test_nan_storm_aborts(tmp_path):
    tr = Trainer(TrainerConfig(ckpt_dir=str(tmp_path), ckpt_every=2,
                               async_ckpt=False, max_rollbacks=2),
                 quad_step_factory(poison_steps=set(range(3, 30))),
                 make_batch, {"w": torch.zeros(4)}, {})
    with pytest.raises(RuntimeError, match="rollbacks"):
        tr.run(20)


def test_straggler_detection(tmp_path):
    tr = Trainer(TrainerConfig(ckpt_dir=str(tmp_path), ckpt_every=100,
                               async_ckpt=False, straggler_factor=3.0),
                 quad_step_factory(slow_steps={10}, delay=0.15), make_batch,
                 {"w": torch.zeros(4)}, {})
    tr.run(15)
    assert 10 in tr.stragglers


def test_preemption_signal_saves_and_stops(tmp_path):
    """SIGTERM between steps: the trainer stops at the next boundary and
    writes a synchronous checkpoint of the step it reached."""
    import os
    import signal

    def step_fn(params, opt_state, batch):
        if batch["step"] == 3:
            os.kill(os.getpid(), signal.SIGTERM)
        return quad_step_factory()(params, opt_state, batch)
    old = signal.getsignal(signal.SIGTERM), signal.getsignal(signal.SIGINT)
    try:
        tr = Trainer(TrainerConfig(ckpt_dir=str(tmp_path), ckpt_every=100),
                     step_fn, make_batch, {"w": torch.zeros(4)}, {})
        hist = tr.run(10)
    finally:
        signal.signal(signal.SIGTERM, old[0])
        signal.signal(signal.SIGINT, old[1])
    assert [h["step"] for h in hist] == [0, 1, 2, 3]
    assert tr.ckpt.latest_step() == 4


def test_restore_writes_into_the_trainers_tensors(tmp_path):
    w = torch.zeros(4)
    tr = Trainer(TrainerConfig(ckpt_dir=str(tmp_path), async_ckpt=False),
                 quad_step_factory(), make_batch, {"w": w}, {})
    tr.run(3)
    tr2 = Trainer(TrainerConfig(ckpt_dir=str(tmp_path)), quad_step_factory(),
                  make_batch, {"w": w}, {})
    assert tr2.restore() == 3
    assert tr2.params["w"] is w
    torch.testing.assert_close(w, tr.params["w"])
    # shardings= (once refused, naming ROADMAP item 13c): a None sharding
    # restores into the trainer's own tensor as before; the re-shard onto
    # a grid is test_torch_mesh_train.py's
    w.zero_()
    assert tr2.restore(shardings={"params": {"w": None}, "opt": {},
                                  "step": None}) == 3
    assert tr2.params["w"] is w
    torch.testing.assert_close(w, tr.params["w"])


# ---------------------------------------------------------------------------
# checkpoints across the two packages' trainers (reduced Qwen3)
# ---------------------------------------------------------------------------

def _lm_batch(step):
    return synthetic_token_batch(step, batch=4, seq=32, vocab=256)


def _ref_trainer(rmodel, rparams, ckpt_dir):
    step = jax.jit(ref_make_train_step(rmodel, RefAdamWConfig(lr=3e-3), 2))
    return RefTrainer(RefTrainerConfig(ckpt_dir=ckpt_dir, ckpt_every=2,
                                       async_ckpt=False),
                      step, lambda s: {k: jnp.asarray(v) for k, v in
                                       _lm_batch(s).items()},
                      rparams, ref_adamw_init(rparams))


def _port_trainer(pmodel, pparams, ckpt_dir):
    params = tree_map(lambda t: t.detach().clone(), pparams)
    step = make_train_step(pmodel, AdamWConfig(lr=3e-3), 2)
    return Trainer(TrainerConfig(ckpt_dir=ckpt_dir, ckpt_every=2),
                   step, _lm_batch, params, adamw_init(params))


def _same_next_steps(first, second, tmp_path):
    """``first`` trains 3 steps (checkpoints at 2 and 3); a fresh
    ``second`` restores step 3 and trains 2 more, as ``first`` does."""
    h1 = first.run(3)
    assert [h["step"] for h in h1] == [0, 1, 2]
    assert second.restore() == 3
    h_first = first.run(2)[-2:]        # a trainer's history accumulates
    h_second = second.run(2)
    assert [h["step"] for h in h_second] == [3, 4]
    for a, b in zip(h_first, h_second):
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=LOSS_TOL,
                                   atol=LOSS_TOL)
    return first, second


def test_reference_trainer_checkpoint_restores_in_the_port(tmp_path):
    rmodel, rparams, pmodel, pparams = lm_pair("qwen3-1.7b")
    ref, mine = _same_next_steps(
        _ref_trainer(rmodel, rparams, str(tmp_path)),
        _port_trainer(pmodel, pparams, str(tmp_path)), tmp_path)
    for g, w in zip(leaves(mine.params), jax.tree.leaves(ref.params)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=PARAM_TOL,
                                   atol=PARAM_TOL)
    assert int(mine.opt_state["count"]) == 5


def test_port_trainer_checkpoint_restores_in_the_reference(tmp_path):
    rmodel, rparams, pmodel, pparams = lm_pair("qwen3-1.7b")
    mine, ref = _same_next_steps(
        _port_trainer(pmodel, pparams, str(tmp_path)),
        _ref_trainer(rmodel, jax.tree.map(jnp.zeros_like, rparams),
                     str(tmp_path)), tmp_path)
    for g, w in zip(leaves(mine.params), jax.tree.leaves(ref.params)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=PARAM_TOL,
                                   atol=PARAM_TOL)


# ---------------------------------------------------------------------------
# the token pipeline
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("step,shard", [(0, (0, 1)), (7, (0, 1)),
                                        (3, (1, 2)), (11, (3, 4))])
def test_synthetic_token_batch_bitwise(step, shard):
    mine = synthetic_token_batch(step, batch=8, seq=16, vocab=1000, seed=5,
                                 shard=shard)
    want = ref_token_batch(step, batch=8, seq=16, vocab=1000, seed=5,
                           shard=shard)
    for k in ("tokens", "labels"):
        assert mine[k].dtype == want[k].dtype == np.int32
        np.testing.assert_array_equal(mine[k], want[k])
    np.testing.assert_array_equal(mine["tokens"][:, 1:],
                                  mine["labels"][:, :-1])


def test_sharded_rows_are_the_global_rows():
    full = synthetic_token_batch(2, batch=8, seq=4, vocab=50)
    parts = [synthetic_token_batch(2, batch=8, seq=4, vocab=50,
                                   shard=(i, 4))["tokens"] for i in range(4)]
    np.testing.assert_array_equal(np.concatenate(parts), full["tokens"])


@pytest.mark.parametrize("device", [None, "cpu"])
def test_token_pipeline_order(device):
    def mk(step):
        return synthetic_token_batch(step, batch=2, seq=4, vocab=50)
    pipe = TokenPipeline(mk, start_step=5, device=device)
    try:
        for want in range(5, 11):
            step, batch = next(pipe)
            assert step == want
            if device is None:
                np.testing.assert_array_equal(batch["tokens"],
                                              mk(step)["tokens"])
            else:
                assert isinstance(batch["tokens"], torch.Tensor)
                assert batch["tokens"].device.type == "cpu"
                np.testing.assert_array_equal(batch["tokens"].numpy(),
                                              mk(step)["tokens"])
    finally:
        pipe.close()


def test_run_puts_the_signal_handlers_back(tmp_path):
    """A handler left installed would keep the trainer (its parameters and
    optimizer state) alive after the caller dropped it."""
    import gc
    import signal
    import weakref
    before = signal.getsignal(signal.SIGTERM)
    tr = Trainer(TrainerConfig(ckpt_dir=str(tmp_path), async_ckpt=False),
                 quad_step_factory(), make_batch, {"w": torch.zeros(4)}, {})
    tr.run(2)
    assert signal.getsignal(signal.SIGTERM) is before
    ref = weakref.ref(tr)
    del tr
    gc.collect()
    assert ref() is None

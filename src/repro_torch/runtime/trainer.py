"""Fault-tolerant training loop (the port of ``repro/runtime/trainer.py``).

  * periodic async checkpointing (atomic, keep-N), in the reference's
    layout: ``{"params", "opt", "step"}``, so a directory written by
    either package's trainer restores in the other;
  * NaN/Inf guard: a bad step triggers a rollback to the last checkpoint
    and skips the offending batch (the pipeline is deterministic, so the
    same data is never retried blindly); too many rollbacks (a NaN storm)
    abort;
  * preemption: SIGTERM/SIGINT request a synchronous save at the next
    step boundary before stopping;
  * straggler surveillance: per-step wall times feed an EMA; steps slower
    than ``straggler_factor`` x EMA are logged with their step index;
  * ``restore`` reads the newest checkpoint back into the trainer's own
    tensors, on their device; ``shardings=`` (the reference's elastic
    re-scale) lays the restored tree over a mesh instead
    (``checkpoint.restore_tree``).

The parameters and optimizer state may be trees resident on a mesh
(``sharding/resident.py::ShardedLeaf`` handles, the step of
``make_train_step`` on a sharded model): checkpoints gather them to the
full-array format, restores (the NaN rollback's too) scatter the blocks
back into the ranks' own tensors, and a preemption saves the same way.
"""
from __future__ import annotations

import dataclasses
import logging
import signal
import time
from typing import Any, Callable, Dict

import numpy as np
import torch

from ..checkpoint import CheckpointManager
from ..core.util import tree_leaves

log = logging.getLogger("repro_torch.trainer")


@dataclasses.dataclass
class TrainerConfig:
    ckpt_dir: str
    ckpt_every: int = 100
    keep_n: int = 3
    async_ckpt: bool = True
    straggler_factor: float = 2.0
    max_rollbacks: int = 3
    log_every: int = 10


class Trainer:
    """Runs ``step_fn(params, opt_state, batch) -> (params, opt_state,
    metrics)`` on ``make_batch(step)`` for global steps from
    ``start_step``; ``metrics["loss"]`` is read on the host every step.
    The checkpoints' tensors live on the device of the first parameter
    leaf (the CPU when there is none)."""

    def __init__(self, cfg: TrainerConfig, step_fn: Callable,
                 make_batch: Callable[[int], Any],
                 params, opt_state, start_step: int = 0):
        self.cfg = cfg
        self.step_fn = step_fn
        self.make_batch = make_batch
        self.params = params
        self.opt_state = opt_state
        self.step = start_step
        ps = [p for p in tree_leaves(params) if isinstance(p, torch.Tensor)]
        self.device = ps[0].device if ps else torch.device("cpu")
        self.ckpt = CheckpointManager(cfg.ckpt_dir, keep_n=cfg.keep_n)
        self._preempted = False
        self._rollbacks = 0
        self._ema = None
        self.skip_steps: set[int] = set()
        self.stragglers: list[int] = []
        self.history: list[Dict[str, float]] = []

    # ---- fault tolerance ----
    def _install_signals(self):
        """Install the preemption handlers; returns the ones they replace
        (``{}`` off the main thread)."""
        def handler(signum, frame):
            log.warning("preemption signal %s: will checkpoint and stop",
                        signum)
            self._preempted = True
        old = {}
        try:
            for sig in (signal.SIGTERM, signal.SIGINT):
                old[sig] = signal.signal(sig, handler)
        except ValueError:
            pass   # not on the main thread (tests)
        return old

    def _tree(self):
        return {"params": self.params, "opt": self.opt_state,
                "step": torch.tensor(self.step, dtype=torch.int32,
                                     device=self.device)}

    def _save(self, sync=False):
        if self.cfg.async_ckpt and not sync:
            self.ckpt.save_async(self.step, self._tree())
        else:
            self.ckpt.save(self.step, self._tree())

    def restore(self, shardings=None):
        """Load the newest checkpoint into the trainer's tensors (or, with
        ``shardings`` -- a tree mirroring ``{"params", "opt", "step"}``,
        or a prefix of it -- onto a mesh by those shardings); returns its
        step."""
        step, tree = self.ckpt.restore(self._tree(), shardings=shardings,
                                       device=self.device, into=True)
        self.params, self.opt_state = tree["params"], tree["opt"]
        self.step = int(tree["step"])
        return step

    def _rollback(self, bad_step: int):
        self._rollbacks += 1
        if self._rollbacks > self.cfg.max_rollbacks:
            raise RuntimeError(
                f"aborting: {self._rollbacks} rollbacks (NaN storm)")
        self.ckpt.wait()
        restored = self.restore()
        # skip past the offending batch: replay from the checkpoint but
        # never feed the bad step's batch again
        log.warning("rolled back to step %d after NaN at step %d; "
                    "bad batch will be skipped", restored, bad_step)
        self.skip_steps = {bad_step}

    # ---- main loop ----
    def run(self, num_steps: int):
        """Train ``num_steps`` global steps from ``self.step``; returns the
        history of every step this trainer ran.  The signal handlers it
        installs are put back when it returns: a handler left installed
        would hold the trainer -- its parameters and optimizer state on
        the device -- alive after the caller dropped it."""
        old = self._install_signals()
        try:
            return self._run(num_steps)
        finally:
            for sig, h in old.items():
                signal.signal(sig, h)

    def _run(self, num_steps: int):
        self.skip_steps = set()
        end = self.step + num_steps
        while self.step < end and not self._preempted:
            s = self.step
            if s in self.skip_steps:
                self.step += 1
                continue
            batch = self.make_batch(s)
            t0 = time.perf_counter()
            params, opt_state, metrics = self.step_fn(
                self.params, self.opt_state, batch)
            loss = float(metrics["loss"])
            dt = time.perf_counter() - t0

            if not np.isfinite(loss):
                log.error("non-finite loss %.3g at step %d", loss, s)
                self._rollback(s)
                continue

            self.params, self.opt_state = params, opt_state
            self.step += 1
            self._track_time(s, dt)
            self.history.append({"step": s, "loss": loss, "time_s": dt,
                                 **{k: float(v) for k, v in metrics.items()
                                    if k != "loss"}})
            if self.step % self.cfg.log_every == 0:
                log.info("step %d loss %.4f (%.0f ms)", self.step, loss,
                         dt * 1e3)
            if self.step % self.cfg.ckpt_every == 0:
                self._save()

        self.ckpt.wait()
        self._save(sync=True)
        return self.history

    def _track_time(self, step: int, dt: float):
        if self._ema is None:
            self._ema = dt
        if dt > self.cfg.straggler_factor * self._ema and step > 2:
            self.stragglers.append(step)
            log.warning("straggler step %d: %.0f ms (ema %.0f ms)",
                        step, dt * 1e3, self._ema * 1e3)
        self._ema = 0.9 * self._ema + 0.1 * dt

"""Training loop with checkpoint/restart fault tolerance.

The loop owns: the train step, the checkpoint manager (async saves every
``checkpoint_every`` steps), the deterministic step-indexed data stream,
metric logging, and the recovery path -- any exception classified as a
*failure* (``InjectedFailure`` here; device errors in production) triggers
restore-from-latest-committed and replay. Because batches are pure
functions of the step index and all step randomness is folded from
(key, step), the trajectory after a recovery is bit-identical to an
uninterrupted run. The step runs eagerly (the reference jits it and
donates the state; the port's step is functional, so the state it starts
from stays valid).
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Any, Callable, Optional

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.ft.failures import FailureInjector, InjectedFailure


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int
    checkpoint_dir: str
    checkpoint_every: int = 100
    keep_checkpoints: int = 3
    log_every: int = 10
    async_checkpoint: bool = True
    max_recoveries: int = 10


class Trainer:
    def __init__(self, tcfg: TrainerConfig,
                 step_fn: Callable,                    # (state, batch) -> (state, metrics)
                 batch_fn: Callable[[int], Any],       # step index -> batch
                 init_state: Any, failure_injector: Optional[FailureInjector] = None):
        self.tcfg = tcfg
        self.step_fn = step_fn
        self.batch_fn = batch_fn
        self._template = init_state
        self.state = init_state
        self.ckpt = CheckpointManager(tcfg.checkpoint_dir, keep=tcfg.keep_checkpoints,
                                      async_save=tcfg.async_checkpoint)
        self.injector = failure_injector
        self.history: list[dict] = []
        self.recoveries = 0

    # -- recovery -----------------------------------------------------------
    def _restore_latest(self) -> int:
        latest = self.ckpt.latest_step()
        assert latest is not None, "run() always commits a step-0 checkpoint"
        self.state = self.ckpt.restore(self._template)
        return latest

    def current_step(self) -> int:
        return int(self.state["step"])

    # -- main loop ------------------------------------------------------------
    def run(self) -> list[dict]:
        step = self.current_step()
        if self.ckpt.latest_step() is None:
            # Commit the initial state synchronously: recovery is then always
            # restore-from-checkpoint.
            self.ckpt.save(step, self.state, block=True)
        while step < self.tcfg.total_steps:
            try:
                step = self._run_from(step)
            except InjectedFailure as e:
                self.recoveries += 1
                if self.recoveries > self.tcfg.max_recoveries:
                    raise RuntimeError("recovery budget exhausted") from e
                self.ckpt.wait()
                step = self._restore_latest()
        self.ckpt.save(step, self.state, block=True)
        self.ckpt.wait()
        return self.history

    def _run_from(self, step: int) -> int:
        while step < self.tcfg.total_steps:
            if self.injector is not None:
                self.injector.check(step)
            batch = self.batch_fn(step)
            t0 = time.perf_counter()
            self.state, metrics = self.step_fn(self.state, batch)
            if step % self.tcfg.log_every == 0 or step == self.tcfg.total_steps - 1:
                m = {k: float(v) for k, v in metrics.items()}
                m.update(step=step, wall_s=time.perf_counter() - t0)
                self.history.append(m)
            step += 1
            if step % self.tcfg.checkpoint_every == 0:
                self.ckpt.save(step, self.state)
        return step

    def save_history(self, path: str) -> None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.history, f, indent=1)

"""Fault-tolerant training loop: checkpoint/restart, stragglers, SIGTERM.

This package's port of the JAX package's ``train/trainer.py``: host-side
control logic around ``train.step.make_train_step``.
  - periodic async checkpoints (atomic, keep-N) + final blocking flush;
  - SIGTERM/SIGINT handler checkpoints before exit (preemption safety);
  - deterministic resume: the data pipeline is seekable by step, so
    restarting from step k replays the identical stream;
  - straggler monitor: per-step wall time EWMA; steps slower than
    ``straggler_factor`` x EWMA increment a counter and invoke a policy
    callback;
  - NaN guard: a non-finite loss aborts with the last good checkpoint
    intact.

Under ``distributed.sharding.use_rules(rules)`` whose mesh has more than
one slot (as ``launch.train --host-mesh`` runs it), the state is placed
on the mesh (``step.place_train_state``) before a checkpoint is restored
into it, and every step runs on the mesh (``step.make_train_step``).

Three differences from the reference: when the last periodic save
already holds the final step, the final flush waits for it instead of
writing the same checkpoint again; ``run`` puts back the signal handlers
it replaced when it returns; and with no ``ckpt_dir`` a trainer writes to
a new directory of its own under the temporary directory (the reference
shares one fixed path, from which any run would resume).
"""
from __future__ import annotations

import dataclasses
import signal
import tempfile
import time
from typing import Callable, Optional

import numpy as np

from ..checkpoint.manager import CheckpointManager
from ..distributed.sharding import active_rules
from .step import (TrainState, init_state, make_train_step,
                   place_train_state)


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    ckpt_every: int = 50
    ckpt_dir: Optional[str] = None      # None: a new temporary directory
    keep_n: int = 3
    microbatches: int = 1
    log_every: int = 10
    straggler_factor: float = 3.0
    ewma_alpha: float = 0.1


class Trainer:
    def __init__(self, model, optimizer, data_fn: Callable,
                 cfg: TrainerConfig, *, seed=0, device=None,
                 straggler_cb: Optional[Callable] = None):
        """``seed``: an int or a ``torch.Generator`` for ``Model.init``;
        ``device``: where the state lives (``None``: the card)."""
        self.model = model
        self.optimizer = optimizer
        self.data_fn = data_fn          # step -> batch
        self.cfg = cfg
        ckpt_dir = cfg.ckpt_dir
        if ckpt_dir is None:
            ckpt_dir = tempfile.mkdtemp(prefix="repro_ckpt_")
            print(f"[trainer] checkpoints in {ckpt_dir}")
        self.ckpt = CheckpointManager(ckpt_dir, keep_n=cfg.keep_n)
        self.straggler_cb = straggler_cb
        self.straggler_events = 0
        self.history: list = []
        self._stop = False
        self.train_step = make_train_step(model, optimizer,
                                          microbatches=cfg.microbatches)
        self.seed = seed
        self.device = device

    # ---------------------------------------------------------------- state
    def init_or_restore(self) -> TrainState:
        state = init_state(self.model, self.optimizer, self.seed,
                           self.device)
        rules = active_rules()
        if rules is not None and rules.mesh.size > 1:
            state = place_train_state(state, rules)
        latest = self.ckpt.latest_step()
        if latest is not None:
            state = self.ckpt.restore(state, step=latest)
            print(f"[trainer] resumed from step {latest}")
        return state

    # ---------------------------------------------------------------- loop
    def _install_signal_handlers(self) -> dict:
        def handler(signum, frame):
            print(f"[trainer] signal {signum}: checkpoint + stop")
            self._stop = True
        previous = {}
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                previous[sig] = signal.signal(sig, handler)
            except ValueError:
                pass                     # non-main thread (tests)
        return previous

    def run(self, state: Optional[TrainState] = None) -> TrainState:
        previous = self._install_signal_handlers()
        try:
            return self._run(state)
        finally:
            for sig, h in previous.items():
                signal.signal(sig, h)

    def _run(self, state: Optional[TrainState]) -> TrainState:
        cfg = self.cfg
        if state is None:
            state = self.init_or_restore()
        start = int(state.step)
        ewma = None
        saved_at = None
        for step in range(start, cfg.total_steps):
            if self._stop:
                break
            batch = self.data_fn(step)
            t0 = time.monotonic()
            state, metrics = self.train_step(state, batch)
            loss = float(metrics["loss"])
            dt = time.monotonic() - t0

            if not np.isfinite(loss):
                self.ckpt.wait()
                raise FloatingPointError(
                    f"non-finite loss at step {step}; last good checkpoint "
                    f"= step {self.ckpt.latest_step()}")

            if step == start:
                pass                        # first step includes warm-up
            elif ewma is None:
                ewma = dt
            elif dt > cfg.straggler_factor * ewma and step > start + 2:
                self.straggler_events += 1
                if self.straggler_cb is not None:
                    self.straggler_cb(step, dt, ewma)
            else:
                ewma = (1 - cfg.ewma_alpha) * ewma + cfg.ewma_alpha * dt

            self.history.append({"step": step, "loss": loss, "time_s": dt})
            if step % cfg.log_every == 0:
                print(f"[trainer] step {step:6d} loss {loss:8.4f} "
                      f"({dt*1e3:.0f} ms)")
            if (step + 1) % cfg.ckpt_every == 0:
                self.ckpt.save(state, step + 1, blocking=False)
                saved_at = step + 1
        if saved_at == state.step:
            self.ckpt.wait()
        else:
            self.ckpt.save(state, state.step, blocking=True)
        return state

"""Training loop with the JAX package's fault-tolerance semantics
(counterpart of its ``train/trainer.py``), on one device.

- checkpoint/restart: atomic async checkpoints every ``ckpt_every``
  steps and at the last; on start, resume from the latest committed step
  (parameters and optimizer moments; the data cursor is the step itself,
  since a batch is a pure function of (seed, step)).  As in the
  reference, the error-feedback buffers of gradient compression are not
  saved: a resumed run starts them from zero;
- preemption: SIGTERM/SIGINT make the loop write a final synchronous
  checkpoint after the current step and stop;
- stragglers: each step's wall time is kept (on the card after
  ``torch.cuda.synchronize()``, so it is the step's own time and not its
  launch time); steps slower than ``straggler_factor`` x the running
  median of the last 50 are counted and logged.

A resume writes the restored values into the parameter and moment
tensors it was given, so ``model.params`` passed to :meth:`Trainer.run`
holds the resumed (and then the trained) values.
"""

from __future__ import annotations

import dataclasses
import os
import signal
import tempfile
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.ckpt.checkpoint import CheckpointManager
from repro_torch.data.synthetic import SyntheticTokens
from repro_torch.train.optim import AdamW
from repro_torch.train.train_step import make_train_step
from repro_torch.train.tree import leaves


@dataclasses.dataclass
class TrainerConfig:
    steps: int = 100
    ckpt_every: int = 25
    ckpt_dir: str = os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")
    keep_last: int = 3
    microbatches: int = 1
    compress_grads: bool = False
    log_every: int = 10
    straggler_factor: float = 2.0


class Trainer:
    def __init__(self, model, optimizer: AdamW, data: SyntheticTokens,
                 cfg: TrainerConfig, step_fn: Optional[Callable] = None):
        self.model = model
        self.optimizer = optimizer
        self.data = data
        self.cfg = cfg
        self.ckpt = CheckpointManager(cfg.ckpt_dir, cfg.keep_last)
        self.step_fn = step_fn or make_train_step(
            model, optimizer, cfg.microbatches, cfg.compress_grads)
        self._preempted = False
        self.step_times: List[float] = []
        self.stragglers = 0
        self.history: List[Dict[str, float]] = []

    # -- preemption hooks ----------------------------------------------------
    def install_signal_handlers(self) -> None:
        def handler(signum, frame):
            self._preempted = True
        signal.signal(signal.SIGTERM, handler)
        signal.signal(signal.SIGINT, handler)

    # -- main loop -------------------------------------------------------------
    def run(self, params=None, resume: bool = True):
        """Train ``params`` (default: the model's) from the latest
        committed step, or from 0; returns (params, optimizer state)."""
        cfg = self.cfg
        params = self.model.params if params is None else params
        opt_state = self.optimizer.init(params)
        ef_state = None
        start = 0
        if resume and self.ckpt.latest_step() is not None:
            state = {"params": params, "opt": opt_state}
            restored, start = self.ckpt.restore(state)
            with torch.no_grad():
                for dst, src in zip(leaves(state), leaves(restored)):
                    dst.copy_(src)
            del restored
            print(f"[trainer] resumed from step {start}")
        device = leaves(params)[0].device

        for step in range(start, cfg.steps):
            t0 = time.perf_counter()
            batch = self.data.batch(step)
            params, opt_state, ef_state, metrics = self.step_fn(
                params, opt_state, ef_state, batch)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            dt = time.perf_counter() - t0
            loss = float(metrics["loss"])
            self.step_times.append(dt)
            med = float(np.median(self.step_times[-50:]))
            if len(self.step_times) > 5 and dt > cfg.straggler_factor * med:
                self.stragglers += 1
                print(f"[trainer] straggler step {step}: {dt:.2f}s "
                      f"(median {med:.2f}s)")
            self.history.append({"step": step, "loss": loss, "time_s": dt})
            if step % cfg.log_every == 0:
                print(f"[trainer] step {step} loss {loss:.4f} "
                      f"({dt:.2f}s, grad_norm "
                      f"{float(metrics.get('grad_norm', 0)):.2f})")
            done = step + 1
            if done % cfg.ckpt_every == 0 or done == cfg.steps:
                self.ckpt.save(done, {"params": params, "opt": opt_state},
                               blocking=False,
                               extra={"data_step": done})
            if self._preempted:
                print(f"[trainer] preemption: checkpointing at step {done}")
                self.ckpt.save(done, {"params": params, "opt": opt_state},
                               blocking=True, extra={"data_step": done})
                break
        self.ckpt.wait()
        return params, opt_state

"""Fault-tolerant training loop.

Responsibilities: data feeding, checkpoint cadence (async), failure
recovery (restore latest checkpoint and replay the data stream — bit
exact, because the stream is a pure function of step and the step is
deterministic, :mod:`repro_torch.train.step`), straggler flagging,
metric logging. The JAX package's loop on the port's step.

The step updates the weights in place, so :meth:`TrainLoop.run` trains a
copy of the module it is given and leaves the caller's as it was.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.config import TrainConfig
from repro_torch.models.common import Params
from repro_torch.optim.adamw import init_opt
from repro_torch.runtime.fault import FaultInjector, StragglerMonitor, WorkerFailure

__all__ = ["TrainLoop", "TrainResult"]


@dataclasses.dataclass
class TrainResult:
    params: Any
    opt_state: Any
    metrics_history: List[Dict[str, float]]
    restarts: int
    straggler_steps: List[int]
    final_step: int


class TrainLoop:
    def __init__(
        self,
        step_fn: Callable,  # (params, opt, batch, rng) -> (params, opt, metrics)
        batch_fn: Callable[[int], Dict[str, np.ndarray]],  # step -> batch
        cfg: TrainConfig,
        *,
        ckpt: Optional[CheckpointManager] = None,
        fault_injector: Optional[FaultInjector] = None,
        to_device: Optional[Callable] = None,  # batch -> device tensors
    ):
        self.step_fn = step_fn
        self.batch_fn = batch_fn
        self.cfg = cfg
        self.ckpt = ckpt
        self.faults = fault_injector
        self.to_device = to_device or (lambda b: b)
        self.straggler = StragglerMonitor()

    def run(self, params: Params, num_steps: int, *, start_step: int = 0) -> TrainResult:
        params = params.map(lambda _, p: p.detach().clone())
        device = next(params.parameters()).device
        opt_state = init_opt(params)
        step = start_step
        restarts = 0
        history: List[Dict[str, float]] = []

        # Checkpoint step convention: meta step == next step to run.
        if self.ckpt is not None:
            if self.ckpt.latest_step() is not None:
                (params, opt_state), step = self.ckpt.restore((params, opt_state))
            else:
                # Commit the initial state so a pre-first-checkpoint
                # failure restarts from a well-defined point.
                self.ckpt.save(start_step, (params, opt_state), blocking=True)

        rng = torch.Generator(device=device).manual_seed(self.cfg.seed)
        while step < num_steps:
            try:
                if self.faults is not None:
                    self.faults.check(step)
                batch = self.to_device(self.batch_fn(step))
                t0 = time.monotonic()
                params, opt_state, metrics = self.step_fn(params, opt_state, batch, rng)
                if device.type == "cuda":  # the latency of the work, not of its enqueue
                    torch.cuda.synchronize(device)
                latency = time.monotonic() - t0
                self.straggler.observe(step, latency)
                history.append(
                    {k: float(v) for k, v in metrics.items()} | {"step": step, "sec": latency}
                )
                step += 1
                if self.ckpt is not None and step % self.cfg.checkpoint_every == 0:
                    self.ckpt.save(step, (params, opt_state), blocking=False)
            except WorkerFailure:
                # Recovery: restore the latest committed checkpoint and
                # replay from there. The data stream is a pure function
                # of step, so the replay is identical.
                restarts += 1
                if self.ckpt is None:
                    raise  # no recovery substrate configured
                (params, opt_state), step = self.ckpt.restore((params, opt_state))
                rng = torch.Generator(device=device).manual_seed(self.cfg.seed + restarts)

        if self.ckpt is not None:
            self.ckpt.save(num_steps, (params, opt_state), blocking=True)
        return TrainResult(
            params=params,
            opt_state=opt_state,
            metrics_history=history,
            restarts=restarts,
            straggler_steps=list(self.straggler.flagged),
            final_step=step,
        )

"""Fault-tolerance machinery: failure injection, heartbeats, stragglers.

A copy of the JAX package's ``repro/runtime/fault.py`` (pure Python, no
array library): the same schedule fires at the same steps, and the same
latency series gives the same flags and the same EWMA. On a cluster
these hooks would wrap ``torch.distributed`` process groups; the
serving engine (:mod:`repro_torch.serve.sparse`) exercises the control
flow end to end (inject → detect → restore from checkpoint → continue)
with simulated failures, and its tests assert bit-exact resumption.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

__all__ = ["FaultInjector", "WorkerFailure", "Heartbeat", "StragglerMonitor"]


class WorkerFailure(RuntimeError):
    """Raised when a (simulated) worker dies mid-step."""

    def __init__(self, step: int, worker: int):
        super().__init__(f"worker {worker} failed at step {step}")
        self.step = step
        self.worker = worker


@dataclasses.dataclass
class FaultInjector:
    """Deterministic failure schedule: {step: worker_id}."""

    schedule: Dict[int, int] = dataclasses.field(default_factory=dict)
    fired: List[int] = dataclasses.field(default_factory=list)

    def check(self, step: int) -> None:
        if step in self.schedule and step not in self.fired:
            self.fired.append(step)
            raise WorkerFailure(step, self.schedule[step])


class Heartbeat:
    """Liveness tracking per worker; a worker silent past ``timeout``
    seconds is declared dead (the detector behind elastic down-scaling)."""

    def __init__(self, num_workers: int, timeout: float = 30.0):
        self.timeout = timeout
        now = time.monotonic()
        self.last_seen = {w: now for w in range(num_workers)}

    def beat(self, worker: int) -> None:
        self.last_seen[worker] = time.monotonic()

    def dead_workers(self) -> List[int]:
        now = time.monotonic()
        return [w for w, t in self.last_seen.items() if now - t > self.timeout]


class StragglerMonitor:
    """Per-step deadline tracking.

    Keeps an EWMA of step latency; a step exceeding ``factor ×`` the EWMA
    is flagged. On a real mesh the response is re-dispatching the slow
    host's shard (data re-assignment is cheap because the pipeline is
    stateless per step); here we record the
    decision for the tests and benchmarks.
    """

    def __init__(self, factor: float = 3.0, alpha: float = 0.2):
        self.factor = factor
        self.alpha = alpha
        self.ewma: Optional[float] = None
        self.flagged: List[int] = []

    def observe(self, step: int, latency: float) -> bool:
        is_straggler = (
            self.ewma is not None and latency > self.factor * self.ewma
        )
        if is_straggler:
            self.flagged.append(step)
            # Straggler steps do not poison the EWMA.
            return True
        self.ewma = (
            latency
            if self.ewma is None
            else (1 - self.alpha) * self.ewma + self.alpha * latency
        )
        return False

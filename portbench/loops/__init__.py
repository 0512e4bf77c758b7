"""The loops that drive the program, one module a traffic ``loop``
(``loops/<loop>.py``), found by name as the metrics are.

A loop module has ``run(ctx: Context) -> Run``, which warms up the
shapes it uses before its window (set-up) and then measures, and
``SPANS``, the names of its host spans from the outermost in, which
label the device's idle gaps. Nothing compiles inside the window: the
kernels are built and the tiles hoisted by the warm-up.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, List, Optional

import numpy as np

from portbench import trace as tracing


@dataclasses.dataclass
class Answer:
    """One answer the program gave, with what it was asked."""

    graph: str
    solver: str
    payload: np.ndarray  # [B, n]
    x: np.ndarray  # [B, n]
    iters: int


@dataclasses.dataclass
class Run:
    loop: str
    setup_s: float = 0.0
    window_s: float = 0.0
    attempted: int = 0
    failed: int = 0
    answers: List[Answer] = dataclasses.field(default_factory=list)
    rhs_iters: int = 0  # right-hand sides × iterations completed
    window_ns: tuple = (0, 0)  # the window on the spans' clock
    profiler: Optional[tracing.Profiler] = None  # its slice, read after the window
    spans: Optional[tracing.Spans] = None
    device_trace: Optional[tracing.DeviceTrace] = None  # set by the harness
    # Set by the harness in a traced run: the program's ``trace.counters()``
    # (None where its tracer was off or absent).
    program_counters: Optional[Dict[str, int]] = None
    # Set by the harness: seconds in ``distribute``, each graph's plan
    # facts (:func:`portbench.harness.plan_facts`), the traffic file.
    plan_s: float = 0.0
    facts: Dict[str, dict] = dataclasses.field(default_factory=dict)
    traffic: Dict[str, object] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class Context:
    config: dict
    traffic: dict
    cell: dict
    seed: int
    seconds: float
    device: object
    graphs: dict  # name -> portbench.matrices.Matrix
    sessions: dict  # name -> repro_torch SparseSession
    t_start: float  # perf_counter at process start
    spans: Optional[tracing.Spans] = None  # set in a traced run
    profile: bool = False  # trace the device (on the card)


def find(name: str):
    """The loop module named ``name``."""
    return importlib.import_module(f"portbench.loops.{name}")


def sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


class SpmvSpans:
    """Spans named ``spmv`` around each product of the program's device
    loops (the closures ``SparseSession.device_spmm`` returns), while in
    effect and in a traced run."""

    def __init__(self, spans: Optional[tracing.Spans]):
        self.spans = spans
        self.saved = None

    def __enter__(self):
        if self.spans is None:
            return self
        from repro_torch.api.session import SparseSession

        spans = self.spans
        self.saved = orig = SparseSession.device_spmm

        def device_spmm(sess):
            return spans.timed("spmv", orig(sess))

        SparseSession.device_spmm = device_spmm
        return self

    def __exit__(self, *exc):
        if self.saved is not None:
            from repro_torch.api.session import SparseSession

            SparseSession.device_spmm = self.saved
        return False

"""Spans recorded by the benchmark around its calls into the program,
and the reading of the profiler's device trace.

Spans are host-clock intervals (``time.perf_counter_ns``) named after
the call they time (``solve``, ``spmv``), with the program's own
(dotted names: ``cg.iter``, ``spmv.exchange``, ...) copied in after the
loop. They are recorded only in a ``--trace 1`` run, from any thread,
and kept in memory. The device trace comes from ``torch.profiler``
(CUDA activity) over a slice of :data:`SLICE_S` seconds of the same
traffic right after the window; its timestamps are put on the spans'
clock by a ``cudaDeviceSynchronize`` made at a known time.
"""
from __future__ import annotations

import bisect
import dataclasses
import threading
import time
from typing import Dict, List, Optional, Tuple

SLICE_S = 3.0


def _on_device(e) -> bool:
    """Whether a profiler event is an operation that ran on the device
    (a kernel, a copy or a set), not a range the profiler drew there."""
    if str(e.device_type()) not in ("DeviceType.CUDA", "CUDA"):
        return False
    return not (getattr(e, "is_user_annotation", lambda: False)()
                or "annotation" in e.name())


class Spans:
    """Named host intervals, appended from any thread."""

    def __init__(self):
        self._lock = threading.Lock()
        self.items: List[Tuple[str, int, int]] = []

    def add(self, name: str, t0: int, t1: int) -> None:
        with self._lock:
            self.items.append((name, t0, t1))

    def extend(self, items) -> None:
        """Add ``(name, t0, t1)`` items, such as the program's spans."""
        with self._lock:
            self.items.extend(items)

    def of(self, name: str, lo: int = 0, hi: int = 2**63) -> List[Tuple[int, int]]:
        return [(a, b) for n, a, b in self.items if n == name and a >= lo and a < hi]

    def total_s(self, name: str, lo: int = 0, hi: int = 2**63) -> float:
        return sum(b - a for a, b in self.of(name, lo, hi)) / 1e9

    def timed(self, name: str, fn):
        """``fn`` with a span around each call."""

        def call(*args, **kw):
            t0 = time.perf_counter_ns()
            try:
                return fn(*args, **kw)
            finally:
                self.add(name, t0, time.perf_counter_ns())

        return call


@dataclasses.dataclass
class DeviceOp:
    name: str
    start: int  # ns on the spans' clock
    end: int
    launched: Optional[int]  # when the host launched it, if the trace links it


@dataclasses.dataclass
class DeviceTrace:
    """What the traced slice holds: the device's operations, the slice's
    bounds, and the host spans."""

    ops: List[DeviceOp]
    lo: int
    hi: int
    spans: Spans

    @property
    def window_s(self) -> float:
        return (self.hi - self.lo) / 1e9

    def busy_intervals(self) -> List[Tuple[int, int]]:
        """The union of the device operations' intervals inside the slice."""
        out: List[List[int]] = []
        for op in sorted(self.ops, key=lambda o: o.start):
            a, b = max(op.start, self.lo), min(op.end, self.hi)
            if b <= a:
                continue
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return [(a, b) for a, b in out]

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) / 1e9

    def in_span(self, name: str) -> List[DeviceOp]:
        """Operations whose launch falls inside a span of ``name``."""
        spans = sorted(self.spans.of(name))
        starts = [a for a, _ in spans]
        hit = []
        for op in self.ops:
            if op.launched is None:
                continue
            i = bisect.bisect_right(starts, op.launched) - 1
            if i >= 0 and op.launched <= spans[i][1]:
                hit.append(op)
        return hit

    def device_ops(self, top: int = 10) -> List[list]:
        """The device operations that took most time, summed by name."""
        by: Dict[str, int] = {}
        for op in self.ops:
            by[op.name] = by.get(op.name, 0) + (op.end - op.start)
        ranked = sorted(by.items(), key=lambda kv: -kv[1])[:top]
        return [[name[:120], ns / 1e9] for name, ns in ranked]

    def _covers(self, name: str):
        """``t -> bool``: whether a span of ``name`` covers ``t`` (spans of
        one name do not overlap: each is recorded by one thread)."""
        spans = sorted(self.spans.of(name))
        starts = [a for a, _ in spans]

        def covers(t: int) -> bool:
            i = bisect.bisect_right(starts, t) - 1
            return i >= 0 and t < spans[i][1]

        return covers

    def idle_gaps(self, names: Tuple[str, ...], top: int = 10) -> List[list]:
        """Idle time between the device's operations inside the slice,
        summed by what the host was doing at each gap's middle: the
        innermost of ``names``' spans that covers it (later names are
        inner), else ``other``."""
        busy = self.busy_intervals()
        covers = [(name, self._covers(name)) for name in names]
        edges = [self.lo] + [t for iv in busy for t in iv] + [self.hi]
        by: Dict[str, int] = {}
        for a, b in zip(edges[0::2], edges[1::2]):
            if b > a:
                mid, label = (a + b) // 2, "other"
                for name, cov in covers:  # later names are inner
                    if cov(mid):
                        label = name
                by["host " + label] = by.get("host " + label, 0) + (b - a)
        ranked = sorted(by.items(), key=lambda kv: -kv[1])[:top]
        return [[name, ns / 1e9] for name, ns in ranked]


class Profiler:
    """``torch.profiler`` over one slice of solves, CUDA activity only."""

    def __init__(self, spans: Spans):
        self.spans = spans
        self.prof = None
        self.lo = self.hi = self.stopped = 0
        self._mark = 0

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.start()
        torch.cuda.synchronize()
        self._mark = time.perf_counter_ns()
        torch.cuda.synchronize()
        self.lo = time.perf_counter_ns()

    def stop(self) -> "Profiler":
        """End the slice; the events are read later, by :meth:`read`,
        once the window has closed."""
        import torch

        torch.cuda.synchronize()
        self.hi = time.perf_counter_ns()
        self.prof.stop()
        self.stopped = time.perf_counter_ns()
        return self

    def read(self) -> DeviceTrace:
        events = self.prof.profiler.kineto_results.events()
        offset = self._offset(events)
        launches: Dict[int, int] = {}
        ops = []
        for e in events:
            if _on_device(e):
                ops.append((e.name(), e.start_ns() - offset, e.end_ns() - offset,
                            e.correlation_id()))
            elif e.correlation_id():  # a runtime or driver call on the host
                launches.setdefault(e.correlation_id(), e.start_ns() - offset)
        self.prof = None
        return DeviceTrace([DeviceOp(n, a, b, launches.get(c)) for n, a, b, c in ops],
                           self.lo, self.hi, self.spans)

    def _offset(self, events) -> int:
        """Trace clock minus the spans' clock, from the second of the two
        synchronisations in :meth:`start`, whose call began at ``_mark``."""
        syncs = sorted(e.start_ns() for e in events
                       if e.name() == "cudaDeviceSynchronize" and not _on_device(e))
        guess = time.time_ns() - time.perf_counter_ns()
        if len(syncs) < 2:
            return guess
        near = min(syncs, key=lambda s: abs(s - (self._mark + guess)))
        return near - self._mark

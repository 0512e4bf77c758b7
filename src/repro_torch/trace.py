"""Spans and counters inside the program: where the host's time goes,
by phase, on the clock a profiler's device trace can be mapped onto.

Tracing is off unless :func:`enable` turns it on. Off, a site costs one
test of the module global :data:`on`: no clock read, no allocation, no
lock. On, :func:`span` records ``(name, t0_ns, t1_ns, span_id,
parent_id, root_id)`` on ``time.perf_counter_ns()`` when the span
closes: the parent is the innermost span open on the same thread (0 at
the outermost), and ``root_id`` is the outermost span's id, so every
span of one solve shares it. :func:`count` adds to a named counter.

Records go into a buffer of ``capacity`` slots, allocated by
:func:`enable` and never grown; a span that finds it full is dropped and
counted under ``trace.dropped``. :func:`spans` and :func:`counters`
read what was recorded, in any state; :func:`disable` stops recording
and keeps it until the next :func:`enable`.

The program's spans (dotted names, see README.md, "Tracing"):
``solve.cg`` and ``cg.iter`` (the device-loop CG and each iteration),
``spmv.call`` (one device product) and its phases ``spmv.pad_x``,
``spmv.exchange``, ``spmv.kernel``, ``spmv.unit_sum``,
``spmv.unblock_y``; ``plan.partition``, ``plan.pack`` and
``plan.exchange`` inside ``distribute``. Counter:
``spmv.exchange_bytes``, the bytes the exchange's gathers write.

Imports only the standard library.
"""
from __future__ import annotations

import itertools
import threading
import time
from typing import Dict, List, Optional, Tuple

__all__ = ["DEFAULT_CAPACITY", "count", "counters", "disable", "enable", "span", "spans"]

# 262,144 spans: a 40 s traced window of the CG cell records about 4,000
# a second (seven an iteration at about 540 iterations a second), so the
# buffer holds about 65 s of it, set-up included.
DEFAULT_CAPACITY = 1 << 18

Record = Tuple[str, int, int, int, int, int]

on = False  # the one global every site tests
_buf: List[Optional[Record]] = []
_slots = itertools.count()
_ids = itertools.count(1)
_counts: Dict[str, int] = {}
_lock = threading.Lock()
_local = threading.local()


class _Off:
    """What :func:`span` hands back while tracing is off: one object,
    shared, that does nothing."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("name", "t0", "sid", "parent", "root", "stack")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        self.stack = stack
        self.sid = next(_ids)
        if stack:
            self.parent, self.root = stack[-1].sid, stack[0].sid
        else:
            self.parent, self.root = 0, self.sid
        stack.append(self)
        self.t0 = time.perf_counter_ns()
        return None

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        self.stack.pop()
        buf = _buf
        i = next(_slots)
        if i < len(buf):
            buf[i] = (self.name, self.t0, t1, self.sid, self.parent, self.root)
        else:
            count("trace.dropped", 1)
        return False


def span(name: str):
    """A context manager that records a span named ``name`` while
    tracing is on, and does nothing while it is off."""
    if not on:
        return _OFF
    return _Span(name)


def count(name: str, n: int) -> None:
    """Add ``n`` to the counter ``name`` while tracing is on."""
    if not on:
        return
    with _lock:
        _counts[name] = _counts.get(name, 0) + n


def enable(capacity: int = DEFAULT_CAPACITY) -> None:
    """Start recording into a fresh buffer of ``capacity`` spans, with
    the counters at zero."""
    global on, _buf, _slots
    if capacity < 1:
        raise ValueError(f"capacity must be at least 1, got {capacity}")
    on = False
    with _lock:
        _buf = [None] * capacity
        _slots = itertools.count()
        _counts.clear()
    on = True


def disable() -> None:
    """Stop recording; what was recorded stays readable."""
    global on
    on = False


def spans() -> List[Record]:
    """The recorded spans, in the order they closed."""
    return [r for r in _buf if r is not None]


def counters() -> Dict[str, int]:
    """The counters, ``trace.dropped`` among them once a span was dropped."""
    with _lock:
        return dict(_counts)

"""What the readers of the program's spans share (``cg.iter``,
``spmv.call`` and its phases, ``plan.*``: ``repro_torch.trace``, copied
into a traced run's spans by the harness).

Each returns None where the program's spans are not there to read: an
untraced run, a program without the tracer, or a buffer that overflowed
(``trace.dropped``), since a reading over part of the spans would be
wrong. The device trace's clock sits up to about 10 µs off the spans'
clock, so a phase next to the ``bell_spmm`` launch can catch it: the
readers give ``bell_spmm`` to ``spmv.kernel`` alone.
"""
from __future__ import annotations

from typing import Optional

from portbench.trace import Spans

KERNEL = "bell_spmm"


def program_spans(run) -> Optional[Spans]:
    """The run's spans, where the program's were recorded whole."""
    counters = run.program_counters
    if run.spans is None or counters is None or counters.get("trace.dropped"):
        return None
    return run.spans


def total_s(run, name: str) -> Optional[float]:
    """Seconds in the program's spans ``name``, anywhere in the run."""
    spans = program_spans(run)
    if spans is None or not spans.of(name):
        return None
    return spans.total_s(name)


def per_call_ms(run, phase: str) -> Optional[float]:
    """Device time of the operations launched inside the program's
    ``phase`` spans, but ``bell_spmm``'s, per ``spmv.call``, in the
    traced slice (ms)."""
    dt = run.device_trace
    if program_spans(run) is None or dt is None:
        return None
    calls = len(dt.spans.of("spmv.call", dt.lo, dt.hi))
    if not calls or not dt.spans.of(phase, dt.lo, dt.hi):
        return None
    ns = sum(op.end - op.start for op in dt.in_span(phase) if KERNEL not in op.name)
    return ns / calls / 1e6

"""The host's time to enqueue one CG iteration: the mean length of the
program's ``cg.iter`` spans that start in the window, before the
profiled slice (the profiler slows the host's launches). The device
loop does not wait inside an iteration at ``b=[B, N]``, so against the
device's time an iteration this says which of the two paces the solve."""
from portbench.phases import program_spans


def read(run):
    spans = program_spans(run)
    if spans is None:
        return None
    lo, hi = run.window_ns
    if run.device_trace is not None:
        hi = min(hi, run.device_trace.lo)
    its = [(a, b) for a, b in spans.of("cg.iter", lo, hi) if b <= hi]
    if not its:
        return None
    return sum(b - a for a, b in its) / len(its) / 1e6

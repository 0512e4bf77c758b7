"""Device operations a CG iteration: those launched inside the
program's ``cg.iter`` spans that start in the traced slice, over their
number. What a CUDA graph or a fused kernel would take away."""
from portbench.phases import program_spans


def read(run):
    dt = run.device_trace
    if program_spans(run) is None or dt is None:
        return None
    its = dt.spans.of("cg.iter", dt.lo, dt.hi)
    if not its:
        return None
    return len(dt.in_span("cg.iter")) / len(its)

"""Share of the spmv calls' device time outside ``bell_spmm``: the
exchange's gathers, the unit sum, padding x and unblocking y."""


def read(run):
    dt = run.device_trace
    if run.loop != "solve" or dt is None:
        return None
    ops = {id(op): op for op in dt.in_span("spmv")}
    ops.update((id(op), op) for op in dt.ops if "bell_spmm" in op.name)
    total = sum(op.end - op.start for op in ops.values())
    kernel = sum(op.end - op.start for op in dt.ops if "bell_spmm" in op.name)
    if total <= 0:
        return None
    return 100.0 * (1.0 - kernel / total)

"""The whole spmv call's share of the card's peak: the time the product
needs (:func:`portbench.roofline.csr_spmv_counts`: the matrix's
non-zeros, x and y alone, never tiles or buffers), over the device time
of every operation launched inside the calls, in the traced slice."""
from portbench.roofline import bound_s, csr_spmv_counts


def read(run):
    dt = run.device_trace
    if run.loop != "solve" or dt is None:
        return None
    # Launched inside a call, and the kernel's own launches wherever the
    # trace does not link them to their host call.
    ops = {id(op): op for op in dt.in_span("spmv")}
    ops.update((id(op), op) for op in dt.ops if "bell_spmm" in op.name)
    busy = sum(op.end - op.start for op in ops.values()) / 1e9
    calls = len(dt.spans.of("spmv", dt.lo, dt.hi))
    if busy <= 0.0 or not calls:
        return None
    f = run.facts[run.traffic["graph"]]
    return 100.0 * calls * bound_s(*csr_spmv_counts(f["nnz"], f["n"], f["n"],
                                                    run.traffic["batch"])) / busy

"""``bell_spmm``'s share of its roofline: each launch's bound from the
plan (:func:`portbench.roofline.bell_spmm_counts`: real tiles, their
indices, the x source and the partials, each once) over the kernel's
device time, in the traced slice."""
from portbench.roofline import bell_spmm_counts, bound_s


def read(run):
    dt = run.device_trace
    if run.loop != "solve" or dt is None:
        return None
    f = run.facts[run.traffic["graph"]]
    launches = [op for op in dt.ops if "bell_spmm" in op.name]
    if not launches or f["xsrc_blocks"] is None:
        return None
    busy = sum(op.end - op.start for op in launches) / 1e9
    counts = bell_spmm_counts(f["real_tiles"], f["bm"], f["bn"], f["units"], f["nrb"],
                              f["xsrc_blocks"], run.traffic["batch"])
    return 100.0 * len(launches) * bound_s(*counts) / busy

"""Seconds packing the Block-ELL tiles inside ``distribute``: the
program's ``plan.pack`` spans, summed over the cell's graphs."""
from portbench.phases import total_s


def read(run):
    return total_s(run, "plan.pack")

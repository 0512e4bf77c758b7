"""Seconds in the partitioner inside ``distribute``: the program's
``plan.partition`` spans, summed over the cell's graphs."""
from portbench.phases import total_s


def read(run):
    return total_s(run, "plan.partition")

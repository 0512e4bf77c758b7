"""Seconds in ``distribute`` (partition, pack, exchange plan) in set-up,
summed over the cell's graphs."""


def read(run):
    return run.plan_s

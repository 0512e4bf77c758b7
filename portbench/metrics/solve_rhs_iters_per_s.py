"""Solver throughput: right-hand sides × iterations of every solve
completed in the window, over the window's wall time."""


def read(run):
    if run.loop != "solve":
        return None
    return run.rhs_iters / run.window_s

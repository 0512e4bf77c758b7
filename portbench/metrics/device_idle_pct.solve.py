"""Share of the traced slice in which no operation ran on the device:
1 - (union of the device operations' intervals) / (the slice)."""


def read(run):
    if run.loop != "solve" or run.device_trace is None:
        return None
    dt = run.device_trace
    return 100.0 * (1.0 - dt.busy_s / dt.window_s)

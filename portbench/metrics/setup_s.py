"""Set-up: the process's start to the window's start (imports, the
kernel's build, the matrices, ``distribute``, the hoist, the warm-up)."""


def read(run):
    return run.setup_s

"""Seconds from the process's start to the window's start: imports, the
kernels' build or load, the weights, the warm-up (and the set-up steps the
reference follows)."""


def read(run):
    return run.setup_s

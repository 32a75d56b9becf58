"""Seconds before the window: imports, data from the seed, the program's
set-up and the warm-up on the cell's shapes (and, in a checkout's first
run, the nvcc and C++ builds)."""


def read(run):
    return run.setup_s

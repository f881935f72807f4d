"""Seconds from the start of the process to the window's first request:
the stand-in, the fleet and series from the seed, CUDA's start, the
kernel library from its build cache, the program registry's startup
captures and the warm-up of the cell's routes."""


def read(run):
    return run.setup_s

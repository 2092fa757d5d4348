"""Seconds from the start of the process to the start of the window:
imports, building the kernels where a checkout has none yet, the initial
state, the warm-up and the probe cycles."""


def read(run):
    return run["setup_s"]

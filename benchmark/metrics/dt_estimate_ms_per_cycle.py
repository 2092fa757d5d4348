"""Device milliseconds per cycle of the dt's estimate: the device
operations launched inside the program's ``estimate_timestep`` ranges (the
CFL reduction and the minima's stack), the kernels of ``csrc/`` excepted.
None where the trace holds fewer whole ``cycle`` ranges than its cycles
less one (``cycle_idle_share``)."""

from benchmark.metrics.cycle_idle_share import whole_cycles

SPAN = "estimate_timestep"


def read(run):
    tr = run.get("trace")
    if tr is None or not whole_cycles(tr):
        return None
    return tr.ms_per_cycle(tr.in_ranges([SPAN]))

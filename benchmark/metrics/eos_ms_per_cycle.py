"""Device milliseconds per cycle of the EOS with floors: the device
operations launched inside the program's ``cons_to_prim`` ranges
(``HydroPackage.cons_to_prim``, cons to prim and its two stacks), the
kernels of ``csrc/`` excepted.  None where the trace holds fewer whole
``cycle`` ranges than its cycles less one (``cycle_idle_share``)."""

from benchmark.metrics.cycle_idle_share import whole_cycles

SPAN = "cons_to_prim"


def read(run):
    tr = run.get("trace")
    if tr is None or not whole_cycles(tr):
        return None
    return tr.ms_per_cycle(tr.in_ranges([SPAN]))

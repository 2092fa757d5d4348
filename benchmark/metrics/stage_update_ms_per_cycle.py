"""Device milliseconds per cycle of the stages' 2S update: the device
operations launched inside the program's ``stage_update`` ranges
(``gam0 u0 + gam1 u1 + beta_dt (-div F)``), the kernels of ``csrc/``
excepted.  None where the trace holds fewer whole ``cycle`` ranges than
its cycles less one (``cycle_idle_share``)."""

from benchmark.metrics.cycle_idle_share import whole_cycles

SPAN = "stage_update"


def read(run):
    tr = run.get("trace")
    if tr is None or not whole_cycles(tr):
        return None
    return tr.ms_per_cycle(tr.in_ranges([SPAN]))

"""Device milliseconds per cycle of the tabular cooling: the device
operations launched inside the program's ``tabular_cooling`` ranges (the
Townsend update of every stage) or ``cooling_dt`` ranges (the cooling's
dt limit, inside ``estimate_timestep``), the kernels of ``csrc/``
excepted.  None where the trace holds fewer whole ``cycle`` ranges than
its cycles less one, or where either range never appears (a program
without ``cooling_dt``)."""

from benchmark.metrics.cluster_source_ms_per_cycle import ms_in

SPANS = ("tabular_cooling", "cooling_dt")


def read(run):
    return ms_in(run, SPANS)

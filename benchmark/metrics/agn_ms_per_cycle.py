"""Device milliseconds per cycle of the cluster's AGN feedback: the device
operations launched inside the program's ``agn_feedback`` ranges (the
thermal dump and the kinetic jet, with the ``agn_triggering`` ranges, the
cold-gas accretion's partial sums, rate and mass removal, and the
``magnetic_tower`` ranges, the tower's field, sums and injection, nested
in it), the kernels of ``csrc/`` excepted.  None where the trace holds
fewer whole ``cycle`` ranges than its cycles less one, or where
``agn_feedback``, ``agn_triggering`` or ``magnetic_tower`` never
appears (a program without the nested ranges)."""

from benchmark.metrics.cluster_source_ms_per_cycle import ms_in

SPAN = "agn_feedback"
NESTED = ("agn_triggering", "magnetic_tower")


def read(run):
    return ms_in(run, (SPAN,), needed=NESTED)

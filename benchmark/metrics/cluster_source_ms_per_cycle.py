"""Device milliseconds per cycle of the galaxy cluster's sources: the
device operations launched inside the program's ``problem_source`` ranges
(the unsplit source of every stage: gravity, AGN feedback, SN Ia) or in
the split source's ``stellar_feedback`` and ``clips`` ranges, the kernels
of ``csrc/`` excepted.  None where the trace holds fewer whole ``cycle``
ranges than its cycles less one (``cycle_idle_share``), or where one of
the ranges read never appears in it."""

from benchmark.metrics.cycle_idle_share import whole_cycles

SPANS = ("problem_source", "stellar_feedback", "clips")


def ms_in(run, spans, needed=()):
    """Device ms per cycle launched inside any range of ``spans``; None
    without whole ``cycle`` ranges or where a range of ``spans`` or
    ``needed`` is missing from the traced stretch."""
    tr = run.get("trace")
    if tr is None or not whole_cycles(tr):
        return None
    seen = {name for _, _, name in tr.host_ops}
    if not seen.issuperset(spans) or not seen.issuperset(needed):
        return None
    return tr.ms_per_cycle(tr.in_ranges(spans))


def read(run):
    return ms_in(run, SPANS)

"""Device milliseconds per cycle of everything else: the stage's plain
PyTorch operations (EOS with floors, the 2S update, the Dedner source, the
ghost fill, the dt's reduction), every device operation that is neither a
kernel of ``csrc/`` nor launched inside a source range."""

from benchmark.harness.trace import CSRC_KERNEL, FIRST_ORDER

SOURCES = ("problem_source", "tabular_cooling", FIRST_ORDER)


def read(run):
    tr = run.get("trace")
    if tr is None:
        return None
    src = {id(o) for o in tr.in_ranges(SOURCES)}
    ops = [o for o in tr.ops if not CSRC_KERNEL.search(o["name"])
           and id(o) not in src]
    return tr.ms_per_cycle(ops) if ops else None

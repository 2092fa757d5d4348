"""Share of the traced cycles in which no device operation ran, in %:
100 (1 - device busy / stretch), the stretch running from the start of the
first ``cycle`` range (the program's, one per cycle of its loop) that the
trace holds whole to the end of the last.  The profiler starts inside the
first traced cycle, so that cycle's range is missing; the window's opening,
which ``device_idle_share`` counts, is left out.  None where the trace
holds fewer whole ``cycle`` ranges than its cycles less one (the profiler
lost some, or the program marks no cycle)."""

from benchmark.harness.trace import union_length

CYCLE = "cycle"


def whole_cycles(tr):
    """``[(start, end)]`` of the ``cycle`` ranges inside the window, in
    microseconds; empty where they are fewer than the traced cycles less
    one."""
    lo, hi = tr.window
    cycles = [(a, b) for a, b, name in tr.host_ops
              if name == CYCLE and lo <= a and b <= hi]
    return cycles if cycles and len(cycles) >= tr.cycles - 1 else []


def read(run):
    tr = run.get("trace")
    cycles = whole_cycles(tr) if tr is not None else []
    if not cycles:
        return None
    lo, hi = cycles[0][0], cycles[-1][1]
    busy = union_length([(max(o["ts"], lo), min(o["ts"] + o["dur"], hi))
                         for o in tr.ops
                         if o["ts"] < hi and o["ts"] + o["dur"] > lo])
    return 100.0 * (1.0 - busy / (hi - lo))

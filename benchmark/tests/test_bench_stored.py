"""Every reader of the two uniform cells on a trace and a run record that a
traced 16^3 run of each left on the card (``data/``, the trace cut to the
events ``harness/trace.py`` reads): each returns the number stored beside
them, which the harness returned before it took states of several level
tensors, to the last digit; so do the traced stretch's busy and window
seconds and its breakdown."""

import gzip
import json
from pathlib import Path

import pytest

from bench_helpers import ROOT  # noqa: F401

from benchmark.harness.result import result_line
from benchmark.harness.spec import Cell
from benchmark.harness.trace import Trace

DATA = Path(__file__).resolve().parent / "data"
CELLS = ["linwave-mhd-uniform-256", "cluster-agn-320"]


def stored(name):
    """``(the stored record, the run record with its Trace)``."""
    rec = json.loads((DATA / f"{name}.run.json").read_text())
    with gzip.open(DATA / f"{name}.trace.json.gz", "rt") as fh:
        events = json.load(fh)["traceEvents"]
    kw = dict(rec["trace"])
    tr = Trace(events, kw.pop("cycles"), **kw)
    run = {k: v for k, v in rec.items()
           if k not in ("trace", "seed", "expected")}
    run["trace"] = tr
    return rec, run


@pytest.mark.parametrize("name", CELLS)
def test_readers_read_as_before(name):
    rec, run = stored(name)
    want = rec["expected"]
    cell = Cell(name)
    for kind, metrics in (("per_layer", cell.per_layer),
                          ("end_to_end", cell.end_to_end)):
        got = {m["name"]: cell.metric_reader(m["name"]).read(run)
               for m in metrics}
        assert got == want[kind], kind
    tr = run["trace"]
    assert tr.busy_s() == want["busy_s"]
    assert tr.window_s() == want["window_s"]
    assert tr.breakdown() == want["breakdown"]


@pytest.mark.parametrize("name", CELLS)
def test_stored_traces_read_the_card(name):
    """The stored stretch holds the port's kernels, each priced: the
    roofline, the kernels' time and the idle share read numbers."""
    rec, run = stored(name)
    line = result_line(Cell(name), run, trace=True, kind="stored")
    metrics = line["metrics"]
    assert 0.0 < metrics["negdiv_sweep_roofline"]["value"] <= 105.0
    assert metrics["kernel_ms_per_cycle"]["value"] > 0.0
    assert "levels" not in rec["trace"]["layout"]
    assert line["correct"] is True

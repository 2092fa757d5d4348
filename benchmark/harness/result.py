"""The result line of a run: ``correct``, ``attempted``, ``failed``, the
cell's metrics (end-to-end with ``--trace 0``, per-layer with
``--trace 1``, each from the reader ``metrics/<name>.py`` of its name), the
device, the traced breakdown and, last, the numbers compared with their
limits."""

from __future__ import annotations

import math


def plain_number(x):
    """``x``, or its text where JSON has no number for it."""
    return x if math.isfinite(x) else repr(x)


def result_line(cell, run, trace, kind):
    """The result line of ``run`` (``cell.run_cell``'s record) on the card
    named ``kind``."""
    checks = run["checks"]
    failed = sum(1 for v, lim in checks.values() if not v <= lim)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = cell.metric_reader(m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = {"platform": "gpu", "kind": kind,
              "count": cell.chips, "memory_peak_bytes": run["peak_bytes"]}
    line = {"correct": failed == 0, "attempted": run["attempted"],
            "failed": failed, "metrics": metrics, "device": device}
    if trace:
        tr = run["trace"]
        device["busy_s"] = tr.busy_s()
        device["window_s"] = tr.window_s()
        line["breakdown"] = tr.breakdown()
    line["checks"] = {name: {"value": plain_number(v), "limit": lim}
                      for name, (v, lim) in checks.items()}
    return line

"""The traced stretch of a window: a ``torch.profiler`` Chrome trace read
back into device operations, each with the host ranges its launch fell in,
and the arithmetic the per-layer readers share.

The stretch is the ``benchmark_window`` range the harness opens on the
host after a synchronise and closes when ``Simulation.run`` (which ends in
one) returns; a device operation is one of the trace's ``kernel``,
``gpu_memcpy`` or ``gpu_memset`` events, and a range one of its
``user_annotation`` events (the program's ``record_function`` names and
the harness's own).
"""

from __future__ import annotations

import contextlib
import json
import re

import torch

WINDOW = "benchmark_window"
# the harness's own copies of the sampled states, left out of every sum
CAPTURE = "benchmark_capture"
# the harness's range around the first-order split source (``programs/``)
FIRST_ORDER = "benchmark_first_order_source"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")

# the kernels of the port's csrc/ (their names in a trace)
CSRC_KERNEL = re.compile(r"\b(negdiv_sweep|negdiv_scalars|fused_stage|"
                         r"stage_scalars)_kernel\b")
NEGDIV = re.compile(r"negdiv_sweep_kernel<(\w+), (\d+), (\d+), (\d+)"
                    r"(?:, (\w+))?>")
SCALARS = re.compile(r"negdiv_scalars_kernel<(\w+), (\d+), (\d+)>")
STAGE = re.compile(r"fused_stage_kernel<(\w+), (\d+), (\d+), (\w+), "
                   r"(\w+)>")
STAGE_SCALARS = re.compile(r"stage_scalars_kernel<(\w+), (\d+)>")


@contextlib.contextmanager
def host_reads(counter):
    """Count the reads of a CUDA tensor to the host (``item``, ``tolist``,
    ``cpu``, ``numpy``, ``float``, ``int``, ``bool``) made inside the block
    into ``counter['reads']``, at the tensor methods."""
    names = ("item", "tolist", "cpu", "numpy", "__float__", "__int__",
             "__bool__")
    saved = {n: getattr(torch.Tensor, n) for n in names}

    def counting(fn):
        def call(self, *a, **k):
            if self.is_cuda:
                counter["reads"] += 1
            return fn(self, *a, **k)
        return call

    for n in names:
        setattr(torch.Tensor, n, counting(saved[n]))
    try:
        yield counter
    finally:
        for n, fn in saved.items():
            setattr(torch.Tensor, n, fn)


def union_length(intervals):
    """Total length covered by ``[(start, end)]``."""
    total, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


class Trace:
    """A traced stretch: ``ops`` (``{name, ts, dur, ranges}``, times in
    microseconds), ``window`` (start, end) in microseconds, the cycles it
    holds, the host reads counted over it, the launches of the port's own
    kernels the program counted over it (``launched``), and the state's
    layout (``shape``, ``itemsize``, ``fluid``, ``nscalars``, and on a
    refined mesh ``levels``; ``programs/uniform.py`` lists them) for the
    readers that count bytes."""

    def __init__(self, events, cycles, host_reads=None, layout=None,
                 launched=None):
        self.cycles = cycles
        self.host_reads = host_reads
        self.layout = layout or {}
        self.launched = launched
        wins = [e for e in events if e.get("cat") == "user_annotation"
                and e.get("name") == WINDOW]
        if len(wins) != 1:
            raise ValueError(f"the trace holds {len(wins)} "
                             f"'{WINDOW}' ranges, not one")
        w = wins[0]
        self.window = (float(w["ts"]), float(w["ts"]) + float(w["dur"]))
        ranges = {}
        for e in events:
            if e.get("cat") == "user_annotation" and e is not w:
                ranges.setdefault((e.get("pid"), e.get("tid")), []).append(
                    (float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                     e["name"]))
        launches = {}
        for e in events:
            if e.get("cat") in ("cuda_runtime", "cuda_driver") \
                    and "correlation" in e.get("args", {}):
                launches[e["args"]["correlation"]] = (
                    float(e["ts"]), ranges.get((e.get("pid"), e.get("tid")),
                                               []))
        self.host_ops = sorted(
            (float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)),
             e["name"]) for e in events
            if e.get("cat") in ("cpu_op", "user_annotation",
                                "cuda_runtime", "cuda_driver")
            and e is not w and self.window[0] <= float(e["ts"])
            <= self.window[1])
        self.ops = []
        for e in events:
            if e.get("cat") not in DEVICE_CATS:
                continue
            ts, dur = float(e["ts"]), float(e.get("dur", 0.0))
            if ts + dur < self.window[0] or ts > self.window[1]:
                continue
            launch = launches.get(e.get("args", {}).get("correlation"))
            inside = []
            if launch is not None:
                lts, rs = launch
                inside = [name for a, b, name in rs if a <= lts <= b]
            if CAPTURE in inside:
                continue
            self.ops.append(dict(name=e["name"], ts=ts, dur=dur,
                                 ranges=inside, cat=e["cat"]))

    @classmethod
    def from_file(cls, path, cycles, **kw):
        with open(path) as fh:
            events = json.load(fh)["traceEvents"]
        return cls(events, cycles, **kw)

    # ---------------------------------------------------------------- sums
    def window_s(self):
        return (self.window[1] - self.window[0]) / 1e6

    def busy_s(self):
        """Seconds of the window in which some device operation ran."""
        lo, hi = self.window
        return union_length([(max(o["ts"], lo), min(o["ts"] + o["dur"], hi))
                             for o in self.ops]) / 1e6

    def csrc_ops(self):
        """The port's own kernels in the trace; none where the trace holds
        fewer of them than the program launched (the profiler lost some),
        so that their readers read nothing rather than too little."""
        ops = [o for o in self.ops if CSRC_KERNEL.search(o["name"])]
        if self.launched is not None and len(ops) < self.launched:
            return []
        return ops

    def ms_per_cycle(self, ops):
        return sum(o["dur"] for o in ops) / 1e3 / self.cycles

    def in_ranges(self, names):
        """Device operations launched inside any range of ``names`` (the
        port's kernels excepted)."""
        names = set(names)
        return [o for o in self.ops if not CSRC_KERNEL.search(o["name"])
                and names.intersection(o["ranges"])]

    # ----------------------------------------------------------- breakdown
    def breakdown(self, top=10):
        """``{"device_ops": [[name, s]], "idle_gaps": [[name, s]]}``: the
        device operations that took most time (summed by name), and the
        device's idle time between them summed by the host operation
        running in the middle of each gap (the innermost one open then)."""
        by_name = {}
        for o in self.ops:
            key = short_name(o["name"])
            by_name[key] = by_name.get(key, 0.0) + o["dur"] / 1e6
        spans = []
        end = self.window[0]
        for o in sorted(self.ops, key=lambda o: o["ts"]):
            if o["ts"] > end:
                spans.append((end, o["ts"] - end))
            end = max(end, o["ts"] + o["dur"])
        if self.window[1] > end:
            spans.append((end, self.window[1] - end))
        gaps = {}
        for (ts, length), key in zip(spans, self.host_ops_at(
                [ts + 0.5 * length for ts, length in spans])):
            gaps[key] = gaps.get(key, 0.0) + length / 1e6

        def top_of(d):
            return [[k, v] for k, v in sorted(d.items(), key=lambda kv:
                                              -kv[1])[:top]]
        return {"device_ops": top_of(by_name), "idle_gaps": top_of(gaps)}

    def host_ops_at(self, times):
        """For each of the rising ``times``, the innermost (latest started)
        host operation still open then."""
        out, stack, i = [], [], 0
        for ts in times:
            while i < len(self.host_ops) and self.host_ops[i][0] <= ts:
                stack.append(self.host_ops[i])
                i += 1
            while stack and stack[-1][1] < ts:
                stack.pop()
            out.append(stack[-1][2] if stack else "(no host operation)")
        return out


def short_name(name):
    """A kernel's name without its argument list and return type."""
    name = name.replace("(anonymous namespace)::", "").split("(")[0]
    if name.startswith("void "):
        name = name[5:]
    return name[:120]


def _true(flag):
    return flag in ("true", "1")


def parse_kernel(name):
    """``(kernel, dtype, switches)`` of the name of one of the port's
    kernels: ``("negdiv_sweep", "double", {"recon", "dir", "solver",
    "scal"})``, ``("negdiv_scalars", "double", {"recon", "dir"})``,
    ``("fused_stage", "double", {"recon", "solver", "faces", "scal"})`` or
    ``("stage_scalars", "double", {"recon"})``; None for another."""
    m = NEGDIV.search(name)
    if m:
        return ("negdiv_sweep", m.group(1), dict(
            recon=int(m.group(2)), dir=int(m.group(3)),
            solver=int(m.group(4)),
            scal=_true(m.group(5))))
    m = SCALARS.search(name)
    if m:
        return ("negdiv_scalars", m.group(1), dict(recon=int(m.group(2)),
                                                   dir=int(m.group(3))))
    m = STAGE.search(name)
    if m:
        return ("fused_stage", m.group(1), dict(
            recon=int(m.group(2)), solver=int(m.group(3)),
            faces=_true(m.group(4)), scal=_true(m.group(5))))
    m = STAGE_SCALARS.search(name)
    if m:
        return ("stage_scalars", m.group(1), dict(recon=int(m.group(2))))
    return None

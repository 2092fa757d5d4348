"""One run of one cell: set-up, the measured window, the traced stretch and
the comparison with the plain reference.

The program is the configuration's (``programs/<program>.py``); the
window is one call of its timed entry (``Simulation.run`` for ``uniform``)
on the object that set-up built and warmed up through that entry; its
length in cycles is set from the probe cycles' time so that it lasts about
``--seconds``.  A per-cycle probe on the program's cycle call keeps each
cycle's dt, copies the states entering a cycle drawn from the seed and the
next one to the host on a side stream, and, with ``--trace 1``, opens the
traced stretch over the window's last ``TRACE_CYCLES`` cycles.  A state is
one tensor, or a tuple of tensors (a refined mesh's levels, in a fixed
order): the host copies take the same form, a pinned buffer per tensor.
"""

from __future__ import annotations

import contextlib
import gc
import os
import shutil
import sys
import tempfile
import time

import numpy as np
import torch

from . import compare
from .compare import each, tensors
from .spec import ROOT
from .trace import CAPTURE, WINDOW, Trace, host_reads

# the protocol, the same for every cell: cycles run before the probe, the
# probe's cycles that time one cycle, the fewest cycles of a window, and
# the window's last cycles that a traced run traces
WARMUP_CYCLES = 2
PROBE_CYCLES = 3
MIN_WINDOW_CYCLES = 5
TRACE_CYCLES = 12


def cache_env():
    """Every build and kernel cache of the program inside the checkout,
    at fixed paths: the port builds its libraries into ``build/`` by
    itself; PyTorch's extension and Triton caches are pointed there too."""
    build = ROOT / "build"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(build / "torch_ext"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(build / "triton"))


class CycleProbe:
    """Called before each cycle of the program with the state entering it:
    keeps the previous cycle's dt, copies the states entering cycles ``k``
    and ``k + 1`` into ``buffers`` (host memory, in the state's form; from
    a CUDA ``device`` on a side stream, so the copy overlaps the cycle),
    with their dt, c_h and t, and calls ``on_trace`` before cycle
    ``trace_start``.  On any other cycle it touches no tensor."""

    def __init__(self, k, buffers, device, trace_start=None,
                 on_trace=None):
        self.k = k
        self.buffers = buffers
        self.trace_start = trace_start
        self.on_trace = on_trace
        self.prev_dt = None
        self.captured = {}
        self.events = []
        # made now: creating a stream inside the window costs milliseconds
        self.side = (torch.cuda.Stream(device) if device.type == "cuda"
                     else None)

    def before(self, ncycle, u, dt, c_h, t):
        cyc = ncycle + 1
        if cyc == self.trace_start and self.on_trace is not None:
            self.on_trace()
        if cyc in (self.k, self.k + 1):
            buf = self.buffers[cyc - self.k]
            src = tensors(u)
            pairs = list(zip(tensors(buf), src, strict=True))
            with torch.profiler.record_function(CAPTURE):
                if src[0].is_cuda:
                    side = self.side
                    side.wait_stream(torch.cuda.current_stream(src[0].device))
                    with torch.cuda.stream(side):
                        for b, x in pairs:
                            b.copy_(x, non_blocking=True)
                    for x in src:
                        x.record_stream(side)
                    self.events.append(side.record_event())
                else:
                    for b, x in pairs:
                        b.copy_(x)
            self.captured[cyc] = dict(u=buf, dt=float(dt), c_h=float(c_h),
                                      t=float(t), dt_prev=self.prev_dt)
        self.prev_dt = float(dt)

    def wait(self):
        for ev in self.events:
            ev.synchronize()


def csrc_launches():
    """The port's own count of its kernels' launches so far (the
    ``launches`` counters of ``solver.sweep`` and ``solver.stage``)."""
    from athenapk_tpu_torch.solver import stage, sweep
    return sum(getattr(f, "launches", 0) for mod in (sweep, stage)
               for f in vars(mod).values() if callable(f))


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_cell(cell, seed, seconds, trace=False, device="cuda", t_start=None,
             overrides=None, control=False):
    """One run of ``cell`` (a ``spec.Cell``); -> the run's record: the
    window's numbers, the trace (``--trace 1``), and under ``checks`` the
    compared numbers with their limits; with ``control`` also the control's
    numbers under ``control`` (``control.py``; the benchmark's runs do not
    compute them)."""
    t_start = time.perf_counter() if t_start is None else t_start
    cache_env()
    tmp = tempfile.mkdtemp(prefix="benchmark-")
    try:
        return _run(cell, seed, seconds, trace, torch.device(device),
                    t_start, overrides, tmp, control)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _run(cell, seed, seconds, trace, device, t_start, overrides, tmp,
         control):
    log = sys.stderr
    prog = cell.program()
    deck = cell.deck(seed, overrides=overrides)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    with contextlib.redirect_stdout(log):
        sim = prog.build(deck, device)
        u = prog.state(sim)
        u0_prog = each(u, lambda x: x.detach().to("cpu", copy=True))
        buffers = [each(u, lambda x: torch.empty(
            x.shape, dtype=x.dtype, pin_memory=device.type == "cuda"))
            for _ in range(2)]
        del u
        prog.run_more(sim, WARMUP_CYCLES)
        sync(device)
        t0 = time.perf_counter()
        prog.run_more(sim, PROBE_CYCLES)
        sync(device)
        t_cycle = (time.perf_counter() - t0) / PROBE_CYCLES
    n_window = max(MIN_WINDOW_CYCLES, int(round(seconds / t_cycle)))
    first = sim.ncycle + 1
    last = sim.ncycle + n_window
    rng = np.random.default_rng([seed % 2 ** 64, 1])
    k = int(rng.integers(first + 1, last))      # first+1 .. last-1

    prof = {}
    counter = {"reads": 0}
    trace_cycles = min(TRACE_CYCLES, n_window - 1)

    def on_trace():
        from torch.profiler import ProfilerActivity, profile
        sync(device)
        acts = [ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        prof["p"] = profile(activities=acts)
        prof["p"].start()
        prof["launches"] = csrc_launches()
        prof["reads"] = host_reads(counter)
        prof["reads"].__enter__()
        prof["range"] = torch.profiler.record_function(WINDOW)
        prof["range"].__enter__()

    probe = CycleProbe(k, buffers, device, trace_start=last - trace_cycles + 1
                       if trace else None, on_trace=on_trace)
    prog.install_probe(sim, probe.before)
    if trace:
        prog.install_ranges(sim)

    sync(device)
    setup_s = time.perf_counter() - t_start
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(log):
        prog.run_more(sim, n_window)       # ends in a synchronise
    window = time.perf_counter() - t0
    print(f"set-up {setup_s:.3f} s; window {n_window} cycles in "
          f"{window:.3f} s", file=log)
    if trace:
        prof["range"].__exit__(None, None, None)
        prof["reads"].__exit__(None, None, None)
        prof["p"].stop()
        prof["launches"] = csrc_launches() - prof["launches"]
    prog.check_window(sim, last)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    layout = prog.layout(sim)
    probe.wait()
    out = dict(attempted=n_window, setup_s=setup_s,
               zone_cycles_per_s=prog.zones(sim) * n_window / window,
               peak_bytes=peak, sampled_cycle=k)
    if trace:
        path = os.path.join(tmp, "trace.json")
        prof["p"].export_chrome_trace(path)
        del prof["p"]
        tr_obj = Trace.from_file(path, trace_cycles,
                                 host_reads=counter["reads"], layout=layout,
                                 launched=prof["launches"])
        os.remove(path)
        out["trace"] = tr_obj
    cap = probe.captured
    del sim, probe
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    mod = cell.reference()
    judge = getattr(mod, "readings", compare.readings)
    ref = mod.sim(deck, device)
    nums = judge(ref, u0_prog, cap, layout["fluid"])
    print(f"reference {time.perf_counter() - t0:.3f} s", file=log)
    limits = cell.config["limits"]
    out["checks"] = {name: (nums[name], limits[name]) for name in limits}
    if control:
        out["control"] = judge(ref, None, cap, layout["fluid"],
                               model=mod.control(deck, device))
    return out

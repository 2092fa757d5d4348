"""The readers of the program's own ranges (``cycle``, ``cons_to_prim``,
``stage_update``, ``estimate_timestep``) on a synthetic trace, with the
first traced cycle cut as the harness cuts it, and on traces that lost
ranges or never had them; on the card (``-m cuda``), at 64^3, the four
read a number and the ``host_read`` ranges match the counted reads."""

import pytest

from bench_helpers import WORKLOADS, run

from benchmark.harness.spec import Cell
from benchmark.harness.trace import WINDOW, Trace

NEW = ("eos_ms_per_cycle", "stage_update_ms_per_cycle",
       "dt_estimate_ms_per_cycle", "cycle_idle_share")
SWEEP = ("void negdiv_sweep_kernel<double, 5, 1, 5, false>(double const*, "
         "double*, double*, Geom, Params<double>, ReconK<double>, double, "
         "int, int, double*)")


def ev(cat, name, ts, dur, **args):
    e = {"cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 1,
         "tid": 1}
    if args:
        e["args"] = args
    return e


def launch(ts, corr, kernel, k_ts, k_dur, cat="kernel"):
    return [ev("cuda_runtime", "cudaLaunchKernel", ts, 1, correlation=corr),
            ev(cat, kernel, k_ts, k_dur, correlation=corr)]


def synthetic(last_cycle=True):
    """A 200 us window over 3 traced cycles: the first cut (its range
    began before the window), the second 60-120 and the third 130-190 us.
    Each launches 10 us in ``cons_to_prim``, the second and third 10 us in
    ``stage_update`` and 4 + 1 us (a kernel and the read's copy) in
    ``estimate_timestep``; the second also a 20 us sweep kernel."""
    events = [
        ev("user_annotation", WINDOW, 0, 200),
        ev("user_annotation", "cycle", -10, 60),
        ev("user_annotation", "cons_to_prim", 15, 10),
        *launch(16, 1, "void at::elementwise_kernel<a>", 20, 10),
        ev("user_annotation", "cycle", 60, 60),
        ev("user_annotation", "cons_to_prim", 62, 8),
        *launch(63, 2, "void at::elementwise_kernel<b>", 64, 10),
        ev("user_annotation", "fused_lane_sweep", 70, 28),
        *launch(71, 3, SWEEP, 74, 20),
        ev("user_annotation", "stage_update", 90, 8),
        *launch(91, 4, "void at::elementwise_kernel<c>", 94, 10),
        ev("user_annotation", "estimate_timestep", 100, 18),
        *launch(101, 5, "void at::reduce_kernel<d>", 104, 4),
        ev("user_annotation", "host_read", 110, 8),
        *launch(111, 6, "Memcpy DtoH", 112, 1, cat="gpu_memcpy"),
    ]
    if last_cycle:
        events.append(ev("user_annotation", "cycle", 130, 60))
    events += [
        ev("user_annotation", "cons_to_prim", 132, 8),
        *launch(133, 7, "void at::elementwise_kernel<b>", 135, 10),
        ev("user_annotation", "stage_update", 150, 8),
        *launch(151, 8, "void at::elementwise_kernel<c>", 152, 10),
        ev("user_annotation", "estimate_timestep", 170, 15),
        *launch(171, 9, "void at::reduce_kernel<d>", 172, 4),
        ev("user_annotation", "host_read", 180, 5),
        *launch(181, 10, "Memcpy DtoH", 182, 1, cat="gpu_memcpy"),
    ]
    return events


def readings(events):
    cell = Cell(WORKLOADS[0])
    run_ = {"trace": Trace(events, cycles=3, host_reads=3)}
    return {name: cell.metric_reader(name).read(run_)
            for name in NEW + ("device_idle_share",)}


def test_readers_of_the_program_ranges():
    got = readings(synthetic())
    assert got["eos_ms_per_cycle"] == pytest.approx(0.030 / 3)
    assert got["stage_update_ms_per_cycle"] == pytest.approx(0.020 / 3)
    assert got["dt_estimate_ms_per_cycle"] == pytest.approx(0.010 / 3)
    # 60-190 us: busy 64-108, 112-113 and 25 us in the third cycle; the
    # cut first cycle's 10 us and the window's opening are left out
    assert got["cycle_idle_share"] == pytest.approx(100 * (1 - 70 / 130))
    assert got["device_idle_share"] == pytest.approx(100 * (1 - 80 / 200))
    assert got["cycle_idle_share"] < got["device_idle_share"]


def test_lost_or_missing_cycle_ranges_read_nothing():
    """A trace holding fewer whole ``cycle`` ranges than its cycles less
    one (the profiler lost one), or none (a program without them), gives
    the four readers nothing to read."""
    lost = readings(synthetic(last_cycle=False))
    bare = readings([e for e in synthetic() if e["name"] != "cycle"])
    for got in (lost, bare):
        assert all(got[name] is None for name in NEW), got
        assert got["device_idle_share"] is not None


def test_every_new_metric_is_a_per_layer_entry():
    cell = Cell(WORKLOADS[0])
    entries = {m["name"]: m for m in cell.per_layer}
    for name in NEW:
        assert entries[name]["source"] == "device_trace"
        assert entries[name]["moves"] == "zone_cycles_per_s"


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("workload", WORKLOADS)
def test_card_reads_the_ranges_and_marks_every_host_read(workload, card):
    cell, out = run(workload, 2 ** 32 + 11, device=card, n=64, trace=True)
    tr = out["trace"]
    got = {name: cell.metric_reader(name).read(out)
           for name in NEW + ("host_reads_per_cycle", "device_idle_share")}
    assert all(v is not None for v in got.values()), got
    marked = sum(1 for _, _, name in tr.host_ops if name == "host_read")
    assert marked / tr.cycles == got["host_reads_per_cycle"], got
    assert got["cycle_idle_share"] <= got["device_idle_share"], got
    assert got["eos_ms_per_cycle"] > 0.0
    assert got["stage_update_ms_per_cycle"] > 0.0

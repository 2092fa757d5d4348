"""The trace arithmetic on a synthetic trace, and a launch's bytes and
operations on known shapes."""

import pytest

from bench_helpers import ROOT  # noqa: F401

from benchmark.harness import roofline
from benchmark.harness.trace import (CAPTURE, WINDOW, Trace, parse_kernel,
                                     union_length)


def ev(cat, name, ts, dur, **args):
    e = {"cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 1,
         "tid": 1}
    if args:
        e["args"] = args
    return e


SWEEP = ("void negdiv_sweep_kernel<double, 5, 2, 5, false>(double const*, "
         "double*, double*, Geom, Params<double>, ReconK<double>, double, "
         "int, int, double*)")
SCAL = "void negdiv_scalars_kernel<double, 1, 3>(double const*, double*)"


def synthetic():
    """A 100 us window over 2 cycles: a sweep launch, a source-range
    kernel, a glue kernel and a harness copy; the device busy 10-30,
    25-45 and 60-70 us."""
    return [
        ev("user_annotation", WINDOW, 0, 100),
        ev("user_annotation", "problem_source", 40, 10),
        ev("user_annotation", CAPTURE, 80, 5),
        ev("cuda_runtime", "cudaLaunchKernel", 5, 1, correlation=1),
        ev("cuda_runtime", "cudaLaunchKernel", 42, 1, correlation=2),
        ev("cuda_runtime", "cudaLaunchKernel", 55, 1, correlation=3),
        ev("cuda_runtime", "cudaMemcpyAsync", 81, 1, correlation=4),
        ev("kernel", SWEEP, 10, 20, correlation=1),
        ev("kernel", "void at::elementwise_kernel<...>", 25, 20,
           correlation=2),
        ev("kernel", "void at::reduce_kernel<...>", 60, 10, correlation=3),
        ev("gpu_memcpy", "Memcpy DtoH", 82, 15, correlation=4),
        ev("kernel", "outside", 150, 10, correlation=9),
    ]


def test_union_of_intervals():
    assert union_length([(0, 10), (5, 20), (30, 40), (35, 36)]) == 30
    assert union_length([]) == 0


def test_sums_by_range_and_idle_share():
    tr = Trace(synthetic(), cycles=2, host_reads=3)
    names = sorted(o["name"][:20] for o in tr.ops)
    assert len(tr.ops) == 3          # the copy and the later kernel left out
    assert names[0].startswith("void at::")
    assert tr.window_s() == pytest.approx(100e-6)
    assert tr.busy_s() == pytest.approx(45e-6)     # 10-45 and 60-70
    assert tr.ms_per_cycle(tr.csrc_ops()) == pytest.approx(0.01)
    src = tr.in_ranges(["problem_source"])
    assert [o["dur"] for o in src] == [20.0]
    bd = tr.breakdown()
    assert bd["device_ops"][0] == ["negdiv_sweep_kernel<double, 5, 2, 5, "
                                   "false>", pytest.approx(20e-6)]
    assert sum(v for _, v in bd["idle_gaps"]) == pytest.approx(55e-6)


def test_readers_on_the_synthetic_trace():
    from benchmark.harness.spec import Cell
    cell = Cell("linwave-mhd-uniform-256")
    tr = Trace(synthetic(), cycles=2, host_reads=3,
               layout=dict(shape=(1, 9, 4, 4, 4), itemsize=8,
                           fluid="glmmhd", nscalars=0))
    run = {"trace": tr}
    got = {m["name"]: cell.metric_reader(m["name"]).read(run)
           for m in cell.per_layer}
    assert got["host_reads_per_cycle"] == 1.5
    assert got["kernel_ms_per_cycle"] == pytest.approx(0.010)
    # the kernel in the program's source range is neither kernel nor glue
    assert got["glue_ms_per_cycle"] == pytest.approx(0.005)
    assert got["device_idle_share"] == pytest.approx(55.0)
    assert 0 < got["negdiv_sweep_roofline"] < 100


def test_lost_kernels_read_nothing():
    """A trace holding fewer of the port's kernels than the program
    launched gives their readers nothing to read."""
    assert len(Trace(synthetic(), cycles=2, launched=1).csrc_ops()) == 1
    assert Trace(synthetic(), cycles=2, launched=2).csrc_ops() == []


def test_kernel_names_parse():
    assert parse_kernel(SWEEP) == ("negdiv_sweep", "double", dict(
        recon=5, dir=2, solver=5, scal=False))
    assert parse_kernel(SCAL) == ("negdiv_scalars", "double",
                                  dict(recon=1, dir=3))
    assert parse_kernel("void at::reduce_kernel<...>") is None


def test_launch_bytes_and_operations():
    layout = dict(shape=(1, 10, 8, 8, 8), itemsize=8, fluid="glmmhd",
                  nscalars=1)
    cells = 512
    case = {"ops_per_cell": {"1": 100.0, "2": 110.0, "3": 120.0}}
    # first direction: 9 rows read, 9 written, mass fluxes written
    assert roofline.launch_cost("negdiv_sweep", dict(dir=1, scal=True),
                                case, layout) == (19 * cells * 8,
                                                  100.0 * cells)
    # later directions also read what they add to
    assert roofline.launch_cost("negdiv_sweep", dict(dir=3, scal=False),
                                case, layout) == (27 * cells * 8,
                                                  120.0 * cells)
    scal = {"ops_per_cell_per_scalar": {"2": 7.0}}
    assert roofline.launch_cost("negdiv_scalars", dict(dir=2), scal,
                                layout) == (4 * cells * 8, 7.0 * cells)
    pk = roofline.peaks()
    t = roofline.least_seconds(3.35e12, 34e12 / 2, "double", pk)
    assert t == pytest.approx(1.0)
    assert roofline.least_seconds(1.0, 34e12, "double", pk) == \
        pytest.approx(1.0)


def test_every_case_file_is_counted():
    known = roofline.cases()
    assert ("negdiv_sweep", (("recon", 5), ("solver", 5))) in known
    for data in known.values():
        per = data.get("ops_per_cell") or data["ops_per_cell_per_scalar"]
        assert set(per) == {"1", "2", "3"}
        assert all(v > 0 for v in per.values())

"""The galaxy-cluster cell (``cluster-agn-320``) on the CPU at 16^3 over
+-0.00625 Mpc, the cell's own 0.78 kpc cells (at the cell's box the AGN
regions would hold no cell): the program agrees with the plain reference
and the float32 control fails it; a broken source reads ``correct``
false; the seed changes the state and not the work; and the cell's three
readers on synthetic traces (each reads nothing on a trace without whole
``cycle`` ranges or without a range it reads)."""

import pytest

from bench_helpers import ROOT, correct

from benchmark.harness.cell import MIN_WINDOW_CYCLES, run_cell
from benchmark.harness.spec import Cell
from benchmark.harness.trace import WINDOW, Trace

CELL = "cluster-agn-320"
READERS = ("cluster_source_ms_per_cycle", "agn_ms_per_cycle",
           "cooling_ms_per_cycle")
DRAWN = ("rseed_v", "rseed_b", "jet_phi0")


def small(n=16, half=0.00625):
    """Deck keys that cut the cell to ``n``^3 cells over +-``half`` Mpc,
    with the cooling table found from any working directory."""
    ov = {"cooling/table_filename":
          str(ROOT / "benchmark" / "configs" / "cluster_powerlaw.cooling")}
    for i in (1, 2, 3):
        ov[f"parthenon/mesh/nx{i}"] = str(n)
        ov[f"parthenon/meshblock/nx{i}"] = str(n)
        ov[f"parthenon/mesh/x{i}min"] = str(-half)
        ov[f"parthenon/mesh/x{i}max"] = str(half)
    return ov


def run(seed, **kw):
    cell = Cell(CELL)
    return cell, run_cell(cell, seed, 0.3, device="cpu", overrides=small(),
                          **kw)


def over_limits(nums, out):
    return [k for k, (_, lim) in out["checks"].items()
            if not nums[k] <= lim]


def test_program_agrees_and_control_fails():
    cell, out = run(2 ** 33 + 17, control=True)
    assert correct(out), out["checks"]
    assert out["attempted"] >= MIN_WINDOW_CYCLES
    assert over_limits(out["control"], out), out["control"]


def test_broken_source_reads_incorrect(monkeypatch):
    """SN Ia left out of the program's unsplit source: the cycle differs
    from the reference's."""
    from athenapk_tpu_torch.pgen.cluster.snia_stellar_feedback import \
        SNIAFeedback
    from benchmark.harness.result import result_line
    monkeypatch.setattr(SNIAFeedback, "apply",
                        lambda self, u, prim, beta_dt, r: u)
    cell, out = run(11)
    line = result_line(cell, out, trace=False, kind="cpu")
    assert line["correct"] is False
    value, limit = out["checks"]["cycle_err"]
    assert not value <= limit
    value, limit = out["checks"]["start_err"]
    assert value <= limit


def test_seeds_change_the_state_not_the_work():
    """Two seeds draw other perturbations and another jet angle: the
    decks differ in those three keys alone, and the initial states differ
    with the same shape."""
    from benchmark.reference import cluster_agn_portdeck as reference
    cell = Cell(CELL)
    a, b = cell.deck(1), cell.deck(2 ** 40 + 3)
    assert a != b
    strip = [ln for ln in a.splitlines() if not ln.startswith(DRAWN)]
    assert strip == [ln for ln in b.splitlines()
                     if not ln.startswith(DRAWN)]
    assert "precision = double" in a and "nx1 = 320" in a
    ua, ub = (reference.sim(cell.deck(s, small()), "cpu").initial_state()
              for s in (1, 2 ** 40 + 3))
    assert ua.shape == ub.shape
    assert not bool((ua == ub).all())


def ev(cat, name, ts, dur, **args):
    e = {"cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 1,
         "tid": 1}
    if args:
        e["args"] = args
    return e


def launch(ts, corr, k_ts, k_dur):
    return [ev("cuda_runtime", "cudaLaunchKernel", ts, 1, correlation=corr),
            ev("kernel", f"void at::elementwise_kernel<{corr}>", k_ts, k_dur,
               correlation=corr)]


def synthetic(nested=True, cycles=True):
    """A 200 us window over 3 traced cycles (the first cut), the last two
    each launching 10 us in ``problem_source`` (4 of it in
    ``agn_feedback``, 1 of that in ``agn_triggering`` and 1 in
    ``magnetic_tower``), 3 us in ``tabular_cooling``, 2 in ``cooling_dt``
    inside ``estimate_timestep``, 5 in ``stellar_feedback`` and 1 in
    ``clips``; ``nested=False`` drops the ranges new in the program
    (``agn_triggering``, ``magnetic_tower``, ``cooling_dt``)."""
    events = [ev("user_annotation", WINDOW, 0, 200),
              ev("user_annotation", "cycle", -10, 60)]
    corr = 0
    for start in (60, 130):
        if cycles:
            events.append(ev("user_annotation", "cycle", start, 60))
        events += [
            ev("user_annotation", "tabular_cooling", start + 1, 4),
            ev("user_annotation", "problem_source", start + 6, 20),
            ev("user_annotation", "agn_feedback", start + 10, 10),
            ev("user_annotation", "agn_triggering", start + 11, 3),
            ev("user_annotation", "magnetic_tower", start + 15, 3),
            ev("user_annotation", "stellar_feedback", start + 30, 6),
            ev("user_annotation", "clips", start + 37, 2),
            ev("user_annotation", "estimate_timestep", start + 40, 10),
            ev("user_annotation", "cooling_dt", start + 41, 3),
        ]
        for ts, dur in ((start + 1.5, 3), (start + 7, 6), (start + 10.5, 2),
                        (start + 11.5, 1), (start + 15.5, 1),
                        (start + 30.5, 5), (start + 37.5, 1),
                        (start + 41.5, 2), (start + 45, 1)):
            corr += 1
            events += launch(ts, corr, ts + 0.2, dur)
    if not nested:
        events = [e for e in events if e["name"] not in
                  ("agn_triggering", "magnetic_tower", "cooling_dt")]
    return events


def readings(events):
    cell = Cell(CELL)
    run_ = {"trace": Trace(events, cycles=3, host_reads=3)}
    return {name: cell.metric_reader(name).read(run_) for name in READERS}


def test_readers_of_the_cluster_ranges():
    got = readings(synthetic())
    # per traced cycle: 6 + 2 + 1 + 1 us in problem_source and 5 + 1 in the
    # split source's ranges; 2 + 1 + 1 in agn_feedback; 3 + 2 of cooling
    assert got["cluster_source_ms_per_cycle"] == pytest.approx(
        2 * 16 / 1e3 / 3)
    assert got["agn_ms_per_cycle"] == pytest.approx(2 * 4 / 1e3 / 3)
    assert got["cooling_ms_per_cycle"] == pytest.approx(2 * 5 / 1e3 / 3)


def test_missing_ranges_read_nothing():
    """Without whole ``cycle`` ranges none of the three reads; without the
    program's new ranges (its parent) the AGN and cooling readers read
    nothing and the sources' reader still reads."""
    bare = readings(synthetic(cycles=False))
    assert all(v is None for v in bare.values()), bare
    parent = readings(synthetic(nested=False))
    assert parent["agn_ms_per_cycle"] is None
    assert parent["cooling_ms_per_cycle"] is None
    assert parent["cluster_source_ms_per_cycle"] == pytest.approx(
        2 * 16 / 1e3 / 3)


def test_readers_are_per_layer_entries_of_the_cell_alone():
    cell = Cell(CELL)
    entries = {m["name"]: m for m in cell.per_layer}
    for name in READERS:
        assert entries[name]["source"] == "device_trace"
        assert entries[name]["moves"] == "zone_cycles_per_s"
        assert entries[name]["workloads"] == [CELL]
    wave = {m["name"] for m in Cell("linwave-mhd-uniform-256").per_layer}
    assert not wave & set(READERS)

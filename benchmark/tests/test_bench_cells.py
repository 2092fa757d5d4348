"""The comparison that decides ``correct``, on the CPU at 16^3: the
program agrees with each configuration's plain reference, the control
(the reference in the precision below the configuration's) fails it, and
a run with the timed path broken underneath reads ``correct`` false."""

import pytest

from bench_helpers import WORKLOADS, correct, over_limits, run

from benchmark.harness.cell import MIN_WINDOW_CYCLES


@pytest.mark.parametrize("workload", WORKLOADS)
def test_program_agrees_and_control_fails(workload):
    cell, out = run(workload, 2 ** 33 + 17, control=True)
    assert correct(out), out["checks"]
    assert out["attempted"] >= MIN_WINDOW_CYCLES
    assert over_limits(out["control"], out), out["control"]


def _unchanged(step):
    def f(self, u, dt, c_h, t=0.0, emit_dt=False):
        return u.clone()
    return f


def _half(step):
    def f(self, u, dt, c_h, t=0.0, emit_dt=False):
        out = step(self, u, dt, c_h, t)
        nz = out.shape[2]
        out[:, :, : nz // 2] = u[:, :, : nz // 2]
        return out
    return f


def _altered(step):
    def f(self, u, dt, c_h, t=0.0, emit_dt=False):
        out = step(self, u, dt, c_h, t)
        _, _, nz, ny, nx = out.shape
        out[0, 0, nz // 2, ny // 2, nx // 2] *= 1.0 + 1e-6
        return out
    return f


@pytest.mark.parametrize("fault", [_unchanged, _half, _altered],
                         ids=["state_unchanged", "half_mesh_left_out",
                              "answer_altered"])
@pytest.mark.parametrize("workload", WORKLOADS)
def test_broken_step_reads_incorrect(workload, fault, monkeypatch):
    from athenapk_tpu_torch.solver.hydro_pkg import HydroPackage
    from benchmark.harness.result import result_line
    monkeypatch.setattr(HydroPackage, "step", fault(HydroPackage.step))
    cell, out = run(workload, 7)
    line = result_line(cell, out, trace=False, kind="cpu")
    assert line["correct"] is False
    assert line["failed"] >= 1
    assert list(line)[-1] == "checks"
    value, limit = out["checks"]["cycle_err"]
    assert not value <= limit


def test_seeds_change_the_state_not_the_work():
    """Two seeds draw different initial states of the same size."""
    from benchmark.harness.spec import Cell
    cell = Cell(WORKLOADS[0])
    a, b = cell.deck(1), cell.deck(2 ** 40 + 3)
    assert a != b
    strip = [ln for ln in a.splitlines()
             if not ln.startswith(("amp", "vflow"))]
    assert strip == [ln for ln in b.splitlines()
                     if not ln.startswith(("amp", "vflow"))]
    assert "precision = double" in a and "wave_flag = 0" in a


def test_cell_refuses_other_chips_than_its_program():
    """A cell that asks for four chips of a one-chip program is refused
    before anything runs, rather than run on one card."""
    import json

    from benchmark.harness.spec import Cell
    from bench_helpers import ROOT
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["workloads"].append(dict(bench["workloads"][0], name="four",
                                   chips=4))
    assert Cell(WORKLOADS[0], bench=bench).program().CHIPS == 1
    with pytest.raises(ValueError, match="asks for 4 chip"):
        Cell("four", bench=bench).program()

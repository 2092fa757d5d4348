"""The benchmark's galaxy-cluster cell (``cluster-agn-320``) on the CPU at
32^3 over +-0.0125 Mpc, the cell's 0.78 kpc cells: the port's uniform
``Simulation`` on the configuration's deck equals the plain reference
(``benchmark/reference/cluster_agn_portdeck.py``, which imports nothing of
the port) within the configuration's limits in its initial state, the dt
of its first two cycles and its first VL2 cycle, on three seeds of the
cell's traffic; with gravity switched off in the port the cycle reads over
its limit, and the float32 control over at least one limit.  The numbers
are the harness's (``benchmark/harness/compare.py:readings``), which
judges this cell."""

import json
from pathlib import Path

import pytest

from athenapk_tpu_torch.config.parameter_input import ParameterInput
from athenapk_tpu_torch.driver import Simulation
from athenapk_tpu_torch.pgen.cluster import pgen as port_pgen
from benchmark.harness import compare
from benchmark.harness.spec import Cell
from benchmark.reference import cluster_agn_portdeck as reference

ROOT = Path(__file__).resolve().parents[1]
CELL = "cluster-agn-320"
TABLE = ROOT / "benchmark" / "configs" / "cluster_powerlaw.cooling"
SEEDS = (7, 2 ** 31 + 11, 2 ** 40 + 3)


def small(n=32, half=0.0125):
    """Deck keys that cut the cell to ``n``^3 cells over +-``half`` Mpc,
    with the cooling table found from any working directory."""
    ov = {"cooling/table_filename": str(TABLE)}
    for i in (1, 2, 3):
        ov[f"parthenon/mesh/nx{i}"] = str(n)
        ov[f"parthenon/meshblock/nx{i}"] = str(n)
        ov[f"parthenon/mesh/x{i}min"] = str(-half)
        ov[f"parthenon/mesh/x{i}max"] = str(half)
    return ov


def limits():
    cfg = json.loads((ROOT / "benchmark" / "configs"
                      / "cluster_agn_portdeck.json").read_text())
    return cfg["limits"]


def port_cycles(deck, ncycles=2):
    """The port's initial state, and the states entering its first
    ``ncycles`` cycles with the dt, c_h, t and previous dt each took (the
    harness's capture of cycles k and k + 1, here k = 1)."""
    sim = Simulation(ParameterInput.from_string(deck), quiet=True,
                     device="cpu")
    u0 = sim.u.clone()
    cap, prev = {}, [None]
    inner = sim._cycle

    def cycle(dt_eff, c_h):
        cap[sim.ncycle + 1] = dict(u=sim.u.clone(), dt=float(dt_eff),
                                   c_h=float(c_h), t=float(sim.t),
                                   dt_prev=prev[0])
        prev[0] = float(dt_eff)
        return inner(dt_eff, c_h)

    sim._cycle = cycle
    sim.nlim = ncycles
    sim.run()
    return sim, u0, cap


def compared(nums):
    return {k: nums[k] for k in limits()}


@pytest.mark.parametrize("seed", SEEDS)
def test_port_equals_the_reference(seed):
    deck = Cell(CELL).deck(seed, small())
    sim, u0, cap = port_cycles(deck)
    assert sim._split_cycle()       # the split source and the accretion cap
    ref = reference.sim(deck, "cpu")
    nums = compare.readings(ref, u0, cap, sim.cfg.fluid)
    lim = limits()
    assert all(nums[k] <= lim[k] for k in lim), compared(nums)
    # the first cycle's dt is the least of the three limits
    dts = ref.dt_limits(cap[1]["u"], cap[1]["t"])
    assert set(dts) == {"hyp", "cool", "acc"}
    assert cap[1]["dt"] == pytest.approx(min(dts.values()), rel=1e-12)


def test_port_without_gravity_reads_over_the_cycle_limit(monkeypatch):
    monkeypatch.setattr(port_pgen, "gravitational_field_source",
                        lambda gravity, u, *a: u)
    deck = Cell(CELL).deck(SEEDS[0], small())
    sim, u0, cap = port_cycles(deck)
    nums = compare.readings(reference.sim(deck, "cpu"), u0, cap,
                            sim.cfg.fluid)
    assert nums["start_err"] <= limits()["start_err"]
    assert not nums["cycle_err"] <= limits()["cycle_err"], compared(nums)


def test_float32_control_reads_over_a_limit():
    deck = Cell(CELL).deck(SEEDS[1], small())
    sim, u0, cap = port_cycles(deck)
    ref = reference.sim(deck, "cpu")
    nums = compare.readings(ref, None, cap, sim.cfg.fluid,
                            model=reference.control(deck, "cpu"))
    over = [k for k, lim in limits().items() if not nums[k] <= lim]
    assert over, compared(nums)


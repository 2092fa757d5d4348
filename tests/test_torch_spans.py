"""The port's profiler ranges on the CPU: a cycle of the benchmark's wave
deck holds its stage's ranges in the expected counts, and every read of a
tensor to the host that a run makes lies inside a ``host_read`` range.

The reads are counted as ``benchmark/harness/trace.py:host_reads`` counts
them on the card (``item``, ``tolist``, ``cpu``, ``float``, ``int``,
``bool``), here on any device, each call marked by a range of its own
whose place in the trace is checked: on the wave, a cooling deck with
subcycling, the cluster with its ``.hst`` columns and an adaptive blast.
``numpy`` is left out: on a CUDA tensor it raises, so a read of the card
always goes through ``cpu`` first, while on the CPU it is the zero-copy
view that the plain versions take (``core/ieee.py``,
``srcterms/tabular_cooling.py``)."""

import contextlib
import json
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from athenapk_tpu_torch.amr.driver import SmrSimulation
from athenapk_tpu_torch.config.parameter_input import ParameterInput
from athenapk_tpu_torch.driver import Simulation
from torch_decks import (cloud_deck, cluster_deck, write_cluster_table,
                         write_cooling_table)

ROOT = Path(__file__).resolve().parents[1]
CYCLES = 3
READS = ("item", "tolist", "cpu", "__float__", "__int__", "__bool__")
MARK = "tensor_read"
HST_BLOCK = """
<parthenon/output1>
file_type = hst
dt = -1.0
"""


def wave_deck(n=16):
    """The benchmark cell's deck (``benchmark/configs/``) at ``n``^3."""
    cfg = json.loads((ROOT / "benchmark" / "configs"
                      / "linwave3d_mhd_wenoz.json").read_text())
    blocks = {b: dict(kv) for b, kv in cfg["deck"].items()}
    for i in (1, 2, 3):
        blocks["parthenon/mesh"][f"nx{i}"] = str(n)
        blocks["parthenon/meshblock"][f"nx{i}"] = str(n)
    blocks["parthenon/time"]["nlim"] = str(CYCLES)
    return "\n".join(f"<{b}>\n" + "".join(f"{k} = {v}\n"
                                          for k, v in kv.items())
                     for b, kv in blocks.items())


@contextlib.contextmanager
def marked_reads():
    """Wrap each read of a tensor to the host in a ``tensor_read`` range."""
    saved = {n: getattr(torch.Tensor, n) for n in READS}

    def marking(fn):
        def call(self, *a, **k):
            with record_function(MARK):
                return fn(self, *a, **k)
        return call

    for n in READS:
        setattr(torch.Tensor, n, marking(saved[n]))
    try:
        yield
    finally:
        for n, fn in saved.items():
            setattr(torch.Tensor, n, fn)


def traced_run(text, reads=False):
    """``[(name, start, end)]`` of the ranges of a run of the deck
    ``text`` (or a ``ParameterInput``) on the CPU, the run alone after
    set-up, sorted by start."""
    pin = ParameterInput.from_string(text) if isinstance(text, str) \
        else text
    refined = pin.get_or_add_string("parthenon/mesh", "refinement",
                                    "none") != "none"
    sim = (SmrSimulation if refined else Simulation)(pin, quiet=True,
                                                     device="cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with marked_reads() if reads else contextlib.nullcontext():
            sim.run()
    assert sim.ncycle == CYCLES
    spans = [(e.name, e.time_range.start, e.time_range.end)
             for e in prof.events() if e.device_type.name == "CPU"
             and e.name in (MARK, "cycle", "host_read", "cons_to_prim",
                            "stage_update", "estimate_timestep")]
    return sorted(spans, key=lambda s: s[1])


def inside(span, outer):
    return outer[1] <= span[1] and span[2] <= outer[2]


def test_wave_cycle_holds_its_stage_ranges():
    """Per cycle of RK3 on the sweep path: 3 stages' EOS and the new
    state's, 3 updates, one dt estimate."""
    spans = traced_run(wave_deck())
    cycles = [s for s in spans if s[0] == "cycle"]
    assert len(cycles) == CYCLES
    for cyc in cycles:
        held = [s[0] for s in spans if s is not cyc and inside(s, cyc)]
        assert {n: held.count(n) for n in set(held)} == {
            "cons_to_prim": 4, "stage_update": 3, "estimate_timestep": 1,
            "host_read": 1}


def _cooling(tmp_path):
    table = write_cooling_table(tmp_path / "cool.dat")
    return cloud_deck(table, nlim=CYCLES, integrator="rk12")


def _cluster(tmp_path):
    table = write_cluster_table(tmp_path / "cluster.cool")
    return cluster_deck(n=16, half=0.02, nlim=CYCLES, table=table) \
        + HST_BLOCK


def _adaptive(tmp_path):
    """``inputs/blast_3d_adaptive.in`` flapping every other cycle, its
    ``.hst`` row every cycle: the refined loop's dt and tags, the
    remesh."""
    return ParameterInput.from_file(
        str(ROOT / "inputs" / "blast_3d_adaptive.in"),
        [f"parthenon/time/nlim={CYCLES}", "parthenon/mesh/derefine_count=1",
         "parthenon/output0/dt=-1"])


@pytest.mark.parametrize("deck", [
    pytest.param(lambda tmp: wave_deck(), id="wave"),
    pytest.param(_cooling, id="cooling-rk12"),
    pytest.param(_cluster, id="cluster-hst"),
    pytest.param(_adaptive, id="adaptive-blast"),
])
def test_every_host_read_lies_in_a_host_read_range(deck, tmp_path,
                                                   monkeypatch):
    monkeypatch.chdir(tmp_path)
    spans = traced_run(deck(tmp_path), reads=True)
    reads = [s for s in spans if s[0] == MARK]
    ranges = [s for s in spans if s[0] == "host_read"]
    assert len(reads) >= CYCLES + 1   # the dt of each cycle, and the first
    bare = [r for r in reads if not any(inside(r, h) for h in ranges)]
    assert not bare, f"{len(bare)} of {len(reads)} reads outside host_read"
    assert all(any(inside(r, h) for r in reads) for h in ranges)


@pytest.fixture(scope="module")
def cluster_ranges(tmp_path_factory):
    """``[(name, start, end)]`` of every range of 2 cycles of the cluster
    deck at 16^3 over +-0.00625 Mpc (0.78 kpc cells, so that the kpc-sized
    accretion region, jet and tower hold cells), Townsend cooling on."""
    table = write_cluster_table(tmp_path_factory.mktemp("cluster")
                                / "cluster.cool")
    sim = Simulation(ParameterInput.from_string(cluster_deck(
        n=16, half=0.00625, nlim=2, table=table)), quiet=True, device="cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        sim.run()
    assert sim.ncycle == 2 and torch.isfinite(sim.u).all()
    return [(e.name, e.time_range.start, e.time_range.end)
            for e in prof.events() if e.device_type.name == "CPU"]


@pytest.mark.parametrize("name, outer", [
    ("agn_triggering", "agn_feedback"),
    ("magnetic_tower", "agn_feedback"),
    ("agn_feedback", "problem_source"),
    ("cooling_dt", "estimate_timestep"),
    ("tabular_cooling", "cycle"),
])
def test_cluster_source_ranges_nest(cluster_ranges, name, outer):
    """The cluster's AGN triggering and tower inside its ``agn_feedback``
    range, the cooling's dt limit inside ``estimate_timestep``."""
    spans = [s for s in cluster_ranges if s[0] == name]
    outers = [s for s in cluster_ranges if s[0] == outer]
    assert spans
    assert all(any(inside(s, o) for o in outers) for s in spans)


def test_cluster_split_source_eos_in_its_range(cluster_ranges):
    """The split sources' own conversion to prim runs in a
    ``cons_to_prim`` range, once a cycle."""
    split = [s for s in cluster_ranges if s[0] == "first_order_source"]
    eos = [s for s in cluster_ranges if s[0] == "cons_to_prim"
           and any(inside(s, f) for f in split)]
    assert len(split) == 2 and len(eos) == 2

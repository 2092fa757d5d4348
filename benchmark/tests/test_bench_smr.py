"""The refined program (``programs/smr.py``) through the harness on the CPU:
a three-level static cluster deck (16^3 base in 8^3 blocks over +-0.02
Mpc, one octant at level 1 and its far corner at level 2: 7, 7 and 8
leaves) run by ``run_cell`` with a cell of this file's own, judged against
a test double of a refined reference, the port's own ``SmrSimulation`` on
the CPU.  The probe's host copies hold every level bit for bit as a direct
run has it entering cycles k and k + 1, ``correct`` reads true, and a step
broken on one level reads ``correct`` false; the probe touches no tensor
on a cycle it does not capture, and copies each level once on the two it
does.  On the card (``-m cuda``) the same run copies the levels on the
side stream and its trace prices the stage kernels."""

import json
import shutil
import sys

import pytest
import torch

from bench_helpers import ROOT, correct

from benchmark.harness import compare
from benchmark.harness.cell import CycleProbe, run_cell
from benchmark.harness.spec import Cell

sys.path.insert(0, str(ROOT / "tests"))
from torch_decks import cluster_deck, write_cluster_table  # noqa: E402

CELL = "cluster-smr-cpu"
CONFIG = "cluster_smr_cpu"
REGIONS = [(0.0, 0.02, 0.0, 0.02, 0.0, 0.02, 1),
           (0.011, 0.02, 0.011, 0.02, 0.011, 0.02, 2)]

# the test double: the refined loop's own dt and cycle (``SmrSimulation.
# _run_split``) on a simulation of the same deck, from the states the
# harness hands it
DOUBLE = '''"""Test double of a refined reference: the port's own SmrSimulation."""
import torch

from athenapk_tpu_torch.amr.driver import SmrSimulation
from athenapk_tpu_torch.config.parameter_input import ParameterInput


class PortSmr:
    def __init__(self, deck, device):
        self.s = SmrSimulation(ParameterInput.from_string(deck), quiet=True,
                               device=device)
        self.device, self.dtype = self.s.device, self.s.dtype
        self.order = sorted(self.s.state)

    def _load(self, u, t):
        self.s.state = dict(zip(self.order, u, strict=True))
        self.s.t = t

    def initial_state(self):
        return tuple(self.s.state[lev] for lev in self.order)

    def next_dt(self, u, t, dt_prev):
        self._load(u, t)
        s = self.s
        dt_j = s.stepper.estimate_dt(s.state)
        vals = torch.stack([torch.as_tensor(
            v, dtype=dt_j.dtype, device=dt_j.device).reshape(())
            for v in (dt_j, s._problem_dt())]).tolist()
        dt = min(vals)
        if dt_prev is not None:
            dt = min(dt, 2.0 * dt_prev)
        dt = min(dt, s.tlim - t)
        return dt, s._c_h(dt)

    def cycle(self, u, dt, c_h, t):
        self._load(u, t)
        s, st = self.s, self.s.stepper
        s.state = st.step(s.state, dt, c_h, t)
        if st.problem_source_first_order is not None:
            s._split_source("first_order_source",
                            st.problem_source_first_order, st, dt)
        return tuple(s.state[lev] for lev in self.order)


def sim(deck, device):
    return PortSmr(deck, device)
'''


def deck_blocks(text):
    """``{block: {key: value}}`` of a deck's text."""
    blocks, cur = {}, None
    for line in text.splitlines():
        line = line.strip()
        if line.startswith("<") and line.endswith(">"):
            cur = blocks.setdefault(line[1:-1], {})
        elif "=" in line:
            key, _, value = line.partition("=")
            cur[key.strip()] = value.strip()
    return blocks


def make_bench_dir(root):
    """A copy of the benchmark under ``root`` with the refined cell's
    configuration, traffic and test-double reference beside the
    benchmark's own files."""
    dst = root / "benchmark"
    shutil.copytree(ROOT / "benchmark", dst,
                    ignore=shutil.ignore_patterns("__pycache__"))
    table = write_cluster_table(root / "cluster.cool")
    text = cluster_deck(n=16, mb=8, half=0.02, refinement="static",
                        regions=REGIONS, table=table)
    cfg = dict(name=CONFIG, program="smr", deck=deck_blocks(text),
               limits=dict(start_err=0.0, dt_err=0.0, cycle_err=0.0))
    (dst / "configs" / f"{CONFIG}.json").write_text(json.dumps(cfg))
    (dst / "traffic" / "smr-cpu.json").write_text(json.dumps(dict(draws={
        "problem/cluster/init_perturb/rseed_v": {"integer": [1, 1000]}})))
    (dst / "reference" / f"{CONFIG}.py").write_text(DOUBLE)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["configs"].append(dict(bench["configs"][0], name=CONFIG,
                                 file=f"benchmark/configs/{CONFIG}.json"))
    bench["workloads"].append(dict(name=CELL, config=CONFIG,
                                   traffic="smr-cpu", chips=1, why="test"))
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return dst


@pytest.fixture(scope="module")
def bench_dir(tmp_path_factory):
    return make_bench_dir(tmp_path_factory.mktemp("smr_bench"))


def levels_of(sim):
    return tuple(sim.state[lev] for lev in sorted(sim.state))


@pytest.fixture(scope="module")
def sound(bench_dir):
    """One run of the refined cell, with what the comparison was given."""
    seen = {}
    inner = compare.readings

    def keep(ref, u0_prog, cap, fluid, model=None):
        seen.update(u0=u0_prog, cap=cap)
        return inner(ref, u0_prog, cap, fluid, model)
    cell = Cell(CELL, bench_dir=bench_dir)
    compare.readings = keep
    try:
        out = run_cell(cell, 2 ** 33 + 5, 0.2, device="cpu")
    finally:
        compare.readings = inner
    return cell, out, seen


def test_captured_levels_match_a_direct_run(sound):
    cell, out, seen = sound
    k = out["sampled_cycle"]
    assert sorted(seen["cap"]) == [k, k + 1]
    prog = cell.program()
    sim = prog.build(cell.deck(2 ** 33 + 5), "cpu")
    lay = prog.layout(sim)
    assert lay["levels"] == [7, 7, 8]
    assert lay["shape"] == (22, 10, 12, 12, 12)
    assert prog.zones(sim) == 22 * 8 ** 3
    assert all(torch.equal(a, b) for a, b in zip(
        seen["u0"], levels_of(sim), strict=True))
    for cyc in (k, k + 1):
        prog.run_more(sim, cyc - 1 - sim.ncycle)
        got = seen["cap"][cyc]["u"]
        assert isinstance(got, tuple) and len(got) == 3
        assert all(torch.equal(a, b) for a, b in zip(
            got, levels_of(sim), strict=True)), cyc


def test_refined_run_is_correct(sound):
    cell, out, _ = sound
    assert correct(out), out["checks"]
    assert out["zone_cycles_per_s"] > 0
    assert sorted(out["checks"]) == ["cycle_err", "dt_err", "start_err"]


def test_step_broken_on_one_level_reads_incorrect(bench_dir, monkeypatch):
    """The finest level left as it entered the step: the program's cycle
    differs from the reference's there alone."""
    from benchmark.harness.result import result_line
    cell = Cell(CELL, bench_dir=bench_dir)
    prog = cell.program()
    build = prog.build

    def broken(deck, device):
        sim = build(deck, device)
        inner = sim.stepper.step

        def step(state, dt, c_h, t=0.0):
            out = inner(state, dt, c_h, t)
            out[max(out)] = state[max(state)]
            return out
        sim.stepper.step = step
        return sim
    monkeypatch.setattr(prog, "build", broken)
    out = run_cell(cell, 17, 0.2, device="cpu")
    line = result_line(cell, out, trace=False, kind="cpu")
    assert line["correct"] is False
    value, limit = out["checks"]["cycle_err"]
    assert not value <= limit
    assert out["checks"]["start_err"][0] == 0.0


def test_probe_touches_nothing_off_its_cycles():
    """No tensor operation at all in ``before`` on a cycle it does not
    capture, and one copy a level on the two it does."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Record(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            name = func.overloadpacket.__name__
            # the profiler range's own markers touch no tensor
            if not name.startswith("_record_function"):
                self.ops.append(name)
            return func(*args, **(kwargs or {}))

    u = tuple(torch.rand(n, 10, 4, 4, 4, dtype=torch.float64)
              for n in (3, 2, 4))
    buffers = [tuple(torch.empty_like(x) for x in u) for _ in range(2)]
    probe = CycleProbe(5, buffers, torch.device("cpu"))
    for ncycle in range(8):
        with Record() as rec:
            probe.before(ncycle, u, 1e-3, 2.0, 0.1 * ncycle)
        want = ["copy_"] * 3 if ncycle + 1 in (5, 6) else []
        assert rec.ops == want, (ncycle, rec.ops)
    assert sorted(probe.captured) == [5, 6]
    assert all(torch.equal(a, b) for a, b in zip(
        probe.captured[5]["u"], u, strict=True))
    assert probe.captured[6]["dt_prev"] == 1e-3


def test_adaptive_deck_is_refused(tmp_path):
    from benchmark.programs import smr
    text = cluster_deck(n=16, mb=8, half=0.02, refinement="adaptive")
    with pytest.raises(ValueError, match="static mesh"):
        smr.build(text, "cpu")


def card_run(root):
    """One traced run of the refined cell on the card (the test double
    within the cluster cell's limits): what the card test checks."""
    from benchmark.harness import roofline
    from benchmark.harness.trace import parse_kernel
    cell = Cell(CELL, bench_dir=make_bench_dir(root))
    cell.config["limits"] = dict(start_err=1e-12, dt_err=1e-12,
                                 cycle_err=1e-10)
    out = run_cell(cell, 2 ** 32 + 9, 0.5, device="cuda", trace=True)
    tr = out["trace"]
    names = sorted({parse_kernel(o["name"])[0] for o in tr.csrc_ops()})
    return dict(correct=correct(out), checks=out["checks"],
                levels=tr.layout["levels"], names=names,
                shares={k: roofline.share(tr, k) for k in names})


@pytest.mark.cuda
def test_card_refined_run_traces_the_stage(tmp_path):
    """On the card: the refined cell's host copies come from the side
    stream, one per level; the run agrees with the test double within the
    cluster cell's limits (both run the stage kernel); the traced stretch
    holds the stage kernels, whose names parse and whose shares of their
    rooflines read within (0, 105] %.  In a process of its own, as the
    benchmark runs: a second profiler session in one process loses the
    record of its first kernel, and the lost-kernel guard then blanks every
    kernel reader."""
    import subprocess
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    code = ("import json, sys\n"
            f"sys.path.insert(0, {str(ROOT / 'benchmark' / 'tests')!r})\n"
            "from pathlib import Path\n"
            "import test_bench_smr as t\n"
            f"print(json.dumps(t.card_run(Path({str(tmp_path)!r}))))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=900)
    assert res.returncode == 0, res.stderr[-4000:]
    got = json.loads(res.stdout.splitlines()[-1])
    assert got["correct"], got["checks"]
    assert got["levels"] == [7, 7, 8]
    assert got["names"] == ["fused_stage", "stage_scalars"]
    for kernel, value in got["shares"].items():
        assert 0.0 < value <= 105.0, kernel

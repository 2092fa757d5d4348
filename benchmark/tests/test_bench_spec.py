"""A configuration, a traffic mix and a metric put beside the benchmark's
own files are found by the names ``BENCHMARK.json`` gives, with no file
that is there edited."""

import hashlib
import json
import shutil

from bench_helpers import ROOT

from benchmark.harness.cell import MIN_WINDOW_CYCLES, run_cell
from benchmark.harness.spec import Cell


def _digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


def test_new_cell_found_by_name(tmp_path):
    src = ROOT / "benchmark"
    dst = tmp_path / "benchmark"
    shutil.copytree(src, dst, ignore=shutil.ignore_patterns("__pycache__"))
    before = _digests(dst)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())

    cfg = json.loads((dst / "configs" / "linwave3d_mhd_wenoz.json")
                     .read_text())
    cfg["name"] = "linwave_small"
    for ax in ("nx1", "nx2", "nx3"):
        cfg["deck"]["parthenon/mesh"][ax] = "16"
        cfg["deck"]["parthenon/meshblock"][ax] = "16"
    cfg["program"] = "uniform_copy"
    (dst / "configs" / "linwave_small.json").write_text(json.dumps(cfg))
    (dst / "programs" / "uniform_copy.py").write_text(
        (dst / "programs" / "uniform.py").read_text())
    (dst / "traffic" / "tiny-mix.json").write_text(json.dumps(dict(
        draws={"problem/linear_wave/amp": {"uniform": [1e-6, 2e-6]}})))
    (dst / "metrics" / "cycles_in_window.py").write_text(
        "def read(run):\n    return run['attempted']\n")
    (dst / "reference" / "linwave_small.py").write_text(
        (dst / "reference" / "linwave3d_mhd_wenoz.py").read_text())
    bench["configs"].append(dict(bench["configs"][0], name="linwave_small",
                                 file="benchmark/configs/linwave_small.json"))
    bench["workloads"].append(dict(name="new-cell", config="linwave_small",
                                   traffic="tiny-mix", chips=1, why="test"))
    bench["per_layer"].append(dict(bench["per_layer"][0],
                                   name="cycles_in_window",
                                   workloads=["new-cell"]))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = Cell("new-cell", bench_dir=dst)
    assert cell.config["name"] == "linwave_small"
    assert set(cell.traffic["draws"]) == {"problem/linear_wave/amp"}
    assert cell.program().__name__ == "benchmark.programs.uniform_copy"
    assert [m["name"] for m in cell.per_layer][-1] == "cycles_in_window"
    assert cell.metric_reader("cycles_in_window").read({"attempted": 7}) == 7
    deck = cell.deck(5)
    assert "nx1 = 16" in deck and "amp = " in deck
    assert cell.reference().sim(deck, "cpu").cells == 16 ** 3
    out = run_cell(cell, 5, 0.3, device="cpu")
    assert all(v <= lim for v, lim in out["checks"].values()), out["checks"]
    assert out["attempted"] >= MIN_WINDOW_CYCLES
    # the old cells are as they were
    old = Cell("linwave-mhd-uniform-256", bench_dir=dst)
    assert "nx1 = 256" in old.deck(5)
    assert all(_digests(dst)[p] == d for p, d in before.items())


def test_draws_repeat_for_a_seed():
    cell = Cell("linwave-mhd-uniform-256")
    big = 2 ** 31 + 12345
    assert cell.draws(big) == cell.draws(big)
    assert cell.draws(big) != cell.draws(big + 1)
    assert set(cell.draws(big)) == {"problem/linear_wave/amp",
                                    "problem/linear_wave/vflow"}

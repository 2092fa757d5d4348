"""What a cell is made of, found by the names in ``BENCHMARK.json``.

* a configuration: the JSON file that its ``configs`` entry names, holding
  the deck as it is run (``deck``: ``{block: {key: value}}``), the
  precision, ``assumed``, ``reduced``, the limits of the comparison that
  decides ``correct`` (``limits``) and the program that runs it
  (``program``: ``benchmark/programs/<program>.py``, which states the
  chips it uses: ``uniform`` or ``smr``, a state of one tensor or of one
  tensor per level); its plain reference is
  ``benchmark/reference/<config>.py``, over states of the program's form;
* a traffic mix: ``benchmark/traffic/<traffic>.json``, holding the deck
  keys the seed draws (``draws``);
* a per-layer metric: the reader ``benchmark/metrics/<metric>.py``.

A later cell, configuration or metric is new files and new entries; no
file here needs an edit for it.
"""

from __future__ import annotations

import importlib.util
import json
import re
import sys
from pathlib import Path

import numpy as np

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


def load_json(path):
    with open(path) as fh:
        return json.load(fh)


def load_module(path, package):
    """The module at ``path``, imported as a member of ``package`` (so its
    relative imports resolve) under a name made from the file's stem."""
    stem = re.sub(r"\W", "_", Path(path).stem)
    name = f"{package}.{stem}"
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    try:
        spec.loader.exec_module(mod)
    except BaseException:
        del sys.modules[name]
        raise
    return mod


class Cell:
    """One workload of ``BENCHMARK.json`` with its configuration, traffic
    mix, metrics and reference."""

    def __init__(self, workload, bench=None, bench_dir=BENCH_DIR):
        bench = bench if bench is not None else load_json(
            bench_dir.parent / "BENCHMARK.json")
        self.bench_dir = Path(bench_dir)
        cells = {w["name"]: w for w in bench["workloads"]}
        if workload not in cells:
            raise KeyError(f"no workload '{workload}' in BENCHMARK.json "
                           f"(there are {sorted(cells)})")
        self.workload = cells[workload]
        self.name = workload
        self.chips = int(self.workload["chips"])
        configs = {c["name"]: c for c in bench["configs"]}
        self.config_entry = configs[self.workload["config"]]
        self.config = load_json(self.bench_dir.parent
                                / self.config_entry["file"])
        self.traffic = load_json(self.bench_dir / "traffic"
                                 / f"{self.workload['traffic']}.json")
        self.end_to_end = [m for m in bench["end_to_end"]
                           if workload in m.get("workloads", [workload])]
        self.per_layer = [m for m in bench["per_layer"]
                          if workload in m.get("workloads", [workload])]

    def reference(self):
        """The configuration's plain reference module."""
        return load_module(self.bench_dir / "reference"
                           / f"{self.workload['config']}.py",
                           "benchmark.reference")

    def program(self):
        """The module that builds and drives the configuration's program;
        refuses a cell that asks for other chips than the program uses."""
        mod = load_module(self.bench_dir / "programs"
                          / f"{self.config['program']}.py",
                          "benchmark.programs")
        if self.chips != mod.CHIPS:
            raise ValueError(f"{self.name} asks for {self.chips} chip(s); "
                             f"the program '{self.config['program']}' runs "
                             f"on {mod.CHIPS}")
        return mod

    def metric_reader(self, name):
        return load_module(self.bench_dir / "metrics" / f"{name}.py",
                           "benchmark.metrics")

    def draws(self, seed):
        """``{"block/key": value}``: the deck keys the seed draws."""
        rng = np.random.default_rng(seed % 2 ** 64)
        out = {}
        for key, how in sorted(self.traffic.get("draws", {}).items()):
            (kind, arg), = how.items()
            if kind == "choice":
                out[key] = arg[int(rng.integers(len(arg)))]
            elif kind == "uniform":
                out[key] = float(rng.uniform(arg[0], arg[1]))
            elif kind == "integer":
                out[key] = int(rng.integers(arg[0], arg[1] + 1))
            else:
                raise ValueError(f"draw '{key}': unknown kind '{kind}'")
        return out

    def deck(self, seed, overrides=None):
        """The deck's text for ``seed``: the configuration's deck with the
        seed's draws and then ``overrides`` (``{"block/key": value}``)
        set."""
        blocks = {b: dict(kv) for b, kv in self.config["deck"].items()}
        updates = self.draws(seed)
        updates.update(overrides or {})
        for path, value in updates.items():
            block, _, key = path.rpartition("/")
            blocks.setdefault(block, {})[key] = value
        lines = []
        for block, kv in blocks.items():
            lines.append(f"<{block}>")
            lines += [f"{key} = {value}" for key, value in kv.items()]
            lines.append("")
        return "\n".join(lines)

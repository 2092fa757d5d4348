"""Shared pieces of the benchmark's tests: a cell's deck cut to a CPU
size, and one run of it."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

WORKLOADS = ["linwave-mhd-uniform-256"]


def small(workload, n=16):
    """Deck keys that cut ``workload``'s mesh to ``n``^3."""
    ov = {f"parthenon/mesh/nx{i}": str(n) for i in (1, 2, 3)}
    ov.update({f"parthenon/meshblock/nx{i}": str(n) for i in (1, 2, 3)})
    return ov


def run(workload, seed, device="cpu", n=16, **kw):
    from benchmark.harness.cell import run_cell
    from benchmark.harness.spec import Cell
    cell = Cell(workload)
    return cell, run_cell(cell, seed, 0.3, device=device,
                          overrides=small(workload, n), **kw)


def correct(out):
    return all(v <= lim for v, lim in out["checks"].values())


def over_limits(nums, out):
    return [k for k, v in nums.items() if not v <= out["checks"][k][1]]

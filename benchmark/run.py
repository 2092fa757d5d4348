"""Run one cell of the benchmark and print its result as the last line.

    python3 benchmark/run.py --workload NAME --seed N --seconds S --trace 0|1

from the root of a checkout that holds the port (``athenapk_tpu_torch``).
It needs as many CUDA devices as the cell asks for, and exits with a code
other than 0, printing no result, where they are missing, where the port is
missing, or where JAX or the JAX package was loaded.  With ``--trace 0``
the result carries the cell's end-to-end metrics, with ``--trace 1`` its
per-layer metrics, the device's busy and traced seconds and a breakdown.
The numbers compared with the plain reference go to standard error as its
last lines, and into the result under ``checks``.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

FORBIDDEN = ("jax", "jaxlib", "flax", "athenapk_tpu")


def forbidden_modules():
    """Top-level names of loaded modules that the port must not load,
    compared whole (``athenapk_tpu_torch`` is not ``athenapk_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from benchmark.harness.spec import Cell
    cell = Cell(args.workload)
    import torch
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              " available", file=sys.stderr)
        return 3
    try:
        import athenapk_tpu_torch  # noqa: F401
    except ImportError as exc:
        print(f"the port is not beside the benchmark: {exc}",
              file=sys.stderr)
        return 4
    from benchmark.harness.cell import run_cell
    from benchmark.harness.result import result_line
    out = run_cell(cell, args.seed, args.seconds, trace=bool(args.trace),
                   device="cuda", t_start=T_START)
    line = result_line(cell, out, trace=bool(args.trace),
                       kind=torch.cuda.get_device_name(0))
    bad = forbidden_modules()
    if bad:
        print(f"loaded in this process: {', '.join(bad)}", file=sys.stderr)
        return 5
    for name, (value, limit) in out["checks"].items():
        print(f"check {name}: {value!r} (limit {limit!r})", file=sys.stderr)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())

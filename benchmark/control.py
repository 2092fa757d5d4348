"""The readings that the limits of ``correct`` are set from, for one cell
over several seeds in one process (the kernels built once):

    python3 benchmark/control.py --workload NAME --seconds S --seeds N ...

For each seed a short window at the cell's own size, then the compared
numbers of the program's answers (the lower readings) and of the control's
(the reference computed in the precision below the configuration's, in the
program's place: the upper readings), one JSON line per seed on standard
output and, with ``--out FILE``, appended to FILE.  The benchmark's own
runs (``run.py``) do not run the control.
"""

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    import torch
    from benchmark.harness.cell import run_cell
    from benchmark.harness.spec import Cell
    cell = Cell(args.workload)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 3
    for seed in args.seeds:
        out = run_cell(cell, seed, args.seconds, control=True)
        rec = dict(workload=args.workload, seed=seed,
                   program={k: v for k, (v, _) in out["checks"].items()},
                   control=out["control"],
                   limits={k: lim for k, (_, lim) in out["checks"].items()},
                   zone_cycles_per_s=out["zone_cycles_per_s"],
                   cycles=out["attempted"],
                   sampled_cycle=out["sampled_cycle"],
                   peak_bytes=out["peak_bytes"],
                   card=torch.cuda.get_device_name(0))
        line = json.dumps(rec)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as fh:
                fh.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Time the port's uniform-path kernels of several checkouts on one card,
in turns, so that two versions are compared within one run.

    python3 -m athenapk_tpu_torch.kernel_ab ROOT [ROOT ...] [--reps 20]

Each ROOT is a checkout holding ``athenapk_tpu_torch``; each is timed in a
fresh interpreter (its kernels build into ``ROOT/build``), in the order
given, so ``parent change change parent`` gives the pairs.  Timed at the
main deck's inputs (a smooth GLM-MHD state of 256^3 cells in one
ghost-free block, f32): ``negdiv_cuda`` with DC and PPM (three launches
per call) and ``stage_cuda`` with DC and PPM (one launch), mean device time
per call over ``--reps`` calls after one warm-up (CUDA events).  Prints one
JSON line per ROOT and the card's name and power limit.  Needs a CUDA card.
"""

import argparse
import json
import subprocess
import sys

CHILD = r"""
import json, sys
import numpy as np
import torch
sys.path.insert(0, sys.argv[1])
from athenapk_tpu_torch.core.mesh import Mesh
from athenapk_tpu_torch.eos.adiabatic import EOS, prim_to_cons
from athenapk_tpu_torch.solver import stage, sweep
from athenapk_tpu_torch.solver.hydro_pkg import HydroConfig
reps = int(sys.argv[2])
n = 256
mesh = Mesh(nx1=n, nx2=n, nx3=n, mbnx1=n, mbnx2=n, mbnx3=n, x1min=0.0,
            x1max=3.0, x2min=0.0, x2max=1.5, x3min=0.0, x3max=1.5, nghost=0)
x, y, z = mesh.cell_centers_mesh()
tp = 2.0 * np.pi
w = np.zeros((1, 9) + mesh.block_shape, np.float32)
w[:, 0] = 1.0 + 0.1 * np.sin(tp * x) * np.cos(tp * y) + 0.05 * np.sin(tp * z)
w[:, 1] = 0.3 + 0.2 * np.sin(tp * z)
w[:, 2] = 0.2 + 0.1 * np.cos(tp * x)
w[:, 3] = -0.15 + 0.1 * np.sin(tp * y)
w[:, 4] = 0.6 + 0.05 * np.cos(tp * (x + y + z))
w[:, 5] = 1.0 + 0.1 * np.sin(tp * y)
w[:, 6] = 0.5 + 0.1 * np.cos(tp * z)
w[:, 7] = 0.1 + 0.1 * np.sin(tp * x)
w[:, 8] = 0.01 * np.sin(tp * (x - y))
prim = torch.tensor(w, device="cuda")
eos = EOS(gamma=5.0 / 3.0)
u = prim_to_cons(eos, prim, "glmmhd")
c_h = 1.3


def cuda_ms(fn):
    fn()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


out = {"root": sys.argv[1]}
for recon in ("dc", "ppm"):
    cfg = HydroConfig(fluid="glmmhd", riemann="hlld", reconstruction=recon)
    out[f"sweep_{recon}_ms"] = cuda_ms(
        lambda: sweep.negdiv_cuda(prim, c_h, mesh, cfg, eos, recon))
    out[f"stage_{recon}_ms"] = cuda_ms(
        lambda: stage.stage_cuda(u, u, 0.0, 1.0, 1e-3, c_h, mesh, cfg, eos,
                                 recon))
print(json.dumps(out), flush=True)
"""


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("roots", nargs="+")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    for root in args.roots:
        res = subprocess.run([sys.executable, "-c", CHILD, root,
                              str(args.reps)], capture_output=True, text=True)
        if res.returncode != 0:
            print(res.stdout + res.stderr, file=sys.stderr)
            return res.returncode
        print(res.stdout.strip().splitlines()[-1], flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

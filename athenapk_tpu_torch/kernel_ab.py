#!/usr/bin/env python3
"""Time the port's kernels of several checkouts on one card, in turns, so
that two versions are compared within one run.

    python3 -m athenapk_tpu_torch.kernel_ab ROOT [ROOT ...] [--reps 20]

Each ROOT is a checkout holding ``athenapk_tpu_torch``; each is timed in a
fresh interpreter (its kernels build into ``ROOT/build``), in the order
given, so ``parent change change parent`` gives the pairs.  Mean device
time per call over ``--reps`` calls after one warm-up (CUDA events), ms:

* ``sweep_{dc,ppm}_ms``, ``stage_{dc,ppm}_ms``: the main deck's inputs, a
  smooth GLM-MHD state of 256^3 cells in one ghost-free block, f32:
  ``negdiv_cuda`` (three launches per call) and ``stage_cuda`` (one);
  ``*_f64_ms`` the same in f64;
* ``deck_{sweep,stage}_{dc,ppm}_ms``: the same calls at the main deck's
  own state (the ``run_bench`` linear wave, 256^3 f32, built by
  ``Simulation``), on which every HLLD face lies between the Alfven waves;
* ``sweep2d_{dc,ppm}_ms``: the Orszag-Tang deck's shape, 2048^2 GLM-MHD
  f32, two launches per call;
* ``stage_faces_{dc,plm}_ms`` and ``sweep_faces_{dc,plm}_ms``: the
  refined paths A and B at a level array of theirs, 64 blocks of 32^3
  with 2 ghosts (36^3), Euler HLLE f32: ``stage_faces_cuda`` and
  ``negdiv_faces_cuda`` (three launches per call).

A rung that differs in a build flag or a source edit is a checkout of its
own (a ``git archive`` with the one change made).

Before its timings each ROOT's kernels are built and their build report is
printed by this checkout's ``kernels.ptxas_summary``: one line per
instantiation with registers and spills, and for this checkout's own
kernels also dynamic shared memory and resident warps per SM.  Then one
JSON line per ROOT, and at the end the card's name and power limit.  Needs
a CUDA card.
"""

import argparse
import json
import subprocess
import sys
from pathlib import Path

from .core import kernels
from .solver import stage, sweep

HERE = Path(__file__).resolve().parent

CHILD = r"""
import json, sys
import numpy as np
import torch
sys.path.insert(0, sys.argv[1])
from athenapk_tpu_torch.config.parameter_input import ParameterInput
from athenapk_tpu_torch.core.mesh import Mesh
from athenapk_tpu_torch.driver import Simulation
from athenapk_tpu_torch.eos.adiabatic import EOS, prim_to_cons
from athenapk_tpu_torch.solver import stage, sweep
from athenapk_tpu_torch.solver.hydro_pkg import HydroConfig
reps = int(sys.argv[2])
print(json.dumps({"build_log": "".join(mod.build_library()[1]
                                       for mod in (sweep, stage))}),
      flush=True)


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


def smooth(mesh, nvar, dtype):
    x, y, z = mesh.cell_centers_mesh()
    tp = 2.0 * np.pi
    w = np.zeros((mesh.nblocks, 9) + mesh.block_shape)
    w[:, 0] = 1.0 + 0.1 * np.sin(tp * x) * np.cos(tp * y) + 0.05 * np.sin(tp * z)
    w[:, 1] = 0.3 + 0.2 * np.sin(tp * z) + 0.0 * x
    w[:, 2] = 0.2 + 0.1 * np.cos(tp * x) + 0.0 * y
    w[:, 3] = -0.15 + 0.1 * np.sin(tp * y) + 0.0 * z
    w[:, 4] = 0.6 + 0.05 * np.cos(tp * (x + y + z))
    w[:, 5] = 1.0 + 0.1 * np.sin(tp * y) + 0.0 * x
    w[:, 6] = 0.5 + 0.1 * np.cos(tp * z) + 0.0 * x
    w[:, 7] = 0.1 + 0.1 * np.sin(tp * x) + 0.0 * y
    w[:, 8] = 0.01 * np.sin(tp * (x - y)) + 0.0 * z
    return torch.tensor(w[:, :nvar], dtype=dtype, device="cuda")


def mesh_of(n, mb, g):
    return Mesh(nx1=n[0], nx2=n[1], nx3=n[2], mbnx1=mb[0], mbnx2=mb[1],
                mbnx3=mb[2], x1min=0.0, x1max=3.0, x2min=0.0, x2max=1.5,
                x3min=0.0, x3max=1.5, nghost=g)


out = {"root": sys.argv[1]}
c_h = 1.3
mhd = {r: HydroConfig(fluid="glmmhd", riemann="hlld", reconstruction=r)
       for r in ("dc", "ppm")}
eos = EOS(gamma=5.0 / 3.0)
mesh = mesh_of((256,) * 3, (256,) * 3, 0)
for dtype, tag in ((torch.float32, ""), (torch.float64, "_f64")):
    prim = smooth(mesh, 9, dtype)
    u = prim_to_cons(eos, prim, "glmmhd")
    for recon, cfg in mhd.items():
        out[f"sweep_{recon}{tag}_ms"] = cuda_ms(
            lambda: sweep.negdiv_cuda(prim, c_h, mesh, cfg, eos, recon))
        out[f"stage_{recon}{tag}_ms"] = cuda_ms(
            lambda: stage.stage_cuda(u, u, 0.0, 1.0, 1e-3, c_h, mesh, cfg,
                                     eos, recon))
    del prim, u
    torch.cuda.empty_cache()

DECK = '''
<job>
problem_id = linear_wave_mhd
<problem/linear_wave>
compute_error = false
wave_flag = 0
amp = 1.0e-6
vflow = 0.0
test = true
<parthenon/mesh>
nghost = 0
nx1 = 256
x1min = 0.0
x1max = 3.0
nx2 = 256
x2min = 0.0
x2max = 1.5
nx3 = 256
x3min = 0.0
x3max = 1.5
<parthenon/meshblock>
nx1 = 256
nx2 = 256
nx3 = 256
<parthenon/time>
integrator = vl2
cfl = 0.3
tlim = 100.0
nlim = 1
<hydro>
fluid = glmmhd
eos = adiabatic
riemann = hlld
reconstruction = ppm
gamma = 1.666666666666667
precision = single
'''
sim = Simulation(ParameterInput.from_string(DECK), quiet=True)
_, prim = sim.pkg.cons_to_prim(sim.u)
c_deck = sim.pkg.c_h_from_dt_hyp(sim._estimate()[1])
for recon in ("dc", "ppm"):
    out[f"deck_sweep_{recon}_ms"] = cuda_ms(lambda: sweep.negdiv_cuda(
        prim, c_deck, sim.mesh, sim.cfg, sim.eos, recon))
    out[f"deck_stage_{recon}_ms"] = cuda_ms(lambda: stage.stage_cuda(
        sim.u, sim.u, 0.0, 1.0, 1e-3, c_deck, sim.mesh, sim.cfg, sim.eos,
        recon))
del sim, prim
torch.cuda.empty_cache()

flat = mesh_of((2048, 2048, 1), (2048, 2048, 1), 0)
prim = smooth(flat, 9, torch.float32)
for recon, cfg in mhd.items():
    out[f"sweep2d_{recon}_ms"] = cuda_ms(
        lambda: sweep.negdiv_cuda(prim, c_h, flat, cfg, eos, recon))
del prim
torch.cuda.empty_cache()

level = mesh_of((128,) * 3, (32,) * 3, 2)
prim = smooth(level, 5, torch.float32)
u0 = prim_to_cons(eos, prim, "euler")
u1 = 1.01 * u0
for recon in ("dc", "plm"):
    cfg = HydroConfig(fluid="euler", riemann="hlle", reconstruction=recon)
    ub = u0 if recon == "dc" else u1
    out[f"stage_faces_{recon}_ms"] = cuda_ms(
        lambda: stage.stage_faces_cuda(u0, ub, 0.0, 1.0, 1e-3, 0.0, level,
                                       cfg, eos, recon))
    out[f"sweep_faces_{recon}_ms"] = cuda_ms(
        lambda: sweep.negdiv_faces_cuda(prim, 0.0, level, cfg, eos, recon))
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
        build, timings = res.stdout.strip().splitlines()[-2:]
        own = Path(root).resolve() == HERE.parent
        for line in kernels.ptxas_summary(json.loads(build)["build_log"],
                                          sweep.PTXAS | stage.PTXAS,
                                          occupancy=own):
            print("  ptxas:", line, flush=True)
        print(timings, flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

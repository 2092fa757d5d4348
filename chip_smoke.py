#!/usr/bin/env python3
"""Chip smoke test of the PyTorch + CUDA port (``athenapk_tpu_torch``) on one
NVIDIA card.

Run from the root of a checkout:  ``python3 chip_smoke.py [--seed N]``.
It needs the CUDA toolkit (``nvcc``) to build the kernels from
``athenapk_tpu_torch/csrc/`` into ``build/``, and exits non-zero, printing
no result, when there is no CUDA card or when the port is not beside it.

Phases (each one fails the run if it fails):

1. card: name and power limit (``nvidia-smi``), torch's device name;
2. build: the sweep and the whole-stage kernel (each source two
   libraries, for decks without and with scalars, each one ``nvcc`` per
   translation unit: the entry points and one unit per reconstruction and
   dtype, 13 per library) and the forest binding (``g++``), all started
   together, timed, with each instantiation's
   registers and spills (ptxas), dynamic shared memory and resident warps
   per SM (the runtime's occupancy query), the instantiations for decks
   with scalars marked "+scalars" and the two scalar kernels
   (``negdiv_scalars``, ``stage_scalars``) among them; an instantiation
   that spills fails the phase;
3. kernel against plain, states made from ``--seed``: ``negdiv_cuda``
   against ``negdiv_plain`` (GLM-MHD HLLD, Euler HLLE and HLLC; 128^3 in
   one block and 8 ghosted 32^3 blocks, 2-D 512^2 and 1-D 4096) and
   ``stage_cuda`` against ``stage_plain`` (Euler HLLC and GLM-MHD HLLD on
   states that trip the floors, 128^3 in one block with the CFL output
   and 8 ghosted 32^3 blocks, stage-start prim included), f32 and f64,
   DC/PLM/PPM; the stage kernel again on white noise beside floored cells,
   where f64 is held in every cell and f32 in all but a bounded share of
   cells that the sweep kernel accounts for; then every case that this
   slice added (a reconstruction of WENO3, LimO3, WENO-Z or a solver of
   Euler LLF, GLM-MHD LLF, GLM-MHD HLLE, with any of the six
   reconstructions and six pairs) on each kernel route, #1, #6/#2, #4
   (2-D and 1-D), #5, #3 (floors, CFL, prim) and #7, f32 and f64, on
   states with steep dips (LimO3's positivity fallback), and LimO3's
   switch at eta = 1 (each branch taken); then passive scalars on every
   route (#1, #6/#2, #4 2-D and 1-D, #5, #3, #7): GLM-MHD HLLD + PPM and
   Euler HLLC + PLM with 1 and 3 scalars and Euler with 4, f32 and f64,
   the fluid rows and the scalar rows held apart, one scalar-kernel
   launch per fluid launch;
4. main paths, each through ``Simulation(pin)`` for 12 cycles (2 warm-up)
   with every kernel's launch count set to 0 just before and read just
   after: the ``bench.py:run_bench`` deck (3-D MHD linear wave, 256^3,
   HLLD + PPM + VL2, ghost-free, f32) on the sweep rung (the default) and
   on the whole-stage rung (``ATHENAPK_PALLAS_STAGE=1``), the EOS kernel's
   launches among the counts (3 a cycle on the sweep rung, none on the
   stage rung, and one for the run's initial dt); the Orszag-Tang vortex (2-D
   GLM-MHD, 2048^2, f32); Sod (1-D Euler, HLLC + PLM, 1024 cells, f64) to
   its ``tlim`` against the exact Riemann solution, and the kernel against
   plain on its final state; the refined-mesh paths through
   ``SmrSimulation`` (``bench.py:run_bench_smr``'s protocol: 12 cycles, 2
   warm-up, face-kernel counts set to 0 before and read after): path A,
   the ``run_bench_smr`` deck (128^3 base, 32^3 blocks, level-1 centre,
   120 leaves, Euler HLLE + PLM, f32) on the whole-stage rung, 4
   stage-faces launches per cycle; path B, the same deck with
   ``ATHENAPK_PALLAS_STAGE=0``, 12 negdiv-faces launches per cycle; path
   C, the 2-D refined blast at 2048^2 (128^2 blocks, 448 leaves, HLLC),
   8 per cycle; each with its mass across levels; the adaptive paths
   through ``SmrSimulation`` with ``bench.py:run_bench_adaptive``'s
   protocol (10 warm-up cycles, then a 15-cycle window holding the remesh
   checks, the remeshes and any new topology's host work): path D, its
   deck (blast, Euler HLLE + PLM, f32, pressure gradient at 0.1, numlevel
   2) at 128^3 with 16^3 blocks on the whole-stage rung, 2 stage-faces
   launches per level and cycle; path D', the bench's own 64^3 with
   ``ATHENAPK_PALLAS_STAGE=0``, 6 negdiv-faces launches per level and
   cycle; each with the rate over the window, the remeshes in the window
   and over the run (a run without one after the initial refinement
   fails), the leaves per level at the start and the end, the host ms per
   remesh (forest update, transfer, new topology's plans, fill) and the
   mass across levels; the cloud-crushing paths (``CLOUD_DECK``: GLM-MHD
   HLLD + PLM + VL2, one passive scalar, tabular cooling, the inflow
   boundary, f32): path G' on a uniform mesh at 128x384x128 in one
   ghosted block with rk12 cooling, on the sweep and the stage rung (5
   cycles, 2 warm-up), with the cooling loop's host reads per cycle and
   its share of the cycle; path G adaptive, base 64x192x64 with 16^3
   blocks and numlevel 2, Townsend cooling, the pgen's scalar refinement
   check, on the stage rung (#7) and the negdiv rung (#6/#2), 10 warm-up
   + 20 timed cycles, with the leaves per cycle and the remeshes; the
   diffusion and split-source paths (``tests/torch_decks.py``'s decks, f32,
   12 cycles with 2 warm-up (path H 8), each profiled right after its
   run): path H,
   the GLM-MHD linear wave with conduction, viscosity and Ohmic
   resistivity of ``tests/test_diffusion_linwave3d.py`` at 384x192x192 in
   one ghost-free block, unsplit and RKL2 (``rkl2_max_dt_ratio = 200``),
   each on the sweep and the stage rung, with dt_hyp / dt_diff, the RKL2
   stages per cycle (and the count the code reckons), the diffusion's
   time and share and the launches per cycle, and the stage kernel with
   ``emit_prim`` at its inputs against plain (f32 and f64); path I,
   driven turbulence (GLM-MHD HLLD + PLM, 30 modes from
   ``make_random_modes``) at 256^3 on both rungs, with the forcing's time,
   share and host reads per cycle; path I', the same turbulence on a
   static refined mesh (base 128^3, 16^3 blocks, the octant at level 1)
   through the ``_smr`` hook on the stage-faces (#7) and the negdiv-faces
   (#6/#2) rung, with the leaves and the forcing's share;
5. whole steps in f64 for 5 cycles, once through the kernels and once
   with their plain versions forced (the plain EOS too: those runs
   launch no kernel of the port), state and every dt compared: the
   main deck at 32^3 on each rung, the vortex at 64^2, Sod at 256,
   ``inputs/blast_3d_smr.in`` on both refined rungs and the 2-D refined
   blast at 256^2 (with seeded noise off the blasts' symmetric ties), and
   the refined runs' mass drift (f64, 1e-13); path F's decks (64^3, and
   the refined one at 32^3 base) with the same stages rescued;
   path G's deck at base 32x96x32 in f64 on both rungs (state, every
   step and the leaf table after every cycle);
   adaptive runs side by side cycle by cycle (``inputs/
   blast_3d_adaptive.in`` on both rungs and the 2-D adaptive blast at
   256^2, ``derefine_count = 1``): leaf tables equal, state and every step
   to the tolerance, a refinement and a derefinement in each, mass drift
   1e-13; the diffusion and source decks (H unsplit and RKL2 at 64x32x32
   on both rungs, the refined diffusive wave unsplit and RKL2, I at 64^3
   on both rungs,
   I' at base 32^3 on both rungs, each run from its own ``ParameterInput``
   so both draw the same randoms, and rand_blast at 128^3 with FOFC in a
   window in which blast 1 fires): state and every dt, the same RKL2
   stage counts and rescues, mass across levels 1e-13; then the face
   kernels against plain at paths A, B, C, D and D''s
   own level arrays (D and D' after their last remesh), f32 as they run
   and the same arrays in f64 (state and every face slab, per variable);
6. timings at the main paths' inputs (256^3 f32, and 2048^2 f32 for the
   2-D entry; the refined paths' level arrays for the face kernels):
   kernel against plain there (held to the f32 tolerance), kernel and
   plain per call, the bound from this run's bytes and the operations its
   data need (FP32 at 67 TFLOP/s), and the kernel's share of that bound
   (the stage-faces kernel at path D's level arrays, and at path A's);
   the main deck's sweep and stage calls again on the same inputs in f64
   (held to the f64 tolerance, the bound at FP64's 34 TFLOP/s); a row per
   path E and F case at its own final state (#1, #3, #6/#2, and #7 at path
   F's refined level arrays); the two scalar kernels at path G''s inputs
   against their plain twins (from the same mass fluxes), with their
   bounds, and the #1 and #3 calls with the scalar; the EOS kernel at the
   main deck's state against the plain EOS, f32 and the same state in f64,
   with no limit and with every floor and ceiling on, bit for bit, each
   with its bound from the bytes of the rows read and written; the cooling
   kernels (the Townsend update in place and the dt) at 324^3 against the
   plain code, f64 on path K''s state tiled and f32 on drawn gas, bit for
   bit, each with its bytes bound and the plain code's time;
7. profile: a torch.profiler trace of 3 cycles of each rung of the main
   deck, of path E's GLM-MHD RK3 + WENO-Z + HLLE, of path F's first three
   cycles (with the rescue), of the vortex and of each refined path (the
   fill, the flux
   correction and the dt package told apart by profiler ranges), and of 3
   cycles of adaptive path D (the step, the fill, the tag dispatch and the
   remesh, with its host ms), of 1 cycle of path G' on each rung (the
   cooling's kernels apart) and of path G (the cooling apart), and of 3
   cycles of each path H, I and I' run (the diffusion, the forcing and
   the refined fill apart by profiler ranges), device time by kernel and
   the device's idle share.

Tracers and the restart (each in the phase its kind belongs to): path J,
path I's turbulence at 256^3 with 0.125 tracers per cell (2,097,152 in
4,194,304 slots) and its ``.hst`` output, on the sweep and the stage rung;
path J', path I''s refined turbulence (960 leaves) with the same density
on the stage-faces and the negdiv-faces rung; for each, zone-cycles/s, the
tracers active and lost, the kernels against plain at the final state
(f32 and f64), phase 7's breakdown with the tracers' ranges (their device
ms per cycle and share) and the host reads of a counted run (J': and the
tracers that change level); adaptive tracers (phase 5): path D''s deck at
64^3 with tracers, f64, through the kernels and the plain versions side by
side (tables, positions, the population conserved, ids unique); the
restart on the card (phase 5): path J's deck at 128^3, path I''s refined
deck and the adaptive deck, f32 and f64, two continuous runs and a run
resumed from ``restart_payload`` at half way, all equal bit for bit (the
card has no h5py, so the ``.rhdf`` file layer is the CPU tests'); ``-t``
(phase 7): ``driver.main(["-t", DIR, "-i", deck])`` on the main deck at
64^3, its trace holding every launch the counters saw and the stage's
named ranges.

The cluster (``tests/torch_decks.py:cluster_deck``: GLM-MHD HLLD + PLM +
VL2, the AGN tracer as one passive scalar, NFW + Hernquist + SMBH
gravity, the ACCEPT HSE atmosphere over +-0.1 Mpc with outflow
boundaries, few-modes velocity and magnetic perturbations, AGN feedback
at a fixed 1e-3 split between the thermal dump, the precessing kinetic
jet and the tower, COLD_GAS triggering, SN Ia, stellar feedback and the
clips), each for 8 cycles (2 warm-up) with the launches counted (phase
4): path K on a static refined mesh (base 128^3 in 32^3 blocks, +-0.025
at level 1, +-0.0125 at level 2: 176 leaves, 5,767,168 cells), f64 with
Townsend cooling, on the stage-faces (#7) and the negdiv-faces (#6/#2)
rung; path K' at 256^3 in one ghosted block, f64 with cooling, on the
sweep (#1) and the stage (#3, ``emit_prim``) rung; path K'' as K' in f32
without cooling and stellar feedback (both outside the f32 range in these
units), stage rung.  For each: the launches of each fluid kernel and of
its scalar kernel against the count expected, the kernels against plain
at the final state (f32 and f64; phases 3 and 6), phase 7's breakdown
with the unsplit and the split source as ranges, the host reads of a
counted run (no more than 1 per cycle) and, on K and K', the mass and
energy the AGN feedback injects over 2 counted cycles against its
analytic rates (1e-3); phase 5 runs the cluster deck 5 f64 cycles through
the kernels and the plain versions (32^3 on both uniform rungs, base
16^3 with a level-1 octant on both refined rungs).  Phase headers carry
the seconds since the start.

Multi-rank runs (phase 4, ``phase_multirank``): ranks are
``torch.multiprocessing`` spawn processes on the one card over gloo, their
messages staged through pinned host buffers.  M1, the main deck at 256^3
f32 in ghosted 256x256x64 blocks (``merge_blocks = false``, nghost 3) over
2 z-slab ranks, 5 cycles on the sweep (#1) and on the stage (#3) rung; M2,
the main deck at 128^3 f64 with outflow z over a 2x2 (z, y) rank grid, 2
cycles; M3, the sharded tracers of ``tests/test_sharding.py:190`` at 128^3
(0.125 per cell, 32^3 blocks) over 2 ranks, 10 steps, and a case in which
each rank sends its whole pool (more than a block layer's capacity) at
once; M4, path A's refined deck (#7) over 2 ranks (flat layout, 3 cycles)
and path D''s adaptive deck at 64^3 (#6/#2, ``derefine_count = 1``, 6
cycles through remeshes that change the leaves) with
``device_leaf_counts``; M5, path K's cluster deck (176 leaves, f64,
Townsend cooling) with only its unsplit sources (gravity, AGN feedback with
COLD_GAS triggering and the tower, SN Ia; stellar feedback and the clips
are split sources, which refined meshes over ranks refuse) through
``AmrHydro(rmesh=..., problem_source_factory=...)`` over 2 ranks (flat
layout) on the stage-faces (#7) and the negdiv-faces (#6/#2) rung, one
warm-up and 3 timed cycles, then one with the host reads counted and one
with the AGN injection metered; M5', the adaptive cluster at 64^3 in 16^3
blocks (``pressure_gradient``) over 2 ranks, 1 + 6 cycles through remeshes
that change the leaves.  Each is held bit for bit against its one-rank run
in this process (state, every dt, leaf tables, tracer pools and
``n_lost``), each rank's launches against the count expected and its bytes
per fill against its plan (the refined fill's also against the face slabs
the other ranks read and an all-gather of its rows); M5 and M5' also each
rank's host reads per cycle against the one-rank run's, one collective of
the source hook per stage, and (M5) the injection summed over the ranks
within 1e-3 of its rates; then M1's step with nccl at world size 1, bit
for bit with the plain step and its launches counted.  Then the same paths
with one card per rank over NCCL (``phase_multirank_nccl``): every
two-rank path where two cards are visible, M2 and the four-rank M1 and M5
where four are, against the same one-rank runs; on one card it prints a
line saying that it did not run.  A failed rank fails the script.  The
phase prints each path's seconds, the bytes each rank sends per fill and
zone-cycles/s labelled "N ranks sharing one H100, not a scaling figure"
or "N ranks with one H100 each (NCCL)".

The last lines are the kernels' JSON line, the card line and
``{"ok": true, "device": {...}}``.
"""

import argparse
import contextlib
import dataclasses
import io
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import types
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
# Errors are max |kernel - plain| over max |plain|, per variable.  Both
# versions do the same operations without FMA contraction and fold the
# same reciprocals, so on the card they agree bit for bit; the tolerances
# leave room for rounding, which -div(F)'s difference of neighbouring
# fluxes amplifies, and in f32 for a select that rounding flips (1.4e-5
# seen while the two rounded differently).
F32_TOL = 1e-4
F64_TOL = 1e-10
STEP_TOL = 1e-10

# published peaks of one H100 SXM at 700 W (NVIDIA data sheet; FP32 and
# FP64 outside the tensor cores)
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
FP64_OPS_PER_S = 34e12

BENCH_DECK = """
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
nx1 = {n}
x1min = 0.0
x1max = 3.0
nx2 = {n}
x2min = 0.0
x2max = 1.5
nx3 = {n}
x3min = 0.0
x3max = 1.5

<parthenon/meshblock>
nx1 = {n}
nx2 = {n}
nx3 = {n}

<parthenon/time>
integrator = vl2
cfl = 0.3
tlim = 100.0
nlim = {ncycles}
ncycle_out = 0
perf_cycle_offset = {warmup}

<hydro>
fluid = glmmhd
eos = adiabatic
riemann = hlld
reconstruction = ppm
gamma = 1.666666666666667
precision = {precision}
"""


OT_DECK = """
<job>
problem_id = orszag_tang

<parthenon/mesh>
nghost = 3
nx1 = {n}
x1min = 0.0
x1max = 1.0
nx2 = {n}
x2min = 0.0
x2max = 1.0
nx3 = 1
x3min = -0.5
x3max = 0.5

<parthenon/meshblock>
nx1 = {n}
nx2 = {n}

<parthenon/time>
integrator = vl2
cfl = 0.3
tlim = 0.5
nlim = {ncycles}
ncycle_out = 0
perf_cycle_offset = {warmup}

<hydro>
fluid = glmmhd
eos = adiabatic
riemann = hlld
reconstruction = ppm
gamma = 1.666666666666667
precision = {precision}
"""

SOD_DECK = """
<job>
problem_id = sod

<parthenon/mesh>
nghost = 2
nx1 = {n}
x1min = 0.0
x1max = 1.0
ix1_bc = outflow
ox1_bc = outflow
nx2 = 1
x2min = -0.5
x2max = 0.5
nx3 = 1
x3min = -0.5
x3max = 0.5

<parthenon/meshblock>
nx1 = {n}

<parthenon/time>
integrator = vl2
cfl = 0.3
tlim = 0.25
nlim = {ncycles}
ncycle_out = 0

<hydro>
fluid = euler
eos = adiabatic
riemann = hllc
reconstruction = plm
gamma = 1.4
precision = double
"""

# The refined-mesh throughput deck of ``bench.py:run_bench_smr``
# (``bench.py:168-221``): 128^3 base, 32^3 meshblocks, a level-1 region at
# the centre (56 + 64 = 120 leaves), Euler + HLLE + PLM + VL2, nghost 2.
SMR_3D_DECK = """
<job>
problem_id = blast

<parthenon/mesh>
refinement = static
numlevel = 2
nghost = 2
nx1 = {n}
x1min = -0.5
x1max = 0.5
nx2 = {n}
x2min = -0.5
x2max = 0.5
nx3 = {n}
x3min = -0.5
x3max = 0.5

<parthenon/static_refinement0>
x1min = -0.25
x1max = 0.25
x2min = -0.25
x2max = 0.25
x3min = -0.25
x3max = 0.25
level = 1

<parthenon/meshblock>
nx1 = {mb}
nx2 = {mb}
nx3 = {mb}

<parthenon/time>
integrator = vl2
cfl = 0.3
tlim = 100.0
nlim = {ncycles}
ncycle_out = 0

<hydro>
fluid = euler
eos = adiabatic
riemann = hlle
reconstruction = plm
gamma = 1.666666666666667
precision = {precision}

<problem/blast>
pressure_ambient = 0.001
pressure_ratio = 1.6e4
radius_outer = 0.12
density_ambient = 1.0
density_ratio = 1.0
"""

# The 2-D refined blast of ``tests/test_smr_2d.py:29-70`` and ``:293-302``
# (Euler + HLLC + PLM + VL2, nghost 2, gamma 1.4, level-1 centre) at the
# uniform 2-D path's size: 2048^2 base, 128^2 meshblocks (192 + 256 = 448
# leaves).
SMR_2D_DECK = """
<job>
problem_id = blast

<problem/blast>
pressure_ratio = 100.0
radius_outer = 0.15

<parthenon/mesh>
refinement = static
numlevel = 2
nghost = 2
nx1 = {n}
x1min = -0.5
x1max = 0.5
nx2 = {n}
x2min = -0.5
x2max = 0.5
nx3 = 1
x3min = -0.5
x3max = 0.5

<parthenon/static_refinement0>
x1min = -0.25
x1max = 0.25
x2min = -0.25
x2max = 0.25
x3min = -0.5
x3max = 0.5
level = 1

<parthenon/meshblock>
nx1 = {mb}
nx2 = {mb}
nx3 = 1

<parthenon/time>
integrator = vl2
cfl = 0.3
tlim = 1.0
nlim = {ncycles}
ncycle_out = 0

<hydro>
fluid = euler
eos = adiabatic
riemann = hllc
reconstruction = plm
gamma = 1.4
precision = {precision}
"""

# The adaptive throughput deck of ``bench.py:run_bench_adaptive``
# (``bench.py:251-345``): a blast on a base of 16^3 meshblocks that refines
# on the pressure gradient at 0.1 (numlevel 2), Euler + HLLE + PLM + VL2,
# nghost 2; here with a cycle line per cycle (the bench's ncycle_out is 0),
# whose leaf counts give the launches each cycle should make.
ADAPTIVE_3D_DECK = """
<job>
problem_id = blast

<parthenon/mesh>
refinement = adaptive
numlevel = 2
nghost = 2
nx1 = {n}
x1min = -0.5
x1max = 0.5
nx2 = {n}
x2min = -0.5
x2max = 0.5
nx3 = {n}
x3min = -0.5
x3max = 0.5

<parthenon/meshblock>
nx1 = {mb}
nx2 = {mb}
nx3 = {mb}

<refinement>
type = pressure_gradient
threshold_pressure_gradient = 0.1

<parthenon/time>
integrator = vl2
cfl = 0.3
tlim = 100.0
nlim = {ncycles}
ncycle_out = 1

<hydro>
fluid = euler
eos = adiabatic
riemann = hlle
reconstruction = plm
gamma = 1.666666666666667
precision = {precision}

<problem/blast>
pressure_ambient = 0.001
pressure_ratio = 1.6e4
radius_outer = 0.12
density_ambient = 1.0
density_ratio = 1.0
"""

# The 2-D refined blast above with ``refinement = adaptive`` on the pressure
# gradient at 0.3 instead of its static region (``tests/torch_decks.py:
# ADAPTIVE_2D``).
ADAPTIVE_2D_DECK = SMR_2D_DECK.replace(
    "refinement = static", "refinement = adaptive").replace(
    """<parthenon/static_refinement0>
x1min = -0.25
x1max = 0.25
x2min = -0.25
x2max = 0.25
x3min = -0.5
x3max = 0.5
level = 1
""", """<refinement>
type = pressure_gradient
threshold_pressure_gradient = 0.3
""")

# The reference performance suite's linear wave
# (``tst/regression/test_suites/performance/performance.py:32-54``,
# ``scripts/performance_grid.py:33-50``): n^3 in one block, ghost-free.
PERF_DECK = """
<job>
problem_id = {pid}

<problem/linear_wave>
compute_error = false
wave_flag = 0
amp = 1.0e-6
test = true

<parthenon/mesh>
nghost = 0
nx1 = {n}
x1min = 0.0
x1max = 3.0
nx2 = {n}
x2min = 0.0
x2max = 1.5
nx3 = {n}
x3min = 0.0
x3max = 1.5

<parthenon/meshblock>
nx1 = {n}
nx2 = {n}
nx3 = {n}

<parthenon/time>
integrator = {integ}
cfl = 0.3
tlim = 100.0
nlim = {ncycles}
ncycle_out = 0
perf_cycle_offset = {warmup}

<hydro>
fluid = {fluid}
eos = adiabatic
riemann = {riemann}
reconstruction = {recon}
gamma = 1.666666666666667
precision = {precision}
"""

# path E: the (fluid, integrator, reconstruction, Riemann solver)
# combinations of the performance suite that the kernels took up in this
# slice (WENO3, LimO3, WENO-Z, GLM-MHD HLLE), on the sweep rung; E' is the
# last of them on the whole-stage rung
PERF_MATRIX = [("euler", "rk3", "wenoz", "hlle"),
               ("glmmhd", "vl2", "plm", "hlle"),
               ("glmmhd", "vl2", "weno3", "hlle"),
               ("glmmhd", "rk2", "weno3", "hlle"),
               ("glmmhd", "rk3", "weno3", "hlle"),
               ("glmmhd", "rk2", "limo3", "hlle"),
               ("glmmhd", "rk3", "wenoz", "hlle")]
NSTAGES = {"rk1": 1, "rk2": 2, "vl2": 2, "rk3": 3}

# Path F: the strong blast of ``tests/test_flux_correct.py`` (pressure
# ratio 1e6) in 3-D with first-order flux correction, Euler HLLC + LimO3 +
# RK2, expanding into a near-vacuum (ambient density and pressure 1e-6,
# density ratio 1e6: the blast at density and pressure 1).  Its radii are
# 6.4 and 3.2 cells of the finest level (0.025 and 0.0125 at 256 cells):
# the first cycle's higher-order candidate then has cells at rho <= 0 or
# p <= 0, which the rescue takes.  The first stage depends only on the
# radius in cells; the test's radii, 0.1 and 0.05, would be 25.6 cells at
# 256 (a blast of more cells starts smoother).
FOFC_DECK = """
<job>
problem_id = blast

<problem/blast>
radius_outer = {r_out}
radius_inner = {r_in}
pressure_ratio = 1.0e6
density_ratio = 1.0e6
pressure_ambient = 1.0e-6
density_ambient = 1.0e-6

<parthenon/mesh>
nghost = 2
nx1 = {n}
x1min = -0.5
x1max = 0.5
nx2 = {n}
x2min = -0.5
x2max = 0.5
nx3 = {n}
x3min = -0.5
x3max = 0.5

<parthenon/meshblock>
nx1 = {mb}
nx2 = {mb}
nx3 = {mb}

<parthenon/time>
integrator = rk2
cfl = 0.3
tlim = 100.0
nlim = {ncycles}
ncycle_out = 0
perf_cycle_offset = {warmup}

<hydro>
fluid = euler
eos = adiabatic
riemann = hllc
reconstruction = limo3
gamma = 1.666666666666667
first_order_flux_correct = true
precision = {precision}
"""
# the same blast on path B's refined mesh (a level-1 region at the centre)
FOFC_SMR_DECK = FOFC_DECK.replace("""<parthenon/mesh>
nghost = 2""", """<parthenon/mesh>
refinement = static
numlevel = 2
nghost = 2""").replace("<parthenon/meshblock>", """\
<parthenon/static_refinement0>
x1min = -0.25
x1max = 0.25
x2min = -0.25
x2max = 0.25
x3min = -0.25
x3max = 0.25
level = 1

<parthenon/meshblock>""")


def fofc_deck(n, ncycles, precision, refined=False, mb=None, warmup=0):
    """Path F's deck with its radii at 6.4 and 3.2 cells of the finest
    level (level 1 of the refined deck: twice the base resolution)."""
    fine = 2 * n if refined else n
    return (FOFC_SMR_DECK if refined else FOFC_DECK).format(
        n=n, mb=mb or n, ncycles=ncycles, warmup=warmup, precision=precision,
        r_out=6.4 / fine, r_in=3.2 / fine)


# the kernels' template codes in order (csrc/hydro_device.cuh)
RECON_NAMES = ["dc", "plm", "ppm", "weno3", "limo3", "wenoz"]
SOLVER_PAIRS = [("euler", "hlle"), ("euler", "hllc"), ("glmmhd", "hlld"),
                ("euler", "llf"), ("glmmhd", "llf"), ("glmmhd", "hlle")]

RUNGS = {"sweep": None, "stage": "ATHENAPK_PALLAS_STAGE"}
# refined-mesh paths: (deck, rung, face-kernel launches per cycle:
# stage-faces, negdiv-faces); A = 2 levels x 2 stages, B = 3 directions x
# 2 levels x 2 stages, C = 2 directions x 2 levels x 2 stages
SMR_PATHS = {"A": ("3d", "stage", (4, 0)), "B": ("3d", "negdiv", (0, 12)),
             "C": ("2d", "negdiv", (0, 8))}
# adaptive paths: (rung, base n, face-kernel launches per level and cycle);
# D = the run_bench_adaptive protocol at n = 128 on the default rung (2
# stages), D' = the bench's own size on the negdiv rung (3 directions x 2
# stages)
AMR_PATHS = {"D": ("stage", 128, 2), "D'": ("negdiv", 64, 6)}
# kernel launches per cycle of the main deck (VL2: a DC and a PPM stage),
# (sweep kernel, stage kernel)
RUNG_LAUNCHES = {"sweep": (6, 0), "stage": (0, 2)}
# EOS kernel launches per cycle of the main deck: one per stage outside the
# stage kernel and one for the dt where no stage emits it (a run adds one
# for its initial dt)
RUNG_EOS_LAUNCHES = {"sweep": 3, "stage": 0}
SOD_L1_TOL = 1.0e-3   # 1024 cells; 6.9e-4 with HLLC + PLM + VL2 (64: 7.6e-3)


T0 = time.time()


def log(*a):
    """Print; a phase's header line (``== ...``) with the seconds since
    the script started, so that a run shows where its time went."""
    if a and str(a[0]).startswith("== "):
        a = a + (f"[{time.time() - T0:.1f} s]",)
    print(*a, flush=True)


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


PORT = None   # the port's modules, set by main()


def make_sim(deck, rung="sweep", restart=None):
    """``Simulation`` of ``deck`` on the card (resumed from the payload
    ``restart``, if given); the rung is read from the environment when the
    package is built."""
    for name in RUNGS.values():
        if name:
            os.environ.pop(name, None)
    if RUNGS[rung]:
        os.environ[RUNGS[rung]] = "1"
    try:
        return PORT.Simulation(PORT.ParameterInput.from_string(deck),
                               quiet=True, restart=restart)
    finally:
        if RUNGS[rung]:
            del os.environ[RUNGS[rung]]


def make_smr_sim(deck, rung, restart=None, quiet=False):
    """``SmrSimulation`` of ``deck`` on the card (resumed from ``restart``,
    if given); ``rung`` "negdiv" sets ``ATHENAPK_PALLAS_STAGE=0`` while the
    stepper is built."""
    os.environ.pop("ATHENAPK_PALLAS_STAGE", None)
    if rung == "negdiv":
        os.environ["ATHENAPK_PALLAS_STAGE"] = "0"
    try:
        return PORT.SmrSimulation(PORT.ParameterInput.from_string(deck),
                                  quiet=quiet, restart=restart)
    finally:
        os.environ.pop("ATHENAPK_PALLAS_STAGE", None)


def reset_counts():
    PORT.sweep.negdiv_cuda.launches = 0
    PORT.stage.stage_cuda.launches = 0
    PORT.stage.stage_faces_cuda.launches = 0
    PORT.sweep.negdiv_faces_cuda.launches = 0
    PORT.sweep.negdiv_scalars_cuda.launches = 0
    PORT.stage.stage_scalars_cuda.launches = 0
    PORT.adiabatic_cuda.cons_to_prim_cuda.launches = 0
    PORT.tabular_cooling_cuda.townsend_cuda.launches = 0
    PORT.tabular_cooling_cuda.cooling_dt_cuda.launches = 0


def cooling_launches():
    """Calls of the cooling kernels (``srcterms.tabular_cooling_cuda``)
    since the last ``reset_counts``: ``(updates, dts)``.  An update is one
    launch, a dt two (the blocks' partial minima, then their minimum)."""
    t = PORT.tabular_cooling_cuda
    return t.townsend_cuda.launches, t.cooling_dt_cuda.launches


@contextlib.contextmanager
def plain_cooling():
    """The cooling's plain versions (``TabularCooling.cool_plain`` and
    ``cooling_dt_plain``) forced in place of its kernels' dispatchers while
    the block runs."""
    t = PORT.tabular_cooling_cuda
    saved = t.fused_townsend, t.fused_cooling_dt
    t.fused_townsend = lambda c, u, dt, fluid: c.cool_plain(u, dt, fluid)
    t.fused_cooling_dt = lambda c, w, mesh: c.cooling_dt_plain(w, mesh)
    try:
        yield
    finally:
        t.fused_townsend, t.fused_cooling_dt = saved


def eos_launches():
    """Launches of the EOS kernel (``eos.adiabatic_cuda``) since the last
    ``reset_counts``."""
    return PORT.adiabatic_cuda.cons_to_prim_cuda.launches


def read_counts():
    return (PORT.sweep.negdiv_cuda.launches, PORT.stage.stage_cuda.launches)


def read_face_counts():
    return (PORT.stage.stage_faces_cuda.launches,
            PORT.sweep.negdiv_faces_cuda.launches)


def all_launches():
    """The launches of the fluid, scalar and cooling kernels, summed from
    their counters (a cooling dt call is two launches)."""
    n_up, n_dt = cooling_launches()
    return sum(read_counts() + read_face_counts()) \
        + PORT.sweep.negdiv_scalars_cuda.launches \
        + PORT.stage.stage_scalars_cuda.launches + n_up + 2 * n_dt


COOLING_KERNEL = re.compile(r"townsend_cool_kernel|cooling_dt_(?:min_)?kernel")
PORT_KERNEL = re.compile(r"negdiv_sweep_kernel|fused_stage_kernel|"
                         r"scalars_kernel|" + COOLING_KERNEL.pattern)
COOLING_KEY = "tabular_cooling (the cooling kernels)"


class TraceLost(Exception):
    """The profiler's trace lacks kernels that the profiled run launched."""


def check_trace(kernels, launched):
    """Raise ``TraceLost`` unless the trace's ``kernels`` hold each of the
    ``launched`` launches of the port's kernels in the profiled run (the
    profiler can drop device events, and a breakdown without them would
    give the other kernels a larger share)."""
    seen = sum(bool(PORT_KERNEL.search(e["name"])) for e in kernels)
    if seen != launched:
        raise TraceLost(f"the trace holds {seen} of the {launched} kernels "
                        "the port launched in the profiled cycles")


def checked_profile(fn):
    """Run the profile phase ``fn``; where its trace lost kernels, run it
    once more (``attempts``, 2 by default), and where that trace loses
    kernels too, the breakdown is not measured (None)."""
    def run(*a, attempts=2, **k):
        for attempt in range(1, attempts + 1):
            try:
                return fn(*a, **k)
            except TraceLost as e:
                log(f"  {e}: events were lost"
                    + ("; profiling again" if attempt < attempts else
                       "; this breakdown is not measured"))
        return None
    return run


def smooth_glm_prim(mesh, seed, dtype):
    """Smooth GLM-MHD primitive state, every component nonzero, plus seeded
    noise (made on the host with numpy, as the CPU tests make theirs)."""
    rng = np.random.default_rng(seed)
    x, y, z = mesh.cell_centers_mesh()
    tp = 2.0 * np.pi
    w = np.zeros((mesh.nblocks, 9) + mesh.block_shape)
    w[:, 0] = 1.0 + 0.1 * np.sin(tp * x) * np.cos(tp * y) \
        + 0.05 * np.sin(tp * z)
    w[:, 1] = 0.3 + 0.2 * np.sin(tp * z) + 0.0 * x
    w[:, 2] = 0.2 + 0.1 * np.cos(tp * x) + 0.0 * y
    w[:, 3] = -0.15 + 0.1 * np.sin(tp * y) + 0.0 * z
    w[:, 4] = 0.6 + 0.05 * np.cos(tp * (x + y + z))
    w[:, 5] = 1.0 + 0.1 * np.sin(tp * y) + 0.0 * x
    w[:, 6] = 0.5 + 0.1 * np.cos(tp * z) + 0.0 * x
    w[:, 7] = 0.1 + 0.1 * np.sin(tp * x) + 0.0 * y
    w[:, 8] = 0.01 * np.sin(tp * (x - y)) + 0.0 * z
    w += 1e-3 * rng.standard_normal(w.shape)
    return torch.tensor(w, dtype=dtype, device="cuda")


def random_prim(mesh, fluid, seed):
    """Positive density and pressure, every other component of either sign
    (numpy, f64)."""
    rng = np.random.default_rng(seed)
    nvar = 9 if fluid == "glmmhd" else 5
    cells = (mesh.nblocks,) + mesh.block_shape
    w = np.ones((mesh.nblocks, nvar) + mesh.block_shape)
    w[:, 0] = 1.0 + 0.3 * rng.random(cells)
    w[:, 1:4] = 0.3 * rng.standard_normal((cells[0], 3) + cells[1:])
    w[:, 4] = 1.0 + 0.2 * rng.random(cells)
    if nvar == 9:
        w[:, 5:8] = 0.2 * rng.standard_normal((cells[0], 3) + cells[1:])
        w[:, 8] = 0.01 * rng.standard_normal(cells)
    return w


def floor_tripping_states(mesh, fluid, seed, dtype):
    """Two distinct conserved states on the card.  The first is the smooth
    state above (its first five variables for Euler) as conserved
    variables; ``FLOORS`` cut into its smooth fields, so the density floor
    and the pressure and internal-energy floors each trip in whole regions,
    inside tiles and in their halo cells.

    Smooth fields plus small noise, not white noise: where a floored
    plateau meets white noise, a last-bit difference between kernel and
    plain flips a PPM limiter select in about one cell in a million, which
    then differs by 1e-3 (seen while the kernels divided by Python scalars
    that PyTorch on the card multiplies by their reciprocals: ``x / 6`` is
    ``x * (1 / 6)``).  That state is ``hard_floor_states``, held to a gate
    of its own."""
    w = smooth_glm_prim(mesh, seed, torch.float64)
    if fluid != "glmmhd":
        w = w[:, :5].contiguous()
    u0 = PORT.prim_to_cons(PORT.EOS(gamma=5.0 / 3.0), w, fluid).to(dtype)
    return u0, 1.01 * u0 + 0.001


FLOORS = dict(density_floor=0.95, pressure_floor=0.58, internal_e_floor=0.9)
HARD_FLOORS = dict(density_floor=0.9, pressure_floor=0.8,
                   internal_e_floor=1.25)
# share of cells in which the f32 stage kernel may leave the tolerance on the
# hard state, each of them accounted for by the sweep kernel (measured: 14 of
# 1.9e7 cells at 128^3, 7.4e-7, while the kernels divided by Python scalars;
# none since they fold the reciprocals as PyTorch does)
HARD_F32_CELLS_OVER = 1e-5


def hard_floor_states(mesh, fluid, seed, dtype):
    """The hard pair of conserved states: white noise in every variable,
    with isolated cells of the first below ``HARD_FLOORS`` (3 % below the
    density floor, 5 % below both pressure floors; mild dips, so that PPM's
    edge states stay positive), as the CPU tests make theirs."""
    rng = np.random.default_rng(seed + 1)
    w = random_prim(mesh, fluid, seed)
    pick = rng.random((mesh.nblocks,) + mesh.block_shape)
    w[:, 0][pick < 0.03] = 0.8
    w[:, 4][(pick > 0.03) & (pick < 0.08)] = 0.6
    w = torch.tensor(w, device="cuda")
    u0 = PORT.prim_to_cons(PORT.EOS(gamma=5.0 / 3.0), w, fluid).to(dtype)
    return u0, 1.01 * u0 + 0.001


def share_of_cells_over(got, ref, tol):
    """Share of the cells in which some variable of ``got`` is further from
    ``ref`` than ``tol`` times that variable's largest magnitude."""
    scale = ref.abs().amax(dim=(0, 2, 3, 4), keepdim=True)
    over = ((got - ref).abs() > tol * scale).any(dim=1)
    return over.double().mean().item()


def cuda_ms(fn, reps):
    """Mean device time of ``fn()`` over ``reps`` calls (CUDA events),
    after one warm-up call."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def max_rel_err(got, ref, per_var=True):
    """max |got - ref| over max |ref|, for each variable (axis 1) and the
    worst of them returned, or over all variables at once.  A variable that
    is zero everywhere in ``ref`` (the vortex has no z components) must be
    zero in ``got`` too: its error is 0 then, else infinite."""
    err = (got - ref).abs()
    if not per_var:
        return (err.max() / ref.abs().max()).item()
    dims = [0, 2, 3, 4]
    top, scale = err.amax(dim=dims), ref.abs().amax(dim=dims)
    rel = torch.where(scale > 0, top / scale,
                      torch.where(top > 0, torch.inf, 0.0))
    return rel.max().item()


def count_ops(fn):
    """Floating-point operations that ``fn()`` (the plain version, on this
    run's data) needs for its result: adds, subtracts, multiplies,
    divisions, square roots, reciprocals, squares, minima and maxima, one
    per output element that the result depends on.

    The plain version is a branch-free ``torch.where`` lattice: it computes
    every HLLD region's state and both sides of every PPM limiter at every
    face.  A pass back over the recorded operations lets each
    ``torch.where`` pass on only the side each element takes, so work that
    no face takes on these data is not counted.  Not counted: sign flips
    and absolute values (operand modifiers on the card), comparisons,
    selects, data movement, and the sign function's ``(x >= 0) * 2 - 1``
    (one select on the card).  A division or square root counts as one,
    though the card runs each as several instructions.

    Returns ``(ops, divisions_and_roots, ops_branch_free)``, the last the
    count of every element the lattice computes."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_flatten, tree_unflatten

    counted = {"add", "sub", "mul", "div", "sqrt", "reciprocal", "pow",
               "maximum", "minimum"}
    token, slot, tape = object(), object(), []

    def tag_of(x):
        tag = getattr(x, "_count_tag", None)
        return tag[1] if tag is not None and tag[0] is token else None

    class Record(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            if not isinstance(out, torch.Tensor):
                raise NotImplementedError(f"count_ops: {func} returns "
                                          f"{type(out).__name__}")
            name = func.overloadpacket.__name__
            leaves, spec = tree_flatten((args, kwargs))
            ins = [x for x in leaves if isinstance(x, torch.Tensor)]
            arrays = [x for x in ins if x.dim() > 0]
            out._count_sign = (
                (name == "_to_copy" and ins[0].dtype == torch.bool)
                or (name in ("mul", "sub") and bool(arrays) and all(
                    getattr(x, "_count_sign", False) for x in arrays)))
            out._count_tag = (token, len(tape))
            kind = ("where" if name == "where" else "pointwise"
                    if torch.Tag.pointwise in func.tags
                    or name == "_to_copy" else "moves")
            if kind == "where" and len(ins) != 3:
                raise NotImplementedError(f"count_ops: {func} with a "
                                          f"scalar operand")
            tape.append(dict(
                func=func, spec=spec, kind=kind, name=name,
                counted=name in counted and not out._count_sign,
                numel=out.numel(),
                leaves=[slot if isinstance(x, torch.Tensor) else x
                        for x in leaves],
                ins=[(tag_of(x), x.shape) for x in ins],
                cond=args[0] if kind == "where" else None))
            return out

    with Record():
        result = fn()
    full = sum(e["numel"] for e in tape if e["counted"])

    need = {tag_of(result): torch.ones(result.shape, dtype=torch.bool,
                                       device=result.device)}
    ops = slow = 0
    for i in range(len(tape) - 1, -1, -1):
        e, tape[i] = tape[i], None
        m = need.pop(i, None)
        if m is None:
            continue
        if e["counted"]:
            k = int(m.sum())
            ops += k
            if e["name"] in ("div", "sqrt", "reciprocal"):
                slow += k
        if all(tag is None for tag, _ in e["ins"]):
            continue
        if e["kind"] == "where":
            masks = [m, m & e["cond"], m & ~e["cond"]]
        elif e["kind"] == "pointwise":
            masks = [m] * len(e["ins"])
        else:
            # data movement (roll, select, stack): its vector-Jacobian
            # product carries the mask back to the elements it read
            xs = [torch.zeros(shape, device=m.device, requires_grad=True)
                  for _, shape in e["ins"]]
            it = iter(xs)
            args, kwargs = tree_unflatten(
                [next(it) if x is slot else x for x in e["leaves"]],
                e["spec"])
            grads = torch.autograd.grad(e["func"](*args, **kwargs), xs,
                                        m.float(), allow_unused=True)
            masks = [torch.zeros(x.shape, dtype=torch.bool, device=m.device)
                     if g is None else g > 0 for x, g in zip(xs, grads)]
        for (tag, shape), mi in zip(e["ins"], masks):
            if tag is None:
                continue
            if mi.shape != shape:
                mi = mi.int().sum_to_size(shape) > 0
            need[tag] = need[tag] | mi if tag in need else mi
    return ops, slow, full


def phase_build():
    log("== phase 2: build (one nvcc per translation unit, 13 per library, "
        "two libraries per source (decks without and with scalars), "
        "all started together) ==")
    results = {}

    def build(name, fn):
        t0 = time.time()
        results[name] = fn() + (time.time() - t0,)

    t0 = time.time()
    threads = [threading.Thread(target=build, args=a) for a in (
        ("negdiv_sweep", PORT.sweep.build_library),
        ("fused_stage", PORT.stage.build_library),
        ("negdiv_sweep (scalars)",
         lambda: PORT.sweep.build_library(scalars=True)),
        ("fused_stage (scalars)",
         lambda: PORT.stage.build_library(scalars=True)),
        ("amr_forest (g++)",
         lambda: (PORT.amr_forest.build_library(), "")),
        ("tabular_cooling", PORT.tabular_cooling_cuda.build_library))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if len(results) != len(threads):
        raise RuntimeError("a kernel did not build")   # its thread raised
    spilling = []
    ptxas = PORT.sweep.PTXAS | PORT.stage.PTXAS
    for name, (path, compiler_log, secs) in results.items():
        summary = PORT.kernels.ptxas_summary(compiler_log, ptxas,
                                             occupancy=True)
        spilling += [ln for ln in summary if "0 bytes spill stores" not in ln]
        regs = [int(re.search(r"(\d+) registers", ln).group(1))
                for ln in summary]
        log(f"  built {path.relative_to(ROOT)} in {secs:.2f} s: "
            f"{len(summary)} instantiations, registers "
            f"{min(regs, default=0)}-{max(regs, default=0)}, "
            f"{sum(ln not in spilling for ln in summary)} without spills")
        for ln in summary:
            log("  ptxas:", ln)
    log(f"  all built in {time.time() - t0:.2f} s")
    if spilling:
        raise AssertionError(f"instantiations that spill: {spilling}")


def _mesh(n, mb, g):
    """Mesh of extents ``n`` in blocks of ``mb`` with ``g`` ghost cells."""
    return PORT.Mesh(nx1=n[0], nx2=n[1], nx3=n[2], mbnx1=mb[0], mbnx2=mb[1],
                     mbnx3=mb[2], x1min=0.0, x1max=1.0, x2min=0.0, x2max=1.5,
                     x3min=0.0, x3max=1.5, nghost=g)


PAIRS = (("glmmhd", "hlld"), ("euler", "hllc"), ("euler", "hlle"))
TOLS = ((torch.float32, F32_TOL), (torch.float64, F64_TOL))


def phase_kernel_vs_plain(seed):
    log("== phase 3: kernels against plain ==")
    sweep, stage = PORT.sweep, PORT.stage
    eos = PORT.EOS(gamma=5.0 / 3.0)
    failed = []

    def report(what, err, tol, finite):
        ok = err <= tol and finite
        log(f"  {what:66s} max rel err {err:.3e} (tol {tol:.0e}, per "
            f"variable) {'ok' if ok else 'FAIL'}")
        if not ok:
            failed.append(what)

    layouts = [("128^3 one block", (128,) * 3, (128,) * 3, 0),
               ("8 blocks of 32^3, nghost 3", (64,) * 3, (32,) * 3, 3),
               ("2-D 512^2 one block", (512, 512, 1), (512, 512, 1), 0),
               ("2-D 4 blocks of 256^2, nghost 3", (512, 512, 1),
                (256, 256, 1), 3),
               ("1-D 4096 one block", (4096, 1, 1), (4096, 1, 1), 0),
               ("1-D 4 blocks of 1024, nghost 3", (4096, 1, 1), (1024, 1, 1),
                3)]
    for label, n, mb, g in layouts:
        mesh = _mesh(n, mb, g)
        sl = mesh.interior_slices
        for fluid, riemann in PAIRS:
            c_h = 1.3 if fluid == "glmmhd" else 0.0
            for dtype, tol in TOLS:
                # the smooth state for 3-D GLM-MHD, a random one elsewhere
                if fluid == "glmmhd" and n[2] > 1:
                    prim = smooth_glm_prim(mesh, seed, dtype)
                else:
                    prim = torch.tensor(random_prim(mesh, fluid, seed),
                                        dtype=dtype, device="cuda")
                for recon in ("dc", "plm", "ppm"):
                    cfg = PORT.HydroConfig(fluid=fluid, riemann=riemann,
                                           reconstruction=recon)
                    got = sweep.negdiv_cuda(prim, c_h, mesh, cfg, eos, recon)
                    torch.cuda.synchronize()
                    ref = sweep.negdiv_plain(prim, c_h, mesh, cfg, eos, recon)
                    report(f"sweep {label}, {fluid} {riemann} {recon} "
                           f"{str(dtype)[6:]}", max_rel_err(got[sl], ref[sl]),
                           tol, bool(torch.isfinite(got[sl]).all()))
                    del got, ref
                del prim
        torch.cuda.empty_cache()

    eos = PORT.EOS(gamma=5.0 / 3.0, **FLOORS)
    for label, n, mb, g in layouts[:2]:
        mesh = _mesh(n, mb, g)
        sl = mesh.interior_slices
        emit_dt = g == 0
        for fluid, riemann in PAIRS[:2]:
            c_h = 1.3 if fluid == "glmmhd" else 0.0
            for dtype, tol in TOLS:
                u0, u1 = floor_tripping_states(mesh, fluid, seed, dtype)
                u0f, _ = PORT.cons_to_prim(eos, u0, fluid, 0)
                if min(int((u0f[:, k] != u0[:, k]).sum()) for k in (0, 4)) \
                        < 1000:
                    raise AssertionError("the test state trips no floor")
                for recon in ("dc", "plm", "ppm"):
                    cfg = PORT.HydroConfig(fluid=fluid, riemann=riemann,
                                           reconstruction=recon)
                    args = (u0, u1, 0.25, 0.75, 1e-3, c_h, mesh, cfg, eos,
                            recon)
                    got = stage.stage_cuda(*args, emit_dt=emit_dt,
                                           emit_prim=True)
                    torch.cuda.synchronize()
                    ref = stage.stage_plain(*args, emit_dt=emit_dt,
                                            emit_prim=True)
                    err = max(max_rel_err(got[0][sl], ref[0][sl]),
                              max_rel_err(got[-1], ref[-1]))
                    if emit_dt:
                        a, b = got[1].min().item(), ref[1].min().item()
                        err = max(err, abs(a - b) / b)
                    report(f"stage {label}, {fluid} {riemann} {recon} "
                           f"{str(dtype)[6:]}"
                           f"{' +dt' if emit_dt else ''} +prim", err, tol,
                           bool(torch.isfinite(got[0][sl]).all()))
                    del got, ref
                del u0, u1, u0f
        torch.cuda.empty_cache()

    # The hard state.  f64 is held to its tolerance in every cell.  In f32
    # a PPM select may flip in a few cells (see floor_tripping_states): the
    # share of cells over the tolerance is bounded, and every cell must
    # agree with the plain stage whose -div(F) is the sweep kernel's on the
    # same prim, so only what the sweep kernel does alike is let through.
    eos = PORT.EOS(gamma=5.0 / 3.0, **HARD_FLOORS)
    gam0, gam1, beta_dt = 0.25, 0.75, 1e-3
    for label, n, mb, g in layouts[:2]:
        mesh = _mesh(n, mb, g)
        sl = mesh.interior_slices
        emit_dt = g == 0
        for fluid, riemann in PAIRS[:2]:
            c_h = 1.3 if fluid == "glmmhd" else 0.0
            for dtype, tol in TOLS:
                allowed = HARD_F32_CELLS_OVER if dtype == torch.float32 \
                    else 0.0
                u0, u1 = hard_floor_states(mesh, fluid, seed, dtype)
                u0f, _ = PORT.cons_to_prim(eos, u0, fluid, 0)
                if min(int((u0f[:, k] != u0[:, k]).sum()) for k in (0, 4)) \
                        < 1000:
                    raise AssertionError("the hard state trips no floor")
                for recon in ("dc", "plm", "ppm"):
                    cfg = PORT.HydroConfig(fluid=fluid, riemann=riemann,
                                           reconstruction=recon)
                    args = (u0, u1, gam0, gam1, beta_dt, c_h, mesh, cfg, eos,
                            recon)
                    got = stage.stage_cuda(*args, emit_dt=emit_dt,
                                           emit_prim=True)
                    torch.cuda.synchronize()
                    ref = stage.stage_plain(*args, emit_dt=emit_dt,
                                            emit_prim=True)
                    over = share_of_cells_over(got[0][sl], ref[0][sl], tol)
                    worst = max_rel_err(got[0][sl], ref[0][sl])
                    nd_k = sweep.negdiv_cuda(ref[-1], c_h, mesh, cfg, eos,
                                             recon)
                    nd_p = sweep.negdiv_plain(ref[-1], c_h, mesh, cfg, eos,
                                              recon)
                    with_sweep = ref[0] + beta_dt * (nd_k - nd_p)
                    err = max(max_rel_err(got[0][sl], with_sweep[sl]),
                              max_rel_err(got[-1], ref[-1]))
                    if emit_dt:
                        a, b = got[1].min().item(), ref[1].min().item()
                        err = max(err, abs(a - b) / b)
                    what = (f"stage hard state, {label}, {fluid} {riemann} "
                            f"{recon} {str(dtype)[6:]}")
                    log(f"  {what}: against plain {worst:.3e}, share of "
                        f"cells over {tol:.0e}: {over:.3e} (allowed "
                        f"{allowed:.0e})")
                    report(what + ", sweep kernel's -div(F)", err, tol,
                           bool(torch.isfinite(got[0][sl]).all())
                           and over <= allowed)
                    del got, ref, nd_k, nd_p, with_sweep
                del u0, u1, u0f
        torch.cuda.empty_cache()
    if failed:
        raise AssertionError(f"kernel disagrees with plain: {failed}")


def dip_prim(mesh, fluid, seed, dtype, dips=True):
    """Smooth fields and 5 % noise (numpy, then on the card); with ``dips``
    also isolated cells of density 0.02 and of pressure 0.01 beside O(1)
    neighbours, where LimO3's density and pressure edges overshoot below
    zero and its positivity fallback runs (the other reconstructions' edges
    go negative there too, and their solvers return NaN: both versions
    alike, so those take the state without dips)."""
    rng = np.random.default_rng(seed)
    nvar = 9 if fluid == "glmmhd" else 5
    x, y, z = mesh.cell_centers_mesh()
    tp = 2.0 * np.pi
    w = np.zeros((mesh.nblocks, nvar) + mesh.block_shape)
    w[:, 0] = 1.0 + 0.3 * np.sin(tp * x) * np.cos(tp * y) + 0.0 * z
    w[:, 1] = 0.3 * np.sin(tp * z) + 0.0 * x
    w[:, 2] = 0.2 * np.cos(tp * x) + 0.0 * y
    w[:, 3] = -0.15 + 0.1 * np.sin(tp * y) + 0.0 * z
    w[:, 4] = 0.6 + 0.3 * np.cos(tp * (x + y + z))
    if nvar == 9:
        w[:, 5] = 1.0 + 0.1 * np.sin(tp * y) + 0.0 * x
        w[:, 6] = 0.5 + 0.1 * np.cos(tp * z) + 0.0 * x
        w[:, 7] = 0.1 + 0.0 * x
        w[:, 8] = 0.01 * np.sin(tp * (x - y)) + 0.0 * z
    w += 0.05 * rng.standard_normal(w.shape)
    if dips:
        pick = rng.random((mesh.nblocks,) + mesh.block_shape)
        w[:, 0][pick < 0.05] = 0.02
        w[:, 4][(pick > 0.05) & (pick < 0.1)] = 0.01
    return torch.tensor(w, dtype=dtype, device="cuda")


def limo3_switch_prim(dtype):
    """A 1-D GLM-MHD state whose every variable climbs in steps that put
    LimO3's smoothness measure eta within a few eps of 1 at dx = 1/4096:
    the three-way select on eta against 1 +- 10 eps takes each branch."""
    rng = np.random.default_rng(3)
    n, dx = 4096, 1.0 / 4096
    eps = float(torch.finfo(dtype).eps)
    a = np.sqrt(0.5) * 0.1 * dx
    steps = a * (1.0 + eps * rng.integers(-12, 13, size=(9, n)))
    w = np.cumsum(steps, axis=-1)       # from a, small: little rounding
    return torch.tensor(w[None, :, None, None, :], dtype=dtype,
                        device="cuda")


def phase_new_cases(seed):
    """Every kernel route against its plain version for each (fluid,
    solver) pair and reconstruction that this slice added (the cases with
    a new reconstruction or a new solver), f32 and f64: #1 (3-D, one
    block), #6/#2 (3-D ghosted, with faces), #4 (2-D and 1-D), #5 (2-D
    ghosted, with faces), #3 (stage, floors, CFL and prim outputs), #7
    (stage on ghosted blocks, with faces); then LimO3's switch at eta = 1."""
    log("== phase 3: kernels against plain, the new reconstructions and "
        "solvers ==")
    sweep, stage = PORT.sweep, PORT.stage
    failed, n_checks = [], 0
    worst = {}
    layouts = {"#1 3-D 64^3": ((64,) * 3, (64,) * 3, 0),
               "#6/#2 3-D 2 blocks of 32^3, nghost 3, faces": (
                   (64, 32, 32), (32,) * 3, 3),
               "#4 2-D 256^2": ((256, 256, 1), (256, 256, 1), 0),
               "#4 1-D 2048": ((2048, 1, 1), (2048, 1, 1), 0),
               "#5 2-D 4 blocks of 64^2, nghost 3, faces": (
                   (128, 128, 1), (64, 64, 1), 3)}
    stage_layouts = {"#3 stage 3-D 48^3 +dt +prim": ((48,) * 3, (48,) * 3, 0),
                     "#7 stage 3-D 2 blocks of 24^3, nghost 3, faces": (
                         (48, 24, 24), (24,) * 3, 3)}
    cases = [(f, r, rec) for f, r in SOLVER_PAIRS for rec in RECON_NAMES
             if rec not in ("dc", "plm", "ppm") or (f, r) not in PAIRS]
    eos = PORT.EOS(gamma=5.0 / 3.0)
    eos_f = PORT.EOS(gamma=5.0 / 3.0, **FLOORS)

    def check(route, what, err, tol, finite):
        nonlocal n_checks
        n_checks += 1
        worst[route] = max(worst.get(route, 0.0), err)
        if not (err <= tol and finite):
            failed.append(f"{what}: {err:.3e}")
            log(f"  FAIL {what}: max rel err {err:.3e} (tol {tol:.0e})")

    for label, (n, mb, g) in layouts.items():
        mesh = _mesh(n, mb, g)
        sl = mesh.interior_slices
        for dtype, tol in TOLS:
            prims = {(f, d): dip_prim(mesh, f, seed, dtype, dips=d)
                     for f in ("euler", "glmmhd") for d in (False, True)}
            for fluid, riemann, recon in cases:
                prim = prims[fluid, recon == "limo3"]
                c_h = 1.3 if fluid == "glmmhd" else 0.0
                cfg = PORT.HydroConfig(fluid=fluid, riemann=riemann,
                                       reconstruction=recon)
                what = f"{label}, {fluid} {riemann} {recon} {str(dtype)[6:]}"
                if g:
                    got, gf = sweep.negdiv_faces_cuda(prim, c_h, mesh, cfg,
                                                      eos, recon)
                    torch.cuda.synchronize()
                    ref, rf = sweep.negdiv_faces_plain(prim, c_h, mesh, cfg,
                                                       eos, recon)
                    err = max([max_rel_err(got[sl], ref[sl])]
                              + [face_err(gf[d], rf[d]) for d in rf])
                    finite = bool(torch.isfinite(got[sl]).all())
                else:
                    got = sweep.negdiv_cuda(prim, c_h, mesh, cfg, eos, recon)
                    torch.cuda.synchronize()
                    ref = sweep.negdiv_plain(prim, c_h, mesh, cfg, eos, recon)
                    err = max_rel_err(got[sl], ref[sl])
                    finite = bool(torch.isfinite(got[sl]).all())
                check(label, what, err, tol, finite)
                del got, ref
            del prims
        torch.cuda.empty_cache()
    for label, (n, mb, g) in stage_layouts.items():
        mesh = _mesh(n, mb, g)
        sl = mesh.interior_slices
        for dtype, tol in TOLS:
            states = {f: floor_tripping_states(mesh, f, seed, dtype)
                      for f in ("euler", "glmmhd")}
            for fluid, riemann, recon in cases:
                u0, u1 = states[fluid]
                c_h = 1.3 if fluid == "glmmhd" else 0.0
                cfg = PORT.HydroConfig(fluid=fluid, riemann=riemann,
                                       reconstruction=recon)
                args = (u0, u1, 0.25, 0.75, 1e-3, c_h, mesh, cfg, eos_f,
                        recon)
                what = f"{label}, {fluid} {riemann} {recon} {str(dtype)[6:]}"
                if g:
                    got = stage.stage_faces_cuda(*args, emit_prim=True)
                    torch.cuda.synchronize()
                    ref = stage.stage_faces_plain(*args, emit_prim=True)
                    err = max([max_rel_err(got[0][sl], ref[0][sl]),
                               max_rel_err(got[1], ref[1])]
                              + [face_err(got[2][d], ref[2][d])
                                 for d in ref[2]])
                else:
                    got = stage.stage_cuda(*args, emit_dt=True,
                                           emit_prim=True)
                    torch.cuda.synchronize()
                    ref = stage.stage_plain(*args, emit_dt=True,
                                            emit_prim=True)
                    a, b = got[1].min().item(), ref[1].min().item()
                    err = max(max_rel_err(got[0], ref[0]),
                              max_rel_err(got[2], ref[2]), abs(a - b) / b)
                check(label, what, err, tol,
                      bool(torch.isfinite(got[0][sl]).all()))
                del got, ref
            del states
        torch.cuda.empty_cache()
    # LimO3's three-way switch: each branch taken, kernel and plain alike
    mesh = _mesh((4096, 1, 1), (4096, 1, 1), 0)
    cfg = PORT.HydroConfig(fluid="glmmhd", riemann="hlle",
                           reconstruction="limo3")
    for dtype, tol in TOLS:
        prim = limo3_switch_prim(dtype)
        got = sweep.negdiv_cuda(prim, 0.5, mesh, cfg, eos, "limo3")
        torch.cuda.synchronize()
        ref = sweep.negdiv_plain(prim, 0.5, mesh, cfg, eos, "limo3")
        dvp = torch.roll(prim, -1, -1) - prim
        dvm = prim - torch.roll(prim, 1, -1)
        eta = ((dvm * dvm + dvp * dvp)
               / PORT.schemes.limo3_rdx2(mesh.dx1))[..., 1:-1]
        e = PORT.schemes.limo3_eps(dtype)
        below = int((eta <= 1.0 - e).sum())
        above = int((eta >= 1.0 + e).sum())
        blend = eta.numel() - below - above
        err = max_rel_err(got, ref)
        log(f"  LimO3 switch, 1-D 4096 {str(dtype)[6:]}: eta <= 1 - eps in "
            f"{below} cells, >= 1 + eps in {above}, in the blend in {blend}; "
            f"max rel err {err:.3e}")
        check("#4 1-D 4096, LimO3 switch", f"LimO3 switch {str(dtype)[6:]}",
              err, tol,
              bool(torch.isfinite(got).all()) and min(below, above,
                                                      blend) > 0)
    for route, err in worst.items():
        log(f"  {route}: worst max rel err over its new cases {err:.3e}")
    log(f"  {n_checks} checks ({len(cases)} new cases x 2 dtypes on each "
        f"route), {len(failed)} failed")
    if failed:
        raise AssertionError(f"kernel disagrees with plain: {failed[:10]}")
    return worst


def run_sim(sim):
    """``sim.run()`` with the launch counts set to 0 just before and read
    just after; returns ``(sweep launches, stage launches, zone-cycles per
    second or None)`` and echoes what the run printed."""
    out = io.StringIO()
    torch.cuda.synchronize()
    reset_counts()
    with contextlib.redirect_stdout(out):
        sim.run()
    counts = read_counts()
    text = out.getvalue()
    print(text, end="", flush=True)
    m = re.search(r"zone-cycles/wallsecond = (\S+)", text)
    return counts + (float(m.group(1)) if m else None,)


def phase_main_deck(rung, n, ncycles, warmup):
    log(f"== phase 4: main deck on the {rung} rung ({n}^3, f32, {ncycles} "
        f"cycles, {warmup} warm-up) ==")
    t0 = time.time()
    sim = make_sim(BENCH_DECK.format(n=n, ncycles=ncycles, warmup=warmup,
                                     precision="single"), rung)
    u0 = sim.u.clone()
    log(f"  set-up {time.time() - t0:.2f} s: mesh {sim.mesh.nx1}x"
        f"{sim.mesh.nx2}x{sim.mesh.nx3}, blocks {sim.mesh.nblocks}, "
        f"nghost {sim.mesh.nghost}, dtype {sim.u.dtype}, "
        f"device {sim.u.device}")
    n_sweep, n_stage, zcps = run_sim(sim)
    n_eos = eos_launches()
    if zcps is None:
        raise AssertionError("main path printed no zone-cycles line")
    want = tuple(k * ncycles for k in RUNG_LAUNCHES[rung])
    want_eos = RUNG_EOS_LAUNCHES[rung] * ncycles + 1
    log(f"  launches: sweep kernel {n_sweep}, stage kernel {n_stage} "
        f"(expected {want[0]} and {want[1]}: {RUNG_LAUNCHES[rung]} per "
        f"cycle); EOS kernel {n_eos} (expected {want_eos}: "
        f"{RUNG_EOS_LAUNCHES[rung]} per cycle and the initial dt)")
    if sim.ncycle != ncycles or (n_sweep, n_stage) != want \
            or n_eos != want_eos:
        raise AssertionError(f"{rung} rung ran {sim.ncycle} cycles, "
                             f"{n_sweep} sweep, {n_stage} stage and {n_eos} "
                             f"EOS launches")
    if not bool(torch.isfinite(sim.u).all()):
        raise AssertionError("main path state is not finite")
    # a 1e-6 linear wave stays a 1e-6 perturbation of the background
    drift = (sim.u - u0).abs().max().item()
    log(f"  state finite; max |u - u(t=0)| = {drift:.3e} at t = {sim.t:.6e}")
    if drift > 1e-5:
        raise AssertionError(f"linear wave left the linear regime: {drift}")
    return sim, (n_sweep, n_stage, n_eos), zcps


def phase_orszag_tang(n, ncycles, warmup):
    log(f"== phase 4: Orszag-Tang vortex ({n}^2, f32, {ncycles} cycles, "
        f"{warmup} warm-up) ==")
    sim = make_sim(OT_DECK.format(n=n, ncycles=ncycles, warmup=warmup,
                                  precision="single"))
    log(f"  mesh {sim.mesh.nx1}x{sim.mesh.nx2}x{sim.mesh.nx3}, blocks "
        f"{sim.mesh.nblocks}, nghost {sim.mesh.nghost}, dtype {sim.u.dtype}")
    mass0 = sim.u[:, 0].double().mean().item()
    n_sweep, n_stage, zcps = run_sim(sim)
    want = 2 * 2 * ncycles
    log(f"  launches: sweep kernel {n_sweep} (expected 2 stages x 2 "
        f"directions x {ncycles} cycles = {want}), stage kernel {n_stage}")
    if sim.ncycle != ncycles or (n_sweep, n_stage) != (want, 0) \
            or zcps is None:
        raise AssertionError(f"vortex ran {sim.ncycle} cycles and {n_sweep} "
                             f"sweep launches")
    mass = sim.u[:, 0].double().mean().item()
    log(f"  mean density {mass:.9f} (start {mass0:.9f}, exact "
        f"{25.0 / (36.0 * np.pi):.9f})")
    if not bool(torch.isfinite(sim.u).all()) \
            or abs(mass - mass0) > 1e-5 * mass0:
        raise AssertionError("vortex state not finite or mass not conserved")
    return sim, n_sweep, zcps


def phase_sod(n):
    log(f"== phase 4: Sod shock tube (1-D Euler, HLLC + PLM, {n} cells, "
        f"f64) to tlim ==")
    sim = make_sim(SOD_DECK.format(n=n, ncycles=-1))
    n_sweep, n_stage, _ = run_sim(sim)
    want = 2 * sim.ncycle
    g = sim.mesh.nghost
    x = sim.mesh.cell_centers_mesh()[0].reshape(-1)[g:-g]
    rho = sim.cons()[sim.mesh.interior_slices][0, 0, 0, 0]
    exact = PORT.exact_riemann.sample((x - 0.5) / sim.t, 1.0, 0.0, 1.0, 0.125,
                                      0.0, 0.1, 1.4)[0]
    l1 = float(np.abs(rho - exact).mean())
    log(f"  {sim.ncycle} cycles to t = {sim.t:.6f}; sweep launches "
        f"{n_sweep} (expected 2 stages x 1 direction x {sim.ncycle} = "
        f"{want}); L1(rho) against the exact solution {l1:.4e} "
        f"(tol {SOD_L1_TOL:.0e})")
    if (n_sweep, n_stage) != (want, 0) or abs(sim.t - 0.25) > 1e-12 \
            or not l1 <= SOD_L1_TOL:
        raise AssertionError("Sod run failed")
    # the sweep kernel against plain at this path's own inputs: the final
    # state, on the ghosted block (its extent leaves a remainder tile that
    # no other phase has)
    sweep = PORT.sweep
    mesh, cfg, eos = sim.mesh, sim.cfg, sim.eos
    sl = mesh.interior_slices
    _, prim = sim.pkg.cons_to_prim(sim.u)
    for recon in ("dc", cfg.reconstruction):
        got = sweep.negdiv_cuda(prim, 0.0, mesh, cfg, eos, recon)
        ref = sweep.negdiv_plain(prim, 0.0, mesh, cfg, eos, recon)
        torch.cuda.synchronize()
        rel = max_rel_err(got[sl], ref[sl])
        log(f"  {recon}: kernel against plain at the final state, block of "
            f"{prim.shape[-1]} cells: max rel err {rel:.3e} (tol "
            f"{F64_TOL:.0e}, per variable)")
        if not (rel <= F64_TOL and bool(torch.isfinite(got[sl]).all())):
            raise AssertionError(f"kernel disagrees with plain at Sod's "
                                 f"inputs ({recon}): {rel:.3e}")
    return n_sweep, sim.ncycle


def perf_deck(fluid, integ, recon, riemann, n, ncycles, warmup, precision):
    pid = "linear_wave_mhd" if fluid == "glmmhd" else "linear_wave"
    return PERF_DECK.format(pid=pid, fluid=fluid, integ=integ, recon=recon,
                            riemann=riemann, n=n, ncycles=ncycles,
                            warmup=warmup, precision=precision)


def phase_perf_matrix(n, ncycles, warmup):
    """Path E: each combination of ``PERF_MATRIX`` through ``Simulation``
    on the sweep rung (3 sweep launches per stage), and the last on the
    whole-stage rung (E', one stage launch per stage); the launch counts
    set to 0 just before each run and read just after."""
    runs = {}
    todo = [(c, "sweep") for c in PERF_MATRIX] + [(PERF_MATRIX[-1], "stage")]
    for combo, rung in todo:
        fluid, integ, recon, riemann = combo
        name = "-".join(combo) + ("" if rung == "sweep" else " (stage rung)")
        log(f"== phase 4: path E, {name} ({n}^3, f32, {ncycles} cycles, "
            f"{warmup} warm-up) ==")
        t0 = time.time()
        sim = make_sim(perf_deck(fluid, integ, recon, riemann, n, ncycles,
                                 warmup, "single"), rung)
        u0 = sim.u.clone()
        setup = time.time() - t0
        n_sweep, n_stage, zcps = run_sim(sim)
        k = NSTAGES[integ] * ncycles
        want = (3 * k, 0) if rung == "sweep" else (0, k)
        drift = (sim.u - u0).abs().max().item()
        del u0
        log(f"  set-up {setup:.2f} s; launches: sweep kernel {n_sweep}, "
            f"stage kernel {n_stage} (expected {want[0]} and {want[1]}); "
            f"zone-cycles/wallsecond {zcps}; max |u - u(t=0)| {drift:.3e}")
        if sim.ncycle != ncycles or (n_sweep, n_stage) != want \
                or zcps is None or not bool(torch.isfinite(sim.u).all()) \
                or drift > 1e-5:
            raise AssertionError(f"path E {name}: {sim.ncycle} cycles, "
                                 f"launches {(n_sweep, n_stage)}, drift "
                                 f"{drift}")
        runs[name] = dict(sim=sim, combo=combo, rung=rung,
                          launches=n_sweep + n_stage, zcps=zcps,
                          cycles=ncycles)
    return runs


def phase_fofc_path(n, ncycles, warmup):
    """Path F: the FOFC blast through ``Simulation`` at ``n``^3 f32 on the
    default rung (the sweep kernel and, on a stage whose candidate has a
    bad cell, the rescue's plain operations on the card), then on path B's
    refined mesh through ``SmrSimulation`` (the negdiv-faces rung, which
    FOFC selects); each prints the stages that took the rescue."""
    log(f"== phase 4: path F, the FOFC blast ({n}^3, f32, Euler HLLC + LimO3 "
        f"+ RK2, {ncycles} cycles, {warmup} warm-up) ==")
    sim = make_sim(fofc_deck(n, ncycles, "single", warmup=warmup), "stage")
    m0 = sim.u[:, 0].double().sum().item()
    n_sweep, n_stage, zcps = run_sim(sim)
    rescues = sim.pkg.fofc_rescues
    _, w = sim.pkg.cons_to_prim(sim.u)
    rho_min, p_min = w[:, 0].min().item(), w[:, 4].min().item()
    drift = abs(sim.u[:, 0].double().sum().item() - m0) / m0
    want = 3 * 2 * ncycles
    log(f"  (asked for the stage rung: FOFC keeps the sweep) launches: "
        f"sweep kernel {n_sweep} (expected {want}), stage kernel {n_stage}; "
        f"stages rescued {rescues} of {2 * ncycles}; min rho {rho_min:.3e}, "
        f"min p {p_min:.3e}; mass drift {drift:.3e} (f32 sums); "
        f"zone-cycles/wallsecond {zcps}")
    if sim.ncycle != ncycles or (n_sweep, n_stage) != (want, 0) \
            or rescues < 1 or zcps is None or not rho_min > 0 \
            or not p_min > 0 or not drift <= 1e-5:
        raise AssertionError(f"path F: {sim.ncycle} cycles, launches "
                             f"{(n_sweep, n_stage)}, {rescues} rescues")
    uniform = dict(sim=sim, launches=n_sweep, zcps=zcps, rescues=rescues,
                   stages=2 * ncycles, cycles=ncycles)

    nb = n // 2
    log(f"== phase 4: path F on path B's refined mesh ({nb}^3 base, 32^3 "
        f"blocks, level-1 centre, f32, {ncycles} cycles, {warmup} warm-up) "
        f"==")
    smr = make_smr_sim(fofc_deck(nb, warmup, "single", refined=True, mb=32),
                       "stage")
    st = smr._stepper_now()
    sm = smr._smesh_now()
    leaves = {lev: int(ids.size) for lev, ids in sm.level_ids.items()}
    m0 = smr.total_mass()
    counts, zcps_r = run_smr(smr, ncycles, warmup)
    st = smr._stepper_now()
    drift = abs(smr.total_mass() - m0) / m0
    want = 3 * 2 * len(leaves) * ncycles
    log(f"  leaves {leaves}; stage rung taken: {st._stage_rung}; launches: "
        f"negdiv-faces kernel {counts[1]} (expected {want}), stage-faces "
        f"{counts[0]}; level stages rescued {st.fofc_rescues} of "
        f"{2 * len(leaves) * ncycles}; mass drift across levels {drift:.3e}; "
        f"zone-cycles/wallsecond {zcps_r}")
    finite = all(bool(torch.isfinite(v).all()) for v in smr.state.values())
    if smr.ncycle != ncycles or counts[:2] != (0, want) or st._stage_rung \
            or st.fofc_rescues < 1 or zcps_r is None or not finite \
            or not drift <= 1e-5:
        raise AssertionError(f"path F refined: {smr.ncycle} cycles, launches "
                             f"{counts}, {st.fofc_rescues} rescues")
    refined = dict(sim=smr, launches=counts[1], zcps=zcps_r,
                   rescues=st.fofc_rescues,
                   stages=2 * len(leaves) * ncycles, cycles=ncycles,
                   leaves=leaves)
    return uniform, refined


def phase_fofc_whole_steps():
    """Path F's decks in f64 for 5 cycles through the kernels and with
    their plain versions forced (no noise: kernel and plain round alike
    on the blast's ties): the same stages rescued, at least one, and the
    state and every dt to STEP_TOL; mass across levels kept."""
    log("== phase 5: path F, kernels against plain over whole steps (f64, 5 "
        "cycles) ==")
    sweep, eos = PORT.sweep, PORT.adiabatic_cuda
    cases = [("FOFC blast 64^3", fofc_deck(64, 5, "double"), False),
             ("FOFC blast, refined, 32^3 base", fofc_deck(
                 32, 5, "double", refined=True, mb=8), True)]
    hst_block = "\n<parthenon/output9>\nfile_type = hst\n"
    for label, deck, refined in cases:
        runs = {}
        for name in ("kernel", "plain"):
            outdir = ROOT / "build" / "chip_smoke" / f"fofc_{name}"
            outdir.mkdir(parents=True, exist_ok=True)
            for old in outdir.glob("*.hst"):
                old.unlink()
            cwd = os.getcwd()
            dispatch = (sweep.fused_negdiv, sweep.fused_negdiv_faces,
                        eos.fused_cons_to_prim)
            os.chdir(outdir)
            try:
                sim = make_smr_sim(deck + hst_block, "stage") if refined \
                    else make_sim(deck + hst_block)
                sim.quiet = True
                m0 = sim.total_mass() if refined else None
                if name == "plain":
                    sweep.fused_negdiv = sweep.negdiv_plain
                    sweep.fused_negdiv_faces = sweep.negdiv_faces_plain
                    eos.fused_cons_to_prim = PORT.adiabatic.cons_to_prim
                reset_counts()
                with contextlib.redirect_stdout(io.StringIO()):
                    sim.run()
                counts = read_counts() + read_face_counts() \
                    + (eos_launches(),)
            finally:
                sweep.fused_negdiv, sweep.fused_negdiv_faces, \
                    eos.fused_cons_to_prim = dispatch
                os.chdir(cwd)
            if (sum(counts) == 0) != (name == "plain"):
                raise AssertionError(f"{label}: {name} run launched {counts}")
            if refined:
                state = {lev: v.cpu().numpy() for lev, v in sim.state.items()}
                rescues = sim._stepper_now().fofc_rescues
                drift = abs(sim.total_mass() - m0) / m0
            else:
                state = {0: sim.u.cpu().numpy()}
                rescues = sim.pkg.fofc_rescues
                drift = 0.0
            runs[name] = (state, np.loadtxt(next(outdir.glob("*.hst"))),
                          rescues, drift)
        (uk, hk, rk, dk), (up, hp, rp, dp) = runs["kernel"], runs["plain"]
        err_u = max(float(np.abs(uk[lev] - up[lev]).max()
                          / np.abs(up[lev]).max()) for lev in up)
        err_dt = float(np.abs(hk[:, 1] - hp[:, 1]).max()
                       / np.abs(hp[:, 1]).max())
        log(f"  {label:32s} state max rel err {err_u:.3e}, dt max rel err "
            f"{err_dt:.3e} (tol {STEP_TOL:.0e}); stages rescued: kernels "
            f"{rk}, plain {rp}; mass drift kernels {dk:.3e}, plain {dp:.3e}")
        if not (err_u <= STEP_TOL and err_dt <= STEP_TOL and rk == rp >= 1
                and hk.shape == hp.shape and dk <= 1e-13):
            raise AssertionError(f"{label}: kernel and plain FOFC steps "
                                 f"disagree or took no rescue")


def phase_whole_steps(seed):
    log("== phase 5: kernels against plain over whole steps (f64, 5 "
        "cycles) ==")
    sweep, stage, eos = PORT.sweep, PORT.stage, PORT.adiabatic_cuda
    hst_block = "\n<parthenon/output1>\nfile_type = hst\n"
    cases = [(f"main deck 32^3, {rung} rung", rung, BENCH_DECK.format(
                  n=32, ncycles=5, warmup=0, precision="double"))
             for rung in RUNGS]
    cases += [("Orszag-Tang 64^2", "sweep", OT_DECK.format(
                   n=64, ncycles=5, warmup=0, precision="double")),
              ("Sod 256", "sweep", SOD_DECK.format(n=256, ncycles=5))]
    for label, rung, deck in cases:
        runs = {}
        for name in ("kernel", "plain"):
            outdir = ROOT / "build" / "chip_smoke" / name
            outdir.mkdir(parents=True, exist_ok=True)
            for old in outdir.glob("*.hst"):
                old.unlink()
            sim = make_sim(deck + hst_block, rung)
            if "Orszag" in label:
                # the vortex's exactly symmetric state sits on ties of the
                # solvers' selects, where rounding alone decides: seeded
                # noise takes it off them
                rng = np.random.default_rng(seed)
                sim.u *= torch.tensor(
                    1.0 + 1e-3 * rng.standard_normal(tuple(sim.u.shape)),
                    device=sim.u.device)
            cwd = os.getcwd()
            dispatch = (sweep.fused_negdiv, stage.fused_stage,
                        eos.fused_cons_to_prim)
            os.chdir(outdir)
            try:
                if name == "plain":
                    # the package reaches its kernels through these names
                    sweep.fused_negdiv = sweep.negdiv_plain
                    stage.fused_stage = stage.stage_plain
                    eos.fused_cons_to_prim = PORT.adiabatic.cons_to_prim
                reset_counts()
                with contextlib.redirect_stdout(io.StringIO()):
                    sim.run()
                counts = read_counts() + (eos_launches(),)
            finally:
                sweep.fused_negdiv, stage.fused_stage, \
                    eos.fused_cons_to_prim = dispatch
                os.chdir(cwd)
            if (sum(counts) == 0) != (name == "plain"):
                raise AssertionError(f"{label}: {name} run launched {counts}")
            runs[name] = (sim.u.double().cpu().numpy(),
                          np.loadtxt(next(outdir.glob("*.hst"))))
        (uk, hk), (up, hp) = runs["kernel"], runs["plain"]
        err_u = float(np.abs(uk - up).max() / np.abs(up).max())
        err_dt = float(np.abs(hk[:, 1] - hp[:, 1]).max()
                       / np.abs(hp[:, 1]).max())
        log(f"  {label:28s} state max rel err {err_u:.3e}, dt max rel err "
            f"{err_dt:.3e} over {hk.shape[0] - 2} cycles (tol "
            f"{STEP_TOL:.0e})")
        if not (err_u <= STEP_TOL and err_dt <= STEP_TOL
                and hk.shape == hp.shape):
            raise AssertionError(f"{label}: kernel and plain steps disagree")


def symmetry_noise(state, seed):
    """``{level: tensor}`` times (1 + 1e-3 noise), plus 1e-3 noise on the
    momenta, made with numpy from ``seed``: the blast decks are exactly
    symmetric at rest, where the solvers' selects sit on ties that rounding
    alone decides (as for the vortex above)."""
    rng = np.random.default_rng(seed)
    out = {}
    for lev in sorted(state):
        v = state[lev].double().cpu().numpy()
        v = v * (1.0 + 1e-3 * rng.standard_normal(v.shape))
        v[:, 1:4] += 1e-3 * rng.standard_normal(v[:, 1:4].shape)
        out[lev] = v
    return out


def smr_deck(path, n, ncycles, precision):
    mb = 32 if path != "C" else 128
    template = SMR_3D_DECK if SMR_PATHS[path][0] == "3d" else SMR_2D_DECK
    return template.format(n=n, mb=mb, ncycles=ncycles, precision=precision)


def run_smr(sim, ncycles, warmup):
    """The bench protocol of ``bench.py:run_bench_smr``: ``warmup`` cycles,
    then the rest to ``ncycles``, whose printed rate is the one kept; the
    face-kernel counts are set to 0 just before the first and read just
    after the second.  Returns ``(counts, zone-cycles per second)``."""
    out = io.StringIO()
    torch.cuda.synchronize()
    reset_counts()
    with contextlib.redirect_stdout(out):
        sim.nlim = warmup
        sim.run()
        sim.nlim = ncycles
        sim.run()
    counts = read_face_counts() + read_counts()
    text = out.getvalue()
    print(text, end="", flush=True)
    rates = re.findall(r"zone-cycles/wallsecond = (\S+)", text)
    return counts, float(rates[-1]) if len(rates) == 2 else None


def phase_smr_path(path, n, ncycles, warmup):
    dims, rung, want = SMR_PATHS[path]
    log(f"== phase 4: refined-mesh path {path} ({dims} {n}^{dims[0]} base, "
        f"{rung} rung, f32, {ncycles} cycles, {warmup} warm-up) ==")
    t0 = time.time()
    sim = make_smr_sim(smr_deck(path, n, warmup, "single"), rung)
    sm = sim._smesh_now()
    leaves = {lev: int(ids.size) for lev, ids in sm.level_ids.items()}
    zones = sum(leaves.values()) * sm.base.mbnx1 * sm.base.mbnx2 \
        * sm.base.mbnx3
    log(f"  set-up {time.time() - t0:.2f} s: leaves {leaves}, "
        f"{zones} zones per cycle, blocks of {sm.base.block_shape}, "
        f"dtype {sim.dtype}, device {sim.device}")
    m0 = sim.total_mass()
    (n_stage_f, n_negdiv_f, n_sweep, n_stage), zcps = run_smr(
        sim, ncycles, warmup)
    expect = tuple(k * ncycles for k in want)
    log(f"  launches: stage-faces kernel {n_stage_f}, negdiv-faces kernel "
        f"{n_negdiv_f} (expected {expect[0]} and {expect[1]}: {want} per "
        f"cycle); uniform-path wrappers {n_sweep} and {n_stage}")
    if sim.ncycle != ncycles or (n_stage_f, n_negdiv_f) != expect \
            or (n_sweep, n_stage) != (0, 0) or zcps is None:
        raise AssertionError(f"path {path} ran {sim.ncycle} cycles with "
                             f"launches {(n_stage_f, n_negdiv_f)}")
    finite = all(bool(torch.isfinite(v).all()) for v in sim.state.values())
    drift = abs(sim.total_mass() - m0) / m0
    log(f"  state finite: {finite}; mass drift across levels {drift:.3e} "
        f"(f32 sums over {zones} cells; gate 1e-5) at t = {sim.t:.6e}")
    if not finite or not drift <= 1e-5:
        raise AssertionError(f"path {path}: state not finite or mass lost")
    return sim, (n_stage_f, n_negdiv_f), zcps


def face_err(got, ref):
    """max |kernel - plain| over max |plain| of each variable of a face
    slab [nb, nvar, A, B, 2]."""
    dims = [0, 2, 3, 4]
    top, scale = (got - ref).abs().amax(dim=dims), ref.abs().amax(dim=dims)
    return torch.where(scale > 0, top / scale,
                       torch.where(top > 0, torch.inf, 0.0)).max().item()


def smr_stage_calls(sim):
    """What one stage-rung cycle of ``sim`` hands the stage-faces function:
    per level, with VL2 the DC predictor ``(u, u)`` and the full-order
    corrector ``(u_half, u)``, with ``u_half`` the filled predictor result
    of this very state; with another integrator its first stage ``(u,
    u)``."""
    st = sim._stepper_now()
    dt_raw, dt, c_h = sim._dt_pack().tolist()
    recon = sim.cfg.reconstruction
    calls = []
    if sim.cfg.integrator != "vl2":
        for lev, u in sim.state.items():
            calls.append((f"level {lev} {recon}", (
                u, u, 0.0, 1.0, dt, c_h, st.level_mesh[lev], sim.cfg,
                sim.eos, recon)))
        return calls
    half = st.fill_ghosts(st._stage_impl(0, sim.state, sim.state, dt, c_h))
    for lev, u in sim.state.items():
        lm = st.level_mesh[lev]
        calls.append((f"level {lev} dc", (u, u, 0.0, 1.0, 0.5 * dt, c_h, lm,
                                          sim.cfg, sim.eos, "dc")))
        calls.append((f"level {lev} {recon}", (half[lev], u, 0.0, 1.0, dt,
                                               c_h, lm, sim.cfg, sim.eos,
                                               recon)))
    return calls


def smr_negdiv_calls(sim):
    """What one negdiv-rung cycle of ``sim`` hands the negdiv-faces
    function: per level, prim of the state with the deck's reconstruction
    (and with DC first, VL2's predictor)."""
    st = sim._stepper_now()
    _, _, c_h = sim._dt_pack().tolist()
    recons = (("dc",) if sim.cfg.integrator == "vl2" else ()) \
        + (sim.cfg.reconstruction,)
    calls = []
    for lev, u in sim.state.items():
        _, prim = PORT.cons_to_prim(sim.eos, u, sim.cfg.fluid,
                                    sim.cfg.nscalars)
        for recon in recons:
            calls.append((f"level {lev} {recon}", (
                prim, c_h, st.level_mesh[lev], sim.cfg, sim.eos, recon)))
    return calls


def phase_smr_kernels_vs_plain(sim, path, kind):
    """Each face kernel against its plain twin at the path's own level
    arrays: f32 as the path runs, and the same arrays in f64.  With
    passive scalars the fluid rows and the scalar rows are held apart,
    and the scalar kernel must launch once per fluid launch."""
    log(f"== phase 3: the {kind} kernel against plain at path {path}'s level "
        f"arrays ==")
    stage, sweep = PORT.stage, PORT.sweep
    failed = []
    calls = smr_stage_calls(sim) if kind == "stage-faces" \
        else smr_negdiv_calls(sim)
    nb0 = sweep.scalar_base(sim.cfg)
    parts = {"": slice(None)} if sim.cfg.nscalars == 0 else {
        "fluid ": slice(0, nb0), "scalars ": slice(nb0, None)}
    for dtype, tol in TOLS[::-1]:
        for label, args in calls:
            args = tuple(a.to(dtype) if torch.is_tensor(a) else a
                         for a in args)
            lm = args[6] if kind == "stage-faces" else args[2]
            sl = lm.interior_slices
            before = (sweep.negdiv_scalars_cuda.launches,
                      stage.stage_scalars_cuda.launches)
            if kind == "stage-faces":
                got = stage.stage_faces_cuda(*args)
                torch.cuda.synchronize()
                ref = stage.stage_faces_plain(*args)
                g_out, r_out, g_f, r_f = got[0], ref[0], got[2], ref[2]
            else:
                g_out, g_f = sweep.negdiv_faces_cuda(*args)
                torch.cuda.synchronize()
                r_out, r_f = sweep.negdiv_faces_plain(*args)
            launched = (sweep.negdiv_scalars_cuda.launches - before[0]) \
                + (stage.stage_scalars_cuda.launches - before[1])
            want = 0 if sim.cfg.nscalars == 0 else (
                1 if kind == "stage-faces" else len(r_f))
            errs = {name: (max_rel_err(g_out[sl][:, p], r_out[sl][:, p]),
                           max(face_err(g_f[d][:, p], r_f[d][:, p])
                               for d in r_f))
                    for name, p in parts.items()}
            finite = bool(torch.isfinite(g_out[sl]).all()) and all(
                bool(torch.isfinite(f).all()) for f in g_f.values())
            ok = max(max(e) for e in errs.values()) <= tol and finite \
                and sorted(g_f) == sorted(r_f) and launched == want
            rows = ", ".join(f"{name}{e_out:.3e} (state), {e_f:.3e} (slabs)"
                             for name, (e_out, e_f) in errs.items())
            log(f"  {kind} path {path} {label} {str(dtype)[6:]}: max rel err "
                f"{rows} (tol {tol:.0e} per variable); scalar-kernel "
                f"launches {launched} (want {want}) {'ok' if ok else 'FAIL'}")
            if not ok:
                failed.append(f"{label} {dtype}")
            del g_out, r_out, g_f, r_f
        torch.cuda.empty_cache()
    if failed:
        raise AssertionError(f"{kind} kernel disagrees with plain at path "
                             f"{path}: {failed}")


def phase_smr_whole_steps(seed):
    log("== phase 5: refined meshes, kernels against plain over whole steps "
        "(f64, 5 cycles) ==")
    stage, sweep = PORT.stage, PORT.sweep
    blast = (ROOT / "inputs" / "blast_3d_smr.in").read_text().replace(
        "nlim = 10000", "nlim = 5").replace("dt = 0.01", "dt = -1.0")
    cases = [("blast_3d_smr.in, stage rung", blast, "stage"),
             ("blast_3d_smr.in, negdiv rung", blast, "negdiv"),
             ("2-D blast 256^2", SMR_2D_DECK.format(
                 n=256, mb=32, ncycles=5, precision="double")
              + "\n<parthenon/output0>\nfile_type = hst\n", "negdiv")]
    drift_worst = 0.0
    for label, deck, rung in cases:
        runs = {}
        for name in ("kernel", "plain"):
            outdir = ROOT / "build" / "chip_smoke" / f"smr_{name}"
            outdir.mkdir(parents=True, exist_ok=True)
            for old in outdir.glob("*.hst"):
                old.unlink()
            cwd = os.getcwd()
            dispatch = (sweep.fused_negdiv_faces, stage.fused_stage_faces)
            os.chdir(outdir)
            try:
                sim = make_smr_sim(deck, rung)
                sim.quiet = True
                sim.load_state(symmetry_noise(sim.state, seed), 0.0, 0)
                m0 = sim.total_mass()
                if name == "plain":
                    # the stepper reaches its kernels through these names
                    sweep.fused_negdiv_faces = sweep.negdiv_faces_plain
                    stage.fused_stage_faces = stage.stage_faces_plain
                reset_counts()
                sim.run()
                counts = read_face_counts()
            finally:
                sweep.fused_negdiv_faces, stage.fused_stage_faces = dispatch
                os.chdir(cwd)
            if (sum(counts) == 0) != (name == "plain"):
                raise AssertionError(f"{label}: {name} run launched {counts}")
            drift = abs(sim.total_mass() - m0) / m0
            runs[name] = ({lev: v.cpu().numpy() for lev, v in
                           sim.state.items()},
                          np.loadtxt(next(outdir.glob("*.hst"))), drift)
        (uk, hk, dk), (up, hp, dp) = runs["kernel"], runs["plain"]
        err_u = max(float(np.abs(uk[lev] - up[lev]).max()
                          / np.abs(up[lev]).max()) for lev in up)
        err_dt = float(np.abs(hk[:, 1] - hp[:, 1]).max()
                       / np.abs(hp[:, 1]).max())
        same_dt = bool(np.array_equal(hk[:, 1], hp[:, 1]))
        drift_worst = max(drift_worst, dk)
        log(f"  {label:30s} state max rel err {err_u:.3e}, dt max rel err "
            f"{err_dt:.3e} (identical: {same_dt}) over {hk.shape[0] - 1} "
            f"cycles (tol {STEP_TOL:.0e}); mass drift across levels, "
            f"kernels {dk:.3e}, plain {dp:.3e} (tol 1e-13)")
        if not (err_u <= STEP_TOL and err_dt <= STEP_TOL
                and hk.shape == hp.shape and dk <= 1e-13):
            raise AssertionError(f"{label}: kernel and plain steps disagree "
                                 f"or mass drifts")
    return drift_worst


def leaves_of(sim):
    return {lev: int(ids.size)
            for lev, ids in sorted(sim._smesh_now().level_ids.items())}


def table_of(sim):
    sm = sim._smesh_now()
    return tuple(np.asarray(x).copy() for x in (sm.levels, sm.lx1, sm.lx2,
                                                sm.lx3))


def remesh_kinds(old, new):
    """'refine' / 'derefine' for the leaves of table ``new`` that ``old``
    lacks: made from their parent, or from their children."""
    have = set(zip(*(x.tolist() for x in old)))
    out = set()
    for lev, a, b, c in zip(*(x.tolist() for x in new)):
        if (lev, a, b, c) not in have:
            out.add("refine" if (lev - 1, a // 2, b // 2, c // 2) in have
                    else "derefine")
    return out


def phase_amr_path(path, ncycles, warmup):
    rung, n, per_level = AMR_PATHS[path]
    log(f"== phase 4: adaptive path {path} (the run_bench_adaptive deck, "
        f"{n}^3 base, 16^3 blocks, {rung} rung, f32, {warmup} warm-up + "
        f"{ncycles - warmup} timed cycles) ==")
    t0 = time.time()
    sim = make_smr_sim(ADAPTIVE_3D_DECK.format(
        n=n, mb=16, ncycles=warmup, precision="single"), rung)
    drv = sim.driver
    n_init = len(drv.remesh_log)
    leaves0 = leaves_of(sim)
    m0 = sim.total_mass()
    log(f"  set-up {time.time() - t0:.2f} s (initial refinement: {n_init} "
        f"remeshes): leaves {leaves0}, blocks of "
        f"{sim._smesh_now().base.block_shape}, dtype {sim.dtype}, device "
        f"{sim.device}")
    out = io.StringIO()
    torch.cuda.synchronize()
    reset_counts()
    with contextlib.redirect_stdout(out):
        sim.run()
        n_warm, warm_remeshes = len(drv.remesh_log), sim.perf_remeshes
        sim.nlim = ncycles
        sim.run()
    counts = read_face_counts() + read_counts()
    text = out.getvalue()
    print(text, end="", flush=True)
    rates = re.findall(r"zone-cycles/wallsecond = (\S+)", text)
    # the leaves each cycle stepped on, from its cycle line
    nlev = [len(m.group(1).split(",")) for m in
            re.finditer(r"cycle=\d+ .*blocks=\{([^}]*)\}", text)]
    want = per_level * sum(nlev)
    face, other = (counts[0], counts[1]) if rung == "stage" \
        else (counts[1], counts[0])
    changed_run = sum(e["changed"] for e in drv.remesh_log[n_init:])
    window = drv.remesh_log[n_warm:]
    zcps = float(rates[-1]) if len(rates) == 2 else None
    log(f"  launches: {'stage' if rung == 'stage' else 'negdiv'}-faces "
        f"kernel {face} (expected {want}: {per_level} per level and cycle "
        f"over {len(nlev)} cycles), {face / ncycles:.2f} per cycle; the "
        f"other face kernel {other}, uniform-path wrappers {counts[2:]}")
    log(f"  remeshes that changed the leaf table: {sim.perf_remeshes} in the "
        f"{ncycles - warmup}-cycle window, {changed_run} over the whole run "
        f"after the initial refinement ({warm_remeshes} in the warm-up); "
        f"{len(window)} remeshes in the window in all; leaves at the start "
        f"{leaves0}, at the end {leaves_of(sim)}; steppers cached "
        f"{len(drv._steppers)}")
    log(f"  zone-cycles/wallsecond over the window: {zcps}")
    if sim.ncycle != ncycles or len(nlev) != ncycles or face != want \
            or other != 0 or counts[2:] != (0, 0) or zcps is None:
        raise AssertionError(f"path {path} ran {sim.ncycle} cycles with "
                             f"launches {counts}, expected {want}")
    if changed_run == 0:
        raise AssertionError(f"path {path}: no remesh after the initial "
                             f"refinement in {ncycles} cycles")
    finite = all(bool(torch.isfinite(v).all()) for v in sim.state.values())
    m1 = sim.total_mass()
    drift = abs(m1 - m0) / m0
    log(f"  state finite: {finite}; mass across levels {m0:.9e} at the "
        f"start, {m1:.9e} at the end (f32; drift {drift:.3e}, gate 1e-5) at "
        f"t = {sim.t:.6e}")
    if not finite or not drift <= 1e-5:
        raise AssertionError(f"path {path}: state not finite or mass lost")
    return sim, face, dict(
        zone_cycles_per_s=zcps, cycles_timed=ncycles - warmup,
        remeshes_window=sim.perf_remeshes, remeshes_run=changed_run,
        remesh_checks_window=len(window), leaves_start=leaves0,
        leaves_end=leaves_of(sim), launches=face,
        launches_per_cycle=face / ncycles,
        steppers_cached=len(drv._steppers), mass_start=m0, mass_end=m1)


def phase_amr_whole_steps(seed):
    """Adaptive runs in f64 through the kernels and with the plain versions
    forced, side by side cycle by cycle: leaf tables equal, state and every
    step to STEP_TOL; each run refines and derefines; mass kept to 1e-13.
    Returns the 2-D run's sweep-faces launches."""
    log("== phase 5: adaptive meshes, kernels against plain over whole "
        "steps (f64, 5 cycles, derefine_count = 1, check_interval = 1) ==")
    stage, sweep = PORT.stage, PORT.sweep
    every = ("refinement = adaptive\nderefine_count = 1\n"
             "check_interval = 1")
    blast = (ROOT / "inputs" / "blast_3d_adaptive.in").read_text().replace(
        "nlim = 10000", "nlim = 5").replace("dt = 0.01", "dt = -1.0") \
        .replace("refinement = adaptive", every)
    flat = ADAPTIVE_2D_DECK.format(n=256, mb=32, ncycles=5,
                                   precision="double").replace(
        "refinement = adaptive", every)
    cases = [("blast_3d_adaptive.in, stage rung", blast, "stage"),
             ("blast_3d_adaptive.in, negdiv rung", blast, "negdiv"),
             ("2-D adaptive blast 256^2", flat, "negdiv")]
    outdir = ROOT / "build" / "chip_smoke" / "amr"
    outdir.mkdir(parents=True, exist_ok=True)
    cwd = os.getcwd()
    launches_2d = 0
    for label, deck, rung in cases:
        os.chdir(outdir)
        try:
            sims = {name: make_smr_sim(deck, rung)
                    for name in ("kernel", "plain")}
        finally:
            os.chdir(cwd)
        start = symmetry_noise(sims["kernel"].state, seed)
        for sim in sims.values():
            sim.quiet = True
            sim.load_state(start, 0.0, 0)
        m0 = {name: sim.total_mass() for name, sim in sims.items()}
        table = table_of(sims["kernel"])
        kinds, err_u, err_dt, launches = set(), 0.0, 0.0, 0
        for k in range(1, 6):
            for name, sim in sims.items():
                dispatch = (sweep.fused_negdiv_faces, stage.fused_stage_faces)
                os.chdir(outdir)
                try:
                    if name == "plain":
                        sweep.fused_negdiv_faces = sweep.negdiv_faces_plain
                        stage.fused_stage_faces = stage.stage_faces_plain
                    sim.nlim = k
                    reset_counts()
                    sim.run()
                    counts = read_face_counts()
                finally:
                    sweep.fused_negdiv_faces, stage.fused_stage_faces = \
                        dispatch
                    os.chdir(cwd)
                if (sum(counts) == 0) != (name == "plain"):
                    raise AssertionError(f"{label}: {name} run launched "
                                         f"{counts}")
                launches += sum(counts)
            kern, plain = sims["kernel"], sims["plain"]
            new = table_of(kern)
            if any(not np.array_equal(a, b)
                   for a, b in zip(new, table_of(plain))):
                raise AssertionError(f"{label}: leaf tables differ after "
                                     f"cycle {k}")
            kinds |= remesh_kinds(table, new)
            table = new
            for lev, u in plain.state.items():
                ref = u.abs().max().item()
                err_u = max(err_u, (kern.state[lev] - u).abs().max().item()
                            / ref)
            err_dt = max(err_dt, abs(kern.tm_dt - plain.tm_dt)
                         / plain.tm_dt, abs(kern.t - plain.t) / plain.t)
        drift = {name: abs(sim.total_mass() - m0[name]) / m0[name]
                 for name, sim in sims.items()}
        log(f"  {label:34s} state max rel err {err_u:.3e}, dt and t max rel "
            f"err {err_dt:.3e} over 5 cycles (tol {STEP_TOL:.0e}); leaf "
            f"tables equal every cycle; remeshes {sorted(kinds)}, leaves at "
            f"the end {leaves_of(sims['kernel'])}; mass drift across "
            f"levels, kernels {drift['kernel']:.3e}, plain "
            f"{drift['plain']:.3e} (tol 1e-13); {launches} face launches")
        if not (err_u <= STEP_TOL and err_dt <= STEP_TOL
                and kinds == {"refine", "derefine"}
                and max(drift.values()) <= 1e-13):
            raise AssertionError(f"{label}: kernel and plain adaptive runs "
                                 f"disagree, do not remesh both ways, or "
                                 f"lose mass")
        if label.startswith("2-D"):
            launches_2d = launches
        del sims
        torch.cuda.empty_cache()
    return launches_2d


def bound_of(nbytes, ops, ms=None, f64=False):
    """The least time the card could take (ms): bytes over the memory rate,
    operations over the FP32 (or FP64) rate, the larger of the two; with
    the kernel's time ``ms`` also its share of that bound."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / (FP64_OPS_PER_S if f64 else FP32_OPS_PER_S) * 1e3
    b = dict(bound_ms=max(t_bytes, t_ops), bytes_ms=t_bytes, ops_ms=t_ops,
             bound_by="bytes" if t_bytes >= t_ops else "operations")
    if ms is not None:
        b["share_of_bound"] = b["bound_ms"] / ms
    return b


def f64_row(recon, kern, plain, inputs, ops, reps, launches):
    """An f64 row of a main-deck timing: ``kern(*x)`` and ``plain(*x)`` on
    ``inputs`` cast to f64 (each distinct tensor once), held against each
    other at the f64 tolerance, timed, with the bound at the FP64 rate from
    the bytes of this call and the ``ops`` its f32 data need."""
    cast = {}
    xs = [cast.setdefault(x.data_ptr(), x.double()) for x in inputs]
    got, ref = kern(*xs), plain(*xs)
    torch.cuda.synchronize()
    rel = max_rel_err(got, ref)
    finite = bool(torch.isfinite(got).all())
    nbytes = (len(cast) + 1) * got.numel() * 8
    del got, ref
    torch.cuda.empty_cache()
    if not (rel <= F64_TOL and finite):
        raise AssertionError(f"f64 kernel disagrees with plain ({recon}): "
                             f"{rel:.3e}")
    ms = cuda_ms(lambda: kern(*xs), reps)
    plain_ms = cuda_ms(lambda: plain(*xs), 2)
    del xs, cast
    torch.cuda.empty_cache()
    b = bound_of(nbytes, ops, ms, f64=True)
    log(f"  {recon} f64: kernel against plain max rel err {rel:.3e} (tol "
        f"{F64_TOL:.0e}); kernel {ms:.4f} ms ({launches}), plain "
        f"{plain_ms:.4f} ms; bound {b['bound_ms']:.4f} ms (bytes "
        f"{b['bytes_ms']:.4f} ms, operations {b['ops_ms']:.4f} ms at 34 "
        f"TFLOP/s); {100 * b['share_of_bound']:.2f} % of the bound")
    return dict(ms=ms, plain_ms=plain_ms, max_rel_err=rel, bytes=nbytes,
                ops=ops, **b)


def phase_sweep_timings(sim, launches, reps, name, replaces, what,
                        f64_rows=False):
    """The sweep kernel at ``sim``'s inputs: one DC and one full-order call
    (what one VL2 cycle runs), each against plain, timed, with its bound
    and its share of it; with ``f64_rows`` the same calls again on the
    inputs in f64, against the FP64 rate (the operations are those the f32
    data need: the same selects up to rounding)."""
    log(f"== phase 6: timings of the sweep kernel at the inputs of {what} ==")
    sweep = PORT.sweep
    mesh, cfg, eos = sim.mesh, sim.cfg, sim.eos
    ndir = len(sweep.active_dirs(mesh))
    _, prim = sim.pkg.cons_to_prim(sim.u)
    c_h = sim.pkg.c_h_from_dt_hyp(sim._estimate()[1])
    itemsize = prim.element_size()
    cells = prim.numel() // prim.shape[1]
    tol = F32_TOL if prim.dtype == torch.float32 else F64_TOL
    per_recon = {}
    max_abs, max_rel = 0.0, 0.0
    for recon in ("dc", cfg.reconstruction):
        got = sweep.negdiv_cuda(prim, c_h, mesh, cfg, eos, recon)
        ref = sweep.negdiv_plain(prim, c_h, mesh, cfg, eos, recon)
        torch.cuda.synchronize()
        abs_err = (got - ref).abs().max().item()
        rel = max_rel_err(got, ref)
        finite = bool(torch.isfinite(got).all())
        max_abs, max_rel = max(max_abs, abs_err), max(max_rel, rel)
        log(f"  {recon}: kernel against plain max abs err {abs_err:.3e}, "
            f"max rel err {rel:.3e} (tol {tol:.0e}, per variable; "
            f"{max_rel_err(got, ref, per_var=False):.3e} over all)")
        del got, ref
        torch.cuda.empty_cache()
        if not (rel <= tol and finite):
            raise AssertionError(f"kernel disagrees with plain at the inputs "
                                 f"of {what} ({recon}): {rel:.3e}")
        ms = cuda_ms(lambda: sweep.negdiv_cuda(prim, c_h, mesh, cfg, eos,
                                               recon), reps)
        plain_ms = cuda_ms(lambda: sweep.negdiv_plain(prim, c_h, mesh, cfg,
                                                      eos, recon), 3)
        torch.cuda.empty_cache()
        ops, slow, full = count_ops(lambda: sweep.negdiv_plain(
            prim, c_h, mesh, cfg, eos, recon))
        torch.cuda.empty_cache()
        nbytes = 2 * prim.numel() * itemsize   # prim read once, out written once
        b = bound_of(nbytes, ops, ms)
        per_recon[recon] = dict(ms=ms, plain_ms=plain_ms, bytes=nbytes,
                                ops=ops, ops_per_cell=ops / cells,
                                div_sqrt_per_cell=slow / cells,
                                branch_free_ops_per_cell=full / cells, **b)
        log(f"  {recon}: kernel {ms:.4f} ms/call ({ndir} launches), plain "
            f"{plain_ms:.4f} ms/call; bound {b['bound_ms']:.4f} ms "
            f"(bytes {b['bytes_ms']:.4f} ms for {nbytes:.4e} B, operations "
            f"{b['ops_ms']:.4f} ms for {ops:.4e} ops = {ops / cells:.1f}/cell, "
            f"of them {slow / cells:.1f} divisions and roots; the "
            f"branch-free lattice does {full / cells:.1f}/cell); "
            f"{100 * b['share_of_bound']:.2f} % of the bound")
        if f64_rows:
            per_recon[recon]["f64"] = f64_row(
                recon, lambda p64: sweep.negdiv_cuda(p64, c_h, mesh, cfg, eos,
                                                     recon),
                lambda p64: sweep.negdiv_plain(p64, c_h, mesh, cfg, eos,
                                               recon),
                (prim,), ops, reps, f"{ndir} launches")
    # one cycle runs one DC and one full-order call
    mix = lambda k: sum(r[k] for r in per_recon.values()) / (2 * ndir)  # noqa
    t_b = sum(r["bytes"] for r in per_recon.values()) / HBM_BYTES_PER_S
    t_o = sum(r["ops"] for r in per_recon.values()) / FP32_OPS_PER_S
    shape = "x".join(str(k) for k in (mesh.nx1, mesh.nx2, mesh.nx3) if k > 1)
    return {
        "name": name,
        "route": "cuda",
        "source": "athenapk_tpu_torch/csrc/negdiv_sweep.cu",
        "replaces": replaces,
        "launches": launches,
        "max_abs_err": max_abs,
        "ms": mix("ms"),
        "plain_ms": mix("plain_ms"),
        "bound_ms": mix("bound_ms"),
        "share_of_bound": mix("bound_ms") / mix("ms"),
        "bound_by": "bytes" if t_b >= t_o else "operations",
        "library_ms": None,
        "library_note": "no single PyTorch call computes reconstruction + "
                        "Riemann solve + flux divergence",
        "unit": f"per launch (one direction), averaged over one cycle of "
                f"{what} (one DC and one {cfg.reconstruction.upper()} call), "
                f"{shape} {str(prim.dtype).replace('torch.', '')}",
        "max_rel_err": max_rel,
        "per_call": per_recon,
    }


def phase_stage_timings(sim, launches, reps):
    """The stage kernel at the main deck's inputs, as the stage rung calls
    it: the DC predictor (no extra output) and the PPM corrector (with the
    CFL output), each against plain, timed, with its bound and its share
    of it; then the same calls on the inputs in f64, against the FP64
    rate."""
    log("== phase 6: timings of the stage kernel at the main deck's "
        "inputs ==")
    stage = PORT.stage
    mesh, cfg, eos = sim.mesh, sim.cfg, sim.eos
    dt, dt_hyp = sim._estimate()
    c_h = sim.pkg.c_h_from_dt_hyp(dt_hyp)
    u1 = sim.u
    # the corrector's u0 is the predictor's result
    u_half = sim.pkg._fused_stage_update(u1, u1, 0.0, 1.0, 0.5 * dt, c_h,
                                         "dc")
    cells = u1.numel() // u1.shape[1]
    tol = F32_TOL if u1.dtype == torch.float32 else F64_TOL
    calls = {"dc": (u1, u1, 0.0, 1.0, 0.5 * dt, False),
             cfg.reconstruction: (u_half, u1, 0.0, 1.0, dt, True)}
    per_call = {}
    max_abs, max_rel = 0.0, 0.0
    for recon, (u0, ub, gam0, gam1, beta_dt, emit_dt) in calls.items():
        args = (u0, ub, gam0, gam1, beta_dt, c_h, mesh, cfg, eos, recon)
        got = stage.stage_cuda(*args, emit_dt=emit_dt)
        ref = stage.stage_plain(*args, emit_dt=emit_dt)
        torch.cuda.synchronize()
        g_u, r_u = (got[0], ref[0]) if emit_dt else (got, ref)
        abs_err = (g_u - r_u).abs().max().item()
        rel = max_rel_err(g_u, r_u)
        finite = bool(torch.isfinite(g_u).all())
        note = ""
        if emit_dt:
            a, b = got[1].min().item(), ref[1].min().item()
            rel = max(rel, abs(a - b) / b)
            note = f", CFL minimum {a:.9e} against {b:.9e}"
        max_abs, max_rel = max(max_abs, abs_err), max(max_rel, rel)
        log(f"  {recon}: kernel against plain max abs err {abs_err:.3e}, "
            f"max rel err {rel:.3e} (tol {tol:.0e}, per variable){note}")
        del got, ref, g_u, r_u
        torch.cuda.empty_cache()
        if not (rel <= tol and finite):
            raise AssertionError(f"stage kernel disagrees with plain at the "
                                 f"main deck's inputs ({recon}): {rel:.3e}")
        ms = cuda_ms(lambda: stage.stage_cuda(*args, emit_dt=emit_dt), reps)
        plain_ms = cuda_ms(lambda: stage.stage_plain(*args, emit_dt=emit_dt),
                           3)
        torch.cuda.empty_cache()

        def plain_all():
            out = stage.stage_plain(*args, emit_dt=emit_dt)
            return torch.cat([x.reshape(-1) for x in out]) if emit_dt else out
        ops, slow, full = count_ops(plain_all)
        torch.cuda.empty_cache()
        # each distinct input read once (the predictor's u0 and u1 are one
        # tensor), u_new written once (the CFL minima are a few kilobytes)
        n_inputs = len({u0.data_ptr(), ub.data_ptr()})
        nbytes = (n_inputs + 1) * u1.numel() * u1.element_size()
        b = bound_of(nbytes, ops, ms)
        per_call[recon] = dict(ms=ms, plain_ms=plain_ms, bytes=nbytes,
                               state_tensors_read=n_inputs, ops=ops,
                               ops_per_cell=ops / cells,
                               div_sqrt_per_cell=slow / cells,
                               branch_free_ops_per_cell=full / cells,
                               emit_dt=emit_dt, **b)
        log(f"  {recon}: kernel {ms:.4f} ms/launch, plain {plain_ms:.4f} "
            f"ms/call; bound {b['bound_ms']:.4f} ms (bytes "
            f"{b['bytes_ms']:.4f} ms for {nbytes:.4e} B, operations "
            f"{b['ops_ms']:.4f} ms for {ops:.4e} ops = {ops / cells:.1f}/cell,"
            f" of them {slow / cells:.1f} divisions and roots; the "
            f"branch-free lattice does {full / cells:.1f}/cell); "
            f"{100 * b['share_of_bound']:.2f} % of the bound")

        def first(out):
            return out[0] if emit_dt else out
        per_call[recon]["f64"] = f64_row(
            recon, lambda a, b_: first(stage.stage_cuda(
                a, b_, *args[2:], emit_dt=emit_dt)),
            lambda a, b_: first(stage.stage_plain(
                a, b_, *args[2:], emit_dt=emit_dt)),
            (u0, ub), ops, reps, "1 launch")
    mix = lambda k: sum(r[k] for r in per_call.values()) / 2  # noqa
    t_b = sum(r["bytes"] for r in per_call.values()) / HBM_BYTES_PER_S
    t_o = sum(r["ops"] for r in per_call.values()) / FP32_OPS_PER_S
    return {
        "name": "fused_stage",
        "route": "cuda",
        "source": "athenapk_tpu_torch/csrc/fused_stage.cu",
        "replaces": "athenapk_tpu/solver/pallas_sweep.py:208",
        "launches": launches,
        "max_abs_err": max_abs,
        "ms": mix("ms"),
        "plain_ms": mix("plain_ms"),
        "bound_ms": mix("bound_ms"),
        "share_of_bound": mix("bound_ms") / mix("ms"),
        "bound_by": "bytes" if t_b >= t_o else "operations",
        "library_ms": None,
        "library_note": "no single PyTorch call computes cons_to_prim + "
                        "three sweeps + the stage update",
        "unit": f"per launch (one stage), averaged over one stage-rung cycle "
                f"of the main deck (the DC predictor and the "
                f"{cfg.reconstruction.upper()} corrector with the CFL "
                f"output), {mesh.nx1}^3 "
                f"{str(u1.dtype).replace('torch.', '')}",
        "max_rel_err": max_rel,
        "per_call": per_call,
    }


def eos_limits(eos, prim):
    """Every floor and ceiling of ``eos`` on, each at a quantile of
    ``prim``'s own density, pressure, specific internal energy or speed (of
    every 7th cell), so that each trips in a share of the cells: the floors
    at the medians, the ceilings at the upper quartiles."""
    rho, p = prim[:, 0].double(), prim[:, 4].double()
    e = p / ((eos.gamma - 1.0) * rho)
    v = prim[:, 1:4].double().square().sum(dim=1).sqrt()

    def q(x, k):
        return float(torch.quantile(x.flatten()[::7], k))
    return dataclasses.replace(
        eos, density_floor=q(rho, 0.5), pressure_floor=q(p, 0.5),
        internal_e_floor=q(e, 0.5), velocity_ceiling=q(v, 0.75),
        internal_e_ceiling=q(e, 0.75))


def phase_eos_timings(sim, launches_by_path, reps):
    """The EOS kernel (``eos.adiabatic_cuda.cons_to_prim_cuda``) against
    the plain ``eos.adiabatic.cons_to_prim`` at ``sim``'s state (the main
    deck's after its run), f32 as it runs and the same state in f64, each
    with the deck's EOS (no limit: the kernel writes prim only and hands the
    input back as the floored cons) and with every floor and ceiling on
    (``eos_limits``: it writes the floored cons too).  Prim and the floored
    cons must equal the plain version's bit for bit, the input must stay
    unwritten, and each limit case must change the state.  Each call is
    timed, with its bound from the bytes of the rows read and written and
    the operations the plain version needs on the f32 data."""
    log("== phase 6: timings of the EOS kernel at the main deck's state ==")
    ad, kern = PORT.adiabatic, PORT.adiabatic_cuda.cons_to_prim_cuda
    fluid, ns = sim.cfg.fluid, sim.cfg.nscalars
    eoses = {"no limit": sim.eos,
             "every limit": eos_limits(sim.eos, ad.cons_to_prim(
                 sim.eos, sim.u, fluid, ns)[1])}
    if PORT.adiabatic_cuda.limits_on(sim.eos):
        raise AssertionError("the main deck's EOS has a limit on")
    ops, per_call, failed = {}, {}, []
    for dtype in (torch.float32, torch.float64):
        u = sim.u.to(dtype).contiguous()
        kept = u.clone()
        tag = str(dtype).replace("torch.", "")
        for case, eos in eoses.items():
            got_u, got_w = kern(eos, u, fluid, ns)
            ref_u, ref_w = ad.cons_to_prim(eos, u, fluid, ns)
            torch.cuda.synchronize()
            abs_err = max((got_w - ref_w).abs().max().item(),
                          (got_u - ref_u).abs().max().item())
            bitwise = torch.equal(got_w, ref_w) and torch.equal(got_u, ref_u)
            aliased = got_u is u
            changed = not torch.equal(ref_u, u)
            unwritten = torch.equal(u, kept)
            del got_u, got_w, ref_u, ref_w
            torch.cuda.empty_cache()
            limited = case != "no limit"
            ok = bitwise and unwritten and aliased != limited \
                and changed == limited
            if not ok:
                failed.append(f"{tag} {case}: bit for bit {bitwise}, input "
                              f"unwritten {unwritten}, cons is the input "
                              f"{aliased}, state changed {changed}")
            if case not in ops:
                # both outputs' operations (the stack moves data only)
                ops[case] = count_ops(lambda: torch.stack(ad.cons_to_prim(
                    eos, u, fluid, ns)))[0]
                torch.cuda.empty_cache()
            ms = cuda_ms(lambda: kern(eos, u, fluid, ns), reps)
            plain_ms = cuda_ms(lambda: ad.cons_to_prim(eos, u, fluid, ns), 3)
            torch.cuda.empty_cache()
            rows_out = 2 if limited else 1
            nbytes = (1 + rows_out) * u.numel() * u.element_size()
            b = bound_of(nbytes, ops[case], ms, f64=dtype == torch.float64)
            per_call[f"{tag}, {case}"] = dict(
                ms=ms, plain_ms=plain_ms, bytes=nbytes, ops=ops[case],
                max_abs_err=abs_err, bit_for_bit=bitwise,
                bytes_per_s=nbytes / ms * 1e3, **b)
            same = "bit for bit" if bitwise else "NOT bit for bit"
            log(f"  {tag} {case}: kernel against plain max abs err "
                f"{abs_err:.3e} ({same}), input unwritten {unwritten}, the "
                f"floored cons "
                f"{'is the input' if aliased else 'a new tensor'}; kernel "
                f"{ms:.4f} ms ({nbytes / ms / 1e9:.3f} TB/s), plain "
                f"{plain_ms:.4f} ms; bound {b['bound_ms']:.4f} ms (bytes "
                f"{b['bytes_ms']:.4f} ms for {nbytes:.4e} B, operations "
                f"{b['ops_ms']:.4f} ms for {ops[case]:.4e}); "
                f"{100 * b['share_of_bound']:.2f} % of the bound")
        del u, kept
        torch.cuda.empty_cache()
    if failed:
        raise AssertionError(f"EOS kernel against plain: {failed}")
    main = per_call["float32, no limit"]
    mesh = sim.mesh
    return {
        "name": "cons_to_prim",
        "route": "cuda",
        "source": "athenapk_tpu_torch/csrc/cons_to_prim.cu",
        "replaces": "none: the JAX package's EOS (athenapk_tpu/eos/"
                    "adiabatic.py:71) is XLA's, fused into the ops around it",
        "launches": launches_by_path["main deck, sweep rung"],
        "launches_by_path": launches_by_path,
        "launches_note": "each run's launches include one for its initial "
                         "dt",
        "max_abs_err": max(r["max_abs_err"] for r in per_call.values()),
        "max_rel_err": 0.0 if all(r["bit_for_bit"]
                                  for r in per_call.values()) else None,
        "ms": main["ms"],
        "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"],
        "share_of_bound": main["share_of_bound"],
        "bound_by": main["bound_by"],
        "library_ms": None,
        "library_note": "no single PyTorch call converts cons to prim with "
                        "the floors and ceilings",
        "unit": f"per launch (one call) at the main deck's state after its "
                f"run, {mesh.nx1}x{mesh.nx2}x{mesh.nx3} ghost-free "
                f"{sim.cfg.fluid}; the top-level numbers are the float32 call "
                f"without a limit, as the main path runs it",
        "per_call": per_call,
    }


# the cooling's constants in units of the proton mass and the centimetre
# and second, all inside float32 (the cluster deck's ~1e130 are not)
F32_COOLING = """
<hydro>
gamma = 1.6666666666666667
He_mass_fraction = 0.25

<units>
code_length_cgs = 1.0
code_mass_cgs = 1.6726e-24
code_time_cgs = 1.0

<cooling>
enable_cooling = tabular
table_filename = {table}
lambda_units_cgs = 1.0
integrator = townsend
cfl = 0.1
"""


def drawn_cluster_gas(tc, shape, seed):
    """A GLM-MHD state with one scalar, ``shape`` cells, f64 on the card:
    gas at 1e4-1e9 K and densities 0.1-10, moving and magnetised."""
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def uniform(lo, hi):
        return lo + (hi - lo) * torch.rand(shape, generator=gen,
                                           device="cuda", dtype=torch.float64)

    def normal():
        return torch.randn(shape, generator=gen, device="cuda",
                           dtype=torch.float64)
    rho = 10.0 ** uniform(-1.0, 1.0)
    e = 10.0 ** uniform(4.0, 9.0) / tc.mbar_gm1_over_kb
    u = torch.empty((1, 10) + shape, device="cuda", dtype=torch.float64)
    u[0, 0] = rho
    for v in (1, 2, 3):
        u[0, v] = rho * 1e-3 * e.sqrt() * normal()
    for v in (5, 6, 7):
        u[0, v] = 1e-2 * (rho * e).sqrt() * normal()
    u[0, 4] = rho * e + 0.5 * (u[0, 1:4] ** 2).sum(dim=0) / rho \
        + 0.5 * (u[0, 5:8] ** 2).sum(dim=0)
    u[0, 8] = normal()
    u[0, 9] = uniform(0.0, 1.0) * rho
    return u


def phase_cooling_timings(reps, seed):
    """The cooling kernels (``srcterms.tabular_cooling_cuda``) against the
    plain code at the benchmark cluster's size, 320^3 with 2 ghosts (324^3
    cells) in one GLM-MHD block with one scalar: f64 on path K''s state at
    64^3 (the cluster deck's first cycle) tiled over the box, with the deck's
    cooling and half its dt (a VL2 stage's); f32 on drawn gas with the same
    table in units that keep every constant inside float32.  The in-place
    update and the dt must equal the plain code bit for bit; each is timed
    beside its bytes bound (rows read and written once; the operations,
    pow and log10 among them, are not counted) and the plain code's time
    (the update's with ``apply``'s clone, as the parent ran it)."""
    log("== phase 6: timings of the cooling kernels at 324^3 (the "
        "benchmark cluster's size) ==")
    # the card tests' comparison (tests/ is on the path: load_port)
    from test_torch_cooling_kernel import same_bits
    tcc = PORT.tabular_cooling_cuda
    n, g = 320, 2
    big = n + 2 * g
    mesh = PORT.Mesh(nx1=n, nx2=n, nx3=n, mbnx1=n, mbnx2=n, mbnx3=n,
                     x1min=-1.0, x1max=1.0, x2min=-1.0, x2max=1.0,
                     x3min=-1.0, x3max=1.0, nghost=g)
    sim = make_sim(cluster_deck("K'", 64, 1))
    sim.run()
    dt64, _ = sim._estimate()
    tile = -(-big // sim.u.shape[-1])
    u64 = sim.u.repeat(1, 1, tile, tile, tile)[..., :big, :big, :big] \
        .contiguous()
    tc64 = sim.pkg.cooling
    del sim
    tc32 = PORT.driver.make_cooling(PORT.ParameterInput.from_string(
        F32_COOLING.format(table=cluster_table())))
    u32 = drawn_cluster_gas(tc32, (big,) * 3, seed).float()
    cases = {"float64": (tc64, u64, 0.5 * dt64),
             "float32": (tc32, u32, 1.0e12)}
    per_call, failed = {}, []
    for tag, (tc, u, beta_dt) in cases.items():
        f64 = u.dtype == torch.float64
        eos = PORT.EOS(gamma=tc.gamma)
        prim = PORT.cons_to_prim(eos, u, "glmmhd", 1)[1]
        got = tcc.townsend_cuda(tc, u.clone(), beta_dt, "glmmhd")
        ref = tc.cool_plain(u.clone(), beta_dt, "glmmhd")
        torch.cuda.synchronize()
        up_bits = same_bits(got, ref)
        changed = int((got[:, 4] != u[:, 4]).sum())
        del got, ref
        got_dt = tcc.cooling_dt_cuda(tc, prim, mesh)
        ref_dt = tc.cooling_dt_plain(prim, mesh)
        dt_bits = same_bits(got_dt, ref_dt)
        dt_value = float(ref_dt)
        torch.cuda.empty_cache()
        if not (up_bits and dt_bits and changed > 0):
            failed.append(f"{tag}: update bit for bit {up_bits} ({changed} "
                          f"energies changed), dt bit for bit {dt_bits}")
        work = u.clone()
        ms_up = cuda_ms(lambda: tcc.townsend_cuda(tc, work, beta_dt,
                                                  "glmmhd"), reps)
        del work
        plain_up = cuda_ms(lambda: tc.cool_plain(u.clone(), beta_dt,
                                                 "glmmhd"), 2)
        torch.cuda.empty_cache()
        ms_dt = cuda_ms(lambda: tcc.cooling_dt_cuda(tc, prim, mesh), reps)
        plain_dt = cuda_ms(lambda: tc.cooling_dt_plain(prim, mesh), 2)
        torch.cuda.empty_cache()
        esize = u.element_size()
        bytes_up = (8 + 1) * big ** 3 * esize
        bytes_dt = 2 * n ** 3 * esize
        b_up = bound_of(bytes_up, 0, ms_up, f64=f64)
        b_dt = bound_of(bytes_dt, 0, ms_dt, f64=f64)
        per_call[tag] = dict(
            update=dict(ms=ms_up, plain_ms=plain_up, bytes=bytes_up,
                        bit_for_bit=up_bits, energies_changed=changed,
                        bytes_per_s=bytes_up / ms_up * 1e3, **b_up),
            dt=dict(ms=ms_dt, plain_ms=plain_dt, bytes=bytes_dt,
                    bit_for_bit=dt_bits, dt=dt_value,
                    bytes_per_s=bytes_dt / ms_dt * 1e3, **b_dt))
        for name, ms, plain, b, bits in (
                ("update", ms_up, plain_up, b_up, up_bits),
                ("dt", ms_dt, plain_dt, b_dt, dt_bits)):
            log(f"  {tag} {name}: kernel "
                f"{'bit for bit' if bits else 'NOT bit for bit'} with "
                f"plain; kernel {ms:.4f} ms, plain {plain:.4f} ms "
                f"({plain / ms:.1f}x); bytes bound {b['bytes_ms']:.4f} ms, "
                f"{100 * b['share_of_bound']:.2f} % of it")
        del u, prim
        torch.cuda.empty_cache()
    if failed:
        raise AssertionError(f"cooling kernels against plain: {failed}")
    main = per_call["float64"]
    return {
        "name": "tabular_cooling",
        "route": "cuda",
        "source": "athenapk_tpu_torch/csrc/tabular_cooling.cu",
        "replaces": "none: the JAX package's cooling (athenapk_tpu/"
                    "srcterms/tabular_cooling.py) is XLA's",
        "ms": main["update"]["ms"],
        "plain_ms": main["update"]["plain_ms"],
        "bound_ms": main["update"]["bound_ms"],
        "share_of_bound": main["update"]["share_of_bound"],
        "bound_by": "bytes (operations not counted)",
        "dt_ms": main["dt"]["ms"],
        "dt_plain_ms": main["dt"]["plain_ms"],
        "dt_share_of_bound": main["dt"]["share_of_bound"],
        "max_rel_err": 0.0,
        "library_ms": None,
        "library_note": "no single PyTorch call integrates the cooling",
        "unit": "per call at 324^3 (320^3 and 2 ghosts), GLM-MHD with one "
                "scalar; the top-level numbers are the f64 update in place "
                "and the f64 dt over the interior",
        "per_call": per_call,
    }


def phase_case_timings(runs, reps, f64=False):
    """A timing row per case at its path's own inputs (the state the path's
    run ended with, f32): the deck's call of the sweep kernel (one per
    stage: a launch per direction) or, on the stage rung, of the stage
    kernel (one launch), against plain (f32 tolerance), kernel and plain
    per call, the bound from this call's bytes (prim read once, -div(F) or
    u_new written once) and the operations its data need, per launch.
    With ``f64`` the same inputs in f64 are held against plain too (f64
    tolerance)."""
    sweep, stage = PORT.sweep, PORT.stage
    rows = {}
    for name, run in runs.items():
        sim = run["sim"]
        mesh, cfg, eos = sim.mesh, sim.cfg, sim.eos
        recon = cfg.reconstruction
        dt, dt_hyp = sim._estimate()
        c_h = sim.pkg.c_h_from_dt_hyp(dt_hyp)
        if run["rung"] == "stage":
            x, n_launch = sim.u, 1

            def kern(u=x):
                return stage.stage_cuda(u, u, 0.0, 1.0, dt, c_h, mesh, cfg,
                                        eos, recon)

            def plain(u=x):
                return stage.stage_plain(u, u, 0.0, 1.0, dt, c_h, mesh, cfg,
                                         eos, recon)
            route = "#3 fused_stage"
        else:
            _, x = sim.pkg.cons_to_prim(sim.u)
            n_launch = len(sweep.active_dirs(mesh))

            def kern(p=x):
                return sweep.negdiv_cuda(p, c_h, mesh, cfg, eos, recon)

            def plain(p=x):
                return sweep.negdiv_plain(p, c_h, mesh, cfg, eos, recon)
            route = "#1 negdiv_sweep"
        errs = {}
        for dtype, tol in TOLS if f64 else TOLS[:1]:
            xd = x.to(dtype)
            got, ref = kern(xd), plain(xd)
            torch.cuda.synchronize()
            errs[dtype] = rel = max_rel_err(got, ref)
            finite = bool(torch.isfinite(got).all())
            if dtype == x.dtype:
                abs_err = (got - ref).abs().max().item()
            del got, ref, xd
            torch.cuda.empty_cache()
            if not (rel <= tol and finite):
                raise AssertionError(f"{route} disagrees with plain at the "
                                     f"inputs of {name} ({dtype}): "
                                     f"{rel:.3e}")
        rel = errs[x.dtype]
        ms = cuda_ms(kern, reps)
        plain_ms = cuda_ms(plain, 2)
        torch.cuda.empty_cache()
        ops, slow, _ = count_ops(plain)
        torch.cuda.empty_cache()
        cells = x.numel() // x.shape[1]
        nbytes = 2 * x.numel() * x.element_size()
        b = bound_of(nbytes / n_launch, ops / n_launch, ms / n_launch,
                     f64=x.dtype == torch.float64)
        rows[name] = dict(
            route=route, ms=ms / n_launch, call_ms=ms,
            plain_ms=plain_ms, launches_per_call=n_launch,
            max_abs_err=abs_err, max_rel_err=rel,
            max_rel_err_f64=errs.get(torch.float64), ops_per_cell=ops / cells,
            div_sqrt_per_cell=slow / cells, launches_on_path=run["launches"],
            cycles=run["cycles"], zone_cycles_per_s=run["zcps"], **b)
        if "rescues" in run:
            rows[name]["stages_rescued"] = run["rescues"]
            rows[name]["stages"] = run["stages"]
        log(f"  {name} ({route}, {recon}): kernel {ms / n_launch:.4f} ms per "
            f"launch ({ms:.4f} per call of {n_launch}), plain {plain_ms:.4f} "
            f"ms per call; bound {b['bound_ms']:.4f} ms per launch "
            f"({b['bound_by']}; {ops / cells:.1f} operations per cell, "
            f"{slow / cells:.1f} divisions and roots); "
            f"{100 * b['share_of_bound']:.2f} % of the bound; max abs err "
            f"{abs_err:.3e}, max rel err " + ", ".join(
                f"{v:.3e} ({str(k)[6:]})" for k, v in errs.items())
            + f"; {run['launches']} launches on the path")
    return rows


@checked_profile
def phase_profile(sim, ncycles, what):
    """Where one cycle's device time goes: a torch.profiler trace of
    ``ncycles`` steps, kernels grouped by name, and the share of the window
    in which no kernel ran."""
    log(f"== phase 7: device-time breakdown of {ncycles} cycles of {what} ==")
    from torch.profiler import ProfilerActivity, profile, record_function

    dt, dt_hyp = sim._estimate()
    c_h = sim.pkg.c_h_from_dt_hyp(dt_hyp)
    u = sim.u
    cooling = sim.pkg.cooling
    if cooling is not None:
        # the cooling's plain kernels are told apart by a profiler range
        apply = cooling.apply_in_place

        def ranged(*a, **k):
            with record_function("cooling"):
                return apply(*a, **k)
        cooling.apply_in_place = ranged
    torch.cuda.synchronize()
    n0 = all_launches()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(ncycles):
                u, _ = sim.pkg.step_with_dt(u, dt, c_h)
            torch.cuda.synchronize()
    finally:
        if cooling is not None:
            del cooling.apply_in_place
    trace = ROOT / "build" / "chip_smoke" / "trace.json"
    trace.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(trace))
    events = json.loads(trace.read_text())["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    if not kernels:
        log("  the profiler recorded no device kernels: not measured")
        return None
    check_trace(kernels, all_launches() - n0)
    recons = RECON_NAMES
    ranges = [e for e in events if e.get("cat") == "user_annotation"
              and e.get("name") == "cooling"]
    launched = {e["args"]["correlation"]: e["ts"] for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "correlation" in e.get("args", {})}
    groups = {}
    for e in kernels:
        m = re.search(r"negdiv_sweep_kernel<\w+, (\d), (\d), \d(?:, \w+)?>",
                      e["name"])
        s = re.search(r"fused_stage_kernel<\w+, (\d), \d(?:, \w+)*>",
                      e["name"])
        ts = launched.get(e.get("args", {}).get("correlation"))
        key = (f"negdiv_sweep {recons[int(m.group(1))]} dir {m.group(2)}"
               if m else f"fused_stage {recons[int(s.group(1))]}" if s
               else "scalar kernels (negdiv_scalars, stage_scalars)"
               if "scalars_kernel" in e["name"]
               else "cons_to_prim (the EOS kernel)"
               if "cons_to_prim_kernel" in e["name"]
               else "a kernel of the port (unparsed)"
               if re.search("negdiv_sweep|fused_stage", e["name"])
               else COOLING_KEY if COOLING_KERNEL.search(e["name"])
               else "cooling (plain PyTorch)" if ts is not None and any(
                   a["ts"] <= ts <= a["ts"] + a["dur"] for a in ranges)
               else "other kernels (plain PyTorch)")
        groups[key] = groups.get(key, 0.0) + e["dur"] / 1e3
    busy = sum(e["dur"] for e in kernels) / 1e3
    t0 = min(e["ts"] for e in kernels)
    t1 = max(e["ts"] + e["dur"] for e in kernels)
    window = (t1 - t0) / 1e3
    for key in sorted(groups, key=groups.get, reverse=True):
        log(f"  {key:32s} {groups[key] / ncycles:9.4f} ms/cycle "
            f"({100 * groups[key] / busy:5.1f} % of device time)")
    idle = max(0.0, 1.0 - busy / window)
    log(f"  device busy {busy / ncycles:.4f} ms/cycle over a "
        f"{window / ncycles:.4f} ms/cycle window: idle share {idle:.3f}")
    return {"ms_per_cycle": {k: v / ncycles for k, v in groups.items()},
            "busy_ms_per_cycle": busy / ncycles,
            "window_ms_per_cycle": window / ncycles, "idle_share": idle}


def _flat(out):
    """The tensors of a face function's result as one vector (count_ops
    follows one result)."""
    parts = [out[0]] + [out[-1][d] for d in sorted(out[-1])]
    return torch.cat([x.reshape(-1) for x in parts])


def phase_smr_timings(sim, kind, launches, reps, name, replaces, what):
    """A face kernel at ``sim``'s level arrays, as one cycle calls it (per
    level a DC and a PLM call): each call timed against plain, with its
    bound from this run's bytes and the operations its data need; the
    entry gives the averages per launch."""
    log(f"== phase 6: timings of the {kind} kernel at the inputs of {what} ==")
    stage, sweep = PORT.stage, PORT.sweep
    per_call, max_abs = {}, 0.0
    calls = smr_stage_calls(sim) if kind == "stage-faces" \
        else smr_negdiv_calls(sim)
    for label, args in calls:
        if kind == "stage-faces":
            def kern():
                return stage.stage_faces_cuda(*args)

            def plain():
                return stage.stage_faces_plain(*args)
            u = args[0]
            # distinct state tensors read once (the predictor's u0 and u1
            # are one tensor), u_new written once
            n_in = len({args[0].data_ptr(), args[1].data_ptr()})
            n_launch = 1
        else:
            def kern():
                return sweep.negdiv_faces_cuda(*args)

            def plain():
                return sweep.negdiv_faces_plain(*args)
            u = args[0]
            n_in = 1       # prim read once, -div(F) written once
            n_launch = len(sweep.active_dirs(args[2]))
        got, ref = kern(), plain()
        torch.cuda.synchronize()
        # what the path uses: the interior cells and every face slab (the
        # ghost rim is rewritten by the fill)
        sl = (args[6] if kind == "stage-faces" else args[2]).interior_slices
        max_abs = max([max_abs, (got[0][sl] - ref[0][sl]).abs().max().item()]
                      + [(got[-1][d] - ref[-1][d]).abs().max().item()
                         for d in ref[-1]])
        del got, ref
        ms = cuda_ms(kern, reps)
        plain_ms = cuda_ms(plain, 2)
        torch.cuda.empty_cache()
        ops, slow, full = count_ops(lambda: _flat(plain()))
        torch.cuda.empty_cache()
        faces = sum(int(np.prod(PORT.sweep.face_shape(u, d)))
                    for d in sweep.active_dirs(args[6] if kind ==
                                               "stage-faces" else args[2]))
        nbytes = ((n_in + 1) * u.numel() + faces) * u.element_size()
        cells = u.numel() // u.shape[1]
        f64 = u.dtype == torch.float64
        b = bound_of(nbytes, ops, ms, f64=f64)
        per_call[label] = dict(ms=ms, plain_ms=plain_ms, launches=n_launch,
                               bytes=nbytes, state_tensors_read=n_in,
                               ops=ops, ops_per_cell=ops / cells,
                               div_sqrt_per_cell=slow / cells,
                               branch_free_ops_per_cell=full / cells, **b)
        log(f"  {label}: kernel {ms:.4f} ms/call ({n_launch} launches), plain "
            f"{plain_ms:.4f} ms/call; bound {b['bound_ms']:.4f} ms (bytes "
            f"{b['bytes_ms']:.4f} ms for {nbytes:.4e} B, operations "
            f"{b['ops_ms']:.4f} ms for {ops:.4e} ops = {ops / cells:.1f}/cell,"
            f" {slow / cells:.1f} of them divisions and roots); "
            f"{100 * b['share_of_bound']:.2f} % of the bound")
    n = sum(r["launches"] for r in per_call.values())
    mix = lambda k: sum(r[k] for r in per_call.values()) / n  # noqa: E731
    dc_and = "a DC and " if sim.cfg.integrator == "vl2" else ""
    t_b = sum(r["bytes"] for r in per_call.values()) / HBM_BYTES_PER_S
    t_o = sum(r["ops"] for r in per_call.values()) / (
        FP64_OPS_PER_S if f64 else FP32_OPS_PER_S)
    return {
        "name": name,
        "route": "cuda",
        "source": ("athenapk_tpu_torch/csrc/fused_stage.cu"
                   if kind == "stage-faces"
                   else "athenapk_tpu_torch/csrc/negdiv_sweep.cu"),
        "replaces": replaces,
        "launches": launches,
        "max_abs_err": max_abs,
        "ms": mix("ms"),
        "plain_ms": mix("plain_ms"),
        "bound_ms": mix("bound_ms"),
        "share_of_bound": mix("bound_ms") / mix("ms"),
        "bound_by": "bytes" if t_b >= t_o else "operations",
        "library_ms": None,
        "library_note": "no single PyTorch call computes reconstruction + "
                        "Riemann solve + flux divergence with the boundary "
                        "face fluxes",
        "unit": f"per launch, averaged over the calls of one cycle of {what} "
                f"(per level {dc_and}a {sim.cfg.reconstruction.upper()} "
                f"call), {'f64' if f64 else 'f32'}",
        "per_call": per_call,
    }


@checked_profile
def phase_smr_profile(sim, ncycles, what):
    """Where a refined-mesh cycle's time goes: a torch.profiler trace of
    ``ncycles`` cycles (dt package, step), the port's kernels by name, and
    the plain-PyTorch kernels of the ghost fill, the flux correction and
    the dt package by the profiler ranges this phase wraps around those
    three calls; the device's idle share."""
    log(f"== phase 7: device-time breakdown of {ncycles} cycles of {what} ==")
    from torch.profiler import ProfilerActivity, profile, record_function

    st = sim._stepper_now()
    wrapped = ((st.state_mgr, "fill_ghosts", "smr.fill"),
               (st, "_slab_flux_correct", "smr.correction"),
               (st, "dt_pack", "smr.dt"))

    def wrap(fn, label):
        def call(*a, **k):
            with record_function(label):
                return fn(*a, **k)
        return call

    for obj, attr, label in wrapped:
        setattr(obj, attr, wrap(getattr(obj, attr), label))
    n0 = all_launches()
    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(ncycles):
                _, dt, c_h = sim._dt_pack().tolist()
                sim.state = st.step(sim.state, dt, c_h)
            torch.cuda.synchronize()
    finally:
        for obj, attr, _ in wrapped:
            delattr(obj, attr)
    trace = ROOT / "build" / "chip_smoke" / "trace_smr.json"
    trace.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(trace))
    events = json.loads(trace.read_text())["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    if not kernels:
        log("  the profiler recorded no device kernels: not measured")
        return None
    check_trace(kernels, all_launches() - n0)
    spans = [e for e in events if e.get("cat") == "gpu_user_annotation"
             and e.get("name", "").startswith("smr.")]
    host = {}
    for e in events:
        if e.get("cat") == "user_annotation" and \
                e.get("name", "").startswith("smr."):
            host[e["name"]] = host.get(e["name"], 0.0) + e["dur"] / 1e3
    recons = RECON_NAMES
    groups, count = {}, {}
    for e in kernels:
        m = re.search(r"negdiv_sweep_kernel<\w+, (\d), (\d), \d(?:, \w+)?>",
                      e["name"])
        s = re.search(r"fused_stage_kernel<\w+, (\d), \d(?:, \w+)*>",
                      e["name"])
        if m:
            key = f"negdiv_sweep (faces) {recons[int(m.group(1))]} dir " \
                  f"{m.group(2)}"
        elif s:
            key = f"fused_stage (faces) {recons[int(s.group(1))]}"
        elif COOLING_KERNEL.search(e["name"]):
            key = COOLING_KEY
        else:
            key = "other glue (plain PyTorch)"
            for a in spans:
                if a["ts"] <= e["ts"] and e["ts"] + e["dur"] <= \
                        a["ts"] + a["dur"] + 1.0:
                    key = f"{a['name']} (plain PyTorch)"
                    break
        groups[key] = groups.get(key, 0.0) + e["dur"] / 1e3
        count[key] = count.get(key, 0) + 1
    busy = sum(e["dur"] for e in kernels) / 1e3
    t0 = min(e["ts"] for e in kernels)
    t1 = max(e["ts"] + e["dur"] for e in kernels)
    window = (t1 - t0) / 1e3
    if not spans:
        log("  no device-side profiler ranges in the trace: the plain "
            "kernels are not split by call (not measured)")
    for key in sorted(groups, key=groups.get, reverse=True):
        log(f"  {key:36s} {groups[key] / ncycles:9.4f} ms/cycle "
            f"({100 * groups[key] / busy:5.1f} % of device time, "
            f"{count[key] / ncycles:.0f} kernels/cycle)")
    for name, ms in sorted(host.items()):
        log(f"  host time in {name}: {ms / ncycles:.4f} ms/cycle")
    idle = max(0.0, 1.0 - busy / window)
    log(f"  device busy {busy / ncycles:.4f} ms/cycle over a "
        f"{window / ncycles:.4f} ms/cycle window: idle share {idle:.3f}")
    return {"ms_per_cycle": {k: v / ncycles for k, v in groups.items()},
            "kernels_per_cycle": {k: v / ncycles for k, v in count.items()},
            "host_ms_per_cycle": {k: v / ncycles for k, v in host.items()},
            "busy_ms_per_cycle": busy / ncycles,
            "window_ms_per_cycle": window / ncycles, "idle_share": idle}


@checked_profile
def phase_amr_profile(sim, ncycles, what):
    """Where an adaptive cycle's time goes: a torch.profiler trace of
    ``ncycles`` cycles of the run loop (remesh check, step, tags and dt
    read), with profiler ranges around the step, the ghost fill, the tag
    dispatch and the remesh; device time per range (a kernel counts in
    the innermost range that holds it; the fill inside a remesh counts to
    the remesh), host time per range, and the device's idle share."""
    log(f"== phase 7: device-time breakdown of {ncycles} cycles of {what} ==")
    from torch.profiler import ProfilerActivity, profile, record_function

    wrapped = ((PORT.SmrHydro, "step", "amr.step"),
               (PORT.SmrState, "fill_ghosts", "amr.fill"),
               (PORT.AmrHydro, "dispatch_tags", "amr.tags"),
               (PORT.AmrHydro, "maybe_remesh", "amr.remesh"),
               (PORT.TabularCooling, "apply_in_place", "amr.cooling"))

    def wrap(fn, label):
        def call(*a, **k):
            with record_function(label):
                return fn(*a, **k)
        return call

    saved = [(cls, attr, cls.__dict__[attr]) for cls, attr, _ in wrapped]
    for cls, attr, label in wrapped:
        setattr(cls, attr, wrap(cls.__dict__[attr], label))
    drv = sim.driver
    n_log = len(drv.remesh_log)
    sim.quiet = True
    n0 = all_launches()
    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            sim.nlim = sim.ncycle + ncycles
            sim.run()
            torch.cuda.synchronize()
    finally:
        for cls, attr, fn in saved:
            setattr(cls, attr, fn)
    window = drv.remesh_log[n_log:]
    trace = ROOT / "build" / "chip_smoke" / "trace_amr.json"
    trace.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(trace))
    events = json.loads(trace.read_text())["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    if not kernels:
        log("  the profiler recorded no device kernels: not measured")
        return None
    check_trace(kernels, all_launches() - n0)
    # each kernel goes to the ranges open on the host when it was launched
    # (the launch's correlation id ties the two)
    ranges = [e for e in events if e.get("cat") == "user_annotation"
              and e.get("name", "").startswith("amr.")]
    launched = {e["args"]["correlation"]: e["ts"] for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "correlation" in e.get("args", {})}
    host = {}
    for e in ranges:
        host[e["name"]] = host.get(e["name"], 0.0) + e["dur"] / 1e3
    groups, count = {}, {}
    unmatched = 0
    for e in kernels:
        name = e["name"]
        ts = launched.get(e.get("args", {}).get("correlation"))
        unmatched += ts is None
        labels = set() if ts is None else {
            a["name"] for a in ranges if a["ts"] <= ts <= a["ts"] + a["dur"]}
        if "fused_stage_kernel" in name or "negdiv_sweep_kernel" in name:
            key = "face kernels (#7 or #6/#2)"
        elif "scalars_kernel" in name:
            key = "scalar kernels"
        elif COOLING_KERNEL.search(name):
            key = COOLING_KEY
        elif "amr.cooling" in labels:
            key = "amr.cooling (plain PyTorch)"
        elif "amr.remesh" in labels:
            key = "amr.remesh (transfer and its fill)"
        elif "amr.tags" in labels:
            key = "amr.tags"
        elif "amr.fill" in labels:
            key = "amr.fill (the step's two fills)"
        elif "amr.step" in labels:
            key = "amr.step (correction, update glue)"
        else:
            key = "other (dt package, the read)"
        groups[key] = groups.get(key, 0.0) + e["dur"] / 1e3
        count[key] = count.get(key, 0) + 1
    if unmatched:
        log(f"  {unmatched} of {len(kernels)} kernels without their launch "
            "in the trace: counted as other")
    busy = sum(e["dur"] for e in kernels) / 1e3
    t0 = min(e["ts"] for e in kernels)
    t1 = max(e["ts"] + e["dur"] for e in kernels)
    span_ms = (t1 - t0) / 1e3
    for key in sorted(groups, key=groups.get, reverse=True):
        log(f"  {key:36s} {groups[key] / ncycles:9.4f} ms/cycle "
            f"({100 * groups[key] / busy:5.1f} % of device time, "
            f"{count[key] / ncycles:.0f} kernels/cycle)")
    for name, ms in sorted(host.items()):
        log(f"  host time in {name}: {ms / ncycles:.4f} ms/cycle (nested "
            f"ranges included)")
    log(f"  remeshes in the window: {len(window)}, "
        f"{sum(e['changed'] for e in window)} of them changing the leaf "
        f"table")
    idle = max(0.0, 1.0 - busy / span_ms)
    log(f"  device busy {busy / ncycles:.4f} ms/cycle over a "
        f"{span_ms / ncycles:.4f} ms/cycle window: idle share {idle:.3f}")
    return {"ms_per_cycle": {k: v / ncycles for k, v in groups.items()},
            "kernels_per_cycle": {k: v / ncycles for k, v in count.items()},
            "host_ms_per_cycle": {k: v / ncycles for k, v in host.items()},
            "remeshes": len(window),
            "remeshes_changed": sum(e["changed"] for e in window),
            "busy_ms_per_cycle": busy / ncycles,
            "window_ms_per_cycle": span_ms / ncycles, "idle_share": idle}


# ------------------------------------------------------- cloud crushing
# The cloud-in-wind deck (pgen/cloud.py) with tabular cooling: a cloud of
# 100 pc at 1e-24 g/cm^3 in a wind of 1e-27 g/cm^3 at 1e7 K and 1700 km/s
# along x2 through the inner-x2 inflow boundary; GLM-MHD HLLD + PLM + VL2
# with a transverse field at plasma beta 100, one passive scalar marking
# the cloud, cooling on this script's own power-law table
# (write_cooling_table).  The domain is 8 radii across x1 and x3 and 24
# along x2; {n} cells across x1 (8 per radius at n = 64); x1, x3 and ox2
# are outflow.  The code units (1 cm, about one hydrogen mass, 1e-8 s)
# keep the cooling's Lambda and (X / m_h)^2 inside the f32 range
# (tests/torch_decks.py:CLOUD says more).
R_CLOUD = 3.085677580962325e+20     # 100 pc in code lengths (cm)
CLOUD_DECK = """
<job>
problem_id = cloud

<problem/cloud>
r0_cgs = 3.085677580962325e+20
rho_cloud_cgs = 1e-24
rho_wind_cgs = 1e-27
T_wind_cgs = 1e7
v_wind_cgs = 1.7e8
plasma_beta = 100.0
mag_field_angle = transverse

<parthenon/mesh>
refinement = {refinement}
numlevel = 2
nghost = 2
nx1 = {n}
x1min = {lo}
x1max = {hi}
nx2 = {n2}
x2min = {lo}
x2max = {x2max}
nx3 = {n}
x3min = {lo}
x3max = {hi}
ix1_bc = outflow
ox1_bc = outflow
ix2_bc = cloud_inflow_x2
ox2_bc = outflow
ix3_bc = outflow
ox3_bc = outflow

<parthenon/meshblock>
nx1 = {mb}
nx2 = {mb}
nx3 = {mb}

<parthenon/time>
integrator = vl2
cfl = 0.3
tlim = 1.0e30
nlim = {ncycles}
ncycle_out = {ncycle_out}
perf_cycle_offset = {warmup}

<hydro>
fluid = glmmhd
eos = adiabatic
riemann = hlld
reconstruction = plm
gamma = 1.666666666666667
nscalars = 1
He_mass_fraction = 0.25
precision = {precision}

<units>
code_length_cgs = 1.0
code_mass_cgs = 1.6726e-24
code_time_cgs = 1.0e-8

<cooling>
enable_cooling = tabular
table_filename = {table}
lambda_units_cgs = 1.0
integrator = {integrator}
cfl = 0.1
"""
# (fluid, riemann, reconstruction, nscalars): the scalar cases of phase 3
SCALAR_CASES = [("glmmhd", "hlld", "ppm", 1), ("glmmhd", "hlld", "ppm", 3),
                ("euler", "hllc", "plm", 1), ("euler", "hllc", "plm", 3),
                ("euler", "hllc", "plm", 4)]


def write_cooling_table(alpha=0.5, lam0=1e-23, t_ref=1e6):
    """A two-column cooling table (log10 T, log10 Lambda), Lambda = lam0
    (T / t_ref)^alpha from 1e4 to 1e8 K, under ``build/``; its path."""
    path = ROOT / "build" / "chip_smoke" / "powerlaw.cool"
    path.parent.mkdir(parents=True, exist_ok=True)
    log_t = np.linspace(4.0, 8.0, 41)
    log_l = np.log10(lam0) + alpha * (log_t - np.log10(t_ref))
    path.write_text("# logT logLambda\n" + "".join(
        f"{a} {b}\n" for a, b in zip(log_t, log_l)))
    return str(path)


def cloud_deck(refinement, n, mb, ncycles, warmup, precision, integrator,
               ncycle_out=1):
    return CLOUD_DECK.format(
        refinement=refinement, n=n, n2=3 * n, lo=-4.0 * R_CLOUD,
        hi=4.0 * R_CLOUD, x2max=20.0 * R_CLOUD, mb=mb, ncycles=ncycles,
        warmup=warmup, precision=precision, table=write_cooling_table(),
        integrator=integrator, ncycle_out=ncycle_out)


def scalar_prim(mesh, fluid, ns, seed, dtype):
    """``dip_prim`` (no dips) plus ``ns`` scalar rows, 0 in part of the
    domain and positive elsewhere, on the card."""
    rng = np.random.default_rng(seed + 1000)
    w = dip_prim(mesh, fluid, seed, torch.float64, dips=False).cpu().numpy()
    cells = (mesh.nblocks, ns) + mesh.block_shape
    q = np.maximum(rng.standard_normal(cells), 0.0) * rng.random(cells)
    return torch.tensor(np.concatenate([w, q], axis=1), dtype=dtype,
                        device="cuda")


def phase_scalar_cases(seed):
    """Every kernel route with passive scalars against its plain version:
    GLM-MHD HLLD + PPM and Euler HLLC + PLM with 1 and 3 scalars, Euler
    with 4, f32 and f64, on #1, #6/#2, #4 (2-D, 1-D), #5, #3 (floors, CFL,
    prim) and #7; the fluid rows and the scalar rows are held apart."""
    log("== phase 3: kernels against plain with passive scalars ==")
    sweep, stage = PORT.sweep, PORT.stage
    layouts = {"#1 3-D 64^3": ((64,) * 3, (64,) * 3, 0),
               "#6/#2 3-D 2 blocks of 32^3, nghost 3, faces": (
                   (64, 32, 32), (32,) * 3, 3),
               "#4 2-D 256^2": ((256, 256, 1), (256, 256, 1), 0),
               "#4 1-D 2048": ((2048, 1, 1), (2048, 1, 1), 0),
               "#5 2-D 4 blocks of 64^2, nghost 3, faces": (
                   (128, 128, 1), (64, 64, 1), 3),
               "#3 stage 3-D 48^3 +dt +prim": ((48,) * 3, (48,) * 3, 0),
               "#7 stage 3-D 2 blocks of 24^3, nghost 3, faces": (
                   (48, 24, 24), (24,) * 3, 3)}
    eos, eos_f = PORT.EOS(gamma=5.0 / 3.0), PORT.EOS(gamma=5.0 / 3.0,
                                                       **FLOORS)
    worst, failed, n_checks = {}, [], 0
    n_scalar = {"negdiv": 0, "stage": 0}
    for label, (n, mb, g) in layouts.items():
        mesh = _mesh(n, mb, g)
        sl = mesh.interior_slices
        is_stage = label.startswith(("#3", "#7"))
        for dtype, tol in TOLS:
            for fluid, riemann, recon, ns in SCALAR_CASES:
                cfg = PORT.HydroConfig(fluid=fluid, riemann=riemann,
                                       reconstruction=recon, nscalars=ns)
                nb0 = sweep.scalar_base(cfg)
                c_h = 1.3 if fluid == "glmmhd" else 0.0
                w = scalar_prim(mesh, fluid, ns, seed, torch.float64)
                before = (sweep.negdiv_scalars_cuda.launches,
                          stage.stage_scalars_cuda.launches)
                rows = {}
                if is_stage:
                    w[:, 0][w[:, 0] < 1.03] = 0.8      # under the floor
                    u0 = PORT.prim_to_cons(eos, w, fluid, ns).to(dtype)
                    u1 = 1.01 * u0 + 0.001
                    args = (u0, u1, 0.25, 0.75, 1e-3, c_h, mesh, cfg, eos_f,
                            recon)
                    if g:
                        got = stage.stage_faces_cuda(*args, emit_prim=True)
                        ref = stage.stage_faces_plain(*args, emit_prim=True)
                        outs = [(got[0][sl], ref[0][sl]), (got[1], ref[1])] \
                            + [(got[2][d], ref[2][d]) for d in ref[2]]
                    else:
                        got = stage.stage_cuda(*args, emit_dt=True,
                                               emit_prim=True)
                        ref = stage.stage_plain(*args, emit_dt=True,
                                                emit_prim=True)
                        outs = [(got[0], ref[0]), (got[2], ref[2])]
                        a, b = got[1].min().item(), ref[1].min().item()
                        rows["dt"] = abs(a - b) / b
                else:
                    prim = w.to(dtype)
                    if g:
                        got = sweep.negdiv_faces_cuda(prim, c_h, mesh, cfg,
                                                      eos, recon)
                        ref = sweep.negdiv_faces_plain(prim, c_h, mesh, cfg,
                                                       eos, recon)
                        outs = [(got[0][sl], ref[0][sl])] + [
                            (got[1][d], ref[1][d]) for d in ref[1]]
                    else:
                        got = sweep.negdiv_cuda(prim, c_h, mesh, cfg, eos,
                                                recon)
                        ref = sweep.negdiv_plain(prim, c_h, mesh, cfg, eos,
                                                 recon)
                        outs = [(got[sl], ref[sl])]
                torch.cuda.synchronize()
                launched = (sweep.negdiv_scalars_cuda.launches - before[0],
                            stage.stage_scalars_cuda.launches - before[1])
                n_scalar["stage" if is_stage else "negdiv"] += sum(launched)
                rows["fluid"] = max(max_rel_err(a[:, :nb0], b[:, :nb0])
                                    for a, b in outs)
                rows["scalars"] = max(max_rel_err(a[:, nb0:], b[:, nb0:])
                                      for a, b in outs)
                finite = all(bool(torch.isfinite(a).all()) for a, _ in outs)
                want = (1, 0) if is_stage else (0, len(
                    sweep.active_dirs(mesh)))
                ok = finite and max(rows.values()) <= tol \
                    and launched == want[::-1]
                what = (f"{label}, {fluid} {riemann} {recon} + {ns} scalars "
                        f"{str(dtype)[6:]}")
                for part, err in rows.items():
                    key = f"{label} [{part}]"
                    worst[key] = max(worst.get(key, 0.0), err)
                n_checks += 1
                if not ok:
                    failed.append(f"{what}: {rows}, scalar launches "
                                  f"{launched}")
                    log(f"  FAIL {what}: {rows} (tol {tol:.0e}), scalar "
                        f"launches {launched}")
                del got, ref, outs
            torch.cuda.empty_cache()
    for key, err in worst.items():
        log(f"  {key}: worst max rel err {err:.3e}")
    log(f"  {n_checks} checks ({len(SCALAR_CASES)} cases x 2 dtypes on each "
        f"of {len(layouts)} routes; fluid and scalar rows apart), "
        f"{len(failed)} failed; scalar-kernel launches {n_scalar}")
    if failed:
        raise AssertionError(f"kernel disagrees with plain with scalars: "
                             f"{failed[:10]}")
    return worst


def cooling_meter(sim):
    """Wrap the cooling's subcycling so that its host time (ending in a
    synchronise) accumulates in ``meter['s']``; its host reads count in
    ``TabularCooling.host_reads``."""
    cooling = sim.pkg.cooling if hasattr(sim, "pkg") else sim.cooling
    meter = {"s": 0.0}
    inner = cooling._subcycle

    def timed(*a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = inner(*a, **k)
        torch.cuda.synchronize()
        meter["s"] += time.perf_counter() - t0
        return out

    cooling._subcycle = timed
    return cooling, meter


def phase_cloud_uniform(rung, n, ncycles, warmup):
    """Path G': the cloud deck on a uniform mesh at level 1's resolution
    (one merged ghosted block), rk12 cooling, f32, on the default (sweep)
    or the stage rung; the host reads of the cooling loop per cycle and
    the loop's share of the cycle."""
    log(f"== phase 4: path G' (cloud, uniform {n}x{3 * n}x{n}, one ghosted "
        f"block, rk12 cooling, {rung} rung, f32, {warmup} warm-up + "
        f"{ncycles - warmup} timed cycles) ==")
    t0 = time.time()
    sim = make_sim(cloud_deck("none", n, n, ncycles, warmup, "single",
                              "rk12", ncycle_out=0), rung)
    if sim.mesh.nghost == 0 or sim.mesh.nblocks != 1 \
            or sim.cfg.nscalars != 1:
        raise AssertionError("path G' must run one ghosted block with a "
                             "scalar")
    cooling, meter = cooling_meter(sim)
    log(f"  set-up {time.time() - t0:.2f} s: block {sim.mesh.block_shape}, "
        f"dtype {sim.dtype}")
    PORT.sweep.negdiv_scalars_cuda.launches = 0
    PORT.stage.stage_scalars_cuda.launches = 0
    reads0 = cooling.host_reads
    t1 = time.time()
    n_sweep, n_stage, zcps = run_sim(sim)
    wall = time.time() - t1
    scal = (PORT.sweep.negdiv_scalars_cuda.launches,
            PORT.stage.stage_scalars_cuda.launches)
    cool = cooling_launches()
    reads = cooling.host_reads - reads0
    share = meter["s"] / wall
    log(f"  launches: sweep {n_sweep}, stage {n_stage}, scalar kernels "
        f"(negdiv, stage) {scal}, cooling (update, dt) {cool}; cooling "
        f"loop: {reads / ncycles:.1f} host "
        f"reads per cycle, {1e3 * meter['s'] / ncycles:.3f} ms per cycle "
        f"of the loop (synchronised), {100 * share:.1f} % of the run's "
        f"wall time ({wall:.3f} s for {ncycles} cycles); zone-cycles/"
        f"wallsecond {zcps}")
    want_stage = 2 * ncycles if rung == "stage" else 0
    want_sweep = 0 if rung == "stage" else 6 * ncycles
    finite = bool(torch.isfinite(sim.u).all())
    # the rk12 update is plain; the dt a cycle and the initial dt are not
    if (n_sweep, n_stage) != (want_sweep, want_stage) or zcps is None \
            or scal != (want_sweep, want_stage) or not finite \
            or cool != (0, ncycles + 1):
        raise AssertionError(f"path G' ({rung}): launches "
                             f"{(n_sweep, n_stage)}, scalar {scal}, cooling "
                             f"{cool}, finite {finite}")
    return sim, dict(zone_cycles_per_s=zcps, launches=n_sweep + n_stage,
                     scalar_launches=sum(scal),
                     cooling_launches=dict(update=cool[0], dt=cool[1]),
                     cooling_reads_per_cycle=reads / ncycles,
                     cooling_loop_ms_per_cycle=1e3 * meter["s"] / ncycles,
                     cooling_loop_share=share, cycles=ncycles)


def phase_cooling_passes(n, ncycles):
    """Why path G''s rk12 loop takes the passes it takes: path G''s deck
    in f32 (as the path runs) and in f64, sweep rung; the loop's passes
    per stage, host reads and time with the log off, then, with
    ``TabularCooling.pass_log`` on, the cells accepted and rejected per
    pass and the active cells' error estimates by bin, over the stages of
    the logged cycles."""
    log(f"== phase 4: path G''s cooling loop in f32 and f64 ({n}x{3 * n}x"
        f"{n}, rk12, sweep rung; 1 warm-up cycle, {ncycles} with the log "
        f"off, {ncycles} with it on) ==")
    names = PORT.PASS_COUNTS
    out = {}
    for precision in ("single", "double"):
        sim = make_sim(cloud_deck("none", n, n, 1, 0, precision, "rk12",
                                  ncycle_out=0))
        cooling, meter = cooling_meter(sim)
        sim.run()
        meter["s"], reads0 = 0.0, cooling.host_reads
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sim.nlim = 1 + ncycles
        sim.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        loop_s = meter["s"]
        reads = (cooling.host_reads - reads0) / ncycles
        # the log on, each stage's first pass marked
        starts, timed = [], cooling._subcycle

        def marked(*a, **k):
            starts.append(len(cooling.pass_log))
            return timed(*a, **k)

        cooling.pass_log, cooling._subcycle = [], marked
        sim.nlim = 1 + 2 * ncycles
        sim.run()
        rows = torch.stack(cooling.pass_log).cpu().numpy()
        cooling.pass_log, cooling._subcycle = None, timed
        passes = np.diff(starts + [len(rows)]).tolist()
        tot = dict(zip(names, rows.sum(axis=0).tolist()))
        cells = sim.u[:, 0].numel()
        act = max(tot["active"], 1)
        steps = (tot["accepted"] + tot["accepted_at_min_step"]) \
            / (cells * len(passes))
        hist = {k: tot[k] / act for k in names[4:]}
        first = rows[:passes[0]]
        shown = sorted(set(range(min(6, len(first))))
                       | set(range(0, len(first), 25)) | {len(first) - 1})
        log(f"  {precision}: {reads:.1f} host reads per cycle, the loop "
            f"{1e3 * loop_s / ncycles:.3f} ms per cycle, "
            f"{100 * loop_s / wall:.1f} % of the cycle "
            f"({1e3 * wall / ncycles:.3f} ms); passes per stage (log on) "
            f"{passes}")
        log(f"  {precision}: over {len(passes)} stages of {cells} cells: "
            f"{tot['active']} active cell-passes, accepted by the error test "
            f"{tot['accepted']}, accepted at the least step "
            f"{tot['accepted_at_min_step']}, rejected {tot['rejected']}; "
            f"accepted steps per cell and stage {steps:.3f}")
        log(f"  {precision}: active cell-passes by error estimate (d_e_tol "
            f"{cooling.d_e_tol:.0e}): " + ", ".join(
                f"{k} {v:.4f}" for k, v in hist.items()))
        log(f"  {precision}: the first stage's passes (pass: " + ", ".join(
            names[:4]) + "): " + "; ".join(
                f"{i}: {' '.join(str(int(x)) for x in first[i, :4])}"
                for i in shown))
        if not bool(torch.isfinite(sim.u).all()):
            raise AssertionError(f"path G' in {precision}: state not finite")
        out[precision] = dict(
            host_reads_per_cycle=reads,
            loop_ms_per_cycle=1e3 * loop_s / ncycles,
            loop_share=loop_s / wall, ms_per_cycle=1e3 * wall / ncycles,
            passes_per_stage=passes, totals=tot, error_bins=hist)
        del sim, cooling, rows
        torch.cuda.empty_cache()
    return out


def phase_cloud_adaptive(rung, n, ncycles, warmup):
    """Path G: the cloud deck adaptive (base {n}x{3n}x{n}, 16^3 blocks,
    numlevel 2), Townsend cooling, f32, on the default rung (#7) or the
    negdiv rung (#6/#2): zone-cycles/s over the timed window, remeshes, the
    leaves per cycle."""
    log(f"== phase 4: path G (cloud crushing, adaptive, base {n}x{3 * n}x"
        f"{n}, 16^3 blocks, numlevel 2, {rung} rung, f32, {warmup} warm-up "
        f"+ {ncycles - warmup} timed cycles) ==")
    t0 = time.time()
    sim = make_smr_sim(cloud_deck("adaptive", n, 16, warmup, 0, "single",
                                  "townsend"), rung)
    drv = sim.driver
    n_init = len(drv.remesh_log)
    leaves0 = leaves_of(sim)
    log(f"  set-up {time.time() - t0:.2f} s (initial refinement: {n_init} "
        f"remeshes): leaves {leaves0}")
    out = io.StringIO()
    torch.cuda.synchronize()
    reset_counts()
    with contextlib.redirect_stdout(out):
        sim.run()
        n_warm = len(drv.remesh_log)
        sim.nlim = ncycles
        sim.run()
    counts = read_face_counts() + read_counts()
    scal = (PORT.sweep.negdiv_scalars_cuda.launches,
            PORT.stage.stage_scalars_cuda.launches)
    cool = cooling_launches()
    text = out.getvalue()
    rates = re.findall(r"zone-cycles/wallsecond = (\S+)", text)
    per_cycle = [m.group(1) for m in
                 re.finditer(r"cycle=\d+ .*blocks=(\{[^}]*\})", text)]
    zcps = float(rates[-1]) if len(rates) == 2 else None
    face = counts[0] if rung == "stage" else counts[1]
    window = drv.remesh_log[n_warm:]
    changed = sum(e["changed"] for e in drv.remesh_log[n_init:])
    log(f"  leaves per cycle: {' '.join(per_cycle)}")
    log(f"  launches: face kernel {face} ({face / ncycles:.2f} per cycle), "
        f"all wrappers {counts}, scalar kernels (negdiv, stage) {scal}, "
        f"cooling (update, dt) {cool}; remesh checks in the window "
        f"{len(window)}, remeshes that changed the leaf table: "
        f"{sim.perf_remeshes} in the window, {changed} over "
        f"the run after the initial refinement; leaves at the end "
        f"{leaves_of(sim)}; zone-cycles/wallsecond over the window {zcps}")
    finite = all(bool(torch.isfinite(v).all()) for v in sim.state.values())
    # the levels a cycle holds change with the remeshes: each cycle takes
    # at least one update a stage and one dt
    if sim.ncycle != ncycles or zcps is None or face == 0 or not finite \
            or sum(scal) != face or cool[0] < 2 * ncycles \
            or cool[1] < ncycles:
        raise AssertionError(f"path G ({rung}): {sim.ncycle} cycles, "
                             f"launches {counts}, scalar {scal}, cooling "
                             f"{cool}, finite {finite}")
    return sim, dict(zone_cycles_per_s=zcps, cycles_timed=ncycles - warmup,
                     cycles=ncycles, launches=face,
                     scalar_launches=sum(scal),
                     cooling_launches=dict(update=cool[0], dt=cool[1]),
                     launches_per_cycle=face / ncycles,
                     remeshes_window=sim.perf_remeshes,
                     remeshes_run=changed, leaves_start=leaves0,
                     leaves_end=leaves_of(sim), leaves_per_cycle=per_cycle)


def phase_cloud_whole_steps():
    """Path G's deck in f64 at base 32x96x32 (16^3 blocks), 5 cycles
    through the kernels and with the plain versions (the faces' and the
    cooling's, which then launch nothing) forced, side by side:
    leaf tables equal, state and every step to STEP_TOL, on both rungs."""
    log("== phase 5: path G's deck, kernels against plain over whole steps "
        "(f64, base 32x96x32, 5 cycles) ==")
    stage, sweep = PORT.stage, PORT.sweep
    deck = cloud_deck("adaptive", 32, 16, 5, 0, "double", "townsend",
                      ncycle_out=0)
    for rung in ("stage", "negdiv"):
        sims = {name: make_smr_sim(deck, rung) for name in ("kernel",
                                                            "plain")}
        err_u, err_dt, launches = 0.0, 0.0, 0
        for k in range(1, 6):
            for name, sim in sims.items():
                sim.quiet = True
                dispatch = (sweep.fused_negdiv_faces, stage.fused_stage_faces)
                try:
                    if name == "plain":
                        sweep.fused_negdiv_faces = sweep.negdiv_faces_plain
                        stage.fused_stage_faces = stage.stage_faces_plain
                    sim.nlim = k
                    reset_counts()
                    with plain_cooling() if name == "plain" \
                            else contextlib.nullcontext():
                        sim.run()
                    counts = read_face_counts()
                    cool = cooling_launches()
                finally:
                    sweep.fused_negdiv_faces, stage.fused_stage_faces = \
                        dispatch
                if (sum(counts) == 0) != (name == "plain") \
                        or (min(cool) == 0) != (name == "plain") \
                        or (max(cool) == 0) != (name == "plain"):
                    raise AssertionError(f"path G f64 ({rung}): {name} run "
                                         f"launched {counts} and cooling "
                                         f"(update, dt) {cool}")
                launches += sum(counts)
            kern, plain = sims["kernel"], sims["plain"]
            if any(not np.array_equal(a, b) for a, b in
                   zip(table_of(kern), table_of(plain))):
                raise AssertionError(f"path G f64 ({rung}): leaf tables "
                                     f"differ after cycle {k}")
            for lev, u in plain.state.items():
                err_u = max(err_u, (kern.state[lev] - u).abs().max().item()
                            / u.abs().max().item())
            err_dt = max(err_dt, abs(kern.tm_dt - plain.tm_dt)
                         / plain.tm_dt, abs(kern.t - plain.t) / plain.t)
        log(f"  {rung} rung: state max rel err {err_u:.3e}, dt and t max "
            f"rel err {err_dt:.3e} over 5 cycles (tol {STEP_TOL:.0e}); leaf "
            f"tables equal every cycle ({leaves_of(sims['kernel'])}); "
            f"{launches} face launches")
        if not (err_u <= STEP_TOL and err_dt <= STEP_TOL):
            raise AssertionError(f"path G f64 ({rung}): kernel and plain "
                                 "disagree")
        del sims
        torch.cuda.empty_cache()


def phase_scalar_timings(sim, launches, reps):
    """The two scalar kernels at path G''s inputs (one merged block,
    128x384x128 + ghosts, f32): each against its plain twin from the same
    mass fluxes, timed per launch, with the bound from this call's bytes
    (the scalar rows, the density the stage converts by and the mass
    fluxes read once, the scalar rows written once) and the operations its
    data need; then the whole #1 and #3 calls with the scalar, per call."""
    log("== phase 6: the scalar kernels at path G''s inputs ==")
    sweep, stage = PORT.sweep, PORT.stage
    mesh, cfg, eos = sim.mesh, sim.cfg, sim.eos
    recon = cfg.reconstruction
    dt, dt_hyp = sim._estimate()
    c_h = sim.pkg.c_h_from_dt_hyp(dt_hyp)
    u = sim.u
    _, prim = sim.pkg.cons_to_prim(u)
    nb0, ns = sweep.scalar_base(cfg), cfg.nscalars
    cells = u.numel() // u.shape[1]
    elt = u.element_size()
    mf = {d: sweep.directional_flux(prim, c_h, d, mesh.dx[d - 1], cfg, eos,
                                    recon)[:, 0].contiguous()
          for d in (1, 2, 3)}
    entries = {}
    # negdiv_scalars: one launch per direction
    out = torch.zeros_like(prim)

    def kern_n():
        for d in (1, 2, 3):
            sweep.negdiv_scalars_cuda(prim, out, None, mf[d], d, mesh, cfg,
                                      recon, d > 1)
        return out[:, nb0:]

    def plain_n():
        nd = None
        for d in (1, 2, 3):
            x, _ = sweep.negdiv_scalars_plain(prim, mf[d], d, mesh, cfg,
                                              recon)
            nd = x if nd is None else nd + x
        return nd

    u_new = torch.empty_like(u)

    def kern_s():
        stage.stage_scalars_cuda(u, u, u_new, None, None, mf, 0.0, 1.0, dt,
                                 mesh, cfg, eos, recon)
        return u_new[:, nb0:]

    def plain_s():
        return stage.stage_scalars_plain(u, u, mf, 0.0, 1.0, dt, mesh, cfg,
                                         eos, recon)[0]

    for name, kern, plain, nl, nbytes, src in (
            ("negdiv_scalars", kern_n, plain_n, 3,
             (2 * ns + 3) * cells * elt, "negdiv_sweep.cu"),
            ("stage_scalars", kern_s, plain_s, 1,
             (3 * ns + 4) * cells * elt, "fused_stage.cu")):
        got, ref = kern(), plain()
        torch.cuda.synchronize()
        abs_err = (got - ref).abs().max().item()
        rel = max_rel_err(got, ref)
        if not (rel <= F32_TOL and bool(torch.isfinite(got).all())):
            raise AssertionError(f"{name} disagrees with its plain twin at "
                                 f"path G''s inputs: {rel:.3e}")
        before = (sweep.negdiv_scalars_cuda.launches,
                  stage.stage_scalars_cuda.launches)
        ms = cuda_ms(kern, reps)
        plain_ms = cuda_ms(plain, 2)
        lib_ms = None
        ops, slow, _ = count_ops(plain)
        torch.cuda.empty_cache()
        b = bound_of(nbytes / nl, ops / nl, ms / nl)
        log(f"  {name}: {ms / nl:.4f} ms per launch ({nl} per call), plain "
            f"{plain_ms:.4f} ms per call; bound {b['bound_ms']:.4f} ms "
            f"({b['bound_by']}: {nbytes / nl / 1e6:.1f} MB, "
            f"{ops / nl / cells:.1f} operations per cell); "
            f"{100 * b['share_of_bound']:.2f} % of the bound; max abs err "
            f"{abs_err:.3e} (rel {rel:.3e})")
        del got, ref
        sweep.negdiv_scalars_cuda.launches, \
            stage.stage_scalars_cuda.launches = before
        entries[name] = dict(
            name=name, route="cuda",
            source=f"athenapk_tpu_torch/csrc/{src}",
            replaces=("athenapk_tpu/solver/pallas_sweep.py:55 (the scalar "
                      "fluxes every sweep body appends: solve_riemann(..., "
                      "nscalars), riemann/solvers.py:63-69)"
                      if name == "negdiv_scalars" else
                      "athenapk_tpu/solver/pallas_sweep.py:250 (the scalar "
                      "rows of the whole-stage bodies: cons_to_prim(..., "
                      "nscalars) and their fluxes, :684)"),
            launches=launches[name], max_abs_err=abs_err, ms=ms / nl,
            plain_ms=plain_ms, library_ms=lib_ms, unit="ms per launch",
            inputs="path G' (cloud, uniform 128x384x128 + ghosts, f32, 1 "
                   "scalar)", **b)
    # the whole calls with the scalar (fluid and scalar launches)
    for name, kern, plain in (
            ("#1 negdiv_cuda with 1 scalar",
             lambda: sweep.negdiv_cuda(prim, c_h, mesh, cfg, eos, recon),
             lambda: sweep.negdiv_plain(prim, c_h, mesh, cfg, eos, recon)),
            ("#3 stage_cuda with 1 scalar",
             lambda: stage.stage_cuda(u, u, 0.0, 1.0, dt, c_h, mesh, cfg,
                                      eos, recon),
             lambda: stage.stage_plain(u, u, 0.0, 1.0, dt, c_h, mesh, cfg,
                                       eos, recon))):
        got, ref = kern(), plain()
        torch.cuda.synchronize()
        sl = mesh.interior_slices
        rel = max_rel_err(got[sl], ref[sl])
        if not rel <= F32_TOL:
            raise AssertionError(f"{name} disagrees with plain: {rel:.3e}")
        del got, ref
        ms = cuda_ms(kern, reps)
        plain_ms = cuda_ms(plain, 2)
        nbytes = (2 if name.startswith("#1") else 3) * u.numel() * elt
        b = bound_of(nbytes, 0.0, ms)
        log(f"  {name}: {ms:.4f} ms per call, plain {plain_ms:.4f} ms; the "
            f"bytes alone bound it at {b['bytes_ms']:.4f} ms "
            f"({u.shape[1]} variables); max rel err {rel:.3e}")
        entries[name] = dict(ms_per_call=ms, plain_ms=plain_ms,
                             bytes_ms=b["bytes_ms"], max_rel_err=rel)
        torch.cuda.empty_cache()
    return entries


# ------------------------------------ diffusion and split sources
# The decks are tests/torch_decks.py's (PORT.decks): the diffusive linear
# wave of tests/test_diffusion_linwave3d.py (path H), the turbulence deck
# with 30 modes from make_random_modes (paths I and I'), the rand_blast
# deck.  Path H's size keeps the deck's 2:1:1 aspect.
PATH_H_SIZE = (384, 192, 192)
TURB_MODES = 30


def timed_deck(deck, warmup):
    """``deck`` with ``perf_cycle_offset = warmup`` in its time block and
    its ``.hst`` output at dt = 0.03 (the interval of the reference suite's
    diffusive-wave deck; the timed cycles write none, where the tests'
    decks write a row, ~15 reductions and host reads, every cycle)."""
    return deck.replace("ncycle_out = 0", "ncycle_out = 0\nperf_cycle_offset "
                        f"= {warmup}").replace("file_type = hst",
                                               "file_type = hst\ndt = 0.03")


@contextlib.contextmanager
def host_reads(counter):
    """Count the tensor reads to the host (``item``, ``tolist``, ``cpu``,
    ``numpy``, ``float``, ``int``, ``bool``) made inside the block into
    ``counter['reads']``."""
    names = ("item", "tolist", "cpu", "numpy", "__float__", "__int__",
             "__bool__")
    saved = {n: getattr(torch.Tensor, n) for n in names}

    def counting(fn):
        def call(self, *a, **k):
            if self.is_cuda:
                counter["reads"] += 1
            return fn(self, *a, **k)
        return call

    for n in names:
        setattr(torch.Tensor, n, counting(saved[n]))
    try:
        yield counter
    finally:
        for n, fn in saved.items():
            setattr(torch.Tensor, n, fn)


def wrap_calls(ranges, make):
    """Replace each ``obj.attr`` of ``ranges`` (``(obj, attr, label)``) by
    ``make(fn, label)``; -> the function that undoes every wrap."""
    undo = []
    for obj, attr, label in ranges:
        inner = getattr(obj, attr)
        own = attr in vars(obj)
        setattr(obj, attr, make(inner, label))
        undo.append((lambda o=obj, a=attr, f=inner: setattr(o, a, f)) if own
                    else (lambda o=obj, a=attr: delattr(o, a)))
    return lambda: [fn() for fn in reversed(undo)]


def run_more(sim, ncycles):
    """``ncycles`` more cycles of ``sim.run()``, its output dropped."""
    sim.nlim = sim.ncycle + ncycles
    quiet = sim.quiet
    sim.quiet = True
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            sim.run()
    finally:
        sim.quiet = quiet


def phase_host_reads(sim, ncycles, what, ranges):
    """Host reads over ``ncycles`` more cycles of ``sim.run()``: those of
    the whole run (its opening dt estimate and closing output included) per
    cycle, and per call those made inside each ``(obj, attr, label)`` of
    ``ranges`` (a nested range counts in each), with the calls per cycle.
    A run of its own after the timed one: the count hooks the tensor
    methods that read the host, and nothing is timed here.  -> ``({"run":
    reads per cycle, label: reads per call}, {label: calls per cycle})``."""
    total = {"reads": 0}
    inside = {label: {"reads": 0, "calls": 0} for _, _, label in ranges}

    def counting(fn, label):
        def call(*a, **k):
            n0 = total["reads"]
            try:
                return fn(*a, **k)
            finally:
                inside[label]["reads"] += total["reads"] - n0
                inside[label]["calls"] += 1
        return call

    undo = wrap_calls(ranges, counting)
    try:
        with host_reads(total):
            run_more(sim, ncycles)
    finally:
        undo()
    out = {"run": total["reads"] / ncycles}
    out.update({label: v["reads"] / max(v["calls"], 1)
                for label, v in inside.items()})
    calls = {label: v["calls"] / ncycles for label, v in inside.items()}
    log(f"  host reads of {what} over {ncycles} more cycles (counted, not "
        f"timed): the run's per cycle {out['run']:.2f}; per call " + ", ".join(
            f"{k} {v:.2f}" for k, v in out.items() if k != "run")
        + "; calls per cycle " + ", ".join(
            f"{k} {v:.2f}" for k, v in calls.items()))
    return out, calls


def loop_ranges(sim):
    """The parts of a uniform cycle whose host reads are counted: the
    fused step (which returns the next dt), or the split cycle and the dt
    estimate after it; and the outputs."""
    return [(sim.pkg, "step_with_dt", "step"), (sim, "_cycle", "cycle"),
            (sim, "_estimate", "dt estimate"),
            (sim, "_do_outputs", "outputs")]


def cycle_reads(reads, calls, what):
    """The reads of one uniform cycle from ``phase_host_reads``'s counts:
    the fused step's, or the split cycle's and its dt estimate's (the run's
    opening estimate and its outputs are not the cycle's)."""
    split = calls["cycle"] > 0
    n = reads["step"] * calls["step"] + reads["cycle"] * calls["cycle"] \
        + (reads["dt estimate"] if split else 0.0)
    log(f"  host reads per cycle of {what}: {n:.2f} ("
        + (f"the cycle {reads['cycle']:.2f}, the dt estimate "
           f"{reads['dt estimate']:.2f})" if split
           else f"the fused step {reads['step']:.2f})"))
    return n


def phase_diffusion_path(integrator, rung, nx, ncycles, warmup):
    """Path H: the GLM-MHD linear wave with conduction, viscosity and Ohmic
    resistivity (HLLD + PLM + VL2) at ``nx`` in one merged ghost-free block,
    f32, on the sweep or the stage rung, unsplit or RKL2.  The timed run
    carries no meter; the RKL2 stages are the package's own count."""
    log(f"== phase 4: path H ({integrator} diffusion, {nx[0]}x{nx[1]}x"
        f"{nx[2]} ghost-free, {rung} rung, f32, {warmup} warm-up + "
        f"{ncycles - warmup} timed cycles) ==")
    t0 = time.time()
    sim = make_sim(timed_deck(PORT.decks.linwave3d_deck(
        nx=nx, integrator=integrator, nlim=ncycles, precision="single"),
        warmup), rung)
    if sim.mesh.nghost != 0 or sim.mesh.nblocks != 1:
        raise AssertionError("path H must run one ghost-free block")
    dt, dt_hyp = sim._estimate()
    ratio = dt_hyp / sim.dt_diff
    # the stage count the code takes for the first super-step
    s_half = PORT.rkl2_stage_count(0.5 * dt, sim.dt_diff) \
        if sim.pkg.sts else None
    log(f"  set-up {time.time() - t0:.2f} s: dt_hyp {dt_hyp:.6e}, dt_diff "
        f"{sim.dt_diff:.6e}, dt_hyp / dt_diff {ratio:.4f}, dt {dt:.6e}; "
        f"RKL2 stages per half step reckoned from them: {s_half}")
    pkg = sim.pkg
    stages0 = pkg.rkl2_stages
    n_sweep, n_stage, zcps = run_sim(sim)
    stages = pkg.rkl2_stages - stages0
    want = tuple(k * ncycles for k in RUNG_LAUNCHES[rung])
    finite = bool(torch.isfinite(sim.u).all())
    log(f"  launches: sweep {n_sweep}, stage {n_stage} (expected {want}); "
        f"RKL2 stages {stages / ncycles:.2f} per cycle; "
        f"zone-cycles/wallsecond {zcps}")
    if (n_sweep, n_stage) != want or zcps is None or not finite \
            or (stages > 0) != pkg.sts:
        raise AssertionError(f"path H ({integrator}, {rung}): launches "
                             f"{(n_sweep, n_stage)}, stages {stages}, "
                             f"finite {finite}")
    return sim, dict(zone_cycles_per_s=zcps, launches=n_sweep + n_stage,
                     launches_per_cycle=(n_sweep + n_stage) / ncycles,
                     dt_hyp_over_dt_diff=ratio,
                     rkl2_stages_per_cycle=stages / ncycles,
                     rkl2_stages_per_half_step_reckoned=s_half,
                     cycles=ncycles)


def diffusion_ranges(sim):
    """Path H's profiler range: the RKL2 half step, or the unsplit
    diffusion's -div(F_diff)."""
    pkg = sim.pkg
    return [(pkg, "sts_half_step" if pkg.sts else "_diff_negdiv",
             "diffusion")]


def forcing_ranges(src, ou):
    """The forcing's profiler ranges: the whole source call ``src`` and,
    inside it, the ``FewModesFT`` ``ou``'s host draws and transform (the
    rest of the forcing is its reductions and kicks)."""
    return [(*src, "forcing"), (ou, "update_var_hat", "forcing.draws"),
            (ou, "inverse_transform", "forcing.transform")]


def phase_turbulence_path(rung, n, ncycles, warmup):
    """Path I: driven GLM-MHD turbulence (HLLD + PLM + VL2, 30 modes) at
    ``n``^3 in one ghost-free block, f32.  The timed run carries no meter
    (the forcing's share is phase 7's, its host reads a counted run's)."""
    log(f"== phase 4: path I (turbulence {n}^3, {TURB_MODES} modes, "
        f"ghost-free, {rung} rung, f32, {warmup} warm-up + "
        f"{ncycles - warmup} timed cycles) ==")
    t0 = time.time()
    sim = make_sim(timed_deck(PORT.decks.turbulence_deck(
        n=n, nlim=ncycles, num_modes=TURB_MODES, precision="single"),
        warmup), rung)
    if sim.mesh.nghost != 0 or sim.src_first_order is None:
        raise AssertionError("path I must run ghost-free with its driving")
    log(f"  set-up {time.time() - t0:.2f} s: block {sim.mesh.block_shape}, "
        f"dtype {sim.dtype}")
    n_sweep, n_stage, zcps = run_sim(sim)
    want = tuple(k * ncycles for k in RUNG_LAUNCHES[rung])
    finite = bool(torch.isfinite(sim.u).all())
    log(f"  launches: sweep {n_sweep}, stage {n_stage} (expected {want}); "
        f"zone-cycles/wallsecond {zcps}")
    if (n_sweep, n_stage) != want or zcps is None or not finite:
        raise AssertionError(f"path I ({rung}): launches "
                             f"{(n_sweep, n_stage)}, finite {finite}")
    return sim, dict(zone_cycles_per_s=zcps, launches=n_sweep + n_stage,
                     launches_per_cycle=(n_sweep + n_stage) / ncycles,
                     cycles=ncycles)


def phase_turbulence_smr_path(rung, n, ncycles, warmup):
    """Path I': the turbulence deck on a static refined mesh, base ``n``^3
    with 16^3 blocks and the octant x, y, z < 0.5 at level 1, through the
    turbulence's ``_smr`` hook, on the stage-faces (#7) or the negdiv-faces
    (#6/#2) rung, f32; the timed run carries no meter."""
    log(f"== phase 4: path I' (turbulence, base {n}^3, 16^3 blocks, octant "
        f"at level 1, {rung} rung, f32, {warmup} warm-up + "
        f"{ncycles - warmup} timed cycles) ==")
    t0 = time.time()
    sim = make_smr_sim(timed_deck(PORT.decks.turbulence_deck(
        n=n, mb=16, nlim=warmup, num_modes=TURB_MODES, precision="single",
        refinement="static"), 0), rung)
    st = sim._stepper_now()
    if st.problem_source_first_order is None or not sim._split_loop():
        raise AssertionError("path I' must run the split loop with its "
                             "driving")
    leaves = leaves_of(sim)
    log(f"  set-up {time.time() - t0:.2f} s: leaves {leaves}")
    m0 = sim.total_mass()
    (n_stage_f, n_negdiv_f, n_sweep, n_stage), zcps = run_smr(
        sim, ncycles, warmup)
    finite = all(bool(torch.isfinite(v).all()) for v in sim.state.values())
    drift = abs(sim.total_mass() - m0) / m0
    per_cycle = {"stage": (2 * len(leaves), 0),
                 "negdiv": (0, 6 * len(leaves))}[rung]
    want = tuple(k * ncycles for k in per_cycle)
    log(f"  launches: stage-faces {n_stage_f}, negdiv-faces {n_negdiv_f} "
        f"(expected {want}); mass drift {drift:.3e} (f32); "
        f"zone-cycles/wallsecond {zcps}")
    if (n_stage_f, n_negdiv_f) != want or (n_sweep, n_stage) != (0, 0) \
            or zcps is None or not finite or not drift <= 1e-5:
        raise AssertionError(f"path I' ({rung}): launches "
                             f"{(n_stage_f, n_negdiv_f)}, finite {finite}, "
                             f"drift {drift}")
    return sim, dict(zone_cycles_per_s=zcps, leaves=leaves,
                     launches=n_stage_f + n_negdiv_f,
                     launches_per_cycle=(n_stage_f + n_negdiv_f) / ncycles,
                     cycles=ncycles)


@checked_profile
def phase_split_profile(sim, ncycles, what, ranges):
    """Where a cycle of a deck with diffusion or split sources goes: a
    torch.profiler trace of ``ncycles`` more cycles of ``sim.run()`` with a
    profiler range around each ``(obj, attr, label)`` of ``ranges``; the
    port's kernels, the plain kernels launched inside each range (a kernel
    counts in the innermost range open at its launch), the rest, each
    top-level range's share of the device time with its nested ones, host
    ms per range and the device's idle share."""
    log(f"== phase 7: device-time breakdown of {ncycles} cycles of {what} ==")
    from torch.profiler import ProfilerActivity, profile, record_function

    def ranged(fn, label):
        def call(*a, **k):
            with record_function(label):
                return fn(*a, **k)
        return call

    undo = wrap_calls(ranges, ranged)
    n0 = all_launches()
    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run_more(sim, ncycles)
            torch.cuda.synchronize()
    finally:
        undo()
    trace = ROOT / "build" / "chip_smoke" / "trace_split.json"
    trace.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(trace))
    events = json.loads(trace.read_text())["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    if not kernels:
        log("  the profiler recorded no device kernels: not measured")
        return None
    check_trace(kernels, all_launches() - n0)
    labels = {label for _, _, label in ranges}
    spans = [e for e in events if e.get("cat") == "user_annotation"
             and e.get("name") in labels]
    host = {}
    for e in spans:
        host[e["name"]] = host.get(e["name"], 0.0) + e["dur"] / 1e3
    launched = {e["args"]["correlation"]: e["ts"] for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "correlation" in e.get("args", {})}
    groups, count = {}, {}
    top = {}
    for e in kernels:
        ts = launched.get(e.get("args", {}).get("correlation"))
        inside = [a for a in spans if ts is not None
                  and a["ts"] <= ts <= a["ts"] + a["dur"]]
        if PORT_KERNEL.search(e["name"]):
            key = "kernels of the port"
        elif inside:
            # the innermost range
            key = min(inside, key=lambda a: a["dur"])["name"] \
                + " (plain PyTorch)"
        else:
            key = "other kernels (plain PyTorch)"
        for name in {a["name"].split(".")[0] for a in inside}:
            top[name] = top.get(name, 0.0) + e["dur"] / 1e3
        groups[key] = groups.get(key, 0.0) + e["dur"] / 1e3
        count[key] = count.get(key, 0) + 1
    busy = sum(e["dur"] for e in kernels) / 1e3
    t0 = min(e["ts"] for e in kernels)
    t1 = max(e["ts"] + e["dur"] for e in kernels)
    window = (t1 - t0) / 1e3
    for key in sorted(groups, key=groups.get, reverse=True):
        log(f"  {key:40s} {groups[key] / ncycles:9.4f} ms/cycle "
            f"({100 * groups[key] / busy:5.1f} % of device time, "
            f"{count[key] / ncycles:.0f} kernels/cycle)")
    for name, ms in sorted(top.items()):
        log(f"  {name} with its nested ranges: {ms / ncycles:.4f} ms/cycle "
            f"of device time ({100 * ms / busy:.1f} % of device time, "
            f"{100 * ms / window:.1f} % of the window)")
    for name, ms in sorted(host.items()):
        log(f"  host time in {name}: {ms / ncycles:.4f} ms/cycle")
    idle = max(0.0, 1.0 - busy / window)
    log(f"  device busy {busy / ncycles:.4f} ms/cycle over a "
        f"{window / ncycles:.4f} ms/cycle window: idle share {idle:.3f}")
    return {"ms_per_cycle": {k: v / ncycles for k, v in groups.items()},
            "kernels_per_cycle": {k: v / ncycles for k, v in count.items()},
            "host_ms_per_cycle": {k: v / ncycles for k, v in host.items()},
            "share_of_device_time": {k: v / busy for k, v in top.items()},
            "share_of_window": {k: v / window for k, v in top.items()},
            "range_ms_per_cycle": {k: v / ncycles for k, v in top.items()},
            "busy_ms_per_cycle": busy / ncycles,
            "window_ms_per_cycle": window / ncycles, "idle_share": idle}


def phase_stage_prim_at_path_h(sim, what="path H"):
    """The stage kernel with ``emit_prim`` (the prim of the unsplit
    diffusion, or of the problem's unsplit source) at ``what``'s own state
    against its plain version, in f32 and f64."""
    log(f"== phase 3: the stage kernel with emit_prim at {what}'s inputs ==")
    stage = PORT.stage
    recon = sim.cfg.reconstruction
    c_h = sim.pkg.c_h_from_dt_hyp(sim._estimate()[1])
    out = {}
    for dtype, tol in TOLS:
        u = sim.u.to(dtype)
        args = (u, u, 0.5, 0.5, 1e-3, c_h, sim.mesh, sim.cfg, sim.eos,
                recon)
        got = stage.stage_cuda(*args, emit_prim=True)
        torch.cuda.synchronize()
        ref = stage.stage_plain(*args, emit_prim=True)
        err = max(max_rel_err(got[0], ref[0]), max_rel_err(got[1], ref[1]))
        name = str(dtype)[6:]
        log(f"  GLM-MHD HLLD {recon} +prim {name} at {tuple(u.shape)}: max "
            f"rel err {err:.3e} (tol {tol:.0e})")
        if not err <= tol:
            raise AssertionError(f"stage +prim at {what}'s inputs ({name}) "
                                 f"disagrees with plain: {err}")
        out[name] = err
        del got, ref, u
        torch.cuda.empty_cache()
    return out


def phase_source_paths(zcps):
    """Paths H (both integrators, both rungs), I (both rungs) and I' (both
    rungs): each timed run carries no meter; after it, its kernels against
    plain at the run's final state (f32 and the same arrays in f64), phase
    7's breakdown and a counted run of the host reads.  Adds each path's
    zone-cycles/s to ``zcps``; -> ``(path_h, path_i, path_i2, the stage
    kernel with emit_prim at path H's state)``."""
    path_h, path_i, path_i2 = {}, {}, {}
    stage_prim_h = None
    for integ in ("unsplit", "rkl2"):
        for rung in ("sweep", "stage"):
            sim, num = phase_diffusion_path(integ, rung, PATH_H_SIZE,
                                            ncycles=8, warmup=2)
            name = f"path H ({integ} diffusion, {rung} rung)"
            if (integ, rung) == ("unsplit", "stage"):
                # the stage as this run calls it: with emit_prim
                stage_prim_h = phase_stage_prim_at_path_h(sim)
            else:
                log(f"== phase 6: the kernel against plain at the final "
                    f"state of {name} ==")
                num["kernel_vs_plain"] = phase_case_timings({name: {
                    "sim": sim, "rung": rung, "launches": num["launches"],
                    "cycles": num["cycles"],
                    "zcps": num["zone_cycles_per_s"]}}, 5, f64=True)[name]
            ranges = diffusion_ranges(sim)
            num["profile"] = phase_split_profile(sim, 3, name, ranges)
            num["host_reads"], calls = phase_host_reads(
                sim, 2, name, ranges + loop_ranges(sim))
            num["host_reads_per_cycle"] = cycle_reads(num["host_reads"],
                                                      calls, name)
            if calls["diffusion"] != 2:
                raise AssertionError(f"{name}: the diffusion ran {calls} "
                                     "times per cycle (2 stages or 2 half "
                                     "steps)")
            path_h[integ, rung] = num
            zcps[f"path_H {integ} {rung}"] = num["zone_cycles_per_s"]
            del sim, ranges
            torch.cuda.empty_cache()
    for rung in ("sweep", "stage"):
        sim, num = phase_turbulence_path(rung, n=256, ncycles=12, warmup=2)
        name = f"path I (turbulence 256^3, {rung} rung)"
        log(f"== phase 6: the kernel against plain at the final state of "
            f"{name} ==")
        num["kernel_vs_plain"] = phase_case_timings({name: {
            "sim": sim, "rung": rung, "launches": num["launches"],
            "cycles": num["cycles"],
            "zcps": num["zone_cycles_per_s"]}}, 5, f64=True)[name]
        ranges = forcing_ranges((sim, "src_first_order"),
                                sim.pgen.forcing_driver(sim.pin, sim.mesh))
        num["profile"] = phase_split_profile(sim, 3, name, ranges)
        num["host_reads"], calls = phase_host_reads(
            sim, 2, name, ranges + loop_ranges(sim))
        num["host_reads_per_cycle"] = cycle_reads(num["host_reads"], calls,
                                                  name)
        if calls["forcing"] != 1:
            raise AssertionError(f"{name}: the forcing ran {calls} times "
                                 "per cycle")
        path_i[rung] = num
        zcps[f"path_I {rung}"] = num["zone_cycles_per_s"]
        del sim, ranges
        torch.cuda.empty_cache()
    for rung in ("stage", "negdiv"):
        sim, num = phase_turbulence_smr_path(rung, n=128, ncycles=12,
                                             warmup=2)
        kind, kname, line = {
            "stage": ("stage-faces", "fused_stage_faces", 641),
            "negdiv": ("negdiv-faces", "negdiv_sweep_faces", 525)}[rung]
        phase_smr_kernels_vs_plain(sim, "I'", kind)
        row = phase_smr_timings(
            sim, kind, num["launches"], 10, kname,
            f"athenapk_tpu/solver/pallas_sweep.py:{line}",
            f"path I' ({rung} rung)")
        num["kernel_vs_plain"] = {k: row[k] for k in (
            "ms", "plain_ms", "bound_ms", "share_of_bound", "bound_by",
            "max_abs_err", "unit", "per_call")}
        st = sim._stepper_now()
        ranges = forcing_ranges(
            (st, "problem_source_first_order"),
            sim.pgen.forcing_driver_smr(sim.pin, sim._smesh_now())._ou) \
            + [(st.state_mgr, "fill_ghosts", "smr.fill")]
        name = f"path I' ({rung} rung)"
        num["profile"] = phase_split_profile(sim, 3, name, ranges)
        num["host_reads"], calls = phase_host_reads(sim, 2, name, ranges)
        num["host_reads_per_cycle"] = num["host_reads"]["run"]
        if calls["forcing"] != 1:
            raise AssertionError(f"{name}: the forcing ran {calls} times "
                                 "per cycle")
        path_i2[rung] = num
        zcps[f"path_I' {rung}"] = num["zone_cycles_per_s"]
        del sim, st, ranges
        torch.cuda.empty_cache()
    return path_h, path_i, path_i2, stage_prim_h


def source_whole_step_cases():
    """(label, deck, refined, rung) of phase 5's new decks, f64, 5 cycles."""
    d = PORT.decks
    region = (0.0, 1.5, 0.0, 1.5, 0.0, 1.5)
    cases = []
    for integ in ("unsplit", "rkl2"):
        for rung in ("sweep", "stage"):
            cases.append((f"H-{integ} 64x32x32, {rung} rung",
                          d.linwave3d_deck(nx=(64, 32, 32), integrator=integ),
                          False, rung))
        cases.append((f"refined diffusion ({integ}), 64x32x32 base, "
                      "stage rung", d.linwave3d_deck(
                          nx=(64, 32, 32), mb=(16, 16, 16), integrator=integ,
                          refinement="static", region=region), True, "stage"))
    cases.append(("refined diffusion (unsplit), negdiv rung",
                  d.linwave3d_deck(nx=(64, 32, 32), mb=(16, 16, 16),
                                   refinement="static", region=region),
                  True, "negdiv"))
    for rung in ("sweep", "stage"):
        cases.append((f"I 64^3, {rung} rung", d.turbulence_deck(
            n=64, num_modes=TURB_MODES), False, rung))
    for rung in ("stage", "negdiv"):
        cases.append((f"I' base 32^3, {rung} rung", d.turbulence_deck(
            n=32, mb=16, num_modes=TURB_MODES, refinement="static"), True,
            rung))
    cases.append(("rand_blast 128^3, FOFC (blast 1 fires)",
                  d.rand_blast_deck(n=128, nlim=5, tlim=0.01, fofc="true"),
                  False, "sweep"))
    return cases


def phase_source_whole_steps(cases=None, what="the diffusion and source "
                             "decks"):
    """Phase 5's diffusion and source decks (or ``cases``, as
    ``source_whole_step_cases`` gives them): 5 f64 cycles through the
    kernels and with every kernel's plain version forced (the fluid's, the
    EOS's and the cooling's, none of which may launch); state and every
    dt to STEP_TOL, the same RKL2 stage counts (and FOFC rescues), mass
    across levels to 1e-13 on refined meshes (where the problem injects
    mass, the kernel run's change of mass to STEP_TOL of the plain run's).
    Each run builds its own ``ParameterInput``, so the turbulence runs draw
    the same randoms."""
    log(f"== phase 5: {what}, kernels against plain over whole steps (f64, "
        "5 cycles) ==")
    sweep, stage, eos = PORT.sweep, PORT.stage, PORT.adiabatic_cuda
    names = ("fused_negdiv", "fused_negdiv_faces")
    snames = ("fused_stage", "fused_stage_faces")
    plain = {"fused_negdiv": sweep.negdiv_plain,
             "fused_negdiv_faces": sweep.negdiv_faces_plain,
             "fused_stage": stage.stage_plain,
             "fused_stage_faces": stage.stage_faces_plain}
    worst = {}
    for label, deck, refined, rung in cases or source_whole_step_cases():
        runs = {}
        for name in ("kernel", "plain"):
            outdir = ROOT / "build" / "chip_smoke" / f"s8_{name}"
            outdir.mkdir(parents=True, exist_ok=True)
            for old in outdir.glob("*.hst"):
                old.unlink()
            saved = {n: getattr(sweep, n) for n in names}
            saved.update({n: getattr(stage, n) for n in snames})
            saved_eos = eos.fused_cons_to_prim
            cwd = os.getcwd()
            os.chdir(outdir)
            try:
                sim = make_smr_sim(deck, rung) if refined \
                    else make_sim(deck, rung)
                sim.quiet = True
                m0 = sim.total_mass() if refined else None
                if name == "plain":
                    for n in names:
                        setattr(sweep, n, plain[n])
                    for n in snames:
                        setattr(stage, n, plain[n])
                    eos.fused_cons_to_prim = PORT.adiabatic.cons_to_prim
                reset_counts()
                with contextlib.redirect_stdout(io.StringIO()), (
                        plain_cooling() if name == "plain"
                        else contextlib.nullcontext()):
                    sim.run()
                counts = read_counts() + read_face_counts()
                n_eos = eos_launches()
                n_cool = cooling_launches()
            finally:
                for n in names:
                    setattr(sweep, n, saved[n])
                for n in snames:
                    setattr(stage, n, saved[n])
                eos.fused_cons_to_prim = saved_eos
                os.chdir(cwd)
            # the kernel run takes the cooling kernels where the deck cools
            # (an update a stage, a dt a cycle), the plain run none
            cools = name == "kernel" and "enable_cooling = tabular" in deck
            if (sum(counts) == 0) != (name == "plain") \
                    or (name == "plain" and n_eos) \
                    or (min(n_cool) > 0) != cools \
                    or (max(n_cool) > 0) != cools:
                raise AssertionError(f"{label}: {name} run launched {counts}"
                                     f", {n_eos} EOS kernels and {n_cool} "
                                     f"cooling kernels (update, dt)")
            if refined:
                st = sim._stepper_now()
                state = {lev: v.cpu().numpy() for lev, v in sim.state.items()}
                extra = (st.rkl2_stages, st.fofc_rescues)
                drift = abs(sim.total_mass() - m0) / m0
            else:
                state = {0: sim.u.cpu().numpy()}
                extra = (sim.pkg.rkl2_stages, sim.pkg.fofc_rescues)
                drift = 0.0
            runs[name] = (state, np.loadtxt(next(outdir.glob("*.hst"))),
                          extra, drift, sum(counts), sim.ncycle, n_cool)
            if "rand_blast" in label and not sim.t > 0.00125:
                raise AssertionError(f"{label}: t = {sim.t}, the window "
                                     "holds no blast")
        (uk, hk, ek, dk, nk, ck, nc), (up, hp, ep, dp, _, cp, _) = \
            runs["kernel"], runs["plain"]
        err_u = max(float(np.abs(uk[lev] - up[lev]).max()
                          / np.abs(up[lev]).max()) for lev in up)
        err_dt = float(np.abs(hk[:, 1] - hp[:, 1]).max()
                       / np.abs(hp[:, 1]).max())
        worst[label] = dict(state=err_u, dt=err_dt, launches=nk,
                            cooling_launches=dict(update=nc[0], dt=nc[1]),
                            rkl2_stages=ek[0], rescues=ek[1],
                            mass_drift=dk)
        log(f"  {label:48s} state {err_u:.3e}, dt {err_dt:.3e} (tol "
            f"{STEP_TOL:.0e}); launches {nk}, cooling (update, dt) {nc}; "
            f"RKL2 stages {ek[0]} / {ep[0]}, rescues {ek[1]} / {ep[1]} "
            f"(kernels / plain); mass drift {dk:.3e}")
        injects = "problem_id = cluster" in deck
        drift_ok = (abs(dk - dp) <= STEP_TOL * dp) if injects \
            else dk <= 1e-13
        if not (err_u <= STEP_TOL and err_dt <= STEP_TOL and ek == ep
                and hk.shape == hp.shape and ck == cp == 5 and drift_ok):
            raise AssertionError(f"{label}: kernel and plain steps disagree")
    return worst


# ------------------------------------------------- tracers and the restart
# tracers per cell on paths J and J' (the reference's turb_with_tracers.in
# is not in the repository: this density is the port's own choice)
TRACER_DENSITY = 0.125
OUT = ROOT / "build" / "chip_smoke"


@contextlib.contextmanager
def in_dir(path):
    """The block with ``path`` (made) as the working directory: the runs
    write their ``.hst`` rows and ``correlations.csv`` there."""
    path.mkdir(parents=True, exist_ok=True)
    cwd = os.getcwd()
    os.chdir(path)
    try:
        yield path
    finally:
        os.chdir(cwd)


def with_tracers(deck, seed=0, capacity_factor=2.0):
    """``deck`` with ``TRACER_DENSITY`` tracers per cell.  An adaptive deck
    takes ``capacity_factor = 16``: a leaf's buffer is sized at seeding,
    and a derefined parent receives its eight children's tracers (seeded
    at eight times the coarse density), which would overflow the default
    headroom and count as lost."""
    return deck + PORT.decks.tracer_block(TRACER_DENSITY, seed=seed,
                                          capacity_factor=capacity_factor)


def tracer_levels(sim):
    """``{level: {field: tensor}}`` of ``sim``'s tracers (a uniform mesh's
    buffers as level 0)."""
    ts = sim.tracer_state
    return ts["levels"] if "levels" in ts else {0: ts}


def tracer_census(sim):
    """``(active, lost, slots)`` of ``sim``'s tracers, in one read."""
    levels = tracer_levels(sim)
    act = sum(st["active"].sum() for st in levels.values())
    active, lost = torch.stack(
        [act, sim.tracer_state["n_lost"].long()]).tolist()
    return active, lost, sum(st["active"].numel() for st in levels.values())


def tracer_ranges(sim):
    """Phase 7's tracer ranges: the advection (Heun, the boundaries, the
    migration), the sampling and, on a uniform mesh, turbulence's lookback
    and correlation row."""
    out = [(sim.tracers, "advect", "tracers.advect"),
           (sim.tracers, "fill", "tracers.fill")]
    if getattr(sim, "_fill_tracers_hook", None) is not None:
        out.append((sim, "_fill_tracers_hook", "turbulence.fill_tracers"))
    return out


def tracer_share(profile):
    """(tracer device ms per cycle, share of the device time) from a
    ``phase_split_profile`` breakdown (None where not measured)."""
    if profile is None:
        return None, None
    names = ("tracers", "turbulence")
    ms = sum(profile["range_ms_per_cycle"].get(k, 0.0) for k in names)
    return ms, sum(profile["share_of_device_time"].get(k, 0.0)
                   for k in names)


def tracer_finite(sim):
    return all(bool(torch.isfinite(st[c]).all())
               for st in tracer_levels(sim).values()
               for c in ("x", "y", "z", "rho"))


def phase_tracer_path(rung, n, ncycles, warmup):
    """Path J: path I's turbulence (GLM-MHD HLLD + PLM + VL2, 30 modes) at
    ``n``^3 in one ghost-free block, f32, with ``TRACER_DENSITY`` tracers
    per cell (random_per_block) and its ``.hst`` output; the timed run
    carries no meter."""
    log(f"== phase 4: path J (turbulence {n}^3 + {TRACER_DENSITY} tracers "
        f"per cell, ghost-free, {rung} rung, f32, {warmup} warm-up + "
        f"{ncycles - warmup} timed cycles) ==")
    t0 = time.time()
    sim = make_sim(timed_deck(with_tracers(PORT.decks.turbulence_deck(
        n=n, nlim=ncycles, num_modes=TURB_MODES, precision="single")),
        warmup), rung)
    if sim.mesh.nghost != 0 or sim.tracer_state is None:
        raise AssertionError("path J must run ghost-free with tracers")
    seeded, _, slots = tracer_census(sim)
    log(f"  set-up {time.time() - t0:.2f} s: block {sim.mesh.block_shape}, "
        f"dtype {sim.dtype}; {seeded} tracers in {slots} slots")
    n_sweep, n_stage, zcps = run_sim(sim)
    active, lost, _ = tracer_census(sim)
    want = tuple(k * ncycles for k in RUNG_LAUNCHES[rung])
    finite = bool(torch.isfinite(sim.u).all()) and tracer_finite(sim)
    log(f"  launches: sweep {n_sweep}, stage {n_stage} (expected {want}); "
        f"tracers active {active}, lost {lost} (seeded {seeded}); "
        f"zone-cycles/wallsecond {zcps}")
    if (n_sweep, n_stage) != want or zcps is None or not finite \
            or active + lost != seeded:
        raise AssertionError(f"path J ({rung}): launches "
                             f"{(n_sweep, n_stage)}, finite {finite}, "
                             f"tracers {active} + {lost} of {seeded}")
    return sim, dict(zone_cycles_per_s=zcps, launches=n_sweep + n_stage,
                     launches_per_cycle=(n_sweep + n_stage) / ncycles,
                     cycles=ncycles, tracers_seeded=seeded,
                     tracer_slots=slots, tracers_active=active,
                     tracers_lost=lost)


def level_of_ids(sim):
    """The level each active tracer id sits on (-1: none), on the card."""
    levels = tracer_levels(sim)
    n = 1 + int(max(st["id"].max() for st in levels.values()))
    out = torch.full((n,), -1, dtype=torch.long,
                     device=levels[min(levels)]["id"].device)
    for lev, st in levels.items():
        out[st["id"][st["active"]].long()] = lev
    return out


def phase_tracer_smr_path(rung, n, ncycles, warmup):
    """Path J': path I' refined turbulence (base ``n``^3, 16^3 blocks,
    the octant at level 1) with ``TRACER_DENSITY`` tracers per cell, on the
    stage-faces (#7) or the negdiv-faces (#6/#2) rung, f32; the timed run
    carries no meter.  The tracers that change level are counted over two
    more cycles after it (ids per level before and after a cycle)."""
    log(f"== phase 4: path J' (refined turbulence, base {n}^3, 16^3 blocks, "
        f"octant at level 1, + {TRACER_DENSITY} tracers per cell, {rung} "
        f"rung, f32, {warmup} warm-up + {ncycles - warmup} timed cycles) ==")
    t0 = time.time()
    sim = make_smr_sim(timed_deck(with_tracers(PORT.decks.turbulence_deck(
        n=n, mb=16, nlim=warmup, num_modes=TURB_MODES, precision="single",
        refinement="static")), 0), rung)
    if sim.tracer_state is None or not sim._split_loop():
        raise AssertionError("path J' must run the split loop with tracers")
    leaves = leaves_of(sim)
    seeded, _, slots = tracer_census(sim)
    log(f"  set-up {time.time() - t0:.2f} s: leaves {leaves}; {seeded} "
        f"tracers in {slots} slots")
    (n_stage_f, n_negdiv_f, n_sweep, n_stage), zcps = run_smr(
        sim, ncycles, warmup)
    active, lost, _ = tracer_census(sim)
    finite = all(bool(torch.isfinite(v).all()) for v in sim.state.values()) \
        and tracer_finite(sim)
    per_cycle = {"stage": (2 * len(leaves), 0),
                 "negdiv": (0, 6 * len(leaves))}[rung]
    want = tuple(k * ncycles for k in per_cycle)
    crossed = []
    for _ in range(2):
        before = level_of_ids(sim)
        run_more(sim, 1)
        after = level_of_ids(sim)
        crossed.append(int(((before >= 0) & (after >= 0)
                            & (before != after)).sum()))
    log(f"  launches: stage-faces {n_stage_f}, negdiv-faces {n_negdiv_f} "
        f"(expected {want}); tracers active {active}, lost {lost} (seeded "
        f"{seeded}); tracers changing level in the 2 cycles after the run "
        f"{crossed}; zone-cycles/wallsecond {zcps}")
    if (n_stage_f, n_negdiv_f) != want or (n_sweep, n_stage) != (0, 0) \
            or zcps is None or not finite or active + lost != seeded:
        raise AssertionError(f"path J' ({rung}): launches "
                             f"{(n_stage_f, n_negdiv_f)}, finite {finite}, "
                             f"tracers {active} + {lost} of {seeded}")
    return sim, dict(zone_cycles_per_s=zcps, leaves=leaves,
                     launches=n_stage_f + n_negdiv_f,
                     launches_per_cycle=(n_stage_f + n_negdiv_f) / ncycles,
                     cycles=ncycles, tracers_seeded=seeded,
                     tracer_slots=slots, tracers_active=active,
                     tracers_lost=lost,
                     tracers_changing_level_per_cycle=crossed)


def phase_tracer_paths(zcps):
    """Paths J (both rungs) and J' (both refined rungs): each timed run,
    then its kernels against plain at the run's final state (f32 and the
    same arrays in f64), phase 7's breakdown with the tracers' ranges and
    a counted run of the host reads.  Adds each path's zone-cycles/s to
    ``zcps``; -> ``(path_j, path_j2)``."""
    path_j, path_j2 = {}, {}
    for rung in ("sweep", "stage"):
        with in_dir(OUT / f"J_{rung}"):
            sim, num = phase_tracer_path(rung, n=256, ncycles=12, warmup=2)
            name = f"path J (turbulence 256^3 + tracers, {rung} rung)"
            log(f"== phase 6: the kernel against plain at the final state "
                f"of {name} ==")
            num["kernel_vs_plain"] = phase_case_timings({name: {
                "sim": sim, "rung": rung, "launches": num["launches"],
                "cycles": num["cycles"],
                "zcps": num["zone_cycles_per_s"]}}, 5, f64=True)[name]
            ranges = tracer_ranges(sim)
            num["profile"] = phase_split_profile(sim, 3, name, ranges)
            num["host_reads"], calls = phase_host_reads(
                sim, 2, name, ranges + loop_ranges(sim))
            # the cycle's reads and the correlation row's (the fill hook
            # runs once per cycle, and once more at each run's start)
            row = num["host_reads"]["turbulence.fill_tracers"]
            num["host_reads_per_cycle"] = cycle_reads(
                num["host_reads"], calls, name) + row
            log(f"  host reads per cycle of {name} with the correlation "
                f"row's ({row:.2f}): {num['host_reads_per_cycle']:.2f}")
        num["tracer_ms_per_cycle"], num["tracer_share"] = tracer_share(
            num["profile"])
        log(f"  {name}: tracers' device ms per cycle "
            f"{num['tracer_ms_per_cycle']}, share of the device time "
            f"{num['tracer_share']}")
        if calls["tracers.advect"] != 1 or calls["tracers.fill"] != 1:
            raise AssertionError(f"{name}: the tracers ran {calls} times "
                                 "per cycle")
        path_j[rung] = num
        zcps[f"path_J {rung}"] = num["zone_cycles_per_s"]
        del sim, ranges
        torch.cuda.empty_cache()
    for rung in ("stage", "negdiv"):
        with in_dir(OUT / f"J2_{rung}"):
            sim, num = phase_tracer_smr_path(rung, n=128, ncycles=12,
                                             warmup=2)
            kind, kname, line = {
                "stage": ("stage-faces", "fused_stage_faces", 641),
                "negdiv": ("negdiv-faces", "negdiv_sweep_faces", 525)}[rung]
            phase_smr_kernels_vs_plain(sim, "J'", kind)
            row = phase_smr_timings(
                sim, kind, num["launches"], 10, kname,
                f"athenapk_tpu/solver/pallas_sweep.py:{line}",
                f"path J' ({rung} rung)")
            num["kernel_vs_plain"] = {k: row[k] for k in (
                "ms", "plain_ms", "bound_ms", "share_of_bound", "bound_by",
                "max_abs_err", "unit", "per_call")}
            name = f"path J' ({rung} rung)"
            ranges = tracer_ranges(sim)
            num["profile"] = phase_split_profile(sim, 3, name, ranges)
            num["host_reads"], calls = phase_host_reads(sim, 2, name,
                                                        ranges)
        num["host_reads_per_cycle"] = num["host_reads"]["run"]
        num["tracer_ms_per_cycle"], num["tracer_share"] = tracer_share(
            num["profile"])
        log(f"  {name}: tracers' device ms per cycle "
            f"{num['tracer_ms_per_cycle']}, share of the device time "
            f"{num['tracer_share']}")
        if calls["tracers.advect"] != 1 or calls["tracers.fill"] != 1:
            raise AssertionError(f"{name}: the tracers ran {calls} times "
                                 "per cycle")
        path_j2[rung] = num
        zcps[f"path_J' {rung}"] = num["zone_cycles_per_s"]
        del sim, ranges
        torch.cuda.empty_cache()
    return path_j, path_j2


def phase_amr_tracers(seed, ncycles=5):
    """Adaptive tracers in f64: adaptive path D' deck (64^3, 16^3 blocks,
    ``derefine_count = 1`` so that the leaf table changes) with
    ``TRACER_DENSITY`` tracers per cell on the negdiv rung, through the
    kernels and with the plain versions forced, side by side from the same
    noised state.  After every cycle: the leaf tables equal, active + lost
    tracers equal to the seeded count, the active ids unique, the two
    runs' tracer ids and activity identical and positions within 1e-10,
    the state within STEP_TOL; and no tracer lost (a periodic box, and the
    buffers' headroom of ``with_tracers``)."""
    log(f"== phase 5: adaptive tracers, kernels against plain (adaptive "
        f"path D' deck at 64^3 + {TRACER_DENSITY} tracers per cell, "
        f"derefine_count = 1, f64, {ncycles} cycles) ==")
    stage, sweep = PORT.stage, PORT.sweep
    deck = with_tracers(ADAPTIVE_3D_DECK.format(
        n=64, mb=16, ncycles=ncycles, precision="double").replace(
        "refinement = adaptive", "refinement = adaptive\nderefine_count = 1"),
        seed, capacity_factor=16.0)
    out = OUT / "amr_tracers"
    with in_dir(out):
        sims = {name: make_smr_sim(deck, "negdiv")
                for name in ("kernel", "plain")}
    start = symmetry_noise(sims["kernel"].state, seed)
    for sim in sims.values():
        sim.quiet = True
        sim.load_state(start, 0.0, 0)
    seeded = tracer_census(sims["kernel"])[0]
    tables, err_x, err_u, launches = set(), 0.0, 0.0, 0
    for k in range(1, ncycles + 1):
        for name, sim in sims.items():
            dispatch = sweep.fused_negdiv_faces
            try:
                if name == "plain":
                    sweep.fused_negdiv_faces = sweep.negdiv_faces_plain
                sim.nlim = k
                reset_counts()
                with in_dir(out):
                    sim.run()
                n_launch = sum(read_face_counts())
            finally:
                sweep.fused_negdiv_faces = dispatch
            if (n_launch == 0) != (name == "plain"):
                raise AssertionError(f"adaptive tracers: the {name} run "
                                     f"launched {n_launch}")
            launches += n_launch
        kern, plain = sims["kernel"], sims["plain"]
        if any(not np.array_equal(a, b)
               for a, b in zip(table_of(kern), table_of(plain))):
            raise AssertionError(f"adaptive tracers: leaf tables differ "
                                 f"after cycle {k}")
        tables.add(tuple(table_of(kern)[0].tolist()))
        for lev, u in plain.state.items():
            err_u = max(err_u, (kern.state[lev] - u).abs().max().item()
                        / u.abs().max().item())
        for lev, st in tracer_levels(plain).items():
            mine = tracer_levels(kern)[lev]
            if not (torch.equal(mine["id"], st["id"])
                    and torch.equal(mine["active"], st["active"])):
                raise AssertionError(f"adaptive tracers: ids or activity "
                                     f"differ at level {lev}, cycle {k}")
            err_x = max([err_x] + [(mine[c] - st[c]).abs().max().item()
                                   for c in "xyz"])
        for sim in sims.values():
            active, lost, _ = tracer_census(sim)
            ids = torch.cat([st["id"][st["active"]]
                             for st in tracer_levels(sim).values()])
            if active + lost != seeded or ids.unique().numel() != active:
                raise AssertionError(f"adaptive tracers, cycle {k}: "
                                     f"{active} active + {lost} lost of "
                                     f"{seeded}, ids unique "
                                     f"{ids.unique().numel()}")
    active, lost, slots = tracer_census(sims["kernel"])
    log(f"  {len(tables)} leaf tables over {ncycles} cycles (remeshes "
        f"{kern.perf_remeshes} in the last call), leaves at the end "
        f"{leaves_of(kern)}; tracers active {active} + lost {lost} = seeded "
        f"{seeded} every cycle, ids unique; positions max abs err {err_x:.3e} "
        f"(tol 1e-10), state max rel err {err_u:.3e} (tol {STEP_TOL:.0e}); "
        f"{launches} negdiv-faces launches")
    if not (len(tables) >= 2 and err_x <= 1e-10 and err_u <= STEP_TOL
            and lost == 0):
        raise AssertionError("adaptive tracers: no remesh, or the kernel and "
                             "plain runs disagree")
    del sims
    torch.cuda.empty_cache()
    return dict(tables=len(tables), seeded=seeded, active=active, lost=lost,
                slots=slots, position_max_abs_err=err_x,
                state_max_rel_err=err_u, launches=launches, cycles=ncycles)


def run_recorded(sim, nlim):
    """Run ``sim`` to cycle ``nlim``; -> the dt of each cycle it ran."""
    dts = []
    attr = "_end_cycle" if hasattr(sim, "_smesh_now") else "_move_tracers"
    inner = getattr(sim, attr)

    def record(dt, *a):
        dts.append(dt)
        return inner(dt, *a)

    setattr(sim, attr, record)
    sim.nlim = nlim
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            sim.run()
    finally:
        delattr(sim, attr)
    return dts


def run_differences(a, dts_a, b, dts_b):
    """What differs, bit for bit, between two runs: state, tracers, time,
    the dt sequence (and the leaf table on a refined mesh)."""
    out = []
    if hasattr(a, "_smesh_now"):
        if any(not np.array_equal(x, y)
               for x, y in zip(table_of(a), table_of(b))):
            return ["leaf table"]
        if any(not torch.equal(u, b.state[lev])
               for lev, u in a.state.items()):
            out.append("state")
    elif not torch.equal(a.u, b.u):
        out.append("state")
    la, lb = tracer_levels(a), tracer_levels(b)
    if sorted(la) != sorted(lb) or any(
            not torch.equal(v, lb[lev][k])
            for lev, st in la.items() for k, v in st.items()) \
            or not torch.equal(a.tracer_state["n_lost"],
                               b.tracer_state["n_lost"]):
        out.append("tracers")
    if a.t != b.t or a.ncycle != b.ncycle:
        out.append("t")
    if dts_a != dts_b:
        out.append("dt sequence")
    return out


def phase_restart_on_card():
    """The restart on the card, f32 and f64, for path J's deck at 128^3
    (sweep rung), path I' refined deck with tracers (base 128^3, stage
    rung) and adaptive path D' deck with tracers (64^3, derefine_count =
    1, negdiv rung): two continuous runs of N cycles must be equal bit for
    bit (else the card is not deterministic there, and the phase fails);
    then N/2 cycles, ``restart_payload``, a new simulation from it and N/2
    more must equal the continuous run bit for bit: state, tracers, t and
    every dt."""
    import importlib.util
    layer = ("this machine has h5py, but the phase holds the payload "
             "alone" if importlib.util.find_spec("h5py") else
             "this machine has no h5py, so the .rhdf file layer does not "
             "run here")
    log(f"== phase 5: restart on the card through restart_payload, the "
        f"dict the .rhdf file layer writes and reads ({layer}) ==")
    d = PORT.decks
    cases = [
        ("path J's deck at 128^3", False, "sweep", 6,
         lambda p: with_tracers(d.turbulence_deck(
             n=128, nlim=6, num_modes=TURB_MODES, precision=p))),
        ("path I' refined deck + tracers", True, "stage", 4,
         lambda p: with_tracers(d.turbulence_deck(
             n=128, mb=16, nlim=4, num_modes=TURB_MODES, precision=p,
             refinement="static"))),
        ("adaptive path D' deck + tracers", True, "negdiv", 6,
         lambda p: with_tracers(ADAPTIVE_3D_DECK.format(
             n=64, mb=16, ncycles=6, precision=p).replace(
             "refinement = adaptive",
             "refinement = adaptive\nderefine_count = 1"),
             capacity_factor=16.0))]
    out = {}
    for label, refined, rung, n, make_deck in cases:
        for prec in ("single", "double"):
            t0 = time.time()
            deck = make_deck(prec)

            def make(restart=None):
                with in_dir(OUT / "restart"):
                    return (make_smr_sim(deck, rung, restart) if refined
                            else make_sim(deck, rung, restart))

            def run(sim, nlim):
                with in_dir(OUT / "restart"):
                    return run_recorded(sim, nlim)

            a = make()
            dts_a = run(a, n)
            b = make()
            dts_b = run(b, n)
            diff = run_differences(a, dts_a, b, dts_b)
            if diff:
                raise AssertionError(f"restart, {label} ({prec}): two "
                                     f"continuous runs differ in {diff}: the "
                                     "card is not deterministic here")
            del b
            c = make()
            dts_c = run(c, n // 2)
            payload = (PORT.restart_payload_smr if refined
                       else PORT.restart_payload)(c)
            del c
            r = make(payload)
            dts_r = dts_c + run(r, n)
            diff = run_differences(a, dts_a, r, dts_r)
            census = tracer_census(a)
            extra = (f", leaves {leaves_of(a)}, remeshes in the resumed "
                     f"part {r.perf_remeshes}" if refined else "")
            log(f"  {label} ({prec}): {n} cycles, resumed after {n // 2}: "
                + ("bit for bit equal (state, tracers, t, every dt)"
                   if not diff else f"DIFFERS in {diff}")
                + f"; tracers active {census[0]}, lost {census[1]}{extra}; "
                f"{time.time() - t0:.1f} s")
            if diff:
                raise AssertionError(f"restart, {label} ({prec}): the resume "
                                     f"differs from the continuous run in "
                                     f"{diff}")
            out[f"{label} ({prec})"] = dict(cycles=n, resumed_after=n // 2,
                                            bitwise=True)
            del a, r
            torch.cuda.empty_cache()
    return out


def phase_trace_cli():
    """``-t``: ``driver.main(["-t", DIR, "-i", deck])`` on the main deck at
    64^3 (f32, 3 cycles, sweep rung); the Chrome trace in DIR must hold
    every launch of the port's kernels that the launch counters saw in
    that run and the stage's named ranges."""
    log("== phase 7: the CLI's -t (the main deck at 64^3, f32, 3 cycles) ==")
    d = OUT / "trace_cli"
    for attempt in (1, 2):
        with in_dir(d):
            (d / "wave.in").write_text(BENCH_DECK.format(
                n=64, ncycles=3, warmup=0, precision="single"))
            n0 = all_launches()
            with contextlib.redirect_stdout(io.StringIO()):
                rc = PORT.driver.main(["-t", "trace", "-i", "wave.in"])
            launched = all_launches() - n0
        events = json.loads((d / "trace" / "trace.json").read_text())[
            "traceEvents"]
        kernels = [e for e in events if e.get("cat") == "kernel"]
        try:
            check_trace(kernels, launched)
            break
        except TraceLost as e:
            # the profiler can drop device events (phase 7): one more try,
            # then the phase fails
            log(f"  {e}" + ("; tracing again" if attempt == 1 else ""))
            if attempt == 2:
                raise AssertionError(f"-t: {e}") from e
    ranges = {e.get("name") for e in events
              if e.get("cat") == "user_annotation"}
    need = {"fused_lane_sweep", "dedner_source", "boundary_fill"}
    log(f"  exit {rc}; {launched} launches of the port's kernels, all in the "
        f"trace; {len(kernels)} kernels in all; the ranges "
        f"{sorted(need & ranges)} found ({sorted(need - ranges)} missing)")
    if rc != 0 or launched != 3 * RUNG_LAUNCHES["sweep"][0] \
            or not need <= ranges:
        raise AssertionError(f"-t: exit {rc}, {launched} launches, ranges "
                             f"{sorted(ranges)[:20]}")
    return dict(launches=launched, kernels_in_trace=len(kernels),
                ranges=sorted(need))


# ------------------------------------------------------------ the cluster
# Paths K, K' and K'': tests/torch_decks.py's cluster_deck (GLM-MHD HLLD +
# PLM + VL2, one passive scalar, NFW + Hernquist + SMBH gravity, the ACCEPT
# HSE atmosphere over +-0.1 Mpc with outflow boundaries, few-modes velocity
# and magnetic perturbations, AGN feedback at a fixed 1e-3 (thermal,
# kinetic with its tracer, the tower) with COLD_GAS triggering, SN Ia,
# stellar feedback, the clips).  K: static refinement, base 128^3 in 32^3
# blocks, +-0.025 at level 1 and +-0.0125 at level 2, f64 with Townsend
# cooling; K': the same physics at 256^3 in one ghosted block; K'': K'
# in f32 without cooling and stellar feedback (both are outside the f32
# range in these units: the cooling overflows, the stellar feedback's
# number density refuses f32).
CLUSTER_K_REGIONS = [(0.025, 1), (0.0125, 2)]


def cluster_table():
    """The cluster's cooling table (1e4-1e10 K) under ``build/``."""
    OUT.mkdir(parents=True, exist_ok=True)
    return PORT.decks.write_cluster_table(OUT / "cluster.cool")


def cluster_deck(path, n, nlim):
    """Path ``path``'s cluster deck at base ``n``^3 (K: refined, 32^3
    blocks; K' f64 with cooling; K'' f32 without cooling and stellar
    feedback), ``nlim`` cycles."""
    d = PORT.decks
    if path == "K''":
        return d.cluster_deck(n=n, nlim=nlim, precision="single",
                              stellar=False)
    kw = dict(mb=32, refinement="static", regions=CLUSTER_K_REGIONS) \
        if path == "K" else {}
    return d.cluster_deck(n=n, nlim=nlim, table=cluster_table(), **kw)


def cluster_ranges(sim):
    """Phase 7's cluster ranges: the unsplit source of every stage and
    the split source (stellar feedback and the clips) of every cycle."""
    st = sim._stepper_now() if hasattr(sim, "_stepper_now") else None
    if st is None:
        return [(sim.pkg, "problem_source_unsplit", "cluster_unsplit"),
                (sim, "src_first_order", "cluster_split")]
    return [(st, "problem_source_unsplit", "cluster_unsplit"),
            (st, "problem_source_first_order", "cluster_split")]


def phase_cluster_uniform(path, rung, n, ncycles, warmup):
    """Path K' (f64, cooling) or K'' (f32) at ``n``^3 in one ghosted
    block on the sweep or the stage rung; the timed run carries no
    meter."""
    f32 = path == "K''"
    log(f"== phase 4: path {path} (cluster {n}^3, one ghosted block, "
        f"{rung} rung, {'f32, no cooling' if f32 else 'f64, cooling'}, "
        f"{warmup} warm-up + {ncycles - warmup} timed cycles) ==")
    t0 = time.time()
    sim = make_sim(timed_deck(cluster_deck(path, n, ncycles), warmup), rung)
    if sim.mesh.nblocks != 1 or sim.mesh.nghost != 2 \
            or not sim._split_cycle() or sim.cfg.nscalars != 1:
        raise AssertionError(f"path {path} must run one ghosted block with "
                             "its split source and the AGN tracer")
    cells = sim.mesh.nx1 * sim.mesh.nx2 * sim.mesh.nx3
    log(f"  set-up {time.time() - t0:.2f} s (the HSE profile, the "
        f"perturbations): {cells} cells, dtype {sim.u.dtype}, cooling "
        f"{sim.pkg.cooling is not None}")
    n_sweep, n_stage, zcps = run_sim(sim)
    n_ns = PORT.sweep.negdiv_scalars_cuda.launches
    n_ss = PORT.stage.stage_scalars_cuda.launches
    n_up, n_dt = cooling_launches()
    per = RUNG_LAUNCHES[rung]
    # the cooling: an update a stage, a dt a cycle and the initial dt
    cool = (2 * ncycles, ncycles + 1) if sim.pkg.cooling is not None \
        else (0, 0)
    want = (per[0] * ncycles, per[1] * ncycles, per[0] * ncycles,
            per[1] * ncycles) + cool
    got = (n_sweep, n_stage, n_ns, n_ss, n_up, n_dt)
    finite = bool(torch.isfinite(sim.u).all())
    log(f"  launches: sweep {n_sweep}, stage {n_stage}, negdiv_scalars "
        f"{n_ns}, stage_scalars {n_ss}, cooling update {n_up}, cooling dt "
        f"{n_dt} (expected {want}); zone-cycles/wallsecond {zcps}; finite "
        f"{finite}")
    if got != want or zcps is None or not finite:
        raise AssertionError(f"path {path} ({rung}): launches {got}, "
                             f"finite {finite}")
    return sim, dict(zone_cycles_per_s=zcps, cells=cells,
                     launches=n_sweep + n_stage,
                     scalar_launches=n_ns + n_ss,
                     cooling_launches=dict(update=n_up, dt=n_dt),
                     launches_per_cycle=(n_sweep + n_stage) / ncycles,
                     cycles=ncycles)


def phase_cluster_refined(rung, n, ncycles, warmup):
    """Path K: the cluster deck on a static refined mesh (base ``n``^3 in
    32^3 blocks, two nested regions), f64 with cooling, on the stage-faces
    (#7) or the negdiv-faces (#6/#2) rung; the timed run carries no
    meter."""
    log(f"== phase 4: path K (cluster, base {n}^3, 32^3 blocks, levels 1 "
        f"and 2 at +-0.025 and +-0.0125, {rung} rung, f64, cooling, "
        f"{warmup} warm-up + {ncycles - warmup} timed cycles) ==")
    t0 = time.time()
    sim = make_smr_sim(timed_deck(cluster_deck("K", n, warmup), 0), rung)
    if not sim._split_loop() or sim.cfg.nscalars != 1:
        raise AssertionError("path K must run the split loop with the AGN "
                             "tracer")
    leaves = leaves_of(sim)
    cells = sum(leaves.values()) * 32 ** 3
    log(f"  set-up {time.time() - t0:.2f} s (one HSE profile at the finest "
        f"dx, the perturbations over all levels): leaves {leaves} "
        f"({sum(leaves.values())} leaves, {cells} cells)")
    (n_sf, n_nf, n_sweep, n_stage), zcps = run_smr(sim, ncycles, warmup)
    n_ns = PORT.sweep.negdiv_scalars_cuda.launches
    n_ss = PORT.stage.stage_scalars_cuda.launches
    n_up, n_dt = cooling_launches()
    nlev = len(leaves)
    per = {"stage": (2 * nlev, 0), "negdiv": (0, 6 * nlev)}[rung]
    # the cooling per level: an update a stage, a dt a cycle (each of the
    # two runs takes its first dt in its first cycle)
    want = (per[0] * ncycles, per[1] * ncycles, 0, 0,
            per[1] * ncycles, per[0] * ncycles, 2 * nlev * ncycles,
            nlev * ncycles)
    got = (n_sf, n_nf, n_sweep, n_stage, n_ns, n_ss, n_up, n_dt)
    finite = all(bool(torch.isfinite(v).all()) for v in sim.state.values())
    log(f"  launches: stage-faces {n_sf}, negdiv-faces {n_nf}, sweep "
        f"{n_sweep}, stage {n_stage}, negdiv_scalars {n_ns}, stage_scalars "
        f"{n_ss}, cooling update {n_up}, cooling dt {n_dt} (expected "
        f"{want}); zone-cycles/wallsecond {zcps}; finite {finite}")
    if got != want or zcps is None or not finite:
        raise AssertionError(f"path K ({rung}): launches {got}, finite "
                             f"{finite}")
    return sim, dict(zone_cycles_per_s=zcps, leaves=leaves, cells=cells,
                     launches=n_sf + n_nf, scalar_launches=n_ns + n_ss,
                     cooling_launches=dict(update=n_up, dt=n_dt),
                     launches_per_cycle=(n_sf + n_nf) / ncycles,
                     cycles=ncycles)


def injection_meter(pkg, acc, whole_terms=True):
    """A ``wrap_calls`` maker that meters the AGN feedback's
    ``apply_groups``: every call appends to ``acc`` the change of mass and
    energy it made, summed over its groups' interior cells, and the deck's
    rates times the stage's ``beta_dt`` (power = fixed_power + efficiency
    c^2 Mdot and the mass rate, Mdot the triggering's from the same prim
    through the call's own sums (over every rank's leaves over ranks),
    each channel's share weighted by its region's discrete volume over the
    analytic one, the tower's energy exactly its share, the accreted gas's
    mass and energy removed): ``[dm, dm analytic, de, de analytic]`` on the
    device.  Over ranks every term but the tower's share is a sum over
    cells, so the ranks' entries add up to the whole mesh's;
    ``whole_terms``: this rank adds the tower's share (one rank does)."""
    from athenapk_tpu_torch.core.indices import IDN as D, IEN as E
    from athenapk_tpu_torch.pgen.cluster.agn_feedback import PLAIN_SUMS
    fb, trig, tw = pkg.agn_feedback, pkg.agn_triggering, pkg.magnetic_tower
    if trig.mode != "COLD_GAS" or fb.triggering is not trig:
        raise AssertionError("the meter reckons COLD_GAS's removal")
    c2 = pkg.units.speed_of_light() ** 2

    def totals(groups):
        m = sum(torch.sum(g["u"][:, D] * g["valid"]) * g["vol"]
                for g in groups)
        e = sum(torch.sum(g["u"][:, E] * g["valid"]) * g["vol"]
                for g in groups)
        return m, e

    def analytic(groups, beta_dt, t, sums):
        mdot = trig.rate_from_partials(sums.total([
            (g.get("level"), trig.accretion_partials(
                g["prim"], g["r"], g["vol"], g["valid"], sums.partial))
            for g in groups]))
        power = fb.fixed_power + fb.efficiency * c2 * mdot
        m_rate = mdot * (1 - fb.efficiency) + fb.fixed_power / (
            fb.efficiency * c2)
        v_th = v_kin = gauss = m_rm = e_rm = 0.0
        for g in groups:
            ok, vol = g["valid"], g["vol"]
            v_th = v_th + torch.sum((g["r"] ** 2 <= fb.thermal_radius ** 2)
                                    & ok) * vol
            rj, _, _, h = fb.jet_coords.sim_to_jet(g["x"], g["y"], g["z"], t)
            jet = ((rj < fb.kinetic_jet_radius)
                   & (h.abs() >= fb.kinetic_jet_offset)
                   & (h.abs() <= fb.kinetic_jet_offset
                      + fb.kinetic_jet_thickness) & ok)
            v_kin = v_kin + torch.sum(jet) * vol
            r2 = rj ** 2 + h ** 2
            gauss = gauss + torch.sum(torch.exp(-r2 / tw.l_mass_scale ** 2)
                                      * ok) * vol
            temp = trig.mbar_over_kb * g["prim"][:, 4] / g["prim"][:, D]
            cold = (g["r"] < trig.accretion_radius) & ok \
                & (temp <= trig.cold_temp_thresh)
            frac = beta_dt / trig.cold_t_acc
            m_rm = m_rm + torch.sum(g["u"][:, D] * cold) * vol * frac
            e_rm = e_rm + torch.sum(g["u"][:, E] * cold) * vol * frac
        v_th = v_th / (4.0 / 3.0 * math.pi * fb.thermal_radius ** 3)
        v_kin = v_kin / (2 * math.pi * fb.kinetic_jet_thickness
                         * fb.kinetic_jet_radius ** 2)
        gauss = gauss / (math.pi ** 1.5 * tw.l_mass_scale ** 3)
        dm = beta_dt * m_rate * (fb.thermal_mass_fraction * v_th
                                 + fb.kinetic_mass_fraction * v_kin
                                 + fb.magnetic_mass_fraction * gauss) - m_rm
        de = beta_dt * power * (fb.thermal_fraction * v_th
                                + fb.kinetic_fraction * v_kin
                                + (fb.magnetic_fraction if whole_terms
                                   else 0.0)) - e_rm
        return dm, de

    def metered(fn, label):
        def call(groups, beta_dt, t, mhd, sums=None):
            want = analytic(groups, beta_dt, t,
                            PLAIN_SUMS if sums is None else sums)
            before = totals(groups)
            out = fn(groups, beta_dt, t, mhd, sums=sums)
            after = totals(groups)
            acc.append(torch.stack([torch.as_tensor(x, dtype=torch.float64,
                                                    device=after[0].device)
                                    for x in (after[0] - before[0], want[0],
                                              after[1] - before[1], want[1])]))
            return out
        return call

    return metered


def injection_check(tot, calls, what):
    """``{mass, energy: {injected, analytic, rel_diff}}`` of the summed
    meter ``tot`` (``[dm, dm analytic, de, de analytic]``); raises past
    1e-3."""
    out = {}
    for name, (got, want) in (("mass", tot[:2]), ("energy", tot[2:])):
        out[name] = dict(injected=got, analytic=want,
                         rel_diff=abs(got - want) / abs(want))
        log(f"  {name} injected by the AGN feedback over {calls} calls: "
            f"{got:.10e}, analytic {want:.10e} (rel diff "
            f"{out[name]['rel_diff']:.3e})")
        if not out[name]["rel_diff"] <= 1e-3:
            raise AssertionError(f"{what}: the AGN feedback injected {name} "
                                 f"{got} against {want}")
    return out


def phase_cluster_injection(sim, ncycles, what):
    """The mass and energy the AGN feedback injects over ``ncycles`` more
    cycles (a counted run, not timed), against the analytic rates
    (``injection_meter``), all summed on the device and read once.  ->
    ``{mass, energy: {injected, analytic, rel_diff}}``."""
    log(f"== phase 4: the AGN feedback's injection over {ncycles} cycles of "
        f"{what} against its rates ==")
    pkg = sim.pgen.register_defaults(sim.pin)   # the sources' objects
    acc = []
    undo = wrap_calls([(pkg.agn_feedback, "apply_groups", "agn")],
                      injection_meter(pkg, acc))
    try:
        run_more(sim, ncycles)
    finally:
        undo()
    return injection_check(torch.stack(acc).sum(dim=0).tolist(), len(acc),
                           what)


def phase_cluster_paths(zcps):
    """Paths K (both refined rungs), K' (both uniform rungs) and K'' (the
    stage rung): each timed run, then its kernels against plain at the
    run's final state (f32 and f64), phase 7's breakdown with the cluster's
    source ranges, a counted run of the host reads (no more than 1 per
    cycle, path I''s) and one of the AGN injection.  Adds each path's
    zone-cycles/s to ``zcps``; -> ``{(path, rung): numbers}``."""
    out = {}
    runs = [("K", "stage"), ("K", "negdiv"), ("K'", "sweep"),
            ("K'", "stage"), ("K''", "stage")]
    for path, rung in runs:
        name = f"path {path} ({rung} rung)"
        folder = {"K": "K", "K'": "K1", "K''": "K2"}[path]
        with in_dir(OUT / f"cluster_{folder}_{rung}"):
            if path == "K":
                sim, num = phase_cluster_refined(rung, n=128, ncycles=8,
                                                 warmup=2)
                kind, kname, line = {
                    "stage": ("stage-faces", "fused_stage_faces", 641),
                    "negdiv": ("negdiv-faces", "negdiv_sweep_faces",
                               525)}[rung]
                phase_smr_kernels_vs_plain(sim, "K", kind)
                row = phase_smr_timings(
                    sim, kind, num["launches"], 10, kname,
                    f"athenapk_tpu/solver/pallas_sweep.py:{line}", name)
                num["kernel_vs_plain"] = {k: row[k] for k in (
                    "ms", "plain_ms", "bound_ms", "share_of_bound",
                    "bound_by", "max_abs_err", "unit", "per_call")}
            else:
                sim, num = phase_cluster_uniform(path, rung, n=256,
                                                 ncycles=8, warmup=2)
                log(f"== phase 6: the kernel against plain at the final "
                    f"state of {name} ==")
                num["kernel_vs_plain"] = phase_case_timings({name: {
                    "sim": sim, "rung": rung, "launches": num["launches"],
                    "cycles": num["cycles"],
                    "zcps": num["zone_cycles_per_s"]}}, 5, f64=True)[name]
                if rung == "stage":
                    # as the path calls it: with the stage-start prim
                    num["stage_prim_max_rel_err"] = \
                        phase_stage_prim_at_path_h(sim, name)
            ranges = cluster_ranges(sim)
            num["profile"] = phase_split_profile(sim, 3, name, ranges)
            if path == "K":
                num["host_reads"], calls = phase_host_reads(sim, 2, name,
                                                            ranges)
                num["host_reads_per_cycle"] = num["host_reads"]["run"]
            else:
                num["host_reads"], calls = phase_host_reads(
                    sim, 2, name, ranges + loop_ranges(sim))
                num["host_reads_per_cycle"] = cycle_reads(
                    num["host_reads"], calls, name)
            if calls["cluster_unsplit"] != 2 or calls["cluster_split"] != 1 \
                    or num["host_reads_per_cycle"] > 1.0:
                raise AssertionError(
                    f"{name}: sources per cycle {calls}, host reads per "
                    f"cycle {num['host_reads_per_cycle']} (path I': 1.00)")
            if path != "K''":
                num["injection"] = phase_cluster_injection(sim, 2, name)
            prof = num["profile"]
            for label in ("cluster_unsplit", "cluster_split"):
                ms = share = None
                if prof is not None:
                    ms = prof["range_ms_per_cycle"].get(label, 0.0)
                    share = prof["share_of_device_time"].get(label, 0.0)
                num[f"{label}_ms_per_cycle"] = ms
                num[f"{label}_share"] = share
                log(f"  {name}: {label} {ms} device ms per cycle, share of "
                    f"the device time {share}")
        out[path, rung] = num
        zcps[f"path_{path} {rung}"] = num["zone_cycles_per_s"]
        del sim, ranges
        torch.cuda.empty_cache()
    return out


def cluster_whole_step_cases():
    """(label, deck, refined, rung) of phase 5's cluster decks, f64 with
    cooling, 5 cycles: 32^3 over +-0.02 Mpc uniform on both rungs, and
    base 16^3 in 8^3 blocks with the octant at level 1 on both refined
    rungs."""
    d, hst, table = PORT.decks, PORT.decks.HST_BLOCK, cluster_table()
    octant = [(0.0, 0.02, 0.0, 0.02, 0.0, 0.02, 1)]
    cases = [(f"cluster 32^3, {rung} rung", d.cluster_deck(
        n=32, half=0.02, table=table) + hst, False, rung)
        for rung in ("sweep", "stage")]
    cases += [(f"cluster base 16^3 + octant, {rung} rung", d.cluster_deck(
        n=16, mb=8, half=0.02, table=table, refinement="static",
        regions=octant) + hst, True, rung) for rung in ("stage", "negdiv")]
    return cases


# ----------------------------------------------------- multi-rank on one card
# The main deck with ghosted z-slabs (merge_blocks = false): nghost 3 for
# PPM, meshblocks (n, n / ny, n / nz); M2 adds outflow in z (the edge
# ranks' boundaries).
MR_PATHS = {"M1": (256, 1, 4, "single", 5, False),
            "M2": (128, 2, 2, "double", 2, True)}
MR_TRACERS = {
    # test_sharding.py:190's setup at 128^3: vz carries the tracers across
    # the slab boundary
    "M3": dict(shape=(128, 128, 128), mb=32, per_cell=TRACER_DENSITY,
               vel=(0.30, 0.15, 0.45), seed=7, steps=10, dt=0.2),
    # every tracer carried half the domain in one step: each rank sends its
    # whole pool, more than layer * cap at once (the JAX routing's :105)
    "M3 overflow": dict(shape=(128, 128, 128), mb=32, per_cell=TRACER_DENSITY,
                        vel=(0.0, 0.0, 2.5), seed=5, steps=3, dt=0.2,
                        capacity_factor=1.0),
}
MR_LABEL = "ranks sharing one H100, not a scaling figure"
MR_NCCL_LABEL = "ranks with one H100 each (NCCL)"
MR_SMR_N = 128    # path A's base (120 leaves of 32^3)
MR_AMR_CYCLES = 6
# the cluster over ranks: M5 is path K's deck (base 128^3 in 32^3 blocks,
# levels 1 and 2 at +-0.025 and +-0.0125: 176 leaves, f64, Townsend
# cooling) with only its unsplit sources (gravity, AGN feedback with
# COLD_GAS triggering and the tower, SN Ia): stellar feedback and the clips
# are split sources, which refined meshes over ranks refuse (the JAX
# package drops them); M5' the adaptive cluster at 64^3 in 16^3 blocks over
# +-0.08 Mpc (numlevel 2, pressure_gradient 0.08), whose remeshes from the
# fifth cycle on change the leaves.  Timed cycles, then one cycle with the
# host reads counted and (M5) one with the AGN injection metered.
MR_CLUSTER = {"cluster": dict(warmup=1, timed=3, reads=1, metered=1,
                              remesh=False),
              "cluster_amr": dict(warmup=1, timed=6, reads=1, metered=0,
                                  remesh=True)}


def mr_deck(path):
    n, ny, nz, precision, ncycles, outflow = MR_PATHS[path]
    deck = BENCH_DECK.format(n=n, ncycles=ncycles, warmup=0,
                             precision=precision)
    deck = deck.replace("nghost = 0", "nghost = 3\nmerge_blocks = false"
                        + ("\nix3_bc = outflow\nox3_bc = outflow"
                           if outflow else ""))
    return deck.replace(f"<parthenon/meshblock>\nnx1 = {n}\nnx2 = {n}\n"
                        f"nx3 = {n}", f"<parthenon/meshblock>\nnx1 = {n}\n"
                        f"nx2 = {n // ny}\nnx3 = {n // nz}")


def mr_cycles(step, dt_fn, pkg, u, ncycles):
    """``ncycles`` of (step at the dt, the next dt): the protocol of every
    multi-rank uniform run and of its one-rank reference.  -> (u, [(dt,
    dt_hyp)])."""
    dt, dt_hyp, _ = dt_fn(u)
    dts = []
    for _ in range(ncycles):
        u = step(u, dt, pkg.c_h_from_dt_hyp(dt_hyp))
        dt, dt_hyp, _ = dt_fn(u)
        dts.append((dt, dt_hyp))
    return u, dts


def mr_one_rank_uniform(path, rung):
    """The one-rank blocked run of a multi-rank uniform path."""
    sim = make_sim(mr_deck(path), rung)
    pkg = sim.pkg

    def dt_fn(u):
        return pkg.estimate_timestep(pkg.cons_to_prim(u)[1])

    return mr_cycles(pkg.step, dt_fn, pkg, sim.u, MR_PATHS[path][4])


def mr_amr_ref(amr, state, ncycles):
    """``AmrHydro.advance``'s loop, with the face-kernel launches that the
    leaves held should make (per stage, one stage-faces launch per level
    or one negdiv-faces launch per level and direction)."""
    want = 0
    per_level = 2 if amr._stepper._stage_rung else 6
    state = amr._place(state)
    for n in range(ncycles):
        if n % amr.check_interval == 0:
            state, _ = amr.maybe_remesh(state)
        dt = float(amr._stepper.estimate_dt(state))
        state = amr._stepper.step(state, dt, 0.0)
        want += per_level * len(state)
    return state, want


def mr_amr_build(case, rmesh):
    """The adaptive deck's ``SmrSimulation`` (initial refinement done), and
    an ``AmrHydro`` over ``rmesh`` (None: one rank) with its settings."""
    # derefine_count = 1: the blast's leaves refine and derefine within a
    # few cycles, so the run holds remeshes that change the leaves
    sim = make_smr_sim(ADAPTIVE_3D_DECK.format(
        n=case["n"], mb=16, ncycles=case["ncycles"], precision="single")
        .replace("numlevel = 2", "numlevel = 2\nderefine_count = 1"),
        case["rung"], quiet=True)
    d = sim.driver
    if case["rung"] == "negdiv":
        os.environ["ATHENAPK_PALLAS_STAGE"] = "0"
    try:
        amr = PORT.AmrHydro(d.smesh, sim.cfg, sim.eos, d.refine_cfg,
                            check_interval=d.check_interval,
                            derefine_count=d.derefine_count,
                            rmesh=rmesh, layout="flat")
    finally:
        os.environ.pop("ATHENAPK_PALLAS_STAGE", None)
    return amr, sim.state


MR_CLUSTER_SIMS = {}   # M5's deck, built once a process for both rungs


def mr_cluster_build(case, rmesh):
    """M5's (``kind`` "cluster") or M5''s ("cluster_amr") deck: -> (an
    ``AmrHydro`` over ``rmesh`` (None: one rank) with the deck's cooling and
    its unsplit source factory, the whole initial state, the cluster's
    source objects).  M5's simulation (its HSE profile and initial state)
    is made once and kept for its other rung."""
    from athenapk_tpu_torch.refinement.criteria import RefinementConfig
    d = PORT.decks
    sim = MR_CLUSTER_SIMS.get(case["kind"])
    if sim is None:
        if case["kind"] == "cluster":
            deck = d.cluster_deck(
                n=128, mb=32, nlim=0, table=cluster_table(),
                refinement="static", regions=CLUSTER_K_REGIONS,
                stellar=False).replace("clip_r = 0.02", "clip_r = -1.0")
        else:
            deck = d.cluster_adaptive_deck(cluster_table(), n=64, mb=16,
                                           half=0.08, nlim=0, split=False)
        sim = make_smr_sim(deck, case["rung"], quiet=True)
        if case["kind"] == "cluster":
            MR_CLUSTER_SIMS[case["kind"]] = sim
    if sim._split_loop() and sim._stepper_now().problem_source_first_order \
            is not None:
        raise AssertionError(f"{case['name']}: the deck keeps a split source")
    drv = sim.driver
    if case["rung"] == "negdiv":
        os.environ["ATHENAPK_PALLAS_STAGE"] = "0"
    try:
        amr = PORT.AmrHydro(
            drv.smesh if drv is not None else sim.smesh, sim.cfg, sim.eos,
            drv.refine_cfg if drv is not None else RefinementConfig(),
            derefine_count=drv.derefine_count if drv is not None else 1,
            device=sim.device, cooling=sim.cooling,
            problem_source_factory=sim._source_factories()[0],
            rmesh=rmesh, layout="flat")
    finally:
        os.environ.pop("ATHENAPK_PALLAS_STAGE", None)
    return amr, sim.state, sim.pgen.register_defaults(sim.pin)


def mr_cluster_cycles(amr, state, ncycles, remesh, t=0.0):
    """``ncycles`` of (remesh if ``remesh``, the dt (one host read), the
    step at the time reached with GLM's c_h = cfl * min dx / dt): the
    protocol of M5 and M5' and of their one-rank runs.  -> (state, t, dts,
    leaf counts per cycle, the face launches the leaves held should
    make)."""
    per_level = 2 if amr._stepper._stage_rung else 6
    dts, tables, want = [], [], 0
    for _ in range(ncycles):
        if remesh:
            state, _ = amr.maybe_remesh(state)
        sm = amr.smesh
        tables.append({str(k): int(v.size) for k, v in sm.level_ids.items()})
        st = amr._stepper
        dt = float(st.estimate_dt(state))
        state = st.step(state, dt, amr.cfg.cfl * sm.min_dx(sm.max_level) / dt,
                        t)
        t += dt
        dts.append(dt)
        want += per_level * len(state)
    return state, t, dts, tables, want


def mr_cluster_run(amr, state, pkg, case, timed, whole_terms=True):
    """M5 or M5' on ``amr`` (one rank or over ranks) from the whole
    ``state``: a warm-up cycle, the timed cycles (``timed(fn)`` ->
    (result, numbers)), then
    one cycle with the host reads counted (the run's per cycle and the
    unsplit hook's per call), then (M5) one with the AGN injection metered
    (``injection_meter``; ``whole_terms``: this rank adds the whole-mesh
    term).  -> (final state, numbers)."""
    spec = MR_CLUSTER[case["kind"]]

    def collectives():
        return sum(st.problem_source_unsplit.leaves.collectives
                   for st in amr._steppers.values())

    state, t, dts0, tables0, _ = mr_cluster_cycles(
        amr, amr._place(state), spec["warmup"], spec["remesh"])
    c0 = collectives()
    (state, t, dts, tables, want), num = timed(lambda: mr_cluster_cycles(
        amr, state, spec["timed"], spec["remesh"], t))
    num.update(want_face_launches=want, cycles=spec["timed"],
               collectives=collectives() - c0,
               leaves_held={str(k): int(v.shape[0]) for k, v in
                            state.items()})
    total = {"reads": 0}
    inside = {"reads": 0, "calls": 0}

    def counting(fn, label):
        def call(*a, **k):
            n0 = total["reads"]
            try:
                return fn(*a, **k)
            finally:
                inside["reads"] += total["reads"] - n0
                inside["calls"] += 1
        return call

    dts, tables = list(dts), list(tables)
    with host_reads(total):
        for _ in range(spec["reads"]):
            # the remesh first, so that the hook counted is the one of
            # the leaves the cycle steps
            if spec["remesh"]:
                state, _ = amr.maybe_remesh(state)
            undo = wrap_calls([(amr._stepper, "problem_source_unsplit",
                                "cluster_unsplit")], counting)
            try:
                state, t, d2, t2, _ = mr_cluster_cycles(amr, state, 1,
                                                        False, t)
            finally:
                undo()
            dts += d2
            tables += t2
    num["host_reads_per_cycle"] = total["reads"] / spec["reads"]
    num["hook_reads_per_call"] = inside["reads"] / max(inside["calls"], 1)
    num["hook_calls_per_cycle"] = inside["calls"] / spec["reads"]
    if spec["metered"]:
        acc = []
        undo = wrap_calls([(pkg.agn_feedback, "apply_groups", "agn")],
                          injection_meter(pkg, acc, whole_terms))
        try:
            state, t, d3, t3, _ = mr_cluster_cycles(
                amr, state, spec["metered"], spec["remesh"], t)
        finally:
            undo()
        dts += d3
        tables += t3
        num["injection"] = torch.stack(acc).sum(dim=0).tolist()
        num["injection_calls"] = len(acc)
    b = amr.smesh.base
    block = b.mbnx1 * b.mbnx2 * b.mbnx3
    num.update(dts=dts0 + dts, tables=tables0 + tables,
               cells=sum(tables[0].values()) * block,
               zone_cycles=sum(sum(tb.values())
                               for tb in tables[:spec["timed"]]) * block)
    return state, num


def mr_fill_numbers(rmesh, stepper, state):
    """The bytes this rank sends in one ghost fill of (a copy of)
    ``state``, its schedule's bytes, and the bounds of
    ``parallel.dryrun.fill_send_bounds`` (face slabs, all-gather)."""
    from athenapk_tpu_torch.parallel.dryrun import fill_send_bounds

    sent0 = rmesh.sent_bytes
    stepper.fill_ghosts({k: v.clone() for k, v in state.items()})
    mgr = stepper.state_mgr
    size = next(iter(state.values())).element_size()
    slabs, gathered = fill_send_bounds(mgr)
    return {"bytes_per_fill": rmesh.sent_bytes - sent0,
            "plan_bytes_per_fill": mgr.fill_values_sent * size,
            "face_slab_bytes": slabs * size,
            "all_gather_bytes": gathered * size}


def mr_rank(rmesh, out_dir, cases):
    """One rank of the multi-rank phase: each case of ``cases`` (uniform
    paths, tracers, the refined placement) with this rank's launches,
    seconds and bytes per fill; writes ``rank{r}.json`` and the rank's (or
    rank 0's gathered) results."""
    from athenapk_tpu_torch.amr.sharded import (ShardedSmrHydro,
                                                flat_owners, gather, place)
    from athenapk_tpu_torch.parallel import halo, mesh_sharding as ms
    from athenapk_tpu_torch.parallel.dryrun import tracer_setup
    from athenapk_tpu_torch.tracers.sharded import (make_sharded_tracer_ops,
                                                    shard_pool)

    load_port()
    res = {}
    r = rmesh.rank

    def timed(fn):
        torch.cuda.synchronize()
        reset_counts()
        sent0 = rmesh.sent_bytes
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, {"seconds": time.perf_counter() - t0,
                     "launches": list(read_counts() + read_face_counts()),
                     "sent_bytes": rmesh.sent_bytes - sent0}

    for case in cases:
        name, kind = case["name"], case["kind"]
        if kind == "uniform":
            sim = make_sim(mr_deck(case["path"]), case["rung"])
            pkg, mesh = sim.pkg, sim.mesh
            ncycles = MR_PATHS[case["path"]][4]
            if case.get("grid"):
                gm = halo.make_device_mesh_2d(rmesh, case["grid"])
                stepper = halo.make_sharded_step_grid(pkg, gm)
                local = halo.shard_grid(halo.to_grid(sim.u, mesh), mesh, gm)
                wanted = sum(halo.halo_bytes(local.shape, mesh, d,
                                             local.element_size())
                             for d in (2, 3))
            else:
                gm = rmesh
                stepper = halo.make_sharded_step(pkg, rmesh)
                local = ms.shard_state(sim.u, mesh, rmesh)
                wanted = halo.halo_bytes(
                    (mesh.nb3 // rmesh.world, mesh.nb2, mesh.nb1)
                    + tuple(local.shape[1:]), mesh, 3, local.element_size())
            del sim
            sent0 = gm.sent_bytes
            (local, dts), num = timed(lambda: mr_cycles(
                stepper.step, stepper.dt, pkg, local, ncycles))
            num["bytes_per_fill"] = (gm.sent_bytes - sent0) / (2 * ncycles)
            num["halo_bytes_per_fill"] = wanted
            num["dts"] = dts
            num["cells"] = mesh.nx1 * mesh.nx2 * mesh.nx3
            num["cycles"] = ncycles
            np.save(os.path.join(out_dir, f"{name}.r{r}.npy"),
                    local.cpu().numpy())
        elif kind == "tracers":
            spec = MR_TRACERS[case["path"]]
            kw = {k: spec[k] for k in ("shape", "mb", "per_cell", "vel",
                                       "seed")}
            kw["capacity_factor"] = spec.get("capacity_factor", 2.0)
            tr, st, prim = tracer_setup("cuda", **kw)
            nb = tr.mesh.nblocks
            per = nb // rmesh.world
            p_loc = prim[r * per:(r + 1) * per]
            advect, fill = make_sharded_tracer_ops(tr, rmesh)
            pool = shard_pool(st, rmesh, nb)

            def run_tracers(pool=pool):
                for _ in range(spec["steps"]):
                    pool = fill(advect(pool, p_loc, spec["dt"]), p_loc)
                return pool

            pool, num = timed(run_tracers)
            num["cells"] = nb * tr.mesh.mbnx1 * tr.mesh.mbnx2 * tr.mesh.mbnx3
            num["cycles"] = spec["steps"]
            num["layer_cap"] = tr.mesh.nb1 * tr.mesh.nb2 * tr.cap
            num["pool_active"] = int(st["active"][r * per:(r + 1) * per]
                                     .sum())
            np.savez(os.path.join(out_dir, f"{name}.r{r}.npz"),
                     **{k: v.cpu().numpy() for k, v in pool.items()})
        elif kind == "smr":
            sim = make_smr_sim(smr_deck("A", n=MR_SMR_N, ncycles=3,
                                        precision="single"), "stage",
                               quiet=True)
            sm = sim.smesh
            owner = flat_owners(sm, rmesh.world)
            sh = ShardedSmrHydro(sm, sim.cfg, sim.eos, owner, rmesh,
                                 device=sim.device, stage_rung=True)
            local = place(sim.state, sm, owner, r)
            del sim

            def run_smr(local=local):
                want = 0
                for _ in range(3):
                    dt = float(sh.estimate_dt(local))
                    local = sh.step(local, dt, 0.0)
                    want += 2 * len(local)
                return local, want

            (local, want), num = timed(run_smr)
            num["want_face_launches"] = want
            num["cells"] = int(sm.levels.size) * int(np.prod(
                (sm.base.mbnx1, sm.base.mbnx2, sm.base.mbnx3)))
            num["cycles"] = 3
            num["leaves"] = {str(k): int(v.shape[0]) for k, v in
                             local.items()}
            num.update(mr_fill_numbers(rmesh, sh, local))
            whole = gather(local, sm, owner, rmesh)
            if r == 0:
                np.savez(os.path.join(out_dir, f"{name}.npz"),
                         **{str(k): v.cpu().numpy() for k, v in
                            whole.items()})
        elif kind == "amr":
            amr, state = mr_amr_build(case, rmesh)
            (state, want), num = timed(lambda: mr_amr_ref(
                amr, state, case["ncycles"]))
            num["want_face_launches"] = want
            num["device_leaf_counts"] = amr.device_leaf_counts(state)
            num["remeshes"] = len(amr.remesh_log)
            num["changed"] = sum(e["changed"] for e in amr.remesh_log)
            num["cycles"] = case["ncycles"]
            num["cells"] = int(amr.smesh.levels.size) * 16 ** 3
            num.update(mr_fill_numbers(rmesh, amr._stepper, state))
            whole = amr.exact_state(state)
            if r == 0:
                np.savez(os.path.join(out_dir, f"{name}.npz"),
                         levels=amr.smesh.levels, lx1=amr.smesh.lx1,
                         lx2=amr.smesh.lx2, lx3=amr.smesh.lx3,
                         **{str(k): v.cpu().numpy() for k, v in
                            whole.items()})
        elif kind in MR_CLUSTER:
            amr, state, pkg = mr_cluster_build(case, rmesh)
            state, num = mr_cluster_run(amr, state, pkg, case, timed,
                                        whole_terms=r == 0)
            num.update(mr_fill_numbers(rmesh, amr._stepper, state))
            whole = amr.exact_state(state)
            if r == 0:
                np.savez(os.path.join(out_dir, f"{name}.npz"),
                         levels=amr.smesh.levels, lx1=amr.smesh.lx1,
                         lx2=amr.smesh.lx2, lx3=amr.smesh.lx3,
                         **{str(k): v.cpu().numpy() for k, v in
                            whole.items()})
            del amr, state, whole
        num["backend"] = rmesh.backend
        num["device"] = str(rmesh.device)
        res[name] = num
        torch.cuda.empty_cache()
    with open(os.path.join(out_dir, f"rank{r}.json"), "w") as f:
        json.dump(res, f)


MR_CASES_2 = [
    {"name": "M1 sweep", "kind": "uniform", "path": "M1", "rung": "sweep"},
    {"name": "M1 stage", "kind": "uniform", "path": "M1", "rung": "stage"},
    {"name": "M3", "kind": "tracers", "path": "M3"},
    {"name": "M3 overflow", "kind": "tracers", "path": "M3 overflow"},
    {"name": "M4 A", "kind": "smr"},
    {"name": "M4 D'", "kind": "amr", "n": 64, "rung": "negdiv",
     "ncycles": MR_AMR_CYCLES},
    {"name": "M5 stage", "kind": "cluster", "rung": "stage"},
    {"name": "M5 negdiv", "kind": "cluster", "rung": "negdiv"},
    {"name": "M5'", "kind": "cluster_amr", "rung": "stage"},
]
MR_CASES_4 = [{"name": "M2", "kind": "uniform", "path": "M2",
               "rung": "sweep", "grid": (2, 2)}]
# with one card per rank (NCCL), where that many cards are visible: every
# two-rank path, then M2 and the four-rank M1 and M5
MR_NCCL_4 = MR_CASES_4 + [
    {"name": "M1 sweep", "kind": "uniform", "path": "M1", "rung": "sweep"},
    {"name": "M5 stage", "kind": "cluster", "rung": "stage"}]


def mr_ranks(out, world):
    with open(os.path.join(out, f"rank{0}.json")) as f:
        keys = list(json.load(f))
    per = []
    for r in range(world):
        with open(os.path.join(out, f"rank{r}.json")) as f:
            per.append(json.load(f))
    return {k: [p[k] for p in per] for k in keys}


def mr_equal(what, got, want):
    got = torch.as_tensor(got).cpu()
    if not torch.equal(got, want.cpu()):
        diff = (got.double() - want.cpu().double()).abs()
        raise AssertionError(f"{what}: differs from the one-rank run "
                             f"(max |diff| {diff.max().item():.3e})")


def mr_reference(case, refs):
    """The one-rank run of a multi-rank case in this process, made once and
    kept in ``refs`` (the shared-card and the NCCL phases compare with the
    same run)."""
    name = case["name"]
    if name in refs:
        return refs[name]
    kind = case["kind"]
    if kind == "uniform":
        ref = mr_one_rank_uniform(case["path"], case["rung"])
    elif kind == "smr":
        sim = make_smr_sim(smr_deck("A", n=MR_SMR_N, ncycles=3,
                                    precision="single"), "stage", quiet=True)
        st = sim.state
        for _ in range(3):
            dt = float(sim.stepper.estimate_dt(st))
            st = sim.stepper.step(st, dt, 0.0)
        ref = (st, sim.smesh)
    elif kind == "amr":
        amr, state = mr_amr_build(case, None)
        st, _ = mr_amr_ref(amr, state, case["ncycles"])
        ref = (st, amr.smesh)
    elif kind in MR_CLUSTER:
        amr, state, pkg = mr_cluster_build(case, None)
        st, num = mr_cluster_run(amr, state, pkg, case,
                                 lambda fn: (fn(), {}))
        ref = (st, amr.smesh, num)
    else:
        return None
    refs[name] = ref
    return ref


def mr_check(case, per, out, world, refs, label):
    """Hold one multi-rank case's ranks (``per``: each rank's numbers; the
    states under ``out``) to its one-rank run, bit for bit, with the
    launches and bytes each rank should have: -> the case's numbers."""
    from athenapk_tpu_torch.parallel.dryrun import tracer_setup
    from athenapk_tpu_torch.parallel import halo, mesh_sharding as ms

    name, kind = case["name"], case["kind"]
    secs = max(p["seconds"] for p in per)
    zcps = per[0].get("zone_cycles", per[0]["cells"] * per[0]["cycles"]) \
        / secs
    backends = sorted({p["backend"] for p in per})
    entry = {"ranks": world, "seconds": secs, "backend": backends,
             "devices": [p["device"] for p in per],
             "zone_cycles_per_s": zcps, "rate_label": f"{world} {label}",
             "cycles": per[0]["cycles"],
             "launches_per_rank": [p["launches"] for p in per]}
    want_backend = "nccl" if label == MR_NCCL_LABEL else "gloo"
    if backends != [want_backend]:
        raise AssertionError(f"{name}: backends {backends}, not "
                             f"{want_backend}")
    if kind == "uniform":
        ref, dts = mr_reference(case, refs)
        for r, p in enumerate(per):
            if [tuple(x) for x in p["dts"]] != dts:
                raise AssertionError(f"{name}: rank {r} dts {p['dts']} "
                                     f"!= one-rank {dts}")
            got = np.load(os.path.join(out, f"{name}.r{r}.npy"))
            if case.get("grid"):
                gm = ms.RankMesh(r, world, case["grid"], ("z", "y"),
                                 torch.device("cuda"), "gloo")
                mesh = PORT.Mesh.from_parameter_input(
                    PORT.ParameterInput.from_string(mr_deck(case["path"])))
                sz, sy = halo.grid_sharding(mesh, gm)
                want = halo.to_grid(ref, mesh)[sz, sy]
            else:
                n = ref.shape[0] // world
                want = ref[r * n:(r + 1) * n]
            mr_equal(f"{name} rank {r}", got, want)
            if p["bytes_per_fill"] != p["halo_bytes_per_fill"]:
                raise AssertionError(
                    f"{name}: rank {r} sent {p['bytes_per_fill']} bytes "
                    f"per fill, the halo is {p['halo_bytes_per_fill']}")
        rung_counts = RUNG_LAUNCHES[case["rung"]]
        want_l = [k * MR_PATHS[case["path"]][4] for k in rung_counts]
        for r, p in enumerate(per):
            if p["launches"][:2] != want_l:
                raise AssertionError(f"{name}: rank {r} launches "
                                     f"{p['launches'][:2]} != {want_l}")
        entry.update(dts=dts, bytes_per_fill=[p["bytes_per_fill"]
                                              for p in per],
                     halo_bytes_per_fill=per[0]["halo_bytes_per_fill"],
                     state_bytes=int(ref.numel() * ref.element_size()))
    elif kind == "tracers":
        spec = MR_TRACERS[case["path"]]
        kw = {k: spec[k] for k in ("shape", "mb", "per_cell", "vel",
                                   "seed")}
        kw["capacity_factor"] = spec.get("capacity_factor", 2.0)
        tr, st, prim = tracer_setup("cuda", **kw)
        for _ in range(spec["steps"]):
            st = tr.fill(tr.advect(st, prim, spec["dt"]), prim)
        per_b = tr.mesh.nblocks // world
        for r in range(world):
            got = np.load(os.path.join(out, f"{name}.r{r}.npz"))
            for k, v in st.items():
                want = v if v.dim() < 2 else v[r * per_b:(r + 1) * per_b]
                mr_equal(f"{name} rank {r} {k}", got[k], want)
        n0 = int(tracer_setup("cuda", **kw)[1]["active"].sum())
        entry.update(active=int(st["active"].sum()), seeded=n0,
                     n_lost=int(st["n_lost"]),
                     layer_cap=per[0]["layer_cap"],
                     leavers_per_rank=[p["pool_active"] for p in per])
        if case["path"] == "M3 overflow":
            if int(st["n_lost"]) != 0 or entry["active"] != n0 \
                    or min(entry["leavers_per_rank"]) <= \
                    entry["layer_cap"]:
                raise AssertionError(f"{name}: {entry}")
    else:
        ref = mr_reference(case, refs)
        st, table = ref[0], ref[1]
        if kind == "amr":
            entry.update(device_leaf_counts=per[0]["device_leaf_counts"],
                         remeshes=per[0]["remeshes"],
                         tables_changed=per[0]["changed"])
            log(f"  {name}: device_leaf_counts "
                f"{per[0]['device_leaf_counts']}, {per[0]['remeshes']} "
                f"remeshes ({per[0]['changed']} changed the leaves)")
            if per[0]["changed"] < 1:
                raise AssertionError(f"{name}: no remesh changed the "
                                     "leaves")
        if kind in MR_CLUSTER:
            rnum = ref[2]
            for r, p in enumerate(per):
                for k in ("dts", "tables", "host_reads_per_cycle",
                          "hook_reads_per_call", "hook_calls_per_cycle"):
                    if p[k] != rnum[k]:
                        raise AssertionError(
                            f"{name}: rank {r} {k} {p[k]} != the one-rank "
                            f"run's {rnum[k]}")
                if p["collectives"] != 2 * p["cycles"]:
                    raise AssertionError(
                        f"{name}: rank {r} made {p['collectives']} "
                        f"collectives in {p['cycles']} cycles (one a stage)")
            if kind == "cluster_amr" and len({json.dumps(t, sort_keys=True)
                                              for t in rnum["tables"]}) < 2:
                raise AssertionError(f"{name}: no remesh changed the leaves")
            entry.update(dts=rnum["dts"], tables=rnum["tables"],
                         leaves_held=[p["leaves_held"] for p in per],
                         host_reads_per_cycle=[p["host_reads_per_cycle"]
                                               for p in per],
                         one_rank_host_reads_per_cycle=rnum[
                             "host_reads_per_cycle"],
                         hook_reads_per_call=per[0]["hook_reads_per_call"],
                         collectives_per_stage=per[0]["collectives"]
                         / (2 * per[0]["cycles"]))
            log(f"  {name}: leaves per cycle {rnum['tables']}; host reads "
                f"per cycle {entry['host_reads_per_cycle']} per rank (one "
                f"rank {rnum['host_reads_per_cycle']}), the unsplit hook's "
                f"{entry['hook_reads_per_call']} per call, "
                f"{rnum['hook_calls_per_cycle']} calls per cycle; "
                f"collectives per stage {entry['collectives_per_stage']}")
            if "injection" in rnum:
                entry["injection_one_rank"] = injection_check(
                    rnum["injection"], rnum["injection_calls"],
                    f"{name}, one rank")
                entry["injection"] = injection_check(
                    np.sum([p["injection"] for p in per], axis=0).tolist(),
                    per[0]["injection_calls"], f"{name}, {world} ranks")
        got = np.load(os.path.join(out, f"{name}.npz"))
        if kind != "smr":
            for k in ("levels", "lx1", "lx2", "lx3"):
                if not np.array_equal(got[k], getattr(table, k)):
                    raise AssertionError(f"{name}: leaf table differs")
        for lev, v in st.items():
            mr_equal(f"{name} level {lev}", got[str(lev)], v)
        face = 0 if (kind == "smr" or case.get("rung") == "stage") else 1
        for r, p in enumerate(per):
            if p["launches"][2 + face] != p["want_face_launches"]:
                raise AssertionError(
                    f"{name}: rank {r} face launches {p['launches']} != "
                    f"{p['want_face_launches']}")
            if not (p["bytes_per_fill"] == p["plan_bytes_per_fill"]
                    and 0 < p["bytes_per_fill"] <= p["face_slab_bytes"]
                    and p["bytes_per_fill"] < p["all_gather_bytes"]):
                raise AssertionError(
                    f"{name}: rank {r} sent {p['bytes_per_fill']} bytes "
                    f"per fill; its schedule {p['plan_bytes_per_fill']}, "
                    f"the face slabs {p['face_slab_bytes']}, an "
                    f"all-gather {p['all_gather_bytes']}")
        entry.update(bytes_per_fill=[p["bytes_per_fill"] for p in per],
                     plan_bytes_per_fill=[p["plan_bytes_per_fill"]
                                          for p in per],
                     face_slab_bytes=[p["face_slab_bytes"] for p in per],
                     all_gather_bytes=[p["all_gather_bytes"] for p in per],
                     state_bytes=int(sum(v.numel() * v.element_size()
                                         for v in st.values())))
    log(f"  {name}: {world} ranks ({'/'.join(backends)}), bit for bit with "
        f"one rank; {secs:.3f} s; launches per rank "
        f"{entry['launches_per_rank']}; {zcps:.6e} zone-cycles/s ({world} "
        f"{label})"
        + (f"; bytes sent per fill per rank {entry['bytes_per_fill']} "
           f"(= the plan's; the state: {entry['state_bytes']})"
           if "bytes_per_fill" in entry else "")
        + (f"; face-slab bound {entry['face_slab_bytes']}, all-gather "
           f"{entry['all_gather_bytes']}"
           if "face_slab_bytes" in entry else ""))
    return entry


def mr_phase(runs, label, cards, refs):
    """Spawn the ranks of each ``(world, cases)`` of ``runs`` on the card
    (``cards``: how many cards they use: 1 shares one over gloo, ``world``
    puts one rank on each over NCCL) and hold each case to its one-rank
    run (``mr_check``).  A failed rank fails the phase.  -> ``{(world,
    name): numbers}``."""
    from athenapk_tpu_torch.parallel.dryrun import run_ranks

    nums = {}
    for world, cases in runs:
        out = tempfile.mkdtemp(dir=str(OUT.parent) if OUT.parent.exists()
                               else None)
        try:
            t0 = time.time()
            run_ranks(mr_rank, world, (out, cases), device="cuda",
                      timeout=900, cards=cards or world)
            log(f"  {world} ranks ({label}): {time.time() - t0:.1f} s "
                f"(spawn included)")
            results = mr_ranks(out, world)
            for case in cases:
                nums[world, case["name"]] = mr_check(
                    case, results[case["name"]], out, world, refs, label)
        finally:
            shutil.rmtree(out, ignore_errors=True)
    return nums


def phase_multirank(refs):
    """The multi-rank paths with every rank on the one
    card (gloo, messages staged through pinned host buffers; on a machine
    with more cards too), each against its one-rank run in this process
    bit for bit; then M1's step with nccl at world size 1.  -> {path:
    numbers} with each rank's launches."""
    from athenapk_tpu_torch.parallel import halo, mesh_sharding as ms

    log("== phase 4: multi-rank paths with the ranks sharing one card "
        "(M1-M5, NCCL at world size 1) ==")
    t_phase = time.time()
    nums = {name: v for (_, name), v in mr_phase(
        ((2, MR_CASES_2), (4, MR_CASES_4)), MR_LABEL, 1, refs).items()}

    # nccl at world size 1: M1's step on the sweep rung, bit for bit
    ref, dts = mr_reference(MR_CASES_2[0], refs)
    sim = make_sim(mr_deck("M1"), "sweep")
    with tempfile.TemporaryDirectory() as tmp:
        rm = ms.init_rank_mesh(0, 1, "file://" + os.path.join(tmp, "r"),
                               "cuda")
        try:
            if rm.backend != "nccl":
                raise AssertionError(f"world size 1 chose {rm.backend}")
            stepper = halo.make_sharded_step(sim.pkg, rm)
            torch.cuda.synchronize()
            reset_counts()
            got, got_dts = mr_cycles(stepper.step, stepper.dt, sim.pkg,
                                     sim.u, MR_PATHS["M1"][4])
            launches = list(read_counts())
        finally:
            torch.distributed.destroy_process_group()
    mr_equal("M1 nccl world 1", got, ref)
    if got_dts != dts:
        raise AssertionError(f"nccl dts {got_dts} != {dts}")
    want_l = [k * MR_PATHS["M1"][4] for k in RUNG_LAUNCHES["sweep"]]
    if launches != want_l:
        raise AssertionError(f"nccl launches {launches} != {want_l}")
    nums["M1 nccl"] = {"ranks": 1, "backend": "nccl", "launches":
                       launches, "dts": dts}
    log(f"  M1 with nccl at world size 1: bit for bit with the plain "
        f"step (state and {len(dts)} dts), launches {launches}")
    del sim, got
    log(f"  multi-rank phase: {time.time() - t_phase:.1f} s")
    return nums


def phase_multirank_nccl(refs):
    """The multi-rank paths with one card per rank over NCCL (CUDA
    tensors sent directly, nothing staged), each against the same one-rank
    run as the shared-card phase, bit for bit: every two-rank path where
    two cards are visible, M2 and the four-rank M1 and M5 where four are.
    On a one-card machine it says so and runs nothing (the shared-card
    phase ran every path).  -> ``{"name (N ranks, nccl)": numbers}``."""
    n = torch.cuda.device_count()
    log(f"== phase 4: multi-rank paths with one card per rank over NCCL "
        f"({n} card(s) visible) ==")
    if n < 2:
        log("  not run: one rank per card needs at least 2 cards and this "
            f"machine shows {n}; the shared-card phase above ran M1-M5")
        return {}
    t_phase = time.time()
    runs = [(2, MR_CASES_2)]
    if n >= 4:
        runs.append((4, MR_NCCL_4))
    else:
        log(f"  M2 and the four-rank M1 and M5 not run: {n} cards visible, "
            "they take 4")
    got = mr_phase(runs, MR_NCCL_LABEL, None, refs)
    log(f"  NCCL phase: {time.time() - t_phase:.1f} s")
    return {f"{name} ({world} ranks, nccl)": v
            for (world, name), v in got.items()}


def entry_route(entry):
    """The phase-3 route label prefix of a kernel line entry."""
    return {"negdiv_sweep": "#1", "fused_stage": "#3", "negdiv_sweep_2d": "#4",
            "fused_stage_faces": "#7", "negdiv_sweep_faces": "#6/#2",
            "negdiv_sweep_faces_2d": "#5"}[entry["name"]]


def load_port():
    """Import the port's modules into ``PORT`` (ImportError where the port
    is not beside this script)."""
    global PORT
    from athenapk_tpu_torch.amr.driver import SmrSimulation
    from athenapk_tpu_torch.amr.remesh import AmrHydro
    from athenapk_tpu_torch.amr.smr import SmrState
    from athenapk_tpu_torch.amr.smr_hydro import SmrHydro
    from athenapk_tpu_torch.config.parameter_input import ParameterInput
    from athenapk_tpu_torch.core import amr_forest, kernels
    from athenapk_tpu_torch.core.mesh import Mesh
    from athenapk_tpu_torch import driver
    from athenapk_tpu_torch.driver import Simulation
    from athenapk_tpu_torch.outputs.restart import (restart_payload,
                                                    restart_payload_smr)
    from athenapk_tpu_torch.eos import adiabatic, adiabatic_cuda
    from athenapk_tpu_torch.eos.adiabatic import (EOS, cons_to_prim,
                                                  prim_to_cons)
    from athenapk_tpu_torch.recon import schemes
    from athenapk_tpu_torch.solver import stage, sweep
    from athenapk_tpu_torch.solver.hydro_pkg import (HydroConfig,
                                                     rkl2_stage_count)
    from athenapk_tpu_torch.srcterms import TabularCooling
    from athenapk_tpu_torch.srcterms import tabular_cooling_cuda
    from athenapk_tpu_torch.srcterms.tabular_cooling import PASS_COUNTS
    from athenapk_tpu_torch.utils import exact_riemann
    # the decks shared with the CPU tests (numpy only)
    sys.path.insert(0, str(ROOT / "tests"))
    import torch_decks
    PORT = types.SimpleNamespace(TabularCooling=TabularCooling,
        decks=torch_decks, rkl2_stage_count=rkl2_stage_count,
        PASS_COUNTS=PASS_COUNTS,
        ParameterInput=ParameterInput, Mesh=Mesh, Simulation=Simulation,
        EOS=EOS, cons_to_prim=cons_to_prim, prim_to_cons=prim_to_cons,
        stage=stage, sweep=sweep, HydroConfig=HydroConfig,
        exact_riemann=exact_riemann, SmrSimulation=SmrSimulation,
        amr_forest=amr_forest, kernels=kernels, AmrHydro=AmrHydro,
        SmrHydro=SmrHydro,
        SmrState=SmrState, schemes=schemes, driver=driver,
        restart_payload=restart_payload,
        restart_payload_smr=restart_payload_smr, adiabatic=adiabatic,
        adiabatic_cuda=adiabatic_cuda,
        tabular_cooling_cuda=tabular_cooling_cuda)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the kernel-against-plain states")
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's chip check needs one",
              file=sys.stderr)
        return 1
    try:
        load_port()
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script ({e})",
              file=sys.stderr)
        return 1
    t_start = time.time()

    log("== phase 1: card ==")
    card = card_line()
    log(f"  nvidia-smi: {card}")
    log(f"  torch {torch.__version__} (CUDA {torch.version.cuda}), device "
        f"{torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}")

    phase_build()
    phase_kernel_vs_plain(args.seed)
    new_case_worst = phase_new_cases(args.seed)
    scalar_worst = phase_scalar_cases(args.seed)

    sims, counts, zcps = {}, {}, {}
    for rung in RUNGS:
        sims[rung], counts[rung], zcps[rung] = phase_main_deck(
            rung, n=256, ncycles=12, warmup=2)
    ot, ot_launches, zcps["orszag_tang_2048"] = phase_orszag_tang(
        n=2048, ncycles=12, warmup=2)
    sod_launches, sod_cycles = phase_sod(n=1024)
    smr, smr_counts = {}, {}
    for path in SMR_PATHS:
        smr[path], smr_counts[path], zcps[f"smr_{path}"] = phase_smr_path(
            path, n=2048 if path == "C" else 128, ncycles=12, warmup=2)
    amr, amr_face = {}, {}
    for path in AMR_PATHS:
        amr[path], amr_face[path], amr_face[f"{path} numbers"] = \
            phase_amr_path(path, ncycles=25, warmup=10)
        zcps[f"amr_{path}"] = amr_face[f"{path} numbers"][
            "zone_cycles_per_s"]
    perf = phase_perf_matrix(n=256, ncycles=12, warmup=2)
    fofc_u, fofc_r = phase_fofc_path(n=256, ncycles=12, warmup=2)
    for name, run in perf.items():
        zcps[f"path_E {name}"] = run["zcps"]
    zcps["path_F"] = fofc_u["zcps"]
    zcps["path_F refined"] = fofc_r["zcps"]
    # the cloud-crushing paths (each kernel's launches counted from
    # 0 just before the path's run)
    cloud_u, cloud_a = {}, {}
    for rung in ("sweep", "stage"):
        # 5 cycles, not the other paths' 8-12: rk12's cycles take ~1 s each
        cloud_u[rung] = phase_cloud_uniform(rung, n=128, ncycles=5,
                                            warmup=2)
        zcps[f"path_G' {rung}"] = cloud_u[rung][1]["zone_cycles_per_s"]
    for rung in ("stage", "negdiv"):
        cloud_a[rung] = phase_cloud_adaptive(rung, n=64, ncycles=30,
                                             warmup=10)
        zcps[f"path_G {rung}"] = cloud_a[rung][1]["zone_cycles_per_s"]
    cooling_passes = phase_cooling_passes(n=128, ncycles=1)
    path_h, path_i, path_i2, stage_prim_h = phase_source_paths(zcps)
    path_j, path_j2 = phase_tracer_paths(zcps)
    path_k = phase_cluster_paths(zcps)
    cluster_steps = phase_source_whole_steps(cluster_whole_step_cases(),
                                             "the cluster decks")
    source_steps = phase_source_whole_steps()
    amr_tracers = phase_amr_tracers(args.seed)
    restarts = phase_restart_on_card()
    trace_cli = phase_trace_cli()
    mr_refs = {}
    multirank = phase_multirank(mr_refs)
    multirank_nccl = phase_multirank_nccl(mr_refs)
    del mr_refs
    MR_CLUSTER_SIMS.clear()
    phase_whole_steps(args.seed)
    smr_drift = phase_smr_whole_steps(args.seed)
    amr_2d_launches = phase_amr_whole_steps(args.seed)
    phase_fofc_whole_steps()
    phase_cloud_whole_steps()
    phase_smr_kernels_vs_plain(smr["A"], "A", "stage-faces")
    phase_smr_kernels_vs_plain(smr["B"], "B", "negdiv-faces")
    phase_smr_kernels_vs_plain(smr["C"], "C", "negdiv-faces")
    # at the adaptive paths' level arrays after their last remesh
    phase_smr_kernels_vs_plain(amr["D"], "D", "stage-faces")
    phase_smr_kernels_vs_plain(amr["D'"], "D'", "negdiv-faces")
    # the +scalars instantiations path G runs (f32 GLM-MHD HLLD + PLM,
    # nghost 2) and the scalar kernels at its level arrays
    phase_smr_kernels_vs_plain(cloud_a["stage"][0], "G", "stage-faces")
    phase_smr_kernels_vs_plain(cloud_a["negdiv"][0], "G", "negdiv-faces")

    sim = sims["stage"]
    by_path = {"main deck, sweep rung": counts["sweep"][0],
               "main deck, stage rung": counts["stage"][0],
               "Orszag-Tang 2048^2": ot_launches, "Sod 1024": sod_launches}
    cycles = {path: sims["sweep"].ncycle for path in by_path}
    cycles["Orszag-Tang 2048^2"] = ot.ncycle
    cycles["Sod 1024"] = sod_cycles
    sweep_entry = phase_sweep_timings(
        sim, counts["sweep"][0], 10, "negdiv_sweep",
        "athenapk_tpu/solver/pallas_sweep.py:37", "the main deck",
        f64_rows=True)
    sweep_entry["launches_by_path"] = by_path
    stage_entry = phase_stage_timings(sim, counts["stage"][1], 10)
    stage_entry["launches_by_path"] = {
        "main deck, sweep rung": counts["sweep"][1],
        "main deck, stage rung": counts["stage"][1]}
    eos_entry = phase_eos_timings(sims["sweep"], {
        f"main deck, {rung} rung": counts[rung][2] for rung in RUNGS}, 10)
    cooling_entry = phase_cooling_timings(10, args.seed)
    flat_entry = phase_sweep_timings(
        ot, ot_launches, 10, "negdiv_sweep_2d",
        "athenapk_tpu/solver/pallas_sweep.py:343", "the Orszag-Tang deck")
    flat_entry["launches_by_path"] = {"Orszag-Tang 2048^2": ot_launches,
                                      "Sod 1024": sod_launches}

    faces_a = phase_smr_timings(
        smr["A"], "stage-faces", smr_counts["A"][0], 10, "fused_stage_faces",
        "athenapk_tpu/solver/pallas_sweep.py:641", "refined-mesh path A")
    # this slice's main path: the entry's numbers are path D's, path A's
    # stay beside them
    faces_entry = phase_smr_timings(
        amr["D"], "stage-faces", amr_face["D"], 10, "fused_stage_faces",
        "athenapk_tpu/solver/pallas_sweep.py:641", "adaptive path D")
    faces_entry["at_path_A"] = {k: faces_a[k] for k in (
        "ms", "plain_ms", "bound_ms", "share_of_bound", "bound_by",
        "max_abs_err", "unit")}
    nd3_entry = phase_smr_timings(
        smr["B"], "negdiv-faces", smr_counts["B"][1], 10,
        "negdiv_sweep_faces", "athenapk_tpu/solver/pallas_sweep.py:418",
        "refined-mesh path B")
    nd3_entry["also_replaces"] = "athenapk_tpu/solver/pallas_sweep.py:81 " \
        "(make_lane_sweep_negdiv_faces, composed by make_fused_negdiv_faces " \
        ":955: the same contract, a TPU layout choice)"
    nd2_entry = phase_smr_timings(
        smr["C"], "negdiv-faces", smr_counts["C"][1], 10,
        "negdiv_sweep_faces_2d", "athenapk_tpu/solver/pallas_sweep.py:457",
        "refined-mesh path C")
    smr_entries = {"A": faces_entry, "B": nd3_entry, "C": nd2_entry}
    for path, entry in smr_entries.items():
        entry["launches_by_path"] = {f"SMR path {path}":
                                     sum(smr_counts[path])}
        entry["launches_per_cycle"] = {
            f"SMR path {path}": sum(smr_counts[path]) / smr[path].ncycle}
        entry["zone_cycles_per_s"] = {f"SMR path {path}":
                                      zcps[f"smr_{path}"]}
    faces_entry["mass_drift_f64_5_cycles"] = smr_drift
    # the adaptive paths: each kernel's launches from the run of the path
    # that drives it (its counts set to 0 just before, read just after)
    for path, entry in (("D", faces_entry), ("D'", nd3_entry)):
        numbers = amr_face[f"{path} numbers"]
        entry["launches"] = amr_face[path]
        entry["launches_by_path"][f"adaptive path {path}"] = amr_face[path]
        entry["launches_per_cycle"][f"adaptive path {path}"] = \
            numbers["launches_per_cycle"]
        entry["zone_cycles_per_s"][f"adaptive path {path}"] = \
            numbers["zone_cycles_per_s"]
        entry[f"adaptive_path_{path}"] = numbers
    nd2_entry["launches"] = amr_2d_launches
    nd2_entry["launches_by_path"]["2-D adaptive blast 256^2, f64, 5 "
                                  "cycles"] = amr_2d_launches
    nd2_entry["launches_per_cycle"]["2-D adaptive blast 256^2, f64, 5 "
                                    "cycles"] = amr_2d_launches / 5

    # this slice's new cases: a row each at paths E and F's own inputs
    log("== phase 6: timings of the new cases at paths E and F's inputs ==")
    case_rows = phase_case_timings(
        {**{name: run for name, run in perf.items()},
         "path F (FOFC blast)": {**fofc_u, "rung": "sweep"}}, 10)
    fofc_faces = phase_smr_timings(
        fofc_r["sim"], "negdiv-faces", fofc_r["launches"], 10,
        "negdiv_sweep_faces", "athenapk_tpu/solver/pallas_sweep.py:525",
        "path F on the refined mesh")
    fofc_stage_faces = phase_smr_timings(
        fofc_r["sim"], "stage-faces", 0, 10, "fused_stage_faces",
        "athenapk_tpu/solver/pallas_sweep.py:641",
        "path F's refined level arrays (not a call of the path: FOFC takes "
        "the negdiv-faces rung)")
    cases = {"reconstructions": RECON_NAMES,
             "solvers": [f"{f} {r}" for f, r in SOLVER_PAIRS]}
    for entry in (sweep_entry, stage_entry, flat_entry, faces_entry,
                  nd3_entry, nd2_entry):
        entry["cases"] = cases
        entry["new_cases_max_rel_err"] = {
            k: v for k, v in new_case_worst.items()
            if k.startswith(entry_route(entry))}
    sweep_entry["new_cases"] = {k: v for k, v in case_rows.items()
                                if v["route"].startswith("#1")}
    stage_entry["new_cases"] = {k: v for k, v in case_rows.items()
                                if v["route"].startswith("#3")}
    nd3_entry["new_cases"] = {"path F refined (FOFC, LimO3 + HLLC)": {
        k: fofc_faces[k] for k in ("ms", "plain_ms", "bound_ms",
                                   "share_of_bound", "bound_by",
                                   "max_abs_err", "unit", "per_call")}}
    nd3_entry["new_cases"]["path F refined (FOFC, LimO3 + HLLC)"].update(
        launches_on_path=fofc_r["launches"], cycles=fofc_r["cycles"],
        zone_cycles_per_s=fofc_r["zcps"], stages_rescued=fofc_r["rescues"],
        level_stages=fofc_r["stages"])
    faces_entry["new_cases"] = {"LimO3 + HLLC at path F's refined level "
                                "arrays": {
        k: fofc_stage_faces[k] for k in ("ms", "plain_ms", "bound_ms",
                                         "share_of_bound", "bound_by",
                                         "max_abs_err", "unit", "per_call")}}
    for name, run in perf.items():
        key = f"path E {name}"
        entry = stage_entry if run["rung"] == "stage" else sweep_entry
        entry["launches_by_path"][key] = run["launches"]
        cycles[key] = run["cycles"]
    sweep_entry["launches_by_path"]["path F (FOFC blast)"] = \
        fofc_u["launches"]
    cycles["path F (FOFC blast)"] = fofc_u["cycles"]
    nd3_entry["launches_by_path"]["path F refined (FOFC blast)"] = \
        fofc_r["launches"]
    nd3_entry["launches_per_cycle"]["path F refined (FOFC blast)"] = \
        fofc_r["launches"] / fofc_r["cycles"]
    # paths H, I and I': each kernel's launches from the run of the path
    for (integ, rung), num in path_h.items():
        key = f"path H ({integ} diffusion), {rung} rung"
        entry = stage_entry if rung == "stage" else sweep_entry
        entry["launches_by_path"][key] = num["launches"]
        cycles[key] = num["cycles"]
        entry.setdefault("path_H", {})[f"{integ}, {rung} rung"] = num
    stage_entry["path_H_stage_prim_max_rel_err"] = stage_prim_h
    for rung, num in path_i.items():
        key = f"path I (turbulence 256^3), {rung} rung"
        entry = stage_entry if rung == "stage" else sweep_entry
        entry["launches_by_path"][key] = num["launches"]
        cycles[key] = num["cycles"]
        entry.setdefault("path_I", {})[f"{rung} rung"] = num
    for rung, num in path_i2.items():
        key = f"path I' (refined turbulence), {rung} rung"
        entry = faces_entry if rung == "stage" else nd3_entry
        entry["launches_by_path"][key] = num["launches"]
        entry["launches_per_cycle"][key] = num["launches_per_cycle"]
        entry["zone_cycles_per_s"][key] = num["zone_cycles_per_s"]
        entry["path_I_prime"] = num
    # paths J and J' (tracers): each kernel's launches from the path's run
    for rung, num in path_j.items():
        key = f"path J (turbulence 256^3 + tracers), {rung} rung"
        entry = stage_entry if rung == "stage" else sweep_entry
        entry["launches_by_path"][key] = num["launches"]
        cycles[key] = num["cycles"]
        entry.setdefault("path_J", {})[f"{rung} rung"] = num
    for rung, num in path_j2.items():
        key = f"path J' (refined turbulence + tracers), {rung} rung"
        entry = faces_entry if rung == "stage" else nd3_entry
        entry["launches_by_path"][key] = num["launches"]
        entry["launches_per_cycle"][key] = num["launches_per_cycle"]
        entry["zone_cycles_per_s"][key] = num["zone_cycles_per_s"]
        entry["path_J_prime"] = num
    nd3_entry["adaptive_tracers_f64"] = amr_tracers
    sweep_entry["restart_on_card"] = restarts
    sweep_entry["trace_cli"] = trace_cli
    sweep_entry["source_decks_whole_steps_f64"] = source_steps

    scalar_rows = phase_scalar_timings(cloud_u["sweep"][0], {
        "negdiv_scalars": cloud_u["sweep"][1]["scalar_launches"],
        "stage_scalars": cloud_a["stage"][1]["scalar_launches"]}, 10)
    scalar_entries = [scalar_rows["negdiv_scalars"],
                      scalar_rows["stage_scalars"]]
    for entry in scalar_entries:
        entry["scalar_cases_max_rel_err"] = scalar_worst
        entry["whole_calls_with_a_scalar"] = {
            k: v for k, v in scalar_rows.items() if k.startswith("#")}
    scalar_entries[0]["launches_by_path"] = {
        f"path G' {r} rung": cloud_u[r][1]["scalar_launches"]
        for r in cloud_u} | {f"path G {r} rung": cloud_a[r][1][
            "scalar_launches"] for r in ("negdiv",)}
    scalar_entries[1]["launches_by_path"] = {
        "path G' stage rung": cloud_u["stage"][1]["scalar_launches"],
        "path G stage rung": cloud_a["stage"][1]["scalar_launches"]}
    # paths K, K' and K'' (the cluster): each kernel's launches from the
    # run of the path (its counts set to 0 just before, read just after)
    for (path, rung), num in path_k.items():
        key = f"path {path} (cluster), {rung} rung"
        if path == "K":
            entry = faces_entry if rung == "stage" else nd3_entry
            entry["launches_per_cycle"][key] = num["launches_per_cycle"]
            entry["zone_cycles_per_s"][key] = num["zone_cycles_per_s"]
        else:
            entry = stage_entry if rung == "stage" else sweep_entry
            cycles[key] = num["cycles"]
        entry["launches_by_path"][key] = num["launches"]
        entry.setdefault("path_K", {})[f"{path}, {rung} rung"] = num
        scalar_entries[1 if rung == "stage" else 0]["launches_by_path"][
            key] = num["scalar_launches"]
    sweep_entry["cluster_decks_whole_steps_f64"] = cluster_steps
    # the cooling kernels' calls (update, dt) by path, from each run's
    # counters, and per cycle
    cool_by_path, cool_per_cycle = {}, {}
    cool_runs = [(f"path {path} (cluster), {rung} rung", num, num["cycles"])
                 for (path, rung), num in path_k.items()]
    cool_runs += [(f"path G' (cloud, rk12), {r} rung", v[1], v[1]["cycles"])
                  for r, v in cloud_u.items()]
    cool_runs += [(f"path G (adaptive cloud), {r} rung", v[1],
                   v[1]["cycles"]) for r, v in cloud_a.items()]
    cool_runs += [(f"phase 5 {label}, kernel run", num, 5)
                  for label, num in cluster_steps.items()]
    for key, num, ncycles in cool_runs:
        cool_by_path[key] = num["cooling_launches"]
        cool_per_cycle[key] = {k: n / ncycles
                               for k, n in num["cooling_launches"].items()}
    cooling_entry["launches"] = cool_by_path["path K' (cluster), sweep rung"]
    cooling_entry["launches_by_path"] = cool_by_path
    cooling_entry["launches_per_cycle"] = cool_per_cycle
    cooling_entry["launches_note"] = (
        "calls of the update and of the dt; a dt call is two launches; "
        "the uniform paths' runs include one dt for their initial dt")
    # the multi-rank paths: each rank's launches from its own run (its
    # counts set to 0 just before, read just after), summed over the ranks
    # (entry, launch counter, whether the entry's per-cycle counts come
    # from ``cycles``)
    route = {"M1 sweep": (sweep_entry, 0, True), "M2": (sweep_entry, 0, True),
             "M1 stage": (stage_entry, 1, True),
             "M4 A": (faces_entry, 2, False), "M4 D'": (nd3_entry, 3, False),
             "M5 stage": (faces_entry, 2, False),
             "M5 negdiv": (nd3_entry, 3, False),
             "M5'": (faces_entry, 2, False)}
    for name, num in list(multirank.items()) + list(multirank_nccl.items()):
        if name == "M1 nccl":
            key = "M1 sweep rung, nccl at world size 1"
            sweep_entry["launches_by_path"][key] = num["launches"][0]
            cycles[key] = len(num["dts"])
            continue
        base = name.split(" (")[0]
        if base not in route:
            continue
        entry, k, by_cycles = route[base]
        key = (name if "nccl" in name
               else f"{name} ({num['ranks']} ranks on one card)")
        n = sum(per[k] for per in num["launches_per_rank"])
        entry["launches_by_path"][key] = n
        if by_cycles:
            cycles[key] = num["cycles"]
        else:
            entry["launches_per_cycle"][key] = n / num["cycles"]
            entry["zone_cycles_per_s"][key] = num["zone_cycles_per_s"]
    sweep_entry["multi_rank"] = multirank
    sweep_entry["multi_rank_nccl"] = multirank_nccl
    scalar_entries[0]["path_G_prime"] = {r: v[1] for r, v in cloud_u.items()}
    scalar_entries[0]["path_G_prime_cooling_passes"] = cooling_passes
    scalar_entries[1]["path_G"] = {r: v[1] for r, v in cloud_a.items()}
    # one cycle: an rk12 cycle (~1.5 s, hundreds of cooling passes) takes
    # ~8 s under the profiler; one attempt: its trace (hundreds of cooling
    # passes) loses events on the H100, a second attempt too
    scalar_entries[0]["path_G_prime_profile"] = {
        r: phase_profile(cloud_u[r][0], 1, f"path G' ({r} rung)",
                         attempts=1)
        for r in cloud_u}
    scalar_entries[1]["path_G_profile"] = phase_amr_profile(
        cloud_a["stage"][0], 3, "path G (stage rung)")

    profiles = {}
    e_name = "-".join(PERF_MATRIX[-1])
    profiles["path_E"] = phase_profile(perf[e_name]["sim"], 3,
                                       f"path E, {e_name}")
    fresh = make_sim(fofc_deck(256, 3, "single"))
    profiles["path_F"] = phase_profile(
        fresh, 3, "path F from its initial state (the first cycle's stage "
        "takes the rescue)")
    log(f"  stages rescued in the profiled cycles: {fresh.pkg.fofc_rescues}")
    del fresh
    sweep_entry["path_E_profile"] = profiles["path_E"]
    sweep_entry["path_F_profile"] = profiles["path_F"]
    faces_entry["adaptive_path_D"]["profile"] = phase_amr_profile(
        amr["D"], 3, "adaptive path D")
    for path in SMR_PATHS:
        smr_entries[path]["main_path_profile"] = phase_smr_profile(
            smr[path], 3, f"refined-mesh path {path}")
    for rung in RUNGS:
        profiles[rung] = phase_profile(sims[rung], 3,
                                       f"the main deck, {rung} rung")
    profiles["orszag_tang_2048"] = phase_profile(ot, 3, "the Orszag-Tang deck")
    sweep_entry["zone_cycles_per_s"] = zcps["sweep"]
    sweep_entry["main_path_profile"] = profiles["sweep"]
    stage_entry["zone_cycles_per_s"] = {k: zcps[k] for k in RUNGS}
    stage_entry["main_path_profile"] = {"stage": profiles["stage"]}
    flat_entry["zone_cycles_per_s"] = zcps["orszag_tang_2048"]
    flat_entry["main_path_profile"] = profiles["orszag_tang_2048"]
    for entry in (sweep_entry, stage_entry, flat_entry):
        # from this run's counts, not from what a rung should launch;
        # path E and F runs count their own cycles
        entry["launches_per_cycle"] = {
            path: n / cycles[path]
            for path, n in entry["launches_by_path"].items()}
    log(f"  zone-cycles/wallsecond: " + ", ".join(
        f"{k} {v:.6e}" for k, v in zcps.items()))
    log(f"== done in {time.time() - t_start:.1f} s ==")

    print(json.dumps({"kernels": [sweep_entry, stage_entry, flat_entry,
                                  faces_entry, nd3_entry, nd2_entry]
                      + scalar_entries + [eos_entry, cooling_entry]}),
          flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

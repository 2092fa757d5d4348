"""Deck-driven simulations on refined meshes, static and adaptive (torch).

Counterpart of ``athenapk_tpu/amr/driver.py`` for ``<parthenon/mesh>
refinement = static | adaptive`` (the reference's mesh modes, e.g.
``inputs/cluster/cluster.in:26`` and ``inputs/blast_3d_adaptive.in``).
Problem set-up reuses the uniform problem generators through a per-leaf
adapter: each leaf gets a one-block ``Mesh`` spanning its own bounds, so
``pgen.problem_generator`` evaluates its fields at the leaf's cell centres,
as the reference calls ``ProblemGenerator`` per MeshBlock at any level.

The loop is the JAX package's pipelined one: the dt package ``[dt_raw,
dt_eff, c_h]`` (CFL dt, 2x growth cap, tlim clamp, GLM speed) is computed on
the device, and the one read of it per cycle comes after the cycle's step
is enqueued.  (The kernels take their scalars from the host, so the step is
enqueued with the dt read in the cycle before; the dt sequence is the JAX
package's.)

Adaptive meshes (``amr.remesh.AmrHydro``): the initial grid is Parthenon's
``Mesh::Initialize`` loop (tag, remesh, regenerate the problem on the new
topology, up to ``numlevel`` times).  Every ``check_interval`` cycles the
run remeshes at the start of the cycle; its tags are enqueued right after
the previous step and read in the same host read as the dt package.  A
remesh that changes the leaf table changes the state, so that cycle reads
its dt once more.  The stepper and the mesh of the moment come from
``_stepper_now()`` / ``_smesh_now()``.

Outputs: the ``.hst`` file summed over levels, the ``cycle=`` lines with
the leaves per level, ``mesh structure`` lines (``ncycle_out_mesh``; a
negative value also prints on every remesh) and ``zone-cycles/wallsecond``
(zones summed over each cycle's leaves).

The problem's hooks, as the JAX driver wires them
(``athenapk_tpu/amr/driver.py:179-197``): ``register_boundary_conditions_smr``
gives the ghost fill its boundary conditions, ``check_refinement_block``
tags blocks beside the criterion (adaptive meshes, combined by ``max``);
tabular cooling is built as the uniform driver builds it
(``driver.make_cooling``) and acts on every level.

The state lives on ``cuda`` unless the caller asks for the CPU; asking for
CUDA where there is none raises.  Not ported (``NotImplementedError``):
restart, hdf5 and rst outputs, tracers, diffusion, and the problems whose
split sources the JAX driver calls (``rand_blast``, ``turbulence``,
``cluster``).
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from ..config.parameter_input import ParameterInput
from ..core.boundaries import check_reflecting_mhd
from ..core.mesh import Mesh
from ..eos.adiabatic import EOS, cons_to_prim
from ..outputs.history import HistoryOutput
from ..pgen import get_pgen
from ..refinement.criteria import RefinementConfig
from ..solver.hydro_pkg import HydroConfig
from .remesh import AmrHydro
from .smr import SmrMesh, smr_regions_from_deck
from .smr_hydro import SmrHydro


def leaf_mesh(smesh: SmrMesh, gid: int) -> Mesh:
    """One-block Mesh covering one leaf (for per-leaf problem set-up)."""
    b = smesh.base
    lev = int(smesh.levels[gid])
    x0, y0, z0 = smesh.block_origin(gid)
    d1, d2, d3 = smesh.dx(lev)
    return Mesh(nx1=b.mbnx1, nx2=b.mbnx2, nx3=b.mbnx3,
                mbnx1=b.mbnx1, mbnx2=b.mbnx2, mbnx3=b.mbnx3,
                x1min=x0, x1max=x0 + d1 * b.mbnx1,
                x2min=y0, x2max=y0 + d2 * b.mbnx2,
                x3min=z0, x3max=z0 + d3 * b.mbnx3,
                nghost=b.nghost)


def init_state_from_pgen(smesh: SmrMesh, pgen, pin, cfg, eos,
                         dtype=torch.float64, device="cuda"):
    """``{level: [nb, nvar, NZ, NY, NX]}`` from the uniform problem
    generator applied leaf by leaf (ghosts unfilled), on the card unless
    the caller asks for the CPU."""
    from ..driver import resolve_device

    device = resolve_device(device)
    state = {}
    for lev, ids in smesh.level_ids.items():
        blocks = [np.asarray(pgen.problem_generator(
            pin, leaf_mesh(smesh, gid), cfg, eos))[0] for gid in ids]
        state[lev] = torch.as_tensor(np.stack(blocks), dtype=dtype,
                                     device=device)
    return state


class SmrSimulation:
    """Time loop on a static or adaptive refined mesh."""

    def __init__(self, pin: ParameterInput, quiet: bool = False,
                 device="cuda"):
        from ..driver import (DTYPES, check_unported, make_cooling,
                              resolve_device)

        self.pin = pin
        self.quiet = quiet
        self.device = resolve_device(device)
        self.problem_id = pin.get_string("job", "problem_id")
        prec = pin.get_or_add_string("hydro", "precision", "double")
        if prec not in DTYPES:
            raise ValueError(f"hydro/precision must be single|double, "
                             f"got '{prec}'")
        self.dtype = DTYPES[prec]
        mode = pin.get_string("parthenon/mesh", "refinement")
        if mode not in ("static", "adaptive"):
            raise ValueError(f"SmrSimulation: refinement={mode}")
        self.adaptive = mode == "adaptive"
        check_unported(pin)

        base = Mesh.from_parameter_input(pin)
        regions = smr_regions_from_deck(pin)
        numlevel = pin.get_or_add_integer("parthenon/mesh", "numlevel", 1)
        max_level = max(numlevel - 1, max((r[-1] for r in regions),
                                          default=0))
        self.smesh = SmrMesh(base, regions, max_level=max_level)
        self.cfg = HydroConfig.from_parameter_input(pin)
        check_reflecting_mhd(base, self.cfg.fluid)
        self.eos = EOS.from_parameter_input(pin)
        # the problems with split sources (rand_blast, turbulence, cluster)
        # are not ported: get_pgen refuses them
        self.pgen = get_pgen(self.problem_id)
        init_hook = getattr(self.pgen, "init_user_mesh_data", None)
        if init_hook is not None:
            init_hook(pin)
        bc_hook = getattr(self.pgen, "register_boundary_conditions_smr",
                          None)
        self._custom_bcs = (bc_hook(pin, self.smesh, self.cfg, self.eos)
                            if bc_hook is not None else None)
        pc_hook = getattr(self.pgen, "check_refinement_block", None)
        self._problem_check = None
        if pc_hook is not None:
            cfg, eos = self.cfg, self.eos
            self._problem_check = lambda prim, base: pc_hook(  # noqa: E731
                pin, base, cfg, eos, prim)
        self.cooling = make_cooling(pin)
        if self.adaptive:
            self.driver = AmrHydro(
                self.smesh, self.cfg, self.eos,
                RefinementConfig.from_parameter_input(pin),
                check_interval=pin.get_or_add_integer(
                    "parthenon/mesh", "check_interval", 1),
                derefine_count=pin.get_or_add_integer(
                    "parthenon/mesh", "derefine_count", 10),
                device=self.device, cooling=self.cooling,
                custom_bcs=self._custom_bcs,
                problem_check=self._problem_check)
        else:
            self.driver = None
            self.stepper = SmrHydro(self.smesh, self.cfg, self.eos,
                                    device=self.device, cooling=self.cooling,
                                    custom_bcs=self._custom_bcs)
        self.state = self._generate_state()
        if self.adaptive:
            # Parthenon's Mesh::Initialize loop: tag, remesh, then
            # REGENERATE the problem on the new topology until the grid
            # settles -- initial data is evaluated at each leaf's own
            # resolution, never prolongated
            for _ in range(max_level + 1):
                _, changed = self.driver.maybe_remesh(self.state)
                if not changed:
                    break
                self.smesh = self.driver.smesh
                self.state = self._generate_state()
            self.driver._deref_counts = {}

        t = "parthenon/time"
        self.tlim = pin.get_real(t, "tlim")
        self.nlim = pin.get_or_add_integer(t, "nlim", -1)
        self.ncycle_out = pin.get_or_add_integer(t, "ncycle_out", 1)
        # print the mesh structure every |N| cycles (inputs/cloud.in:46)
        self.ncycle_out_mesh = pin.get_or_add_integer(t, "ncycle_out_mesh",
                                                      0)
        self.t = 0.0
        self.ncycle = 0
        # the last dt taken: caps the next at 2x (Parthenon's ratchet)
        self.tm_dt = None

        self._hst = None
        for blk in pin.output_blocks():
            if pin.get_string(blk, "file_type") == "hst":
                oid = pin.get_or_add_string(blk, "id",
                                            blk.rsplit("output", 1)[-1])
                self._hst = HistoryOutput(
                    f"{self.problem_id}.out{oid}.hst", self.cfg.fluid,
                    pin.get_or_add_real(blk, "dt", -1.0))

    # ----------------------------------------------------------- state I/O
    def load_state(self, state, t: float, ncycle: int,
                   dt: Optional[float] = None):
        """Replace the state with ``{level: array}`` (ghosts included, in
        this simulation's layout, e.g. the JAX package's ``SmrSimulation.
        state``) at time ``t`` and cycle ``ncycle``, on this simulation's
        device and dtype.  ``dt``, the last cycle's step, caps the first
        step at 2*dt."""
        new = {}
        sm = self._smesh_now()
        for lev, ids in sm.level_ids.items():
            want = (ids.size, self.cfg.nvar) + sm.base.block_shape
            arr = np.asarray(state[lev])
            if arr.shape != want:
                raise ValueError(f"level {lev}: state shape {arr.shape} does "
                                 f"not match this mesh's {want}")
            new[lev] = torch.from_numpy(np.array(arr)).to(
                device=self.device, dtype=self.dtype)
        self.state = new
        self.t = float(t)
        self.ncycle = int(ncycle)
        self.tm_dt = float(dt) if dt else None
        return self

    # ------------------------------------------------------------- helpers
    def _stepper_now(self):
        return self.driver._stepper if self.adaptive else self.stepper

    def _smesh_now(self):
        return self.driver.smesh if self.adaptive else self.smesh

    def _generate_state(self):
        """The problem generator's state on the current topology, its
        ghosts filled."""
        return self._stepper_now().fill_ghosts(init_state_from_pgen(
            self._smesh_now(), self.pgen, self.pin, self.cfg, self.eos,
            self.dtype, self.device))

    def _write_hst(self, dt):
        if self._hst is None or not self._hst.due(self.t):
            return
        groups = []
        for lev in sorted(self.state):
            u = self.state[lev]
            _, w = cons_to_prim(self.eos, u, self.cfg.fluid,
                                self.cfg.nscalars)
            groups.append((u, w, self._stepper_now().level_mesh[lev]))
        self._hst.write_groups(self.t, dt, groups)

    def _dt_pack(self):
        """The next cycle's ``[dt_raw, dt_eff, c_h]`` on the device, not
        read."""
        return self._stepper_now().dt_pack(
            self.state, self.tm_dt if self.tm_dt is not None
            else float("inf"), self.t, self.tlim)

    def _read_next(self, with_tags=True):
        """``((dt_raw, dt_eff, c_h), tags or None)`` for the next cycle: the
        dt package and, when the next cycle checks the refinement (and
        ``with_tags``), the level tags, enqueued on the device and read to
        the host in ONE read (the loop's one host read per cycle)."""
        pack = self._dt_pack()
        if not (with_tags and self.adaptive
                and self.ncycle % self.driver.check_interval == 0):
            return pack.tolist(), None
        parts = self.driver.dispatch_tags(self.state)
        flat = torch.cat([pack] + [t.to(pack.dtype) for _, t in parts])
        vals = flat.cpu().numpy()
        tags = self.driver.assemble_tags(parts, vals[3:].astype(np.int32))
        return vals[:3].tolist(), tags

    def _running(self):
        return self.t < self.tlim and (self.nlim < 0
                                       or self.ncycle < self.nlim)

    def _print_mesh(self, zones_per_block):
        parts = [f"level {lev}: {ids.size} blocks "
                 f"({ids.size * zones_per_block} zones)"
                 for lev, ids in sorted(self._smesh_now().level_ids.items())]
        print(f"mesh structure (cycle {self.ncycle}): " + "; ".join(parts),
              flush=True)

    # ------------------------------------------------------------------ run
    def run(self):
        b = self._smesh_now().base
        zones_per_block = b.mbnx1 * b.mbnx2 * b.mbnx3
        t0 = time.time()
        zone_cycles = 0
        n_remesh = 0
        self._write_hst(0.0)
        pack, tags = self._read_next() if self._running() else (None, None)
        while self._running():
            if tags is not None:
                # the tags describe the state the previous step left
                self.state, changed = self.driver.maybe_remesh(self.state,
                                                               tags)
                if changed:
                    n_remesh += 1
                    if not self.quiet and self.ncycle_out_mesh < 0:
                        self._print_mesh(zones_per_block)
                    # the state changed under the dt read with the tags
                    pack, _ = self._read_next(with_tags=False)
            dt_raw, dt, c_h = pack
            self.state = self._stepper_now().step(self.state, dt, c_h)
            self.tm_dt = dt_raw
            self.t += dt
            self.ncycle += 1
            zone_cycles += zones_per_block * sum(
                v.shape[0] for v in self.state.values())
            # the next cycle's dt (and tags), read after this cycle's step
            # is enqueued
            pack, tags = (self._read_next() if self._running()
                          else (None, None))
            if not self.quiet and self.ncycle_out > 0 \
                    and self.ncycle % self.ncycle_out == 0:
                nlv = {lev: v.shape[0] for lev, v in self.state.items()}
                print(f"cycle={self.ncycle} time={self.t:.8e} "
                      f"dt={dt:.8e} blocks={nlv}", flush=True)
            if not self.quiet and self.ncycle_out_mesh != 0 \
                    and self.ncycle % abs(self.ncycle_out_mesh) == 0:
                self._print_mesh(zones_per_block)
            self._write_hst(dt)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        wall = time.time() - t0
        self.perf_zone_cycles = zone_cycles
        self.perf_wall = wall
        self.perf_remeshes = n_remesh
        if not self.quiet and zone_cycles:
            print(f"zone-cycles/wallsecond = {zone_cycles / wall:.6e}",
                  flush=True)
        return self

    # ------------------------------------------------------------ accessors
    def total_mass(self):
        return self._stepper_now().total_mass(self.state)

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
(``athenapk_tpu/amr/driver.py:179-197, 401-412``): ``problem_generator_smr``
builds the whole initial state where the problem has one (the cluster),
``register_boundary_conditions_smr``
gives the ghost fill its boundary conditions, ``check_refinement_block``
tags blocks beside the criterion (adaptive meshes, combined by ``max``);
tabular cooling is built as the uniform driver builds it
(``deck.make_cooling``) and acts on every level.

Diffusion is built as the uniform driver builds it
(``deck.make_diffusion``): unsplit diffusion joins every stage
(``SmrHydro``), RKL2 wraps the cycle.  The problem's source hooks are the
JAX driver's (``athenapk_tpu/amr/driver.py:119-140, 225-282``):
``problem_source_unsplit_smr`` joins every stage; for the split sources
(``problem_source_first_order``, ``problem_source_strang``) a ``_smr`` hook
wins (sources with reductions over the mesh, e.g. turbulence's driving),
else ``adapt_split_source`` runs the uniform hook per level with a
``LevelLeafView`` (pointwise sources, e.g. rand_blast's blasts);
``estimate_timestep_smr`` caps the dt.  Each is rebuilt for every new leaf
table.  A deck with RKL2, a split source or a dt hook runs the JAX
driver's non-pipelined branch (``_run_split``, ``:590-680``): the dt read
before the cycle, the half super-step, the Strang source, the step, the
Strang source, the first-order source, the half super-step, each source
followed by a ghost fill.  Every other deck keeps the pipelined loop.

Outputs and restart, as the JAX driver has them
(``athenapk_tpu/amr/driver.py:345-395, 486-530``): mixed-level ``.phdf``
dumps named ``{problem}.out{id}.{count:05d}.phdf`` (no underscore, unlike
the uniform ``out_{id}``) with the tracer swarm where ``swarms = tracers``,
and ``.rhdf`` checkpoints ``{problem}.out_{id}.{count:05d}.rhdf`` (the
trigger advances before the write).  ``SmrSimulation(pin,
restart=payload)`` rebuilds the mesh from the payload's leaf table and
resumes bit for bit (the derefinement counters of an adaptive run
included); ``driver.run_from_restart`` sends a payload with ``levels``
here.

Tracers (``tracers.smr_tracers.SmrTracers``) run on static and adaptive
meshes: a tracer deck always takes the non-pipelined loop, where each
cycle advects and samples them with the prim of the cycle's final state;
a remesh that changes the leaf table re-bins them (``adopt``).

The state lives on ``cuda`` unless the caller asks for the CPU; asking for
CUDA where there is none raises.  Every problem of the JAX package runs,
the galaxy cluster included (``pgen.cluster``; its reference decks all use
static refinement).
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch
from torch.profiler import record_function

from ..config.parameter_input import ParameterInput
from ..core.boundaries import check_reflecting_mhd
from ..core.device import DTYPES, resolve_device
from ..core.mesh import Mesh
from ..deck import (check_h5py, make_cooling, make_diffusion,
                    swarm_variables, tracers_to_device)
from ..eos.adiabatic import EOS, cons_to_prim
from ..outputs.hdf5 import write_phdf_smr
from ..outputs.history import HistoryOutput
from ..outputs.restart import write_restart_smr
from ..pgen import get_pgen
from ..refinement.criteria import RefinementConfig
from ..solver.hydro_pkg import HydroConfig
from ..tracers.smr_tracers import SmrTracers, compact_swarm_smr
from .remesh import AmrHydro
from .smr import (LevelLeafView, SmrMesh, leaf_mesh,
                  smr_regions_from_deck)
from .smr_hydro import SmrHydro


def adapt_split_source(factory, pin, smesh, cfg, eos):
    """Run a uniform mesh's split-source factory on a refined mesh: one
    instance per level, built with a ``LevelLeafView`` (the leaves'
    coordinates, the level's dx).  Right for POINTWISE sources (rand_blast's
    blasts, the reference's ``ProblemSourceFirstOrder`` contract,
    ``hydro_driver.cpp:548-561``); a source with reductions over the mesh
    needs a ``*_smr`` hook, which wins where present."""
    fns = {lev: factory(pin, LevelLeafView(smesh, lev), cfg, eos)
           for lev in smesh.level_ids}
    if all(fn is None for fn in fns.values()):
        return None

    def src(state, dt, t):
        return {lev: (fns[lev](u, dt, t) if fns[lev] is not None else u)
                for lev, u in state.items()}

    return src


def init_state_from_pgen(smesh: SmrMesh, pgen, pin, cfg, eos,
                         dtype=torch.float64, device="cuda"):
    """``{level: [nb, nvar, NZ, NY, NX]}`` from the uniform problem
    generator applied leaf by leaf (ghosts unfilled), on the card unless
    the caller asks for the CPU."""
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
                 device="cuda", restart: Optional[dict] = None):
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
        check_h5py(pin)

        base = Mesh.from_parameter_input(pin)
        regions = smr_regions_from_deck(pin)
        numlevel = pin.get_or_add_integer("parthenon/mesh", "numlevel", 1)
        max_level = max(numlevel - 1, max((r[-1] for r in regions),
                                          default=0))
        if restart is None:
            self.smesh = SmrMesh(base, regions, max_level=max_level)
        else:
            ll = np.asarray(restart["logical_locations"])
            self.smesh = SmrMesh.from_leaf_table(
                base, restart["levels"], ll[:, 0], ll[:, 1], ll[:, 2],
                max_level=max_level)
        self.cfg = HydroConfig.from_parameter_input(pin)
        check_reflecting_mhd(base, self.cfg.fluid)
        self.eos = EOS.from_parameter_input(pin)
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
        self.diffusion = make_diffusion(pin)
        factories = self._source_factories()
        pe_hook = getattr(self.pgen, "estimate_timestep_smr", None)
        self._pe_factory = (None if pe_hook is None else (
            lambda sm: pe_hook(pin, sm, self.cfg, self.eos)))
        self._pe_cache = (None, None)   # (smesh, fn)
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
                problem_check=self._problem_check,
                diffusion=self.diffusion,
                problem_source_factory=factories[0],
                problem_first_order_factory=factories[1],
                problem_strang_factory=factories[2])
        else:
            self.driver = None
            built = [f(self.smesh) if f is not None else None
                     for f in factories]
            self.stepper = SmrHydro(
                self.smesh, self.cfg, self.eos, device=self.device,
                cooling=self.cooling, custom_bcs=self._custom_bcs,
                diffusion=self.diffusion, problem_source_unsplit=built[0],
                problem_source_first_order=built[1],
                problem_source_strang=built[2])
        if restart is None:
            self.state = self._generate_state()
        if self.adaptive and restart is None:
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
        self._hdf5_outs = []   # {id, dt, variables, sp, swarm_vars, next,
        self._rst_outs = []    # count} / {id, dt, next, count}
        for blk in pin.output_blocks():
            ftype = pin.get_string(blk, "file_type")
            oid = pin.get_or_add_string(blk, "id",
                                        blk.rsplit("output", 1)[-1])
            dt_out = pin.get_or_add_real(blk, "dt", -1.0)
            if ftype == "hst":
                self._hst = HistoryOutput(
                    f"{self.problem_id}.out{oid}.hst", self.cfg.fluid,
                    dt_out)
            elif ftype == "hdf5":
                self._hdf5_outs.append({
                    "id": oid, "dt": dt_out,
                    "variables": pin.get_or_add_string(blk, "variables",
                                                       "cons"),
                    "sp": pin.get_or_add_bool(blk,
                                              "single_precision_output",
                                              False),
                    "swarm_vars": swarm_variables(pin, blk),
                    "next": 0.0, "count": 0})
            elif ftype == "rst":
                self._rst_outs.append({"id": oid, "dt": dt_out,
                                       "next": 0.0, "count": 0})

        # tracers (per-level buffers); on adaptive meshes every remesh
        # that changes the leaf table re-bins them (adopt)
        self.tracers = SmrTracers(pin, self._smesh_now(), self.cfg,
                                  device=self.device)
        self.tracer_state = None
        if restart is not None:
            self.restore(restart)
        if self.tracers.enabled and self.tracer_state is None:
            self.tracer_state = self.tracers.seed()
            if self.tracer_state is not None:
                self.tracer_state = self.tracers.fill(self.tracer_state,
                                                      self._prims())

    def _source_factories(self):
        """``factory(smesh)`` of the unsplit source, the first-order and
        the Strang split source (each None where the problem has none; the
        JAX driver's ``_split_factory``: an ``_smr`` hook wins over the
        per-level adapter of the uniform hook).  The unsplit factory passes
        keywords on to the hook (``leaves=`` over ranks, the cluster's)."""
        pin, cfg, eos, pgen = self.pin, self.cfg, self.eos, self.pgen
        unsplit = getattr(pgen, "problem_source_unsplit_smr", None)

        def split(name):
            smr_hook = getattr(pgen, f"{name}_smr", None)
            if smr_hook is not None:
                return lambda sm: smr_hook(pin, sm, cfg, eos)
            uni = getattr(pgen, name, None)
            if uni is not None:
                return lambda sm: adapt_split_source(uni, pin, sm, cfg, eos)
            return None

        return ((None if unsplit is None
                 else (lambda sm, **kw: unsplit(pin, sm, cfg, eos, **kw))),
                split("problem_source_first_order"),
                split("problem_source_strang"))

    # ----------------------------------------------------------- state I/O
    def restore(self, payload):
        """Resume from a restart payload (``outputs.restart``; see
        ``driver.load_payload``) on this simulation's leaf table: the
        ghost-inclusive state (no refill), the clock, the 2x-cap seed, the
        forcing, the derefinement counters, the tracers and the output
        triggers (hdf5 outputs, rst outputs, then the ``.hst`` one); the
        ``.hst`` file is appended to.  Returns ``self``."""
        self.load_state(payload["state"], payload["t"], payload["ncycle"],
                        dt=payload.get("dt"),
                        forcing=payload.get("few_modes_ft"))
        if self.adaptive and payload.get("deref_counts") is not None:
            self.driver._deref_counts = dict(payload["deref_counts"])
        tr = payload.get("tracers")
        if self.tracers.enabled and tr is not None:
            self.tracer_state = {
                "levels": {int(lev): tracers_to_device(st, self.device)
                           for lev, st in tr["levels"].items()},
                "n_lost": torch.as_tensor(np.asarray(tr["n_lost"]),
                                          dtype=torch.int32,
                                          device=self.device)}
        trig = payload.get("triggers")
        if trig is not None:
            for out, (nt, cnt) in zip(self._hdf5_outs + self._rst_outs,
                                      trig[:-1]):
                out["next"] = float(nt)
                out["count"] = int(cnt)
            if self._hst is not None:
                self._hst.next_time = float(trig[-1][0])
        if self._hst is not None:
            self._hst._wrote_header = True
        return self

    def load_state(self, state, t: float, ncycle: int,
                   dt: Optional[float] = None, forcing=None):
        """Replace the state with ``{level: array}`` (ghosts included, in
        this simulation's layout, e.g. the JAX package's ``SmrSimulation.
        state``) at time ``t`` and cycle ``ncycle``, on this simulation's
        device and dtype.  ``dt``, the last cycle's step (the JAX driver's
        ``tm_dt``), caps the first step at 2*dt.  ``forcing``
        (turbulence): the forcing driver's ``(var_hat, bit_generator
        state)`` (``driver.load_payload`` maps the JAX package's driver
        state onto these arguments)."""
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
        if forcing is not None:
            self.pgen.forcing_driver_smr(self.pin, sm).set_state(*forcing)
        return self

    # ------------------------------------------------------------- helpers
    def _stepper_now(self):
        return self.driver._stepper if self.adaptive else self.stepper

    def _smesh_now(self):
        return self.driver.smesh if self.adaptive else self.smesh

    def _generate_state(self):
        """The problem generator's state on the current topology, its
        ghosts filled: the problem's ``problem_generator_smr`` where it has
        one (the cluster's, which integrates its HSE profile once and
        normalises its perturbations over all levels; it returns host
        arrays per level), else the uniform generator leaf by leaf (the
        JAX package's ``_generate_state``)."""
        sm = self._smesh_now()
        gen_smr = getattr(self.pgen, "problem_generator_smr", None)
        if gen_smr is not None:
            state = {lev: torch.as_tensor(u, dtype=self.dtype,
                                          device=self.device)
                     for lev, u in gen_smr(self.pin, sm, self.cfg,
                                           self.eos).items()}
        else:
            state = init_state_from_pgen(sm, self.pgen, self.pin, self.cfg,
                                         self.eos, self.dtype, self.device)
        return self._stepper_now().fill_ghosts(state)

    def _problem_dt(self):
        """The pgen's dt constraint on the current mesh (inf without one),
        its closure rebuilt after every remesh; a float or a 0-d tensor."""
        if self._pe_factory is None:
            return float("inf")
        sm = self._smesh_now()
        if self._pe_cache[0] is not sm:
            self._pe_cache = (sm, self._pe_factory(sm))
        fn = self._pe_cache[1]
        return float("inf") if fn is None else fn(self.state, self.t)

    def _split_loop(self):
        """Does the run take the JAX driver's non-pipelined branch (RKL2, a
        split source, a pgen dt constraint or tracers)?"""
        st = self._stepper_now()
        return (st.sts or st.problem_source_first_order is not None
                or st.problem_source_strang is not None
                or self._pe_factory is not None
                or self.tracer_state is not None)

    def _prims(self):
        """``{level: prim}`` of the state (ghosts included)."""
        return {lev: cons_to_prim(self.eos, u, self.cfg.fluid,
                                  self.cfg.nscalars)[1]
                for lev, u in self.state.items()}

    def _c_h(self, dt):
        if self.cfg.fluid != "glmmhd":
            return 0.0
        sm = self._smesh_now()
        return self.cfg.cfl * sm.min_dx(sm.max_level) / dt if dt > 0 else 0.0

    def _write_hst(self, dt):
        if self._hst is None or not self._hst.due(self.t):
            return
        prims = self._prims()
        level_mesh = self._stepper_now().level_mesh
        self._hst.write_groups(self.t, dt, [
            (self.state[lev], prims[lev], level_mesh[lev])
            for lev in sorted(self.state)])

    def _write_rst(self, force=False):
        for out in self._rst_outs:
            if not force and (out["dt"] < 0.0 or self.t < out["next"]):
                continue
            fname = (f"{self.problem_id}.out_{out['id']}."
                     f"{out['count']:05d}.rhdf")
            # the trigger advances before the write: the checkpoint holds
            # the state after it, so a resume continues at count+1
            out["count"] += 1
            out["next"] = self.t + max(out["dt"], 0.0)
            write_restart_smr(fname, self)

    def _write_hdf5(self, dt, force=False):
        """The due hdf5 outputs (``dt < 0``: the final dump only)."""
        for out in self._hdf5_outs:
            if not force and (out["dt"] < 0.0 or self.t < out["next"]):
                continue
            if out["dt"] > 0.0:
                while out["next"] <= self.t:
                    out["next"] += out["dt"]
            want_prim = "prim" in out["variables"]
            want_cons = "cons" in out["variables"] or not want_prim
            prims = None
            if want_prim:
                prims = {lev: w.cpu().numpy()
                         for lev, w in self._prims().items()}
            swarms = None
            if out["swarm_vars"] and self.tracer_state is not None:
                swarms = {name: compact_swarm_smr(self.tracer_state, vs)
                          for name, vs in out["swarm_vars"].items()}
            fname = (f"{self.problem_id}.out{out['id']}."
                     f"{out['count']:05d}.phdf")
            out["count"] += 1
            write_phdf_smr(
                fname, self._smesh_now(), self.cfg.fluid, self.t, dt,
                self.ncycle, state={lev: u.cpu().numpy() for lev, u in
                                    self.state.items()}
                if want_cons else None,
                prim_state=prims, single_precision=out["sp"],
                swarms=swarms)

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
            with record_function("host_read"):
                return pack.tolist(), None
        parts = self.driver.dispatch_tags(self.state)
        flat = torch.cat([pack] + [t.to(pack.dtype) for _, t in parts])
        with record_function("host_read"):
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
        self._write_hst(0.0)
        self._write_hdf5(0.0)
        if self._split_loop():
            zone_cycles, n_remesh = self._run_split(zones_per_block)
        else:
            zone_cycles, n_remesh = self._run_pipelined(zones_per_block)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        wall = time.time() - t0
        self.perf_zone_cycles = zone_cycles
        self.perf_wall = wall
        self.perf_remeshes = n_remesh
        if not self.quiet and zone_cycles:
            print(f"zone-cycles/wallsecond = {zone_cycles / wall:.6e}",
                  flush=True)
        self._write_hdf5(0.0, force=True)
        self._write_rst(force=True)
        return self

    def _end_cycle(self, dt, zones_per_block):
        """The cycle's output: the ``cycle=`` line, the mesh structure,
        the ``.hst`` row, the due dumps and checkpoints."""
        if not self.quiet and self.ncycle_out > 0 \
                and self.ncycle % self.ncycle_out == 0:
            nlv = {lev: v.shape[0] for lev, v in self.state.items()}
            print(f"cycle={self.ncycle} time={self.t:.8e} "
                  f"dt={dt:.8e} blocks={nlv}", flush=True)
        if not self.quiet and self.ncycle_out_mesh != 0 \
                and self.ncycle % abs(self.ncycle_out_mesh) == 0:
            self._print_mesh(zones_per_block)
        self._write_hst(dt)
        self._write_hdf5(dt)
        self._write_rst()

    def _split_source(self, name, src, stepper, dt):
        """A split source over the state at full dt in the range ``name``,
        then the ghost fill."""
        with record_function(name):
            state = src(self.state, dt, self.t)
        with record_function("boundary_fill"):
            self.state = stepper.fill_ghosts(state)

    def _run_split(self, zones_per_block):
        """The JAX driver's non-pipelined cycle: remesh check, the dt (one
        host read of the estimate, dt_diff and the pgen's dt), then the
        RKL2 half super-step, the Strang source, the step, the Strang
        source, the first-order source and the second half super-step.
        -> (zone-cycles, remeshes)."""
        zone_cycles = n_remesh = 0
        while self._running():
            with record_function("cycle"):
                if self.adaptive and \
                        self.ncycle % self.driver.check_interval == 0:
                    self.state, changed = self.driver.maybe_remesh(self.state)
                    if changed:
                        n_remesh += 1
                        if not self.quiet and self.ncycle_out_mesh < 0:
                            self._print_mesh(zones_per_block)
                        if self.tracer_state is not None:
                            # re-bin the tracers onto the new leaf table
                            self.tracers = SmrTracers(
                                self.pin, self.driver.smesh, self.cfg,
                                device=self.device)
                            self.tracer_state = self.tracers.adopt(
                                self.tracer_state)
                st = self._stepper_now()
                if st.sts:
                    dt_j, dt_diff = st.estimate_dt_with_diff(self.state)
                else:
                    dt_j, dt_diff = st.estimate_dt(self.state), None
                parts = (dt_j, dt_j if dt_diff is None else dt_diff,
                         self._problem_dt())
                stacked = torch.stack([torch.as_tensor(
                    v, dtype=dt_j.dtype, device=dt_j.device).reshape(())
                    for v in parts])
                with record_function("host_read"):
                    vals = stacked.tolist()
                dt_raw = min(vals[0], vals[2])
                if self.tm_dt is not None:
                    dt_raw = min(dt_raw, 2.0 * self.tm_dt)
                self.tm_dt = dt_raw
                dt = min(dt_raw, self.tlim - self.t)
                src_strang = st.problem_source_strang
                src_fo = st.problem_source_first_order
                if st.sts:
                    # the Strang wrap: a half super-step on each side of the
                    # hyperbolic cycle (hydro_driver.cpp:456-458)
                    self.state = st.sts_half_step(self.state, 0.5 * dt, vals[1])
                if src_strang is not None:
                    # AddSplitSourcesStrang (hydro_driver.cpp:460-470)
                    self._split_source("strang_source", src_strang, st, dt)
                self.state = st.step(self.state, dt, self._c_h(dt), self.t)
                if src_strang is not None:
                    self._split_source("strang_source", src_strang, st, dt)
                if src_fo is not None:
                    # AddSplitSourcesFirstOrder, once per cycle at full dt
                    # (hydro_driver.cpp:548-561)
                    self._split_source("first_order_source", src_fo, st, dt)
                if st.sts:
                    self.state = st.sts_half_step(self.state, 0.5 * dt, vals[1])
                if self.tracer_state is not None:
                    # advect with the last-filled velocities, then resample
                    prims = self._prims()
                    self.tracer_state = self.tracers.fill(self.tracers.advect(
                        self.tracer_state, prims, dt), prims)
                self.t += dt
                self.ncycle += 1
                zone_cycles += zones_per_block * sum(
                    v.shape[0] for v in self.state.values())
            self._end_cycle(dt, zones_per_block)
        return zone_cycles, n_remesh

    def _run_pipelined(self, zones_per_block):
        """The pipelined loop (module docstring). -> (zone-cycles,
        remeshes)."""
        zone_cycles = 0
        n_remesh = 0
        pack, tags = self._read_next() if self._running() else (None, None)
        while self._running():
            with record_function("cycle"):
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
                self.state = self._stepper_now().step(self.state, dt, c_h,
                                                      self.t)
                self.tm_dt = dt_raw
                self.t += dt
                self.ncycle += 1
                zone_cycles += zones_per_block * sum(
                    v.shape[0] for v in self.state.values())
                # the next cycle's dt (and tags), read after this cycle's step
                # is enqueued
                pack, tags = (self._read_next() if self._running()
                              else (None, None))
            self._end_cycle(dt, zones_per_block)
        return zone_cycles, n_remesh

    # ------------------------------------------------------------ accessors
    def total_mass(self):
        return self._stepper_now().total_mass(self.state)

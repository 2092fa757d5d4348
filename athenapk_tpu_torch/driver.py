"""Evolution driver: the main simulation loop (torch).

Counterpart of ``athenapk_tpu/driver.py`` (Parthenon's ``EvolutionDriver``
plus AthenaPK's ``HydroDriver``, ``src/hydro/hydro_driver.cpp:34-41``):

* per cycle: c_h from the previous hyperbolic dt (the reference's
  ``PreStepMeshUserWorkInLoop``, ``src/hydro/hydro.cpp:102-143``), one
  multi-stage step, the next dt (growth-capped at 2x), outputs.
* ``zone-cycles/wallsecond`` at the end, with ``perf_cycle_offset`` warm-up
  exclusion (the protocol of the reference performance suite,
  ``tst/regression/test_suites/performance/performance.py:95-96``).

The state lives on ``cuda`` unless the caller asks for the CPU
(``Simulation(pin, device="cpu")`` or ``--device cpu``); asking for CUDA
where there is none raises.  ``hydro/precision = single|double`` sets the
state's dtype.

``run_from_file`` and the CLI send a deck with ``<parthenon/mesh>
refinement = static`` or ``adaptive`` to ``amr.driver.SmrSimulation`` (the
JAX routing, ``athenapk_tpu/driver.py:515-518``).

Tabular cooling (``<cooling> enable_cooling = tabular``) and diffusion
(``<diffusion>``, Spitzer conduction through ``<units>``) are built from
``<units>`` and ``hydro/He_mass_fraction`` as the JAX driver builds them
(``athenapk_tpu/driver.py:66-95``), and a problem's
``register_boundary_conditions`` hook gives the ghost fill its boundary
conditions.

The problem's source hooks are the JAX driver's
(``athenapk_tpu/driver.py:96-121``): ``problem_source_unsplit`` joins every
stage (``HydroPackage``); ``problem_source_strang`` acts before and after
the hydro cycle and ``problem_source_first_order`` once per cycle at full
dt, each followed by a boundary fill; ``estimate_timestep_factory`` (or
``estimate_timestep``) caps the dt.  A deck with any of these, or with
RKL2 diffusion (the cycle inside two half super-steps, the Strang wrap),
runs ``step`` and then a separate estimate (the JAX package's
non-pipelined branch, ``:360-420``); every other deck runs the fused
``step_with_dt``.  The hyperbolic stages take the kernels either way.

Outputs (``<parthenon/output*>``): ``hst``; ``hdf5`` (``.phdf`` dumps
named ``{problem}.out_{id}.{count:05d}.phdf``, with ``swarms = tracers`` the
compacted tracer swarm beside the fields) and ``rst`` (``.rhdf``
checkpoints; the trigger advances before the write, so a resume continues
at count+1).  Both need ``h5py``: a deck with such a block raises an
ImportError naming it when the ``Simulation`` is built where h5py is
missing (the chip machine has none).  ``Simulation(pin,
restart=payload)`` resumes from ``outputs.restart``'s payload (in the
checkpoint's own block layout, so the resume is bit for bit); a resumed
run appends to its ``.hst`` file.  ``load_payload`` carries a payload into
a built simulation through the same ``restore``.

Tracers (``<tracers>``, ``tracers.Tracers``) are seeded with the state,
and every cycle, on either branch, are advected (Heun) and sampled with the
prim of the cycle's final state, before the problem's
``problem_fill_tracers`` hook (turbulence's lookback vectors and
``correlations.csv``).

CLI: ``-i deck.in``, ``-r file.rhdf`` (resume; overrides apply to the
stored deck), ``-t TRACE_DIR`` (the run inside ``torch.profiler.profile``,
CPU and on the card CUDA activity, exported as a Chrome trace to
``TRACE_DIR/trace.json``), ``--device cpu``.

Profiler ranges (``torch.profiler.record_function``, always on; a trace
shows them): ``cycle`` around each cycle of the loop, from the dt clamp to
the next dt (the refined driver's loops alike); ``strang_source`` and
``first_order_source`` around the split sources, each followed by a
``boundary_fill``; ``host_read`` around each read of the device to the
host; ``solver.hydro_pkg`` names the phases of a stage, the problem's
sources (``pgen.cluster``) and the remesh (``amr.remesh``) theirs.

Every problem of the JAX package runs, the galaxy cluster included
(``pgen.cluster``: its unsplit source joins every stage, its stellar
feedback and clips are the first-order split source, its accretion dt the
pgen's dt constraint).  Not ported yet: multi-device runs.  On a CUDA
device the kernels take every method of the decks (six reconstructions;
Euler LLF, HLLE, HLLC; GLM-MHD LLF, HLLE, HLLD) with any number of passive
scalars.
"""

from __future__ import annotations

import dataclasses
import math
import os
import sys
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.profiler import ProfilerActivity, profile, record_function

from .amr.driver import SmrSimulation
from .config.parameter_input import ParameterInput
from .core.device import DTYPES, resolve_device
from .core.mesh import Mesh
from .deck import (check_h5py, make_cooling, make_diffusion, swarm_variables,
                   tracers_to_device)
from .eos.adiabatic import EOS
from .outputs.hdf5 import write_phdf
from .outputs.history import HistoryOutput
from .outputs.restart import read_restart, write_restart, write_restart_smr
from .pgen import get_pgen
from .solver.hydro_pkg import HydroConfig, HydroPackage
from .tracers import Tracers, compact_swarm


def load_payload(sim, payload):
    """Continue another run's state in ``sim`` (a ``Simulation`` or an
    ``amr.driver.SmrSimulation``): ``sim.restore(payload)``, the way in of
    ``Simulation(pin, restart=payload)``.  ``payload`` has the keys of a
    restart payload (``outputs.restart``; the JAX package's
    ``read_restart``), numpy arrays or any arrays: ``cons`` on a uniform
    mesh, ``state`` as ``{level: array}`` on a refined one; ``t``,
    ``ncycle``, and where they apply ``dt``, ``dt_diff``, ``triggers``,
    ``tracers``, ``few_modes_ft`` = ``(var_hat, bit_generator state)`` and
    ``deref_counts``.  Returns ``sim``."""
    return sim.restore(payload)


class Simulation:
    """Owns mesh, package, state and the time loop."""

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
        mode = pin.get_or_add_string("parthenon/mesh", "refinement", "none")
        if mode in ("static", "adaptive"):
            raise NotImplementedError(
                f"refinement = {mode}: the uniform Simulation does not run "
                "refined meshes; SmrSimulation does (run_from_file and the "
                "CLI route the deck to it)")
        check_h5py(pin)

        self.mesh = Mesh.from_parameter_input(pin)
        self.cfg = HydroConfig.from_parameter_input(pin)
        self.eos = EOS.from_parameter_input(pin)
        self.pgen = get_pgen(self.problem_id)
        # InitUserMeshData analog: may mutate pin (linear_wave test=true
        # rescales tlim) before the time controls are read below
        init_hook = getattr(self.pgen, "init_user_mesh_data", None)
        if init_hook is not None:
            init_hook(pin)
        self.mesh = self._merge_blocks(pin, self.mesh, restart)
        diffusion = make_diffusion(pin)
        cooling = make_cooling(pin)
        if cooling is not None and pin.has("cooling", "test_filename"):
            cooling.test_cooling_table(pin)
        custom_bcs = None
        bc_hook = getattr(self.pgen, "register_boundary_conditions", None)
        if bc_hook is not None:
            custom_bcs = bc_hook(pin, self.mesh, self.cfg, self.eos)

        def hook(name):
            factory = getattr(self.pgen, name, None)
            return (factory(pin, self.mesh, self.cfg, self.eos)
                    if factory is not None else None)

        # the split sources (ProblemSourceFirstOrder once per cycle at full
        # dt, ProblemSourceStrangSplit before and after the cycle, each
        # handed the full dt: hydro_driver.cpp:460-470, 548-561)
        self.src_first_order = hook("problem_source_first_order")
        self.src_strang = hook("problem_source_strang")
        # the pgen's dt constraint (ProblemEstimateTimestep, main.cpp:107);
        # a factory returning None keeps the fused-dt path
        if getattr(self.pgen, "estimate_timestep_factory", None) is not None:
            self._pe_fn = hook("estimate_timestep_factory")
        else:
            raw_pe = getattr(self.pgen, "estimate_timestep", None)
            self._pe_fn = ((lambda prim, t: raw_pe(
                self.pin, self.mesh, self.cfg, self.eos, prim, t))
                if raw_pe is not None else None)
        self.pkg = HydroPackage(self.mesh, self.cfg, self.eos,
                                problem_source_unsplit=hook(
                                    "problem_source_unsplit"),
                                diffusion=diffusion, cooling=cooling,
                                custom_bcs=custom_bcs)

        t = "parthenon/time"
        self.tlim = pin.get_real(t, "tlim")
        self.nlim = pin.get_or_add_integer(t, "nlim", -1)
        self.perf_cycle_offset = pin.get_or_add_integer(
            t, "perf_cycle_offset", 0)
        self.ncycle_out = pin.get_or_add_integer(t, "ncycle_out", 1)

        self.t = 0.0
        self.ncycle = 0
        self.is_restart = False
        self._prev_dt = 0.0   # dt before a loaded state (2x growth cap)
        self._loaded_dt_diff = None   # dt_diff of a loaded state
        self.dt_diff = math.inf   # the last estimate's diffusive dt
        self.tm_dt = None     # set by run
        if restart is None:
            u = torch.as_tensor(self.pgen.problem_generator(
                pin, self.mesh, self.cfg, self.eos), dtype=self.dtype,
                device=self.device)
            self.u = self.pkg.apply_boundaries(u)

        # tracers; the problem may add per-particle fields
        # (ProblemInitTracerData) and a per-cycle fill hook
        extra = getattr(self.pgen, "tracer_extra_fields", None)
        self.tracers = Tracers(pin, self.mesh, self.cfg,
                               extra_fields=extra(pin) if extra else None,
                               device=self.device)
        self._fill_tracers_hook = getattr(self.pgen, "problem_fill_tracers",
                                          None)
        self.tracer_state = None

        self.outputs = []
        for blk in pin.output_blocks():
            ftype = pin.get_string(blk, "file_type")
            dt_out = pin.get_or_add_real(blk, "dt", -1.0)
            oid = pin.get_or_add_string(blk, "id", blk.rsplit("output", 1)[-1])
            if ftype == "hst":
                hook = getattr(self.pgen, "history_columns", None)
                extra_cols = (hook(pin, self.mesh, self.cfg, self.eos)
                              if hook is not None else ())
                self.outputs.append(HistoryOutput(
                    f"{self.problem_id}.out{oid}.hst", self.cfg.fluid, dt_out,
                    extra_columns=extra_cols))
            elif ftype == "hdf5":
                self.outputs.append(_Hdf5Output(
                    self, oid, pin.get_or_add_string(blk, "variables",
                                                     "cons"), dt_out,
                    pin.get_or_add_bool(blk, "single_precision_output",
                                        False), swarm_variables(pin, blk)))
            elif ftype == "rst":
                self.outputs.append(_RestartOutput(self, oid, dt_out))
        if restart is not None:
            self.restore(restart)
        if self.tracers.enabled and self.tracer_state is None:
            self.tracer_state = self.tracers.seed(
                user_hook=getattr(self.pgen, "seed_initial_tracers", None))
            if self.tracer_state is not None:
                _, w0 = self.pkg.cons_to_prim(self.u)
                self.tracer_state = self.tracers.fill(self.tracer_state, w0)

    # ----------------------------------------------------------- state I/O
    def restore(self, payload):
        """Resume from a restart payload (``outputs.restart``; see
        ``load_payload``): the state, the clock, the 2x-cap seed, the
        forcing, the tracers and the output triggers.  A resumed run
        appends to its ``.hst`` file and does not refill the problem's
        tracer fields at its start.  Returns ``self``."""
        self.load_state(payload["cons"], payload["t"], payload["ncycle"],
                        dt=payload.get("dt"), dt_diff=payload.get("dt_diff"),
                        forcing=payload.get("few_modes_ft"))
        if self.tracers.enabled and payload.get("tracers") is not None:
            self.tracer_state = tracers_to_device(payload["tracers"],
                                                  self.device)
        if payload.get("triggers") is not None:
            for out, (nt, cnt) in zip(self.outputs, payload["triggers"]):
                out.next_time = float(nt)
                out.count = int(cnt)
        for out in self.outputs:
            if isinstance(out, HistoryOutput):
                out._wrote_header = True
        self.is_restart = True
        return self

    def load_state(self, cons: np.ndarray, t: float, ncycle: int,
                   dt: Optional[float] = None,
                   dt_diff: Optional[float] = None, forcing=None):
        """Replace the state with ``cons`` ([nblocks, nvar, NZ, NY, NX] in
        this simulation's layout, e.g. another package's state) at time
        ``t`` and cycle ``ncycle``, on this simulation's device and dtype.
        ``dt``, the last cycle's step, caps the first step at 2*dt.
        ``dt_diff`` (RKL2 decks): the diffusive dt the next cycle's
        super-steps use.  ``forcing`` (turbulence): the forcing driver's
        ``(var_hat, bit_generator state)``, so the next cycles draw what
        the other run would (``load_payload`` maps the JAX package's
        driver state onto these arguments)."""
        want = (self.mesh.nblocks, self.cfg.nvar) + self.mesh.block_shape
        if tuple(cons.shape) != want:
            raise ValueError(f"state shape {tuple(cons.shape)} does not match "
                             f"this simulation's layout {want}")
        self.u = torch.from_numpy(np.array(cons)).to(device=self.device,
                                                     dtype=self.dtype)
        self.t = float(t)
        self.ncycle = int(ncycle)
        self._prev_dt = float(dt) if dt else 0.0
        self._loaded_dt_diff = None if dt_diff is None else float(dt_diff)
        if forcing is not None:
            self.pgen.forcing_driver(self.pin, self.mesh).set_state(*forcing)
        return self

    # ----------------------------------------------------------- block merge
    @staticmethod
    def _merge_blocks(pin, mesh, restart=None):
        """A uniform mesh on one device solves as ONE mesh-spanning block,
        ghost-free when every boundary is periodic, the problem has no
        boundary hook and its initial state needs no ghosts
        (``needs_ghosts_at_init``; cyclic rolls are the boundary; no ghost
        storage and no fill pass).

        ``parthenon/mesh/merge_blocks = auto|true|false``: ``auto`` merges
        unless ``torch.distributed`` is initialised with more than one
        rank (a sharded run splits the block axis, which needs the
        decomposition; the JAX package's ``athenapk_tpu/driver.py:280``
        asks for one visible device).  A ``restart`` payload written in
        another layout resumes in its own (bit-exact resume wins over
        speed)."""
        mode = pin.get_or_add_string("parthenon/mesh", "merge_blocks",
                                     "auto")
        if mode not in ("auto", "true", "false"):
            raise ValueError(
                f"parthenon/mesh/merge_blocks must be auto|true|false, "
                f"got '{mode}'")
        if mode == "false":
            return mesh
        if mode == "auto" and dist.is_available() and dist.is_initialized() \
                and dist.get_world_size() > 1:
            return mesh
        merged = mesh
        if mesh.nblocks > 1:
            merged = dataclasses.replace(mesh, mbnx1=mesh.nx1,
                                         mbnx2=mesh.nx2, mbnx3=mesh.nx3)
        bcs = {merged.ix1_bc, merged.ox1_bc}
        if merged.nx2 > 1:
            bcs |= {merged.ix2_bc, merged.ox2_bc}
        if merged.nx3 > 1:
            bcs |= {merged.ix3_bc, merged.ox3_bc}
        pgen = get_pgen(pin.get_string("job", "problem_id"))
        has_bc_hook = getattr(pgen, "register_boundary_conditions",
                              None) is not None
        # unlike the JAX package (athenapk_tpu/driver.py:296), a problem
        # whose initial state needs ghosts keeps them (the cluster's
        # init_perturb/sigma_b)
        ghosts_hook = getattr(pgen, "needs_ghosts_at_init", None)
        keep = ghosts_hook is not None and ghosts_hook(pin)
        if bcs == {"periodic"} and not has_bc_hook and not keep \
                and merged.nghost > 0:
            merged = dataclasses.replace(merged, nghost=0)
        if restart is not None and merged is not mesh:
            shp = np.shape(restart["cons"])
            want = (1, shp[1]) + (
                merged.nx3 + 2 * merged.ng3, merged.nx2 + 2 * merged.ng2,
                merged.nx1 + 2 * merged.ng1)
            if tuple(shp) != want:
                return mesh
        return merged

    # ------------------------------------------------------------------ steps
    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _estimate(self):
        """``(dt, dt_hyp)`` of the state, with the pgen's dt constraint (a
        float or a 0-d tensor, read with the package's minima); keeps the
        diffusive dt in ``dt_diff``."""
        _, prim = self.pkg.cons_to_prim(self.u)
        cap = math.inf if self._pe_fn is None else self._pe_fn(prim, self.t)
        dt, dt_hyp, self.dt_diff = self.pkg.estimate_timestep(prim, cap)
        return dt, dt_hyp

    def _split_cycle(self):
        """Does a cycle run the JAX package's non-pipelined branch (RKL2,
        split sources or a pgen dt constraint)?"""
        return (self.pkg.sts or self.src_first_order is not None
                or self.src_strang is not None or self._pe_fn is not None)

    def _cycle(self, dt_eff, c_h):
        """One cycle of the non-pipelined branch (``athenapk_tpu/driver.py:
        360-396``): the RKL2 half super-step, the Strang source, the hydro
        step, the Strang source again, the first-order source, the second
        half super-step; each source followed by a boundary fill."""
        pkg = self.pkg
        if pkg.sts:
            self.u = pkg.sts_half_step(self.u, 0.5 * dt_eff, self.dt_diff)
        if self.src_strang is not None:
            self._split_source("strang_source", self.src_strang, dt_eff)
        self.u = pkg.step(self.u, dt_eff, c_h, self.t)
        if self.src_strang is not None:
            self._split_source("strang_source", self.src_strang, dt_eff)
        if self.src_first_order is not None:
            self._split_source("first_order_source", self.src_first_order,
                               dt_eff)
        if pkg.sts:
            self.u = pkg.sts_half_step(self.u, 0.5 * dt_eff, self.dt_diff)

    def _split_source(self, name, src, dt_eff):
        """A split source over the state at full dt in the range ``name``,
        then the ghost fill."""
        with record_function(name):
            u = src(self.u, dt_eff, self.t)
        with record_function("boundary_fill"):
            self.u = self.pkg.apply_boundaries(u)

    def _do_outputs(self, force=False):
        due = [out for out in self.outputs if force or out.due(self.t)]
        if not due:
            return
        u, w = self.pkg.cons_to_prim(self.u)
        for out in due:
            out.write(self.t, self.tm_dt if self.tm_dt is not None else 0.0,
                      u, w, self.mesh)

    def _move_tracers(self, dt_eff):
        """Advect the tracers over the cycle and sample them, with the prim
        of the cycle's final state (the JAX package's order on both of its
        branches)."""
        _, w = self.pkg.cons_to_prim(self.u)
        self.tracer_state = self.tracers.fill(
            self.tracers.advect(self.tracer_state, w, dt_eff), w)

    # ------------------------------------------------------------------- run
    def run(self):
        dt, dt_hyp = self._estimate()
        if self._loaded_dt_diff is not None:
            self.dt_diff = self._loaded_dt_diff
            self._loaded_dt_diff = None
        if self._prev_dt > 0.0:
            # continue the 2x growth cap across a loaded state
            dt = min(2.0 * self._prev_dt, dt)
            self._prev_dt = 0.0
        self.tm_dt = dt
        if self.tracer_state is not None \
                and self._fill_tracers_hook is not None \
                and not self.is_restart:
            # the problem's tracer fields right after seeding (the
            # reference calls ProblemFillTracers then, tracers.cpp:184-186)
            self.tracer_state = self._fill_tracers_hook(
                self.pin, self.mesh, self.cfg, self.tracer_state,
                self.ncycle, self.t, dt)
        self._do_outputs()

        zones = self.mesh.nx1 * self.mesh.nx2 * self.mesh.nx3
        perf_cycles = 0
        perf_start = None
        split = self._split_cycle()

        while self.t < self.tlim and (self.nlim < 0 or self.ncycle < self.nlim):
            if self.ncycle == self.perf_cycle_offset:
                self._sync()   # pending work before the perf clock starts
                perf_start = time.time()
            with record_function("cycle"):
                dt_eff = min(dt, self.tlim - self.t)
                c_h = self.pkg.c_h_from_dt_hyp(dt_hyp)
                if split:
                    self._cycle(dt_eff, c_h)
                else:
                    self.u, (dt_new, dt_hyp, self.dt_diff) = \
                        self.pkg.step_with_dt(self.u, dt_eff, c_h, self.t)
                if self.tracer_state is not None:
                    self._move_tracers(dt_eff)
                self.t += dt_eff
                self.ncycle += 1
                if self.tracer_state is not None \
                        and self._fill_tracers_hook is not None:
                    self.tracer_state = self._fill_tracers_hook(
                        self.pin, self.mesh, self.cfg, self.tracer_state,
                        self.ncycle, self.t, dt_eff)
                if perf_start is not None:
                    perf_cycles += 1
                self.tm_dt = dt_eff
                if split:
                    dt_new, dt_hyp = self._estimate()
                dt = min(2.0 * dt, dt_new)

            if not self.quiet and self.ncycle_out > 0 and \
                    self.ncycle % self.ncycle_out == 0:
                print(f"cycle={self.ncycle} time={self.t:.8e} dt={dt_eff:.8e}",
                      flush=True)
            self._do_outputs()

        self._sync()
        if perf_start is not None and perf_cycles > 0:
            wall = time.time() - perf_start
            zc_per_s = zones * perf_cycles / wall
            print(f"walltime used = {wall:.6e}")
            print(f"zone-cycles/wallsecond = {zc_per_s:.6e}", flush=True)

        self._do_outputs(force=True)
        after = getattr(self.pgen, "user_work_after_loop", None)
        if after is not None:
            after(self.pin, self.mesh, self.cfg, self.eos, self)
        return self

    # ------------------------------------------------------------- accessors
    def cons(self):
        u, _ = self.pkg.cons_to_prim(self.u)
        return u.cpu().numpy()


class _Hdf5Output:
    """An hdf5 output block: ``.phdf`` dumps of ``cons`` and/or ``prim``
    (and the tracer swarm), every ``dt`` (negative: the final dump only)."""

    def __init__(self, sim, oid, variables, dt, single_precision,
                 swarm_vars):
        self.sim = sim
        self.oid = oid
        self.variables = variables
        self.dt = dt
        self.single_precision = single_precision
        self.swarm_vars = swarm_vars
        self.next_time = 0.0
        self.count = 0

    def due(self, t):
        return self.dt >= 0.0 and t >= self.next_time

    def write(self, t, dt, u, w, mesh):
        sim = self.sim
        fname = f"{sim.problem_id}.out_{self.oid}.{self.count:05d}.phdf"
        kw = {}
        if "cons" in self.variables:
            kw["cons"] = u.cpu().numpy()
        if "prim" in self.variables:
            kw["prim"] = w.cpu().numpy()
        if self.swarm_vars and sim.tracer_state is not None:
            kw["swarms"] = {name: compact_swarm(sim.tracer_state, vs)
                            for name, vs in self.swarm_vars.items()}
        # NCycle holds the dump's count, as in the JAX package
        write_phdf(fname, mesh, sim.cfg.fluid, t, dt, self.count,
                   single_precision=self.single_precision, **kw)
        self.count += 1
        while self.dt > 0.0 and self.next_time <= t:
            self.next_time += self.dt


class _RestartOutput:
    """An rst output block: ``.rhdf`` checkpoints every ``dt``."""

    def __init__(self, sim, oid, dt):
        self.sim = sim
        self.oid = oid
        self.dt = dt
        self.next_time = 0.0
        self.count = 0

    def due(self, t):
        return self.dt >= 0.0 and t >= self.next_time

    def write(self, t, dt, u, w, mesh):
        fname = (f"{self.sim.problem_id}.out_{self.oid}."
                 f"{self.count:05d}.rhdf")
        # the trigger advances BEFORE the write, so the checkpoint holds
        # the state after it: a resume continues at count+1
        self.count += 1
        while self.dt > 0.0 and self.next_time <= t:
            self.next_time += self.dt
        write_restart(fname, self.sim)


def run_from_file(path: str, overrides=None, quiet=False, device="cuda"):
    pin = ParameterInput.from_file(path, overrides)
    mode = pin.get_or_add_string("parthenon/mesh", "refinement", "none")
    if mode in ("static", "adaptive"):
        return SmrSimulation(pin, quiet=quiet, device=device).run()
    if mode != "none":
        raise ValueError(
            f"<parthenon/mesh> refinement = '{mode}' — expected "
            "'none', 'static', or 'adaptive'")
    return Simulation(pin, quiet=quiet, device=device).run()


def run_from_restart(path: str, overrides=None, quiet=False,
                     device="cuda"):
    """Resume the checkpoint ``path`` (either package's ``.rhdf``) with
    ``overrides`` applied to its stored deck; a refined-mesh checkpoint
    (its payload has ``levels``) resumes in ``SmrSimulation``."""
    pin, payload = read_restart(path)
    if overrides:
        pin.apply_overrides(overrides)
    if "levels" in payload:
        return SmrSimulation(pin, quiet=quiet, device=device,
                             restart=payload).run()
    return Simulation(pin, quiet=quiet, device=device,
                      restart=payload).run()


def write_restart_file(sim, fname):
    """Write ``sim``'s checkpoint (uniform or refined) to ``fname``."""
    if hasattr(sim, "_smesh_now"):
        write_restart_smr(fname, sim)
    else:
        write_restart(fname, sim)


def traced(trace_dir, fn, device):
    """``fn()`` inside ``torch.profiler.profile`` (CPU activity, and CUDA
    activity on a CUDA device), its Chrome trace exported to
    ``trace_dir/trace.json``; -> ``fn()``'s result."""
    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        out = fn()
    prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))
    return out


def main(argv=None):
    """CLI: python -m athenapk_tpu_torch.driver -i deck.in [ovr...]
            python -m athenapk_tpu_torch.driver -r file.rhdf [ovr...]
       Options: --device cuda|cpu; -t TRACE_DIR (a torch.profiler trace of
       the run in TRACE_DIR/trace.json, with the ranges of the module
       docstring)."""
    argv = list(argv if argv is not None else sys.argv[1:])
    opts = {}
    for flag in ("--device", "-t"):
        if flag in argv:
            i = argv.index(flag)
            opts[flag] = argv[i + 1]
            argv = argv[:i] + argv[i + 2:]
    device = opts.get("--device", "cuda")

    def _run():
        for flag, run in (("-r", run_from_restart), ("-i", run_from_file)):
            if flag in argv:
                i = argv.index(flag)
                overrides = [a for a in argv[:i] + argv[i + 2:] if "=" in a]
                run(argv[i + 1], overrides, device=device)
                return 0
        print("usage: python -m athenapk_tpu_torch.driver -i input.in "
              "[block/key=value ...]  (or -r file.rhdf) [-t trace_dir] "
              "[--device cuda|cpu]")
        return 1

    if "-t" in opts:
        return traced(opts["-t"], _run, device)
    return _run()


if __name__ == "__main__":
    raise SystemExit(main())

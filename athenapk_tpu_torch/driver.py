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

Not ported yet (``NotImplementedError``): hdf5 and rst outputs, tracers,
restart (``-r``), refined meshes, diffusion, cooling.
"""

from __future__ import annotations

import dataclasses
import sys
import time
from typing import Optional

import numpy as np
import torch

from .config.parameter_input import ParameterInput
from .core.mesh import Mesh
from .eos.adiabatic import EOS
from .outputs.history import HistoryOutput
from .pgen import get_pgen
from .solver.hydro_pkg import HydroConfig, HydroPackage

_DTYPES = {"double": torch.float64, "single": torch.float32}


def resolve_device(device) -> torch.device:
    """``torch.device`` for ``device``; refuses CUDA where there is none
    rather than quietly running on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; ask for the CPU "
                           "explicitly (device='cpu', or --device cpu)")
    return dev


def _check_ported(pin) -> None:
    """Raise NotImplementedError for deck features this port lacks."""
    mode = pin.get_or_add_string("parthenon/mesh", "refinement", "none")
    if mode in ("static", "adaptive"):
        raise NotImplementedError(
            f"refinement = {mode} (refined meshes) is not ported to "
            "athenapk_tpu_torch yet")
    if pin.has_block("diffusion") and any(
            pin.get_or_add_string("diffusion", k, "none") != "none"
            for k in ("conduction", "viscosity", "resistivity")):
        raise NotImplementedError("diffusion is not ported to "
                                  "athenapk_tpu_torch yet")
    if pin.get_or_add_string("cooling", "enable_cooling", "none") != "none":
        raise NotImplementedError("cooling is not ported to "
                                  "athenapk_tpu_torch yet")
    if pin.get_or_add_bool("tracers", "enabled", False):
        raise NotImplementedError("tracers are not ported to "
                                  "athenapk_tpu_torch yet")
    for blk in pin.output_blocks():
        ftype = pin.get_string(blk, "file_type")
        if ftype in ("hdf5", "rst"):
            raise NotImplementedError(
                f"<{blk}> file_type = {ftype}: {ftype} output is not ported "
                "to athenapk_tpu_torch yet (hst is)")


class Simulation:
    """Owns mesh, package, state and the time loop."""

    def __init__(self, pin: ParameterInput, quiet: bool = False,
                 device="cuda"):
        self.pin = pin
        self.quiet = quiet
        self.device = resolve_device(device)
        self.problem_id = pin.get_string("job", "problem_id")

        prec = pin.get_or_add_string("hydro", "precision", "double")
        if prec not in _DTYPES:
            raise ValueError(f"hydro/precision must be single|double, "
                             f"got '{prec}'")
        self.dtype = _DTYPES[prec]
        _check_ported(pin)

        self.mesh = Mesh.from_parameter_input(pin)
        self.cfg = HydroConfig.from_parameter_input(pin)
        self.eos = EOS.from_parameter_input(pin)
        self.pgen = get_pgen(self.problem_id)
        # InitUserMeshData analog: may mutate pin (linear_wave test=true
        # rescales tlim) before the time controls are read below
        init_hook = getattr(self.pgen, "init_user_mesh_data", None)
        if init_hook is not None:
            init_hook(pin)
        self.mesh = self._merge_blocks(pin, self.mesh)
        self.pkg = HydroPackage(self.mesh, self.cfg, self.eos)

        t = "parthenon/time"
        self.tlim = pin.get_real(t, "tlim")
        self.nlim = pin.get_or_add_integer(t, "nlim", -1)
        self.perf_cycle_offset = pin.get_or_add_integer(
            t, "perf_cycle_offset", 0)
        self.ncycle_out = pin.get_or_add_integer(t, "ncycle_out", 1)

        u = torch.as_tensor(self.pgen.problem_generator(
            pin, self.mesh, self.cfg, self.eos), dtype=self.dtype,
            device=self.device)
        self.u = self.pkg.apply_boundaries(u)
        self.t = 0.0
        self.ncycle = 0
        self._prev_dt = 0.0   # dt before a loaded state (2x growth cap)
        self.tm_dt = None     # set by run

        self.outputs = []
        for blk in pin.output_blocks():
            if pin.get_string(blk, "file_type") != "hst":
                continue
            dt_out = pin.get_or_add_real(blk, "dt", -1.0)
            oid = pin.get_or_add_string(blk, "id", blk.rsplit("output", 1)[-1])
            hook = getattr(self.pgen, "history_columns", None)
            extra_cols = (hook(pin, self.mesh, self.cfg, self.eos)
                          if hook is not None else ())
            self.outputs.append(HistoryOutput(
                f"{self.problem_id}.out{oid}.hst", self.cfg.fluid, dt_out,
                extra_columns=extra_cols))

    # ----------------------------------------------------------- state I/O
    def load_state(self, cons: np.ndarray, t: float, ncycle: int,
                   dt: Optional[float] = None):
        """Replace the state with ``cons`` ([nblocks, nvar, NZ, NY, NX] in
        this simulation's layout, e.g. another package's state) at time
        ``t`` and cycle ``ncycle``, on this simulation's device and dtype.
        ``dt``, the last cycle's step, caps the first step at 2*dt."""
        want = (self.mesh.nblocks, self.cfg.nvar) + self.mesh.block_shape
        if tuple(cons.shape) != want:
            raise ValueError(f"state shape {tuple(cons.shape)} does not match "
                             f"this simulation's layout {want}")
        self.u = torch.from_numpy(np.array(cons)).to(device=self.device,
                                                     dtype=self.dtype)
        self.t = float(t)
        self.ncycle = int(ncycle)
        self._prev_dt = float(dt) if dt else 0.0
        return self

    # ----------------------------------------------------------- block merge
    @staticmethod
    def _merge_blocks(pin, mesh):
        """A uniform mesh on one device solves as ONE mesh-spanning block,
        ghost-free when every boundary is periodic (cyclic rolls are the
        boundary; no ghost storage and no fill pass).

        ``parthenon/mesh/merge_blocks = auto|true|false``: ``auto`` merges
        when the run has one device, and this port runs one device per
        process, so ``auto`` merges."""
        mode = pin.get_or_add_string("parthenon/mesh", "merge_blocks",
                                     "auto")
        if mode not in ("auto", "true", "false"):
            raise ValueError(
                f"parthenon/mesh/merge_blocks must be auto|true|false, "
                f"got '{mode}'")
        if mode == "false":
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
        if bcs == {"periodic"} and merged.nghost > 0:
            merged = dataclasses.replace(merged, nghost=0)
        return merged

    # ------------------------------------------------------------------ steps
    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _estimate(self):
        _, prim = self.pkg.cons_to_prim(self.u)
        dt, dt_hyp, _ = self.pkg.estimate_timestep(prim)
        return dt, dt_hyp

    def _do_outputs(self, force=False):
        due = [out for out in self.outputs if force or out.due(self.t)]
        if not due:
            return
        u, w = self.pkg.cons_to_prim(self.u)
        for out in due:
            out.write(self.t, self.tm_dt if self.tm_dt is not None else 0.0,
                      u, w, self.mesh)

    # ------------------------------------------------------------------- run
    def run(self):
        dt, dt_hyp = self._estimate()
        if self._prev_dt > 0.0:
            # continue the 2x growth cap across a loaded state
            dt = min(2.0 * self._prev_dt, dt)
            self._prev_dt = 0.0
        self.tm_dt = dt
        self._do_outputs()

        zones = self.mesh.nx1 * self.mesh.nx2 * self.mesh.nx3
        perf_cycles = 0
        perf_start = None

        while self.t < self.tlim and (self.nlim < 0 or self.ncycle < self.nlim):
            if self.ncycle == self.perf_cycle_offset:
                self._sync()   # pending work before the perf clock starts
                perf_start = time.time()
            dt_eff = min(dt, self.tlim - self.t)
            c_h = self.pkg.c_h_from_dt_hyp(dt_hyp)
            self.u, (dt_new, dt_hyp, _) = self.pkg.step_with_dt(
                self.u, dt_eff, c_h)
            self.t += dt_eff
            self.ncycle += 1
            if perf_start is not None:
                perf_cycles += 1
            self.tm_dt = dt_eff
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


def run_from_file(path: str, overrides=None, quiet=False, device="cuda"):
    pin = ParameterInput.from_file(path, overrides)
    mode = pin.get_or_add_string("parthenon/mesh", "refinement", "none")
    if mode not in ("none", "static", "adaptive"):
        raise ValueError(
            f"<parthenon/mesh> refinement = '{mode}' — expected "
            "'none', 'static', or 'adaptive'")
    return Simulation(pin, quiet=quiet, device=device).run()


def main(argv=None):
    """CLI: python -m athenapk_tpu_torch.driver -i deck.in [--device cpu]
    [block/key=value ...]"""
    argv = list(argv if argv is not None else sys.argv[1:])
    device = "cuda"
    if "--device" in argv:
        i = argv.index("--device")
        device = argv[i + 1]
        argv = argv[:i] + argv[i + 2:]
    if "-r" in argv:
        raise NotImplementedError("restart (-r) is not ported to "
                                  "athenapk_tpu_torch yet")
    if "-t" in argv:
        raise NotImplementedError("profiler traces (-t) are not ported to "
                                  "athenapk_tpu_torch yet")
    if "-i" not in argv:
        print("usage: python -m athenapk_tpu_torch.driver -i input.in "
              "[--device cuda|cpu] [block/key=value ...]")
        return 1
    i = argv.index("-i")
    path = argv[i + 1]
    overrides = [a for a in argv[:i] + argv[i + 2:] if "=" in a]
    run_from_file(path, overrides, device=device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

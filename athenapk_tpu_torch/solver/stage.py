"""The whole-stage function: cons_to_prim + -div(F) + the 2S stage update.

Counterpart of ``athenapk_tpu/solver/pallas_sweep.py:make_fused_stage``:
for 3-D ``[nb, nvar, NZ, NY, NX]`` conserved states ``u0`` and ``u1``,

    u0f, prim = cons_to_prim(u0)                    (floors applied)
    u_new = gam0 * u0f + gam1 * u1 + beta_dt * (-div F(prim))

with two optional outputs: ``emit_dt`` adds the raw hyperbolic CFL bound
``min_d dx_d / (|v_d| + lam_d)`` of ``cons_to_prim(u_new)`` (a tensor whose
minimum is the bound over all cells; ghost-free layouts only, where every
cell is an interior cell), ``emit_prim`` adds the stage-start ``prim``.
Output order, as the JAX function's: ``u_new[, raw_dt][, prim]``.  Every
shift wraps within a block, as in ``solver/sweep.py``.

* ``stage_plain`` — the plain PyTorch version.
* ``stage_cuda`` — the hand-written Hopper kernel (``csrc/fused_stage.cu``:
  Euler with LLF, HLLE or HLLC, GLM-MHD with LLF, HLLE or HLLD; DC, PLM,
  PPM, WENO3, LimO3 or WENO-Z, as ``make_fused_stage`` takes them; f32 and
  f64), one launch per stage, built with ``nvcc`` into ``build/`` at first
  use (``core.kernels``).
* ``fused_stage`` — takes the plain version for a CPU tensor and the kernel
  for any other; it never falls back from one to the other.

Passive scalars: the stage launch also writes every face's mass flux, and
the scalar kernel of the same source (``stage_scalars_cuda``) then does
the scalar rows of the stage; ``stage_scalars_plain`` is its plain twin.

The refined-mesh form, counterpart of ``make_fused_stage_faces``: on
ghosted 3-D blocks, the stage plus each direction's Riemann fluxes at the
block's two interior boundary faces (``sweep.boundary_faces``), which the
coarse-fine flux correction reads.  ``stage_faces_plain``,
``stage_faces_cuda`` (the same kernel with its face output) and
``fused_stage_faces`` return ``(u_new, prim or None, {d: faces})``.
"""

from __future__ import annotations

import ctypes

import torch

from ..core import kernels
from ..core.indices import EULER, IB1, IB2, IB3, IDN, IPR
from ..eos.adiabatic import (cons_to_prim, fast_magnetosonic_speed,
                             sound_speed)
from . import sweep

CSRC = kernels.CSRC_DIR / "fused_stage.cu"


def _check_layout(mesh, emit_dt):
    if not (mesh.nx2 > 1 and mesh.nx3 > 1):
        raise ValueError("the whole-stage function is 3-D only")
    if emit_dt and mesh.nghost != 0:
        raise ValueError("emit_dt needs the ghost-free layout (nghost = 0): "
                         "its minimum runs over every cell")


def raw_cfl_dt(prim, mesh, cfg, eos, dirs=(1, 2, 3)):
    """Per cell, ``min_d dx_d / (|v_d| + lam_d)`` over the directions
    ``dirs`` (the stage's bound takes all three)."""
    rho, p = prim[:, IDN], prim[:, IPR]
    if cfg.fluid == EULER:
        cs = sound_speed(eos, rho, p)
        lam = (cs, cs, cs)
    else:
        b1, b2, b3 = prim[:, IB1], prim[:, IB2], prim[:, IB3]
        lam = (fast_magnetosonic_speed(eos, rho, p, b1, b2, b3),
               fast_magnetosonic_speed(eos, rho, p, b2, b3, b1),
               fast_magnetosonic_speed(eos, rho, p, b3, b1, b2))
    m = None
    for d in dirs:
        t = mesh.dx[d - 1] / (torch.abs(prim[:, d]) + lam[d - 1])
        m = t if m is None else torch.minimum(m, t)
    return m


# ------------------------------------------------------------------ plain
def stage_plain(u0, u1, gam0, gam1, beta_dt, c_h, mesh, cfg, eos, recon,
                emit_dt=False, emit_prim=False):
    """The stage as whole-tensor operations; ``raw_dt`` is the per-cell
    bound."""
    _check_layout(mesh, emit_dt)
    u0f, prim = cons_to_prim(eos, u0, cfg.fluid, cfg.nscalars)
    negdiv = sweep.negdiv_plain(prim, c_h, mesh, cfg, eos, recon)
    u_new = gam0 * u0f + gam1 * u1 + beta_dt * negdiv
    out = [u_new]
    if emit_dt:
        _, w_new = cons_to_prim(eos, u_new, cfg.fluid, cfg.nscalars)
        out.append(raw_cfl_dt(w_new, mesh, cfg, eos))
    if emit_prim:
        out.append(prim)
    return out[0] if len(out) == 1 else tuple(out)


def stage_faces_plain(u0, u1, gam0, gam1, beta_dt, c_h, mesh, cfg, eos, recon,
                      emit_prim=False):
    """The stage and its boundary-face slabs as whole-tensor operations:
    ``stage_plain`` with its fluxes kept."""
    _check_layout(mesh, False)
    sweep.check_faces_layout(mesh)
    u0f, prim = cons_to_prim(eos, u0, cfg.fluid, cfg.nscalars)
    fluxes = sweep.compute_fluxes(prim, c_h, mesh, cfg, eos, recon)
    negdiv = -sweep.flux_divergence(fluxes, mesh)
    u_new = gam0 * u0f + gam1 * u1 + beta_dt * negdiv
    return (u_new, prim if emit_prim else None,
            sweep.boundary_faces(fluxes, mesh))


def stage_scalars_plain(u0, u1, mfluxes, gam0, gam1, beta_dt, mesh, cfg, eos,
                        recon):
    """The scalar rows of the stage from the three directions' mass fluxes
    (``{d: [nb, NZ, NY, NX]}``): ``(u_new, prim)`` of those rows, each
    ``[nb, nscalars, NZ, NY, NX]``.  The plain twin of the scalar kernel
    (what ``stage_plain`` computes for those rows)."""
    nb0 = sweep.scalar_base(cfg)
    u_d = u0[:, IDN:IDN + 1]
    if eos.density_floor > 0.0:
        u_d = torch.clamp(u_d, min=eos.density_floor)
    w = u0[:, nb0:] * (1.0 / u_d)
    prim = torch.cat([u0[:, :nb0], w], dim=1)
    negdiv = None
    for d in (1, 2, 3):
        nd, _ = sweep.negdiv_scalars_plain(prim, mfluxes[d], d, mesh, cfg,
                                           recon)
        negdiv = nd if negdiv is None else negdiv + nd
    return gam0 * u0[:, nb0:] + gam1 * u1[:, nb0:] + beta_dt * negdiv, w


# ------------------------------------------------------------------- CUDA
def build_library(scalars=False):
    """Compile ``csrc/fused_stage.cu`` (see ``sweep.build_library``)."""
    return kernels.build_library(CSRC, sweep.build_units(scalars),
                                 scalars=scalars)


ENTRIES = {
    "fused_stage": ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 9
                    + [ctypes.c_double] * 7
                    + [ctypes.POINTER(ctypes.c_double)] * 2
                    + [ctypes.c_void_p] * 4, ctypes.c_int),
    "fused_stage_tiles": ([ctypes.c_int] * 4, ctypes.c_int),
    "fused_stage_occupancy": ([ctypes.c_int] * 5
                              + [ctypes.POINTER(ctypes.c_int)],
                              ctypes.c_int)}
SCALAR_ENTRIES = {
    "stage_scalars": ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 9
                      + [ctypes.c_double] * 6
                      + [ctypes.POINTER(ctypes.c_double)] * 2
                      + [ctypes.c_void_p] * 4, ctypes.c_int),
    "stage_scalars_occupancy": ([ctypes.c_int] * 2
                                + [ctypes.POINTER(ctypes.c_int)],
                                ctypes.c_int)}


def _library(scalars=False):
    """The loaded library of decks without scalars or (``scalars``) of
    decks with scalars, built at first use."""
    scalars = bool(scalars)
    return kernels.load(CSRC, sweep.build_units(scalars),
                        {**ENTRIES, **SCALAR_ENTRIES} if scalars else ENTRIES,
                        scalars=scalars)


# how ``kernels.ptxas_summary`` names an instantiation of the stage's
# kernels from its template switches (reconstruction, solver, faces,
# scalars), its threads per block, and its occupancy query
PTXAS = {
    "fused_stage": (
        lambda k: (f"{sweep.RECON_NAMES[k[0]]} {sweep.SOLVER_NAMES[k[1]]}"
                   f"{' faces' if k[2] else ''}"
                   f"{' +scalars' if sweep.scalars_switch(k) else ''}"), 128,
        lambda dt, k: kernels.occupancy_of(
            _library(sweep.scalars_switch(k)).fused_stage_occupancy, dt,
            k[1], k[0], k[2], sweep.scalars_switch(k))),
    "stage_scalars": (
        lambda k: f"{sweep.RECON_NAMES[k[0]]} all directions", 128,
        lambda dt, k: kernels.occupancy_of(
            _library(True).stage_scalars_occupancy, dt, k[0]))}


def stage_scalars_cuda(u0, u1, u_new, prim, slabs, mfluxes, gam0, gam1,
                       beta_dt, mesh, cfg, eos, recon):
    """The scalar rows of the stage by the scalar kernel, after the stage
    launch (same stream) wrote the mass fluxes ``mfluxes`` (``{d:
    tensor}``): writes the scalar rows of ``u_new``, ``prim`` and the face
    ``slabs`` (either may be None).  ``stage_scalars_cuda.launches``
    counts the launches."""
    nb, nvar, nz, ny, nx = u0.shape
    kernels.launch(
        _library(True).stage_scalars, u0.data_ptr(), u1.data_ptr(),
        u_new.data_ptr(),
        prim.data_ptr() if prim is not None else None,
        *(slabs[d].data_ptr() if slabs else None for d in (1, 2, 3)),
        mesh.nghost if slabs else 0, kernels.KERNEL_DTYPES[u0.dtype],
        sweep.KERNEL_RECONS[recon], nb, nvar, sweep.scalar_base(cfg), nz, ny,
        nx, float(mesh.dx1), float(mesh.dx2), float(mesh.dx3), float(gam0),
        float(gam1), float(beta_dt), _eos_args(eos), _recon_k(mesh),
        *(mfluxes[d].data_ptr() for d in (1, 2, 3)),
        torch.cuda.current_stream(u0.device).cuda_stream)
    stage_scalars_cuda.launches += 1


stage_scalars_cuda.launches = 0


def _eos_args(eos):
    return (ctypes.c_double * 6)(
        eos.gamma, eos.density_floor, eos.pressure_floor,
        eos.internal_e_floor, eos.velocity_ceiling, eos.internal_e_ceiling)


def _recon_k(mesh):
    return (ctypes.c_double * 6)(*(
        k for d in (1, 2, 3) for k in sweep.recon_constants(
            float(mesh.dx[d - 1]))))


def _stage_launch(name, u0, u1, gam0, gam1, beta_dt, c_h, mesh, cfg, eos,
                  recon, emit_dt, emit_prim, faces):
    """One launch of the stage kernel on the current stream (and, with
    scalars, one of the scalar kernel after it); returns ``(u_new, raw_dt
    or None, prim or None, faces or None)``, ``faces`` allocated here when
    asked for."""
    sweep.check_kernel_config(cfg, recon)
    _check_layout(mesh, emit_dt)
    sweep.check_kernel_tensor(name, u0, mesh, cfg)
    sweep.check_kernel_tensor(name, u1, mesh, cfg)
    if u1.dtype != u0.dtype or u1.device != u0.device \
            or u1.shape != u0.shape:
        raise ValueError(f"{name}: u0 and u1 must agree in shape, dtype "
                         "and device")
    lib = _library(cfg.nscalars > 0)
    nb, nvar, nz, ny, nx = u0.shape
    u_new = torch.empty_like(u0)
    raw_dt = torch.empty(nb * lib.fused_stage_tiles(nb, nz, ny, nx),
                         dtype=u0.dtype, device=u0.device) if emit_dt else None
    prim = torch.empty_like(u0) if emit_prim else None
    slabs = {d: torch.empty(sweep.face_shape(u0, d), dtype=u0.dtype,
                            device=u0.device) for d in (1, 2, 3)} \
        if faces else None
    mfluxes = {d: torch.empty((nb, nz, ny, nx), dtype=u0.dtype,
                              device=u0.device) for d in (1, 2, 3)} \
        if cfg.nscalars else None
    with torch.cuda.device(u0.device):
        kernels.launch(
            lib.fused_stage, u0.data_ptr(), u1.data_ptr(), u_new.data_ptr(),
            raw_dt.data_ptr() if emit_dt else None,
            prim.data_ptr() if emit_prim else None,
            *(slabs[d].data_ptr() if faces else None for d in (1, 2, 3)),
            mesh.nghost if faces else 0,
            kernels.KERNEL_DTYPES[u0.dtype],
            sweep.KERNEL_SOLVERS[cfg.fluid, cfg.riemann],
            sweep.KERNEL_RECONS[recon], nb, nvar, nz, ny, nx,
            float(mesh.dx1), float(mesh.dx2), float(mesh.dx3), float(gam0),
            float(gam1), float(beta_dt), float(c_h), _eos_args(eos),
            _recon_k(mesh),
            *(mfluxes[d].data_ptr() if mfluxes else None for d in (1, 2, 3)),
            torch.cuda.current_stream(u0.device).cuda_stream)
        if mfluxes:
            stage_scalars_cuda(u0, u1, u_new, prim, slabs, mfluxes, gam0,
                               gam1, beta_dt, mesh, cfg, eos, recon)
    return u_new, raw_dt, prim, slabs


def stage_cuda(u0, u1, gam0, gam1, beta_dt, c_h, mesh, cfg, eos, recon,
               emit_dt=False, emit_prim=False):
    """The stage by the Hopper kernel: one launch on the current stream.
    ``raw_dt`` is one bound per tile of the kernel.  Raises on anything the
    kernel does not take; ``stage_cuda.launches`` counts the launches."""
    u_new, raw_dt, prim, _ = _stage_launch(
        "stage_cuda", u0, u1, gam0, gam1, beta_dt, c_h, mesh, cfg, eos,
        recon, emit_dt, emit_prim, faces=False)
    stage_cuda.launches += 1
    out = [u_new] + [x for x in (raw_dt, prim) if x is not None]
    return out[0] if len(out) == 1 else tuple(out)


stage_cuda.launches = 0


def stage_faces_cuda(u0, u1, gam0, gam1, beta_dt, c_h, mesh, cfg, eos, recon,
                     emit_prim=False):
    """The stage and its boundary-face slabs by the Hopper kernel: one
    launch on the current stream.  Raises on anything the kernel does not
    take; ``stage_faces_cuda.launches`` counts the launches."""
    sweep.check_faces_layout(mesh)
    u_new, _, prim, slabs = _stage_launch(
        "stage_faces_cuda", u0, u1, gam0, gam1, beta_dt, c_h, mesh, cfg, eos,
        recon, False, emit_prim, faces=True)
    stage_faces_cuda.launches += 1
    return u_new, prim, slabs


stage_faces_cuda.launches = 0


def fused_stage(u0, u1, gam0, gam1, beta_dt, c_h, mesh, cfg, eos, recon,
                emit_dt=False, emit_prim=False):
    """The stage: the plain version for a CPU tensor, the CUDA kernel for
    any other (which launches or raises)."""
    fn = stage_plain if u0.device.type == "cpu" else stage_cuda
    return fn(u0, u1, gam0, gam1, beta_dt, c_h, mesh, cfg, eos, recon,
              emit_dt=emit_dt, emit_prim=emit_prim)


def fused_stage_faces(u0, u1, gam0, gam1, beta_dt, c_h, mesh, cfg, eos, recon,
                      emit_prim=False):
    """``(u_new, prim or None, {d: faces})``: the plain version for a CPU
    tensor, the CUDA kernel for any other (which launches or raises)."""
    fn = stage_faces_plain if u0.device.type == "cpu" else stage_faces_cuda
    return fn(u0, u1, gam0, gam1, beta_dt, c_h, mesh, cfg, eos, recon,
              emit_prim=emit_prim)

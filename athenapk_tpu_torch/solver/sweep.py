"""The fused -div(F) sweep: reconstruction + Riemann solve + flux divergence.

Counterpart of ``athenapk_tpu/solver/pallas_sweep.py``
(``make_lane_sweep_negdiv`` composed by ``make_fused_negdiv`` on 3-D
meshes, ``make_fused_negdiv_v2`` on 1-D and 2-D meshes): the function
``(prim, c_h) -> sum_d -(F_d[i+1] - F_d[i]) / dx_d`` over the active
directions, for a ``[nb, nvar, NZ, NY, NX]`` primitive tensor.  Every shift
wraps within a block (``torch.roll``), which is the periodic boundary on
the ghost-free layout and lands in the ghost rim otherwise.

* ``negdiv_plain`` — the plain PyTorch version (whole-tensor sweeps),
  ``-flux_divergence(compute_fluxes(...))``.
* ``negdiv_cuda`` — the hand-written Hopper kernel
  (``csrc/negdiv_sweep.cu``: Euler with LLF, HLLE or HLLC, GLM-MHD with
  LLF, HLLE or HLLD; DC, PLM, PPM, WENO3, LimO3 or WENO-Z), one launch per
  active direction accumulating into the output.  It is built with
  ``nvcc`` into ``build/`` at first use (``core.kernels``; one translation
  unit per reconstruction and dtype, compiled in parallel).
* ``fused_negdiv`` — takes the plain version for a CPU tensor and the
  kernel for a CUDA tensor; it never falls back from one to the other.

Passive scalars (``cfg.nscalars > 0``): each direction's fluid launch also
writes the face mass fluxes, and a second hand-written kernel of the same
source, ``negdiv_scalars_cuda``, does the scalar rows from them (upwind
fluxes of the reconstructed scalars, as ``riemann/solvers.py``'s
``_scalar_fluxes``); ``negdiv_scalars_plain`` is its plain twin.

The refined-mesh form (counterpart of ``make_fused_negdiv_faces_v2``, 3-D
and 2-D, and of ``make_lane_sweep_negdiv_faces`` as composed by
``make_fused_negdiv_faces``) also returns, per active direction d, the
Riemann fluxes at a ghosted block's two interior boundary faces, sweep
index ``g`` and ``g + n`` (``n`` interior cells), as
``[nb, nvar, A, B, 2]`` (x: A, B = z, y; y: z, x; z: y, x): the values the
coarse-fine flux correction reads (``amr/smr_hydro.py``).
``negdiv_faces_plain``, ``negdiv_faces_cuda`` (the same kernel with its
face output) and ``fused_negdiv_faces`` return ``(negdiv, {d: faces})``.

``build_units``, ``check_kernel_config``, ``check_kernel_tensor`` and the
switch codes also serve the whole-stage kernel (``solver/stage.py``).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..core import kernels
from ..core.indices import AXIS_OF_DIR, EULER, GLMMHD, NGLMMHD, NHYDRO
from ..recon import positivity_mask, reconstruct, schemes
from ..riemann import solve_riemann

CSRC = kernels.CSRC_DIR / "negdiv_sweep.cu"

# codes of the kernels' template switches (csrc/hydro_device.cuh)
KERNEL_RECONS = {"dc": 0, "plm": 1, "ppm": 2, "weno3": 3, "limo3": 4,
                 "wenoz": 5}
KERNEL_SOLVERS = {(EULER, "hlle"): 0, (EULER, "hllc"): 1, (GLMMHD, "hlld"): 2,
                  (EULER, "llf"): 3, (GLMMHD, "llf"): 4, (GLMMHD, "hlle"): 5}


def active_dirs(mesh):
    dirs = [1]
    if mesh.nx2 > 1:
        dirs.append(2)
    if mesh.nx3 > 1:
        dirs.append(3)
    return dirs


# ------------------------------------------------------------------ plain
def directional_flux(prim, c_h, d, dx, cfg, eos, recon):
    """Flux tensor of direction ``d``, co-indexed faces (index i = face
    i-1/2): ``wl = qp[i-1]``, ``wr = qm[i]``.  LimO3 keeps density and
    pressure positive (``recon.positivity_mask``)."""
    axis = AXIS_OF_DIR[d]
    qm, qp = reconstruct(recon, prim, axis, dx,
                         positivity_mask=positivity_mask(cfg.nvar))
    wl = torch.roll(qp, 1, dims=axis)   # right edge of cell i-1
    return solve_riemann(cfg.riemann, cfg.fluid, eos, wl, qm, d,
                         c_h=c_h, nscalars=cfg.nscalars)


def compute_fluxes(prim, c_h, mesh, cfg, eos, recon):
    """One flux tensor per active direction, co-indexed faces (i = i-1/2)
    (``CalculateFluxes``, ``src/hydro/hydro.cpp:1026-1208``)."""
    return {d: directional_flux(prim, c_h, d, mesh.dx[d - 1], cfg, eos,
                                recon)
            for d in active_dirs(mesh)}


def flux_divergence(fluxes, mesh):
    """div(F) with the reference's sign convention
    ``u_new = ... - beta*dt*divF`` (``Update::UpdateWithFluxDivergence``)."""
    div = None
    for d, F in fluxes.items():
        dFx = (torch.roll(F, -1, dims=AXIS_OF_DIR[d]) - F) / mesh.dx[d - 1]
        div = dFx if div is None else div + dFx
    return div


def negdiv_plain(prim, c_h, mesh, cfg, eos, recon):
    """-div(F) summed over the active directions, as whole-tensor ops."""
    return -flux_divergence(compute_fluxes(prim, c_h, mesh, cfg, eos, recon),
                            mesh)


def boundary_faces(fluxes, mesh):
    """``{d: [nb, nvar, A, B, 2]}``: each direction's fluxes at sweep index
    ``g`` and ``g + n`` (co-indexed faces: index i is face i-1/2), as
    ``SmrHydro._slabs_from_fluxes`` slices them."""
    out = {}
    for d, F in fluxes.items():
        g = (mesh.ng1, mesh.ng2, mesh.ng3)[d - 1]
        n = (mesh.mbnx1, mesh.mbnx2, mesh.mbnx3)[d - 1]
        ax = AXIS_OF_DIR[d]
        out[d] = torch.stack([F.select(ax, g), F.select(ax, g + n)], dim=-1)
    return out


def check_faces_layout(mesh):
    if mesh.nghost == 0:
        raise ValueError("face capture needs ghosted blocks (nghost > 0)")


def negdiv_faces_plain(prim, c_h, mesh, cfg, eos, recon):
    """``(-div(F), {d: faces})``: ``negdiv_plain`` plus the boundary-face
    slabs of its fluxes."""
    check_faces_layout(mesh)
    fluxes = compute_fluxes(prim, c_h, mesh, cfg, eos, recon)
    return -flux_divergence(fluxes, mesh), boundary_faces(fluxes, mesh)


def scalar_base(cfg):
    """The first scalar's row: the fluid's variable count."""
    return NGLMMHD if cfg.fluid == GLMMHD else NHYDRO


def negdiv_scalars_plain(prim, mflux, d, mesh, cfg, recon):
    """The scalar rows of direction ``d``'s -(F[i+1] - F[i]) / dx and of
    its co-indexed fluxes, from that direction's mass flux ``mflux``
    ([nb, NZ, NY, NX], index i the face i-1/2): ``(negdiv, fluxes)``, each
    ``[nb, nscalars, NZ, NY, NX]``.  The plain twin of the scalar kernel
    (what ``directional_flux`` and ``flux_divergence`` compute for those
    rows)."""
    axis = AXIS_OF_DIR[d]
    q = prim[:, scalar_base(cfg):]
    qm, qp = reconstruct(recon, q, axis, mesh.dx[d - 1],
                         positivity_mask=[False] * q.shape[1])
    wl = torch.roll(qp, 1, dims=axis)
    fd = mflux[:, None]
    F = torch.where(fd >= 0.0, fd * wl, fd * qm)
    return -((torch.roll(F, -1, dims=axis) - F) / mesh.dx[d - 1]), F


def face_shape(q, d):
    """Shape of direction ``d``'s face slab of a state ``q``."""
    nb, nvar, nz, ny, nx = q.shape
    return {1: (nb, nvar, nz, ny, 2), 2: (nb, nvar, nz, nx, 2),
            3: (nb, nvar, ny, nx, 2)}[d]


# ------------------------------------------------------------------- CUDA
@functools.cache
def build_units(scalars=False):
    """The translation units of a kernel source: ``-D`` flags of one unit
    per (reconstruction, dtype) and, first, the entry points', for the
    library of decks without scalars or (``scalars``) the one of decks
    with scalars (cached: every launch looks its library up by them)."""
    s = int(bool(scalars))
    return ((f"-DHYDRO_ENTRY_SCAL={s}",),) + tuple(
        (f"-DHYDRO_UNIT_RECON={r}", f"-DHYDRO_UNIT_DTYPE={t}",
         f"-DHYDRO_UNIT_SCAL={s}")
        for r in KERNEL_RECONS.values()
        for t in kernels.KERNEL_DTYPES.values())


def build_library(scalars=False):
    """Compile ``csrc/negdiv_sweep.cu`` (``kernels.build_library``): the
    library of decks without scalars or (``scalars``) of decks with
    scalars, whose fluid kernels also write the faces' mass fluxes and
    which holds the scalar kernel."""
    return kernels.build_library(CSRC, build_units(scalars), scalars=scalars)


ENTRIES = {
    "negdiv_sweep": ([ctypes.c_void_p, ctypes.c_void_p]
                     + [ctypes.c_int] * 9 + [ctypes.c_double] * 5
                     + [ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                        ctypes.c_void_p, ctypes.c_void_p], ctypes.c_int),
    "negdiv_sweep_occupancy": ([ctypes.c_int] * 5
                               + [ctypes.POINTER(ctypes.c_int)],
                               ctypes.c_int)}
SCALAR_ENTRIES = {
    "negdiv_scalars": ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 9
                       + [ctypes.c_double] * 3
                       + [ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                          ctypes.c_void_p, ctypes.c_void_p], ctypes.c_int),
    "negdiv_scalars_occupancy": ([ctypes.c_int] * 3
                                 + [ctypes.POINTER(ctypes.c_int)],
                                 ctypes.c_int)}


def _library(scalars=False):
    """The loaded library of decks without scalars or (``scalars``) of
    decks with scalars, built at first use."""
    scalars = bool(scalars)
    return kernels.load(CSRC, build_units(scalars),
                        {**ENTRIES, **SCALAR_ENTRIES} if scalars else ENTRIES,
                        scalars=scalars)


RECON_NAMES = sorted(KERNEL_RECONS, key=KERNEL_RECONS.get)
SOLVER_NAMES = [f"{f}-{r}" for f, r in sorted(KERNEL_SOLVERS,
                                              key=KERNEL_SOLVERS.get)]


def scalars_switch(k):
    """The template switch of a fluid kernel's instantiation for decks with
    scalars (its fourth; a build from before it has three)."""
    return k[3] if len(k) > 3 else 0


# how ``kernels.ptxas_summary`` names an instantiation of the sweep's
# kernels from its template switches (reconstruction, direction, solver,
# scalars), its threads per block, and its occupancy query
PTXAS = {
    "negdiv_sweep": (
        lambda k: (f"{RECON_NAMES[k[0]]} dir {k[1]} {SOLVER_NAMES[k[2]]}"
                   f"{' +scalars' if scalars_switch(k) else ''}"), 128,
        lambda dt, k: kernels.occupancy_of(
            _library(scalars_switch(k)).negdiv_sweep_occupancy, dt, k[2],
            k[0], k[1], scalars_switch(k))),
    "negdiv_scalars": (
        lambda k: f"{RECON_NAMES[k[0]]} dir {k[1]}", 256,
        lambda dt, k: kernels.occupancy_of(
            _library(True).negdiv_scalars_occupancy, dt, k[0], k[1]))}


def recon_constants(dx):
    """``(dx^2, (0.1 dx)^2)`` as WENO3 and LimO3 compute them in Python
    from a cell width (``recon/schemes.py``): the kernels take them as
    doubles and round them to the dtype as PyTorch rounds Python floats."""
    return schemes.weno3_dx2(dx), schemes.limo3_rdx2(dx)


def check_kernel_config(cfg, recon):
    """Raise ``ValueError`` for what the CUDA kernels do not take: a
    (fluid, solver) pair or reconstruction that no deck may ask for, or a
    negative scalar count.  Any ``nscalars >= 0`` runs."""
    if cfg.nscalars < 0:
        raise ValueError(f"nscalars must be >= 0, got {cfg.nscalars}")
    if (cfg.fluid, cfg.riemann) not in KERNEL_SOLVERS:
        raise ValueError(f"the CUDA kernels have no riemann={cfg.riemann} "
                         f"for fluid={cfg.fluid}")
    if recon not in KERNEL_RECONS:
        raise ValueError(f"the CUDA kernels have no '{recon}' "
                         "reconstruction")


def check_kernel_tensor(name, q, mesh, cfg):
    """Raise unless ``q`` is a contiguous f32/f64 CUDA state tensor
    ``[nb, nvar, NZ, NY, NX]`` of ``mesh``'s block shape."""
    kernels.check_tensor(name, q)
    if q.shape[1] != cfg.nvar \
            or tuple(q.shape[2:]) != tuple(mesh.block_shape):
        raise ValueError(f"{name}: the state must be [nb, {cfg.nvar}, "
                         f"{', '.join(map(str, mesh.block_shape))}], "
                         f"got {list(q.shape)}")


def negdiv_scalars_cuda(prim, out, slab, mflux, d, mesh, cfg, recon,
                        accumulate):
    """The scalar rows of direction ``d`` by the scalar kernel, after the
    fluid launch of that direction (same stream) wrote ``mflux``: writes
    (or, with ``accumulate``, adds to) ``out``'s scalar rows and writes
    ``slab``'s (may be None).  ``negdiv_scalars_cuda.launches`` counts the
    launches."""
    nb, nvar, nz, ny, nx = prim.shape
    dx = float(mesh.dx[d - 1])
    kernels.launch(
        _library(True).negdiv_scalars, prim.data_ptr(), out.data_ptr(),
        kernels.KERNEL_DTYPES[prim.dtype], KERNEL_RECONS[recon], d, nb, nvar,
        scalar_base(cfg), nz, ny, nx, dx,
        *recon_constants(dx), int(accumulate),
        slab.data_ptr() if slab is not None else None,
        (mesh.ng1, mesh.ng2, mesh.ng3)[d - 1], mflux.data_ptr(),
        torch.cuda.current_stream(prim.device).cuda_stream)
    negdiv_scalars_cuda.launches += 1


negdiv_scalars_cuda.launches = 0


def _sweep_launches(name, prim, c_h, mesh, cfg, eos, recon, faces):
    """One kernel launch per active direction on the current stream, the
    first writing -div(F) and the others adding to it; with ``faces`` each
    launch also writes its direction's slab.  With scalars each launch
    also writes the face mass fluxes and the scalar kernel follows it.
    Returns ``(-div(F), {d: slab} or None, fluid launches)``."""
    check_kernel_config(cfg, recon)
    check_kernel_tensor(name, prim, mesh, cfg)
    fn = _library(cfg.nscalars > 0).negdiv_sweep
    nb, nvar, nz, ny, nx = prim.shape
    out = torch.empty_like(prim)
    dirs = active_dirs(mesh)
    slabs = None
    if faces:
        check_faces_layout(mesh)
        slabs = {d: torch.empty(face_shape(prim, d), dtype=prim.dtype,
                                device=prim.device) for d in dirs}
    # one mass-flux array serves every direction: each scalar launch has
    # read it before the next fluid launch (same stream) writes it
    mflux = (torch.empty((nb, nz, ny, nx), dtype=prim.dtype,
                         device=prim.device) if cfg.nscalars else None)
    with torch.cuda.device(prim.device):
        stream = torch.cuda.current_stream(prim.device).cuda_stream
        for k, d in enumerate(dirs):
            dx = float(mesh.dx[d - 1])
            kernels.launch(
                fn, prim.data_ptr(), out.data_ptr(),
                kernels.KERNEL_DTYPES[prim.dtype],
                KERNEL_SOLVERS[cfg.fluid, cfg.riemann],
                KERNEL_RECONS[recon], d, nb, nvar, nz, ny, nx,
                dx, float(eos.gamma), float(c_h), *recon_constants(dx),
                int(k > 0), slabs[d].data_ptr() if faces else None,
                (mesh.ng1, mesh.ng2, mesh.ng3)[d - 1],
                mflux.data_ptr() if mflux is not None else None, stream)
            if mflux is not None:
                negdiv_scalars_cuda(prim, out, slabs[d] if faces else None,
                                    mflux, d, mesh, cfg, recon, k > 0)
    return out, slabs, len(dirs)


def negdiv_cuda(prim, c_h, mesh, cfg, eos, recon):
    """-div(F) over the active directions by the Hopper kernel: one launch
    per direction on the current stream, the first writing the output and
    the others adding to it.  Raises on anything the kernel does not take;
    ``negdiv_cuda.launches`` counts the launches."""
    out, _, n = _sweep_launches("negdiv_cuda", prim, c_h, mesh, cfg, eos,
                                recon, faces=False)
    negdiv_cuda.launches += n
    return out


negdiv_cuda.launches = 0


def negdiv_faces_cuda(prim, c_h, mesh, cfg, eos, recon):
    """``(-div(F), {d: faces})`` by the Hopper kernel with its face output:
    one launch per active direction, as ``negdiv_cuda``.  Raises on
    anything the kernel does not take; ``negdiv_faces_cuda.launches``
    counts the launches."""
    out, faces, n = _sweep_launches("negdiv_faces_cuda", prim, c_h, mesh,
                                    cfg, eos, recon, faces=True)
    negdiv_faces_cuda.launches += n
    return out, faces


negdiv_faces_cuda.launches = 0


def fused_negdiv(prim, c_h, mesh, cfg, eos, recon):
    """-div(F): the plain version for a CPU tensor, the CUDA kernel for
    any other (which launches or raises)."""
    if prim.device.type == "cpu":
        return negdiv_plain(prim, c_h, mesh, cfg, eos, recon)
    return negdiv_cuda(prim, c_h, mesh, cfg, eos, recon)


def fused_negdiv_faces(prim, c_h, mesh, cfg, eos, recon):
    """``(-div(F), {d: faces})``: the plain version for a CPU tensor, the
    CUDA kernel for any other (which launches or raises)."""
    fn = negdiv_faces_plain if prim.device.type == "cpu" \
        else negdiv_faces_cuda
    return fn(prim, c_h, mesh, cfg, eos, recon)

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
  ``nvcc`` into ``build/`` at first use (one translation unit per
  reconstruction and dtype, compiled in parallel) and loaded with
  ``ctypes``.
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

``build_library``, ``ptxas_summary`` and ``check_kernel_config`` also
serve the whole-stage kernel (``solver/stage.py``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

import torch

from ..core.indices import (AXIS_X, AXIS_Y, AXIS_Z, EULER, GLMMHD,
                            NGLMMHD, NHYDRO)
from ..recon import positivity_mask, reconstruct, schemes
from ..riemann import solve_riemann

AXIS_OF_DIR = {1: AXIS_X, 2: AXIS_Y, 3: AXIS_Z}

CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
CSRC = CSRC_DIR / "negdiv_sweep.cu"
# device functions that every kernel source includes
HEADERS = (CSRC_DIR / "hydro_device.cuh",)
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"

# codes of the kernels' template switches (csrc/hydro_device.cuh)
KERNEL_RECONS = {"dc": 0, "plm": 1, "ppm": 2, "weno3": 3, "limo3": 4,
                 "wenoz": 5}
KERNEL_SOLVERS = {(EULER, "hlle"): 0, (EULER, "hllc"): 1, (GLMMHD, "hlld"): 2,
                  (EULER, "llf"): 3, (GLMMHD, "llf"): 4, (GLMMHD, "hlle"): 5}
KERNEL_DTYPES = {torch.float32: 0, torch.float64: 1}


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
def _nvcc():
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        nvcc = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels are built "
                           "from csrc/*.cu on first use")
    return nvcc


def build_units(scalars=False):
    """The translation units of a kernel source: ``-D`` flags of one unit
    per (reconstruction, dtype) and, first, the entry points', for the
    library of decks without scalars or (``scalars``) the one of decks
    with scalars."""
    s = int(bool(scalars))
    return [(f"-DHYDRO_ENTRY_SCAL={s}",)] + [
        (f"-DHYDRO_UNIT_RECON={r}", f"-DHYDRO_UNIT_DTYPE={t}",
         f"-DHYDRO_UNIT_SCAL={s}")
        for r in KERNEL_RECONS.values() for t in KERNEL_DTYPES.values()]


def build_library(source=None, scalars=False, units=None):
    """Compile one kernel source of ``csrc/`` (default: the sweep's) for
    sm_90a into ``build/``, keyed by the hash of the source and of the
    header it includes, so editing either rebuilds.  Each source makes two
    libraries: the kernels without scalars, and (``scalars``,
    ``lib<name>_scalars_<hash>.so``) the fluid kernels' instantiations for
    decks with scalars with the scalar kernels, built and loaded only when
    a deck has scalars.  Each unit of ``build_units`` (or of ``units``, a
    list of ``-D`` flag tuples, for a source that makes one library; the
    list then keys the library too) is one ``nvcc`` process, all started
    together; the objects link into one library.  Returns ``(path,
    compiler_log)``; the log holds ptxas' register and shared memory
    report."""
    source = Path(source) if source is not None else CSRC
    digest = hashlib.sha256()
    for path in (source,) + HEADERS:
        digest.update(path.read_bytes())
    if units is not None:
        digest.update(repr([list(unit) for unit in units]).encode())
    kind = "_scalars" if scalars else ""
    lib = BUILD_DIR / f"lib{source.stem}{kind}_{digest.hexdigest()[:12]}.so"
    if lib.exists():
        return lib, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    work = lib.with_name(f"{lib.stem}.{os.getpid()}.units")
    work.mkdir(exist_ok=True)
    flags = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
             "-std=c++17", "-O3", "--fmad=false"]
    procs = []
    units = build_units(scalars) if units is None else units
    for k, defines in enumerate(units):
        obj = work / f"unit{k}.o"
        cmd = flags + ["-Xptxas", "-v", "-Xcompiler", "-fPIC", "-c",
                       *defines, "-o", str(obj), str(source)]
        procs.append((obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    log, failed = [], []
    for obj, proc in procs:
        out, _ = proc.communicate()
        log.append(out)
        if proc.returncode != 0:
            failed.append(f"{obj.name} ({proc.returncode}):\n{out}")
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    res = subprocess.run(flags + ["-shared", "-o", str(tmp)]
                         + [str(obj) for obj, _ in procs],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({res.returncode}):\n"
                           f"{res.stdout}{res.stderr}")
    os.replace(tmp, lib)
    shutil.rmtree(work, ignore_errors=True)
    return lib, "".join(log)


_libs = {}


def _library(scalars=False):
    """The loaded library of decks without scalars or (``scalars``) of
    decks with scalars, built at first use."""
    scalars = bool(scalars)
    if scalars not in _libs:
        path, _ = build_library(scalars=scalars)
        lib = ctypes.CDLL(str(path))
        fn = lib.negdiv_sweep
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p] \
            + [ctypes.c_int] * 9 + [ctypes.c_double] * 5 \
            + [ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
               ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.negdiv_sweep_occupancy.argtypes = [ctypes.c_int] * 5 \
            + [ctypes.POINTER(ctypes.c_int)]
        lib.negdiv_sweep_occupancy.restype = ctypes.c_int
        if scalars:
            lib.negdiv_scalars.argtypes = [ctypes.c_void_p] * 2 \
                + [ctypes.c_int] * 9 + [ctypes.c_double] * 3 \
                + [ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p]
            lib.negdiv_scalars.restype = ctypes.c_int
            lib.negdiv_scalars_occupancy.argtypes = [ctypes.c_int] * 3 \
                + [ctypes.POINTER(ctypes.c_int)]
            lib.negdiv_scalars_occupancy.restype = ctypes.c_int
        _libs[scalars] = lib
    return _libs[scalars]


def kernel_occupancy(dtype, solver, recon, d, scal=0):
    """``(dynamic shared memory in bytes, resident blocks per SM)`` of the
    instantiation ``negdiv_cuda`` launches for the kernel codes ``dtype``,
    ``solver``, ``recon`` (``KERNEL_DTYPES`` ... values), direction ``d``
    and a deck without (``scal = 0``) or with scalars, on the current card;
    a block is 128 threads."""
    out = (ctypes.c_int * 2)()
    rc = _library(scal).negdiv_sweep_occupancy(dtype, solver, recon, d,
                                               scal, out)
    if rc != 0:
        raise RuntimeError(f"negdiv_sweep_occupancy failed with cudaError {rc}")
    return out[0], out[1]


def scalar_occupancy(kernel, dtype, recon, d=None):
    """``(dynamic shared memory, resident blocks per SM)`` of a scalar
    kernel's instantiation (``"negdiv_scalars"`` of direction ``d``, or
    ``"stage_scalars"``) on the current card; a block is 256 threads
    (negdiv_scalars) or 128 (stage_scalars)."""
    out = (ctypes.c_int * 2)()
    if kernel == "negdiv_scalars":
        rc = _library(True).negdiv_scalars_occupancy(dtype, recon, d, out)
    else:
        from . import stage
        rc = stage._library(True).stage_scalars_occupancy(dtype, recon,
                                                          out)
    if rc != 0:
        raise RuntimeError(f"{kernel}_occupancy failed with cudaError {rc}")
    return out[0], out[1]


def ptxas_summary(compiler_log, occupancy=False):
    """One line per kernel instantiation in a ``build_library`` log (of
    this or any checkout's kernels): kernel, dtype and template switches,
    registers and spills, from ``nvcc -Xptxas -v``.  With ``occupancy``,
    also the dynamic shared memory and resident blocks per SM that this
    checkout's kernels ask the current card for (``kernel_occupancy``); a
    block is 128 threads, 4 warps."""
    from . import stage
    query = {"negdiv_sweep": lambda dt, k: kernel_occupancy(
                 dt, k[2], k[0], k[1], k[3] if len(k) > 3 else 0),
             "fused_stage": lambda dt, k: stage.kernel_occupancy(
                 dt, k[1], k[0], k[2], k[3] if len(k) > 3 else 0),
             "negdiv_scalars": lambda dt, k: scalar_occupancy(
                 "negdiv_scalars", dt, k[0], k[1]),
             "stage_scalars": lambda dt, k: scalar_occupancy(
                 "stage_scalars", dt, k[0])}
    threads = {"negdiv_sweep": 128, "fused_stage": 128,
               "negdiv_scalars": 256, "stage_scalars": 128}
    names = {"f": "f32", "d": "f64"}
    recons = sorted(KERNEL_RECONS, key=KERNEL_RECONS.get)
    solvers = [f"{f}-{r}" for f, r in sorted(KERNEL_SOLVERS,
                                             key=KERNEL_SOLVERS.get)]
    lines, current = [], None
    for line in compiler_log.splitlines():
        m = re.search(r"Compiling entry function .*(negdiv_sweep|fused_stage|"
                      r"negdiv_scalars|stage_scalars)"
                      r"_kernelI([fd])((?:L[ib]\d+E)+)E", line)
        if m:
            k = [int(x) for x in re.findall(r"L[ib](\d+)E", m.group(3))]
            kernel, dtype = m.group(1), "fd".index(m.group(2))
            # the instantiation for decks with scalars (a fourth switch;
            # a build from before it has three) is marked "+scalars"
            scal = " +scalars" if kernel in ("negdiv_sweep", "fused_stage") \
                and len(k) > 3 and k[3] else ""
            what = {"negdiv_sweep": lambda: f"dir {k[1]} {solvers[k[2]]}",
                    "fused_stage": lambda: solvers[k[1]] + (
                        " faces" if k[2] else ""),
                    "negdiv_scalars": lambda: f"dir {k[1]}",
                    "stage_scalars": lambda: "all directions"}[kernel]()
            current = (f"{kernel} {names[m.group(2)]} {recons[k[0]]} "
                       f"{what}{scal}")
            spill = ""
        elif current and "spill stores" in line:
            spill = line.strip()
        elif current and "registers" in line:
            regs = re.search(r"Used (\d+) registers", line).group(1)
            text = f"{current}: {regs} registers, {spill}"
            if occupancy:
                smem, blocks = query[kernel](dtype, k)
                warps = threads[kernel] // 32 * blocks
                text += (f"; {smem} bytes of dynamic shared memory, "
                         f"{blocks} blocks = {warps} warps per SM")
            lines.append(text)
            current = None
    return lines


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
    if not q.is_cuda:
        raise ValueError(f"{name} needs a CUDA tensor")
    if q.dtype not in KERNEL_DTYPES:
        raise TypeError(f"{name} takes float32 or float64, got {q.dtype}")
    if q.dim() != 5 or q.shape[1] != cfg.nvar \
            or tuple(q.shape[2:]) != tuple(mesh.block_shape):
        raise ValueError(f"{name}: the state must be [nb, {cfg.nvar}, "
                         f"{', '.join(map(str, mesh.block_shape))}], "
                         f"got {list(q.shape)}")
    if not q.is_contiguous():
        raise ValueError(f"{name} needs a contiguous tensor")
    if q.shape[0] == 0:
        # a refined level with no leaves (a zero-sized grid is a launch
        # error, not a no-op)
        raise ValueError(f"{name}: a level with no blocks never reaches a "
                         "launch")


def negdiv_scalars_cuda(prim, out, slab, mflux, d, mesh, cfg, recon,
                        accumulate):
    """The scalar rows of direction ``d`` by the scalar kernel, after the
    fluid launch of that direction (same stream) wrote ``mflux``: writes
    (or, with ``accumulate``, adds to) ``out``'s scalar rows and writes
    ``slab``'s (may be None).  ``negdiv_scalars_cuda.launches`` counts the
    launches."""
    nb, nvar, nz, ny, nx = prim.shape
    dx = float(mesh.dx[d - 1])
    rc = _library(True).negdiv_scalars(
        prim.data_ptr(), out.data_ptr(), KERNEL_DTYPES[prim.dtype],
        KERNEL_RECONS[recon], d, nb, nvar, scalar_base(cfg), nz, ny, nx, dx,
        *recon_constants(dx), int(accumulate),
        slab.data_ptr() if slab is not None else None,
        (mesh.ng1, mesh.ng2, mesh.ng3)[d - 1], mflux.data_ptr(),
        torch.cuda.current_stream(prim.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"negdiv_scalars launch (direction {d}) failed "
                           f"with cudaError {rc}")
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
            rc = fn(prim.data_ptr(), out.data_ptr(),
                    KERNEL_DTYPES[prim.dtype],
                    KERNEL_SOLVERS[cfg.fluid, cfg.riemann],
                    KERNEL_RECONS[recon], d, nb, nvar, nz, ny, nx,
                    dx, float(eos.gamma), float(c_h), *recon_constants(dx),
                    int(k > 0),
                    slabs[d].data_ptr() if faces else None,
                    (mesh.ng1, mesh.ng2, mesh.ng3)[d - 1],
                    mflux.data_ptr() if mflux is not None else None, stream)
            if rc != 0:
                raise RuntimeError(f"negdiv_sweep launch (direction {d}) "
                                   f"failed with cudaError {rc}")
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

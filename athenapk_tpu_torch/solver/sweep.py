"""The fused -div(F) sweep: reconstruction + Riemann solve + flux divergence.

Counterpart of ``athenapk_tpu/solver/pallas_sweep.py``
(``make_lane_sweep_negdiv`` composed by ``make_fused_negdiv``): the
function ``(prim, c_h) -> sum_d -(F_d[i+1] - F_d[i]) / dx_d`` over the
active directions, for a ``[nb, nvar, NZ, NY, NX]`` primitive tensor.
Every shift wraps within a block (``torch.roll``), which is the periodic
boundary on the ghost-free layout and lands in the ghost rim otherwise.

* ``negdiv_plain`` — the plain PyTorch version (whole-tensor sweeps),
  ``-flux_divergence(compute_fluxes(...))``.
* ``negdiv_cuda`` — the hand-written Hopper kernel
  (``csrc/negdiv_sweep.cu``, GLM-MHD + HLLD with DC, PLM or PPM), one
  launch per direction accumulating into the output.  It is built with
  ``nvcc`` into ``build/`` at first use and loaded with ``ctypes``.
* ``fused_negdiv`` — takes the plain version for a CPU tensor and the
  kernel for a CUDA tensor; it never falls back from one to the other.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

from ..core.indices import AXIS_X, AXIS_Y, AXIS_Z, GLMMHD, NGLMMHD
from ..recon import reconstruct
from ..riemann import solve_riemann

AXIS_OF_DIR = {1: AXIS_X, 2: AXIS_Y, 3: AXIS_Z}

CSRC = Path(__file__).resolve().parents[1] / "csrc" / "negdiv_sweep.cu"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"

# reconstruction codes of the kernel's template switch
KERNEL_RECONS = {"dc": 0, "plm": 1, "ppm": 2}
_KERNEL_DTYPES = {torch.float32: 0, torch.float64: 1}


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
    i-1/2): ``wl = qp[i-1]``, ``wr = qm[i]``."""
    axis = AXIS_OF_DIR[d]
    qm, qp = reconstruct(recon, prim, axis, dx)
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


# ------------------------------------------------------------------- CUDA
def _nvcc():
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        nvcc = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the negdiv sweep kernel is "
                           "built from csrc/negdiv_sweep.cu on first use")
    return nvcc


def build_library():
    """Compile ``csrc/negdiv_sweep.cu`` for sm_90a into ``build/`` (keyed
    by the source's hash, so an edited source rebuilds).  Returns
    ``(path, compiler_log)``; the log holds ptxas' register and shared
    memory report."""
    tag = hashlib.sha256(CSRC.read_bytes()).hexdigest()[:12]
    lib = BUILD_DIR / f"libnegdiv_sweep_{tag}.so"
    if lib.exists():
        return lib, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
           "-std=c++17", "-O3", "--fmad=false", "-Xptxas", "-v",
           "-shared", "-Xcompiler", "-fPIC", "-o", str(tmp), str(CSRC)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n"
                           f"{res.stdout}{res.stderr}")
    os.replace(tmp, lib)
    return lib, res.stdout + res.stderr


_lib = None


def _library():
    global _lib
    if _lib is None:
        path, _ = build_library()
        lib = ctypes.CDLL(str(path))
        fn = lib.negdiv_sweep
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_double, ctypes.c_double,
                       ctypes.c_double, ctypes.c_double, ctypes.c_int,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def check_kernel_config(cfg, recon):
    """Raise NotImplementedError for what the CUDA kernel does not take."""
    if cfg.fluid != GLMMHD or cfg.riemann != "hlld" or cfg.nscalars != 0:
        raise NotImplementedError(
            "the CUDA negdiv sweep covers fluid=glmmhd, riemann=hlld, "
            f"nscalars=0 only (got fluid={cfg.fluid}, riemann={cfg.riemann}"
            f", nscalars={cfg.nscalars})")
    if recon not in KERNEL_RECONS:
        raise NotImplementedError(
            f"the CUDA negdiv sweep has no '{recon}' reconstruction "
            f"(it has {', '.join(KERNEL_RECONS)})")


def negdiv_cuda(prim, c_h, mesh, cfg, eos, recon):
    """-div(F) over the active directions by the Hopper kernel: one launch
    per direction on the current stream, the first writing the output and
    the others adding to it.  Raises on anything the kernel does not take;
    ``negdiv_cuda.launches`` counts the launches."""
    check_kernel_config(cfg, recon)
    if not prim.is_cuda:
        raise ValueError("negdiv_cuda needs a CUDA tensor")
    if prim.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"negdiv_cuda takes float32 or float64, "
                        f"got {prim.dtype}")
    if prim.dim() != 5 or prim.shape[1] != NGLMMHD \
            or tuple(prim.shape[2:]) != tuple(mesh.block_shape):
        raise ValueError(f"prim must be [nb, {NGLMMHD}, "
                         f"{', '.join(map(str, mesh.block_shape))}], "
                         f"got {list(prim.shape)}")
    if not prim.is_contiguous():
        raise ValueError("negdiv_cuda needs a contiguous tensor")
    fn = _library().negdiv_sweep
    nb, nvar, nz, ny, nx = prim.shape
    out = torch.empty_like(prim)
    with torch.cuda.device(prim.device):
        stream = torch.cuda.current_stream(prim.device).cuda_stream
        for k, d in enumerate(active_dirs(mesh)):
            rc = fn(prim.data_ptr(), out.data_ptr(),
                    _KERNEL_DTYPES[prim.dtype], KERNEL_RECONS[recon], d,
                    nb, nvar, nz, ny, nx, float(mesh.dx[d - 1]),
                    float(eos.gamma), 1.0 / eos.gm1, float(c_h), int(k > 0),
                    stream)
            if rc != 0:
                raise RuntimeError(f"negdiv_sweep launch (direction {d}) "
                                   f"failed with cudaError {rc}")
            negdiv_cuda.launches += 1
    return out


negdiv_cuda.launches = 0


def fused_negdiv(prim, c_h, mesh, cfg, eos, recon):
    """-div(F): the plain version for a CPU tensor, the CUDA kernel for
    any other (which launches or raises)."""
    if prim.device.type == "cpu":
        return negdiv_plain(prim, c_h, mesh, cfg, eos, recon)
    return negdiv_cuda(prim, c_h, mesh, cfg, eos, recon)

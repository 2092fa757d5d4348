"""The EOS with floors as one hand-written CUDA kernel.

``eos.adiabatic.cons_to_prim`` is, on the card, 21 elementwise launches
and two stacks of the state's rows a call.  ``csrc/cons_to_prim.cu`` does
the same conversion in one launch that reads each cell once and writes
prim, and the floored cons only when a floor or a ceiling is on: with none
on, the floored cons is the input bit for bit, and the input itself is
returned, not a copy.

* ``cons_to_prim_cuda`` — the kernel on the current stream; raises on
  anything it does not take.  ``cons_to_prim_cuda.launches`` counts the
  launches.
* ``fused_cons_to_prim`` — the plain ``eos.adiabatic.cons_to_prim`` for a
  CPU tensor, the kernel for any other; it never falls back from one to
  the other.

The kernel is built with ``nvcc`` into ``build/`` at first use
(``core.kernels``).
"""

from __future__ import annotations

import ctypes
import math

import torch

from ..core import kernels
from ..core.indices import GLMMHD, NGLMMHD, NHYDRO
from . import adiabatic

CSRC = kernels.CSRC_DIR / "cons_to_prim.cu"
UNITS = [()]
ENTRIES = {"eos_cons_to_prim": (
    [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_longlong]
    + [ctypes.c_double] * 6 + [ctypes.c_void_p], ctypes.c_int)}
# a ceiling at or above this is off in the kernel (hydro_device.cuh)
NO_CEILING = 1.0e300


def build_library():
    """Compile ``csrc/cons_to_prim.cu``: one translation unit."""
    return kernels.build_library(CSRC, UNITS)


def _library():
    """The loaded library, built at first use."""
    return kernels.load(CSRC, UNITS, ENTRIES)


def limits_on(eos):
    """Does the EOS enable a floor or a ceiling (so the floored cons may
    differ from the input)?"""
    return (eos.density_floor > 0.0 or eos.pressure_floor > 0.0
            or eos.internal_e_floor > 0.0
            or math.isfinite(eos.velocity_ceiling)
            or math.isfinite(eos.internal_e_ceiling))


def cons_to_prim_cuda(eos, cons, fluid, nscalars=0):
    """``(cons', prim)`` of a contiguous f32/f64 CUDA state ``[nb, nvar,
    NZ, NY, NX]`` by the kernel, one launch on the current stream, with
    ``eos.adiabatic.cons_to_prim``'s numbers.  ``cons'`` is ``cons`` itself
    when no floor or ceiling is on, else a new tensor.  Raises on anything
    the kernel does not take; ``cons_to_prim_cuda.launches`` counts the
    launches."""
    nbase = NGLMMHD if fluid == GLMMHD else NHYDRO
    kernels.check_tensor("cons_to_prim_cuda", cons)
    if nscalars < 0 or cons.shape[1] != nbase + nscalars:
        raise ValueError(f"cons_to_prim_cuda: the state must be [nb, "
                         f"{nbase + nscalars}, nz, ny, nx], got "
                         f"{list(cons.shape)}")
    ceilings = (eos.velocity_ceiling, eos.internal_e_ceiling)
    if any(math.isfinite(c) and c >= NO_CEILING for c in ceilings):
        raise ValueError(f"cons_to_prim_cuda: a finite ceiling >= "
                         f"{NO_CEILING} reads as off in the kernel")
    nb, nvar, nz, ny, nx = cons.shape
    prim = torch.empty_like(cons)
    cons_out = torch.empty_like(cons) if limits_on(eos) else cons
    with torch.cuda.device(cons.device):
        kernels.launch(
            _library().eos_cons_to_prim, cons.data_ptr(),
            cons_out.data_ptr() if cons_out is not cons else None,
            prim.data_ptr(), kernels.KERNEL_DTYPES[cons.dtype], nbase, nb,
            nvar, nz * ny * nx, float(eos.gamma), float(eos.density_floor),
            float(eos.pressure_floor), float(eos.internal_e_floor),
            float(eos.velocity_ceiling), float(eos.internal_e_ceiling),
            torch.cuda.current_stream(cons.device).cuda_stream)
    cons_to_prim_cuda.launches += 1
    return cons_out, prim


cons_to_prim_cuda.launches = 0


def fused_cons_to_prim(eos, cons, fluid, nscalars=0):
    """``(cons', prim)``: the plain version for a CPU tensor, the CUDA
    kernel for any other (which launches or raises)."""
    if cons.device.type == "cpu":
        return adiabatic.cons_to_prim(eos, cons, fluid, nscalars)
    return cons_to_prim_cuda(eos, cons, fluid, nscalars)

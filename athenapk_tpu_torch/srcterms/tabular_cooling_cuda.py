"""The Townsend cooling and its dt limit as hand-written CUDA kernels.

On the card ``TabularCooling``'s plain Townsend update is ~60 elementwise
launches and two ``[cells, n_temp - 1]`` bool tables summed in int64 a
stage, and its dt ~25 launches and a reduction.  ``csrc/tabular_cooling.cu``
does the update in one launch that reads each cell once and writes its
energy in place, and the dt in one launch over the interior view (no copy)
and one over the blocks' partial minima, with the plain code's numbers bit
for bit.

* ``townsend_cuda`` — the update on a CUDA state, in place;
  ``townsend_cuda.launches`` counts its launches.
* ``cooling_dt_cuda`` — the cooling dt of a CUDA prim;
  ``cooling_dt_cuda.launches`` counts its calls.
* ``fused_townsend`` / ``fused_cooling_dt`` — the plain code
  (``TabularCooling.cool_plain`` / ``cooling_dt_plain``) for a CPU tensor,
  the kernel for any other; they never fall back from one to the other.

Both raise on anything the kernels do not take.  The library is built with
``nvcc`` into ``build/`` at first use (``core.kernels``).
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from ..core import kernels
from ..core.indices import GLMMHD, IPR, NGLMMHD, NHYDRO

CSRC = kernels.CSRC_DIR / "tabular_cooling.cu"
UNITS = [()]
# the tables sit in each block's shared memory: 4 n - 2 values for the
# update, under the 48 KB a launch takes without opting in
MAX_ROWS = 1024
# partial minima of the dt's first launch (its blocks)
DT_PARTS = 1024
TABLES = ("temps", "lambdas", "alpha_k", "Y_k", "log_lambdas")


class CoolArgs(ctypes.Structure):
    """``csrc/tabular_cooling.cu:CoolArgs``: the cooling's Python floats."""
    _fields_ = [(name, ctypes.c_double) for name in (
        "mgk", "tcf", "e_tcf", "e_floor", "lam_fin", "t_fin", "xh", "coef",
        "lts", "dlt", "ltf", "half_ltf", "gm1", "e_floor_dt", "cfl")]


ENTRIES = {
    "cooling_townsend": ([ctypes.c_void_p] + [ctypes.c_int] * 4
                         + [ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int,
                            ctypes.POINTER(CoolArgs), ctypes.c_void_p],
                         ctypes.c_int),
    "cooling_dt": ([ctypes.c_void_p, ctypes.c_int,
                    ctypes.POINTER(ctypes.c_int),
                    ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p,
                    ctypes.c_int, ctypes.POINTER(CoolArgs), ctypes.c_void_p,
                    ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p],
                   ctypes.c_int)}


def build_library():
    """Compile ``csrc/tabular_cooling.cu``: one translation unit, with FMA
    contraction on (the source's own arithmetic is rounded intrinsics: only
    libdevice's ``pow`` contracts, as in PyTorch's build of
    ``torch.pow``)."""
    return kernels.build_library(CSRC, UNITS, fmad=True)


def _library():
    """The loaded library, built at first use."""
    return kernels.load(CSRC, UNITS, ENTRIES, fmad=True)


def _args(cooling, coef=0.0):
    """The cooling's constants as the plain code computes them."""
    mgk = cooling.mbar_gm1_over_kb
    tcf = 10.0 ** cooling.log_temp_start
    return CoolArgs(
        mgk=mgk, tcf=tcf, e_tcf=tcf / mgk,
        e_floor=cooling.t_floor / mgk if cooling.t_floor > 0 else -math.inf,
        lam_fin=cooling.lambda_final, t_fin=cooling.temp_final,
        xh=cooling.x_h_over_mh2, coef=coef, lts=cooling.log_temp_start,
        dlt=cooling.d_log_temp, ltf=cooling.log_temp_final,
        half_ltf=0.5 * cooling.log_temp_final, gm1=cooling.gamma - 1.0,
        e_floor_dt=max(cooling.t_floor, tcf) / mgk,
        cfl=cooling.cooling_time_cfl)


def _check(name, x, rows, contiguous=True):
    """Raise unless ``x`` is a float32/float64 CUDA tensor ``[nb, nvar, nz,
    ny, nx]`` (``kernels.check_tensor``) with at least ``rows`` rows."""
    kernels.check_tensor(name, x, contiguous)
    if x.shape[1] < rows:
        raise ValueError(f"{name}: the state must be [nb, nvar >= {rows}, "
                         f"nz, ny, nx], got {list(x.shape)}")


def _table_pointers(cooling, like):
    """The device pointers of the cooling's tables (``cooling._tables``) on
    ``like``'s device and in its dtype, as a ``void*[5]``, kept in
    ``cooling.kernel_tables`` by (device, dtype); raises where the table is
    longer than ``MAX_ROWS`` or where, in the dtype, temps does not rise or
    Y_k does not fall (the kernel's searches count over monotone tables)."""
    key = (like.device, like.dtype)
    if key in cooling.kernel_tables:
        return cooling.kernel_tables[key]
    if cooling.n_temp > MAX_ROWS:
        raise ValueError(f"the cooling kernels take at most {MAX_ROWS} "
                         f"table rows, got {cooling.n_temp}")
    np_dtype = np.float32 if like.dtype == torch.float32 else np.float64
    temps = cooling._np["temps"].astype(np_dtype)
    y_k = cooling._np["Y_k"].astype(np_dtype)
    if not (np.all(np.diff(temps) >= 0) and np.all(np.diff(y_k) <= 0)):
        raise ValueError(f"the cooling table is not monotone in {like.dtype}")
    tab = cooling._tables(like)
    cooling.kernel_tables[key] = (ctypes.c_void_p * len(TABLES))(
        *[tab[k].data_ptr() for k in TABLES])
    return cooling.kernel_tables[key]


def townsend_cuda(cooling, cons, dt, fluid):
    """The Townsend cooling over ``dt`` (a float) applied to the
    contiguous f32/f64 CUDA state ``cons`` ``[nb, nvar, NZ, NY, NX]``
    in place by the kernel, one launch on the current stream, with
    ``TabularCooling.cool_plain``'s numbers; only the energy row changes.
    Returns ``cons``.  Raises on anything the kernel does not take;
    ``townsend_cuda.launches`` counts the launches."""
    mhd = fluid == GLMMHD
    _check("townsend_cuda", cons, NGLMMHD if mhd else NHYDRO)
    if cooling.integrator != "townsend":
        raise ValueError(f"townsend_cuda: the cooling's integrator is "
                         f"{cooling.integrator}")
    if torch.is_tensor(dt):
        raise TypeError("townsend_cuda takes dt as a float")
    tables = _table_pointers(cooling, cons)
    nb, nvar, nz, ny, nx = cons.shape
    # tef_adj's coefficient as the plain code computes it
    args = _args(cooling, cooling.lambda_final * dt / cooling.temp_final
                 * cooling.mbar_gm1_over_kb)
    with torch.cuda.device(cons.device):
        kernels.launch(
            _library().cooling_townsend, cons.data_ptr(),
            kernels.KERNEL_DTYPES[cons.dtype], int(mhd), nb, nvar,
            nz * ny * nx, tables, cooling.n_temp, ctypes.byref(args),
            torch.cuda.current_stream(cons.device).cuda_stream)
    townsend_cuda.launches += 1
    return cons


townsend_cuda.launches = 0


def cooling_dt_cuda(cooling, prim, mesh):
    """``cooling_time_cfl * min |e / (de/dt)|`` over the interior cells of
    the f32/f64 CUDA prim ``[nb, nvar, NZ, NY, NX]`` (``mesh`` gives the
    interior) as a 0-d tensor in prim's dtype, by the kernel through the
    interior view's strides, on the current stream, with
    ``TabularCooling.cooling_dt_plain``'s number.  Raises on anything the
    kernel does not take; ``cooling_dt_cuda.launches`` counts the calls."""
    # the kernel reads the interior view through its strides
    _check("cooling_dt_cuda", prim, IPR + 1, contiguous=False)
    w = prim[mesh.interior_slices]
    if w.numel() == 0:
        raise ValueError("cooling_dt_cuda: the interior holds no cell")
    if w.numel() // w.shape[1] > 2 ** 31 - 1:
        raise ValueError("cooling_dt_cuda takes at most 2^31 - 1 cells")
    tables = _table_pointers(cooling, prim)
    size = (ctypes.c_int * 5)(*w.shape)
    stride = (ctypes.c_longlong * 5)(*w.stride())
    ncells = w.numel() // w.shape[1]
    parts = torch.empty(min(DT_PARTS, -(-ncells // 256)), dtype=prim.dtype,
                        device=prim.device)
    out = torch.empty((), dtype=prim.dtype, device=prim.device)
    args = _args(cooling)
    with torch.cuda.device(prim.device):
        kernels.launch(
            _library().cooling_dt, w.data_ptr(),
            kernels.KERNEL_DTYPES[prim.dtype], size, stride, tables,
            cooling.n_temp, ctypes.byref(args), parts.data_ptr(),
            parts.numel(), out.data_ptr(),
            torch.cuda.current_stream(prim.device).cuda_stream)
    cooling_dt_cuda.launches += 1
    return out


cooling_dt_cuda.launches = 0


def fused_townsend(cooling, cons, dt, fluid):
    """The Townsend cooling applied to ``cons`` in place, returned: the
    plain code for a CPU tensor, the CUDA kernel for any other (which
    launches or raises)."""
    if cons.device.type == "cpu":
        return cooling.cool_plain(cons, dt, fluid)
    return townsend_cuda(cooling, cons, dt, fluid)


def fused_cooling_dt(cooling, prim, mesh):
    """The cooling dt as a 0-d tensor: the plain code for a CPU tensor, the
    CUDA kernel for any other (which launches or raises)."""
    if prim.device.type == "cpu":
        return cooling.cooling_dt_plain(prim, mesh)
    return cooling_dt_cuda(cooling, prim, mesh)

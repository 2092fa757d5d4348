"""ctypes binding of the native AMR forest manager (``native/amr_forest.cc``).

Counterpart of ``athenapk_tpu/core/amr_forest.py``: the host-side block
table (the reference keeps it in Parthenon's C++ forest-of-trees mesh):
leaf bookkeeping and 2:1-balanced refinement.  The C++ source is shared
with the JAX package; this binding builds its own copy of the library with
``g++`` into the port's ``build/`` directory, keyed by a hash of the source
(as ``core.kernels.build_library`` builds the kernels), and never writes
under ``native/``, whose library belongs to the JAX package's binding.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

from .kernels import BUILD_DIR

SOURCE = Path(__file__).resolve().parents[2] / "native" / "amr_forest.cc"

COPY, PROLONG, RESTRICT = 0, 1, 2

_lib = None


def build_library(build_dir=None):
    """Compile ``native/amr_forest.cc`` into ``build_dir`` (default
    ``build/``) unless a library of the same source hash is there; returns
    its path."""
    build_dir = Path(build_dir) if build_dir is not None else BUILD_DIR
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:12]
    lib = build_dir / f"libamr_forest_{digest}.so"
    if lib.exists():
        return lib
    cxx = os.environ.get("CXX") or shutil.which("g++") or "c++"
    build_dir.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    res = subprocess.run([cxx, "-O2", "-std=c++17", "-fPIC", "-Wall",
                          "-shared", "-o", str(tmp), str(SOURCE)],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"{cxx} failed ({res.returncode}) building "
                           f"{SOURCE.name}:\n{res.stdout}{res.stderr}")
    os.replace(tmp, lib)
    return lib


def _load():
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(build_library()))
    lib.amr_forest_create.restype = ctypes.c_void_p
    lib.amr_forest_create.argtypes = [ctypes.c_int32] * 8
    lib.amr_forest_destroy.restype = None
    lib.amr_forest_destroy.argtypes = [ctypes.c_void_p]
    lib.amr_forest_num_leaves.restype = ctypes.c_int32
    lib.amr_forest_num_leaves.argtypes = [ctypes.c_void_p]
    i32p = np.ctypeslib.ndpointer(dtype=np.int32, flags="C_CONTIGUOUS")
    lib.amr_forest_get_leaves.restype = None
    lib.amr_forest_get_leaves.argtypes = [ctypes.c_void_p] + [i32p] * 4
    lib.amr_forest_update.restype = ctypes.c_int32
    lib.amr_forest_update.argtypes = [ctypes.c_void_p, i32p]
    lib.amr_forest_get_transfer.restype = None
    lib.amr_forest_get_transfer.argtypes = [ctypes.c_void_p] + [i32p] * 3
    _lib = lib
    return lib


class AmrForest:
    """Leaf-block table with 2:1-balanced refine/derefine updates."""

    def __init__(self, nroot1, nroot2, nroot3, ndim=3, max_level=10,
                 periodic=(True, True, True)):
        lib = _load()
        self._h = lib.amr_forest_create(
            nroot1, nroot2, nroot3, ndim, max_level,
            int(periodic[0]), int(periodic[1]), int(periodic[2]))
        self._lib = lib

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.amr_forest_destroy(self._h)
            self._h = None

    @property
    def num_leaves(self) -> int:
        return int(self._lib.amr_forest_num_leaves(self._h))

    def leaves(self):
        """-> (levels, lx1, lx2, lx3) int32 arrays [n]."""
        n = self.num_leaves
        levels = np.empty(n, np.int32)
        lx1 = np.empty(n, np.int32)
        lx2 = np.empty(n, np.int32)
        lx3 = np.empty(n, np.int32)
        self._lib.amr_forest_get_leaves(self._h, levels, lx1, lx2, lx3)
        return levels, lx1, lx2, lx3

    def update(self, tags):
        """Apply refinement tags; -> (kind, old_id, octant) transfer arrays
        [n_new] with kind in {COPY, PROLONG, RESTRICT}."""
        tags = np.ascontiguousarray(tags, np.int32)
        if tags.size != self.num_leaves:
            raise ValueError(f"{tags.size} tags for {self.num_leaves} leaves")
        n_new = int(self._lib.amr_forest_update(self._h, tags))
        kind = np.empty(n_new, np.int32)
        old_id = np.empty(n_new, np.int32)
        octant = np.empty(n_new, np.int32)
        self._lib.amr_forest_get_transfer(self._h, kind, old_id, octant)
        return kind, old_id, octant

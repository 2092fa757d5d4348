"""History (.hst) output: volume-integrated scalar reductions over time.

Counterpart of ``athenapk_tpu/outputs/history.py`` (reference
``HistoryOutputVar`` registration at ``src/hydro/hydro.cpp:422-441`` and
Parthenon's ``.hst`` ASCII writer): a commented header, then one row per
history dump.  Columns: time, dt, mass, 1/2/3-mom, KE, total E, and for MHD
the magnetic energy and the relative divB.  Reductions run over interior
cells only.

A column is ``(label, fn)`` with ``fn(u, w, mesh) -> scalar``, summed over
the groups of a multi-level mesh (volume-weighted sums add up), or
``(label, partial_fn, finalize)``, whose tuple partials are summed over the
groups before ``finalize`` (relDivB, a ratio).
"""

from __future__ import annotations

import os
from typing import List, Sequence, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from ..core.ieee import sqrt
from ..core.indices import (AXIS_OF_DIR, GLMMHD, IB1, IB2, IB3, IDN, IEN,
                            IM1, IM2, IM3)


def _interior(q, mesh):
    """Interior view of a [nb, nz, ny, nx] per-variable tensor."""
    sl = mesh.interior_slices
    return q[tuple([sl[0]] + list(sl[2:]))]


def _block_sums(q, mesh):
    """Per-block interior sums in the state dtype, handed to the host in
    f64 (the f64 combine over blocks keeps f32 runs accurate, as the JAX
    package does)."""
    sums = torch.sum(_interior(q, mesh), dim=(1, 2, 3))
    with record_function("host_read"):
        return sums.cpu().numpy().astype(np.float64)


def hydro_history_columns(fluid: str):
    """Standard Hydro history columns (see module docstring)."""
    cols: List[Tuple] = []

    def vol_sum(q, mesh):
        return float(_block_sums(q, mesh).sum()) * mesh.cell_volume

    cols.append(("mass", lambda u, w, mesh: vol_sum(u[:, IDN], mesh)))
    cols.append(("1-mom", lambda u, w, mesh: vol_sum(u[:, IM1], mesh)))
    cols.append(("2-mom", lambda u, w, mesh: vol_sum(u[:, IM2], mesh)))
    cols.append(("3-mom", lambda u, w, mesh: vol_sum(u[:, IM3], mesh)))
    cols.append(("KE", lambda u, w, mesh: vol_sum(
        0.5 * (u[:, IM1] ** 2 + u[:, IM2] ** 2 + u[:, IM3] ** 2) / u[:, IDN],
        mesh)))
    cols.append(("tot-E", lambda u, w, mesh: vol_sum(u[:, IEN], mesh)))
    if fluid == GLMMHD:
        cols.append(("ME", lambda u, w, mesh: vol_sum(
            0.5 * (u[:, IB1] ** 2 + u[:, IB2] ** 2 + u[:, IB3] ** 2), mesh)))
        cols.append(("relDivB", _rel_divb_partial,
                     lambda p: p[0] / (p[1] + 1e-30)))
    return cols


def _rel_divb_partial(u, w, mesh):
    """``(num, den)`` partials of the volume-averaged relative divB
    (cell-centred central differences; ``HydroHst`` at hydro.cpp:145-208),
    volume-weighted so that the groups of a multi-level mesh combine."""
    b = [u[:, IB1], u[:, IB2], u[:, IB3]]
    bmag = sqrt(b[0] ** 2 + b[1] ** 2 + b[2] ** 2)
    divb = torch.zeros_like(b[0])
    dims = [1] + ([2] if mesh.nx2 > 1 else []) + ([3] if mesh.nx3 > 1 else [])
    for d in dims:
        ax = AXIS_OF_DIR[d] - 1  # u[:, var] drops the var axis
        divb = divb + (torch.roll(b[d - 1], -1, dims=ax)
                       - torch.roll(b[d - 1], 1, dims=ax)) / (2 * mesh.dx[d - 1])
    vol = mesh.cell_volume
    num = float(_block_sums(torch.abs(divb), mesh).sum()) * mesh.min_dx * vol
    den = float(_block_sums(bmag, mesh).sum()) * vol
    return (num, den)


class HistoryOutput:
    def __init__(self, filename: str, fluid: str, dt: float,
                 extra_columns: Sequence = ()):
        self.filename = filename
        self.dt = dt
        self.columns = hydro_history_columns(fluid) + list(extra_columns)
        self.next_time = 0.0
        self._wrote_header = False

    def due(self, t: float) -> bool:
        # dt < 0 (no <output>/dt in the deck) means write every cycle
        return self.dt < 0.0 or t >= self.next_time

    def _header(self):
        if self._wrote_header:
            return
        os.makedirs(os.path.dirname(self.filename) or ".", exist_ok=True)
        with open(self.filename, "w") as fh:
            fh.write("#  History data\n")
            labels = ["[1]=time", "[2]=dt"] + [
                f"[{i + 3}]={col[0]}" for i, col in enumerate(self.columns)]
            fh.write("# " + "  ".join(labels) + "\n")
        self._wrote_header = True

    def write(self, t, dt, u, w, mesh):
        self.write_groups(t, dt, [(u, w, mesh)])

    def write_groups(self, t, dt, groups):
        """One row from the groups ``[(u, w, mesh_like), ...]`` of a mesh
        (one per refinement level); ``mesh_like`` needs cell_volume,
        interior_slices, dx, min_dx, nx2 and nx3."""
        self._header()
        vals = []
        for col in self.columns:
            parts = [col[1](u, w, m) for (u, w, m) in groups]
            if len(col) == 3:
                summed = tuple(sum(p[i] for p in parts)
                               for i in range(len(parts[0])))
                vals.append(float(col[2](summed)))
            else:
                vals.append(float(sum(parts)))
        with open(self.filename, "a") as fh:
            row = [f"{float(t):.14e}", f"{float(dt):.14e}"] + [
                f"{v:.14e}" for v in vals]
            fh.write("  ".join(row) + "\n")
        while self.dt > 0.0 and self.next_time <= t:
            self.next_time += self.dt

"""History (.hst) output: volume-integrated scalar reductions over time.

Counterpart of ``athenapk_tpu/outputs/history.py`` (reference
``HistoryOutputVar`` registration at ``src/hydro/hydro.cpp:422-441`` and
Parthenon's ``.hst`` ASCII writer): a commented header, then one row per
history dump.  Columns: time, dt, mass, 1/2/3-mom, KE, total E, and for MHD
the magnetic energy and the relative divB.  Reductions run over interior
cells only.

A column is ``(label, fn)`` with ``fn(u, w, mesh) -> scalar``.
"""

from __future__ import annotations

import os
from typing import List, Sequence, Tuple

import numpy as np
import torch

from ..core.indices import IDN, IM1, IM2, IM3, IEN, IB1, IB2, IB3, GLMMHD
from ..solver.sweep import AXIS_OF_DIR


def _interior(q, mesh):
    """Interior view of a [nb, nz, ny, nx] per-variable tensor."""
    sl = mesh.interior_slices
    return q[tuple([sl[0]] + list(sl[2:]))]


def _block_sums(q, mesh):
    """Per-block interior sums in the state dtype, handed to the host in
    f64 (the f64 combine over blocks keeps f32 runs accurate, as the JAX
    package does)."""
    return torch.sum(_interior(q, mesh), dim=(1, 2, 3)).cpu().numpy() \
        .astype(np.float64)


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
        cols.append(("relDivB", _rel_divb))
    return cols


def _rel_divb(u, w, mesh):
    """Volume-averaged relative divB (cell-centred central differences;
    ``HydroHst`` at hydro.cpp:145-208)."""
    b = [u[:, IB1], u[:, IB2], u[:, IB3]]
    bmag = torch.sqrt(b[0] ** 2 + b[1] ** 2 + b[2] ** 2)
    divb = torch.zeros_like(b[0])
    dims = [1] + ([2] if mesh.nx2 > 1 else []) + ([3] if mesh.nx3 > 1 else [])
    for d in dims:
        ax = AXIS_OF_DIR[d] - 1  # u[:, var] drops the var axis
        divb = divb + (torch.roll(b[d - 1], -1, dims=ax)
                       - torch.roll(b[d - 1], 1, dims=ax)) / (2 * mesh.dx[d - 1])
    vol = mesh.cell_volume
    num = float(_block_sums(torch.abs(divb), mesh).sum()) * mesh.min_dx * vol
    den = float(_block_sums(bmag, mesh).sum()) * vol
    return num / (den + 1e-30)


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
        self._header()
        vals = [float(fn(u, w, mesh)) for _, fn in self.columns]
        with open(self.filename, "a") as fh:
            row = [f"{float(t):.14e}", f"{float(dt):.14e}"] + [
                f"{v:.14e}" for v in vals]
            fh.write("  ".join(row) + "\n")
        while self.dt > 0.0 and self.next_time <= t:
            self.next_time += self.dt

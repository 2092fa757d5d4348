"""Uniform Cartesian block-structured mesh.

The TPU-native data model: the mesh is a regular grid of equally sized
MeshBlocks; all block data lives in a single batched array
``[nblocks, nvar, NZ, NY, NX]`` (ghost-inclusive).  This is the analog of the
reference's MeshBlockPack batching (AthenaPK packs all blocks of a rank into
one kernel launch, ``src/hydro/hydro.cpp:270-271``) — here the block axis is
the outermost batch dimension of every XLA kernel.

Only ``UniformCartesian`` coordinates exist, matching the reference
(asserted at ``src/hydro/hydro.cpp:551-555``); dx is closed-form per level.

Block ordering: ``b = ibx + nbx1 * (iby + nbx2 * ibz)`` — x fastest, matching
a C-order reshape of the block grid ``[nbz, nby, nbx]``.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Static description of a uniform mesh decomposed into equal blocks."""

    # global interior cell counts
    nx1: int
    nx2: int
    nx3: int
    # per-block interior cell counts
    mbnx1: int
    mbnx2: int
    mbnx3: int
    # domain extents
    x1min: float
    x1max: float
    x2min: float
    x2max: float
    x3min: float
    x3max: float
    nghost: int = 2
    # boundary condition names per face: periodic | outflow | reflecting
    ix1_bc: str = "periodic"
    ox1_bc: str = "periodic"
    ix2_bc: str = "periodic"
    ox2_bc: str = "periodic"
    ix3_bc: str = "periodic"
    ox3_bc: str = "periodic"

    # ------------------------------------------------------------ properties
    @property
    def ndim(self) -> int:
        return 1 + (self.nx2 > 1) + (self.nx3 > 1)

    @property
    def nb1(self) -> int:
        return self.nx1 // self.mbnx1

    @property
    def nb2(self) -> int:
        return self.nx2 // self.mbnx2

    @property
    def nb3(self) -> int:
        return self.nx3 // self.mbnx3

    @property
    def nblocks(self) -> int:
        return self.nb1 * self.nb2 * self.nb3

    @property
    def dx1(self) -> float:
        return (self.x1max - self.x1min) / self.nx1

    @property
    def dx2(self) -> float:
        return (self.x2max - self.x2min) / self.nx2

    @property
    def dx3(self) -> float:
        return (self.x3max - self.x3min) / self.nx3

    @property
    def dx(self) -> Tuple[float, float, float]:
        return (self.dx1, self.dx2, self.dx3)

    @property
    def min_dx(self) -> float:
        """Global minimum cell width over active dimensions (reference
        ``CalculateGlobalMinDx``, ``src/hydro/hydro.cpp:65-95``)."""
        dxs = [self.dx1]
        if self.nx2 > 1:
            dxs.append(self.dx2)
        if self.nx3 > 1:
            dxs.append(self.dx3)
        return min(dxs)

    # ghost counts per direction (no ghosts along degenerate dims)
    @property
    def ng1(self) -> int:
        return self.nghost

    @property
    def ng2(self) -> int:
        return self.nghost if self.nx2 > 1 else 0

    @property
    def ng3(self) -> int:
        return self.nghost if self.nx3 > 1 else 0

    # padded per-block shapes
    @property
    def NX(self) -> int:
        return self.mbnx1 + 2 * self.ng1

    @property
    def NY(self) -> int:
        return self.mbnx2 + 2 * self.ng2

    @property
    def NZ(self) -> int:
        return self.mbnx3 + 2 * self.ng3

    @property
    def block_shape(self) -> Tuple[int, int, int]:
        return (self.NZ, self.NY, self.NX)

    # interior index bounds (inclusive), mirroring cellbounds.GetBounds*
    @property
    def interior(self):
        """(ks, ke, js, je, is_, ie) inclusive interior bounds."""
        return (self.ng3, self.ng3 + self.mbnx3 - 1,
                self.ng2, self.ng2 + self.mbnx2 - 1,
                self.ng1, self.ng1 + self.mbnx1 - 1)

    @property
    def interior_slices(self):
        """Slices selecting the interior of the [b, v, z, y, x] state."""
        ks, ke, js, je, is_, ie = self.interior
        return (slice(None), slice(None),
                slice(ks, ke + 1), slice(js, je + 1), slice(is_, ie + 1))

    @property
    def cell_volume(self) -> float:
        return self.dx1 * (self.dx2 if self.nx2 > 1 else self.x2max - self.x2min) * (
            self.dx3 if self.nx3 > 1 else self.x3max - self.x3min)

    # ------------------------------------------------------------ coordinates
    def block_origin(self, b: int) -> Tuple[float, float, float]:
        ibx = b % self.nb1
        iby = (b // self.nb1) % self.nb2
        ibz = b // (self.nb1 * self.nb2)
        return (self.x1min + ibx * self.mbnx1 * self.dx1,
                self.x2min + iby * self.mbnx2 * self.dx2,
                self.x3min + ibz * self.mbnx3 * self.dx3)

    def cell_centers(self, dtype=np.float64):
        """Cell-center coordinates for every block, ghost-inclusive.

        Returns (x, y, z) with shapes [nb, NX], [nb, NY], [nb, NZ]
        (numpy arrays; used by problem generators on the host).
        """
        nb = self.nblocks
        x = np.empty((nb, self.NX), dtype=dtype)
        y = np.empty((nb, self.NY), dtype=dtype)
        z = np.empty((nb, self.NZ), dtype=dtype)
        for b in range(nb):
            x0, y0, z0 = self.block_origin(b)
            x[b] = x0 + (np.arange(self.NX, dtype=dtype) - self.ng1 + 0.5) * self.dx1
            y[b] = y0 + (np.arange(self.NY, dtype=dtype) - self.ng2 + 0.5) * self.dx2
            z[b] = z0 + (np.arange(self.NZ, dtype=dtype) - self.ng3 + 0.5) * self.dx3
        return x, y, z

    def cell_centers_mesh(self, dtype=np.float64):
        """Broadcastable (x[nb,1,1,NX], y[nb,1,NY,1], z[nb,NZ,1,1]) grids."""
        x, y, z = self.cell_centers(dtype)
        return (x[:, None, None, :], y[:, None, :, None], z[:, :, None, None])

    # ------------------------------------------------------------ validation
    def __post_init__(self):
        for (n, mb, name) in ((self.nx1, self.mbnx1, "x1"),
                              (self.nx2, self.mbnx2, "x2"),
                              (self.nx3, self.mbnx3, "x3")):
            if n % mb != 0:
                raise ValueError(
                    f"mesh {name}: global n={n} not divisible by block n={mb}")
        if self.nx2 == 1 and self.nx3 > 1:
            raise ValueError("nx3 > 1 requires nx2 > 1")
        if self.nghost == 0:
            # Ghost-free periodic fast path: the mesh is ONE global block and
            # every stencil shift is a cyclic jnp.roll, which IS the periodic
            # boundary condition.  This removes all ghost-zone storage (exact
            # lane alignment at power-of-two widths, e.g. 256^3) and the
            # boundary-fill pass entirely — the TPU-native formulation of a
            # uniform periodic mesh.
            bcs = (self.ix1_bc, self.ox1_bc, self.ix2_bc, self.ox2_bc,
                   self.ix3_bc, self.ox3_bc)
            if any(bc != "periodic" for bc in bcs):
                raise ValueError(
                    "nghost=0 (ghost-free fast path) requires periodic "
                    "boundaries on all faces")
            if self.nblocks != 1:
                raise ValueError(
                    "nghost=0 (ghost-free fast path) requires a single "
                    "mesh-spanning block (meshblock = mesh)")

    # ------------------------------------------------------------ factory
    @classmethod
    def from_parameter_input(cls, pin) -> "Mesh":
        mb = "parthenon/mesh"
        blk = "parthenon/meshblock"
        nx1 = pin.get_integer(mb, "nx1")
        nx2 = pin.get_integer(mb, "nx2")
        nx3 = pin.get_integer(mb, "nx3")
        # meshblock defaults to whole mesh if absent
        mbnx1 = pin.get_or_add_integer(blk, "nx1", nx1)
        mbnx2 = pin.get_or_add_integer(blk, "nx2", nx2)
        mbnx3 = pin.get_or_add_integer(blk, "nx3", nx3)
        return cls(
            nx1=nx1, nx2=nx2, nx3=nx3,
            mbnx1=mbnx1, mbnx2=mbnx2, mbnx3=mbnx3,
            x1min=pin.get_real(mb, "x1min"), x1max=pin.get_real(mb, "x1max"),
            x2min=pin.get_real(mb, "x2min"), x2max=pin.get_real(mb, "x2max"),
            x3min=pin.get_real(mb, "x3min"), x3max=pin.get_real(mb, "x3max"),
            nghost=pin.get_or_add_integer(mb, "nghost", 2),
            ix1_bc=pin.get_or_add_string(mb, "ix1_bc", "periodic"),
            ox1_bc=pin.get_or_add_string(mb, "ox1_bc", "periodic"),
            ix2_bc=pin.get_or_add_string(mb, "ix2_bc", "periodic"),
            ox2_bc=pin.get_or_add_string(mb, "ox2_bc", "periodic"),
            ix3_bc=pin.get_or_add_string(mb, "ix3_bc", "periodic"),
            ox3_bc=pin.get_or_add_string(mb, "ox3_bc", "periodic"),
        )

"""Ghost-zone fill: inter-block exchange + physical boundary conditions.

Counterpart of ``athenapk_tpu/core/boundaries.py`` (reference
``AddBoundaryExchangeTasks``, ``src/hydro/hydro_driver.cpp:567``): the
regular block grid is viewed as ``[nb3, nb2, nb1, nvar, NZ, NY, NX]`` and
neighbour face slabs come from ``torch.roll`` along the block-grid axes.
Physical BCs (periodic / outflow / reflecting) mirror the reference
(Parthenon built-ins + AthenaPK's ``ReflectBC``,
``src/bvals/boundary_conditions_apk.hpp:38-85``).  Directions are filled
x -> y -> z so edge and corner ghosts come out consistent.

All functions act on conserved variables; reflecting therefore flips the
sign of the normal momentum.  On the ghost-free layout (nghost = 0) the
fill is the identity: the stencils' cyclic rolls are the boundary.
"""

from __future__ import annotations

from typing import Callable

import torch

from .indices import GLMMHD, IM1, IM2, IM3
from .mesh import Mesh

_NORMAL_MOM = {1: IM1, 2: IM2, 3: IM3}
_CELL_AX = {1: 6, 2: 5, 3: 4}   # cell axis of direction d in the grid view
_BLK_AX = {1: 2, 2: 1, 3: 0}    # block-grid axis of direction d


def check_reflecting_mhd(mesh: Mesh, fluid: str) -> None:
    """Reflecting BCs are hydro-only: B needs special treatment the
    reference refuses to fake (``bvals/boundary_conditions_apk.hpp``)."""
    if fluid != GLMMHD:
        return
    bcs = (mesh.ix1_bc, mesh.ox1_bc, mesh.ix2_bc, mesh.ox2_bc,
           mesh.ix3_bc, mesh.ox3_bc)
    if "reflecting" in bcs:
        raise ValueError(
            "Reflecting boundary conditions for MHD need special treatment "
            "(magnetic-field components are not handled); use outflow or "
            "periodic — matches the reference's guard in "
            "bvals/boundary_conditions_apk.hpp")


def _cslice(cell_ax: int, a, b):
    idx = [slice(None)] * 7
    idx[cell_ax] = slice(a, b)
    return tuple(idx)


def _bslice(blk_ax: int, pos: str):
    idx = [slice(None)] * 7
    idx[blk_ax] = slice(0, 1) if pos == "inner" else slice(-1, None)
    return tuple(idx)


def apply_physical_dir(grid, mesh: Mesh, dirn: int, bc: str, pos: str):
    """Apply one physical BC, in place, to the domain-boundary block layer
    of ``grid`` ([nb3, nb2, nb1, nvar, NZ, NY, NX])."""
    if bc == "periodic":
        return
    g = mesh.nghost
    cell_ax = _CELL_AX[dirn]
    N = grid.shape[cell_ax]
    cs = lambda a, b: _cslice(cell_ax, a, b)  # noqa: E731
    layer = grid[_bslice(_BLK_AX[dirn], pos)]        # a view into grid
    ghost = cs(0, g) if pos == "inner" else cs(N - g, N)
    if bc == "outflow":
        edge = cs(g, g + 1) if pos == "inner" else cs(N - g - 1, N - g)
        layer[ghost] = layer[edge].expand_as(layer[ghost])
    elif bc == "reflecting":
        nvar = grid.shape[3]
        signs = torch.ones(nvar, dtype=grid.dtype, device=grid.device)
        signs[_NORMAL_MOM[dirn]] = -1.0
        src = cs(g, 2 * g) if pos == "inner" else cs(N - 2 * g, N - g)
        mirror = torch.flip(layer[src], dims=[cell_ax])
        layer[ghost] = signs.reshape(nvar, 1, 1, 1) * mirror
    else:
        raise ValueError(f"unknown boundary condition '{bc}'")


def _fill_dir(grid, mesh: Mesh, dirn: int, inner_bc: str, outer_bc: str):
    """Exchange + physical BC along one direction, in place."""
    g = mesh.nghost
    cell_ax = _CELL_AX[dirn]
    blk_ax = _BLK_AX[dirn]
    N = grid.shape[cell_ax]
    # inter-block exchange (periodic across the domain by construction):
    # lo ghosts from the -d neighbour's last interior slab, hi ghosts from
    # the +d neighbour's first
    from_left = torch.roll(grid[_cslice(cell_ax, N - 2 * g, N - g)], 1,
                           dims=blk_ax)
    from_right = torch.roll(grid[_cslice(cell_ax, g, 2 * g)], -1,
                            dims=blk_ax)
    grid[_cslice(cell_ax, 0, g)] = from_left
    grid[_cslice(cell_ax, N - g, N)] = from_right
    apply_physical_dir(grid, mesh, dirn, inner_bc, "inner")
    apply_physical_dir(grid, mesh, dirn, outer_bc, "outer")


def make_boundary_fn(mesh: Mesh) -> Callable:
    """Build the ghost-fill function for this mesh (problem-registered
    boundary conditions are not ported yet)."""
    if mesh.nghost == 0:
        # ghost-free periodic layout (Mesh.__post_init__ validated
        # all-periodic single-block): the ghost fill is the identity
        return lambda u: u
    nb3, nb2, nb1 = mesh.nb3, mesh.nb2, mesh.nb1

    def apply_boundaries(u):
        """u: [nblocks, nvar, NZ, NY, NX] conserved state -> a ghost-filled
        copy (``u`` itself is left as it was)."""
        nvar = u.shape[1]
        grid = u.reshape(nb3, nb2, nb1, nvar, *mesh.block_shape).clone()
        _fill_dir(grid, mesh, 1, mesh.ix1_bc, mesh.ox1_bc)
        if mesh.nx2 > 1:
            _fill_dir(grid, mesh, 2, mesh.ix2_bc, mesh.ox2_bc)
        if mesh.nx3 > 1:
            _fill_dir(grid, mesh, 3, mesh.ix3_bc, mesh.ox3_bc)
        return grid.reshape(u.shape)

    return apply_boundaries

"""Explicit halo exchange over 1-D and 2-D rank grids, and the sharded step.

Counterpart of ``athenapk_tpu/parallel/halo.py``: block-grid axes are split
over the ranks and the g-deep face slabs of the neighbouring ranks move
with ``torch.distributed`` point-to-point messages, the analog of the
reference's per-neighbour MPI Isend/Irecv halo buffers
(``AddBoundaryExchangeTasks``, ``src/hydro/hydro_driver.cpp:567``; the JAX
package's ``lax.ppermute``).

Decompositions:

* 1-D: the block-grid z axis over a ``("blocks",)`` rank grid
  (``make_sharded_step``, flat ``[nblocks, nvar, NZ, NY, NX]`` rows of the
  rank's z-slab); the x and y exchange stay local;
* 2-D: block-grid (z, y) over a ``("z", "y")`` rank grid
  (``make_sharded_step_grid``, grid-shaped ``[nb3, nb2, nb1, nvar, NZ, NY,
  NX]`` pieces); an axis of size 1 fills locally.

Each sharded direction sends one message up and one down per fill in one
``batch_isend_irecv``; with two ranks on an axis both go to the same peer,
told apart by their tags.  Physical and problem-registered boundaries are
applied on the edge ranks only (the reference applies them on the blocks
that touch the domain boundary).  The dt is the minimum over ranks
(``all_reduce(MIN)``, the reference's ``MPI_Allreduce``) of each raw
minimum the estimate takes, combined afterwards, so every rank gets the
one-rank dt bit for bit.
"""

from __future__ import annotations

import copy

import torch

from ..core.boundaries import _BLK_AX, _CELL_AX, _cslice, _fill_dir, \
    apply_physical_dir
from ..core.mesh import Mesh
from .mesh_sharding import RankMesh

_TAG_UP, _TAG_DN = 0, 1


def _axsl(ndim, ax, a, b):
    idx = [slice(None)] * ndim
    idx[ax] = slice(a, b)
    return tuple(idx)


def halo_bytes(grid_shape, mesh: Mesh, dirn: int, itemsize: int) -> int:
    """Bytes one rank sends per fill along a sharded direction: two slabs,
    one block layer wide and g cells deep."""
    g = mesh.nghost
    shape = list(grid_shape)
    shape[_BLK_AX[dirn]] = 1
    shape[_CELL_AX[dirn]] = g
    n = 1
    for s in shape:
        n *= s
    return 2 * n * itemsize


def _fill_dir_sharded(grid, mesh: Mesh, dirn: int, rmesh: RankMesh,
                      axis_name: str, custom_bcs=None):
    """Ghost fill, in place, along one SHARDED block-grid direction of the
    local grid ``[nb3_loc, nb2_loc, nb1_loc, nvar, NZ, NY, NX]``: the
    neighbour ranks' g-deep slabs fill the outer block layers' ghosts, the
    local rolls the inner ones, and the domain boundary is applied on the
    edge ranks only."""
    g = mesh.nghost
    cell_ax = _CELL_AX[dirn]
    blk_ax = _BLK_AX[dirn]
    N = grid.shape[cell_ax]
    inner_bc = {1: mesh.ix1_bc, 2: mesh.ix2_bc, 3: mesh.ix3_bc}[dirn]
    outer_bc = {1: mesh.ox1_bc, 2: mesh.ox2_bc, 3: mesh.ox3_bc}[dirn]
    prev, nxt = rmesh.neighbours(axis_name)
    idx = rmesh.axis_index(axis_name)
    n_ranks = rmesh.axis_size(axis_name)

    # the slabs that cross ranks: the next rank's first layer's lo ghosts
    # come from my last layer, the previous rank's last layer's hi ghosts
    # from my first
    up = grid[_axsl(7, blk_ax, grid.shape[blk_ax] - 1, None)][
        _cslice(cell_ax, N - 2 * g, N - g)]
    dn = grid[_axsl(7, blk_ax, 0, 1)][_cslice(cell_ax, g, 2 * g)]
    from_prev, from_next = rmesh.sendrecv(
        [(nxt, up, _TAG_UP), (prev, dn, _TAG_DN)],
        [(prev, up.shape, up.dtype, _TAG_UP),
         (nxt, dn.shape, dn.dtype, _TAG_DN)])

    # inside the rank: the single-device rolls, the outer layers replaced
    left = torch.roll(grid[_cslice(cell_ax, N - 2 * g, N - g)], 1,
                      dims=blk_ax)
    right = torch.roll(grid[_cslice(cell_ax, g, 2 * g)], -1, dims=blk_ax)
    left[_axsl(7, blk_ax, 0, 1)] = from_prev
    right[_axsl(7, blk_ax, left.shape[blk_ax] - 1, None)] = from_next
    grid[_cslice(cell_ax, 0, g)] = left
    grid[_cslice(cell_ax, N - g, N)] = right

    # physical boundaries on the edge ranks (periodic is already right)
    if idx == 0:
        apply_physical_dir(grid, mesh, dirn, inner_bc, "inner", custom_bcs)
    if idx == n_ranks - 1:
        apply_physical_dir(grid, mesh, dirn, outer_bc, "outer", custom_bcs)


def _make_fill(mesh: Mesh, rmesh: RankMesh, local_grid, sharded,
               custom_bcs=None):
    """The ghost fill of a rank's rows: ``local_grid`` is the local
    ``(nb3, nb2, nb1)``, ``sharded`` ``{direction: axis name}`` for the
    directions split over ranks (the others fill locally)."""
    if mesh.nghost == 0:
        raise ValueError("a sharded mesh needs ghost zones "
                         "(parthenon/mesh/merge_blocks=false or nghost > 0)")

    def apply_boundaries(u_local):
        nvar = u_local.shape[1]
        grid = u_local.reshape(*local_grid, nvar,
                               *mesh.block_shape).clone()
        bcs = {1: (mesh.ix1_bc, mesh.ox1_bc), 2: (mesh.ix2_bc, mesh.ox2_bc),
               3: (mesh.ix3_bc, mesh.ox3_bc)}
        active = {1: True, 2: mesh.nx2 > 1, 3: mesh.nx3 > 1}
        for dirn in (1, 2, 3):
            if not active[dirn]:
                continue
            if dirn in sharded:
                _fill_dir_sharded(grid, mesh, dirn, rmesh, sharded[dirn],
                                  custom_bcs)
            else:
                _fill_dir(grid, mesh, dirn, *bcs[dirn], custom_bcs)
        return grid.reshape(u_local.shape)

    return apply_boundaries


def make_sharded_boundary_fn(mesh: Mesh, rmesh: RankMesh,
                             axis_name: str = "blocks", custom_bcs=None):
    """Ghost fill for a z-slab-sharded flat state (a rank's rows)."""
    n = rmesh.axis_size(axis_name)
    if mesh.nb3 % n != 0:
        raise ValueError(f"nb3={mesh.nb3} must divide over {n} ranks")
    sharded = {3: axis_name} if n > 1 else {}
    return _make_fill(mesh, rmesh, (mesh.nb3 // n, mesh.nb2, mesh.nb1),
                      sharded, custom_bcs)


class ShardedStep:
    """A rank's step and dt over its rows: ``step(u, dt, c_h, t=0.0)`` runs
    the port's ``HydroPackage.step`` on a shallow copy of the package whose
    ghost fill is the sharded one; ``dt(u)`` gives ``(dt, dt_hyp,
    dt_diff)``, the one-rank estimate's floats, from the minima over ranks.
    A rank-local dt never leaves: the whole-stage rung's emitted CFL bound
    is refused (``emit_dt``)."""

    def __init__(self, pkg, rmesh: RankMesh, apply_boundaries, to_flat,
                 from_flat):
        self.rmesh = rmesh
        self.pkg = copy.copy(pkg)
        self.pkg.apply_boundaries = apply_boundaries
        self._to_flat = to_flat
        self._from_flat = from_flat

    def step(self, u, dt, c_h, t=0.0, emit_dt=False):
        if emit_dt:
            raise ValueError("emit_dt gives a rank-local CFL bound; a "
                             "sharded step takes its dt from dt() (the "
                             "minimum over ranks)")
        return self._from_flat(self.pkg.step(self._to_flat(u), dt, c_h, t),
                               u)

    def dt(self, u):
        _, prim = self.pkg.cons_to_prim(self._to_flat(u))
        return self.pkg.estimate_timestep(
            prim, reduce_min=lambda v: self.rmesh.all_reduce(v, "min"))

    def __iter__(self):
        # (step_fn, dt_fn), the JAX package's pair
        return iter((self.step, self.dt))


def check_no_problem_source(pkg):
    """Refuse a package with an unsplit problem source: the uniform hooks
    close over the whole mesh's coordinates and sum over its blocks, so on
    a rank's rows they would fail on a shape or make rank-local sums (the
    JAX package's ``shard_map`` step runs the same closure and fails on
    the shapes when it traces).  Refined meshes shard the hook
    (``AmrHydro(rmesh=...)``)."""
    if getattr(pkg, "problem_source_unsplit", None) is not None:
        raise ValueError(
            "a uniform sharded step does not run the problem's unsplit "
            "source: the hook holds the whole mesh's coordinates and sums "
            "over all blocks; run the problem on a refined mesh over ranks "
            "(AmrHydro(rmesh=...)) or on one rank")


def make_sharded_step(pkg, rmesh: RankMesh, axis_name: str = "blocks"):
    """``ShardedStep`` over the rows of a z-slab rank grid; unpacks as the
    JAX package's ``(step_fn, dt_fn)``: ``step_fn(u, dt, c_h) -> u'`` and
    ``dt_fn(u) -> (dt, dt_hyp, dt_diff)`` on this rank's
    ``[nblocks / world, nvar, NZ, NY, NX]`` rows.  A package with an
    unsplit problem source is refused (``check_no_problem_source``)."""
    check_no_problem_source(pkg)
    fill = make_sharded_boundary_fn(pkg.mesh, rmesh, axis_name,
                                    getattr(pkg, "custom_bcs", None))
    return ShardedStep(pkg, rmesh, fill, lambda u: u, lambda v, u: v)


# ---------------------------------------------------------------- 2-D grid
def make_device_mesh_2d(rmesh: RankMesh, shape, names=("z", "y")):
    """The ``(ndz, ndy)`` rank grid over the ranks (and the group) of
    ``rmesh``."""
    return RankMesh(rmesh.rank, rmesh.world, tuple(shape), tuple(names),
                    rmesh.device, rmesh.backend)


def grid_sharding(mesh: Mesh, rmesh: RankMesh, names=("z", "y")):
    """This rank's ``(z, y)`` block-grid slices of a grid-shaped state."""
    ndz, ndy = rmesh.axis_size(names[0]), rmesh.axis_size(names[1])
    if mesh.nb3 % ndz != 0 or mesh.nb2 % ndy != 0:
        raise ValueError(
            f"block grid ({mesh.nb3},{mesh.nb2}) not divisible by device "
            f"mesh ({ndz},{ndy})")
    nz, ny = mesh.nb3 // ndz, mesh.nb2 // ndy
    iz, iy = rmesh.axis_index(names[0]), rmesh.axis_index(names[1])
    return slice(iz * nz, (iz + 1) * nz), slice(iy * ny, (iy + 1) * ny)


def to_grid(u, mesh: Mesh):
    """``[nblocks, nvar, ...]`` -> ``[nb3, nb2, nb1, nvar, ...]``."""
    return u.reshape(mesh.nb3, mesh.nb2, mesh.nb1, u.shape[1],
                     *mesh.block_shape)


def from_grid(ug, mesh: Mesh):
    return ug.reshape(mesh.nblocks, ug.shape[3], *mesh.block_shape)


def shard_grid(ug, mesh: Mesh, rmesh: RankMesh, names=("z", "y")):
    """This rank's piece of a grid-shaped state."""
    sz, sy = grid_sharding(mesh, rmesh, names)
    return ug[sz, sy].contiguous()


def gather_grid(ug_local, mesh: Mesh, rmesh: RankMesh, names=("z", "y")):
    """The whole grid-shaped state from every rank's piece."""
    parts = rmesh.all_gather(ug_local)
    out = torch.empty((mesh.nb3, mesh.nb2) + tuple(ug_local.shape[2:]),
                      dtype=ug_local.dtype, device=ug_local.device)
    for r, p in enumerate(parts):
        c = rmesh.coords(r)
        ndz, ndy = rmesh.axis_size(names[0]), rmesh.axis_size(names[1])
        nz, ny = mesh.nb3 // ndz, mesh.nb2 // ndy
        iz, iy = c[rmesh.names.index(names[0])], c[rmesh.names.index(names[1])]
        out[iz * nz:(iz + 1) * nz, iy * ny:(iy + 1) * ny] = p
    return out


def make_sharded_step_grid(pkg, rmesh: RankMesh, names=("z", "y")):
    """``ShardedStep`` over a 2-D ``(z, y)`` rank grid, on grid-shaped
    pieces ``[nb3 / ndz, nb2 / ndy, nb1, nvar, NZ, NY, NX]`` (place them
    with ``to_grid`` and ``shard_grid``).  Either axis may have size 1.  A
    package with an unsplit problem source is refused."""
    check_no_problem_source(pkg)
    mesh = pkg.mesh
    zname, yname = names
    sz, sy = grid_sharding(mesh, rmesh, names)
    local = (sz.stop - sz.start, sy.stop - sy.start, mesh.nb1)
    sharded = {}
    if rmesh.axis_size(yname) > 1:
        sharded[2] = yname
    if rmesh.axis_size(zname) > 1:
        sharded[3] = zname
    fill = _make_fill(mesh, rmesh, local, sharded,
                      getattr(pkg, "custom_bcs", None))
    nvar = pkg.cfg.nvar
    return ShardedStep(
        pkg, rmesh, fill,
        lambda ug: ug.reshape(-1, nvar, *mesh.block_shape),
        lambda v, ug: v.reshape(ug.shape))

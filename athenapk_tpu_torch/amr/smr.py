"""Refined meshes, static and adaptive: level-grouped blocks with
coarse-fine coupling (torch).

Counterpart of ``athenapk_tpu/amr/smr.py``: leaf blocks (from the native
forest manager) are grouped by level into batched tensors
``{level: [nb_level, nvar, NZ, NY, NX]}``; every ghost cell's provenance
(same-level copy, prolongation from a coarse neighbour, restriction from
fine neighbours, physical boundary) is worked out once on the host into
index tensors, so a ghost fill is ``index_select`` / ``index_copy_`` and
slicing.  (The JAX package's one-hot row moves are a TPU workaround for
gathers and are not ported.)

The fill is the JAX package's default, sequential slab assembly
(``_fill_ghosts_sequential``): pass A fills the faces of every level but
the coarsest (restriction reads them), pass B fills each level coarsest
first, axis by axis with growing transverse extents, pass C re-applies the
physical boundaries at full extent.  It updates the level tensors in place.

``SmrMesh.from_forest`` wraps a forest that an adaptive remesh has just
updated (``amr/remesh.py``), ``SmrMesh.from_leaf_table`` rebuilds the mesh
of a saved leaf table.  Problem-registered boundary conditions
(``SmrState(custom_bcs=...)``, the cloud's inflow): a physical face whose
BC name is a key calls ``fn(u, didx, gsl, lev, axis, lo)`` after the
axis's slabs are written, with ``u`` the level tensor, ``didx`` the
blocks on that face and ``gsl`` the ghost region's (z, y, x) slices at
the pass's transverse extents; it writes ``u[didx, :, *gsl]`` in place.
(The JAX package's sequential fill hands its hooks the same slices
without the variable axis, which its cloud hook then misreads; its
``scatter`` fill passes the variable axis and is the one the port's
results are held against.)  Not ported: the ``scatter`` and ``buffered``
A/B fills (they give the same bits).

``leaf_mesh`` and ``LevelLeafView`` let a uniform mesh's problem hooks run
on a refined mesh: a one-block ``Mesh`` of one leaf, and a mesh-like view
of one level's leaves.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.amr_forest import AmrForest
from ..core.device import resolve_device
from ..core.indices import IM1, IM2, IM3
from ..core.mesh import Mesh
from ..refinement.prolong_restrict import prolongate_minmod, restrict_average


def smr_regions_from_deck(pin):
    """``<parthenon/static_refinement{N}>`` blocks of a deck as region
    tuples ``(x1min, x1max, x2min, x2max, x3min, x3max, level)``."""
    regions = []
    for name in sorted(pin.blocks):
        if not name.startswith("parthenon/static_refinement"):
            continue
        regions.append((
            pin.get_real(name, "x1min"), pin.get_real(name, "x1max"),
            pin.get_real(name, "x2min"), pin.get_real(name, "x2max"),
            pin.get_real(name, "x3min"), pin.get_real(name, "x3max"),
            pin.get_integer(name, "level")))
    return regions


def _periodicity(base: Mesh):
    return (base.ix1_bc == "periodic", base.ix2_bc == "periodic",
            base.ix3_bc == "periodic")


@dataclasses.dataclass(frozen=True)
class LevelMesh:
    """One level's block geometry, as the solver functions read a mesh:
    the base mesh's block layout with the level's cell widths."""

    base: Mesh
    dx: tuple

    @property
    def dx1(self):
        return self.dx[0]

    @property
    def dx2(self):
        return self.dx[1]

    @property
    def dx3(self):
        return self.dx[2]

    @property
    def min_dx(self):
        b = self.base
        return min(d for d, n in zip(self.dx, (b.nx1, b.nx2, b.nx3)) if n > 1)

    @property
    def cell_volume(self):
        return self.dx[0] * self.dx[1] * self.dx[2]

    def __getattr__(self, name):
        # block layout (nx2, nx3, nghost, ng1..3, mbnx1..3, block_shape,
        # interior_slices, ...) is the base mesh's
        if name.startswith("__"):
            raise AttributeError(name)
        return getattr(self.base, name)


class SmrMesh:
    """Leaf-block geometry of a refined mesh: a base ``Mesh`` (whose
    meshblock is every level's block) plus static refinement regions
    ``[(x1min, x1max, ..., level)]``, or a forest (``from_forest``)."""

    def __init__(self, base: Mesh, regions, max_level=None):
        if base.ndim < 1:
            raise ValueError("SMR needs at least a 1-D mesh")
        self.base = base
        # refinement ceiling (the deck's numlevel - 1); defaults to the
        # deepest static region
        region_max = max((r[-1] for r in regions), default=0)
        if max_level is None:
            max_level = region_max
        if max_level < region_max:
            raise ValueError("max_level below deepest static region")
        forest = AmrForest(base.nb1, base.nb2, base.nb3, ndim=base.ndim,
                           max_level=max_level, periodic=_periodicity(base))
        # refine the blocks that intersect each region up to its level;
        # inactive dimensions never refine
        act2 = base.nx2 > 1
        act3 = base.nx3 > 1
        for _ in range(region_max):
            levels, lx1, lx2, lx3 = forest.leaves()
            tags = np.zeros(forest.num_leaves, np.int32)
            for (x0, x1, y0, y1, z0, z1, lev) in regions:
                for i in range(forest.num_leaves):
                    if levels[i] >= lev:
                        continue
                    s = 1 << levels[i]
                    w1 = (base.x1max - base.x1min) / (base.nb1 * s)
                    w2 = (base.x2max - base.x2min) / (
                        base.nb2 * (s if act2 else 1))
                    w3 = (base.x3max - base.x3min) / (
                        base.nb3 * (s if act3 else 1))
                    bx0 = base.x1min + lx1[i] * w1
                    by0 = base.x2min + lx2[i] * w2
                    bz0 = base.x3min + lx3[i] * w3
                    if (bx0 < x1 and bx0 + w1 > x0 and by0 < y1
                            and by0 + w2 > y0 and bz0 < z1
                            and bz0 + w3 > z0):
                        tags[i] = 1
            if not tags.any():
                break
            forest.update(tags)
        self._adopt_forest(forest)

    def _adopt_forest(self, forest):
        """Take the forest's leaf table.  ``max_level`` is the deepest level
        that holds leaves, as in the JAX package (``dx``/``min_dx`` of the
        finest level set the GLM speed); the refinement ceiling (the deck's
        ``numlevel - 1``) is the forest's own, so a mesh derefined to its
        roots refines again."""
        self.forest = forest
        self.levels, self.lx1, self.lx2, self.lx3 = forest.leaves()
        self.max_level = int(self.levels.max())
        # only levels that hold leaves: after a remesh level 0 may be empty
        # (every root refined), and a level with no leaves has no tensor
        self.level_ids = {lev: ids for lev in range(self.max_level + 1)
                          if (ids := np.where(self.levels == lev)[0]).size}
        self._by_loc = {(int(l), int(a), int(b), int(c)): i
                        for i, (l, a, b, c) in enumerate(
                            zip(self.levels, self.lx1, self.lx2, self.lx3))}

    @classmethod
    def from_forest(cls, base: Mesh, forest):
        """Wrap a forest that ``forest.update`` has just changed (the
        adaptive path)."""
        sm = cls.__new__(cls)
        sm.base = base
        sm._adopt_forest(forest)
        return sm

    @classmethod
    def from_leaf_table(cls, base: Mesh, levels, lx1, lx2, lx3,
                        max_level=None):
        """The mesh of a saved leaf table: refine-only tags replayed on a
        fresh forest until the leaf set matches (any 2:1-balanced table is
        reachable so).  ``max_level`` is the forest's ceiling (default: the
        table's deepest level)."""
        levels = np.asarray(levels)
        if max_level is None:
            max_level = int(levels.max())
        forest = AmrForest(base.nb1, base.nb2, base.nb3, ndim=base.ndim,
                           max_level=max_level, periodic=_periodicity(base))
        target = {(int(l), int(a), int(b), int(c))
                  for l, a, b, c in zip(levels, lx1, lx2, lx3)}
        for _ in range(max_level + 1):
            cur, ca, cb, cc = forest.leaves()
            tags = np.array([(int(l), int(a), int(b), int(c)) not in target
                             for l, a, b, c in zip(cur, ca, cb, cc)],
                            np.int32)
            if not tags.any():
                break
            forest.update(tags)
        sm = cls.from_forest(base, forest)
        got = {(int(l), int(a), int(b), int(c)) for l, a, b, c in
               zip(sm.levels, sm.lx1, sm.lx2, sm.lx3)}
        if got != target:
            raise ValueError("leaf table replay failed (table not "
                             "2:1-balanced or level out of range)")
        return sm

    def _scales(self, level):
        """Refinement scale per dimension: 2^level on active dims, 1 on
        inactive ones (a 2-D mesh never refines z)."""
        b = self.base
        s = 1 << level
        return (s, s if b.nx2 > 1 else 1, s if b.nx3 > 1 else 1)

    def dx(self, level):
        b = self.base
        s1, s2, s3 = self._scales(level)
        return (b.dx1 / s1, b.dx2 / s2, b.dx3 / s3)

    def min_dx(self, level):
        """Smallest cell width over the active dims at a level."""
        b = self.base
        d = self.dx(level)
        return min(d[i] for i, n in enumerate((b.nx1, b.nx2, b.nx3)) if n > 1)

    def level_mesh(self, level) -> LevelMesh:
        return LevelMesh(self.base, self.dx(level))

    def find(self, level, a, b, c):
        """Leaf id at a location, or -1."""
        return self._by_loc.get((level, a, b, c), -1)

    def wrap(self, level, a, b, c):
        """A neighbour location wrapped periodically; ``None`` where it
        crosses a non-periodic domain boundary."""
        per = _periodicity(self.base)
        s1, s2, s3 = self._scales(level)
        ext = (self.base.nb1 * s1, self.base.nb2 * s2, self.base.nb3 * s3)
        out = []
        for v, e, p in zip((a, b, c), ext, per):
            if 0 <= v < e:
                out.append(v)
            elif p:
                out.append(v % e)
            else:
                return None
        return tuple(out)

    def block_origin(self, leaf_id):
        lev = int(self.levels[leaf_id])
        s1, s2, s3 = self._scales(lev)
        w1 = self.base.dx1 * self.base.mbnx1 / s1
        w2 = self.base.dx2 * self.base.mbnx2 / s2
        w3 = self.base.dx3 * self.base.mbnx3 / s3
        return (self.base.x1min + self.lx1[leaf_id] * w1,
                self.base.x2min + self.lx2[leaf_id] * w2,
                self.base.x3min + self.lx3[leaf_id] * w3)

    def cell_centers_leaf(self, leaf_id):
        """Ghost-inclusive cell centres (x, y, z broadcastable) of a leaf."""
        b = self.base
        lev = int(self.levels[leaf_id])
        d1, d2, d3 = self.dx(lev)
        x0, y0, z0 = self.block_origin(leaf_id)
        x = x0 + (np.arange(b.NX) - b.ng1 + 0.5) * d1
        y = y0 + (np.arange(b.NY) - b.ng2 + 0.5) * d2
        z = z0 + (np.arange(b.NZ) - b.ng3 + 0.5) * d3
        return (x[None, None, :], y[None, :, None], z[:, None, None])


def leaf_mesh(smesh: SmrMesh, gid: int) -> Mesh:
    """One-block Mesh covering one leaf (for per-leaf problem set-up)."""
    b = smesh.base
    lev = int(smesh.levels[gid])
    x0, y0, z0 = smesh.block_origin(gid)
    d1, d2, d3 = smesh.dx(lev)
    return Mesh(nx1=b.mbnx1, nx2=b.mbnx2, nx3=b.mbnx3,
                mbnx1=b.mbnx1, mbnx2=b.mbnx2, mbnx3=b.mbnx3,
                x1min=x0, x1max=x0 + d1 * b.mbnx1,
                x2min=y0, x2max=y0 + d2 * b.mbnx2,
                x3min=z0, x3max=z0 + d3 * b.mbnx3,
                nghost=b.nghost)


class LevelLeafView:
    """Mesh-like view of one refinement level's leaves, so that a uniform
    mesh's problem hook (a split-source factory, say) runs unchanged on a
    refined mesh: the block axis is the level's leaves, ``cell_centers_mesh``
    gives each leaf's own coordinates, dx is the level's, and the domain
    extents stay global (factories read them for whole-domain
    constants)."""

    def __init__(self, smesh: SmrMesh, lev: int):
        b = smesh.base
        self._smesh = smesh
        self._ids = smesh.level_ids[lev]
        self.nblocks = len(self._ids)
        self.nghost = b.nghost
        self.ng1, self.ng2, self.ng3 = b.ng1, b.ng2, b.ng3
        self.NX, self.NY, self.NZ = b.NX, b.NY, b.NZ
        self.block_shape = b.block_shape
        self.mbnx1, self.mbnx2, self.mbnx3 = b.mbnx1, b.mbnx2, b.mbnx3
        self.dx1, self.dx2, self.dx3 = smesh.dx(lev)
        self.dx = (self.dx1, self.dx2, self.dx3)
        self.min_dx = smesh.min_dx(lev)
        self.cell_volume = self.dx1 * self.dx2 * self.dx3
        self.x1min, self.x1max = b.x1min, b.x1max
        self.x2min, self.x2max = b.x2min, b.x2max
        self.x3min, self.x3max = b.x3min, b.x3max
        self.nx1, self.nx2, self.nx3 = b.nx1, b.nx2, b.nx3
        self.interior_slices = b.interior_slices
        self.ndim = b.ndim

    def cell_centers(self, dtype=np.float64):
        nb = self.nblocks
        x = np.empty((nb, self.NX), dtype=dtype)
        y = np.empty((nb, self.NY), dtype=dtype)
        z = np.empty((nb, self.NZ), dtype=dtype)
        for li, gid in enumerate(self._ids):
            xs, ys, zs = self._smesh.cell_centers_leaf(gid)
            x[li] = np.ravel(xs)
            y[li] = np.ravel(ys)
            z[li] = np.ravel(zs)
        return x, y, z

    def cell_centers_mesh(self, dtype=np.float64):
        x, y, z = self.cell_centers(dtype)
        return (x[:, None, None, :], y[:, None, :, None],
                z[:, :, None, None])


class SmrState:
    """Ghost-fill plans of a refined mesh and the fill itself.  Index
    tensors live on ``device``, where the state is: the card unless the
    caller asks for the CPU."""

    def __init__(self, smesh: SmrMesh, nvar: int, device="cuda",
                 custom_bcs=None):
        self.smesh = smesh
        self.nvar = nvar
        self.custom_bcs = custom_bcs or {}
        self.device = resolve_device(device)
        b = smesh.base
        self.block_shape = b.block_shape
        # per array axis (1 = z, 2 = y, 3 = x of [nvar, NZ, NY, NX]);
        # inactive dimensions carry no ghosts, never halve and have no faces
        self.ndim = b.ndim
        self.n_of = {3: b.mbnx1, 2: b.mbnx2, 1: b.mbnx3}
        self.g_of = {3: b.ng1, 2: b.ng2, 1: b.ng3}
        self.act = {3: True, 2: b.nx2 > 1, 1: b.nx3 > 1}
        self.half_of = {ax: (n // 2 if self.act[ax] else n)
                        for ax, n in self.n_of.items()}
        self.nfaces = 2 * self.ndim
        self.noct = 1 << self.ndim          # children per refinement
        active_mb = [self.n_of[ax] for ax in (1, 2, 3) if self.act[ax]]
        if b.nghost > min(active_mb) // 2:
            raise ValueError("SMR requires nghost <= meshblock/2 (the "
                             "restricted fine slab must cover the ghosts)")
        self._plans = {lev: self._build_plan(lev) for lev in smesh.level_ids}
        # leaf id -> (level, row of the level tensor)
        self.loc_of = self._locations()
        self._batch = self._build_batches()

    def _obit(self, oc):
        """Octant bit per array axis (forest encoding: x = bit 0, y = bit 1,
        z = bit 2)."""
        return {3: oc & 1, 2: (oc >> 1) & 1, 1: (oc >> 2) & 1}

    def index(self, a):
        """An int64 index tensor on the state's device."""
        return torch.as_tensor(np.asarray(a, np.int64), device=self.device)

    def _locations(self):
        """``{leaf id: (level, row)}``: every leaf's row in its level
        tensor."""
        return {int(gid): (lev, li)
                for lev, ids in self.smesh.level_ids.items()
                for li, gid in enumerate(ids)}

    def level_rows(self, lev):
        """Rows of a level tensor that the plans index."""
        return len(self.smesh.level_ids.get(lev, ()))

    def _build_batches(self):
        """Group the plan's ops into one gather and one write per (level,
        face[, octant]) instead of one per block."""
        loc_of = self.loc_of
        batch = {}
        for lev, plan in self._plans.items():
            same = {f: ([], []) for f in range(self.nfaces)}
            coarse = {}
            fine = {f: ([], []) for f in range(self.nfaces)}
            phys = {f: [] for f in range(self.nfaces)}
            for (li, face, kind, payload) in plan:
                if kind == "same":
                    same[face][0].append(li)
                    same[face][1].append(loc_of[payload][1])
                elif kind == "coarse":
                    cgid, octant = payload
                    d, s = coarse.setdefault((face, octant), ([], []))
                    d.append(li)
                    s.append(loc_of[cgid][1])
                elif kind == "fine":
                    kids = sorted(payload)  # by octant
                    fine[face][0].append(li)
                    fine[face][1].append([loc_of[kid][1] for (_, kid) in kids])
                elif kind == "phys":
                    phys[face].append(li)
            ix = self.index
            batch[lev] = {
                "phys": {f: ix(d) for f, d in phys.items() if d},
                "same": {f: (ix(d), ix(s)) for f, (d, s) in same.items() if d},
                "coarse": {k: (ix(d), ix(s)) for k, (d, s) in coarse.items()},
                # (destinations, the kids of each as one flat index,
                # [ops, kids per op])
                "fine": {f: (ix(d), ix(np.ravel(s)), np.shape(s))
                         for f, (d, s) in fine.items() if d},
            }
            # the octant groups of each face in one gather: sources offset
            # by the group's position in the concatenated parent strips
            cat = {}
            nbp = self.level_rows(lev - 1)
            for (face, _), (d, s) in coarse.items():
                ds, ss = cat.setdefault(face, ([], []))
                ss.append(np.asarray(s) + len(ds) * nbp)
                ds.append(np.asarray(d))
            batch[lev]["coarse_cat"] = {
                f: (ix(np.concatenate(ds)), ix(np.concatenate(ss)))
                for f, (ds, ss) in cat.items()}
        return batch

    # ---------------------------------------------------------------- plans
    def _plan_ids(self, lev):
        """The leaves whose ghosts this state fills, in row order."""
        return self.smesh.level_ids[lev]

    def _build_plan(self, lev, ids=None):
        """For each block of this level (``ids``, default ``_plan_ids``) and
        each face, the provenance of its ghosts: ('same', leaf) | ('coarse',
        (leaf, octant)) | ('fine', [(octant, leaf), ...]) | ('phys',
        None)."""
        sm = self.smesh
        ops = []  # (block_local_idx, face, kind, payload)
        ids = self._plan_ids(lev) if ids is None else ids
        offsets = [(-1, 0, 0), (1, 0, 0), (0, -1, 0), (0, 1, 0),
                   (0, 0, -1), (0, 0, 1)][:self.nfaces]
        for loc_i, gid in enumerate(ids):
            a, b_, c = int(sm.lx1[gid]), int(sm.lx2[gid]), int(sm.lx3[gid])
            for face, (dx, dy, dz) in enumerate(offsets):
                loc = sm.wrap(lev, a + dx, b_ + dy, c + dz)
                if loc is None:
                    ops.append((loc_i, face, "phys", None))
                    continue
                na, nb_, nc = loc
                same = sm.find(lev, na, nb_, nc)
                if same >= 0:
                    ops.append((loc_i, face, "same", same))
                    continue
                coarse = sm.find(lev - 1, na // 2, nb_ // 2, nc // 2) \
                    if lev > 0 else -1
                if coarse >= 0:
                    # octant of my neighbour location within the coarse block
                    octant = (na & 1) | ((nb_ & 1) << 1) | ((nc & 1) << 2)
                    ops.append((loc_i, face, "coarse", (coarse, octant)))
                    continue
                # fine neighbours: the 2^(ndim-1) children of the neighbour
                # location that touch my face must be leaves at lev + 1
                b = sm.base
                fa = 2 * na
                fb = 2 * nb_ if b.nx2 > 1 else nb_
                fc = 2 * nc if b.nx3 > 1 else nc
                bit = face // 2          # octant bit along the face axis
                want = 1 if face % 2 == 0 else 0
                kids = []
                for oc in range(self.noct):
                    if (oc >> bit) & 1 != want:
                        continue
                    kid = sm.find(lev + 1, fa + (oc & 1), fb + ((oc >> 1) & 1),
                                  fc + ((oc >> 2) & 1))
                    if kid >= 0:
                        kids.append((oc, kid))
                if len(kids) != self.noct // 2:
                    raise RuntimeError(
                        f"SMR neighbour resolution failed at level {lev} "
                        f"block {gid} face {face}")
                ops.append((loc_i, face, "fine", kids))
        return ops

    # ------------------------------------------------------------ ghost fill
    def fill_ghosts(self, state):
        """``{level: [nb, nvar, NZ, NY, NX]}`` -> the same tensors with their
        ghosts filled (in place; the dict is returned)."""
        out = dict(state)
        for step in self.fill_steps():
            self._fill_axis(out, *step)
        return out

    def fill_steps(self):
        """The fill's steps in order, ``(level, axis, ext_axes,
        phys_only)``: every read of a step precedes its writes."""
        act_axes = [ax for ax in (3, 2, 1) if self.act[ax]]
        levs = sorted(self.smesh.level_ids)
        steps = []
        for lev in levs[1:]:                          # pass A
            for ax in act_axes:
                steps.append((lev, ax, (), False))
        for lev in levs:                              # pass B
            for i, ax in enumerate(act_axes):
                steps.append((lev, ax, tuple(act_axes[:i]), False))
        for lev in levs:                              # pass C: phys last
            for ax in act_axes:
                steps.append((lev, ax, tuple(a for a in act_axes if a != ax),
                              True))
        return steps

    def _fill_axis(self, out, lev, axis, ext_axes, phys_only=False):
        """Assemble the lo/hi ghost slabs of ``axis`` from the current level
        tensors, then write them: every read precedes both writes."""
        new_slabs, custom_ops = self._assemble_axis(out, lev, axis, ext_axes,
                                                    phys_only)
        u = out[lev]
        for gidx, slab in new_slabs.values():
            u[gidx] = slab
        for bc, d, gsl, lo in custom_ops:
            self.custom_bcs[bc](u, d, gsl, lev, axis, lo)

    def _assemble_axis(self, out, lev, axis, ext_axes, phys_only=False):
        """The lo/hi ghost slabs of ``axis`` for one level: ``({lo: (index
        of the ghost region, slab)}, [custom boundary calls])``.
        ``ext_axes``: transverse axes whose ghost columns are included
        (already filled this round); ``phys_only``: pass C, physical
        boundaries only."""
        sm = self.smesh
        n_of, g_of, act = self.n_of, self.g_of, self.act
        half_of = self.half_of
        n, g = n_of[axis], g_of[axis]
        h = half_of[axis]
        gc = (g + 1) // 2            # coarse cells covering g fine ghosts
        fr = g // 2                  # restriction's transverse corner depth
        batch = self._batch[lev]

        def read(level, idx):
            return out[level][idx]

        def tsl(ax, child=False, child_ext=()):
            """Transverse slice of axis ``ax``: ghost-extended if already
            swept (or asked for by ``child_ext`` for child strips), else
            the interior."""
            if not act[ax]:
                return slice(0, n_of[ax])
            if child:
                if ax in child_ext:
                    return slice(g_of[ax] - 2 * fr,
                                 g_of[ax] + n_of[ax] + 2 * fr)
                return slice(g_of[ax], g_of[ax] + n_of[ax])
            if ax in ext_axes:
                return slice(0, n_of[ax] + 2 * g_of[ax])
            return slice(g_of[ax], g_of[ax] + n_of[ax])

        def vsl(sl_axis):
            """[nb, nvar, z, y, x] index: ``sl_axis`` on the fill axis, the
            pass's transverse extents elsewhere."""
            idx = [slice(None), slice(None), None, None, None]
            for ax in (1, 2, 3):
                idx[ax + 1] = sl_axis if ax == axis else tsl(ax)
            return tuple(idx)

        new_slabs, custom_ops = {}, []
        for lo in (True, False):
            face = 2 * (3 - axis) + (0 if lo else 1)
            if phys_only and face not in batch["phys"]:
                continue
            ghost = slice(0, g) if lo else slice(g + n, 2 * g + n)
            slab = read(lev, vsl(ghost)).clone()      # old content as base
            touched = False

            # ---- same-level copies (sources: interiors only)
            if not phys_only and face in batch["same"]:
                d, s = batch["same"][face]
                src = slice(n, n + g) if lo else slice(g, 2 * g)
                slab.index_copy_(0, d, read(lev, vsl(src)).index_select(0, s))
                touched = True

            # ---- fine restriction (children interiors plus their pass-A
            # face ghosts to transverse depth 2*fr, one ext axis at a time)
            if not phys_only and face in batch["fine"]:
                d, kids, (nops, nk) = batch["fine"][face]
                bit = face // 2
                want = 1 if lo else 0
                ocs = [oc for oc in range(self.noct)
                       if (oc >> bit) & 1 == want]
                csrc = (slice(g + n - 2 * g, g + n) if lo
                        else slice(g, 3 * g))
                for ext in (None,) + tuple(t for t in ext_axes
                                           if act[t] and fr > 0):
                    cext = (ext,) if ext is not None else ()
                    idx = [slice(None), slice(None), None, None, None]
                    for ax in (1, 2, 3):
                        idx[ax + 1] = (csrc if ax == axis
                                       else tsl(ax, child=True,
                                                child_ext=cext))
                    strip = read(lev + 1, tuple(idx)).index_select(0, kids)
                    rest = restrict_average(strip, dims=self.ndim)
                    half = {ax: (half_of[ax] + (2 * fr if ax == ext else 0))
                            if act[ax] else n_of[ax] for ax in (1, 2, 3)}
                    half[axis] = g
                    rest = rest.reshape((nops, nk, self.nvar,
                                         half[1], half[2], half[3]))
                    ag_n = {ax: n_of[ax] + (2 * fr if ax == ext else 0)
                            for ax in (1, 2, 3)}
                    ag_n[axis] = g
                    agg = torch.zeros((nops, self.nvar, ag_n[1], ag_n[2],
                                       ag_n[3]), dtype=rest.dtype,
                                      device=rest.device)
                    for j, oc in enumerate(ocs):
                        ob = self._obit(oc)
                        psl = [slice(None), slice(None), None, None, None]
                        for ax in (1, 2, 3):
                            if ax == axis:
                                psl[ax + 1] = slice(0, g)
                            else:
                                off = ob[ax] * half_of[ax] if act[ax] else 0
                                psl[ax + 1] = slice(off, off + half[ax])
                        agg[tuple(psl)] = rest[:, j]
                    # placement in the slab: ext axes span [0, n+2g) ->
                    # offset g-fr; interior axes span [0, n) -> offset 0
                    ssl = [slice(None), slice(None), None, None, None]
                    for ax in (1, 2, 3):
                        if ax == axis:
                            ssl[ax + 1] = slice(0, g)
                        elif ax == ext:
                            ssl[ax + 1] = slice(g_of[ax] - fr,
                                                g_of[ax] - fr + ag_n[ax])
                        elif ax in ext_axes and act[ax]:
                            ssl[ax + 1] = slice(g_of[ax],
                                                g_of[ax] + n_of[ax])
                        else:
                            ssl[ax + 1] = slice(0, ag_n[ax])
                    slab[tuple(ssl)].index_copy_(0, d, agg)
                    touched = True

            # ---- coarse prolongation (the parent is completely filled);
            # the octant groups of a face share the strip's shape, so all
            # of them go through one gather + prolongation + write
            cgroups = {} if phys_only else {
                oct_: ds for (f, oct_), ds in batch["coarse"].items()
                if f == face}
            sel = None
            ogroups = []
            for oct_, (d, s) in cgroups.items():
                ob = self._obit(oct_)
                o_ax = g + ob[axis] * h
                csl = (slice(o_ax + h - gc - 1, o_ax + h + 1) if lo
                       else slice(o_ax - 1, o_ax + gc + 1))
                idx = [slice(None), slice(None), None, None, None]
                sel = [slice(None), slice(None), None, None, None]
                clamped = False
                for ax in (1, 2, 3):
                    if ax == axis:
                        idx[ax + 1] = csl
                        sel[ax + 1] = (slice(2 * gc + 2 - g, 2 * gc + 2)
                                       if lo else slice(2, 2 + g))
                    elif not act[ax]:
                        idx[ax + 1] = slice(0, n_of[ax])
                        sel[ax + 1] = slice(0, n_of[ax])
                    else:
                        o_t = g_of[ax] + ob[ax] * half_of[ax]
                        if ax in ext_axes:
                            idx[ax + 1] = slice(o_t - gc - 1,
                                                o_t + half_of[ax] + gc + 1)
                            sel[ax + 1] = slice(
                                2 * gc + 2 - g_of[ax],
                                2 * gc + 2 + n_of[ax] + g_of[ax])
                        else:
                            idx[ax + 1] = slice(o_t - 1,
                                                o_t + half_of[ax] + 1)
                            sel[ax + 1] = slice(2, 2 + n_of[ax])
                    sl = idx[ax + 1]
                    ext_full = (n_of[ax] + 2 * g_of[ax] if act[ax]
                                else n_of[ax])
                    clamped |= sl.start < 0 or sl.stop > ext_full
                ogroups.append((tuple(idx), d, s, clamped))
            if ogroups and not any(cl for *_, cl in ogroups):
                parts = [read(lev - 1, idx) for idx, *_ in ogroups]
                big = torch.cat(parts, dim=0) if len(parts) > 1 else parts[0]
                d_cat, s_cat = batch["coarse_cat"][face]
                fine = prolongate_minmod(big.index_select(0, s_cat),
                                         dims=self.ndim)
                slab.index_copy_(0, d_cat, fine[tuple(sel)])
                touched = True
            elif ogroups:
                # a read past the array's ends (nghost = 1 extents) changes
                # the strips' shapes per octant: one group at a time
                for idx, d, s, _ in ogroups:
                    fine = prolongate_minmod(
                        read(lev - 1, idx).index_select(0, s), dims=self.ndim)
                    slab.index_copy_(0, d, fine[tuple(sel)])
                touched = True

            # ---- physical boundaries (edge broadcast or mirror)
            if face in batch["phys"]:
                d = batch["phys"][face]
                b = sm.base
                bc = (b.ix1_bc, b.ox1_bc, b.ix2_bc, b.ox2_bc,
                      b.ix3_bc, b.ox3_bc)[face]
                if bc == "outflow":
                    esl = (slice(g, g + 1) if lo
                           else slice(g + n - 1, g + n))
                    edge = read(lev, vsl(esl)).index_select(0, d)
                    slab.index_copy_(0, d, edge.expand(
                        (d.numel(), self.nvar) + tuple(slab.shape[2:])))
                    touched = True
                elif bc == "reflecting":
                    mom_of_axis = {3: IM1, 2: IM2, 1: IM3}
                    msl = slice(g, 2 * g) if lo else slice(n, n + g)
                    mirror = torch.flip(read(lev, vsl(msl)).index_select(0, d),
                                        dims=(axis - 4,))
                    # the normal momentum flips sign (exactly the JAX
                    # package's multiply by -1)
                    mirror[:, mom_of_axis[axis]].neg_()
                    slab.index_copy_(0, d, mirror)
                    touched = True
                elif bc in self.custom_bcs:
                    custom_ops.append((bc, d, vsl(ghost)[2:], lo))
                else:
                    raise ValueError(
                        f"unsupported refined-mesh BC '{bc}' (periodic, "
                        "outflow, reflecting or a problem-registered one)")
            if touched:
                new_slabs[lo] = (vsl(ghost), slab)
        return new_slabs, custom_ops

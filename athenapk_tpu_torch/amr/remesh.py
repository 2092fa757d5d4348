"""Adaptive meshes (torch): retag -> forest update -> block-data transfer.

Counterpart of ``athenapk_tpu/amr/remesh.py`` on one device (Parthenon's
``Mesh::LoadBalancingAndAdaptiveMeshRefinement``, driven by the criteria
of ``refinement/criteria.py`` on ``<parthenon/mesh> refinement =
adaptive`` decks such as ``inputs/blast_3d_adaptive.in``):

1. evaluate the configured criterion per leaf block, on the device
   (``AmrHydro.dispatch_tags``; the caller reads the tags),
2. apply the tags to the native forest (2:1 balance and sibling-complete
   derefinement happen there),
3. transfer block data old -> new along the forest's transfer map, on the
   device: COPY (same leaf), PROLONG (minmod prolongation of one octant of
   an old coarse block, read with a one-cell halo), RESTRICT (average of
   the 2^d old children into the merged block),
4. regroup leaves by level and refill the ghosts.

Both transfer operators keep block means, so mass and energy are
conserved across a remesh to rounding.  The host groups the transfer map
by kind and octant into index tensors; the data moves as batched
``index_select`` / ``index_copy_`` and never passes through host numpy.
Every new level tensor is freshly allocated: the old state is only read.

A topology change is a host event (the reference reallocates MeshBlocks):
``AmrHydro`` keeps one ``SmrHydro`` per leaf table, whose ghost-fill and
flux-correction plans are built in Python loops over leaves, so a blast
that revisits a topology pays for its plans once.  Nothing is compiled per
topology.

``AmrHydro`` passes ``cooling``, ``custom_bcs`` and ``diffusion`` on to
every stepper, builds each leaf table's problem sources from the
factories, and combines the pgen's per-block refinement check
(``problem_check(prim, base) -> [nblocks] tags``) with the criterion's tags
by ``max``, in the same enqueued tag tensors (the JAX package's
``_tag_fn``).

Over ranks (``rmesh``, a ``parallel.mesh_sharding.RankMesh``): the
placements of the JAX package's sharded ``AmrHydro`` (``_FlatStepper``,
``_PaddedStepper``, ``_place``, ``exact_state``, ``device_leaf_counts``)
become explicit ownership (``amr/sharded.py``): ``layout="flat"`` deals all
levels' leaves in id order, exact to one leaf, ``"padded"`` chunks each
level.  Each rank holds its leaves' rows and steps them with a
``ShardedSmrHydro``; the tags are gathered (small vectors) so every rank
updates its forest alike, and ``transfer_sharded`` moves each new leaf's
rows from its old owner, which copies, prolongs or restricts them.  The
problem's unsplit source runs on the rank's rows, its sums over every
rank's leaves (``amr/leaf_sums.py``); the split sources are refused over
ranks, where the JAX package drops them.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch.profiler import record_function

from ..core.amr_forest import COPY, PROLONG, RESTRICT
from ..core.device import resolve_device
from ..eos.adiabatic import cons_to_prim
from ..refinement.criteria import check_refinement
from ..refinement.prolong_restrict import prolongate_minmod, restrict_average
from .sharded import (OWNERS, ShardedSmrHydro, gather, own_ids, place,
                      transfer_sharded)
from .smr import SmrMesh, SmrState
from .smr_hydro import SmrHydro


def _edge_pad(interior, base):
    """Replicate the interior into the ghost shell: face ghosts are refilled
    by the ghost fill; corner and edge ghosts are never read by the
    dimension-split update but must hold valid (non-zero-density) states.
    Inactive dimensions carry no ghosts."""
    return F.pad(interior, (base.ng1, base.ng1, base.ng2, base.ng2,
                            base.ng3, base.ng3), mode="replicate")


def transfer(smesh: SmrMesh, state, tags):
    """Apply per-leaf tags to the forest and move the block data; -> (new
    SmrMesh, ``{level: tensor}`` whose interiors are valid and whose ghosts
    are not filled).

    ``state``: ``{level: [nb_level, nvar, NZ, NY, NX]}`` whose ghosts are
    valid (prolongation reads a one-cell halo of the coarse octant).
    ``tags``: int array over the old mesh's global leaf ids.  The forest
    update runs in the profiler range ``remesh_forest``.
    """
    base = smesh.base
    ndim = base.ndim
    nz, ny, nx = base.mbnx3, base.mbnx2, base.mbnx1
    g3, g2, g1 = base.ng3, base.ng2, base.ng1
    act2, act3 = base.nx2 > 1, base.nx3 > 1
    hz = nz // 2 if act3 else nz
    hy = ny // 2 if act2 else ny
    hx = nx // 2
    noct = 1 << ndim
    isl = (slice(None), slice(None), slice(g3, g3 + nz),
           slice(g2, g2 + ny), slice(g1, g1 + nx))

    # the old table, before the forest changes under it
    old_by_loc = dict(smesh._by_loc)
    old_li = {int(gid): li for ids in smesh.level_ids.values()
              for li, gid in enumerate(ids)}
    first = next(iter(state.values()))
    nvar, dtype, device = first.shape[1], first.dtype, first.device

    with record_function("remesh_forest"):
        kind, old_id, octant = smesh.forest.update(
            np.ascontiguousarray(tags, np.int32))
        new_sm = SmrMesh.from_forest(base, smesh.forest)

    def ix(a):
        return torch.as_tensor(np.asarray(a, np.int64), device=device)

    new_state = {}
    for lev, ids in new_sm.level_ids.items():
        # ---- the transfer map grouped by kind and octant (host, indices)
        copy_dst, copy_src = [], []
        pro = {oc: ([], []) for oc in range(noct)}   # octant -> (dst, src)
        res_dst = []
        res_kids = {oc: [] for oc in range(noct)}    # octant -> old fine li
        for li, gid in enumerate(ids):
            k = int(kind[gid])
            if k == COPY:
                copy_dst.append(li)
                copy_src.append(old_li[int(old_id[gid])])
            elif k == PROLONG:
                oc = int(octant[gid])
                pro[oc][0].append(li)
                pro[oc][1].append(old_li[int(old_id[gid])])
            elif k == RESTRICT:
                a, b, c = (int(new_sm.lx1[gid]), int(new_sm.lx2[gid]),
                           int(new_sm.lx3[gid]))
                res_dst.append(li)
                for oc in range(noct):
                    cx, cy, cz = oc & 1, (oc >> 1) & 1, (oc >> 2) & 1
                    kid = old_by_loc[(lev + 1, 2 * a + cx,
                                      (2 * b if act2 else b) + cy,
                                      (2 * c if act3 else c) + cz)]
                    res_kids[oc].append(old_li[kid])
            else:  # pragma: no cover
                raise RuntimeError(f"unknown transfer kind {k}")

        # ---- batched device transfers into a fresh tensor (every row is
        # written by exactly one of the three kinds)
        out = torch.empty((len(ids), nvar) + base.block_shape, dtype=dtype,
                          device=device)
        if copy_dst:
            out.index_copy_(0, ix(copy_dst),
                            state[lev].index_select(0, ix(copy_src)))
        for oc in range(noct):
            dst, src = pro[oc]
            if not dst:
                continue
            ox, oy, oz = oc & 1, (oc >> 1) & 1, (oc >> 2) & 1
            reg = state[lev - 1][
                :, :,
                (slice(g3 + oz * hz - 1, g3 + (oz + 1) * hz + 1)
                 if act3 else slice(0, nz)),
                (slice(g2 + oy * hy - 1, g2 + (oy + 1) * hy + 1)
                 if act2 else slice(0, ny)),
                slice(g1 + ox * hx - 1, g1 + (ox + 1) * hx + 1)
            ].index_select(0, ix(src))
            fine = prolongate_minmod(reg, dims=ndim)
            # fine covers virtual cells [-2, n + 2) on active dims;
            # the interior is [2, n + 2)
            interior = fine[:, :,
                            slice(2, nz + 2) if act3 else slice(0, nz),
                            slice(2, ny + 2) if act2 else slice(0, ny),
                            slice(2, nx + 2)]
            out.index_copy_(0, ix(dst), _edge_pad(interior, base))
        if res_dst:
            merged = torch.empty((len(res_dst), nvar, nz, ny, nx),
                                 dtype=dtype, device=device)
            for oc in range(noct):
                cx, cy, cz = oc & 1, (oc >> 1) & 1, (oc >> 2) & 1
                kids = state[lev + 1][isl].index_select(0, ix(res_kids[oc]))
                merged[:, :, cz * hz:(cz + 1) * hz, cy * hy:(cy + 1) * hy,
                       cx * hx:(cx + 1) * hx] = restrict_average(kids,
                                                                 dims=ndim)
            out.index_copy_(0, ix(res_dst), _edge_pad(merged, base))
        new_state[lev] = out
    return new_sm, new_state


def remesh(smesh: SmrMesh, state, tags, custom_bcs=None):
    """Apply per-leaf tags; -> (new SmrMesh, transferred state with its
    ghosts filled by a new ``SmrState`` on the state's device).
    ``AmrHydro`` fills through its cached stepper of the new topology
    instead."""
    new_sm, new_state = transfer(smesh, state, tags)
    first = next(iter(new_state.values()))
    return new_sm, SmrState(new_sm, first.shape[1], first.device,
                            custom_bcs=custom_bcs).fill_ghosts(new_state)


class AmrHydro:
    """Adaptive-mesh hydro on one device or over ranks (``rmesh``,
    ``layout``): step plus periodic retag and remesh, with one ``SmrHydro``
    (over ranks ``ShardedSmrHydro``) cached per leaf table.

    ``remesh_log`` keeps, per remesh, whether the leaf table changed and
    whether its topology was new.  A remesh runs in profiler ranges:
    ``remesh_transfer`` (the forest update, in ``remesh_forest``, and the
    blocks' move), ``remesh_plans`` (the stepper of the leaf table, its
    plans built where the topology is new) and ``remesh_fill`` (the ghost
    fill); its tags reach the host in a ``host_read``.

    The problem's sources depend on the leaves' coordinates, so each new
    leaf table builds its own from the factories (``factory(smesh)``; the
    JAX package's ``athenapk_tpu/amr/remesh.py:379-450``): the unsplit
    source ``src(state, prims, beta_dt, t)``, and the first-order and
    Strang split sources ``src(state, dt, t)`` that the driver applies.
    Over ranks the unsplit factory is called as ``factory(smesh,
    leaves=...)`` with the rank's ``amr.leaf_sums.LeafSums`` (its rows and
    the sums over every rank's leaves); the split factories are refused.
    """

    def __init__(self, smesh: SmrMesh, cfg, eos, refine_cfg,
                 check_interval=1, derefine_count=10, device="cuda",
                 cooling=None, custom_bcs=None, problem_check=None,
                 diffusion=None, problem_source_factory=None,
                 problem_first_order_factory=None,
                 problem_strang_factory=None, rmesh=None, layout="flat"):
        if layout not in OWNERS:
            raise ValueError(f"unknown AMR layout {layout!r}")
        if rmesh is not None and (problem_first_order_factory is not None
                                  or problem_strang_factory is not None):
            raise ValueError(
                "split problem sources (first-order, Strang) do not run "
                "over ranks: the JAX package's sharded AmrHydro drops them "
                "without a word (athenapk_tpu/amr/remesh.py:184-189); the "
                "port refuses them instead of stepping without them")
        # ranks over the leaves (parallel.mesh_sharding.RankMesh) and their
        # ownership: "flat" (exact to one leaf) or "padded" (per level)
        self.rmesh = rmesh
        self.layout = layout
        self._owner = (OWNERS[layout](smesh, rmesh.world)
                       if rmesh is not None else None)
        self.smesh = smesh
        self.cfg = cfg
        self.eos = eos
        self.cooling = cooling
        self.diffusion = diffusion
        self.problem_source_factory = problem_source_factory
        self.problem_first_order_factory = problem_first_order_factory
        self.problem_strang_factory = problem_strang_factory
        self.custom_bcs = custom_bcs
        self.problem_check = problem_check
        self.device = resolve_device(device)
        self.refine_cfg = refine_cfg
        self.check_interval = max(1, int(check_interval))
        # a leaf must ask for derefinement this many CONSECUTIVE checks
        # before it may merge (Parthenon's derefine_count: damps flapping
        # at marginal criteria)
        self.derefine_count = max(1, int(derefine_count))
        self._deref_counts = {}
        self._steppers = {}
        self.remesh_log = []
        self._stage_rung = None   # the first stepper's, kept for the run
        self._stepper = self._get_stepper()
        self._stage_rung = self._stepper._stage_rung

    def _signature(self):
        """The whole leaf table: ghost plans and flux-correction sites
        depend on the topology, not only on the per-level counts."""
        sm = self.smesh
        return (sm.levels.tobytes(), sm.lx1.tobytes(), sm.lx2.tobytes(),
                sm.lx3.tobytes())

    def _get_stepper(self):
        sig = self._signature()
        st = self._steppers.get(sig)
        if st is None:
            def build(factory):
                return factory(self.smesh) if factory is not None else None

            if self.rmesh is not None:
                st = ShardedSmrHydro(
                    self.smesh, self.cfg, self.eos, self._owner, self.rmesh,
                    device=self.device, stage_rung=self._stage_rung,
                    cooling=self.cooling, custom_bcs=self.custom_bcs,
                    diffusion=self.diffusion,
                    problem_source_factory=self.problem_source_factory)
            else:
                st = SmrHydro(
                    self.smesh, self.cfg, self.eos, device=self.device,
                    stage_rung=self._stage_rung, cooling=self.cooling,
                    custom_bcs=self.custom_bcs, diffusion=self.diffusion,
                    problem_source_unsplit=build(
                        self.problem_source_factory),
                    problem_source_first_order=build(
                        self.problem_first_order_factory),
                    problem_source_strang=build(self.problem_strang_factory))
            self._steppers[sig] = st
        return st

    # ------------------------------------------------------------------ tags
    def _level_tags(self, u):
        _, prim = cons_to_prim(self.eos, u, self.cfg.fluid, self.cfg.nscalars)
        tags = check_refinement(self.refine_cfg, prim, self.smesh.base)
        if self.problem_check is not None:
            tags = torch.maximum(tags, self.problem_check(
                prim, self.smesh.base).to(tags.dtype))
        return tags

    def dispatch_tags(self, state):
        """The per-level tags, enqueued on the device and NOT read: ->
        ``[(leaf_ids, int32 tensor)]``.  The driver reads them together
        with the next cycle's dt.  Sharded: the rank's own leaves."""
        if self.rmesh is not None:
            own = own_ids(self.smesh, self._owner, self.rmesh.rank)
            return [(own[lev], self._level_tags(state[lev]))
                    for lev in self.smesh.level_ids if lev in state]
        state = self.exact_state(state)
        return [(ids, self._level_tags(state[lev]))
                for lev, ids in self.smesh.level_ids.items()]

    def assemble_tags(self, parts, flat=None):
        """Global tag array of ``dispatch_tags``' parts.  ``flat``: their
        values already on the host, concatenated in order; otherwise they
        are read here, in one read.  Sharded: every rank's small tag
        vector is gathered (each rank's leaves, in level then id order,
        are known to all) and read once, so every rank holds the same
        global array after as many host reads as one rank."""
        tags = np.zeros(self.smesh.levels.size, np.int32)
        if self.rmesh is not None:
            mine = (torch.cat([t for _, t in parts]) if flat is None
                    else torch.as_tensor(np.asarray(flat, np.int32)))
            ids = [np.concatenate(list(own_ids(self.smesh, self._owner,
                                               r).values()))
                   for r in range(self.rmesh.world)]
            got = self.rmesh.all_gather(mine.to(torch.int32),
                                        sizes=[i.size for i in ids])
            gathered = torch.cat(got)
            with record_function("host_read"):
                tags[np.concatenate(ids)] = gathered.cpu().numpy()
            return tags
        if flat is None:
            mine = torch.cat([t for _, t in parts])
            with record_function("host_read"):
                flat = mine.cpu().numpy()
        o = 0
        for ids, _ in parts:
            tags[ids] = flat[o:o + ids.size]
            o += ids.size
        return tags

    def compute_tags(self, state):
        """Global per-leaf tag array from the configured criterion."""
        return self.assemble_tags(self.dispatch_tags(state))

    # --------------------------------------------------------------- evolve
    def maybe_remesh(self, state, tags=None):
        """Apply the derefinement counters to the tags and remesh if any
        tag is left; -> (state, whether the leaf table changed).

        ``tags``: the global tag array of THIS state, if the caller has it
        (the driver reads it with the cycle's dt); otherwise computed and
        read here."""
        if tags is None:
            tags = self.compute_tags(state)
        tags = np.array(tags, np.int32)
        # counters keyed by leaf location, so they survive remeshes of
        # other blocks
        sm = self.smesh
        new_counts = {}
        for i in np.nonzero(tags < 0)[0]:
            key = (int(sm.levels[i]), int(sm.lx1[i]), int(sm.lx2[i]),
                   int(sm.lx3[i]))
            c = self._deref_counts.get(key, 0) + 1
            new_counts[key] = c
            if c < self.derefine_count:
                tags[i] = 0
        self._deref_counts = new_counts
        if not tags.any():
            return state, False
        old_sig = self._signature()
        with record_function("remesh_transfer"):
            if self.rmesh is not None:
                self.smesh, self._owner, new_state = transfer_sharded(
                    sm, state, tags, self._owner,
                    lambda m: OWNERS[self.layout](m, self.rmesh.world),
                    self.rmesh)
            else:
                self.smesh, new_state = transfer(sm, self.exact_state(state),
                                                 tags)
        sig = self._signature()
        log = {"changed": sig != old_sig,
               "new_topology": sig not in self._steppers}
        with record_function("remesh_plans"):
            self._stepper = self._get_stepper()
        with record_function("remesh_fill"):
            state = self._stepper.fill_ghosts(new_state)
        self.remesh_log.append(log)
        return state, log["changed"]

    def advance(self, state, ncycles, c_h=0.0):
        """``ncycles`` of (maybe_remesh -> dt -> step); a sharded run takes
        a whole state or the rank's rows and returns the rank's rows."""
        state = self._place(state)
        for n in range(ncycles):
            if n % self.check_interval == 0:
                state, _ = self.maybe_remesh(state)
            dt_dev = self._stepper.estimate_dt(state)
            with record_function("host_read"):
                dt = float(dt_dev)
            state = self._stepper.step(state, dt, c_h)
        return state

    # ------------------------------------------------ sharded placement
    def _place(self, state):
        """The rank's rows: a whole ``{level: [n_leaves, ...]}`` state is
        split by the ownership; the rank's rows come back as they are
        (idempotent).  One device: the state itself."""
        if self.rmesh is None:
            return state
        own = own_ids(self.smesh, self._owner, self.rmesh.rank)
        mine = {lev for lev, ids in own.items() if ids.size}
        if set(state) == mine and all(state[lev].shape[0] == own[lev].size
                                      for lev in mine):
            return state
        for lev, ids in self.smesh.level_ids.items():
            if lev not in state or state[lev].shape[0] != ids.size:
                raise ValueError(f"level {lev}: neither the rank's rows nor "
                                 "the whole level")
        return place(state, self.smesh, self._owner, self.rmesh.rank)

    def device_leaf_counts(self, state):
        """``{rank: real leaves}`` from the rows each rank holds (one
        device: ``{device: leaves}``)."""
        n = sum(v.shape[0] for v in state.values())
        if self.rmesh is None:
            return {str(self.device): n}
        got = self.rmesh.all_gather(torch.tensor([n]))
        return {r: int(v[0]) for r, v in enumerate(got)}

    def exact_state(self, state):
        """``{level: [n_leaves_level, ...]}``.  One device holds no slot
        padding, so this checks the counts and returns the state; sharded,
        it gathers every rank's rows (tests, outputs; the step never
        does)."""
        if self.rmesh is not None:
            return gather(self._place(state), self.smesh, self._owner,
                          self.rmesh)
        for lev, ids in self.smesh.level_ids.items():
            if state[lev].shape[0] != ids.size:
                raise ValueError(f"level {lev}: {state[lev].shape[0]} blocks "
                                 f"for {ids.size} leaves")
        return state

    def total_mass(self, state):
        return self._stepper.total_mass(state)

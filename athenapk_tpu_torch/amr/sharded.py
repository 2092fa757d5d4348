"""Refined meshes over ranks: leaf ownership, what each rank's fill reads
of the others' rows, the sharded step and the sharded remesh transfer.

Counterpart of the JAX package's sharded placements
(``athenapk_tpu/amr/remesh.py``: ``_PaddedStepper`` :167-227,
``_FlatStepper`` :229-366, ``_place`` / ``exact_state`` /
``device_leaf_counts`` :556-633), which leave the row moves to GSPMD.  Here
ownership is explicit: ``owner[gid]`` is the rank of each leaf, and a rank
holds ``{level: [its leaves of the level, in id order, ...]}``.

* ``flat`` deals all levels' leaves in the forest's id order (its
  space-filling curve): rank ``i`` owns ``N//D + (i < N%D)`` contiguous
  leaves (Parthenon's SFC chunk balancing, exact to one leaf);
* ``padded`` chunks each level: ``ceil(c/D)`` leaves of a level per rank
  (the JAX package's slot padding without the pad rows, which explicit
  ranks do not need).

The ghost fill (``ShardedSmrState``) runs the one-device fill's steps
(``SmrState.fill_steps``) on "owned + received" level arrays: the rank's
rows first, then a row for each other rank's leaf that its plans read
(same-level neighbours, coarse parents, fine children).  Of such a row
only the boxes the steps read are sent: the g-deep slab behind a
same-level face, the children's 2g-deep strips, the parent's octant strip
(``_reads``, the bounds of ``SmrState._assemble_axis``'s reads); the rest
of the row stays NaN.  The steps read ghosts that earlier steps of the
same fill wrote on the neighbours, so a box is sent before each step that
reads it, unless the reader holds a box that covers it and that no step
since has written into.  The schedule is fixed per leaf table
(``fill_values_sent``); each rank sends less than an all-gather of its
rows would (``parallel.dryrun.fill_send_bounds``).  The coarse-fine flux
correction receives the fine children's face slabs for the coarse owner
(``ShardedSmrHydro``), the dt is the minimum over ranks and the mass the
sum.

A remesh (``transfer_sharded``): every rank applies the same global tags
to its own copy of the forest; each new leaf's rows are made by the old
owner of its source (copied, prolonged, or for a merged block each child's
restricted octant) and sent to its new owner, which assembles them as the
one-device ``remesh.transfer`` does.  Every real row equals the one-device
run bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.amr_forest import COPY, PROLONG, RESTRICT
from ..refinement.prolong_restrict import prolongate_minmod, restrict_average
from .smr import SmrMesh, SmrState
from .smr_hydro import SmrHydro


def flat_owners(smesh: SmrMesh, world: int):
    """Rank of each leaf: all levels dealt in id (SFC) order, exact to one
    leaf."""
    N = smesh.levels.size
    n = np.full(world, N // world, np.int64)
    n[: N % world] += 1
    return np.repeat(np.arange(world), n)


def padded_owners(smesh: SmrMesh, world: int):
    """Rank of each leaf: ``ceil(c/D)`` leaves of each level per rank."""
    owner = np.zeros(smesh.levels.size, np.int64)
    for ids in smesh.level_ids.values():
        s = -(-ids.size // world)
        owner[ids] = np.arange(ids.size) // s
    return owner


OWNERS = {"flat": flat_owners, "padded": padded_owners}


def own_ids(smesh: SmrMesh, owner, rank: int):
    """``{level: ids of the level owned by rank}`` (possibly empty)."""
    return {lev: ids[owner[ids] == rank]
            for lev, ids in smesh.level_ids.items()}


def _sources(kind, payload):
    """The leaves a plan op reads."""
    if kind == "same":
        return [payload]
    if kind == "coarse":
        return [payload[0]]
    if kind == "fine":
        return [kid for _, kid in payload]
    return []


def _covers(a, b):
    """Box ``a`` holds box ``b`` (boxes: ((lo, hi),) * 3)."""
    return all(p <= q and s >= t for (p, s), (q, t) in zip(a, b))


def _meets(a, b):
    """Boxes ``a`` and ``b`` share a cell."""
    return all(p < t and q < s for (p, s), (q, t) in zip(a, b))


class ShardedSmrState(SmrState):
    """The ghost fill of one rank's rows (see the module docstring)."""

    def __init__(self, smesh: SmrMesh, nvar: int, owner, rmesh,
                 device="cuda", custom_bcs=None):
        self.owner = np.asarray(owner)
        self.rmesh = rmesh
        self.own = own_ids(smesh, self.owner, rmesh.rank)
        super().__init__(smesh, nvar, device, custom_bcs=custom_bcs)
        self._sched, self.fill_values_sent = self._build_schedule()

    def _plan_ids(self, lev):
        return self.own[lev]

    def _locations(self):
        halo = {lev: set() for lev in self.smesh.level_ids}
        for ops in self._plans.values():
            for (_, _, kind, payload) in ops:
                for s in _sources(kind, payload):
                    if self.owner[s] != self.rmesh.rank:
                        halo[int(self.smesh.levels[s])].add(int(s))
        self.halo = {lev: np.array(sorted(h), np.int64)
                     for lev, h in halo.items()}
        loc = {}
        for lev in self.smesh.level_ids:
            for i, gid in enumerate(self.own[lev]):
                loc[int(gid)] = (lev, i)
            n = self.own[lev].size
            for j, gid in enumerate(self.halo[lev]):
                loc[int(gid)] = (lev, n + j)
        return loc

    def level_rows(self, lev):
        if lev not in self.own:
            return 0
        return self.own[lev].size + self.halo[lev].size

    def _tbox(self, ax, ext):
        """Extent of a transverse axis in a read: ghost-extended or the
        interior."""
        n, g = self.n_of[ax], self.g_of[ax]
        if not self.act[ax]:
            return (0, n)
        return (0, n + 2 * g) if ext else (g, g + n)

    def _reads(self, axis, ext_axes, face, kind, payload):
        """``[(leaf, box)]``: what one plan op of a fill step on ``axis``
        reads from other leaves, ``box`` the ``((z0, z1), (y0, y1), (x0,
        x1))`` of the ghosted row that bounds ``SmrState._assemble_axis``'s
        reads (same-level g-deep slabs, the children's 2g-deep strips, the
        parent's octant strip)."""
        n, g = self.n_of[axis], self.g_of[axis]
        lo = face % 2 == 0
        box = {}
        if kind == "same":
            for ax in (1, 2, 3):
                box[ax] = self._tbox(ax, ax in ext_axes)
            box[axis] = (n, n + g) if lo else (g, 2 * g)
            out = [(payload, box)]
        elif kind == "fine":
            fr = g // 2
            for ax in (1, 2, 3):
                box[ax] = self._tbox(ax, False)
                if self.act[ax] and ax in ext_axes and fr > 0:
                    gt, nt = self.g_of[ax], self.n_of[ax]
                    box[ax] = (gt - 2 * fr, gt + nt + 2 * fr)
            box[axis] = (n - g, n + g) if lo else (g, 3 * g)
            out = [(kid, box) for _, kid in payload]
        elif kind == "coarse":
            gid, oc = payload
            ob = self._obit(oc)
            gc = (g + 1) // 2
            for ax in (1, 2, 3):
                if not self.act[ax]:
                    box[ax] = (0, self.n_of[ax])
                    continue
                hf = self.half_of[ax]
                o = self.g_of[ax] + ob[ax] * hf
                if ax == axis:
                    b = (o + hf - gc - 1, o + hf + 1) if lo \
                        else (o - 1, o + gc + 1)
                elif ax in ext_axes:
                    b = (o - gc - 1, o + hf + gc + 1)
                else:
                    b = (o - 1, o + hf + 1)
                box[ax] = (max(b[0], 0),
                           min(b[1], self.n_of[ax] + 2 * self.g_of[ax]))
            out = [(gid, box)]
        else:
            out = []
        return [(int(s), (b[1], b[2], b[3])) for s, b in out]

    def _written(self, axis, ext_axes):
        """The boxes a fill step on ``axis`` writes: its two ghost slabs."""
        n, g = self.n_of[axis], self.g_of[axis]
        out = []
        for gsl in ((0, g), (g + n, n + 2 * g)):
            b = {ax: self._tbox(ax, ax in ext_axes) for ax in (1, 2, 3)}
            b[axis] = gsl
            out.append((b[1], b[2], b[3]))
        return out

    def _build_schedule(self):
        """Per fill step ``(sends, recvs)``: ``[(peer, [(level, box
        slices, row index tensor)], n values)]`` in message order, from
        every rank's plans (the same on every rank).  A box of a remote
        leaf is sent before a step that reads it unless the reader holds a
        box that covers it and that no step since has written into."""
        sm, owner, me = self.smesh, self.owner, self.rmesh.rank
        ops = {}
        for lev, ids in sm.level_ids.items():
            for (li, face, kind, payload) in self._build_plan(lev, ids):
                r = int(owner[ids[li]])
                if any(owner[s] != r for s in _sources(kind, payload)):
                    ops.setdefault((lev, 3 - face // 2), []).append(
                        (r, face, kind, payload))
        writes = {lev: [] for lev in sm.level_ids}
        held = {}
        sched, sent = [], 0
        for k, (lev, axis, ext_axes, phys_only) in \
                enumerate(self.fill_steps()):
            send, recv = {}, {}
            for (r, face, kind, payload) in \
                    ([] if phys_only else ops.get((lev, axis), [])):
                for s, box in self._reads(axis, ext_axes, face, kind,
                                          payload):
                    o = int(owner[s])
                    if o == r:
                        continue
                    sl = int(sm.levels[s])
                    if any(_covers(hb, box) and not any(
                            kw >= hk and _meets(wb, box)
                            for kw, wb in writes[sl])
                           for hb, hk in held.get((r, s), ())):
                        continue
                    held.setdefault((r, s), []).append((box, k))
                    if r == me:
                        recv.setdefault(o, {}).setdefault(
                            (sl, box), []).append(s)
                    elif o == me:
                        send.setdefault(r, {}).setdefault(
                            (sl, box), []).append(s)
            sched.append((self._parts(send), self._parts(recv)))
            sent += sum(n for _, _, n in sched[-1][0])
            writes[lev].extend((k, b) for b in self._written(axis,
                                                             ext_axes))
        return sched, sent

    def _parts(self, by_peer):
        """``[(peer, [(level, slices, row index tensor)], n values)]`` of
        ``{peer: {(level, box): [leaves]}}``, groups in (level, box) order
        and rows in id order on both sides of each message."""
        out = []
        for peer, groups in sorted(by_peer.items()):
            parts, n = [], 0
            for (lev, box), gids in sorted(groups.items()):
                rows = [self.loc_of[g][1] for g in sorted(gids)]
                sl = (slice(None), slice(None)) + tuple(
                    slice(a, b) for a, b in box)
                parts.append((lev, sl, self.index(rows)))
                n += len(rows) * self.nvar * int(np.prod(
                    [b - a for a, b in box]))
            out.append((peer, parts, n))
        return out

    def _exchange(self, ext, send, recv):
        like = next(iter(ext.values()))
        got = self.rmesh.sendrecv(
            [(peer, torch.cat([ext[lev][sl].index_select(0, ix).reshape(-1)
                               for lev, sl, ix in parts]), 0)
             for peer, parts, _ in send],
            [(peer, (n,), like.dtype, 0) for peer, _, n in recv])
        for (_, parts, _), buf in zip(recv, got):
            o = 0
            for lev, sl, ix in parts:
                view = ext[lev][sl]
                shape = (ix.numel(),) + tuple(view.shape[1:])
                k = int(np.prod(shape))
                view.index_copy_(0, ix, buf[o:o + k].reshape(shape))
                o += k

    def fill_ghosts(self, state):
        """``{level: this rank's rows}`` -> the same rows ghost-filled (new
        tensors where the level has received rows, else in place)."""
        like = next(iter(state.values()))
        ext = {}
        for lev in self.smesh.level_ids:
            n_own, n_halo = self.own[lev].size, self.halo[lev].size
            if n_halo == 0:
                if n_own:
                    ext[lev] = state[lev]
                continue
            # received rows hold only the boxes sent; the rest is NaN, so
            # a read outside them shows in the result
            e = torch.full((n_own + n_halo,) + tuple(like.shape[1:]),
                           float("nan"), dtype=like.dtype, device=like.device)
            if n_own:
                e[:n_own] = state[lev]
            ext[lev] = e
        for step, (send, recv) in zip(self.fill_steps(), self._sched):
            if send or recv:
                self._exchange(ext, send, recv)
            if self.own[step[0]].size:
                self._fill_axis(ext, *step)
        return {lev: ext[lev][:self.own[lev].size] for lev in state}


class ShardedSmrHydro(SmrHydro):
    """``SmrHydro`` on one rank's rows: the per-level kernels run on the
    rank's leaves, the fill is ``ShardedSmrState``'s, the flux correction
    receives the remote fine children's face slabs, the dt is reduced with
    ``all_reduce(MIN)`` and ``total_mass`` with ``all_reduce(SUM)``.  It
    takes no problem source hooks: they reduce over leaves."""

    def __init__(self, smesh: SmrMesh, cfg, eos, owner, rmesh,
                 device="cuda", stage_rung=None, cooling=None,
                 custom_bcs=None, diffusion=None):
        self.owner = np.asarray(owner)
        self.rmesh = rmesh
        if not (self.owner == rmesh.rank).any():
            raise ValueError(f"rank {rmesh.rank} owns no leaf of the "
                             f"{smesh.levels.size} (fewer leaves than ranks)")
        super().__init__(smesh, cfg, eos, device=device,
                         stage_rung=stage_rung, cooling=cooling,
                         custom_bcs=custom_bcs, diffusion=diffusion)
        self._slab_sched = self._build_slab_schedule()

    def _make_state_mgr(self, custom_bcs):
        return ShardedSmrState(self.smesh, self.cfg.nvar, self.owner,
                               self.rmesh, self.device, custom_bcs=custom_bcs)

    def _build_slab_schedule(self):
        """``(sends, recvs)`` of the fine face slabs the coarse owners
        read: ``[(peer, [((level, direction), row index tensor)])]``, in
        the same order on both sides of each message."""
        sm, owner, me = self.smesh, self.owner, self.rmesh.rank
        need = {}
        for lev, ids in sm.level_ids.items():
            for (li, face, kind, payload) in \
                    self.state_mgr._build_plan(lev, ids):
                if kind != "fine":
                    continue
                r = int(owner[ids[li]])
                for _, kid in payload:
                    if owner[kid] != r:
                        need.setdefault(r, set()).add(
                            (lev + 1, face // 2 + 1, int(kid)))
        send, recv = {}, {}
        for r, keys in need.items():
            for (L, d, kid) in sorted(keys):
                o = int(owner[kid])
                if r == me:
                    recv.setdefault(o, []).append((L, d, kid))
                elif o == me:
                    send.setdefault(r, []).append((L, d, kid))
        loc = self.state_mgr.loc_of

        def parts(by_peer):
            out = []
            for peer, keys in sorted(by_peer.items()):
                groups = {}
                for (L, d, kid) in keys:
                    groups.setdefault((L, d), []).append(loc[kid][1])
                out.append((peer, [(k, self.state_mgr.index(v))
                                   for k, v in sorted(groups.items())]))
            return out

        return parts(send), parts(recv)

    def _slab_shape(self, d, like):
        b = self.smesh.base
        nz, ny, nx = b.block_shape
        return {1: (like.shape[1], nz, ny, 2), 2: (like.shape[1], nz, nx, 2),
                3: (like.shape[1], ny, nx, 2)}[d]

    def _slab_flux_correct(self, targets, slabs, scale=1.0):
        send, recv = self._slab_sched
        if send or recv:
            like = next(iter(next(iter(slabs.values())).values()))
            got = self.rmesh.sendrecv(
                [(peer, torch.cat([slabs[L][d].index_select(0, ix).reshape(-1)
                                   for (L, d), ix in p]), 1)
                 for peer, p in send],
                [(peer, (sum(ix.numel() * int(np.prod(
                    self._slab_shape(d, like))) for (_, d), ix in p),),
                  like.dtype, 1) for peer, p in recv])
            slabs = {L: dict(v) for L, v in slabs.items()}
            for (_, p), buf in zip(recv, got):
                o = 0
                for (L, d), ix in p:
                    shape = self._slab_shape(d, like)
                    k = ix.numel() * int(np.prod(shape))
                    ext = slabs.setdefault(L, {}).get(d)
                    rows = self.state_mgr.level_rows(L)
                    if ext is None or ext.shape[0] != rows:
                        full = torch.zeros((rows,) + shape, dtype=like.dtype,
                                           device=like.device)
                        if ext is not None:
                            full[:ext.shape[0]] = ext
                        slabs[L][d] = ext = full
                    ext.index_copy_(0, ix, buf[o:o + k].reshape(
                        (ix.numel(),) + shape))
                    o += k
        return super()._slab_flux_correct(targets, slabs, scale)

    def _global_min(self, t):
        return self.rmesh.all_reduce(t.reshape(1), "min").reshape(())

    def total_mass(self, state):
        local = torch.tensor([super().total_mass(state)],
                             dtype=torch.float64)
        return float(self.rmesh.all_reduce(local, "sum"))


def place(state, smesh: SmrMesh, owner, rank: int):
    """The rank's rows of a whole ``{level: [n_leaves, ...]}`` state."""
    own = own_ids(smesh, owner, rank)
    out = {}
    for lev, ids in smesh.level_ids.items():
        if own[lev].size:
            rows = np.searchsorted(ids, own[lev])
            out[lev] = state[lev][torch.as_tensor(
                rows, device=state[lev].device)]
    return out


def gather(state, smesh: SmrMesh, owner, rmesh):
    """The whole ``{level: [n_leaves, ...]}`` state from every rank's rows
    (for tests, outputs and the dry run; the step never gathers)."""
    like = next(iter(state.values()))
    out = {}
    for lev, ids in smesh.level_ids.items():
        mine = state.get(lev)
        if mine is None:
            mine = like.new_empty((0,) + tuple(like.shape[1:]))
        parts = rmesh.all_gather(mine)
        full = like.new_empty((ids.size,) + tuple(like.shape[1:]))
        for r, p in enumerate(parts):
            rows = np.searchsorted(ids, ids[owner[ids] == r])
            if rows.size:
                full[torch.as_tensor(rows, device=full.device)] = p
        out[lev] = full
    return out


def transfer_sharded(smesh: SmrMesh, state, tags, owner, owners_fn, rmesh):
    """``remesh.transfer`` over ranks: -> (new SmrMesh, the new owners,
    ``{level: this rank's new rows}`` with valid interiors and unfilled
    ghosts).  ``state``: the rank's ghost-filled rows under ``owner``;
    ``tags``: the global tag array (the same on every rank);
    ``owners_fn(new_smesh)``: the new ownership."""
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
    from .remesh import _edge_pad

    me = rmesh.rank
    old_by_loc = dict(smesh._by_loc)
    old_own = own_ids(smesh, owner, me)
    old_row = {int(g): i for ids in old_own.values()
               for i, g in enumerate(ids)}
    like = next(iter(state.values()))
    nvar, dtype, device = like.shape[1], like.dtype, like.device

    kind, old_id, octant = smesh.forest.update(
        np.ascontiguousarray(tags, np.int32))
    new_sm = SmrMesh.from_forest(base, smesh.forest)
    new_owner = owners_fn(new_sm)

    def ix(a):
        return torch.as_tensor(np.asarray(a, np.int64), device=device)

    # ---- what each new leaf needs: ("row", src) or ("oct", kid, oc)
    needs = {}
    for lev, ids in new_sm.level_ids.items():
        for gid in ids:
            k = int(kind[gid])
            if k in (COPY, PROLONG):
                needs[int(gid)] = [("row", int(old_id[gid]))]
            elif k == RESTRICT:
                a, b, c = (int(new_sm.lx1[gid]), int(new_sm.lx2[gid]),
                           int(new_sm.lx3[gid]))
                lst = []
                for oc in range(noct):
                    cx, cy, cz = oc & 1, (oc >> 1) & 1, (oc >> 2) & 1
                    kid = old_by_loc[(lev + 1, 2 * a + cx,
                                      (2 * b if act2 else b) + cy,
                                      (2 * c if act3 else c) + cz)]
                    lst.append(("oct", int(kid), oc))
                needs[int(gid)] = lst
            else:  # pragma: no cover
                raise RuntimeError(f"unknown transfer kind {k}")

    # ---- pieces this rank makes from its old rows, batched as
    # remesh.transfer batches them
    rows_made, octs_made = {}, {}
    for lev, ids in new_sm.level_ids.items():
        cp, pro, res = [], {}, {}
        for gid in ids:
            gid = int(gid)
            k = int(kind[gid])
            for item in needs[gid]:
                src = item[1]
                if owner[src] != me:
                    continue
                if k == COPY:
                    cp.append((gid, old_row[src]))
                elif k == PROLONG:
                    pro.setdefault(int(octant[gid]), []).append(
                        (gid, old_row[src]))
                else:
                    res.setdefault(item[2], []).append((gid, old_row[src]))
        if cp:
            got = state[lev].index_select(0, ix([r for _, r in cp]))
            for j, (gid, _) in enumerate(cp):
                rows_made[gid] = got[j]
        for oc, lst in pro.items():
            ox, oy, oz = oc & 1, (oc >> 1) & 1, (oc >> 2) & 1
            reg = state[lev - 1][
                :, :,
                (slice(g3 + oz * hz - 1, g3 + (oz + 1) * hz + 1)
                 if act3 else slice(0, nz)),
                (slice(g2 + oy * hy - 1, g2 + (oy + 1) * hy + 1)
                 if act2 else slice(0, ny)),
                slice(g1 + ox * hx - 1, g1 + (ox + 1) * hx + 1)
            ].index_select(0, ix([r for _, r in lst]))
            fine = prolongate_minmod(reg, dims=ndim)
            interior = fine[:, :,
                            slice(2, nz + 2) if act3 else slice(0, nz),
                            slice(2, ny + 2) if act2 else slice(0, ny),
                            slice(2, nx + 2)]
            padded = _edge_pad(interior, base)
            for j, (gid, _) in enumerate(lst):
                rows_made[gid] = padded[j]
        for oc, lst in res.items():
            kids = state[lev + 1][isl].index_select(0, ix([r for _, r in lst]))
            rest = restrict_average(kids, dims=ndim)
            for j, (gid, _) in enumerate(lst):
                octs_made[(gid, oc)] = rest[j]

    # ---- route the pieces to the new owners (message order: by id)
    def expected(dst, src_rank):
        rows, octs = [], []
        for gid in sorted(g for g in needs if new_owner[g] == dst):
            for item in needs[gid]:
                if owner[item[1]] != src_rank:
                    continue
                if item[0] == "row":
                    rows.append(gid)
                else:
                    octs.append((gid, item[2]))
        return rows, octs

    row_shape = (nvar,) + tuple(base.block_shape)
    oct_shape = (nvar, hz, hy, hx)
    sends, recvs, recv_keys = [], [], []
    for peer in range(rmesh.world):
        if peer == me:
            continue
        rows, octs = expected(peer, me)
        if rows:
            sends.append((peer, torch.stack([rows_made[g] for g in rows]), 0))
        if octs:
            sends.append((peer, torch.stack([octs_made[k] for k in octs]), 1))
        rows, octs = expected(me, peer)
        if rows:
            recvs.append((peer, (len(rows),) + row_shape, dtype, 0))
            recv_keys.append(rows)
        if octs:
            recvs.append((peer, (len(octs),) + oct_shape, dtype, 1))
            recv_keys.append(octs)
    for keys, buf in zip(recv_keys, rmesh.sendrecv(sends, recvs)):
        for j, key in enumerate(keys):
            (octs_made if isinstance(key, tuple) else rows_made)[key] = buf[j]

    # ---- assemble this rank's new rows (remesh.transfer's writes)
    new_own = own_ids(new_sm, new_owner, me)
    new_state = {}
    for lev, ids in new_own.items():
        if not ids.size:
            continue
        out = torch.empty((ids.size, nvar) + base.block_shape, dtype=dtype,
                          device=device)
        direct = [(i, int(g)) for i, g in enumerate(ids)
                  if int(kind[g]) != RESTRICT]
        if direct:
            out.index_copy_(0, ix([i for i, _ in direct]),
                            torch.stack([rows_made[g] for _, g in direct]))
        merged_rows = [(i, int(g)) for i, g in enumerate(ids)
                       if int(kind[g]) == RESTRICT]
        if merged_rows:
            merged = torch.empty((len(merged_rows), nvar, nz, ny, nx),
                                 dtype=dtype, device=device)
            for oc in range(noct):
                cx, cy, cz = oc & 1, (oc >> 1) & 1, (oc >> 2) & 1
                merged[:, :, cz * hz:(cz + 1) * hz, cy * hy:(cy + 1) * hy,
                       cx * hx:(cx + 1) * hx] = torch.stack(
                    [octs_made[(g, oc)] for _, g in merged_rows])
            out.index_copy_(0, ix([i for i, _ in merged_rows]),
                            _edge_pad(merged, base))
        new_state[lev] = out
    return new_sm, new_owner, new_state

"""Tracer particles on refined meshes, static and adaptive (the port's
counterpart of ``athenapk_tpu/tracers/smr_tracers.py``).

The buffers are per level, ``{lev: {field: [nb_lev, cap]}}`` like the fluid
state; interpolation is leaf-local at the leaf's own cell width; migration
routes particles across blocks and levels in one stable sort of the
concatenated pool.  The owner of a position comes from per-level lookup
tables (``tab[lev][c3, c2, c1]`` -> index in the level's batch, or -1),
walked finest to coarsest: the finest level with a leaf there wins (the
flat-array form of the reference forest's ``GetNeighborBlockIndex``).

Adaptive meshes: positions are global, so after a remesh that changes the
leaf table the new topology's ``SmrTracers`` re-bins the population
(``adopt``) with the same pool, sort and scatter.  (The reference refuses
tracers on adaptive meshes, ``src/tracers/tracers.cpp:77-79``; the JAX
package supports them this way.)

Dtypes and devices as in ``tracers.tracers``: float64 positions and fields,
int32 ids and ``n_lost``, every tensor on the simulation's device.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.device import resolve_device
from ..core.indices import GLMMHD, IV1, IV2, IV3
from .tracers import (F64, I32, sampled_components, trilinear,
                      wrap_periodic)


class SmrTracers:
    def __init__(self, pin, smesh, cfg, device="cuda"):
        self.enabled = pin.get_or_add_bool("tracers", "enabled", False)
        self.smesh = smesh
        self.mhd = cfg.fluid == GLMMHD
        # on the card unless the caller asks for the CPU
        self.device = resolve_device(device)
        if not self.enabled:
            return
        base = smesh.base
        if base.nx3 == 1:
            raise ValueError("tracers currently only supported in 3D "
                             "(matches reference)")
        self.seed_method = pin.get_or_add_string(
            "tracers", "initial_seed_method", "none")
        self.num_per_cell = pin.get_or_add_real(
            "tracers", "initial_num_tracers_per_cell", 0.0)
        self.rng_seed = pin.get_or_add_integer("tracers",
                                               "initial_rng_seed", 0)
        self.cap_factor = pin.get_or_add_real("tracers", "capacity_factor",
                                              2.0)
        self.levels = sorted(smesh.level_ids)
        # offsets of each level in the concatenated leaf order (sorted
        # levels, then batch order)
        self._leaf_off = {}
        c = 0
        for lev in self.levels:
            self._leaf_off[lev] = c
            c += len(smesh.level_ids[lev])
        self.total_leaves = c
        # per-level leaf origins and ownership tables
        self._orig = {}
        self._tab = {}
        for lev in self.levels:
            ids = smesh.level_ids[lev]
            org = np.array([smesh.block_origin(g) for g in ids])
            self._orig[lev] = tuple(torch.as_tensor(
                org[:, i], dtype=F64, device=self.device) for i in range(3))
            s1, s2, s3 = smesh._scales(lev)
            tab = np.full((base.nb3 * s3, base.nb2 * s2, base.nb1 * s1), -1,
                          np.int64)
            for i, g in enumerate(ids):
                tab[smesh.lx3[g], smesh.lx2[g], smesh.lx1[g]] = i
            self._tab[lev] = torch.as_tensor(tab, device=self.device)

    def _field_names(self):
        return list(sampled_components(self.mhd))

    def _names(self):
        return ["x", "y", "z", "id", "active"] + self._field_names()

    # ------------------------------------------------------------------ seed
    def seed(self):
        """Random-per-block seeding, one gid-seeded numpy stream per leaf
        (a finer leaf is smaller, so refined regions hold more tracers per
        volume, as in the reference)."""
        if self.seed_method == "none":
            return None
        if self.seed_method != "random_per_block":
            raise ValueError(f"Unknown tracer initial_seed_method "
                             f"'{self.seed_method}' (SMR supports "
                             "random_per_block)")
        base = self.smesh.base
        n_per_block = int(base.mbnx1 * base.mbnx2 * base.mbnx3
                          * self.num_per_cell)
        if n_per_block <= 0:
            raise ValueError("initial_num_tracers_per_cell too small")
        cap = max(int(np.ceil(n_per_block * self.cap_factor)), n_per_block)
        self.cap = cap
        per_level = {}
        for lev in self.levels:
            ids = self.smesh.level_ids[lev]
            nb = len(ids)
            d1, d2, d3 = self.smesh.dx(lev)
            x = np.zeros((nb, cap))
            y = np.zeros((nb, cap))
            z = np.zeros((nb, cap))
            pid = np.full((nb, cap), -1, np.int32)
            active = np.zeros((nb, cap), bool)
            for i, g in enumerate(ids):
                rng = np.random.default_rng(int(g) + self.rng_seed)
                x0, y0, z0 = self.smesh.block_origin(g)
                x[i, :n_per_block] = x0 + rng.random(n_per_block) * (
                    base.mbnx1 * d1)
                y[i, :n_per_block] = y0 + rng.random(n_per_block) * (
                    base.mbnx2 * d2)
                z[i, :n_per_block] = z0 + rng.random(n_per_block) * (
                    base.mbnx3 * d3)
                pid[i, :n_per_block] = n_per_block * int(g) + np.arange(
                    n_per_block)
                active[i, :n_per_block] = True
            dev = self.device
            st = dict(x=torch.as_tensor(x, device=dev),
                      y=torch.as_tensor(y, device=dev),
                      z=torch.as_tensor(z, device=dev),
                      id=torch.as_tensor(pid, device=dev),
                      active=torch.as_tensor(active, device=dev))
            for name in self._field_names():
                st[name] = torch.zeros((nb, cap), dtype=F64, device=dev)
            per_level[lev] = st
        return {"levels": per_level,
                "n_lost": torch.zeros((), dtype=I32, device=self.device)}

    # ---------------------------------------------------------------- interp
    def _interp(self, lev, prim, comps, x, y, z):
        """Leaf-local trilinear interpolation of each prim component in
        ``comps`` at level ``lev``'s cell width; a stencil across the leaf
        edge reads its filled ghosts (coarse-fine prolongations included).
        -> a list."""
        base = self.smesh.base
        d1, d2, d3 = self.smesh.dx(lev)
        ox, oy, oz = self._orig[lev]
        fx = (x - ox[:, None]) / d1 + (base.ng1 - 0.5)
        fy = (y - oy[:, None]) / d2 + (base.ng2 - 0.5)
        fz = (z - oz[:, None]) / d3 + (base.ng3 - 0.5)
        return trilinear([prim[:, c] for c in comps], fx, fy, fz,
                         wrap=False)

    def _wrap_or_drop(self, per_level, n_lost):
        base = self.smesh.base
        for st in per_level.values():
            active = st["active"]
            for comp, lo, hi, per in (
                    ("x", base.x1min, base.x1max, base.ix1_bc == "periodic"),
                    ("y", base.x2min, base.x2max, base.ix2_bc == "periodic"),
                    ("z", base.x3min, base.x3max, base.ix3_bc == "periodic")):
                q = st[comp]
                if per:
                    st[comp] = wrap_periodic(q, lo, hi)
                else:
                    escaped = active & ((q < lo) | (q >= hi))
                    n_lost = n_lost + escaped.sum().to(I32)
                    active = active & ~escaped
            st["active"] = active
        return per_level, n_lost

    # --------------------------------------------------------------- migrate
    def _dest_col(self, x, y, z):
        """Destination in the concatenated leaf order: the FINEST level
        whose table has a leaf at the position wins (-1: none)."""
        base = self.smesh.base
        dest = torch.full(x.shape, -1, dtype=torch.long, device=x.device)
        for lev in reversed(self.levels):
            s1, s2, s3 = self.smesh._scales(lev)

            def cell(q, lo, width, n):
                return torch.clamp(torch.floor((q - lo) / width).long(), 0,
                                   n - 1)

            c1 = cell(x, base.x1min, base.mbnx1 * base.dx1 / s1,
                      base.nb1 * s1)
            c2 = cell(y, base.x2min, base.mbnx2 * base.dx2 / s2,
                      base.nb2 * s2)
            c3 = cell(z, base.x3min, base.mbnx3 * base.dx3 / s3,
                      base.nb3 * s3)
            idx = self._tab[lev][c3, c2, c1]
            hit = (idx >= 0) & (dest < 0)
            dest = torch.where(hit, self._leaf_off[lev] + idx, dest)
        return dest

    def _pack(self, pool, key, cap):
        """Stable-sort the flat ``pool`` by ``key`` (``total_leaves``:
        none) and scatter it into per-level ``[nb, cap]`` buffers. ->
        ``(per_level, n_overflow)``."""
        tot = self.total_leaves
        n = tot * cap
        key_s, perm = torch.sort(key, stable=True)
        counts = torch.bincount(key, minlength=tot + 1)
        starts = torch.cumsum(counts, 0) - counts
        slot = torch.arange(key.shape[0], device=key.device) - starts[key_s]
        valid = (key_s < tot) & (slot < cap)
        dest = torch.where(valid, key_s * cap + slot, n)
        out = {lev: {} for lev in self.levels}
        for k, q in pool.items():
            qs = valid if k == "active" else q[perm]
            buf = torch.zeros(n + 1, dtype=q.dtype, device=q.device)
            buf[dest] = qs
            for lev in self.levels:
                o = self._leaf_off[lev] * cap
                nb = len(self.smesh.level_ids[lev])
                out[lev][k] = buf[o:o + nb * cap].reshape(nb, cap)
        n_overflow = ((key_s < tot).sum() - valid.sum()).to(I32)
        return out, n_overflow

    def _migrate(self, per_level, n_lost):
        """One stable sort over the concatenated pool routes particles
        across blocks and levels at once."""
        cap = next(iter(per_level.values()))["x"].shape[1]
        keys = []
        pool = {k: [] for k in self._names()}
        for lev in self.levels:
            st = per_level[lev]
            col = self._dest_col(st["x"], st["y"], st["z"])
            keys.append(torch.where(st["active"], col,
                                    self.total_leaves).reshape(-1))
            for k in pool:
                pool[k].append(st[k].reshape(-1))
        out, n_overflow = self._pack(
            {k: torch.cat(v) for k, v in pool.items()}, torch.cat(keys), cap)
        return out, n_lost + n_overflow

    # ----------------------------------------------------------------- adopt
    def adopt(self, state):
        """Re-bin a population onto THIS mesh's leaves (after a remesh):
        every level's buffers into one pool, each active particle to the
        finest leaf covering it under the NEW tables, one stable sort and
        scatter.  Identity, position and samples are kept exactly; a
        particle with no leaf, or over a leaf's capacity, counts as
        lost."""
        if state is None:
            return None
        old = state["levels"]
        cap = next(iter(old.values()))["x"].shape[1]
        self.cap = cap
        pool = {k: torch.cat([old[lev][k].reshape(-1)
                              for lev in sorted(old)])
                for k in self._names()}
        dest = self._dest_col(pool["x"], pool["y"], pool["z"])
        key = torch.where(pool["active"] & (dest >= 0), dest,
                          self.total_leaves)
        out, n_overflow = self._pack(pool, key, cap)
        return {"levels": out, "n_lost": state["n_lost"] + n_overflow}

    # ---------------------------------------------------------------- advect
    def advect(self, state, prims, dt):
        """Heun per level with the stored velocity as the predictor, then
        the domain boundaries and the cross-level migration."""
        if state is None:
            return None
        per_level = {lev: dict(st) for lev, st in state["levels"].items()}
        for lev, st in per_level.items():
            w = prims[lev]
            x, y, z = st["x"], st["y"], st["z"]
            x_s = x + dt * st["vel_x"]
            y_s = y + dt * st["vel_y"]
            z_s = z + dt * st["vel_z"]
            vx_s, vy_s, vz_s = self._interp(lev, w, (IV1, IV2, IV3), x_s,
                                            y_s, z_s)
            st["x"] = x + dt * 0.5 * (st["vel_x"] + vx_s)
            st["y"] = y + dt * 0.5 * (st["vel_y"] + vy_s)
            st["z"] = z + dt * 0.5 * (st["vel_z"] + vz_s)
        per_level, n_lost = self._wrap_or_drop(per_level, state["n_lost"])
        per_level, n_lost = self._migrate(per_level, n_lost)
        return {"levels": per_level, "n_lost": n_lost}

    # ------------------------------------------------------------------ fill
    def fill(self, state, prims):
        """Sample the fields at the particles, level by level."""
        if state is None:
            return None
        comps = sampled_components(self.mhd)
        per_level = {}
        for lev, st in state["levels"].items():
            st = dict(st)
            x, y, z = st["x"], st["y"], st["z"]
            act = st["active"]
            for name, v in zip(comps, self._interp(
                    lev, prims[lev], comps.values(), x, y, z)):
                st[name] = torch.where(act, v, 0.0)
            per_level[lev] = st
        return {"levels": per_level, "n_lost": state["n_lost"]}


def compact_swarm_smr(state, variables):
    """The active particles of every level for an output, level by level
    in (leaf, slot) order."""
    out = {v: [] for v in variables}
    for lev in sorted(state["levels"]):
        st = state["levels"][lev]
        act = st["active"].cpu().numpy().reshape(-1)
        for v in variables:
            if v not in st:
                raise KeyError(f"unknown tracer variable '{v}'")
            q = st[v].cpu().numpy()
            out[v].append(q.reshape((act.size,) + q.shape[2:])[act])
    return {v: np.concatenate(parts) for v, parts in out.items()}

"""Lagrangian tracer particles on a uniform mesh (reference
``src/tracers/tracers.cpp``; the port's counterpart of
``athenapk_tpu/tracers/tracers.py``).

Tracers live in per-block fixed-capacity buffers ``[nblocks, cap]`` with an
``active`` mask, on the simulation's device: positions and the sampled
fields are float64 whatever the state's dtype, ``id`` and ``n_lost`` int32
(the JAX package's dtypes under x64).  Interpolation is block-local: each
tracer reads only its owner block's ghost-inclusive array (``LCInterp`` on
the block pack, ``tracers.cpp:226-231``); on the ghost-free merged block
the indices wrap cyclically, on ghosted blocks they are clipped to the
block.  Migration between blocks is one stable sort of the flattened pool
by destination, a ``bincount`` and a masked scatter (``scatter_pool``).

* seeding: ``random_per_block`` with one ``np.random.default_rng(b +
  seed)`` stream per block (the JAX package's bits; ``SeedInitialTracers``,
  ``tracers.cpp:95-167``) or the problem's ``seed_initial_tracers`` hook
  (``initial_seed_method = user``);
* advection: Heun with trilinear (cell-centred linear) velocity
  interpolation, the last-filled velocity as the predictor
  (``AdvectTracers``, ``tracers.cpp:189-242``);
* fields: rho, p, v (and B) sampled after every cycle (``FillTracers``,
  ``tracers.cpp:249-308``);
* boundaries: periodic faces wrap positions; non-periodic faces deactivate
  the particles that leave and count them in ``n_lost``.

A block whose incoming particles exceed ``cap = ceil(num_per_cell *
cells_per_block * capacity_factor)`` drops the excess and counts it in
``n_lost`` (``tracers/capacity_factor``, default 2).  All of it is plain
PyTorch, as it is plain ``jnp`` in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.indices import GLMMHD, IB1, IB2, IB3, IDN, IPR, IV1, IV2, IV3

F64 = torch.float64
I32 = torch.int32


def particle_fields(state):
    """Names of the per-particle entries (``[nblocks, cap, ...]``); skips
    ``n_lost`` and any other entry of fewer dimensions."""
    return [k for k, v in state.items() if v.dim() >= 2]


def scatter_pool(fields, key, nb, cap):
    """Route a flat particle pool into per-block fixed-capacity slots.

    ``fields``: ``{name: [n, ...]}``; ``key``: ``[n]`` destination block in
    ``[0, nb]`` (``nb``: inactive, sorts last).  A stable sort by key, a
    ``bincount`` and a masked scatter into ``[nb, cap, ...]``; a block's
    overflow beyond ``cap`` is dropped.  -> ``({name: [nb, cap, ...]},
    n_overflow)`` (int32)."""
    n = key.shape[0]
    key = key.long()
    key_s, perm = torch.sort(key, stable=True)
    counts = torch.bincount(key, minlength=nb + 1)
    starts = torch.cumsum(counts, 0) - counts
    slot = torch.arange(n, device=key.device) - starts[key_s]
    valid = (key_s < nb) & (slot < cap)
    # one slot past the buffers takes every dropped particle
    dest = torch.where(valid, key_s * cap + slot, nb * cap)
    out = {}
    for name, q in fields.items():
        qp = valid if name == "active" else q[perm]
        buf = torch.zeros((nb * cap + 1,) + tuple(q.shape[1:]),
                          dtype=q.dtype, device=q.device)
        buf[dest] = qp
        out[name] = buf[:nb * cap].reshape((nb, cap) + tuple(q.shape[1:]))
    n_overflow = ((key_s < nb).sum() - valid.sum()).to(I32)
    return out, n_overflow


def trilinear(fields, fx, fy, fz, wrap):
    """Trilinear interpolation of each of ``fields`` (``[nb, NZ, NY, NX]``
    each) at the fractional cell-centre indices ``fx, fy, fz``
    (``[nb, cap]``, float64), row ``b`` reading block ``b``; ``wrap``:
    cyclic indices (the ghost-free periodic block), else clipped to the
    block.  The corners and weights are computed once for all the fields;
    each value is the JAX package's sum, in its order.  -> a list."""
    nb, NZ, NY, NX = fields[0].shape
    i0f = torch.floor(fx)
    j0f = torch.floor(fy)
    k0f = torch.floor(fz)
    wx = fx - i0f
    wy = fy - j0f
    wz = fz - k0f
    if wrap:
        i0 = torch.remainder(i0f.long(), NX)
        j0 = torch.remainder(j0f.long(), NY)
        k0 = torch.remainder(k0f.long(), NZ)
        i1 = torch.remainder(i0 + 1, NX)
        j1 = torch.remainder(j0 + 1, NY)
        k1 = torch.remainder(k0 + 1, NZ)
    else:
        i0 = torch.clamp(i0f.long(), 0, NX - 2)
        j0 = torch.clamp(j0f.long(), 0, NY - 2)
        k0 = torch.clamp(k0f.long(), 0, NZ - 2)
        i1 = i0 + 1
        j1 = j0 + 1
        k1 = k0 + 1
    base = torch.arange(nb, device=fx.device)[:, None] * (NZ * NY * NX)
    corners = []
    for kk, wk in ((k0, 1 - wz), (k1, wz)):
        for jj, wj in ((j0, 1 - wy), (j1, wy)):
            row = base + (kk * NY + jj) * NX
            for ii, wi in ((i0, 1 - wx), (i1, wx)):
                corners.append((row + ii, wk * wj * wi))
    outs = []
    for field in fields:
        flat = field.reshape(-1)
        out = 0.0
        for idx, w in corners:
            out = out + flat[idx] * w
        outs.append(out)
    return outs


def wrap_periodic(q, lo, hi):
    """``lo + mod(q - lo, hi - lo)`` with the sign of the divisor
    (``jnp.mod``'s: a truncated remainder moved up by the period where
    negative)."""
    span = hi - lo
    r = torch.fmod(q - lo, span)
    return lo + torch.where(r < 0, r + span, r)


def sampled_components(mhd):
    """``{field name: prim index}`` of the sampled fields."""
    comps = dict(vel_x=IV1, vel_y=IV2, vel_z=IV3, rho=IDN, pressure=IPR)
    if mhd:
        comps.update(B_x=IB1, B_y=IB2, B_z=IB3)
    return comps


class Tracers:
    def __init__(self, pin, mesh, cfg, extra_fields=None, device="cuda"):
        from ..driver import resolve_device

        self.enabled = pin.get_or_add_bool("tracers", "enabled", False)
        self.mesh = mesh
        self.mhd = cfg.fluid == GLMMHD
        # on the card unless the caller asks for the CPU
        self.device = resolve_device(device)
        if not self.enabled:
            return
        if mesh.nx3 == 1:
            raise ValueError("tracers currently only supported in 3D "
                             "(matches reference)")
        self.seed_method = pin.get_or_add_string(
            "tracers", "initial_seed_method", "none")
        self.num_per_cell = pin.get_or_add_real(
            "tracers", "initial_num_tracers_per_cell", 0.0)
        self.rng_seed = pin.get_or_add_integer("tracers", "initial_rng_seed",
                                               0)
        self.cap_factor = pin.get_or_add_real("tracers", "capacity_factor",
                                              2.0)
        # problem-specific per-particle fields: {name: trailing shape}
        # (ProblemInitTracerData, e.g. turbulence's lookback vectors,
        # turbulence.cpp:200-219)
        self.extra_fields = dict(extra_fields or {})
        origins = np.array([mesh.block_origin(b)
                            for b in range(mesh.nblocks)])
        self._origins = tuple(torch.as_tensor(origins[:, i], dtype=F64,
                                              device=self.device)
                              for i in range(3))

    def _field_names(self):
        return list(sampled_components(self.mhd))

    def _tensor(self, a, dtype=F64):
        return torch.as_tensor(a, dtype=dtype, device=self.device)

    # ------------------------------------------------------------------ seed
    def seed(self, user_hook=None):
        """Random-per-block seeding into the per-block buffers (one
        gid-seeded numpy stream per block), or the problem's hook."""
        mesh = self.mesh
        n_per_block = int(mesh.mbnx1 * mesh.mbnx2 * mesh.mbnx3
                          * self.num_per_cell)
        if self.seed_method == "none":
            return None
        if self.seed_method == "user":
            if user_hook is None:
                raise ValueError("initial_seed_method=user requires the "
                                 "problem generator to define "
                                 "seed_initial_tracers")
            return user_hook(self)
        if self.seed_method != "random_per_block":
            raise ValueError(f"Unknown tracer initial_seed_method "
                             f"'{self.seed_method}'")
        if n_per_block <= 0:
            raise ValueError("initial_num_tracers_per_cell too small")
        nb = mesh.nblocks
        cap = max(int(np.ceil(n_per_block * self.cap_factor)), n_per_block)
        self.cap = cap
        x = np.zeros((nb, cap))
        y = np.zeros((nb, cap))
        z = np.zeros((nb, cap))
        ids = np.full((nb, cap), -1, np.int32)
        active = np.zeros((nb, cap), bool)
        for b in range(nb):
            rng = np.random.default_rng(b + self.rng_seed)
            x0, y0, z0 = mesh.block_origin(b)
            x[b, :n_per_block] = x0 + rng.random(n_per_block) * (
                mesh.mbnx1 * mesh.dx1)
            y[b, :n_per_block] = y0 + rng.random(n_per_block) * (
                mesh.mbnx2 * mesh.dx2)
            z[b, :n_per_block] = z0 + rng.random(n_per_block) * (
                mesh.mbnx3 * mesh.dx3)
            ids[b, :n_per_block] = n_per_block * b + np.arange(n_per_block)
            active[b, :n_per_block] = True
        state = dict(x=self._tensor(x), y=self._tensor(y), z=self._tensor(z),
                     id=self._tensor(ids, I32),
                     active=self._tensor(active, torch.bool),
                     n_lost=torch.zeros((), dtype=I32, device=self.device))
        for name in self._field_names():
            state[name] = torch.zeros((nb, cap), dtype=F64,
                                      device=self.device)
        for name, trailing in self.extra_fields.items():
            state[name] = torch.zeros((nb, cap) + tuple(trailing),
                                      dtype=F64, device=self.device)
        return state

    # ---------------------------------------------------------------- interp
    def _interp(self, prim, comps, x, y, z, origins=None):
        """Block-local trilinear interpolation among cell centres of each
        prim component in ``comps``: row ``b`` of ``x, y, z`` reads block
        ``b``'s ghost-inclusive array (its ghosts are filled, so a stencil
        across the block edge sees the neighbour's copy).  ``origins``: the
        (x, y, z) block origins of ``prim``'s rows when they are not the
        whole mesh (a rank's blocks).  -> a list."""
        mesh = self.mesh
        bx0, by0, bz0 = self._origins if origins is None else origins
        fx = (x - bx0[:, None]) / mesh.dx1 + (mesh.ng1 - 0.5)
        fy = (y - by0[:, None]) / mesh.dx2 + (mesh.ng2 - 0.5)
        fz = (z - bz0[:, None]) / mesh.dx3 + (mesh.ng3 - 0.5)
        return trilinear([prim[:, c] for c in comps], fx, fy, fz,
                         mesh.nghost == 0)

    def _apply_domain_bcs(self, state):
        """Periodic faces wrap positions; non-periodic faces deactivate the
        particles that leave."""
        mesh = self.mesh
        active = state["active"]
        lost = torch.zeros((), dtype=I32, device=active.device)
        for comp, lo, hi, per in (
                ("x", mesh.x1min, mesh.x1max, mesh.ix1_bc == "periodic"),
                ("y", mesh.x2min, mesh.x2max, mesh.ix2_bc == "periodic"),
                ("z", mesh.x3min, mesh.x3max, mesh.ix3_bc == "periodic")):
            q = state[comp]
            if per:
                state[comp] = wrap_periodic(q, lo, hi)
            else:
                escaped = active & ((q < lo) | (q >= hi))
                lost = lost + escaped.sum().to(I32)
                active = active & ~escaped
        state["active"] = active
        state["n_lost"] = state["n_lost"] + lost
        return state

    # --------------------------------------------------------------- migrate
    def _dest_gid(self, state):
        """The owner block of each position (x-fastest block order)."""
        mesh = self.mesh

        def cell(q, lo, width, n):
            return torch.clamp(torch.floor((q - lo) / width).long(), 0,
                               n - 1)

        b1 = cell(state["x"], mesh.x1min, mesh.mbnx1 * mesh.dx1, mesh.nb1)
        b2 = cell(state["y"], mesh.x2min, mesh.mbnx2 * mesh.dx2, mesh.nb2)
        b3 = cell(state["z"], mesh.x3min, mesh.mbnx3 * mesh.dx3, mesh.nb3)
        return b1 + mesh.nb1 * (b2 + mesh.nb2 * b3)

    def _migrate(self, state):
        """Route particles to their owner blocks (``scatter_pool``);
        inactive particles take the key ``nblocks`` and sort last."""
        nb = self.mesh.nblocks
        if nb == 1:
            return state
        cap = state["x"].shape[1]
        n = nb * cap
        key = torch.where(state["active"], self._dest_gid(state),
                          nb).reshape(n)
        fields = {name: state[name].reshape((n,) + state[name].shape[2:])
                  for name in particle_fields(state)}
        routed, n_overflow = scatter_pool(fields, key, nb, cap)
        out = dict(state)
        out.update(routed)
        out["n_lost"] = state["n_lost"] + n_overflow
        return out

    # ---------------------------------------------------------------- advect
    def advect(self, state, prim, dt, origins=None, migrate=None):
        """Heun: the predictor uses the stored (last-filled) velocity, the
        corrector samples at the predicted position; then the domain
        boundaries and the migration.  ``origins`` and ``migrate`` (the
        JAX package's ``_advect_impl`` hooks) let a rank advect its own
        blocks' pools and route them between ranks
        (``tracers.sharded``)."""
        if state is None:
            return None
        x, y, z = state["x"], state["y"], state["z"]
        x_s = x + dt * state["vel_x"]
        y_s = y + dt * state["vel_y"]
        z_s = z + dt * state["vel_z"]
        vx_s, vy_s, vz_s = self._interp(prim, (IV1, IV2, IV3), x_s, y_s,
                                        z_s, origins)
        state = dict(state)
        state["x"] = x + dt * 0.5 * (state["vel_x"] + vx_s)
        state["y"] = y + dt * 0.5 * (state["vel_y"] + vy_s)
        state["z"] = z + dt * 0.5 * (state["vel_z"] + vz_s)
        return (migrate or self._migrate)(self._apply_domain_bcs(state))

    # ------------------------------------------------------------------ fill
    def fill(self, state, prim, origins=None):
        """Sample the fields at the particles (0 where inactive);
        ``origins`` as ``advect``'s."""
        if state is None:
            return None
        state = dict(state)
        x, y, z = state["x"], state["y"], state["z"]
        act = state["active"]
        comps = sampled_components(self.mhd)
        for name, v in zip(comps, self._interp(prim, comps.values(), x, y,
                                                z, origins)):
            state[name] = torch.where(act, v, 0.0)
        return state


def compact_swarm(state, variables):
    """The active particles for an output: ``{name: np.ndarray[n_active]}``
    in (block, slot) order, each entry read from the device once."""
    active = state["active"].cpu().numpy().reshape(-1)
    out = {}
    for name in variables:
        if name not in state:
            raise KeyError(f"unknown tracer variable '{name}'")
        q = state[name].cpu().numpy()
        out[name] = q.reshape((active.size,) + q.shape[2:])[active]
    return out

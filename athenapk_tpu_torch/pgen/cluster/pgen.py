"""Cluster problem generator and source hooks (reference
``src/pgen/cluster.cpp``; counterpart of
``athenapk_tpu/pgen/cluster/pgen.py``).

Initial state (host numpy f64, as the JAX package's): the hydrostatic
atmosphere of the ACCEPT entropy profile in the NFW + BCG + SMBH
potential, or uniform gas; uniform, dipole and tower magnetic fields; the
few-modes velocity and magnetic perturbations (``<init_perturb>``; B is
the curl of a ghost-extended vector potential).  On a refined mesh
(``problem_generator_smr``) the HSE profile is integrated once at the
finest level's dx and the perturbations are normalised over all levels.

Sources, on the state's device (the coordinates kept with each hook's
closure, on each device and dtype a state comes in): the unsplit source
(gravity, AGN feedback with triggering and the tower, SN Ia) joins every
stage; stellar feedback and the clips are a split source, once per cycle
at full dt; the accretion dt caps the step; ``history_columns`` adds
``cold_mass``, ``agn_extent`` and ``agn_feedback_power`` to the uniform
``.hst`` (the refined driver has no cluster columns, as in the JAX
package).  No source reads the host: the accretion rate, the tower's
scale and the region mass stay 0-d tensors.  On a uniform mesh the
sources bounded by a sphere (the AGN's channels, stellar feedback, the
clips) run on the index box that holds it (``regions``); gravity and SN
Ia, and every source on a refined mesh, run on the whole group.  Each
source runs in a profiler range of its name (``gravity``,
``agn_feedback``, ``snia_feedback``, ``stellar_feedback``, ``clips``;
inside ``agn_feedback``, ``agn_triggering`` and ``magnetic_tower``); the
split sources' and the refined accretion dt's own conversions to prim
run in ``cons_to_prim`` ranges; the history columns read the host in
``host_read`` ranges.
"""

from __future__ import annotations

import math
import types
import weakref

import numpy as np
import torch
from torch.profiler import record_function

from ...amr.leaf_sums import LeafSums
from ...amr.smr import LevelLeafView
from ...core.ieee import sqrt
from ...core.indices import (GLMMHD, IB1, IB2, IB3, IDN, IEN, IM1, IM2,
                             IM3, IPR, NGLMMHD, NHYDRO)
from ...eos.adiabatic import cons_to_prim
from ...solver.hydro_pkg import interior_mask
from ...utils.few_modes_ft import FewModesFT, FewModesFTSmr, make_random_modes
from ...utils.units import Units, mean_molecular_weights
from . import regions
from .agn_feedback import AGNFeedback
from .agn_triggering import AGNTriggering
from .entropy_profiles import ACCEPTEntropyProfile
from .gravity import ClusterGravity, gravitational_field_source
from .hse import HydrostaticEquilibriumSphere
from .jet_coords import JetCoords
from .magnetic_tower import MagneticTower
from .snia_stellar_feedback import SNIAFeedback, StellarFeedback

_cache = weakref.WeakKeyDictionary()


class _ClusterPkg:
    def __init__(self, pin):
        self.units = Units(pin)
        he_x = pin.get_real("hydro", "He_mass_fraction")
        self.mu, self.mu_e = mean_molecular_weights(he_x)
        self.gamma = pin.get_real("hydro", "gamma")
        self.gravity = ClusterGravity(pin, self.units)
        self.entropy = ACCEPTEntropyProfile(pin, self.units)
        self.hse = HydrostaticEquilibriumSphere(
            pin, self.units, self.gravity, self.entropy, self.mu, self.mu_e)
        c = "problem/cluster/gravity"
        self.gravity_srcterm = pin.get_or_add_bool(c, "gravity_srcterm", True)
        # clips (cluster_clips.cpp)
        cl = "problem/cluster/clips"
        self.clip_r = pin.get_or_add_real(cl, "clip_r", -1.0)
        self.clip_dfloor = pin.get_or_add_real(cl, "dfloor", -1.0)
        self.clip_vceil = pin.get_or_add_real(cl, "vceil", float("inf"))
        self.clip_vAceil = pin.get_or_add_real(cl, "vAceil", float("inf"))
        self.clip_Tceil = pin.get_or_add_real(cl, "Tceil", float("inf"))
        self.mbar_over_kb = self.mu * self.units.mh() / \
            self.units.k_boltzmann()
        # the AGN subsystem (optional)
        self.jet_coords = JetCoords(pin)
        self.magnetic_tower = MagneticTower(pin, self.units, self.jet_coords)
        self.agn_feedback = AGNFeedback(pin, self.units, self.jet_coords,
                                        self.magnetic_tower,
                                        self.mbar_over_kb, self.gamma)
        self.agn_triggering = AGNTriggering(pin, self.units,
                                            self.mbar_over_kb, self.gamma)
        if self.agn_triggering.mode != "NONE":
            self.agn_feedback.triggering = self.agn_triggering
        self.snia_feedback = SNIAFeedback(pin, self.units, self.gravity)
        self.stellar_feedback = StellarFeedback(pin, self.units, self.mu,
                                                self.mbar_over_kb)

        # the HSE self-test output (reference test_he_sphere.dat)
        h = "problem/cluster/hydrostatic_equilibrium"
        if pin.get_or_add_bool(h, "test_he_sphere", False):
            r0 = pin.get_or_add_real(h, "test_he_sphere_r_start",
                                     1e-3 * self.units.kpc())
            r1 = pin.get_or_add_real(h, "test_he_sphere_r_end",
                                     4000 * self.units.kpc())
            n_r = pin.get_or_add_integer(h, "test_he_sphere_n_r", 4000)
            self.hse.generate_p_rho_profile(r0, r1, n_r).write(
                "test_he_sphere.dat")


def _pkg(pin):
    if pin not in _cache:
        _cache[pin] = _ClusterPkg(pin)
    return _cache[pin]


def register_defaults(pin):
    return _pkg(pin)


def init_user_mesh_data(pin):
    _pkg(pin)


def needs_ghosts_at_init(pin):
    """Does the initial state need ghost cells?  ``init_perturb/sigma_b``
    takes B as the curl of a vector potential on the ghost-extended block,
    so the uniform driver keeps the ghosts of an all-periodic deck then
    (the JAX package's merge drops them, ``athenapk_tpu/driver.py:296``,
    and the perturbation refuses nghost 0)."""
    return pin.get_or_add_real("problem/cluster/init_perturb", "sigma_b",
                               0.0) != 0.0


class _Coords:
    """Cell-centre coordinates of a group of blocks: host f64 grids
    ``x[nb,1,1,NX]``, ``y[nb,1,NY,1]``, ``z[nb,NZ,1,1]``, on each device
    and dtype a state comes in, ``(x, y, z, r)`` tensors (``r`` the radius
    over the whole block), and for each radius a source asks for, the
    index box that holds its sphere (``regions.index_box``)."""

    def __init__(self, x, y, z):
        self.host = (x, y, z)
        self._on = {}
        self._boxes = {}

    @classmethod
    def of_mesh(cls, mesh):
        """The coordinates of a ``Mesh`` (or a level's ``LevelLeafView``)."""
        return cls(*mesh.cell_centers_mesh())

    def on(self, like):
        """``(x, y, z, r)`` in ``like``'s device and dtype."""
        key = (like.device, like.dtype)
        if key not in self._on:
            x, y, z = (torch.as_tensor(c, dtype=like.dtype,
                                       device=like.device)
                       for c in self.host)
            self._on[key] = (x, y, z, sqrt(x ** 2 + y ** 2 + z ** 2))
        return self._on[key]

    def box(self, radius):
        """``regions.index_box`` of ``radius`` on these blocks (host
        arithmetic, once per radius)."""
        if radius not in self._boxes:
            self._boxes[radius] = regions.index_box(self.host, radius)
        return self._boxes[radius]


def _level_coords(smesh, leaves=None):
    """``{level: _Coords}`` of a refined mesh's leaves (with ``leaves``, an
    ``amr.leaf_sums.LeafSums``: of the rows it holds, on the levels where
    it holds any)."""
    out = {}
    for lev in sorted(smesh.level_ids):
        c = _Coords.of_mesh(LevelLeafView(smesh, lev))
        if leaves is not None:
            if not leaves.ids[lev].size:
                continue
            rows = np.searchsorted(smesh.level_ids[lev], leaves.ids[lev])
            c = _Coords(*(a[rows] for a in c.host))
        out[lev] = c
    return out


def _init_cons(pin, pkg, cfg, xb, yb, zb, min_dx, profile=None):
    """The cluster's conserved state on host coordinate arrays ``xb``,
    ``yb``, ``zb`` of shape [nb, NZ, NY, NX] (numpy f64; shared by the
    uniform and the refined generators)."""
    gm1 = pkg.gamma - 1.0
    mhd = cfg.fluid == GLMMHD
    u = np.zeros((xb.shape[0], cfg.nvar) + xb.shape[1:])
    r = np.sqrt(xb ** 2 + yb ** 2 + zb ** 2)

    ug = "problem/cluster/uniform_gas"
    if pin.get_or_add_bool(ug, "init_uniform_gas", False):
        rho = pin.get_real(ug, "rho")
        ux = pin.get_real(ug, "ux")
        uy = pin.get_real(ug, "uy")
        uz = pin.get_real(ug, "uz")
        pres = pin.get_real(ug, "pres")
        u[:, IDN] = rho
        u[:, IM1] = rho * ux
        u[:, IM2] = rho * uy
        u[:, IM3] = rho * uz
        u[:, IEN] = pres / gm1 + 0.5 * rho * (ux ** 2 + uy ** 2 + uz ** 2)
    else:
        p_r = np.interp(r.ravel(), profile.r, profile.p).reshape(r.shape)
        k_r = pkg.entropy.k_from_r(r)
        rho = pkg.hse.rho_from_p_k(p_r, k_r)
        u[:, IDN] = rho
        u[:, IEN] = p_r / gm1

    if mhd:
        ub = "problem/cluster/uniform_b_field"
        if pin.get_or_add_bool(ub, "init_uniform_b_field", False):
            u[:, IB1] += pin.get_real(ub, "bx")
            u[:, IB2] += pin.get_real(ub, "by")
            u[:, IB3] += pin.get_real(ub, "bz")
        db = "problem/cluster/dipole_b_field"
        if pin.get_or_add_bool(db, "init_dipole_b_field", False):
            mx = pin.get_real(db, "mx")
            my = pin.get_real(db, "my")
            mz = pin.get_real(db, "mz")
            # the dipole field of the vector potential A = m x r / r^3
            r3 = np.maximum(r, min_dx / 2) ** 3
            u[:, IB1] += (3 * xb * (mx * xb + my * yb + mz * zb) / r ** 2
                          - mx) / r3
            u[:, IB2] += (3 * yb * (mx * xb + my * yb + mz * zb) / r ** 2
                          - my) / r3
            u[:, IB3] += (3 * zb * (mx * xb + my * yb + mz * zb) / r ** 2
                          - mz) / r3
        # the initial magnetic tower (the fixed-field injection at t=0)
        tw = pkg.magnetic_tower
        if tw.initial_field != 0.0 and tw.l_scale > 0:
            bt = tw.unit_field(torch.from_numpy(np.ascontiguousarray(xb)),
                               torch.from_numpy(np.ascontiguousarray(yb)),
                               torch.from_numpy(np.ascontiguousarray(zb)),
                               0.0)
            for c, b in zip((IB1, IB2, IB3), bt):
                u[:, c] += tw.initial_field * b.numpy()
        u[:, IEN] += 0.5 * (u[:, IB1] ** 2 + u[:, IB2] ** 2 + u[:, IB3] ** 2)
    return u


def _uses_hse(pin):
    return not pin.get_or_add_bool("problem/cluster/uniform_gas",
                                   "init_uniform_gas", False)


def problem_generator(pin, mesh, cfg, eos):
    pkg = _pkg(pin)
    shape = (mesh.nblocks,) + mesh.block_shape
    xb, yb, zb = (np.broadcast_to(c, shape)
                  for c in mesh.cell_centers_mesh())
    profile = pkg.hse.profile_for_mesh(mesh) if _uses_hse(pin) else None
    u = _init_cons(pin, pkg, cfg, xb, yb, zb, mesh.min_dx, profile=profile)
    return _apply_init_perturb(pin, mesh, cfg, u)


def _perturb_scale(pin, ip, tag):
    """One length scale from l_peak or k_peak (cluster.cpp:380-393)."""
    l_peak = pin.get_or_add_real(ip, f"l_peak_{tag}", -1.0)
    k_peak = pin.get_or_add_real(ip, f"k_peak_{tag}", -1.0)
    if not ((l_peak > 0.0) != (k_peak > 0.0)):
        raise ValueError(
            f"init_perturb needs exactly one of l_peak_{tag}/k_peak_{tag}")
    if l_peak > 0.0:
        lx = pin.get_real("parthenon/mesh", "x1max") \
            - pin.get_real("parthenon/mesh", "x1min")
        k_peak = lx / l_peak       # assumes a cubic box (as the reference)
    return k_peak


def _few_modes(pin, ip, tag, cls, mesh, **kw):
    """The ``init_perturb`` few-modes field of ``tag`` (``v`` or ``b``) on
    the host: ``cls`` (FewModesFT or FewModesFTSmr) generated once."""
    k_peak = _perturb_scale(pin, ip, tag)
    n_modes = pin.get_or_add_integer(ip, f"num_modes_{tag}", 40)
    sol_w = (pin.get_or_add_real(ip, "sol_weight_v", 1.0) if tag == "v"
             else 1.0)
    rseed = pin.get_or_add_integer(ip, f"rseed_{tag}", 1 if tag == "v"
                                   else 2)
    fm = cls(mesh, n_modes, make_random_modes(n_modes, k_peak, rseed),
             k_peak, sol_w, 1e-10, rseed, **kw)
    out = fm.generate(1.0, device="cpu")
    if isinstance(out, dict):
        return {lev: a.numpy() for lev, a in out.items()}
    return out.numpy()


def _curl(a, g, dx):
    """B = curl A (cluster.cpp:768-781) by central differences of the
    ghost(``g``)-extended potential ``a`` [3, nb, NZ+2g, NY+2g, NX+2g] on
    the interior cells; ``dx`` = (dx1, dx2, dx3)."""

    def d(comp, axis):
        # dA_comp/dx_axis; the array axes after the block are (z, y, x)
        ax = 3 - axis
        lo = [slice(g, -g)] * 3
        hi = [slice(g, -g)] * 3
        lo[ax] = slice(g - 1, -g - 1)
        hi[ax] = slice(g + 1, None if g == 1 else -g + 1)
        q = a[comp]
        return (q[(slice(None),) + tuple(hi)]
                - q[(slice(None),) + tuple(lo)]) / (2.0 * dx[axis - 1])

    return (d(2, 2) - d(1, 3),     # dAz/dy - dAy/dz
            d(0, 3) - d(2, 1),     # dAx/dz - dAz/dx
            d(1, 1) - d(0, 2))     # dAy/dx - dAx/dy


def _set_velocity(u, sl, v, v_norm):
    """Momenta rho v / v_norm on the interior ``sl`` of ``u`` (zero
    velocity before: cluster.cpp:699) and their kinetic energy."""
    mom = u[:, IM1:IM3 + 1][(slice(None), slice(None)) + sl]
    if np.any(mom != 0.0):
        raise ValueError("init_perturb sigma_v requires zero initial "
                         "velocity (cluster.cpp:699)")
    rho = u[:, IDN][(slice(None),) + sl]
    ke_ = np.zeros_like(rho)
    for n, c in enumerate((IM1, IM2, IM3)):
        u[:, c][(slice(None),) + sl] = rho * v[n] / v_norm
        ke_ += u[:, c][(slice(None),) + sl] ** 2
    u[:, IEN][(slice(None),) + sl] += 0.5 * ke_ / rho


def _set_field(u, sl, b, b_norm):
    """B = b / b_norm on the interior ``sl`` of ``u`` (zero B before:
    cluster.cpp:766) and its magnetic energy."""
    bexist = u[:, IB1:IB3 + 1][(slice(None), slice(None)) + sl]
    if np.any(bexist != 0.0):
        raise ValueError("init_perturb sigma_b requires zero initial "
                         "B (cluster.cpp:766)")
    for c, bb in zip((IB1, IB2, IB3), b):
        u[:, c][(slice(None),) + sl] = bb / b_norm
    u[:, IEN][(slice(None),) + sl] += 0.5 * (
        b[0] ** 2 + b[1] ** 2 + b[2] ** 2) / b_norm ** 2


def _apply_init_perturb(pin, mesh, cfg, u):
    """The initial velocity and magnetic perturbations of a few-modes
    field (``cluster.cpp:374-458`` and ``:658-815``): v normalised to rms
    sigma_v (momenta rho v, kinetic energy added); B = curl A of a
    solenoidal few-modes vector potential normalised to rms sigma_b
    (magnetic energy added)."""
    ip = "problem/cluster/init_perturb"
    sigma_v = pin.get_or_add_real(ip, "sigma_v", 0.0)
    sigma_b = pin.get_or_add_real(ip, "sigma_b", 0.0)
    if sigma_v == 0.0 and sigma_b == 0.0:
        return u
    ks, ke, js, je, is_, ie = mesh.interior
    sl = (slice(ks, ke + 1), slice(js, je + 1), slice(is_, ie + 1))
    vol = mesh.cell_volume
    lxyz = ((mesh.x1max - mesh.x1min) * (mesh.x2max - mesh.x2min)
            * (mesh.x3max - mesh.x3min))

    if sigma_v != 0.0:
        v = _few_modes(pin, ip, "v", FewModesFT, mesh)
        v_norm = math.sqrt(float((v ** 2).sum() * vol) / lxyz / sigma_v ** 2)
        _set_velocity(u, sl, v, v_norm)

    if sigma_b != 0.0:
        if cfg.fluid != GLMMHD:
            raise ValueError("init_perturb sigma_b requires fluid=glmmhd")
        g = mesh.nghost
        if g < 1:
            raise ValueError("init_perturb sigma_b needs nghost >= 1 "
                             "(curl of the vector potential)")
        # the potential is solenoidal (sol_weight 1) and ghost-filled, so
        # the curl's central differences hold on every interior cell
        a = _few_modes(pin, ip, "b", FewModesFT, mesh, fill_ghosts=True)
        b = _curl(a, g, (mesh.dx1, mesh.dx2, mesh.dx3))
        b2_sum = float((b[0] ** 2 + b[1] ** 2 + b[2] ** 2).sum() * vol)
        _set_field(u, sl, b, math.sqrt(b2_sum / lxyz / sigma_b ** 2))
    return u


def problem_generator_smr(pin, smesh, cfg, eos):
    """The refined-mesh initial state ``{level: [nb, nvar, NZ, NY, NX]}``
    (host numpy f64, ghosts unfilled): ONE HSE profile sampled at the
    finest level's dx (a per-leaf generator would integrate it once per
    leaf), evaluated at each leaf's own cell centres (the reference calls
    ``ProblemGenerator`` per MeshBlock at any level against the shared
    PRhoProfile); the perturbations normalised over all levels."""
    pkg = _pkg(pin)
    base = smesh.base
    profile = None
    if _uses_hse(pin):
        fine = types.SimpleNamespace(min_dx=min(smesh.dx(smesh.max_level)),
                                     **{k: getattr(base, k) for k in (
                                         "x1min", "x1max", "x2min", "x2max",
                                         "x3min", "x3max")})
        profile = pkg.hse.profile_for_mesh(fine)
    state = {}
    bs = base.block_shape
    for lev, c in _level_coords(smesh).items():
        xs, ys, zs = (np.broadcast_to(a, (a.shape[0],) + bs)
                      for a in c.host)
        state[lev] = _init_cons(pin, pkg, cfg, xs, ys, zs,
                                min(smesh.dx(lev)), profile=profile)
    return _apply_init_perturb_smr(pin, smesh, cfg, state)


def _apply_init_perturb_smr(pin, smesh, cfg, state):
    """``cluster.cpp:377-461`` on a refined mesh: the SAME few-modes
    realisation as the uniform path (one OU spectrum, ``FewModesFTSmr``'s
    per-level phase tables: a level-l leaf samples the same continuous
    modes at its own cell positions), normalised by the volume-weighted
    rms over ALL leaves.  A fully refined mesh gives the uniform field at
    2x."""
    ip = "problem/cluster/init_perturb"
    sigma_v = pin.get_or_add_real(ip, "sigma_v", 0.0)
    sigma_b = pin.get_or_add_real(ip, "sigma_b", 0.0)
    if sigma_v == 0.0 and sigma_b == 0.0:
        return state
    base = smesh.base
    ks, ke, js, je, is_, ie = base.interior
    sl = (slice(ks, ke + 1), slice(js, je + 1), slice(is_, ie + 1))
    lxyz = ((base.x1max - base.x1min) * (base.x2max - base.x2min)
            * (base.x3max - base.x3min))

    def vol(lev):
        d1, d2, d3 = smesh.dx(lev)
        return d1 * d2 * d3

    if sigma_v != 0.0:
        v = _few_modes(pin, ip, "v", FewModesFTSmr, smesh)
        v2_sum = sum(float((a ** 2).sum()) * vol(lev)
                     for lev, a in sorted(v.items()))
        v_norm = math.sqrt(v2_sum / lxyz / sigma_v ** 2)
        for lev, u in state.items():
            _set_velocity(u, sl, v[lev], v_norm)

    if sigma_b != 0.0:
        if cfg.fluid != GLMMHD:
            raise ValueError("init_perturb sigma_b requires fluid=glmmhd")
        # ghost=1: the phases on the 1-cell-extended index range, so the
        # curl's central differences hold on every interior cell (the
        # refined analog of the uniform fill_ghosts=True)
        a = _few_modes(pin, ip, "b", FewModesFTSmr, smesh, ghost=1)
        b = {lev: _curl(q, 1, smesh.dx(lev)) for lev, q in sorted(a.items())}
        b2_sum = sum(float((bb[0] ** 2 + bb[1] ** 2 + bb[2] ** 2).sum())
                     * vol(lev) for lev, bb in b.items())
        b_norm = math.sqrt(b2_sum / lxyz / sigma_b ** 2)
        for lev, u in state.items():
            _set_field(u, sl, b[lev], b_norm)
    return state


# ------------------------------------------------------------- sources
def _unsplit_groups(pkg, mhd, groups, beta_dt, t, sums=None):
    """The unsplit source over leaf groups, in place: gravity, AGN
    feedback (with the fixed-field tower; ``sums`` its cross-group sums),
    SN Ia."""
    if pkg.gravity_srcterm:
        with record_function("gravity"):
            for g in groups:
                gravitational_field_source(pkg.gravity, g["u"], g["prim"],
                                           beta_dt, g["x"], g["y"], g["z"],
                                           g["r"])
    with record_function("agn_feedback"):
        pkg.agn_feedback.apply_groups(groups, beta_dt, t, mhd, sums=sums)
    with record_function("snia_feedback"):
        for g in groups:
            pkg.snia_feedback.apply(g["u"], g["prim"], beta_dt, g["r"])


def _group(u, prim, coords, vol, valid, level=None, boxed=False):
    """A group of blocks for the sources; ``boxed``: it offers the index
    boxes of ``coords`` (``regions.of``), which the uniform hooks take and
    the refined ones, whose sums run per leaf, do not."""
    x, y, z, r = coords.on(u)
    return dict(u=u, prim=prim, x=x, y=y, z=z, r=r, vol=vol, valid=valid,
                level=level, box=coords.box if boxed else None)


def _valid(mesh, like, cache):
    """The interior mask [1, NZ, NY, NX] on ``like``'s device."""
    if like.device not in cache:
        cache[like.device] = interior_mask(mesh.block_shape,
                                           mesh.interior_slices,
                                           like.device)[0]
    return cache[like.device]


def problem_source_unsplit(pin, mesh, cfg, eos):
    """The cluster's unsplit (per-stage) source (``ClusterUnsplitSrcTerm``,
    cluster.cpp:63-84): gravity, AGN feedback (the fixed-field tower
    included) and SN Ia.  Stellar feedback and the clips are SPLIT sources,
    once per cycle at full dt on the final state (``ClusterSplitSrcTerm``
    as ProblemSourceFirstOrder, main.cpp:106): the one-shot density reset
    must see the persisted state, not a discarded 2S half-register."""
    pkg = _pkg(pin)
    coords = _Coords.of_mesh(mesh)
    mhd = cfg.fluid == GLMMHD
    masks = {}

    def src(u, prim, mesh_, beta_dt, t):
        u = u.clone()
        _unsplit_groups(pkg, mhd, [_group(u, prim, coords, mesh.cell_volume,
                                          _valid(mesh, u, masks),
                                          boxed=True)],
                        beta_dt, t)
        return u

    return src


def problem_source_unsplit_smr(pin, smesh, cfg, eos, leaves=None):
    """The unsplit source on a refined mesh: per-level coordinates and
    volume-weighted cross-level reductions (the reference reduces across
    ranks and levels, ``hydro_driver.cpp:360-449``).  -> ``src(state,
    prims, beta_dt, t) -> state`` over the per-level state dict.

    ``leaves``: the ``amr.leaf_sums.LeafSums`` of the rows the state holds
    (a rank's leaves over ranks; every leaf by default).  The sums run per
    leaf in global leaf order, all of a stage's partials in one total (one
    collective over ranks), so a rank's rows step as in the one-rank run,
    bit for bit."""
    pkg = _pkg(pin)
    mhd = cfg.fluid == GLMMHD
    leaves = LeafSums(smesh) if leaves is None else leaves
    coords = _level_coords(smesh, leaves)
    masks = {}

    def src(state, prims, beta_dt, t):
        out = {lev: u.clone() for lev, u in state.items()}
        groups = []
        for lev in sorted(out):
            d1, d2, d3 = smesh.dx(lev)
            groups.append(_group(out[lev], prims[lev], coords[lev],
                                 d1 * d2 * d3,
                                 _valid(smesh.base, out[lev], masks), lev))
        _unsplit_groups(pkg, mhd, groups, beta_dt, t, sums=leaves)
        return out

    src.leaves = leaves
    return src


def _split_sources(pkg):
    return not (pkg.stellar_feedback.disabled and pkg.clip_r <= 0.0)


def _split_sources_on(pkg, g, dt, mhd):
    """Stellar feedback, then the clips, on one group of blocks in place,
    each on the index box of its sphere where the group offers one; ->
    the group's ``u``."""
    with record_function("stellar_feedback"):
        if not pkg.stellar_feedback.disabled:
            gs = regions.of(g, "stellar_feedback",
                            pkg.stellar_feedback.stellar_radius)
            pkg.stellar_feedback.apply(gs["u"], gs["prim"], dt, gs["r"])
    with record_function("clips"):
        if pkg.clip_r > 0.0:
            gc = regions.of(g, "clips", pkg.clip_r)
            _apply_clips(pkg, gc["u"], gc["r"], mhd)
    return g["u"]


def problem_source_first_order(pin, mesh, cfg, eos):
    """The cluster's split sources (``ClusterSplitSrcTerm``,
    cluster.cpp:85-93, as ProblemSourceFirstOrder, main.cpp:106): stellar
    feedback and the clips, once per cycle at full dt on the final state;
    None when neither is configured."""
    pkg = _pkg(pin)
    if not _split_sources(pkg):
        return None
    coords = _Coords.of_mesh(mesh)
    mhd = cfg.fluid == GLMMHD

    def src(u, dt, t):
        with record_function("cons_to_prim"):
            u, prim = cons_to_prim(eos, u, cfg.fluid, cfg.nscalars)
        return _split_sources_on(pkg, _group(u, prim, coords, None, None,
                                             boxed=True), dt, mhd)

    return src


def problem_source_first_order_smr(pin, smesh, cfg, eos):
    """The split sources on a refined mesh, level by level with each
    leaf's radii."""
    pkg = _pkg(pin)
    if not _split_sources(pkg):
        return None
    coords = _level_coords(smesh)
    mhd = cfg.fluid == GLMMHD

    def src(state, dt, t):
        out = {}
        for lev, u in state.items():
            with record_function("cons_to_prim"):
                u, prim = cons_to_prim(eos, u, cfg.fluid, cfg.nscalars)
            out[lev] = _split_sources_on(
                pkg, _group(u, prim, coords[lev], None, None), dt, mhd)
        return out

    return src


def _accretion_dt(trig, parts, m_reg):
    """accretion_cfl * M_region / Mdot (a 0-d tensor)."""
    mdot = trig.rate_from_partials(parts)
    return trig.accretion_cfl * m_reg / torch.clamp(mdot, min=1e-300)


def estimate_timestep(pin, mesh, cfg, eos, prim, t):
    """The accretion-time dt constraint (``ClusterEstimateTimestep``,
    cluster.cpp:95-116, and ``AGNTriggering::EstimateTimeStep``,
    agn_triggering.cpp:555-585): ``accretion_cfl * cold_t_acc`` (a float)
    for COLD_GAS; ``accretion_cfl * M_region / Mdot`` (a 0-d tensor on
    ``prim``'s device) for the Bondi modes, from the current prim (the
    reference uses the previous cycle's reduced values and skips the first
    cycle).  ``estimate_timestep_factory`` keeps the coordinates between
    calls."""
    fn = estimate_timestep_factory(pin, mesh, cfg, eos)
    return math.inf if fn is None else fn(prim, t)


def estimate_timestep_factory(pin, mesh, cfg, eos):
    """The build-time form of ``estimate_timestep``: None without
    triggering, which keeps eligible decks on the fused-dt path."""
    trig = _pkg(pin).agn_triggering
    if trig.mode == "NONE":
        return None
    if trig.mode == "COLD_GAS":
        cap = trig.accretion_cfl * trig.cold_t_acc
        return lambda prim, t: cap
    coords = _Coords.of_mesh(mesh)
    masks = {}

    def fn(prim, t):
        r = coords.on(prim)[3]
        valid = _valid(mesh, prim, masks)
        return _accretion_dt(
            trig, trig.accretion_partials(prim, r, mesh.cell_volume, valid),
            trig.region_mass(prim, r, mesh.cell_volume, valid))

    return fn


def estimate_timestep_smr(pin, smesh, cfg, eos):
    """The accretion dt on a refined mesh from volume-weighted cross-level
    partials; ``fn(state, t)`` or None without triggering."""
    trig = _pkg(pin).agn_triggering
    if trig.mode == "NONE":
        return None
    if trig.mode == "COLD_GAS":
        cap = trig.accretion_cfl * trig.cold_t_acc
        return lambda state, t: cap
    coords = _level_coords(smesh)
    masks = {}

    def fn(state, t):
        parts = None
        m_reg = 0.0
        for lev, u in state.items():
            with record_function("cons_to_prim"):
                _, prim = cons_to_prim(eos, u, cfg.fluid, cfg.nscalars)
            r = coords[lev].on(u)[3]
            d1, d2, d3 = smesh.dx(lev)
            valid = _valid(smesh.base, u, masks)
            p = trig.accretion_partials(prim, r, d1 * d2 * d3, valid)
            parts = p if parts is None else {
                k: parts[k] + p[k] for k in parts}
            m_reg = m_reg + trig.region_mass(prim, r, d1 * d2 * d3, valid)
        return _accretion_dt(trig, parts, m_reg)

    return fn


def _apply_clips(pkg, u, r, mhd):
    """The cluster clips (``cluster_clips.cpp``), in place: inside clip_r,
    the density floor and the velocity, Alfven-speed and temperature
    ceilings."""
    gm1 = pkg.gamma - 1.0
    inside = r < pkg.clip_r
    rho = u[:, IDN].clone()
    if pkg.clip_dfloor > 0.0:
        rho = torch.where(inside & (rho < pkg.clip_dfloor),
                          pkg.clip_dfloor, rho)
        u[:, IDN] = rho
    if math.isfinite(pkg.clip_vceil):
        v2 = (u[:, IM1] ** 2 + u[:, IM2] ** 2 + u[:, IM3] ** 2) / rho ** 2
        v = sqrt(v2)
        over = inside & (v > pkg.clip_vceil)
        fac = torch.where(over, pkg.clip_vceil / torch.clamp(v, min=1e-30),
                          1.0)
        ke_old = 0.5 * rho * v2
        for c in (IM1, IM2, IM3):
            u[:, c] *= fac
        ke_new = ke_old * fac ** 2
        u[:, IEN] += -(ke_old - ke_new)
    if mhd and math.isfinite(pkg.clip_vAceil):
        # the Alfven-speed ceiling as a density *raise*
        b2 = u[:, IB1] ** 2 + u[:, IB2] ** 2 + u[:, IB3] ** 2
        rho_min = b2 / (pkg.clip_vAceil ** 2)
        rho = torch.where(inside & (rho < rho_min), rho_min, rho)
        u[:, IDN] = rho
    if math.isfinite(pkg.clip_Tceil):
        ke = 0.5 * (u[:, IM1] ** 2 + u[:, IM2] ** 2 + u[:, IM3] ** 2) / rho
        me = (0.5 * (u[:, IB1] ** 2 + u[:, IB2] ** 2 + u[:, IB3] ** 2)
              if mhd else 0.0)
        eint = u[:, IEN] - ke - me
        e_ceil = pkg.clip_Tceil / pkg.mbar_over_kb / gm1 * rho
        over = inside & (eint > e_ceil)
        u[:, IEN] = torch.where(over, e_ceil + ke + me, u[:, IEN])
    return u


def history_columns(pin, mesh, cfg, eos):
    """The cluster's history columns (``cluster_reductions.cpp:18-100``
    and the agn_feedback_power column): the cold-gas mass below a
    temperature threshold, the largest radius of AGN-tracer concentration
    above a threshold, and the AGN power."""
    pkg = _pkg(pin)
    gm1 = pkg.gamma - 1.0
    cols = []
    red = "problem/cluster/reductions"
    cold_thresh = pin.get_or_add_real(red, "cold_temp_threshold", -1.0)
    # the reference key is agn_tracer_thresh (cluster.cpp:323-324); the
    # old spelling is honoured as a fallback, as in the JAX package
    tracer_thresh = pin.get_or_add_real(red, "agn_tracer_thresh", -1.0)
    if tracer_thresh < 0.0:
        tracer_thresh = pin.get_or_add_real(red, "agn_tracer_threshold",
                                            -1.0)
    coords = _Coords.of_mesh(mesh)
    sl = mesh.interior_slices
    if cold_thresh > 0.0:
        e_thresh = cold_thresh / pkg.mbar_over_kb / gm1

        def _cold_gas(u, w, mesh_):
            wi = w[sl]
            internal_e = wi[:, IPR] / (gm1 * wi[:, IDN])
            cold = torch.sum(torch.where(internal_e < e_thresh, wi[:, IDN],
                                         0.0))
            with record_function("host_read"):
                return float(cold) * mesh.cell_volume

        cols.append(("cold_mass", _cold_gas))
    if tracer_thresh >= 0.0 and cfg.nscalars > 0:
        nbase = NGLMMHD if cfg.fluid == GLMMHD else NHYDRO
        isl = tuple([sl[0]] + list(sl[2:]))

        def _agn_extent(u, w, mesh_):
            # the tracer CONCENTRATION cons(scalar)/cons(rho) above the
            # threshold (cluster_reductions.cpp:92)
            ui = u[sl]
            conc = ui[:, nbase] / ui[:, IDN]
            x, y, z, _ = coords.on(u)
            r2 = (x ** 2 + y ** 2 + z ** 2)[isl]
            extent = sqrt(torch.amax(torch.where(conc > tracer_thresh, r2,
                                                 0.0)))
            with record_function("host_read"):
                return float(extent)

        cols.append(("agn_extent", _agn_extent))
    masks = {}

    def _feedback_power(u, w, mesh_):
        fb = pkg.agn_feedback
        mdot = 0.0 if fb.triggering is None else fb.triggering.accretion_rate(
            w, coords.on(u)[3], mesh.cell_volume, _valid(mesh, u, masks))
        power = fb.power_and_mass_rate(mdot)[0]
        with record_function("host_read"):
            return float(power)

    cols.append(("agn_feedback_power", _feedback_power))
    return cols

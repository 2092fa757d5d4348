"""The cluster's sphere-bounded sources on the index box that holds their
sphere (``pgen/cluster/regions.py``).

* On the cluster deck at 48^3 over +-0.02 Mpc with the tower's scales cut
  to 0.6 kpc (so that its box, ~41 cells a side, is smaller than the
  block), the uniform hooks' boxed sources against the whole-group path
  the refined hooks take (a group without boxes) on the same state:
  every cell outside every box keeps its input (or, with gravity and SN
  Ia, the whole-group result) bit for bit; every cell inside equals the
  whole-group result to 1e-13 (only the partial sums' order differs).
* The tower's field and its Gaussian mass are exactly 0.0 at every cell
  centre outside the tower's box and beyond its radius, and not all 0.0
  within a tenth of it, in float64 and float32.
* The box helper's edges: a sphere that covers the block, one the mesh
  does not reach, a multi-block group, the 320^3 cell's geometry.
* The counter: every AGN, stellar-feedback and clips call of two uniform
  cycles runs on a box; a refined run's calls run whole.
"""

import numpy as np
import pytest
import torch

from athenapk_tpu_torch.amr.driver import SmrSimulation
from athenapk_tpu_torch.config.parameter_input import ParameterInput
from athenapk_tpu_torch.core.indices import GLMMHD, IDN, IEN, IM1, IM3
from athenapk_tpu_torch.core.mesh import Mesh
from athenapk_tpu_torch.driver import Simulation
from athenapk_tpu_torch.eos.adiabatic import EOS, cons_to_prim
from athenapk_tpu_torch.pgen.cluster import pgen as tcl
from athenapk_tpu_torch.pgen.cluster import regions
from athenapk_tpu_torch.solver.hydro_pkg import HydroConfig
from torch_decks import cluster_deck

torch.set_num_threads(2)

TOL = 1e-13
AGN_NAMES = ("agn_thermal", "agn_kinetic", "agn_triggering",
             "magnetic_tower")
SPLIT_NAMES = ("stellar_feedback", "clips")
# the tower's scales cut from 2 kpc, so that its box leaves cells out
SMALL_TOWER = ("l_scale = 0.002\nl_mass_scale = 0.002",
               "l_scale = 0.0006\nl_mass_scale = 0.0006")
WHOLE_BOX_OFF = """
<problem/cluster/gravity>
gravity_srcterm = false

<problem/cluster/snia_feedback>
disabled = true
"""


def _deck(n=48, half=0.02, extra="", **kw):
    text = cluster_deck(n=n, half=half, **kw)
    assert SMALL_TOWER[0] in text
    return text.replace(*SMALL_TOWER) + extra


def _parts(text):
    pin = ParameterInput.from_string(text)
    mesh = Mesh.from_parameter_input(pin)
    cfg = HydroConfig.from_parameter_input(pin)
    return pin, mesh, cfg, EOS.from_parameter_input(pin)


def _state(mesh, seed=5):
    """(cons, prim) on which every boxed source acts: rho 15-45, T
    2e7-4.8e7 K (cold gas, stellar feedback), |v| ~ 35 (the velocity
    ceiling of 30), B ~ N(0, 3), psi, a scalar."""
    rng = np.random.default_rng(seed)
    shape = (mesh.nblocks,) + mesh.block_shape
    w = np.empty((mesh.nblocks, 10) + mesh.block_shape)
    w[:, IDN] = rng.uniform(15.0, 45.0, shape)
    w[:, 1:4] = 20.0 * rng.standard_normal((mesh.nblocks, 3)
                                           + mesh.block_shape)
    w[:, 4] = w[:, IDN] * rng.uniform(0.3, 0.7, shape)
    w[:, 5:8] = 3.0 * rng.standard_normal((mesh.nblocks, 3)
                                          + mesh.block_shape)
    w[:, 8] = 0.1 * rng.standard_normal(shape)
    w[:, 9] = rng.uniform(0.0, 1.0, shape)
    u = w.copy()
    u[:, IM1:IM3 + 1] = w[:, IDN:IDN + 1] * w[:, 1:4]
    u[:, IEN] = (w[:, 4] / (2.0 / 3.0)
                 + 0.5 * w[:, IDN] * (w[:, 1:4] ** 2).sum(axis=1)
                 + 0.5 * (w[:, 5:8] ** 2).sum(axis=1))
    u[:, 9] = w[:, IDN] * w[:, 9]
    return torch.from_numpy(u), torch.from_numpy(w)


def _outside(coords, radii, shape):
    """bool [NZ, NY, NX]: the cells outside every box of ``radii``."""
    out = torch.ones(shape, dtype=torch.bool)
    for radius in radii:
        box = coords.box(radius)
        assert box is not None, radius
        out[box] = False
    return out


def _close(got, want):
    torch.testing.assert_close(got, want, rtol=TOL, atol=0.0)


@pytest.mark.parametrize("sources", ["boxed_only", "all"])
def test_boxed_sources_match_whole_group(sources):
    text = _deck(extra=WHOLE_BOX_OFF if sources == "boxed_only" else "")
    pin, mesh, cfg, eos = _parts(text)
    pkg = tcl.register_defaults(pin)
    mhd = cfg.fluid == GLMMHD
    u, w = _state(mesh)
    dt, t = 3.0e-4, 0.013
    coords = tcl._Coords.of_mesh(mesh)
    valid = tcl._valid(mesh, u, {})
    fb, tw = pkg.agn_feedback, pkg.magnetic_tower
    unsplit_radii = (fb.thermal_radius, fb.kinetic_radius(),
                     pkg.agn_triggering.accretion_radius,
                     tw.radius(u.dtype))
    split_radii = (pkg.stellar_feedback.stellar_radius, pkg.clip_r)

    # the unsplit source: the uniform hook against the whole group
    regions.counts.clear()
    boxed = tcl.problem_source_unsplit(pin, mesh, cfg, eos)(u, w, mesh, dt,
                                                            t)
    assert all(regions.counts[n]["engaged"] == 1
               and regions.counts[n]["whole"] == 0 for n in AGN_NAMES)
    whole = u.clone()
    tcl._unsplit_groups(pkg, mhd, [tcl._group(whole, w, coords,
                                              mesh.cell_volume, valid)],
                        dt, t)
    assert all(regions.counts[n]["whole"] == 1 for n in AGN_NAMES)
    out = _outside(coords, unsplit_radii, mesh.block_shape)
    assert 0 < int(out.sum()) < out.numel()
    assert torch.equal(boxed[..., out], whole[..., out])
    if sources == "boxed_only":
        assert torch.equal(boxed[..., out], u[..., out])
    _close(boxed, whole)
    changed = (whole != u).flatten(2).any(dim=-1).any(dim=0)
    assert changed[IDN] and changed[IEN] and changed[9]

    # the split source: stellar feedback and the clips
    regions.counts.clear()
    boxed = tcl.problem_source_first_order(pin, mesh, cfg, eos)(u.clone(),
                                                                dt, t)
    assert all(regions.counts[n]["engaged"] == 1 for n in SPLIT_NAMES)
    uu, prim = cons_to_prim(eos, u.clone(), cfg.fluid, cfg.nscalars)
    whole = tcl._split_sources_on(pkg, tcl._group(uu, prim, coords, None,
                                                  None), dt, mhd)
    assert all(regions.counts[n]["whole"] == 1 for n in SPLIT_NAMES)
    out = _outside(coords, split_radii, mesh.block_shape)
    assert 0 < int(out.sum()) < out.numel()
    assert torch.equal(boxed[..., out], u[..., out])
    assert torch.equal(whole[..., out], u[..., out])
    _close(boxed, whole)
    changed = (whole != u).flatten(2).any(dim=-1).any(dim=0)
    assert changed[IDN] and changed[IM1] and changed[IEN]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_tower_is_zero_outside_its_box(dtype):
    pin, mesh, _, _ = _parts(_deck())
    tw = tcl.register_defaults(pin).magnetic_tower
    coords = tcl._Coords.of_mesh(mesh)
    like = torch.zeros((), dtype=dtype)
    x, y, z, r = coords.on(like)
    radius = tw.radius(dtype)
    out = _outside(coords, (radius,), mesh.block_shape)
    assert 0 < int(out.sum()) < out.numel()
    r = r[0]
    beyond, shell = r > radius, (r <= radius) & (r > 0.9 * radius)
    assert bool(shell.any())
    for t in (0.0, 0.013, 0.5):
        fields = tw.unit_field(x, y, z, t) + (tw.mass_profile(x, y, z, t),)
        for f in fields:
            f = f.expand((1,) + r.shape)[0]
            assert f.dtype == dtype
            assert bool((f[out] == 0.0).all())
            assert bool((f[beyond] == 0.0).all())
            assert bool((f[shell] != 0.0).any())


def _group_of(mesh, coords, boxed=True):
    u = torch.zeros((mesh.nblocks, 10) + mesh.block_shape,
                    dtype=torch.float64)
    return tcl._group(u, u.clone(), coords, mesh.cell_volume,
                      tcl._valid(mesh, u, {}), boxed=boxed)


def _multi_block(text):
    """``text`` (a 24^3 deck in one block) in blocks of 8 x 12 x 12."""
    head, tail = text.split("<parthenon/meshblock>", 1)
    block = "<parthenon/meshblock>\nnx1 = 8\nnx2 = 12\nnx3 = 12\n"
    assert tail.startswith("\nnx1 = 24\nnx2 = 24\nnx3 = 24\n"), tail[:40]
    return head + block + tail[len("\nnx1 = 24\nnx2 = 24\nnx3 = 24\n"):]


def _box_covers(coords, box, radius):
    """Every cell centre within ``radius`` lies inside ``box``."""
    x, y, z = coords.host
    near = np.sqrt(x ** 2 + y ** 2 + z ** 2) <= radius
    outside = np.ones(near.shape[1:], dtype=bool)
    outside[box] = False
    return not near[:, outside].any()


@pytest.mark.parametrize("case", ["covers", "outside", "multi_block",
                                  "cell_geometry"])
def test_index_box_edges(case):
    regions.counts.clear()
    if case == "covers":
        pin, mesh, _, _ = _parts(_deck(n=16))
        coords = tcl._Coords.of_mesh(mesh)
        assert coords.box(0.05) is None
        g = _group_of(mesh, coords)
        assert regions.of(g, "clips", 0.05) is g
        assert dict(regions.counts["clips"]) == dict(
            engaged=0, whole=1, cells=mesh.nblocks * int(np.prod(
                mesh.block_shape)))
    elif case == "outside":
        # a mesh that holds no cell near the origin: every box is empty,
        # the partials are 0, Mdot is 0 and the state keeps its bits
        text = _deck(n=16, extra=WHOLE_BOX_OFF)
        for ax in ("x1", "x2", "x3"):
            text = text.replace(f"{ax}min = -0.02", f"{ax}min = 0.03") \
                .replace(f"{ax}max = 0.02", f"{ax}max = 0.07")
        pin, mesh, cfg, eos = _parts(text)
        pkg = tcl.register_defaults(pin)
        coords = tcl._Coords.of_mesh(mesh)
        box = coords.box(pkg.magnetic_tower.radius(torch.float64))
        assert box is not None and box[0] == slice(0, 0)
        u, w = _state(mesh)
        trig = pkg.agn_triggering
        g = regions.of(_group_of(mesh, coords), "agn_triggering",
                       trig.accretion_radius)
        assert g["r"].numel() == 0
        parts = trig.accretion_partials(g["prim"], g["r"], g["vol"],
                                        g["valid"])
        assert float(parts["cold_mass"]) == 0.0
        assert float(trig.rate_from_partials(parts)) == 0.0
        got = tcl.problem_source_unsplit(pin, mesh, cfg, eos)(u, w, mesh,
                                                              3.0e-4, 0.013)
        assert torch.equal(got, u)
        assert all(regions.counts[n]["engaged"] >= 1
                   and regions.counts[n]["cells"] == 0 for n in AGN_NAMES)
    elif case == "multi_block":
        # 3 x 2 x 2 blocks of 8 x 12 x 12: the sphere lies in the middle
        # block along x and straddles the blocks along y and z, so the box
        # is the union of four blocks' boxes, wider than each
        pin, mesh, _, _ = _parts(_multi_block(_deck(n=24)))
        assert (mesh.nb1, mesh.nb2, mesh.nb3) == (3, 2, 2)
        coords = tcl._Coords.of_mesh(mesh)
        radius = 0.002
        box = coords.box(radius)
        full = tuple(slice(0, n) for n in mesh.block_shape)
        held = []
        for b in range(mesh.nblocks):
            p = regions.index_box(tuple(a[b:b + 1] for a in coords.host),
                                  radius)
            p = full if p is None else p
            if all(s.stop > s.start for s in p):
                held.append(p)
        assert len(held) == 4
        for ax in range(3):
            assert box[ax] == slice(min(p[ax].start for p in held),
                                    max(p[ax].stop for p in held))
        assert box[2].stop - box[2].start < mesh.block_shape[2]

        def cells(p):
            return int(np.prod([s.stop - s.start for s in p]))
        assert all(cells(p) < cells(box) for p in held)
        assert _box_covers(coords, box, radius)
        g = regions.of(_group_of(mesh, coords), "clips", radius)
        assert g["u"].shape == (12, 10, 16, 16, 4)
        assert regions.counts["clips"]["engaged"] == 1
    else:
        # the 320^3 cell's geometry (host coordinates only): the tower's
        # box ~140 cells a side, the clips' ~52, of 324
        mesh = Mesh(nx1=320, nx2=320, nx3=320, mbnx1=320, mbnx2=320,
                    mbnx3=320, x1min=-0.125, x1max=0.125, x2min=-0.125,
                    x2max=0.125, x3min=-0.125, x3max=0.125, nghost=2)
        pin, _, _, _ = _parts(cluster_deck(n=16))
        pkg = tcl.register_defaults(pin)
        coords = tcl._Coords.of_mesh(mesh)
        sizes = {}
        for name, radius in (
                ("tower", pkg.magnetic_tower.radius(torch.float64)),
                ("clips", pkg.clip_r),
                ("thermal", pkg.agn_feedback.thermal_radius)):
            box = coords.box(radius)
            sizes[name] = [s.stop - s.start for s in box]
            assert _box_covers(coords, box, radius)
        assert all(135 <= n <= 145 for n in sizes["tower"]), sizes
        assert all(50 <= n <= 56 for n in sizes["clips"]), sizes
        assert all(10 <= n <= 14 for n in sizes["thermal"]), sizes


def test_counter_engaged_uniform_whole_refined(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    regions.counts.clear()
    sim = Simulation(ParameterInput.from_string(_deck(n=32, nlim=2)),
                     quiet=True, device="cpu")
    sim.run()
    assert sim.ncycle == 2
    for name in AGN_NAMES + SPLIT_NAMES:
        c = regions.counts[name]
        calls = 4 if name in AGN_NAMES else 2     # VL2: 2 stages a cycle
        assert c["engaged"] == calls and c["whole"] == 0, (name, c)
        assert 0 < c["cells"] < sim.u[:, 0].numel()

    regions.counts.clear()
    text = cluster_deck(n=16, mb=8, half=0.02, nlim=1, refinement="static",
                        regions=[(0.01, 1)])
    sim = SmrSimulation(ParameterInput.from_string(text), quiet=True,
                        device="cpu")
    sim.run()
    assert sim.ncycle == 1
    for name in AGN_NAMES + SPLIT_NAMES:
        c = regions.counts[name]
        assert c["whole"] > 0 and c["engaged"] == 0, (name, c)

"""Port parity: first-order flux correction (FOFC) against the JAX package.

Twins of ``tests/test_flux_correct.py`` on the port, and the JAX package's
``fofc_bad_cells`` and ``first_order_flux_correct`` against the port's on
the same inputs (numpy, f64, CPU).  The runs compared with the JAX package
step it eagerly (``jax.disable_jit``): the blasts start exactly symmetric
at rest, where the compiled step rounds some selects' ties the other way,
and the port follows the eager step (``ROADMAP.md``, queue 3).  They use
the near-vacuum blasts of ``torch_decks.NEAR_VACUUM`` with LimO3, whose
first cycles take the rescue; the decks of ``test_flux_correct.py`` as
given never need it.  Tolerance 1e-12 relative (the operations are the
same; measured 0).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from athenapk_tpu.amr.driver import SmrSimulation as JSmrSim
from athenapk_tpu.config.parameter_input import ParameterInput as JPin
from athenapk_tpu.driver import Simulation as JSim
from athenapk_tpu.eos.adiabatic import EOS as JEOS
from athenapk_tpu.solver import hydro_pkg as jhp
from athenapk_tpu_torch.amr.driver import SmrSimulation as TSmrSim
from athenapk_tpu_torch.amr.smr import SmrMesh
from athenapk_tpu_torch.amr.smr_hydro import SmrHydro
from athenapk_tpu_torch.config.parameter_input import ParameterInput as TPin
from athenapk_tpu_torch.core.indices import IDN, IPR
from athenapk_tpu_torch.core.mesh import Mesh
from athenapk_tpu_torch.driver import Simulation as TSim
from athenapk_tpu_torch.eos.adiabatic import EOS, cons_to_prim, prim_to_cons
from athenapk_tpu_torch.riemann import solve_riemann
from athenapk_tpu_torch.solver import hydro_pkg as thp
from athenapk_tpu_torch.solver import sweep
from athenapk_tpu_torch.solver.hydro_pkg import (HydroConfig,
                                                 first_order_flux_correct)
from test_flux_correct import DECK, SMR_DECK
from torch_decks import NEAR_VACUUM

torch.set_num_threads(2)

TOL = 1e-12
# the JAX package's axis of each direction, ``_AXIS_OF_DIR`` of its SMR path
JAX_AXIS = {1: -1, 2: -2, 3: -3}


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def test_strong_blast_stays_positive_port():
    """Twin of ``test_strong_blast_stays_positive``: the 2-D strong blast
    with FOFC on the port (PPM + HLLC + RK2, 64^2, to tlim)."""
    sim = TSim(TPin.from_string(DECK), quiet=True, device="cpu").run()
    _, w = sim.pkg.cons_to_prim(sim.u)
    w = w[sim.mesh.interior_slices]
    assert bool(torch.isfinite(w).all())
    assert w[:, IDN].min() > 0.0 and w[:, IPR].min() > 0.0


def _blast_state(seed, nb=2, n=8, nvar=5):
    """A blast-like conserved state (density and pressure positive) on
    ghost-free blocks, and its prim, from numpy."""
    rng = np.random.default_rng(seed)
    w = np.zeros((nb, nvar, n, n, n))
    w[:, 0] = 0.5 + rng.random((nb, n, n, n))
    w[:, 1:4] = 0.5 * rng.standard_normal((nb, 3, n, n, n))
    w[:, 4] = 0.2 + rng.random((nb, n, n, n))
    if nvar == 9:
        w[:, 5:8] = 0.3 * rng.standard_normal((nb, 3, n, n, n))
        w[:, 8] = 0.01 * rng.standard_normal((nb, n, n, n))
    return w


@pytest.mark.parametrize("fluid", ["euler", "glmmhd"])
def test_fofc_functions_match_jax(fluid):
    """The bad-cell mask and the corrected fluxes of both packages on the
    same state and the same fluxes, tampered so that a few interior cells'
    candidates go rho <= 0, p <= 0 or NaN (each pass of the rescue has
    work), with the interior excluding a rim of each block."""
    nvar = 9 if fluid == "glmmhd" else 5
    c_h = 0.7 if fluid == "glmmhd" else 0.0
    w = _blast_state(11, nvar=nvar)
    n = w.shape[-1]
    mesh = Mesh(nx1=n, nx2=n, nx3=n, mbnx1=n, mbnx2=n, mbnx3=n, x1min=0.0,
                x1max=1.0, x2min=0.0, x2max=1.0, x3min=0.0, x3max=1.0,
                nghost=0)
    teos, jeos = EOS(gamma=5.0 / 3.0), JEOS(gamma=5.0 / 3.0)
    prim = torch.tensor(w)
    u = prim_to_cons(teos, prim, fluid)
    cfg = HydroConfig(fluid=fluid, riemann="hlle", reconstruction="ppm",
                      first_order_flux_correct=True)
    fluxes = sweep.compute_fluxes(prim, c_h, mesh, cfg, teos, "ppm")
    dt, dx = 0.02, mesh.dx1
    for d, k, j, i in ((1, 3, 4, 5), (2, 2, 3, 3), (3, 5, 5, 2), (1, 6, 2, 4)):
        # a large outflow at one face drains the cell before it
        idx = [0, 0, k, j, i]
        idx[thp.AXIS_OF_DIR[d]] += 1
        fluxes[d][tuple(idx)] += 3.0 * float(u[0, 0, k, j, i]) * dx / dt
    fluxes[2][1, 4, 3, 3, 3] = float("nan")
    fluxes[3][1, 4, 2, 6, 1] -= 4.0 * float(u[1, 4, 2, 6, 1]) * dx / dt
    interior = torch.zeros((n, n, n), dtype=torch.bool)
    interior[1:-1, 1:-1, 1:-1] = True
    interior = interior[None, None]
    dxs = {d: mesh.dx[d - 1] for d in (1, 2, 3)}
    args = (1.0, 0.0, dt, c_h)
    got = first_order_flux_correct(cfg, teos, (1, 2, 3), dxs, interior, u, u,
                                   prim, fluxes, *args)
    jcfg = jhp.HydroConfig(fluid=fluid, riemann="hlle", reconstruction="ppm",
                           first_order_flux_correct=True)
    ref = jhp.first_order_flux_correct(
        jcfg, jeos, (1, 2, 3), JAX_AXIS, dxs, jnp.asarray(interior.numpy()),
        jnp.asarray(u.numpy()), jnp.asarray(u.numpy()),
        jnp.asarray(w), {d: jnp.asarray(f.numpy()) for d, f in
                         fluxes.items()}, *args)
    for d in (1, 2, 3):
        r, g = np.asarray(ref[d]), got[d].numpy()
        assert np.array_equal(np.isnan(r), np.isnan(g))
        ok = ~np.isnan(r)
        assert _rel(g[ok], r[ok]) <= TOL
    # the bad-cell masks of the tampered candidate, and of the corrected one
    for fl_t, fl_j in ((fluxes, {d: jnp.asarray(f.numpy())
                                 for d, f in fluxes.items()}), (got, ref)):
        div = sweep.flux_divergence(fl_t, mesh)
        cand = u - dt * div
        jdiv = sum((jnp.roll(fl_j[d], -1, axis=JAX_AXIS[d]) - fl_j[d])
                   / dxs[d] for d in (1, 2, 3))
        jcand = jnp.asarray(u.numpy()) - dt * jdiv
        bad_t = thp.fofc_bad_cells(cfg, cand, interior)
        bad_j = jhp.fofc_bad_cells(jcfg, jcand,
                                   jnp.asarray(interior.numpy()))
        np.testing.assert_array_equal(bad_t.numpy(), np.asarray(bad_j))
        if fl_t is fluxes:
            assert int(bad_t.sum()) >= 5
        else:
            # what the four passes leave: no bad density inside
            rho = cand[:, :1][interior.expand_as(cand[:, :1])]
            assert bool((rho > 0).all())


def test_fofc_mechanism_replaces_exactly_bad_faces_port():
    """Twin of ``test_fofc_mechanism_replaces_exactly_bad_faces``: on the
    port's refined-mesh stepper, one tampered face flux drains one interior
    cell past rho = 0; the corrected fluxes are LLF on that cell's six
    faces and bit-identical to the input everywhere else."""
    base = Mesh(nx1=16, nx2=16, nx3=16, mbnx1=8, mbnx2=8, mbnx3=8,
                x1min=-0.5, x1max=0.5, x2min=-0.5, x2max=0.5,
                x3min=-0.5, x3max=0.5, nghost=3)
    sm = SmrMesh(base, [(-0.5, 0.0, -0.5, 0.0, -0.5, 0.0, 1)])
    eos = EOS(gamma=5.0 / 3.0)
    cfg = HydroConfig(fluid="euler", riemann="hllc", reconstruction="ppm",
                      integrator="rk2", cfl=0.3,
                      first_order_flux_correct=True)
    sh = SmrHydro(sm, cfg, eos, device="cpu")
    assert not sh._stage_rung       # FOFC takes the negdiv-faces rung
    w = np.zeros((5,) + base.block_shape)
    w[0], w[1], w[4] = 1.0, 0.1, 0.5
    state = {lev: prim_to_cons(eos, torch.tensor(np.broadcast_to(
        w, (len(ids), 5) + base.block_shape).copy()), "euler")
        for lev, ids in sm.level_ids.items()}
    state = sh.fill_ghosts(state)
    lev = 1
    u = state[lev]
    _, prim = cons_to_prim(eos, u, "euler", 0)
    lm = sh.level_mesh[lev]
    fluxes = sweep.compute_fluxes(prim, 0.0, lm, cfg, eos, "ppm")
    g = base.nghost
    k, j, i = g + 4, g + 3, g + 2
    dt = 1.0e-3
    dx = lm.dx[0]
    tampered = {d: f.clone() for d, f in fluxes.items()}
    tampered[1][0, 0, k, j, i + 1] += 2.0 * float(u[0, 0, k, j, i]) * dx / dt
    dxmap = {d: lm.dx[d - 1] for d in (1, 2, 3)}
    fixed = first_order_flux_correct(cfg, eos, (1, 2, 3), dxmap, sh._interior,
                                     u, u, prim, tampered, 1.0, 0.0, dt, 0.0)
    llf = {d: solve_riemann("llf", "euler", eos,
                            torch.roll(prim, 1, dims=thp.AXIS_OF_DIR[d]),
                            prim, d, c_h=0.0)
           for d in (1, 2, 3)}
    for d, faces in ((1, ((k, j, i), (k, j, i + 1))),
                     (2, ((k, j, i), (k, j + 1, i))),
                     (3, ((k, j, i), (k + 1, j, i)))):
        for f in faces:
            assert torch.equal(fixed[d][(0, slice(None)) + f],
                               llf[d][(0, slice(None)) + f])
        changed = set(map(tuple, (fixed[d] != tampered[d])[0, 0]
                          .nonzero().tolist()))
        assert changed <= set(faces), (d, changed)
    div_bad = sweep.flux_divergence(tampered, lm)
    div_fix = sweep.flux_divergence(fixed, lm)
    assert float((u - dt * div_bad)[0, 0, k, j, i]) <= 0.0
    assert float((u - dt * div_fix)[0, 0, k, j, i]) > 0.0


def _cube(n, mb=None):
    mb = mb or n
    return [f"parthenon/mesh/nx{k}={n}" for k in (1, 2, 3)] + \
        [f"parthenon/meshblock/nx{k}={mb}" for k in (1, 2, 3)]


def test_fofc_blast_matches_jax():
    """The 3-D near-vacuum blast with LimO3 + HLLC + RK2 and FOFC, 16^3,
    5 cycles: the port's state and time equal the JAX package's (stepped
    eagerly), and the port took the rescue on some stages."""
    over = (["hydro/reconstruction=limo3", "parthenon/time/nlim=5",
             "parthenon/time/tlim=10", "parthenon/mesh/merge_blocks=true"]
            + NEAR_VACUUM + _cube(16))
    js = JSim(JPin.from_string(DECK, over), quiet=True)
    ts = TSim(TPin.from_string(DECK, over), quiet=True, device="cpu")
    ts.load_state(np.asarray(js.u), js.t, js.ncycle)
    ts.run()
    with jax.disable_jit():
        js.run()
    assert ts.ncycle == js.ncycle == 5
    assert ts.pkg.fofc_rescues >= 1
    assert _rel(ts.u.numpy(), np.asarray(js.u)) <= TOL
    assert ts.t == pytest.approx(js.t, rel=1e-12)


def test_fofc_smr_blast_matches_jax():
    """The refined-mesh twin: ``SMR_DECK`` (two levels, 16^3 base) as a
    near-vacuum blast with LimO3 + HLLC + RK2, 3 cycles: per-level rescues
    before the coarse-fine restriction give the JAX package's state (stepped
    eagerly), and mass is kept across levels."""
    over = (["hydro/reconstruction=limo3", "parthenon/time/integrator=rk2",
             "parthenon/time/nlim=3", "parthenon/time/tlim=10"]
            + NEAR_VACUUM + [f"parthenon/mesh/nx{k}=16" for k in (1, 2, 3)])
    js = JSmrSim(JPin.from_string(SMR_DECK, over), quiet=True)
    ts = TSmrSim(TPin.from_string(SMR_DECK, over), quiet=True, device="cpu")
    ts.load_state({lev: np.asarray(v) for lev, v in js.state.items()}, js.t,
                  js.ncycle)
    m0 = ts.total_mass()
    ts.run()
    with jax.disable_jit():
        js.run()
    assert ts.ncycle == js.ncycle == 3
    assert ts._stepper_now().fofc_rescues >= 1
    for lev, u in js.state.items():
        assert _rel(ts.state[lev].numpy(), np.asarray(u)) <= TOL
    assert abs(ts.total_mass() - m0) <= 1e-13 * abs(m0)


def test_fofc_routes_to_the_sweep(monkeypatch, capsys):
    """With FOFC the whole-stage rung does not apply: asked for, the
    package says so once and runs the sweep path."""
    monkeypatch.setenv("ATHENAPK_PALLAS_STAGE", "1")
    over = ["parthenon/time/nlim=1", "parthenon/mesh/nghost=0"] + _cube(8)
    sim = TSim(TPin.from_string(DECK, over), quiet=True, device="cpu")
    assert capsys.readouterr().out.count("runs the sweep kernel") == 1
    assert sim.pkg._stage_rung and not sim.pkg._use_fused_stage()
    plain = TSim(TPin.from_string(
        DECK, over + ["hydro/first_order_flux_correct=false"]), quiet=True,
        device="cpu")
    assert plain.pkg._use_fused_stage()

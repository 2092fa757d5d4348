"""The kernels on the card: ``negdiv_cuda`` against ``negdiv_plain`` (3-D,
2-D and 1-D; Euler and GLM-MHD) and ``stage_cuda`` against ``stage_plain``,
and the decks of both paths through ``Simulation`` on the card; the
face-capturing forms of both kernels (``stage_faces_cuda``,
``negdiv_faces_cuda``) against their plain twins, also at the level sizes
an adaptive mesh hands them, and refined-mesh decks, static and adaptive,
through ``SmrSimulation`` on the card; the adaptive remesh on the card
against the CPU; every kernel route with passive scalars against its
plain version (the fluid kernels' instantiations for decks with scalars
and the two scalar kernels); the EOS kernel against the plain EOS, bit for
bit, and its launches in a wave cycle on both rungs.

Every test here needs a CUDA card (the kernel has no CPU mode) and skips
with that reason elsewhere.  The file imports neither jax nor the JAX
package, so it also runs where only the port is installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda.py
"""

import contextlib
import io

import numpy as np
import pytest
import torch

from athenapk_tpu_torch.amr.driver import SmrSimulation
from athenapk_tpu_torch.amr.remesh import remesh
from athenapk_tpu_torch.amr.smr import LevelMesh, SmrMesh, SmrState
from athenapk_tpu_torch.config.parameter_input import ParameterInput
from athenapk_tpu_torch.core.mesh import Mesh
from athenapk_tpu_torch.driver import Simulation
from athenapk_tpu_torch.eos.adiabatic import EOS, prim_to_cons
from athenapk_tpu_torch.solver import stage, sweep
from athenapk_tpu_torch.solver.hydro_pkg import HydroConfig
from torch_decks import (ADAPTIVE_2D, CASES, HST_BLOCK, SMR_1D, SMR_2D,
                         SMR_3D, deck, symmetry_noise)

pytestmark = pytest.mark.cuda

C_H = 1.3
LAYOUTS = {"ghostfree": (32, 32, 0), "ghosted": (32, 16, 3)}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _mesh(layout):
    n, mb, g = LAYOUTS[layout]
    return Mesh(nx1=n, nx2=n, nx3=n, mbnx1=mb, mbnx2=mb, mbnx3=mb,
                x1min=0.0, x1max=1.0, x2min=0.0, x2max=1.5, x3min=0.0,
                x3max=1.5, nghost=g)


def _prim(mesh, dtype, device, seed=9):
    """Smooth GLM-MHD state, every component nonzero, plus seeded noise."""
    rng = np.random.default_rng(seed)
    x, y, z = mesh.cell_centers_mesh()
    tp = 2.0 * np.pi
    w = np.zeros((mesh.nblocks, 9) + mesh.block_shape)
    w[:, 0] = 1.0 + 0.1 * np.sin(tp * x) * np.cos(tp * y) + 0.0 * z
    w[:, 1] = 0.3 + 0.2 * np.sin(tp * z) + 0.0 * x
    w[:, 2] = 0.2 + 0.1 * np.cos(tp * x) + 0.0 * y
    w[:, 3] = -0.15 + 0.1 * np.sin(tp * y) + 0.0 * z
    w[:, 4] = 0.6 + 0.05 * np.cos(tp * (x + y + z))
    w[:, 5] = 1.0 + 0.0 * x
    w[:, 6] = 0.5 + 0.1 * np.cos(tp * z) + 0.0 * x
    w[:, 7] = 0.1 + 0.1 * np.sin(tp * x) + 0.0 * y
    w[:, 8] = 0.01 * np.sin(tp * (x - y)) + 0.0 * z
    w += 1e-3 * rng.standard_normal(w.shape)
    return torch.tensor(w, dtype=dtype, device=device)


@pytest.mark.parametrize("dtype,tol", [
    # both dtypes are built without FMA contraction and fold the same
    # reciprocals as the plain version, so they agree bit for bit on the
    # card; the tolerances leave room for rounding, which -div(F)'s
    # difference of neighbouring fluxes amplifies
    (torch.float64, 1e-10),
    (torch.float32, 1e-4),
])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("recon", ["dc", "plm", "ppm"])
def test_kernel_matches_plain(card, recon, layout, dtype, tol):
    mesh = _mesh(layout)
    cfg = HydroConfig(fluid="glmmhd", riemann="hlld", reconstruction=recon)
    eos = EOS(gamma=5.0 / 3.0)
    prim = _prim(mesh, dtype, card)
    before = sweep.negdiv_cuda.launches
    got = sweep.fused_negdiv(prim, C_H, mesh, cfg, eos, recon)
    torch.cuda.synchronize()
    assert sweep.negdiv_cuda.launches == before + 3
    ref = sweep.negdiv_plain(prim, C_H, mesh, cfg, eos, recon)
    sl = mesh.interior_slices
    # max |kernel - plain| over max |plain|, for each variable
    dims = [0, 2, 3, 4]
    err = ((got[sl] - ref[sl]).abs().amax(dim=dims)
           / ref[sl].abs().amax(dim=dims)).max().item()
    assert err <= tol


def test_wrapper_refuses_what_the_kernel_does_not_take(card):
    mesh = _mesh("ghostfree")
    eos = EOS(gamma=5.0 / 3.0)
    cfg = HydroConfig(fluid="glmmhd", riemann="hlld", reconstruction="ppm")
    prim = _prim(mesh, torch.float64, card)
    with pytest.raises(TypeError):
        sweep.negdiv_cuda(prim.half(), C_H, mesh, cfg, eos, "ppm")
    with pytest.raises(ValueError, match="contiguous"):
        sweep.negdiv_cuda(prim.transpose(2, 4), C_H, mesh, cfg, eos, "ppm")
    with pytest.raises(ValueError):
        sweep.negdiv_cuda(prim[..., :-1], C_H, mesh, cfg, eos, "ppm")
    # a deck with scalars runs on the kernels: the fluid rows as without
    # them, the scalar row against the plain version
    scalars = HydroConfig(fluid="glmmhd", riemann="hlld",
                          reconstruction="ppm", nscalars=1)
    prim_s = torch.cat([prim, 0.5 + 0.4 * torch.tanh(prim[:, :1])], dim=1)
    before = sweep.negdiv_scalars_cuda.launches
    got = sweep.fused_negdiv(prim_s, C_H, mesh, scalars, eos, "ppm")
    assert sweep.negdiv_scalars_cuda.launches == before + 3
    assert torch.equal(got[:, :9], sweep.negdiv_cuda(prim, C_H, mesh, cfg,
                                                     eos, "ppm"))
    ref = sweep.negdiv_plain(prim_s, C_H, mesh, scalars, eos, "ppm")
    assert _per_var_err(got, ref) <= 1e-10


def test_simulation_on_card_matches_plain_steps(card, tmp_path, monkeypatch):
    """Five f64 cycles of the linear-wave deck through the kernel and with
    the plain -div(F) forced agree to 1e-10."""
    deck = """
<job>
problem_id = linear_wave_mhd
<problem/linear_wave>
wave_flag = 0
amp = 1.0e-6
test = true
<parthenon/mesh>
nghost = 0
nx1 = 16
x1min = 0.0
x1max = 3.0
nx2 = 16
x2min = 0.0
x2max = 1.5
nx3 = 16
x3min = 0.0
x3max = 1.5
<parthenon/time>
integrator = vl2
cfl = 0.3
tlim = 100.0
nlim = 5
<hydro>
fluid = glmmhd
riemann = hlld
reconstruction = ppm
gamma = 1.666666666666667
"""
    monkeypatch.chdir(tmp_path)
    states = []
    for forced_plain in (False, True):
        if forced_plain:
            monkeypatch.setattr(sweep, "fused_negdiv", sweep.negdiv_plain)
        sim = Simulation(ParameterInput.from_string(deck), quiet=True)
        assert sim.u.is_cuda and sim.u.dtype == torch.float64
        before = sweep.negdiv_cuda.launches
        with contextlib.redirect_stdout(io.StringIO()):
            sim.run()
        assert sweep.negdiv_cuda.launches - before == \
            (0 if forced_plain else 2 * 3 * 5)
        states.append((sim.u.cpu().numpy(), sim.t))
    (uk, tk), (up, tp) = states
    assert np.abs(uk - up).max() <= 1e-10 * np.abs(up).max()
    assert tk == pytest.approx(tp, rel=1e-10)


# ------------------------------------------- Euler, and 1-D and 2-D meshes
PAIRS = list(sweep.KERNEL_SOLVERS)       # every (fluid, solver) pair
RECONS = list(sweep.KERNEL_RECONS)      # every reconstruction
# (nx1, nx2, nx3, block nx1, nx2, nx3, nghost)
FLAT_LAYOUTS = {
    "3d_ghostfree": (32, 24, 16, 32, 24, 16, 0),
    "2d_ghostfree": (96, 80, 1, 96, 80, 1, 0),
    "2d_ghosted": (64, 64, 1, 32, 32, 1, 3),
    "1d_ghostfree": (500, 1, 1, 500, 1, 1, 0),
    "1d_ghosted": (256, 1, 1, 64, 1, 1, 3),
}


def _flat_mesh(layout):
    n1, n2, n3, m1, m2, m3, g = FLAT_LAYOUTS[layout]
    return Mesh(nx1=n1, nx2=n2, nx3=n3, mbnx1=m1, mbnx2=m2, mbnx3=m3,
                x1min=0.0, x1max=1.0, x2min=0.0, x2max=1.5, x3min=0.0,
                x3max=1.5, nghost=g)


def _random_prim(mesh, fluid, seed):
    """Positive density and pressure, every other component of either
    sign (numpy, f64)."""
    rng = np.random.default_rng(seed)
    nvar = 9 if fluid == "glmmhd" else 5
    cells = (mesh.nblocks,) + mesh.block_shape
    w = np.ones((mesh.nblocks, nvar) + mesh.block_shape)
    w[:, 0] = 1.0 + 0.3 * rng.random(cells)
    w[:, 1:4] = 0.3 * rng.standard_normal((cells[0], 3) + cells[1:])
    w[:, 4] = 1.0 + 0.2 * rng.random(cells)
    if nvar == 9:
        w[:, 5:8] = 0.2 * rng.standard_normal((cells[0], 3) + cells[1:])
        w[:, 8] = 0.01 * rng.standard_normal(cells)
    return w


def _per_var_err(got, ref):
    dims = [0, 2, 3, 4]
    return ((got - ref).abs().amax(dim=dims)
            / ref.abs().amax(dim=dims)).max().item()


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-10),
                                       (torch.float32, 1e-4)])
@pytest.mark.parametrize("layout", sorted(FLAT_LAYOUTS))
@pytest.mark.parametrize("recon", RECONS)
@pytest.mark.parametrize("fluid,riemann", PAIRS)
def test_sweep_kernel_euler_and_flat_meshes(card, fluid, riemann, recon,
                                            layout, dtype, tol):
    mesh = _flat_mesh(layout)
    cfg = HydroConfig(fluid=fluid, riemann=riemann, reconstruction=recon)
    eos = EOS(gamma=5.0 / 3.0)
    prim = torch.tensor(_random_prim(mesh, fluid, 13), dtype=dtype,
                        device=card)
    c_h = C_H if fluid == "glmmhd" else 0.0
    before = sweep.negdiv_cuda.launches
    got = sweep.fused_negdiv(prim, c_h, mesh, cfg, eos, recon)
    torch.cuda.synchronize()
    assert sweep.negdiv_cuda.launches - before == len(sweep.active_dirs(mesh))
    ref = sweep.negdiv_plain(prim, c_h, mesh, cfg, eos, recon)
    sl = mesh.interior_slices
    assert bool(torch.isfinite(got[sl]).all())
    assert _per_var_err(got[sl], ref[sl]) <= tol


# ------------------------------------------------------- the stage kernel
FLOORS = dict(density_floor=0.9, pressure_floor=0.8, internal_e_floor=1.25)
# ghost-free extents that the kernel's 7 x 14 columns do not divide
STAGE_LAYOUTS = {"ghostfree": (40, 20, 10, 40, 20, 10, 0),
                 "ghosted": (32, 32, 32, 16, 16, 16, 3)}


def _stage_states(mesh, fluid, seed):
    """Two distinct conserved states; in the first, a few percent of the
    cells lie below the density floor and a few below the pressure and
    internal-energy floors (mild dips: PPM's edge states stay positive)."""
    rng = np.random.default_rng(seed)
    w = _random_prim(mesh, fluid, seed + 100)
    pick = rng.random((mesh.nblocks,) + mesh.block_shape)
    w[:, 0][pick < 0.03] = 0.8
    w[:, 4][(pick > 0.03) & (pick < 0.08)] = 0.6
    u0 = prim_to_cons(EOS(gamma=5.0 / 3.0), torch.tensor(w), fluid)
    return u0, 1.01 * u0 + 0.001


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-10),
                                       (torch.float32, 1e-4)])
@pytest.mark.parametrize("layout", sorted(STAGE_LAYOUTS))
@pytest.mark.parametrize("recon", RECONS)
@pytest.mark.parametrize("fluid,riemann", PAIRS)
def test_stage_kernel_matches_plain(card, fluid, riemann, recon, layout,
                                    dtype, tol):
    n1, n2, n3, m1, m2, m3, g = STAGE_LAYOUTS[layout]
    mesh = Mesh(nx1=n1, nx2=n2, nx3=n3, mbnx1=m1, mbnx2=m2, mbnx3=m3,
                x1min=0.0, x1max=1.0, x2min=0.0, x2max=1.5, x3min=0.0,
                x3max=1.5, nghost=g)
    cfg = HydroConfig(fluid=fluid, riemann=riemann, reconstruction=recon)
    eos = EOS(gamma=5.0 / 3.0, **FLOORS)
    u0, u1 = (a.to(device=card, dtype=dtype)
              for a in _stage_states(mesh, fluid, 17))
    u0f, _ = stage.cons_to_prim(eos, u0, fluid, 0)
    assert int((u0f[:, 0] != u0[:, 0]).sum()) > 10     # floors are tripped
    assert int((u0f[:, 4] != u0[:, 4]).sum()) > 10
    c_h = C_H if fluid == "glmmhd" else 0.0
    emit_dt = g == 0
    args = (u0, u1, 0.25, 0.75, 1e-3, c_h, mesh, cfg, eos, recon)
    before = stage.stage_cuda.launches
    got = stage.fused_stage(*args, emit_dt=emit_dt, emit_prim=True)
    torch.cuda.synchronize()
    assert stage.stage_cuda.launches == before + 1
    ref = stage.stage_plain(*args, emit_dt=emit_dt, emit_prim=True)
    sl = mesh.interior_slices
    assert bool(torch.isfinite(got[0][sl]).all())
    assert _per_var_err(got[0][sl], ref[0][sl]) <= tol
    assert _per_var_err(got[-1], ref[-1]) <= tol          # stage-start prim
    if emit_dt:
        assert got[1].min().item() == pytest.approx(ref[1].min().item(),
                                                    rel=tol)
    alone = stage.fused_stage(*args)
    assert torch.equal(alone, got[0])


def test_stage_wrapper_refuses_what_the_kernel_does_not_take(card):
    mesh = _mesh("ghostfree")
    eos = EOS(gamma=5.0 / 3.0)
    cfg = HydroConfig(fluid="glmmhd", riemann="hlld", reconstruction="ppm")
    u = _prim(mesh, torch.float64, card)
    args = (0.25, 0.75, 1e-3, C_H, mesh, cfg, eos, "ppm")
    with pytest.raises(TypeError):
        stage.stage_cuda(u.half(), u.half(), *args)
    with pytest.raises(ValueError, match="agree"):
        stage.stage_cuda(u, u.float(), *args)
    with pytest.raises(ValueError, match="contiguous"):
        stage.stage_cuda(u.transpose(2, 4), u, *args)
    with pytest.raises(ValueError, match="CUDA tensor"):
        stage.stage_cuda(u.cpu(), u.cpu(), *args)
    with pytest.raises(ValueError, match="ghost-free"):
        stage.stage_cuda(u, u, 0.25, 0.75, 1e-3, C_H, _mesh("ghosted"), cfg,
                         eos, "ppm", emit_dt=True)
    # a deck with scalars runs on the kernels
    scalars = HydroConfig(fluid="glmmhd", riemann="hlld",
                          reconstruction="ppm", nscalars=1)
    cons = prim_to_cons(eos, u, "glmmhd")
    u_s = torch.cat([cons, cons[:, :1] * (0.5 + 0.4 * torch.tanh(u[:, 1:2]))],
                    dim=1)
    before = stage.stage_scalars_cuda.launches
    got = stage.fused_stage(u_s, u_s, 0.25, 0.75, 1e-3, C_H, mesh, scalars,
                            eos, "ppm")
    assert stage.stage_scalars_cuda.launches == before + 1
    assert torch.equal(got[:, :9], stage.fused_stage(
        cons, cons, 0.25, 0.75, 1e-3, C_H, mesh, cfg, eos, "ppm"))
    ref = stage.stage_plain(u_s, u_s, 0.25, 0.75, 1e-3, C_H, mesh, scalars,
                            eos, "ppm")
    assert _per_var_err(got, ref) <= 1e-10


# ------------------------------------------------ decks through Simulation
WAVE_DECK = """
<job>
problem_id = linear_wave_mhd
<problem/linear_wave>
wave_flag = 0
amp = 1.0e-6
test = true
<parthenon/mesh>
nghost = 0
nx1 = 32
x1min = 0.0
x1max = 3.0
nx2 = 16
x2min = 0.0
x2max = 1.5
nx3 = 16
x3min = 0.0
x3max = 1.5
<parthenon/time>
integrator = vl2
cfl = 0.3
tlim = 100.0
nlim = 5
<hydro>
fluid = glmmhd
riemann = hlld
reconstruction = ppm
gamma = 1.666666666666667
<parthenon/output1>
file_type = hst
"""

OT_DECK = """
<job>
problem_id = orszag_tang
<parthenon/mesh>
nghost = 3
nx1 = 64
x1min = 0.0
x1max = 1.0
nx2 = 64
x2min = 0.0
x2max = 1.0
nx3 = 1
x3min = -0.5
x3max = 0.5
<parthenon/time>
integrator = vl2
cfl = 0.3
tlim = 0.5
nlim = 5
<hydro>
fluid = glmmhd
riemann = hlld
reconstruction = ppm
gamma = 1.666666666666667
<parthenon/output1>
file_type = hst
"""

SOD_DECK = """
<job>
problem_id = sod
<parthenon/mesh>
nghost = 2
nx1 = 128
x1min = 0.0
x1max = 1.0
ix1_bc = outflow
ox1_bc = outflow
nx2 = 1
x2min = -0.5
x2max = 0.5
nx3 = 1
x3min = -0.5
x3max = 0.5
<parthenon/time>
integrator = vl2
cfl = 0.3
tlim = 0.25
nlim = 5
<hydro>
fluid = euler
riemann = hllc
reconstruction = plm
gamma = 1.4
<parthenon/output1>
file_type = hst
"""


def _run_deck(deck, device, outdir, noise=0.0):
    """Run the deck on ``device`` from its initial state times
    ``1 + noise * N(0, 1)`` (seeded); returns the simulation and its
    history rows."""
    outdir.mkdir(parents=True, exist_ok=True)
    sim = Simulation(ParameterInput.from_string(deck), quiet=True,
                     device=device)
    if noise:
        u = sim.u.cpu().numpy()
        u = u * (1.0 + noise * np.random.default_rng(21).standard_normal(
            u.shape))
        sim.load_state(u, 0.0, 0)
        sim.u = sim.pkg.apply_boundaries(sim.u)
    with contextlib.chdir(outdir), contextlib.redirect_stdout(io.StringIO()):
        sim.run()
    hst = np.loadtxt(next(outdir.glob("*.hst")))
    return sim, hst


@pytest.mark.parametrize("rung,stage_launches,sweep_launches", [
    ("ATHENAPK_PALLAS_STAGE", 10, 0), ("default", 0, 30)])
def test_wave_deck_on_the_rungs_on_card(card, rung, stage_launches,
                                        sweep_launches, tmp_path,
                                        monkeypatch):
    """Five f64 cycles of the 3-D MHD wave on the stage rung and on the
    default sweep path on the card against the default path on the CPU:
    state 1e-10, every dt."""
    monkeypatch.delenv("ATHENAPK_PALLAS_STAGE", raising=False)
    ref, href = _run_deck(WAVE_DECK, "cpu", tmp_path / "cpu")
    if rung != "default":
        monkeypatch.setenv(rung, "1")
    n_stage, n_sweep = stage.stage_cuda.launches, sweep.negdiv_cuda.launches
    sim, hst = _run_deck(WAVE_DECK, "cuda", tmp_path / "card")
    assert sim.u.is_cuda and sim.ncycle == 5
    assert stage.stage_cuda.launches - n_stage == stage_launches
    assert sweep.negdiv_cuda.launches - n_sweep == sweep_launches
    a, b = ref.u.numpy(), sim.u.cpu().numpy()
    assert np.abs(a - b).max() <= 1e-10 * np.abs(a).max()
    np.testing.assert_allclose(hst[:, :2], href[:, :2], rtol=1e-10)


@pytest.mark.parametrize("deck,launches_per_stage", [(OT_DECK, 2),
                                                     (SOD_DECK, 1)],
                         ids=["orszag_tang", "sod"])
def test_flat_decks_on_card_match_cpu(card, deck, launches_per_stage,
                                      tmp_path):
    """Orszag-Tang (2-D, ghost-free) and Sod (1-D, ghosted, Euler + HLLC)
    for 5 f64 cycles on the card against the CPU, state and every dt to
    1e-10.  Seeded noise of 1e-3 takes the vortex's exactly symmetric state
    off the ties of the solver's selects, where rounding alone would
    decide."""
    ref, href = _run_deck(deck, "cpu", tmp_path / "cpu", noise=1e-3)
    before = sweep.negdiv_cuda.launches
    sim, hst = _run_deck(deck, "cuda", tmp_path / "card", noise=1e-3)
    assert sim.u.is_cuda and sim.ncycle == 5
    assert sweep.negdiv_cuda.launches - before == 2 * 5 * launches_per_stage
    a, b = ref.u.numpy(), sim.u.cpu().numpy()
    assert np.abs(a - b).max() <= 1e-10 * np.abs(a).max()
    np.testing.assert_allclose(hst[:, :2], href[:, :2], rtol=1e-10)


# the near-vacuum blast with first-order flux correction (LimO3 + HLLC +
# RK2), its radii 6.4 and 3.2 cells at 32^3, where the first cycle's
# candidate needs the rescue (tests/torch_decks.py:NEAR_VACUUM)
FOFC_BLAST = ("<problem/blast>\nradius_outer = 0.2\nradius_inner = 0.1\n"
              "pressure_ratio = 1.0e6\ndensity_ratio = 1.0e6\n"
              "pressure_ambient = 1.0e-6\ndensity_ambient = 1.0e-6\n")


def test_fofc_blast_kernel_matches_plain_on_card(card, tmp_path,
                                                monkeypatch):
    """Five f64 cycles of the FOFC blast on the card through the sweep
    kernel against the same run with its plain version (the rescue's
    plain operations on the card in both): the same stages rescued, state
    and every dt to 1e-10.  Against the CPU the blast's exactly symmetric
    state sits on the selects' ties, which the CPU's and the card's
    roundings (a division by a scalar against a multiplication by its
    reciprocal) break differently, and seeded noise would take the state
    off the rescue."""
    text = deck("blast", riemann="hllc", recon="limo3", integ="rk2",
                nx=(32, 32, 32), mb=(32, 32, 32), extra=FOFC_BLAST,
                extra_hydro="first_order_flux_correct = true", tlim=10.0,
                merge="auto") + "\n<parthenon/output1>\nfile_type = hst\n"
    monkeypatch.delenv("ATHENAPK_PALLAS_STAGE", raising=False)
    before = sweep.negdiv_cuda.launches
    sim, hst = _run_deck(text, "cuda", tmp_path / "kernel")
    assert sim.u.is_cuda and sim.ncycle == 5
    assert sweep.negdiv_cuda.launches - before == 5 * 2 * 3
    monkeypatch.setattr(sweep, "fused_negdiv", sweep.negdiv_plain)
    ref, href = _run_deck(text, "cuda", tmp_path / "plain")
    assert sweep.negdiv_cuda.launches - before == 5 * 2 * 3
    assert sim.pkg.fofc_rescues == ref.pkg.fofc_rescues >= 1
    a, b = ref.u.cpu().numpy(), sim.u.cpu().numpy()
    assert np.abs(a - b).max() <= 1e-10 * np.abs(a).max()
    np.testing.assert_allclose(hst[:, :2], href[:, :2], rtol=1e-10)


# every deck runs on the card, the advection deck with a scalar too
DECK_RUNS = [(case, rung) for case in sorted(CASES) for rung in (
    ("sweep", "stage")
    if CASES[case].get("nx", (1, 1, 1))[2] > 1 else ("sweep",))]


@pytest.mark.parametrize("case,rung", DECK_RUNS,
                         ids=[f"{c}-{r}" for c, r in DECK_RUNS])
def test_pgen_decks_on_card_match_cpu(card, case, rung, tmp_path,
                                      monkeypatch):
    """Every ported problem's deck for 5 f64 cycles on the card (3-D decks
    on each rung) against the default path on the CPU, from the initial
    state times seeded noise: state 1e-10."""
    text = deck(**{**CASES[case], "merge": "auto"}) \
        + "\n<parthenon/output1>\nfile_type = hst\n"
    monkeypatch.delenv("ATHENAPK_PALLAS_STAGE", raising=False)
    ref, href = _run_deck(text, "cpu", tmp_path / "cpu", noise=1e-3)
    if rung != "sweep":
        monkeypatch.setenv(f"ATHENAPK_PALLAS_{rung.upper()}", "1")
    n_stage, n_sweep = stage.stage_cuda.launches, sweep.negdiv_cuda.launches
    sim, hst = _run_deck(text, "cuda", tmp_path / "card", noise=1e-3)
    ndir = len(sweep.active_dirs(sim.mesh))
    nstages = {"vl2": 2, "rk3": 3}[sim.cfg.integrator]
    want_stage = {"sweep": 0, "stage": nstages}[rung]
    assert sim.u.is_cuda and sim.ncycle == ref.ncycle == 5
    assert stage.stage_cuda.launches - n_stage == 5 * want_stage
    assert sweep.negdiv_cuda.launches - n_sweep \
        == 5 * (nstages - want_stage) * ndir
    a, b = ref.u.numpy(), sim.u.cpu().numpy()
    assert np.isfinite(b).all()
    assert np.abs(a - b).max() <= 1e-10 * np.abs(a).max()
    np.testing.assert_allclose(hst[:, :2], href[:, :2], rtol=1e-10)


# ---------------------------------------------------------- passive scalars
# (fluid, riemann, reconstruction, nscalars): the cases chip_smoke.py's
# phase 3 holds on every route
SCALAR_CASES = [("glmmhd", "hlld", "ppm", 1), ("glmmhd", "hlld", "ppm", 3),
                ("euler", "hllc", "plm", 1), ("euler", "hllc", "plm", 3),
                ("euler", "hllc", "plm", 4)]
SCALAR_LAYOUTS = ["3d_ghostfree", "2d_ghosted", "1d_ghosted"]


def _scalar_prim(mesh, fluid, nscalars, seed):
    """``_random_prim`` plus ``nscalars`` scalar rows: a tracer that is 0
    in part of the domain and positive elsewhere (numpy, f64)."""
    rng = np.random.default_rng(seed)
    w = _random_prim(mesh, fluid, seed)
    cells = (mesh.nblocks, nscalars) + mesh.block_shape
    q = np.maximum(rng.standard_normal(cells), 0.0) * rng.random(cells)
    return np.concatenate([w, q], axis=1)


def _scalar_case(case):
    fluid, riemann, recon, ns = case
    cfg = HydroConfig(fluid=fluid, riemann=riemann, reconstruction=recon,
                      nscalars=ns)
    return cfg, recon, (C_H if fluid == "glmmhd" else 0.0)


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-10),
                                       (torch.float32, 1e-4)])
@pytest.mark.parametrize("faces", [False, True])
@pytest.mark.parametrize("layout", SCALAR_LAYOUTS)
@pytest.mark.parametrize("case", SCALAR_CASES,
                         ids=lambda c: "-".join(map(str, c)))
def test_sweep_kernels_with_scalars_match_plain(card, case, layout, faces,
                                                dtype, tol):
    """Routes #1, #4 (2-D, 1-D) and, with faces, #6/#2 and #5 with passive
    scalars: -div(F) and every face slab, fluid and scalar rows, against
    the plain version; one scalar launch per fluid launch."""
    cfg, recon, c_h = _scalar_case(case)
    mesh = _flat_mesh(layout)
    if faces and mesh.nghost == 0:
        mesh = _face_mesh(16, 3, 3)
    eos = EOS(gamma=5.0 / 3.0)
    prim = torch.tensor(_scalar_prim(mesh, cfg.fluid, cfg.nscalars, 31),
                        dtype=dtype, device=card)
    ndir = len(sweep.active_dirs(mesh))
    before = sweep.negdiv_scalars_cuda.launches
    sl = mesh.interior_slices
    if faces:
        nd, fc = sweep.fused_negdiv_faces(prim, c_h, mesh, cfg, eos, recon)
        ref_nd, ref_fc = sweep.negdiv_faces_plain(prim, c_h, mesh, cfg, eos,
                                                  recon)
        for d in fc:
            assert _face_err(fc[d], ref_fc[d]) <= tol, d
    else:
        nd = sweep.fused_negdiv(prim, c_h, mesh, cfg, eos, recon)
        ref_nd = sweep.negdiv_plain(prim, c_h, mesh, cfg, eos, recon)
    torch.cuda.synchronize()
    assert sweep.negdiv_scalars_cuda.launches - before == ndir
    assert bool(torch.isfinite(nd[sl]).all())
    assert _per_var_err(nd[sl], ref_nd[sl]) <= tol


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-10),
                                       (torch.float32, 1e-4)])
@pytest.mark.parametrize("faces", [False, True])
@pytest.mark.parametrize("case", SCALAR_CASES,
                         ids=lambda c: "-".join(map(str, c)))
def test_stage_kernels_with_scalars_match_plain(card, case, faces, dtype,
                                                tol):
    """Routes #3 (floors, CFL bound, stage-start prim) and #7 (faces) with
    passive scalars against the plain version."""
    cfg, recon, c_h = _scalar_case(case)
    if faces:
        mesh = _face_mesh(16, 3, 3)
    else:
        n1, n2, n3, m1, m2, m3, g = STAGE_LAYOUTS["ghostfree"]
        mesh = Mesh(nx1=n1, nx2=n2, nx3=n3, mbnx1=m1, mbnx2=m2, mbnx3=m3,
                    x1min=0.0, x1max=1.0, x2min=0.0, x2max=1.5, x3min=0.0,
                    x3max=1.5, nghost=g)
    eos = EOS(gamma=5.0 / 3.0, **FLOORS)
    w = torch.tensor(_scalar_prim(mesh, cfg.fluid, cfg.nscalars, 37))
    w[:, 0][w[:, 0] < 1.03] = 0.8          # below the density floor
    u0 = prim_to_cons(eos, w, cfg.fluid, cfg.nscalars).to(card, dtype)
    u1 = 1.01 * u0 + 0.001
    args = (u0, u1, 0.25, 0.75, 1e-3, c_h, mesh, cfg, eos, recon)
    before = stage.stage_scalars_cuda.launches
    if faces:
        got = stage.fused_stage_faces(*args, emit_prim=True)
        ref = stage.stage_faces_plain(*args, emit_prim=True)
        for d in (1, 2, 3):
            assert _face_err(got[2][d], ref[2][d]) <= tol, d
    else:
        got = stage.fused_stage(*args, emit_dt=True, emit_prim=True)
        ref = stage.stage_plain(*args, emit_dt=True, emit_prim=True)
        assert got[1].min().item() == pytest.approx(ref[1].min().item(),
                                                    rel=tol)
    torch.cuda.synchronize()
    assert stage.stage_scalars_cuda.launches == before + 1
    sl = mesh.interior_slices
    assert bool(torch.isfinite(got[0][sl]).all())
    assert _per_var_err(got[0][sl], ref[0][sl]) <= tol
    assert _per_var_err(got[-1 if not faces else 1],
                        ref[-1 if not faces else 1]) <= tol


# ------------------------------------- the face-capturing kernels (SMR)
# (fluid, riemann, reconstruction, meshblock, nghost): extents 14 and 22
# leave remainder columns and march steps in both kernels; nghost 2 with DC
# puts the faces one cell from a column's first
FACE_CASES = [("euler", "hllc", "ppm", 8, 3), ("euler", "hlle", "plm", 16, 3),
              ("glmmhd", "hlld", "ppm", 8, 3), ("euler", "hlle", "dc", 8, 2),
              ("euler", "hllc", "plm", 32, 2),
              ("glmmhd", "hlle", "wenoz", 8, 3),
              ("euler", "llf", "limo3", 16, 2),
              ("glmmhd", "llf", "weno3", 8, 2)]


def _face_mesh(mb, g, ndim=3):
    """A level-1 geometry: blocks of ``mb`` cells (``ndim`` active axes)
    with halved widths."""
    nx = [2 * mb, 2 * mb if ndim > 1 else 1, 2 * mb if ndim > 2 else 1]
    mbs = [mb, mb if ndim > 1 else 1, mb if ndim > 2 else 1]
    base = Mesh(nx1=nx[0], nx2=nx[1], nx3=nx[2], mbnx1=mbs[0], mbnx2=mbs[1],
                mbnx3=mbs[2], x1min=0.0, x1max=1.0, x2min=0.0, x2max=1.5,
                x3min=0.0, x3max=1.5, nghost=g)
    return LevelMesh(base, (base.dx1 / 2, base.dx2 / (2 if ndim > 1 else 1),
                            base.dx3 / (2 if ndim > 2 else 1)))


def _face_err(got, ref):
    """max |kernel - plain| over max |plain| of each variable of a face
    slab [nb, nvar, A, B, 2]."""
    dims = [0, 2, 3, 4]
    return ((got - ref).abs().amax(dim=dims)
            / ref.abs().amax(dim=dims).clamp(min=1e-300)).max().item()


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-10),
                                       (torch.float32, 1e-4)])
@pytest.mark.parametrize("case", FACE_CASES,
                         ids=lambda c: "-".join(map(str, c)))
def test_stage_faces_kernel_matches_plain(card, case, dtype, tol):
    fluid, riemann, recon, mb, g = case
    lm = _face_mesh(mb, g)
    cfg = HydroConfig(fluid=fluid, riemann=riemann, reconstruction=recon)
    eos = EOS(gamma=5.0 / 3.0, **FLOORS)
    mesh3 = Mesh(nx1=mb, nx2=mb, nx3=mb, mbnx1=mb, mbnx2=mb, mbnx3=mb,
                 x1min=0.0, x1max=1.0, x2min=0.0, x2max=1.0, x3min=0.0,
                 x3max=1.0, nghost=g)
    u0, u1 = (a.to(device=card, dtype=dtype)
              for a in _stage_states(mesh3, fluid, 23))
    u0 = torch.cat([u0, 1.02 * u0, 0.98 * u0])     # three blocks
    u1 = torch.cat([u1, u1, u1])
    c_h = C_H if fluid == "glmmhd" else 0.0
    args = (u0, u1, 0.25, 0.75, 1e-3, c_h, lm, cfg, eos, recon)
    before = stage.stage_faces_cuda.launches
    got = stage.fused_stage_faces(*args, emit_prim=True)
    torch.cuda.synchronize()
    assert stage.stage_faces_cuda.launches == before + 1
    ref = stage.stage_faces_plain(*args, emit_prim=True)
    sl = lm.interior_slices
    assert bool(torch.isfinite(got[0][sl]).all())
    assert _per_var_err(got[0][sl], ref[0][sl]) <= tol
    assert _per_var_err(got[1], ref[1]) <= tol
    for d in (1, 2, 3):
        assert got[2][d].shape == ref[2][d].shape
        assert bool(torch.isfinite(got[2][d]).all())
        assert _face_err(got[2][d], ref[2][d]) <= tol, d
    # the face output changes nothing else the kernel writes
    alone = stage.stage_cuda(*args)
    assert torch.equal(alone, got[0])


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-10),
                                       (torch.float32, 1e-4)])
@pytest.mark.parametrize("ndim", [3, 2, 1])
@pytest.mark.parametrize("case", FACE_CASES,
                         ids=lambda c: "-".join(map(str, c)))
def test_negdiv_faces_kernel_matches_plain(card, case, ndim, dtype, tol):
    fluid, riemann, recon, mb, g = case
    lm = _face_mesh(mb, g, ndim)
    cfg = HydroConfig(fluid=fluid, riemann=riemann, reconstruction=recon)
    eos = EOS(gamma=5.0 / 3.0)
    rng = np.random.default_rng(29)
    nvar = cfg.nvar
    w = np.ones((3, nvar) + lm.block_shape)
    w[:, 0] += 0.3 * rng.random(w[:, 0].shape)
    w[:, 1:4] = 0.3 * rng.standard_normal(w[:, 1:4].shape)
    w[:, 4] += 0.2 * rng.random(w[:, 4].shape)
    if nvar == 9:
        w[:, 5:8] = 0.2 * rng.standard_normal(w[:, 5:8].shape)
    prim = torch.tensor(w, dtype=dtype, device=card)
    c_h = C_H if fluid == "glmmhd" else 0.0
    before = sweep.negdiv_faces_cuda.launches
    nd, faces = sweep.fused_negdiv_faces(prim, c_h, lm, cfg, eos, recon)
    torch.cuda.synchronize()
    assert sweep.negdiv_faces_cuda.launches == before + ndim
    ref_nd, ref_f = sweep.negdiv_faces_plain(prim, c_h, lm, cfg, eos, recon)
    sl = lm.interior_slices
    assert _per_var_err(nd[sl], ref_nd[sl]) <= tol
    assert sorted(faces) == sorted(ref_f) == list(range(1, ndim + 1))
    for d in faces:
        assert faces[d].shape == ref_f[d].shape
        assert _face_err(faces[d], ref_f[d]) <= tol, d
    assert torch.equal(nd, sweep.negdiv_cuda(prim, c_h, lm, cfg, eos, recon))


# --------------------------------- extents around the kernels' own tiles
# The sweep kernel marches 16 cells of 8 rows per step along x and 4 cells
# of 32 pencils per step along y and z; the stage kernel takes columns of
# 7 x 14 cells and cuts z into segments.  Extents one cell past those;
# extents shorter than a step and than the PPM stencil (the kernels wrap
# several times round the block); refined path A's blocks of 36 cells with
# their ghosts, and 37, two blocks at a time (ghosted: with and without
# the face output).
TILE_LAYOUTS = {
    # (nx1, nx2, nx3, mbnx1, mbnx2, mbnx3, nghost)
    "remainder-of-one": (17, 9, 65, 17, 9, 65, 0),
    "stage-remainder-of-one": (15, 8, 9, 15, 8, 9, 0),
    "shorter-than-stencil": (5, 3, 2, 5, 3, 2, 0),
    "flat-remainder-of-one": (17, 33, 1, 17, 33, 1, 0),
    "line-shorter-than-stencil": (3, 1, 1, 3, 1, 1, 0),
    "path-a-36": (64, 32, 32, 32, 32, 32, 2),
    "path-a-37": (66, 33, 33, 33, 33, 33, 2),
}


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-10),
                                       (torch.float32, 1e-4)])
@pytest.mark.parametrize("recon", ["dc", "plm", "ppm"])
@pytest.mark.parametrize("fluid,riemann", [("glmmhd", "hlld"),
                                           ("euler", "hllc")])
@pytest.mark.parametrize("layout", sorted(TILE_LAYOUTS))
def test_kernels_at_extents_around_their_tiles(card, layout, fluid, riemann,
                                               recon, dtype, tol):
    n1, n2, n3, m1, m2, m3, g = TILE_LAYOUTS[layout]
    mesh = Mesh(nx1=n1, nx2=n2, nx3=n3, mbnx1=m1, mbnx2=m2, mbnx3=m3,
                x1min=0.0, x1max=1.0, x2min=0.0, x2max=1.5, x3min=0.0,
                x3max=1.5, nghost=g)
    cfg = HydroConfig(fluid=fluid, riemann=riemann, reconstruction=recon)
    c_h = C_H if fluid == "glmmhd" else 0.0
    sl = mesh.interior_slices
    eos = EOS(gamma=5.0 / 3.0)
    prim = torch.tensor(_random_prim(mesh, fluid, 31), dtype=dtype,
                        device=card)
    got = sweep.negdiv_cuda(prim, c_h, mesh, cfg, eos, recon)
    ref = sweep.negdiv_plain(prim, c_h, mesh, cfg, eos, recon)
    assert bool(torch.isfinite(got[sl]).all())
    assert _per_var_err(got[sl], ref[sl]) <= tol
    if g:
        nd, faces = sweep.negdiv_faces_cuda(prim, c_h, mesh, cfg, eos, recon)
        _, ref_f = sweep.negdiv_faces_plain(prim, c_h, mesh, cfg, eos, recon)
        assert torch.equal(nd, got)
        for d in ref_f:
            assert _face_err(faces[d], ref_f[d]) <= tol, d
    if n2 == 1 or n3 == 1:
        return   # the stage kernel is 3-D only
    eos = EOS(gamma=5.0 / 3.0, **FLOORS)
    u0, u1 = (a.to(device=card, dtype=dtype)
              for a in _stage_states(mesh, fluid, 37))
    args = (u0, u1, 0.25, 0.75, 1e-3, c_h, mesh, cfg, eos, recon)
    got = stage.stage_cuda(*args, emit_dt=g == 0, emit_prim=True)
    ref = stage.stage_plain(*args, emit_dt=g == 0, emit_prim=True)
    assert bool(torch.isfinite(got[0][sl]).all())
    assert _per_var_err(got[0][sl], ref[0][sl]) <= tol
    assert _per_var_err(got[-1], ref[-1]) <= tol          # stage-start prim
    if g == 0:
        assert got[1].min().item() == pytest.approx(ref[1].min().item(),
                                                    rel=tol)
    else:
        u_new, prim_k, faces = stage.stage_faces_cuda(*args, emit_prim=True)
        _, _, ref_f = stage.stage_faces_plain(*args, emit_prim=True)
        assert torch.equal(u_new, got[0]) and torch.equal(prim_k, got[-1])
        for d in (1, 2, 3):
            assert _face_err(faces[d], ref_f[d]) <= tol, d


SMR_RUNS = {
    # (deck, rung, kernel launches per cycle: stage-faces, negdiv-faces)
    "3d_stage": (SMR_3D.format(n=32, mb=8, nlim=5, precision="double"),
                 "stage", (4, 0)),
    "3d_negdiv": (SMR_3D.format(n=32, mb=8, nlim=5, precision="double"),
                  "negdiv", (0, 12)),
    "2d": (SMR_2D.format(n=64, mb=16, tlim=1.0, nlim=5, precision="double"),
           "negdiv", (0, 8)),
    "1d": (SMR_1D.format(n=128, mb=16, nlim=5), "negdiv", (0, 4)),
}


def _run_smr(text, device, outdir, start):
    outdir.mkdir(parents=True, exist_ok=True)
    with contextlib.chdir(outdir):
        sim = SmrSimulation(ParameterInput.from_string(text), quiet=True,
                            device=device)
        sim.load_state(start, 0.0, 0)
        m0 = sim.total_mass()
        sim.run()
    return sim, np.loadtxt(next(outdir.glob("*.hst"))), m0


@pytest.mark.parametrize("case", sorted(SMR_RUNS))
def test_refined_decks_on_card_match_cpu(card, case, tmp_path, monkeypatch):
    """Five f64 cycles through ``SmrSimulation`` on the card against the
    CPU (the kernels' plain twins), from the problem's initial state with
    seeded symmetry-breaking noise: state and every dt to 1e-10, the
    launch counts per cycle, and mass across levels to 1e-13 (periodic
    decks)."""
    text, rung, (n_stage, n_negdiv) = SMR_RUNS[case]
    text += HST_BLOCK
    if rung == "negdiv":
        monkeypatch.setenv("ATHENAPK_PALLAS_STAGE", "0")
    else:
        monkeypatch.delenv("ATHENAPK_PALLAS_STAGE", raising=False)
    with contextlib.chdir(tmp_path):
        sim0 = SmrSimulation(ParameterInput.from_string(text), quiet=True,
                             device="cpu")
    start = symmetry_noise({lev: v.numpy() for lev, v in sim0.state.items()},
                           seed=5)
    ref, href, _ = _run_smr(text, "cpu", tmp_path / "cpu", start)
    before = (stage.stage_faces_cuda.launches,
              sweep.negdiv_faces_cuda.launches)
    sim, hst, m0 = _run_smr(text, "cuda", tmp_path / "card", start)
    assert (stage.stage_faces_cuda.launches - before[0],
            sweep.negdiv_faces_cuda.launches - before[1]) \
        == (5 * n_stage, 5 * n_negdiv)
    assert sim.ncycle == ref.ncycle == 5
    for lev in ref.state:
        a, b = ref.state[lev].numpy(), sim.state[lev].cpu().numpy()
        assert np.isfinite(b).all()
        assert np.abs(a - b).max() <= 1e-10 * np.abs(a).max()
    np.testing.assert_allclose(hst[:, :2], href[:, :2], rtol=1e-10)
    if case != "1d":      # Sod's outflow boundaries let mass through
        assert abs(sim.total_mass() - m0) <= 1e-13 * m0


# ------------------------------------------- adaptive meshes on the card
# Level sizes an adaptive mesh hands the face kernels: one block, a few,
# one octree level (8), path A's coarse level (56) and a level of the
# adaptive bench at 128^3 (504), on path D's blocks (16^3 + 2 ghosts, Euler
# HLLE + PLM) and the 2-D adaptive blast's (32^2 + 2 ghosts, HLLC + PLM).
LEVEL_SIZES = [1, 3, 8, 56, 504]
FACE_KERNELS = {"stage_faces_3d": ("hlle", 3, 16),
                "negdiv_faces_3d": ("hlle", 3, 16),
                "negdiv_faces_2d": ("hllc", 2, 32)}


def _level_prim(lm, nb, dtype, device, seed):
    rng = np.random.default_rng(seed)
    w = np.ones((nb, 5) + lm.block_shape)
    w[:, 0] += 0.3 * rng.random(w[:, 0].shape)
    w[:, 1:4] = 0.3 * rng.standard_normal(w[:, 1:4].shape)
    w[:, 4] += 0.2 * rng.random(w[:, 4].shape)
    return torch.tensor(w, dtype=dtype, device=device)


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-10),
                                       (torch.float32, 1e-4)])
@pytest.mark.parametrize("nb", LEVEL_SIZES)
@pytest.mark.parametrize("kernel", sorted(FACE_KERNELS))
def test_face_kernels_at_adaptive_level_sizes(card, kernel, nb, dtype, tol):
    """#7 (stage-faces), #6/#2 (3-D negdiv-faces) and #5 (2-D negdiv-faces)
    against their plain twins at ``nb`` blocks: the kernels pick their
    segments from the block count, which a remesh changes under them."""
    riemann, ndim, mb = FACE_KERNELS[kernel]
    lm = _face_mesh(mb, 2, ndim)
    cfg = HydroConfig(fluid="euler", riemann=riemann, reconstruction="plm")
    eos = EOS(gamma=5.0 / 3.0)
    prim = _level_prim(lm, nb, dtype, card, seed=nb)
    sl = lm.interior_slices
    if kernel.startswith("stage"):
        from athenapk_tpu_torch.eos.adiabatic import prim_to_cons as p2c
        u0 = p2c(eos, prim, "euler")
        args = (u0, 1.01 * u0, 0.25, 0.75, 1e-3, 0.0, lm, cfg, eos, "plm")
        before = stage.stage_faces_cuda.launches
        out, _, faces = stage.fused_stage_faces(*args)
        torch.cuda.synchronize()
        assert stage.stage_faces_cuda.launches == before + 1
        ref, _, ref_f = stage.stage_faces_plain(*args)
    else:
        args = (prim, 0.0, lm, cfg, eos, "plm")
        before = sweep.negdiv_faces_cuda.launches
        out, faces = sweep.fused_negdiv_faces(*args)
        torch.cuda.synchronize()
        assert sweep.negdiv_faces_cuda.launches == before + ndim
        ref, ref_f = sweep.negdiv_faces_plain(*args)
    assert out.shape[0] == nb and bool(torch.isfinite(out[sl]).all())
    assert _per_var_err(out[sl], ref[sl]) <= tol
    assert sorted(faces) == sorted(ref_f)
    for d in faces:
        assert faces[d].shape == ref_f[d].shape
        assert _face_err(faces[d], ref_f[d]) <= tol, d


def test_a_level_without_blocks_never_reaches_a_launch(card):
    lm = _face_mesh(16, 2, 3)
    cfg = HydroConfig(fluid="euler", riemann="hlle", reconstruction="plm")
    eos = EOS(gamma=5.0 / 3.0)
    empty = torch.empty((0, 5) + lm.block_shape, device=card)
    before = (stage.stage_faces_cuda.launches,
              sweep.negdiv_faces_cuda.launches)
    with pytest.raises(ValueError, match="no blocks"):
        stage.stage_faces_cuda(empty, empty, 0.25, 0.75, 1e-3, 0.0, lm, cfg,
                               eos, "plm")
    with pytest.raises(ValueError, match="no blocks"):
        sweep.negdiv_faces_cuda(empty, 0.0, lm, cfg, eos, "plm")
    assert (stage.stage_faces_cuda.launches,
            sweep.negdiv_faces_cuda.launches) == before


def _blob(sm, dtype, device):
    """A Gaussian density blob at (0.3, 0.5, 0.5) with seeded noise on the
    momenta, ghosts unfilled."""
    rng = np.random.default_rng(3)
    eos = EOS(gamma=5.0 / 3.0)
    state = {}
    for lev, ids in sm.level_ids.items():
        w = np.zeros((len(ids), 5) + sm.base.block_shape)
        for li, gid in enumerate(ids):
            x, y, z = sm.cell_centers_leaf(gid)
            r2 = (x - 0.3) ** 2 + (y - 0.5) ** 2
            if sm.base.nx3 > 1:
                r2 = r2 + (z - 0.5) ** 2
            w[li, 0] = 1.0 + np.broadcast_to(np.exp(-r2 / 0.005),
                                             sm.base.block_shape)
        w[:, 1:3] = 1e-3 * rng.standard_normal(w[:, 1:3].shape)
        w[:, 4] = 1.0
        state[lev] = prim_to_cons(eos, torch.tensor(w), "euler").to(
            device=device, dtype=dtype)
    return state


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("ndim", [3, 2])
def test_remesh_on_card_matches_cpu_bitwise(card, ndim, dtype):
    """The same tags on the card and on the CPU: refine the corner
    [0, 0.5)^d, then derefine it while refining [0.5, 1)^d, then derefine
    all; leaf tables equal and the filled states equal bit for bit."""
    kw = dict(nx1=32, nx2=32, nx3=32 if ndim == 3 else 1, mbnx1=8, mbnx2=8,
              mbnx3=8 if ndim == 3 else 1, x1min=0.0, x1max=1.0, x2min=0.0,
              x2max=1.0, x3min=0.0 if ndim == 3 else -0.5,
              x3max=1.0 if ndim == 3 else 0.5, nghost=2)
    meshes = {dev: SmrMesh(Mesh(**kw), [], max_level=1)
              for dev in ("cpu", "cuda")}
    start = SmrState(meshes["cpu"], 5, "cpu").fill_ghosts(
        _blob(meshes["cpu"], dtype, "cpu"))
    states = {"cpu": start,
              "cuda": {lev: v.to(card) for lev, v in start.items()}}
    for r in range(3):
        sm = meshes["cpu"]
        nb = sm.levels.size
        corner = [all(o < 0.5 for o in sm.block_origin(g)[:ndim])
                  for g in range(nb)]
        far = [all(o >= 0.5 for o in sm.block_origin(g)[:ndim])
               for g in range(nb)]
        tags = np.array([corner, np.where(sm.levels == 1, -1, far),
                         -np.ones(nb)][r], np.int32)
        for dev in meshes:
            meshes[dev], states[dev] = remesh(meshes[dev], states[dev], tags)
        for a, b in zip(*((m.levels, m.lx1, m.lx2, m.lx3)
                          for m in meshes.values())):
            np.testing.assert_array_equal(a, b)
        assert sorted(states["cuda"]) == sorted(states["cpu"])
        for lev, v in states["cpu"].items():
            assert states["cuda"][lev].device.type == "cuda"
            assert torch.equal(states["cuda"][lev].cpu(), v), (r, lev)


ADAPTIVE_RUNS = {
    # (deck, rung)
    "3d_stage": ("blast_3d_adaptive", "stage"),
    "3d_negdiv": ("blast_3d_adaptive", "negdiv"),
    "2d": (ADAPTIVE_2D.format(n=64, mb=16, nlim=5, precision="double"),
           "negdiv"),
}


@pytest.mark.parametrize("case", sorted(ADAPTIVE_RUNS))
def test_adaptive_decks_on_card_match_cpu(card, case, tmp_path,
                                          monkeypatch):
    """Five f64 cycles of an adaptive deck (``derefine_count = 1``) through
    ``SmrSimulation`` on the card against the CPU (the plain twins), from
    the initial state with seeded noise: leaf table, state and time to
    1e-10 at the end, a refinement and a derefinement on the way (the
    leaf counts flap), face launches on the card, mass to 1e-13."""
    from pathlib import Path
    text, rung = ADAPTIVE_RUNS[case]
    if text == "blast_3d_adaptive":
        text = (Path(__file__).resolve().parents[1] / "inputs"
                / "blast_3d_adaptive.in").read_text().replace(
            "nlim = 10000", "nlim = 5").replace("dt = 0.01", "dt = -1.0")
    text = text.replace("refinement = adaptive",
                        "refinement = adaptive\nderefine_count = 1")
    if rung == "negdiv":
        monkeypatch.setenv("ATHENAPK_PALLAS_STAGE", "0")
    else:
        monkeypatch.delenv("ATHENAPK_PALLAS_STAGE", raising=False)
    sims = {}
    with contextlib.chdir(tmp_path):
        for dev in ("cpu", "cuda"):
            sims[dev] = SmrSimulation(ParameterInput.from_string(text),
                                      quiet=True, device=dev)
        start = symmetry_noise({lev: v.numpy() for lev, v in
                                sims["cpu"].state.items()}, seed=5)
        m0, counts = {}, {}
        for dev, sim in sims.items():
            sim.load_state(start, 0.0, 0)
            m0[dev] = sim.total_mass()
            before = (stage.stage_faces_cuda.launches
                      + sweep.negdiv_faces_cuda.launches)
            sim.run()
            counts[dev] = (stage.stage_faces_cuda.launches
                           + sweep.negdiv_faces_cuda.launches - before)
    ref, got = sims["cpu"], sims["cuda"]
    assert counts["cpu"] == 0 and counts["cuda"] > 0
    assert got.ncycle == ref.ncycle == 5
    assert ref.perf_remeshes >= 2 and got.perf_remeshes == ref.perf_remeshes
    for a, b in zip(*((s._smesh_now().levels, s._smesh_now().lx1,
                       s._smesh_now().lx2, s._smesh_now().lx3)
                      for s in (ref, got))):
        np.testing.assert_array_equal(a, b)
    for lev in ref.state:
        a, b = ref.state[lev].numpy(), got.state[lev].cpu().numpy()
        assert np.isfinite(b).all()
        assert np.abs(a - b).max() <= 1e-10 * np.abs(a).max()
    assert abs(got.t - ref.t) <= 1e-10 * ref.t
    assert abs(got.total_mass() - m0["cuda"]) <= 1e-13 * m0["cuda"]


# ------------------------------------------- diffusion and split sources
# The decks of chip_smoke.py's paths H, I and I' at small sizes, f64: 5
# cycles on the card against the CPU.  The hyperbolic stages launch the
# kernels whatever the deck's diffusion or sources; the diffusion, the
# RKL2 stages and the forcing are plain PyTorch on the card.
from torch_decks import (linwave3d_deck, rand_blast_deck,  # noqa: E402
                         turbulence_deck)

SOURCE_RUNS = {
    "H-unsplit": linwave3d_deck(nx=(32, 16, 16), integrator="unsplit"),
    "H-rkl2": linwave3d_deck(nx=(32, 16, 16), integrator="rkl2"),
    "I": turbulence_deck(n=32, num_modes=30),
    "rand_blast": rand_blast_deck(n=64, nlim=5, tlim=0.01, fofc="true"),
}
SOURCE_RUNGS = [(case, rung) for case in sorted(SOURCE_RUNS)
                for rung in (("sweep",) if case == "rand_blast"
                             else ("sweep", "stage"))]


@pytest.mark.parametrize("case,rung", SOURCE_RUNGS,
                         ids=[f"{c}-{r}" for c, r in SOURCE_RUNGS])
def test_source_decks_on_card_match_cpu(card, case, rung, tmp_path,
                                        monkeypatch):
    """Diffusion (unsplit, RKL2), turbulence and rand_blast decks: 5 f64
    cycles on the card against the CPU, state and every dt to 1e-10; the
    kernels launched on every stage, the same RKL2 stage counts."""
    if rung == "stage":
        monkeypatch.setenv("ATHENAPK_PALLAS_STAGE", "1")
    else:
        monkeypatch.delenv("ATHENAPK_PALLAS_STAGE", raising=False)
    text = SOURCE_RUNS[case]
    ref, href = _run_deck(text, "cpu", tmp_path / "cpu")
    before = stage.stage_cuda.launches + sweep.negdiv_cuda.launches
    sim, hst = _run_deck(text, "cuda", tmp_path / "card")
    launched = stage.stage_cuda.launches + sweep.negdiv_cuda.launches \
        - before
    assert sim.u.is_cuda and sim.ncycle == ref.ncycle == 5
    assert launched == 5 * (2 if rung == "stage" else 6)
    assert sim.pkg.rkl2_stages == ref.pkg.rkl2_stages
    a, b = ref.u.numpy(), sim.u.cpu().numpy()
    assert np.isfinite(b).all()
    assert np.abs(a - b).max() <= 1e-10 * np.abs(a).max()
    np.testing.assert_allclose(hst[:, :2], href[:, :2], rtol=1e-10)


REFINED_SOURCE_RUNS = {
    "H-unsplit": linwave3d_deck(nx=(32, 16, 16), mb=(8, 8, 8),
                                integrator="unsplit", refinement="static",
                                region=(0.0, 1.5, 0.0, 1.5, 0.0, 1.5)),
    "H-rkl2": linwave3d_deck(nx=(32, 16, 16), mb=(8, 8, 8),
                             integrator="rkl2", refinement="static",
                             region=(0.0, 1.5, 0.0, 1.5, 0.0, 1.5)),
    "I-prime": turbulence_deck(n=16, mb=8, num_modes=30,
                               refinement="static"),
}


@pytest.mark.parametrize("rung", ["stage", "negdiv"])
@pytest.mark.parametrize("case", sorted(REFINED_SOURCE_RUNS))
def test_refined_source_decks_on_card_match_cpu(card, case, rung, tmp_path,
                                                monkeypatch):
    """The refined diffusion and turbulence decks: 5 f64 cycles on the
    card against the CPU on both rungs, state to 1e-10, the face kernels
    launched, the mass across levels to 1e-13."""
    monkeypatch.setenv("ATHENAPK_PALLAS_STAGE",
                       "1" if rung == "stage" else "0")
    text = REFINED_SOURCE_RUNS[case]
    sims, counts, m0 = {}, {}, {}
    with contextlib.chdir(tmp_path), \
            contextlib.redirect_stdout(io.StringIO()):
        for dev in ("cpu", "cuda"):
            sims[dev] = SmrSimulation(ParameterInput.from_string(text),
                                      quiet=True, device=dev)
            m0[dev] = sims[dev].total_mass()
            before = (stage.stage_faces_cuda.launches
                      + sweep.negdiv_faces_cuda.launches)
            sims[dev].run()
            counts[dev] = (stage.stage_faces_cuda.launches
                           + sweep.negdiv_faces_cuda.launches - before)
    ref, got = sims["cpu"], sims["cuda"]
    nlev = len(ref.state)
    assert counts["cpu"] == 0
    assert counts["cuda"] == 5 * nlev * (2 if rung == "stage" else 6)
    assert got.ncycle == ref.ncycle == 5
    assert got.stepper.rkl2_stages == ref.stepper.rkl2_stages
    for lev in ref.state:
        a, b = ref.state[lev].numpy(), got.state[lev].cpu().numpy()
        assert np.isfinite(b).all()
        assert np.abs(a - b).max() <= 1e-10 * np.abs(a).max()
    assert abs(got.total_mass() - m0["cuda"]) <= 1e-13 * m0["cuda"]


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-10),
                                       (torch.float32, 1e-4)])
def test_stage_kernel_with_prim_at_the_diffusive_wave(card, dtype, tol):
    """The stage kernel's instantiation of path H (GLM-MHD HLLD + PLM,
    ghost-free, with the stage-start prim the unsplit diffusion reads)
    against its plain version at the diffusive wave's own state."""
    sim = Simulation(ParameterInput.from_string(linwave3d_deck(
        nx=(32, 16, 16))), quiet=True, device="cuda")
    u = sim.u.to(dtype)
    args = (u, u, 0.5, 0.5, 1e-3, C_H, sim.mesh, sim.cfg, sim.eos, "plm")
    got = stage.stage_cuda(*args, emit_prim=True)
    ref = stage.stage_plain(*args, emit_prim=True)
    for g, r in zip(got, ref):
        r = r.double().cpu().numpy()
        assert np.abs(g.double().cpu().numpy() - r).max() \
            <= tol * np.abs(r).max()


# -------------------------------------------------- tracers and the restart
from athenapk_tpu_torch.outputs.restart import (  # noqa: E402
    restart_payload, restart_payload_smr)
from torch_decks import ADVECT_TRACERS, tracer_block  # noqa: E402


def _tracers_close(got, want, tol):
    """Tracer dicts (``{name: tensor}``): integer and boolean entries
    identical, floats within ``tol`` of the largest value or of 1."""
    for k, v in want.items():
        g, v = got[k].cpu(), v.cpu()
        if v.is_floating_point():
            scale = max(v.abs().max().item(), 1.0)
            assert (g - v).abs().max().item() <= tol * scale, k
        else:
            assert torch.equal(g, v), k


@pytest.mark.parametrize("merge", ["false", "true"])
def test_tracers_on_card_match_cpu(card, merge, tmp_path, monkeypatch):
    """Advection and sampling on the card (with the migration between 8
    blocks, or the cyclic wrap of the merged block) against the CPU, f64:
    the same ids in the same slots."""
    monkeypatch.chdir(tmp_path)
    text = ADVECT_TRACERS.format(merge=merge, nlim=6, precision="double")
    sims = {dev: Simulation(ParameterInput.from_string(text), quiet=True,
                            device=dev).run() for dev in ("cuda", "cpu")}
    got, want = sims["cuda"].tracer_state, sims["cpu"].tracer_state
    assert got["x"].is_cuda and got["x"].dtype == torch.float64
    assert int(want["active"].sum()) > 0
    _tracers_close(got, want, 1e-10)


@pytest.mark.parametrize("precision,tol", [("double", 1e-10),
                                           ("single", 1e-4)])
def test_restart_payload_round_trip_on_card(card, precision, tol, tmp_path,
                                            monkeypatch):
    """Turbulence with tracers on the card: 2 cycles, the payload, a new
    ``Simulation`` from it and 2 more equal 4 straight cycles bit for bit;
    the same payload resumed on the CPU agrees with the card's run."""
    monkeypatch.chdir(tmp_path)

    def make(nlim, device="cuda", restart=None):
        return Simulation(ParameterInput.from_string(
            turbulence_deck(n=16, mb=8, nlim=nlim, num_modes=4,
                            precision=precision, merge="false")
            + tracer_block(0.05, seed=3)), quiet=True, device=device,
            restart=restart)

    full = make(4).run()
    payload = restart_payload(make(2).run())
    rest = make(4, restart=payload).run()
    assert torch.equal(full.u, rest.u) and full.t == rest.t
    _tracers_close(rest.tracer_state, full.tracer_state, 0.0)
    cpu = make(4, device="cpu", restart=payload).run()
    a, b = cpu.u.double().numpy(), full.u.double().cpu().numpy()
    assert np.abs(a - b).max() <= tol * np.abs(a).max()


def test_refined_restart_payload_round_trip_on_card(card, tmp_path,
                                                    monkeypatch):
    """The refined turbulence with tracers on the card: the payload's
    resume equals the straight run bit for bit."""
    monkeypatch.chdir(tmp_path)

    def make(nlim, restart=None):
        return SmrSimulation(ParameterInput.from_string(
            turbulence_deck(n=16, mb=8, nlim=nlim, num_modes=4,
                            refinement="static")
            + tracer_block(0.05, seed=3)), quiet=True, device="cuda",
            restart=restart)

    full = make(4).run()
    rest = make(4, restart=restart_payload_smr(make(2).run())).run()
    for lev, u in full.state.items():
        assert torch.equal(u, rest.state[lev])
    for lev, st in full.tracer_state["levels"].items():
        _tracers_close(rest.tracer_state["levels"][lev], st, 0.0)


# ------------------------------------------------------------ the cluster
# The cluster deck of chip_smoke.py's paths K, K' and K'' at a small size
# (``torch_decks.cluster_deck``: GLM-MHD HLLD + PLM + VL2, one scalar, the
# whole AGN subsystem), f64 with Townsend cooling and f32 without cooling
# and stellar feedback (whose number density is outside f32).  Its sources
# are plain PyTorch on the card; the hyperbolic stages launch the kernels
# (the +scalars instantiations and a scalar kernel after each).
from athenapk_tpu_torch.pgen.cluster import pgen as cluster_pgen  # noqa: E402
from torch_decks import cluster_deck, write_cluster_table  # noqa: E402

CLUSTER_PRECISIONS = {"double": 1e-10, "single": 1e-4}


def _cluster_text(tmp_path, precision, **kw):
    f64 = precision == "double"
    return cluster_deck(half=0.02, precision=precision, stellar=f64,
                        table=(write_cluster_table(tmp_path / "c.cool")
                               if f64 else None), **kw)


def test_cluster_sources_on_card_match_cpu(card, tmp_path):
    """The cluster's unsplit source (gravity, AGN feedback, the tower, SN
    Ia), its split source (stellar feedback, the clips) and the accretion
    dt on the card against the CPU at the deck's initial state, f64, on a
    uniform and a refined mesh: 1e-12 of each variable's largest value."""
    text = _cluster_text(tmp_path, "double", n=16, nlim=0)
    sim = Simulation(ParameterInput.from_string(text), quiet=True,
                     device="cpu")
    _, w = sim.pkg.cons_to_prim(sim.u)
    src = cluster_pgen.problem_source_unsplit(sim.pin, sim.mesh, sim.cfg,
                                              sim.eos)
    split = cluster_pgen.problem_source_first_order(sim.pin, sim.mesh,
                                                    sim.cfg, sim.eos)
    outs = {}
    for dev in ("cpu", "cuda"):
        u, p = sim.u.to(dev), w.to(dev)
        a = src(u, p, sim.mesh, 2e-4, 0.01)
        outs[dev] = (a, split(a, 2e-4, 0.01))
    for got, want in zip(outs["cuda"], outs["cpu"]):
        assert got.is_cuda
        for v in range(want.shape[1]):
            scale = want[:, v].abs().max().item()
            assert (got[:, v].cpu() - want[:, v]).abs().max().item() \
                <= 1e-12 * max(scale, 1e-300), v
    smr = SmrSimulation(ParameterInput.from_string(_cluster_text(
        tmp_path, "double", n=16, mb=8, nlim=0, refinement="static",
        regions=[(0.0, 0.02, 0.0, 0.02, 0.0, 0.02, 1)])), quiet=True,
        device="cpu")
    src_smr = cluster_pgen.problem_source_unsplit_smr(
        smr.pin, smr.smesh, smr.cfg, smr.eos)
    prims = smr._prims()
    res = {dev: src_smr({k: v.to(dev) for k, v in smr.state.items()},
                        {k: v.to(dev) for k, v in prims.items()}, 2e-4, 0.01)
           for dev in ("cpu", "cuda")}
    for lev, want in res["cpu"].items():
        got = res["cuda"][lev].cpu()
        assert (got - want).abs().max().item() \
            <= 1e-12 * want.abs().max().item()


@pytest.mark.parametrize("precision", sorted(CLUSTER_PRECISIONS))
@pytest.mark.parametrize("rung", ["sweep", "stage"])
def test_cluster_deck_on_card_matches_cpu(card, rung, precision, tmp_path,
                                          monkeypatch):
    """3 cycles of the cluster deck (32^3 in one ghosted block) on the
    card against the CPU on both uniform rungs: the +scalars fluid kernel
    and one scalar kernel per launch, the state to 1e-10 (f64) or 1e-4
    (f32) of each variable's largest value."""
    monkeypatch.setenv("ATHENAPK_PALLAS_STAGE",
                       "1" if rung == "stage" else "0")
    monkeypatch.chdir(tmp_path)
    text = _cluster_text(tmp_path, precision, n=32, nlim=3)
    kern, skern = ((stage.stage_cuda, stage.stage_scalars_cuda)
                   if rung == "stage"
                   else (sweep.negdiv_cuda, sweep.negdiv_scalars_cuda))
    sims, counts = {}, {}
    for dev in ("cpu", "cuda"):
        n0 = (kern.launches, skern.launches)
        sims[dev] = Simulation(ParameterInput.from_string(text), quiet=True,
                               device=dev).run()
        counts[dev] = (kern.launches - n0[0], skern.launches - n0[1])
    per = 2 if rung == "stage" else 6
    assert counts == {"cpu": (0, 0), "cuda": (3 * per, 3 * per)}
    ref, got = sims["cpu"].u, sims["cuda"].u.cpu()
    assert bool(torch.isfinite(got).all())
    tol = CLUSTER_PRECISIONS[precision]
    for v in range(ref.shape[1]):
        scale = ref[:, v].abs().max().item()
        assert (got[:, v] - ref[:, v]).abs().max().item() <= tol * scale, v
    assert abs(sims["cuda"].t - sims["cpu"].t) <= tol * sims["cpu"].t


@pytest.mark.parametrize("precision", sorted(CLUSTER_PRECISIONS))
@pytest.mark.parametrize("rung", ["stage", "negdiv"])
def test_refined_cluster_deck_on_card_matches_cpu(card, rung, precision,
                                                  tmp_path, monkeypatch):
    """3 cycles of the cluster deck on a static refined mesh (base 16^3 in
    8^3 blocks, the octant at level 1) on the card against the CPU on both
    refined rungs: the face kernels and one scalar kernel per launch, the
    state to 1e-10 (f64) or 1e-4 (f32)."""
    monkeypatch.setenv("ATHENAPK_PALLAS_STAGE",
                       "1" if rung == "stage" else "0")
    monkeypatch.chdir(tmp_path)
    text = _cluster_text(tmp_path, precision, n=16, mb=8, nlim=3,
                         refinement="static",
                         regions=[(0.0, 0.02, 0.0, 0.02, 0.0, 0.02, 1)])
    kern, skern = ((stage.stage_faces_cuda, stage.stage_scalars_cuda)
                   if rung == "stage"
                   else (sweep.negdiv_faces_cuda, sweep.negdiv_scalars_cuda))
    sims, counts = {}, {}
    for dev in ("cpu", "cuda"):
        n0 = (kern.launches, skern.launches)
        sims[dev] = SmrSimulation(ParameterInput.from_string(text),
                                  quiet=True, device=dev).run()
        counts[dev] = (kern.launches - n0[0], skern.launches - n0[1])
    per = 2 * 2 if rung == "stage" else 2 * 6       # two levels
    assert counts == {"cpu": (0, 0), "cuda": (3 * per, 3 * per)}
    tol = CLUSTER_PRECISIONS[precision]
    for lev, ref in sims["cpu"].state.items():
        got = sims["cuda"].state[lev].cpu()
        assert bool(torch.isfinite(got).all())
        for v in range(ref.shape[1]):
            scale = ref[:, v].abs().max().item()
            assert (got[:, v] - ref[:, v]).abs().max().item() \
                <= tol * scale, (lev, v)


# The cluster's variants that ran on the CPU only until now: the Bondi and
# Booth-Schaye triggering (with the region-mass removal and the accretion
# dt), the fixed-field tower, the dipole field, the .hst columns and the
# HSE self-test file; and the sharded cluster hook over two ranks sharing
# the card.
def _trigger(text, mode):
    return text.replace(
        "triggering_mode = COLD_GAS\naccretion_radius = 0.002",
        f"triggering_mode = {mode}\naccretion_radius = 0.008\n"
        "bondi_alpha = 100.0\nbondi_n0 = 6.5e72\nbondi_beta = 2.0\n"
        "accretion_cfl = 0.25")


CLUSTER_VARIANTS = {
    "boosted_bondi": lambda t: _trigger(t, "BOOSTED_BONDI"),
    "booth_schaye": lambda t: _trigger(t, "BOOTH_SCHAYE"),
    "fixed_field_tower": lambda t: t.replace(
        "fixed_power = 1.0e-3", "fixed_power = 0.0").replace(
        "triggering_mode = COLD_GAS", "triggering_mode = NONE").replace(
        "l_mass_scale = 0.002", "l_mass_scale = 0.002\n"
        "fixed_field_rate = 1.0e-3"),
    # the dipole is the initial field: the B perturbation wants none
    "dipole": lambda t: t.replace("sigma_b = 0.5", "sigma_b = 0.0") + """
<problem/cluster/dipole_b_field>
init_dipole_b_field = true
mx = 1e-9
my = 2e-9
mz = -3e-9
""",
}


@pytest.mark.parametrize("variant", sorted(CLUSTER_VARIANTS))
def test_cluster_variants_on_card_match_cpu(card, variant, tmp_path,
                                            monkeypatch):
    """3 cycles of a cluster variant (16^3 in one ghosted block, f64, the
    ``.hst`` file written every cycle with the cluster's columns) on the
    card against the CPU: every variable to 1e-10 of its largest value,
    every ``.hst`` column to 1e-10 relative, and, for the Bondi modes, the
    accretion dt of the final state."""
    monkeypatch.delenv("ATHENAPK_PALLAS_STAGE", raising=False)
    text = CLUSTER_VARIANTS[variant](_cluster_text(
        tmp_path, "double", n=16, nlim=3)) + HST_BLOCK
    sims, hst = {}, {}
    for dev in ("cpu", "cuda"):
        (tmp_path / dev).mkdir()
        monkeypatch.chdir(tmp_path / dev)
        sims[dev] = Simulation(ParameterInput.from_string(text), quiet=True,
                               device=dev).run()
        hst[dev] = np.loadtxt(next((tmp_path / dev).glob("*.hst")))
    ref, got = sims["cpu"].u, sims["cuda"].u
    assert got.is_cuda and bool(torch.isfinite(got).all())
    for v in range(ref.shape[1]):
        scale = ref[:, v].abs().max().item()
        assert (got[:, v].cpu() - ref[:, v]).abs().max().item() \
            <= 1e-10 * scale, v
    assert hst["cpu"].shape == hst["cuda"].shape and hst["cpu"].shape[0] >= 3
    np.testing.assert_allclose(hst["cuda"], hst["cpu"], rtol=1e-10,
                               atol=1e-300)
    if variant == "dipole":
        assert sims["cpu"].u[:, 7].abs().max().item() > 0
    if variant in ("boosted_bondi", "booth_schaye"):
        dts = [float(cluster_pgen.estimate_timestep(
            s.pin, s.mesh, s.cfg, s.eos, s.pkg.cons_to_prim(s.u)[1], s.t))
            for s in (sims["cpu"], sims["cuda"])]
        assert abs(dts[1] - dts[0]) <= 1e-10 * dts[0]


def test_hse_self_test_file_on_card(card, tmp_path, monkeypatch):
    """``test_he_sphere = true`` writes ``test_he_sphere.dat`` when the
    card run is built, the CPU run's file exactly."""
    text = _cluster_text(tmp_path, "double", n=16, nlim=1).replace(
        "r_sampling = 4.0", "r_sampling = 4.0\ntest_he_sphere = true\n"
        "test_he_sphere_n_r = 400")
    files = {}
    for dev in ("cpu", "cuda"):
        (tmp_path / dev).mkdir()
        monkeypatch.chdir(tmp_path / dev)
        Simulation(ParameterInput.from_string(text), quiet=True, device=dev)
        files[dev] = (tmp_path / dev / "test_he_sphere.dat").read_text()
    assert files["cuda"] == files["cpu"] and len(files["cpu"]) > 0


def test_sharded_cluster_on_card_two_ranks(card, tmp_path, monkeypatch):
    """The cluster's unsplit source over two ranks sharing the card (gloo;
    ``tests/test_torch_cluster_sharded.py``'s deck, flat layout, stage-faces
    rung, 3 cycles) against one rank on the card, bit for bit, with one
    collective per stage on each rank."""
    import json

    import torch_dist_workers as w
    from athenapk_tpu_torch.parallel.dryrun import run_ranks

    monkeypatch.setenv("ATHENAPK_PALLAS_STAGE", "1")
    deck = cluster_deck(half=0.02, n=16, mb=8, nlim=3, refinement="static",
                        regions=[(0.0, 0.02, 0.0, 0.02, 0.0, 0.02, 1)],
                        stellar=False, table=write_cluster_table(
                            tmp_path / "s.cool")).replace(
        "clip_r = 0.02", "clip_r = -1.0")
    sim = w.cluster_sim(deck, "stage", "cuda")
    sm = sim.smesh
    np.savez(tmp_path / "c_in.npz", levels=sm.levels, lx1=sm.lx1,
             lx2=sm.lx2, lx3=sm.lx3,
             **{f"L{k}": v.cpu().numpy() for k, v in sim.state.items()})
    run_ranks(w.run_cases, 2, (str(tmp_path), [("cluster_case", (
        "c", deck, "flat", "stage", 3, False))]), device="cuda", cards=1,
        timeout=600)
    amr = w.cluster_amr(sim)
    ref, dts, _ = w.cluster_cycles(amr, dict(sim.state), 3, False)
    out = np.load(tmp_path / "c.npz")
    nums = json.loads((tmp_path / "c.json").read_text())
    assert nums["dts"] == dts and nums["collectives"] == [6, 6]
    for lev, v in ref.items():
        np.testing.assert_array_equal(out[f"L{lev}"], v.cpu().numpy())


# ------------------------------------------------------------ the EOS kernel
import zlib  # noqa: E402

from athenapk_tpu_torch.eos import adiabatic_cuda  # noqa: E402
from athenapk_tpu_torch.eos.adiabatic import cons_to_prim  # noqa: E402
from torch_decks import EOS_LIMITS, eos_cons  # noqa: E402

# (nb, nz, ny, nx): one ghost-free block; three 8^3 blocks with 3 ghosts;
# an odd nx (f32 takes the kernel's one-cell loads where nz*ny*nx % 4 != 0,
# f64 where it is odd)
EOS_SHAPES = {"ghostfree-nb1": (1, 16, 16, 16),
              "ghosted-nb3": (3, 14, 14, 14),
              "odd-nx-nb3": (3, 5, 3, 7)}


@pytest.mark.parametrize("shape", sorted(EOS_SHAPES))
@pytest.mark.parametrize("limit", sorted(EOS_LIMITS))
@pytest.mark.parametrize("nscalars", [0, 1, 2])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("fluid", ["euler", "glmmhd"])
def test_eos_kernel_matches_plain_bit_for_bit(card, fluid, dtype, nscalars,
                                              limit, shape):
    """One launch gives the plain EOS's prim and floored cons bit for bit
    (NaN where it has NaN), on a state that trips the limit; the input is
    never written; with no limit on the returned cons is the input itself,
    with one on a tensor of its own."""
    eos = EOS(gamma=5.0 / 3.0, **EOS_LIMITS[limit])
    seed = zlib.crc32(f"{fluid}/{dtype}/{nscalars}/{limit}/{shape}".encode())
    u = torch.tensor(eos_cons(fluid, nscalars, seed, EOS_SHAPES[shape]),
                     dtype=dtype, device=card)
    kept = u.clone()
    before = adiabatic_cuda.cons_to_prim_cuda.launches
    got_u, got_w = adiabatic_cuda.fused_cons_to_prim(eos, u, fluid, nscalars)
    torch.cuda.synchronize()
    assert adiabatic_cuda.cons_to_prim_cuda.launches == before + 1
    ref_u, ref_w = cons_to_prim(eos, u, fluid, nscalars)
    assert torch.equal(u, kept)
    if limit == "none":
        assert got_u is u
    else:
        assert got_u.data_ptr() != u.data_ptr()
        assert not torch.equal(ref_u, u)      # the state trips the limit
    for got, ref in ((got_w, ref_w), (got_u, ref_u)):
        assert got.dtype == ref.dtype and got.shape == ref.shape
        torch.testing.assert_close(got, ref, rtol=0.0, atol=0.0,
                                   equal_nan=True)


def test_eos_wrapper_refuses_what_the_kernel_does_not_take(card):
    eos = EOS(gamma=5.0 / 3.0)
    u = torch.tensor(eos_cons("glmmhd", 0, 3, (1, 4, 6, 8)), device=card)
    before = adiabatic_cuda.cons_to_prim_cuda.launches
    with pytest.raises(ValueError, match="CUDA"):
        adiabatic_cuda.cons_to_prim_cuda(eos, u.cpu(), "glmmhd")
    with pytest.raises(ValueError, match="contiguous"):
        adiabatic_cuda.cons_to_prim_cuda(eos, u.transpose(2, 4), "glmmhd")
    with pytest.raises(TypeError):
        adiabatic_cuda.cons_to_prim_cuda(eos, u.long(), "glmmhd")
    with pytest.raises(ValueError):
        adiabatic_cuda.cons_to_prim_cuda(eos, u, "glmmhd", nscalars=1)
    with pytest.raises(ValueError, match="ceiling"):
        adiabatic_cuda.cons_to_prim_cuda(
            EOS(gamma=5.0 / 3.0, velocity_ceiling=1e301), u, "glmmhd")
    assert adiabatic_cuda.cons_to_prim_cuda.launches == before


RK3_WAVE_DECK = WAVE_DECK.replace("integrator = vl2", "integrator = rk3") \
    .replace("reconstruction = ppm", "reconstruction = wenoz") \
    .replace("riemann = hlld", "riemann = hlle")


@pytest.mark.parametrize("rung,per_cycle", [("sweep", 4), ("stage", 0)])
def test_wave_cycle_eos_launches_on_card(card, rung, per_cycle,
                                         monkeypatch):
    """Three RK3 cycles of the benchmark's wave deck (ghost-free, WENO-Z +
    HLLE, f64) on the card: the sweep rung launches the EOS kernel once a
    stage and once for the dt, the stage rung never; on the sweep rung the
    cycles equal, bit for bit, the same cycles with the plain EOS."""
    if rung == "stage":
        monkeypatch.setenv("ATHENAPK_PALLAS_STAGE", "1")
    else:
        monkeypatch.delenv("ATHENAPK_PALLAS_STAGE", raising=False)

    def cycles():
        """The state and dt after three cycles, and the EOS kernel's
        launches in them."""
        sim = Simulation(ParameterInput.from_string(RK3_WAVE_DECK),
                         quiet=True)
        u, dt = sim.u, sim.pkg.estimate_timestep(
            sim.pkg.cons_to_prim(sim.u)[1])[0]
        before = adiabatic_cuda.cons_to_prim_cuda.launches
        for _ in range(3):
            u, (dt, _, _) = sim.pkg.step_with_dt(u, dt, 0.5)
        torch.cuda.synchronize()
        return u, dt, adiabatic_cuda.cons_to_prim_cuda.launches - before

    u, dt, launched = cycles()
    assert launched == 3 * per_cycle
    if rung == "sweep":
        monkeypatch.setattr(adiabatic_cuda, "fused_cons_to_prim",
                            cons_to_prim)
        u_plain, dt_plain, launched = cycles()
        assert launched == 0
        assert torch.equal(u, u_plain) and dt == dt_plain

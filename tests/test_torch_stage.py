"""Port parity: the whole-stage function (``solver/stage.py``) and its
routing in ``HydroPackage`` against the JAX package, on the CPU.

``stage_plain`` is held against both JAX formulations of the same stage:
the composition ``gam0*u0f + gam1*u1 - bdt*div`` of the XLA path in f64
(1e-12 relative to the largest magnitude: the same operations in the same
order, so only rounding differs) and the Pallas kernel ``make_fused_stage``
run in interpret mode in f32, as ``tests/test_pallas_sweep.py`` runs it
(1e-5, that test's tolerance).  The states trip the density, pressure and
internal-energy floors, and ``u1`` differs from ``u0``.

The whole-stage rung of ``HydroPackage`` (picked by
``ATHENAPK_PALLAS_STAGE``) is held against the port's default sweep path
and the JAX package's XLA step.

The CUDA kernel itself runs only on the card (``tests/test_torch_cuda.py``).
"""

import dataclasses
import os

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from athenapk_tpu.config.parameter_input import ParameterInput as JPin
from athenapk_tpu.core.mesh import Mesh as JMesh
from athenapk_tpu.driver import Simulation as JSim
from athenapk_tpu.eos.adiabatic import EOS as JEOS
from athenapk_tpu.solver.hydro_pkg import HydroConfig as JCfg
from athenapk_tpu.solver.hydro_pkg import HydroPackage as JPkg
from athenapk_tpu.solver.pallas_sweep import make_fused_stage
from athenapk_tpu_torch.config.parameter_input import ParameterInput as TPin
from athenapk_tpu_torch.core.mesh import Mesh
from athenapk_tpu_torch.driver import Simulation as TSim
from athenapk_tpu_torch.eos.adiabatic import EOS, prim_to_cons
from athenapk_tpu_torch.solver import stage, sweep
from athenapk_tpu_torch.solver.hydro_pkg import HydroConfig, HydroPackage

torch.set_num_threads(2)

TOL = 1e-12
PAIRS = [("euler", "hllc"), ("euler", "hlle"), ("glmmhd", "hlld")]
FLOORS = dict(density_floor=0.9, pressure_floor=0.8, internal_e_floor=1.25)
GAM0, GAM1, BDT = 0.25, 0.75, 1e-3


def _mesh_kw(n=16, mb=16, g=0, nx3=None):
    nx3 = n if nx3 is None else nx3
    return dict(nx1=n, nx2=n, nx3=nx3, mbnx1=mb, mbnx2=mb,
                mbnx3=min(mb, nx3), x1min=0.0, x1max=1.0, x2min=0.0,
                x2max=1.5, x3min=0.0, x3max=1.5, nghost=g)


def _states(mesh, fluid, seed, trip_floors=True):
    """Two distinct conserved states (numpy, f64); in the first, a few
    percent of the cells fall below the density floor and a few below the
    pressure and internal-energy floors."""
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
    if trip_floors:
        # mild dips, so that PPM's edge states stay positive
        pick = rng.random(cells)
        w[:, 0][pick < 0.03] = 0.8                      # below dfloor
        w[:, 4][(pick > 0.03) & (pick < 0.08)] = 0.6    # below both p floors
    u0 = prim_to_cons(EOS(gamma=5.0 / 3.0), torch.tensor(w), fluid).numpy()
    return u0, 1.01 * u0 + 0.001


def _rel(a, b):
    a = np.asarray(a)
    b = np.asarray(b)
    return np.abs(a - b).max() / np.abs(a).max()


def _packages(kw, fluid, riemann, recon, floors=True, **cfgs):
    fl = FLOORS if floors else {}
    cfgs = dict(fluid=fluid, riemann=riemann, reconstruction=recon, **cfgs)
    jpkg = JPkg(JMesh(**kw), JCfg(**cfgs), JEOS(gamma=5.0 / 3.0, **fl))
    tpkg = HydroPackage(Mesh(**kw), HydroConfig(**cfgs),
                        EOS(gamma=5.0 / 3.0, **fl))
    return jpkg, tpkg


@pytest.mark.parametrize("recon", ["dc", "plm", "ppm"])
@pytest.mark.parametrize("fluid,riemann", PAIRS)
def test_stage_plain_matches_jax_composition(fluid, riemann, recon):
    kw = _mesh_kw()
    jpkg, tpkg = _packages(kw, fluid, riemann, recon)
    u0, u1 = _states(tpkg.mesh, fluid, seed=3)
    c_h = 1.3 if fluid == "glmmhd" else 0.0

    ju0f, jprim = jpkg._cons_to_prim(jnp.asarray(u0))
    # the state does trip the floors
    assert (np.asarray(ju0f)[:, 0] != u0[:, 0]).sum() > 10
    assert (np.asarray(ju0f)[:, 4] != u0[:, 4]).sum() > 10
    div = jpkg._flux_divergence(jpkg._compute_fluxes(jprim, jnp.asarray(c_h),
                                                     recon))
    ref = GAM0 * ju0f + GAM1 * jnp.asarray(u1) - BDT * div
    _, jw_new = jpkg._cons_to_prim(ref)
    ref_dt = float(jpkg._estimate_timestep(jw_new)[1]) / jpkg.cfg.cfl

    got, raw_dt, prim = stage.stage_plain(
        torch.tensor(u0), torch.tensor(u1), GAM0, GAM1, BDT, c_h, tpkg.mesh,
        tpkg.cfg, tpkg.eos, recon, emit_dt=True, emit_prim=True)
    assert np.isfinite(got.numpy()).all()
    assert _rel(ref, got.numpy()) <= TOL
    assert _rel(jprim, prim.numpy()) <= TOL
    assert float(raw_dt.min()) == pytest.approx(ref_dt, rel=TOL)
    # without the optional outputs the first one comes alone
    alone = stage.stage_plain(torch.tensor(u0), torch.tensor(u1), GAM0, GAM1,
                              BDT, c_h, tpkg.mesh, tpkg.cfg, tpkg.eos, recon)
    assert torch.equal(alone, got)


@pytest.mark.parametrize("fluid,riemann,recon", [
    ("euler", "hllc", "ppm"), ("euler", "hlle", "plm"),
    ("glmmhd", "hlld", "ppm"), ("glmmhd", "hlld", "dc")])
def test_stage_plain_matches_pallas_interpret_f32(fluid, riemann, recon):
    """Against ``make_fused_stage(..., interpret=True)`` in f32, with the
    CFL minima (the minimum of the JAX tile output against the port's) and
    the stage-start prim."""
    kw = _mesh_kw()
    jpkg, tpkg = _packages(kw, fluid, riemann, recon)
    u0, u1 = _states(tpkg.mesh, fluid, seed=4)
    u0, u1 = u0.astype(np.float32), u1.astype(np.float32)
    c_h = 1.3 if fluid == "glmmhd" else 0.0
    f32 = jnp.float32
    kern = make_fused_stage(jpkg.mesh, jpkg.cfg, jpkg.eos,
                            jpkg._positivity_mask, recon, tz=8, ty=8,
                            interpret=True, emit_dt=True, emit_prim=True)
    ref, ref_dt, ref_prim = kern(jnp.asarray(u0), jnp.asarray(u1), f32(GAM0),
                                 f32(GAM1), f32(BDT), f32(c_h))
    got, raw_dt, prim = stage.stage_plain(
        torch.tensor(u0), torch.tensor(u1), GAM0, GAM1, BDT, c_h, tpkg.mesh,
        tpkg.cfg, tpkg.eos, recon, emit_dt=True, emit_prim=True)
    assert got.dtype == torch.float32
    assert _rel(ref, got.numpy()) <= 1e-5
    assert _rel(ref_prim, prim.numpy()) <= 1e-5
    assert float(raw_dt.min()) == pytest.approx(float(jnp.min(ref_dt)),
                                                rel=1e-5)


def test_fused_stage_cpu_is_the_plain_path():
    kw = _mesh_kw(n=8, mb=8)
    _, tpkg = _packages(kw, "glmmhd", "hlld", "ppm")
    u0, u1 = (torch.tensor(a) for a in _states(tpkg.mesh, "glmmhd", seed=5))
    args = (u0, u1, GAM0, GAM1, BDT, 1.3, tpkg.mesh, tpkg.cfg, tpkg.eos, "ppm")
    launches = stage.stage_cuda.launches
    got = stage.fused_stage(*args, emit_dt=True)
    ref = stage.stage_plain(*args, emit_dt=True)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    assert stage.stage_cuda.launches == launches


def test_non_cpu_tensor_never_takes_the_plain_stage():
    """A tensor off the CPU goes to the kernel wrapper, which raises on
    what it cannot launch instead of falling back."""
    kw = _mesh_kw(n=8, mb=8)
    mesh, eos = Mesh(**kw), EOS(gamma=5.0 / 3.0)
    u = torch.empty((1, 9) + mesh.block_shape, device="meta")
    ok = HydroConfig(fluid="glmmhd", riemann="hlld", reconstruction="ppm")
    with pytest.raises(ValueError, match="CUDA tensor"):
        stage.fused_stage(u, u, GAM0, GAM1, BDT, 1.3, mesh, ok, eos, "ppm")
    euler = HydroConfig(fluid="euler", riemann="hllc", reconstruction="plm")
    with pytest.raises(ValueError, match="CUDA tensor"):
        stage.fused_stage(u[:, :5], u[:, :5], GAM0, GAM1, BDT, 0.0, mesh,
                          euler, eos, "plm")
    # llf, GLM-MHD hlle and the weno-type reconstructions are taken now:
    # they get as far as the tensor checks, and so do passive scalars
    llf = HydroConfig(fluid="euler", riemann="llf", reconstruction="plm")
    with pytest.raises(ValueError, match="CUDA tensor"):
        stage.fused_stage(u[:, :5], u[:, :5], GAM0, GAM1, BDT, 0.0, mesh, llf,
                          eos, "plm")
    for riemann in ("hlle", "llf"):
        glm = HydroConfig(fluid="glmmhd", riemann=riemann,
                          reconstruction="wenoz")
        with pytest.raises(ValueError, match="CUDA tensor"):
            stage.fused_stage(u, u, GAM0, GAM1, BDT, 1.3, mesh, glm, eos,
                              "wenoz")
    for recon in ("weno3", "limo3", "wenoz"):
        with pytest.raises(ValueError, match="CUDA tensor"):
            stage.fused_stage(u, u, GAM0, GAM1, BDT, 1.3, mesh, ok, eos,
                              recon)
    scalars = HydroConfig(fluid="euler", riemann="hllc", reconstruction="plm",
                          nscalars=1)
    with pytest.raises(ValueError, match="CUDA tensor"):
        stage.fused_stage(u[:, :6], u[:, :6], GAM0, GAM1, BDT, 0.0, mesh,
                          scalars, eos, "plm")


@pytest.mark.parametrize("fn", [stage.stage_plain, stage.stage_cuda],
                         ids=["plain", "cuda"])
def test_stage_refuses_other_layouts(fn):
    """3-D only, and the CFL output only where every cell is interior."""
    eos = EOS(gamma=5.0 / 3.0)
    cfg = HydroConfig(fluid="euler", riemann="hllc", reconstruction="plm")
    flat = Mesh(**_mesh_kw(n=8, mb=8, nx3=1))
    u = torch.ones((1, 5) + flat.block_shape, dtype=torch.float64)
    with pytest.raises(ValueError, match="3-D"):
        fn(u, u, GAM0, GAM1, BDT, 0.0, flat, cfg, eos, "plm")
    ghosted = Mesh(**_mesh_kw(n=8, mb=4, g=2))
    u = torch.ones((8, 5) + ghosted.block_shape, dtype=torch.float64)
    with pytest.raises(ValueError, match="ghost-free"):
        fn(u, u, GAM0, GAM1, BDT, 0.0, ghosted, cfg, eos, "plm", emit_dt=True)


# ------------------------------------------------------- HydroPackage rungs
def _rung_packages(monkeypatch, kw, fluid, riemann, recon, **cfgs):
    """JAX package (XLA step) and the port's default and stage packages;
    the rung is read when a package is built."""
    for name in ("ATHENAPK_PALLAS_SWEEP", "ATHENAPK_PALLAS_STAGE",
                 "ATHENAPK_PALLAS_V2"):
        monkeypatch.delenv(name, raising=False)
    jpkg, default = _packages(kw, fluid, riemann, recon, **cfgs)
    monkeypatch.setenv("ATHENAPK_PALLAS_STAGE", "1")
    _, staged = _packages(kw, fluid, riemann, recon, **cfgs)
    monkeypatch.delenv("ATHENAPK_PALLAS_STAGE")
    return jpkg, default, staged


@pytest.mark.parametrize("fluid,riemann,source,max_dt", [
    ("glmmhd", "hlld", "dedner_plain", 0.5),
    ("glmmhd", "hlld", "dedner_extended", -1.0),
    ("euler", "hllc", "dedner_plain", -1.0),
    ("euler", "hlle", "dedner_plain", 1e-4)])
def test_step_with_dt_rungs_match_default_and_jax(monkeypatch, fluid, riemann,
                                                  source, max_dt):
    kw = _mesh_kw()
    jpkg, default, staged = _rung_packages(
        monkeypatch, kw, fluid, riemann, "ppm", integrator="vl2",
        glmmhd_source=source, max_dt=max_dt)
    assert not default._use_fused_stage()
    assert staged._use_fused_stage()
    # the extended Dedner source reads prim after the kernel, so the last
    # stage cannot hand out the next dt
    assert staged._use_fused_stage_dt() == (source == "dedner_plain")
    assert staged._stage_needs_prim() == (source == "dedner_extended")

    u0, _ = _states(default.mesh, fluid, seed=6)
    dt, c_h = 1e-3, (1.2 if fluid == "glmmhd" else 0.0)
    ju, jdts = jpkg.step_with_dt(jnp.asarray(u0), jnp.asarray(dt),
                                 jnp.asarray(c_h), 0.0)
    calls = []
    monkeypatch.setattr(stage, "fused_stage", lambda *a, **k: (
        calls.append(a[9]), stage.stage_plain(*a, **k))[1])
    for name, pkg, want in (("default", default, []),
                            ("stage", staged, ["dc", "ppm"])):
        del calls[:]
        u, dts = pkg.step_with_dt(torch.tensor(u0), dt, c_h)
        assert calls == want, name
        assert _rel(ju, u.numpy()) <= TOL, name
        assert dts[0] == pytest.approx(float(jdts[0]), rel=TOL), name
        assert dts[1] == pytest.approx(float(jdts[1]), rel=TOL), name
        assert dts[2] == float("inf")


def test_stage_rung_on_ghosted_blocks_matches_default(monkeypatch):
    """Ghosted multi-block layout: the stage rung is taken (the wrap lands
    in the ghost rim, the boundary fill overwrites it), the dt comes from
    the ordinary estimate."""
    kw = _mesh_kw(mb=8, g=3)
    jpkg, default, staged = _rung_packages(
        monkeypatch, kw, "euler", "hllc", "ppm", integrator="vl2")
    assert staged._use_fused_stage() and not staged._use_fused_stage_dt()
    with pytest.raises(ValueError, match="emit_dt"):
        staged.step(torch.zeros(1), 1e-3, 0.0, emit_dt=True)
    u0, _ = _states(default.mesh, "euler", seed=7)
    u0 = default.apply_boundaries(torch.tensor(u0))
    ju, jdts = jpkg.step_with_dt(jnp.asarray(u0.numpy()), jnp.asarray(1e-3),
                                 jnp.asarray(0.0), 0.0)
    for pkg in (default, staged):
        u, dts = pkg.step_with_dt(u0, 1e-3, 0.0)
        assert _rel(ju, u.numpy()) <= TOL
        assert dts[0] == pytest.approx(float(jdts[0]), rel=TOL)


def test_rung_eligibility(monkeypatch):
    """Twins of the JAX package's eligibility rules: 3-D only, no
    first-order flux correction."""
    flat = _mesh_kw(nx3=1)
    _, default, staged = _rung_packages(
        monkeypatch, flat, "glmmhd", "hlld", "ppm", integrator="vl2")
    assert not staged._use_fused_stage()
    assert not staged._use_fused_stage_dt()

    _, default, staged = _rung_packages(
        monkeypatch, _mesh_kw(), "glmmhd", "hlld", "ppm", integrator="rk2")
    assert staged._use_fused_stage() and staged._use_fused_stage_dt()
    # the rung is fixed when the package is built
    monkeypatch.setenv("ATHENAPK_PALLAS_STAGE", "1")
    assert not default._use_fused_stage()
    staged.cfg = dataclasses.replace(staged.cfg, first_order_flux_correct=True,
                                     integrator="vl2")
    assert not staged._use_fused_stage()
    no_hyp = dataclasses.replace(staged.cfg, first_order_flux_correct=False,
                                 calc_dt_hyp=False)
    staged.cfg = no_hyp
    assert staged._use_fused_stage() and not staged._use_fused_stage_dt()


# ----------------------------------------------------------- slice as a whole
WAVE_DECK = """
<job>
problem_id = linear_wave_mhd
<problem/linear_wave>
compute_error = true
wave_flag = 0
amp = 1.0e-6
vflow = 0.0
test = true
<parthenon/mesh>
nghost = 3
merge_blocks = true
nx1 = 16
x1min = 0.0
x1max = 3.0
nx2 = 16
x2min = 0.0
x2max = 1.5
nx3 = 16
x3min = 0.0
x3max = 1.5
<parthenon/meshblock>
nx1 = 8
nx2 = 8
nx3 = 8
<parthenon/time>
integrator = vl2
cfl = 0.3
tlim = 100.0
nlim = 5
ncycle_out = 0
<hydro>
fluid = glmmhd
eos = adiabatic
riemann = hlld
reconstruction = ppm
gamma = 1.666666666666667
<parthenon/output1>
file_type = hst
"""


@pytest.mark.parametrize("rung", ["ATHENAPK_PALLAS_STAGE", "default"])
def test_wave_deck_on_the_rungs_matches_jax(rung, tmp_path, monkeypatch):
    """The 3-D MHD wave at 16^3 for 5 cycles: the JAX ``Simulation`` (XLA
    step) against the port's on the stage rung and on the default sweep
    path.  State 1e-10 (rounding-order differences only), every cycle's dt
    in the history."""
    for name in ("ATHENAPK_PALLAS_SWEEP", "ATHENAPK_PALLAS_STAGE"):
        monkeypatch.delenv(name, raising=False)
    js = JSim(JPin.from_string(WAVE_DECK), quiet=True)
    if rung != "default":
        monkeypatch.setenv(rung, "1")
    ts = TSim(TPin.from_string(WAVE_DECK), quiet=True, device="cpu")
    monkeypatch.delenv(rung, raising=False)
    assert ts.mesh.nghost == 0 and ts.mesh.nblocks == 1
    assert ts.pkg._use_fused_stage() == (rung == "ATHENAPK_PALLAS_STAGE")
    ts.load_state(np.asarray(js.u), js.t, js.ncycle)
    calls = []
    monkeypatch.setattr(stage, "fused_stage", lambda *a, **k: (
        calls.append(a[9]), stage.stage_plain(*a, **k))[1])
    for sub, sim in (("jax", js), ("torch", ts)):
        os.makedirs(tmp_path / sub)
        monkeypatch.chdir(tmp_path / sub)
        sim.run()
    assert len(calls) == (10 if rung == "ATHENAPK_PALLAS_STAGE" else 0)
    a, b = np.asarray(js.u), ts.u.numpy()
    assert ts.ncycle == js.ncycle == 5
    assert np.abs(a - b).max() <= 1e-10 * np.abs(a).max()
    assert ts.t == pytest.approx(js.t, rel=1e-10)
    hj = np.loadtxt(tmp_path / "jax" / "linear_wave_mhd.out1.hst")
    ht = np.loadtxt(tmp_path / "torch" / "linear_wave_mhd.out1.hst")
    np.testing.assert_allclose(ht[:, :2], hj[:, :2], rtol=1e-10)

"""Port parity: passive scalars in the kernels' plain versions and in the
steppers, against the JAX package on the CPU in f64.

* ``sweep.negdiv_plain`` against ``make_fused_negdiv`` (3-D) and
  ``make_fused_negdiv_v2`` (2-D) in interpret mode and the XLA
  composition; ``negdiv_faces_plain`` against ``make_fused_negdiv_faces_v2``;
  ``stage.stage_plain`` and ``stage_faces_plain`` against
  ``make_fused_stage`` and ``make_fused_stage_faces`` in interpret mode (as
  ``tests/test_pallas_sweep.py`` runs the Pallas kernels on the CPU):
  GLM-MHD HLLD + PPM with 1 and 3 scalars, Euler HLLC + PLM with 4;
* the scalar kernels' plain twins (``negdiv_scalars_plain``,
  ``stage_scalars_plain``) give the scalar rows of the whole functions
  bit for bit;
* the ``advection`` deck with scalars through both packages'
  ``run_from_file`` (the CLI's call), 2-D and 3-D, 5 cycles: the ``.hst``
  file and the state.

Gate: 1e-12 relative to each output's largest magnitude.  The CUDA
kernels run only on the card (``tests/test_torch_cuda.py``).
"""

import contextlib

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from athenapk_tpu import driver as jdriver
from athenapk_tpu.core.mesh import Mesh as JMesh
from athenapk_tpu.eos.adiabatic import EOS as JEOS
from athenapk_tpu.solver import pallas_sweep as ps
from athenapk_tpu.solver.hydro_pkg import HydroConfig as JCfg
from athenapk_tpu.solver.hydro_pkg import HydroPackage as JPkg
from athenapk_tpu_torch import driver as tdriver
from athenapk_tpu_torch.amr.smr import LevelMesh
from athenapk_tpu_torch.core.mesh import Mesh
from athenapk_tpu_torch.eos.adiabatic import EOS, prim_to_cons
from athenapk_tpu_torch.solver import stage, sweep
from athenapk_tpu_torch.solver.hydro_pkg import HydroConfig
from torch_decks import CASES, HST_BLOCK, deck

torch.set_num_threads(2)

TOL = 1e-12
C_H = 1.3
GAM0, GAM1, BDT = 0.25, 0.75, 1e-3
FLOORS = dict(density_floor=0.9, pressure_floor=0.8, internal_e_floor=1.25)
# (fluid, riemann, reconstruction, nscalars)
CASES_S = [("glmmhd", "hlld", "ppm", 1), ("glmmhd", "hlld", "ppm", 3),
           ("euler", "hllc", "plm", 4)]
IDS = ["-".join(map(str, c)) for c in CASES_S]


def _kw(n=(12, 10, 8), g=0, mb=None):
    mb = mb or n
    return dict(nx1=n[0], nx2=n[1], nx3=n[2], mbnx1=mb[0], mbnx2=mb[1],
                mbnx3=mb[2], x1min=0.0, x1max=1.0, x2min=0.0, x2max=1.5,
                x3min=0.0, x3max=1.5, nghost=g)


def _prim(shape, fluid, ns, seed):
    """Positive density and pressure, the other fluid components of either
    sign, a few percent of the cells under the floors, and ``ns`` scalars
    that are 0 in part of the domain (numpy, f64)."""
    rng = np.random.default_rng(seed)
    nf = 9 if fluid == "glmmhd" else 5
    cells = (shape[0],) + tuple(shape[1:])
    w = np.ones((shape[0], nf + ns) + tuple(shape[1:]))
    w[:, 0] = 1.0 + 0.3 * rng.random(cells)
    w[:, 1:4] = 0.3 * rng.standard_normal((cells[0], 3) + cells[1:])
    w[:, 4] = 1.0 + 0.2 * rng.random(cells)
    if nf == 9:
        w[:, 5:8] = 0.2 * rng.standard_normal((cells[0], 3) + cells[1:])
        w[:, 8] = 0.01 * rng.standard_normal(cells)
    pick = rng.random(cells)
    w[:, 0][pick < 0.03] = 0.8
    w[:, 4][(pick > 0.03) & (pick < 0.08)] = 0.6
    q = (shape[0], ns) + cells[1:]
    w[:, nf:] = np.maximum(rng.standard_normal(q), 0.0) * rng.random(q)
    return w


def _cfgs(case):
    fluid, riemann, recon, ns = case
    kw = dict(fluid=fluid, riemann=riemann, reconstruction=recon,
              nscalars=ns)
    return HydroConfig(**kw), JCfg(**kw), (C_H if fluid == "glmmhd" else 0.0)


def _mask(nvar):
    return tuple(v in (0, 4) for v in range(nvar))


def _rel(got, want, sl=None):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    if sl is not None:
        got, want = got[sl], want[sl]
    return float(np.abs(got - want).max() / np.abs(want).max())


def _level_mesh(mb, g, ndim=3):
    nx = (2 * mb, 2 * mb, 2 * mb if ndim == 3 else 1)
    base = Mesh(**_kw(nx, g, (mb, mb, mb if ndim == 3 else 1)))
    return LevelMesh(base, (base.dx1 / 2, base.dx2 / 2,
                            base.dx3 / (2 if ndim == 3 else 1)))


@pytest.mark.parametrize("ndim", [3, 2])
@pytest.mark.parametrize("case", CASES_S, ids=IDS)
def test_negdiv_plain_with_scalars_matches_jax(case, ndim):
    cfg, jcfg, c_h = _cfgs(case)
    kw = _kw((12, 10, 8) if ndim == 3 else (16, 12, 1))
    mesh, jmesh = Mesh(**kw), JMesh(**kw)
    eos, jeos = EOS(gamma=5.0 / 3.0), JEOS(gamma=5.0 / 3.0)
    recon = cfg.reconstruction
    w = _prim((1,) + mesh.block_shape, cfg.fluid, cfg.nscalars, 3)
    got = sweep.negdiv_plain(torch.tensor(w), c_h, mesh, cfg, eos, recon)
    jpkg = JPkg(jmesh, jcfg, jeos)
    xla = -jpkg._flux_divergence(jpkg._compute_fluxes(
        jnp.asarray(w), jnp.asarray(c_h), recon))
    make = ps.make_fused_negdiv if ndim == 3 else ps.make_fused_negdiv_v2
    fn = make(jmesh, jcfg, jeos, _mask(cfg.nvar), recon, interpret=True)
    for ref in (xla, fn(jnp.asarray(w), jnp.asarray(c_h))):
        assert _rel(got, ref) <= TOL
    # the scalar kernel's plain twin gives the scalar rows bit for bit
    nb0 = sweep.scalar_base(cfg)
    prim = torch.tensor(w)
    twin = None
    for d in sweep.active_dirs(mesh):
        fd = sweep.directional_flux(prim, c_h, d, mesh.dx[d - 1], cfg, eos,
                                    recon)[:, 0]
        nd, _ = sweep.negdiv_scalars_plain(prim, fd, d, mesh, cfg, recon)
        twin = nd if twin is None else twin + nd
    assert torch.equal(twin, got[:, nb0:])


@pytest.mark.parametrize("case", CASES_S, ids=IDS)
def test_negdiv_faces_plain_with_scalars_matches_jax(case):
    cfg, jcfg, c_h = _cfgs(case)
    lm = _level_mesh(8, 3)
    eos, jeos = EOS(gamma=5.0 / 3.0), JEOS(gamma=5.0 / 3.0)
    recon = cfg.reconstruction
    w = _prim((2,) + lm.block_shape, cfg.fluid, cfg.nscalars, 5)
    got_nd, got_f = sweep.negdiv_faces_plain(torch.tensor(w), c_h, lm, cfg,
                                             eos, recon)
    fn = ps.make_fused_negdiv_faces_v2(lm.block_shape, lm.dx, jcfg, jeos,
                                       _mask(cfg.nvar), recon, 3,
                                       interpret=True)
    nd, faces = fn(jnp.asarray(w), c_h)
    assert _rel(got_nd, nd, lm.interior_slices) <= TOL
    assert sorted(got_f) == sorted(faces) == [1, 2, 3]
    for d in (1, 2, 3):
        assert _rel(got_f[d], faces[d]) <= TOL, d


@pytest.mark.parametrize("case", CASES_S, ids=IDS)
def test_stage_plain_with_scalars_matches_jax(case):
    cfg, jcfg, c_h = _cfgs(case)
    kw = _kw((16, 8, 8))
    mesh, jmesh = Mesh(**kw), JMesh(**kw)
    eos, jeos = EOS(gamma=5.0 / 3.0, **FLOORS), JEOS(gamma=5.0 / 3.0,
                                                       **FLOORS)
    recon = cfg.reconstruction
    w = torch.tensor(_prim((1,) + mesh.block_shape, cfg.fluid, cfg.nscalars,
                           7))
    u0 = prim_to_cons(EOS(gamma=5.0 / 3.0), w, cfg.fluid, cfg.nscalars)
    u1 = 1.01 * u0 + 0.001
    got, raw_dt, prim = stage.stage_plain(u0, u1, GAM0, GAM1, BDT, c_h, mesh,
                                          cfg, eos, recon, emit_dt=True,
                                          emit_prim=True)
    kern = ps.make_fused_stage(jmesh, jcfg, jeos, _mask(cfg.nvar), recon,
                               tz=8, ty=8, interpret=True, emit_dt=True,
                               emit_prim=True)
    ref, ref_dt, ref_prim = kern(jnp.asarray(u0.numpy()),
                                 jnp.asarray(u1.numpy()), GAM0, GAM1, BDT,
                                 c_h)
    assert _rel(got, ref) <= TOL
    assert _rel(prim, ref_prim) <= TOL
    assert float(raw_dt.min()) == pytest.approx(float(jnp.min(ref_dt)),
                                                rel=TOL)
    # the scalar kernel's plain twin gives the scalar rows bit for bit
    fluxes = sweep.compute_fluxes(prim, c_h, mesh, cfg, eos, recon)
    u_s, w_s = stage.stage_scalars_plain(
        u0, u1, {d: f[:, 0] for d, f in fluxes.items()}, GAM0, GAM1, BDT,
        mesh, cfg, eos, recon)
    nb0 = sweep.scalar_base(cfg)
    assert torch.equal(u_s, got[:, nb0:])
    assert torch.equal(w_s, prim[:, nb0:])


@pytest.mark.parametrize("case", CASES_S, ids=IDS)
def test_stage_faces_plain_with_scalars_matches_jax(case):
    cfg, jcfg, c_h = _cfgs(case)
    lm = _level_mesh(8, 3)
    eos, jeos = EOS(gamma=5.0 / 3.0, **FLOORS), JEOS(gamma=5.0 / 3.0,
                                                       **FLOORS)
    recon = cfg.reconstruction
    w = torch.tensor(_prim((2,) + lm.block_shape, cfg.fluid, cfg.nscalars,
                           9))
    u0 = prim_to_cons(EOS(gamma=5.0 / 3.0), w, cfg.fluid, cfg.nscalars)
    u1 = 1.01 * u0 + 0.001
    got = stage.stage_faces_plain(u0, u1, GAM0, GAM1, BDT, c_h, lm, cfg, eos,
                                  recon, emit_prim=True)
    fn = ps.make_fused_stage_faces(lm.block_shape, lm.dx, jcfg, jeos,
                                   _mask(cfg.nvar), recon, 3, interpret=True,
                                   emit_prim=True)
    want = fn(jnp.asarray(u0.numpy()), jnp.asarray(u1.numpy()), GAM0, GAM1,
              BDT, c_h)
    assert _rel(got[0], want[0], lm.interior_slices) <= TOL
    assert _rel(got[1], want[1]) <= TOL
    for d in (1, 2, 3):
        assert _rel(got[2][d], want[2][d]) <= TOL, d


def _run(mod, path, outdir):
    outdir.mkdir(parents=True, exist_ok=True)
    kw = {} if mod is jdriver else {"device": "cpu"}
    with contextlib.chdir(outdir):
        sim = mod.run_from_file(str(path), quiet=True, **kw)
    return sim, np.loadtxt(next(outdir.glob("*.hst")))


@pytest.mark.parametrize("ndim", [2, 3])
def test_advection_deck_with_scalars_matches_jax(ndim, tmp_path):
    """The advection deck with 2 scalars through both packages'
    ``run_from_file``: 5 cycles, the state and every ``.hst`` column to
    1e-12."""
    spec = dict(CASES["advection_scalar"], extra_hydro="nscalars = 2",
                merge="true")
    if ndim == 3:
        spec.update(nx=(16, 16, 16), mb=(8, 8, 8))
    path = tmp_path / "advection.in"
    path.write_text(deck(**spec) + HST_BLOCK)
    js, jh = _run(jdriver, path, tmp_path / "jax")
    ts, th = _run(tdriver, path, tmp_path / "torch")
    assert ts.ncycle == js.ncycle == 5
    assert ts.cfg.nvar == 7 and ts.mesh.nghost == js.mesh.nghost
    a, b = np.asarray(js.u), ts.u.numpy()
    assert _rel(b, a) <= TOL
    assert jh.shape == th.shape
    # each column to 1e-12 of its largest magnitude, or of the mass's (a
    # momentum sum that is 0 up to rounding has no relative error)
    scale = np.maximum(np.abs(jh).max(axis=0), np.abs(jh[:, 2]).max())
    assert (np.abs(th - jh) <= TOL * scale).all()
    assert np.abs(b[:, 5:]).max() > 0.1     # the scalars were advected

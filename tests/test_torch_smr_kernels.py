"""Port parity: the face-capturing functions of the refined-mesh path
against the JAX package's Pallas kernels, run in interpret mode on the
CPU (as ``tests/test_smr_stage_fused.py`` and ``test_pallas_sweep.py`` run
them):

* ``stage.stage_faces_plain`` against ``make_fused_stage_faces`` (TPU
  kernel #7): ``u_new`` on the interior cells (its ghost rim is rewritten
  by the fill; the JAX kernel's lane packing leaves other values there),
  the stage-start ``prim`` and every face slab in full;
* ``sweep.negdiv_faces_plain`` against ``make_fused_negdiv_faces_v2``
  (#6 in 3-D, #5 in 2-D) and ``make_fused_negdiv_faces`` (#2, composed per
  direction): -div(F) on the interior cells and every slab in full.

Gates: 1e-12 relative to each output's largest magnitude in f64 (the
same operations in the same order; rounding only), and the JAX package's
own 2e-5 (``test_smr_stage_fused.py:52``) in f32.  States trip the
density, pressure and internal-energy floors; ``u1`` differs from ``u0``;
extents 14 = 8 + 2*3 and 22 = 16 + 2*3 leave remainder tiles in the CUDA
kernels (``tests/test_torch_cuda.py`` runs these same cases there).

The CUDA kernels themselves run only on the card.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from athenapk_tpu.eos.adiabatic import EOS as JEOS
from athenapk_tpu.solver import pallas_sweep as ps
from athenapk_tpu.solver.hydro_pkg import HydroConfig as JCfg
from athenapk_tpu_torch.amr.smr import LevelMesh
from athenapk_tpu_torch.core.mesh import Mesh
from athenapk_tpu_torch.eos.adiabatic import EOS, prim_to_cons
from athenapk_tpu_torch.solver import stage, sweep
from athenapk_tpu_torch.solver.hydro_pkg import HydroConfig

torch.set_num_threads(2)

FLOORS = dict(density_floor=0.9, pressure_floor=0.8, internal_e_floor=1.25)
GAM0, GAM1, BDT, C_H = 0.25, 0.75, 1e-3, 1.3
TOLS = {"f64": (jnp.float64, torch.float64, 1e-12),
        "f32": (jnp.float32, torch.float32, 2e-5)}
# (fluid, riemann, reconstruction, meshblock, nghost)
CASES = [("euler", "hllc", "ppm", 8, 3), ("euler", "hlle", "plm", 16, 3),
         ("glmmhd", "hlld", "ppm", 8, 3), ("euler", "hlle", "dc", 8, 2)]
# every case in f64; f32 (the JAX package's working type on the TPU) on two
RUNS = [(c, "f64") for c in CASES] + [(CASES[0], "f32"), (CASES[2], "f32")]
RUN_IDS = ["-".join(map(str, c)) + "-" + p for c, p in RUNS]


def _level_mesh(mb, g, ndim=3):
    nx = (2 * mb, 2 * mb, 2 * mb if ndim == 3 else 1)
    base = Mesh(nx1=nx[0], nx2=nx[1], nx3=nx[2], mbnx1=mb, mbnx2=mb,
                mbnx3=mb if ndim == 3 else 1, x1min=0.0, x1max=1.0,
                x2min=0.0, x2max=1.5, x3min=0.0, x3max=1.5, nghost=g)
    # a level-1 geometry: the base's blocks with halved widths
    s3 = 2 if ndim == 3 else 1
    return LevelMesh(base, (base.dx1 / 2, base.dx2 / 2, base.dx3 / s3))


def _prim(lm, fluid, seed, nb=3):
    """Positive density and pressure, every other component of either sign,
    a few percent of the cells dipping under the floors (numpy, f64)."""
    rng = np.random.default_rng(seed)
    nvar = 9 if fluid == "glmmhd" else 5
    cells = (nb,) + lm.block_shape
    w = np.ones((nb, nvar) + lm.block_shape)
    w[:, 0] = 1.0 + 0.3 * rng.random(cells)
    w[:, 1:4] = 0.3 * rng.standard_normal((nb, 3) + cells[1:])
    w[:, 4] = 1.0 + 0.2 * rng.random(cells)
    if nvar == 9:
        w[:, 5:8] = 0.2 * rng.standard_normal((nb, 3) + cells[1:])
        w[:, 8] = 0.01 * rng.standard_normal(cells)
    pick = rng.random(cells)
    w[:, 0][pick < 0.03] = 0.8
    w[:, 4][(pick > 0.03) & (pick < 0.08)] = 0.6
    return w


def _cfgs(fluid, riemann, recon):
    return (HydroConfig(fluid=fluid, riemann=riemann, reconstruction=recon),
            JCfg(fluid=fluid, riemann=riemann, reconstruction=recon))


def _rel(got, want, sl=None):
    got, want = got.numpy(), np.asarray(want)
    assert got.shape == want.shape
    if sl is not None:
        got, want = got[sl], want[sl]
    return float(np.abs(got - want).max() / np.abs(want).max())


def _mask(nvar):
    return tuple(v in (0, 4) for v in range(nvar))


@pytest.mark.parametrize("case,prec", RUNS, ids=RUN_IDS)
def test_stage_faces_matches_pallas(case, prec):
    fluid, riemann, recon, mb, g = case
    jdt, tdt, tol = TOLS[prec]
    lm = _level_mesh(mb, g)
    cfg, jcfg = _cfgs(fluid, riemann, recon)
    eos, jeos = EOS(gamma=5.0 / 3.0, **FLOORS), JEOS(gamma=5.0 / 3.0, **FLOORS)
    u0 = prim_to_cons(EOS(gamma=5.0 / 3.0), torch.tensor(_prim(lm, fluid, 3)),
                      fluid)
    u1 = 1.01 * u0 + 0.001
    c_h = C_H if fluid == "glmmhd" else 0.0
    fn = ps.make_fused_stage_faces(lm.block_shape, lm.dx, jcfg, jeos,
                                   _mask(cfg.nvar), recon, g, interpret=True,
                                   emit_prim=True)
    want = fn(jnp.asarray(u0.numpy(), jdt), jnp.asarray(u1.numpy(), jdt),
              GAM0, GAM1, BDT, c_h)
    got = stage.fused_stage_faces(u0.to(tdt), u1.to(tdt), GAM0, GAM1, BDT,
                                  c_h, lm, cfg, eos, recon, emit_prim=True)
    assert _rel(got[0], want[0], lm.interior_slices) <= tol
    assert _rel(got[1], want[1]) <= tol
    assert sorted(got[2]) == [1, 2, 3]
    for d in (1, 2, 3):
        assert _rel(got[2][d], want[2][d]) <= tol
    # without emit_prim there is no prim, and the rest is the same
    u_new, prim, faces = stage.stage_faces_plain(
        u0.to(tdt), u1.to(tdt), GAM0, GAM1, BDT, c_h, lm, cfg, eos, recon)
    assert prim is None and torch.equal(u_new, got[0])
    assert all(torch.equal(faces[d], got[2][d]) for d in (1, 2, 3))


def test_stage_faces_is_stage_plain_plus_slabs():
    lm = _level_mesh(8, 3)
    cfg, _ = _cfgs("euler", "hllc", "ppm")
    eos = EOS(gamma=5.0 / 3.0, **FLOORS)
    u0 = prim_to_cons(eos, torch.tensor(_prim(lm, "euler", 5)), "euler")
    args = (u0, 1.01 * u0, GAM0, GAM1, BDT, 0.0, lm, cfg, eos, "ppm")
    u_new, _, faces = stage.stage_faces_plain(*args)
    assert torch.equal(u_new, stage.stage_plain(*args))
    fluxes = sweep.compute_fluxes(
        stage.cons_to_prim(eos, u0, "euler", 0)[1], 0.0, lm, cfg, eos, "ppm")
    g, n = 3, 8
    assert torch.equal(faces[1][..., 0], fluxes[1][..., g])
    assert torch.equal(faces[1][..., 1], fluxes[1][..., g + n])
    assert torch.equal(faces[2][..., 1], fluxes[2][:, :, :, g + n])
    assert torch.equal(faces[3][..., 0], fluxes[3][:, :, g])


@pytest.mark.parametrize("case,prec", RUNS, ids=RUN_IDS)
def test_negdiv_faces_matches_pallas_3d(case, prec):
    fluid, riemann, recon, mb, g = case
    jdt, tdt, tol = TOLS[prec]
    lm = _level_mesh(mb, g)
    cfg, jcfg = _cfgs(fluid, riemann, recon)
    eos, jeos = EOS(gamma=5.0 / 3.0), JEOS(gamma=5.0 / 3.0)
    w = _prim(lm, fluid, 7)
    c_h = C_H if fluid == "glmmhd" else 0.0
    got_nd, got_f = sweep.fused_negdiv_faces(
        torch.tensor(w, dtype=tdt), c_h, lm, cfg, eos, recon)
    for make in (ps.make_fused_negdiv_faces_v2, ps.make_fused_negdiv_faces):
        fn = make(lm.block_shape, lm.dx, jcfg, jeos, _mask(cfg.nvar), recon,
                  g, interpret=True)
        nd, faces = fn(jnp.asarray(w, jdt), c_h)
        assert _rel(got_nd, nd, lm.interior_slices) <= tol, make.__name__
        assert sorted(got_f) == sorted(faces) == [1, 2, 3]
        for d in (1, 2, 3):
            assert _rel(got_f[d], faces[d]) <= tol, (make.__name__, d)


@pytest.mark.parametrize("prec", sorted(TOLS))
@pytest.mark.parametrize("case", [("euler", "hllc", "plm", 16, 3),
                                  ("glmmhd", "hlld", "ppm", 8, 3)],
                         ids=lambda c: "-".join(map(str, c)))
def test_negdiv_faces_matches_pallas_2d(case, prec):
    fluid, riemann, recon, mb, g = case
    jdt, tdt, tol = TOLS[prec]
    lm = _level_mesh(mb, g, ndim=2)
    cfg, jcfg = _cfgs(fluid, riemann, recon)
    eos, jeos = EOS(gamma=1.4), JEOS(gamma=1.4)
    w = _prim(lm, fluid, 11)
    c_h = C_H if fluid == "glmmhd" else 0.0
    got_nd, got_f = sweep.fused_negdiv_faces(
        torch.tensor(w, dtype=tdt), c_h, lm, cfg, eos, recon)
    fn = ps.make_fused_negdiv_faces_v2(lm.block_shape, lm.dx, jcfg, jeos,
                                       _mask(cfg.nvar), recon, g,
                                       interpret=True)
    nd, faces = fn(jnp.asarray(w, jdt), c_h)
    assert _rel(got_nd, nd, lm.interior_slices) <= tol
    assert sorted(got_f) == sorted(faces) == [1, 2]
    for d in (1, 2):
        assert tuple(got_f[d].shape) == faces[d].shape
        assert _rel(got_f[d], faces[d]) <= tol


def test_negdiv_faces_1d_slab_is_the_flux():
    base = Mesh(nx1=32, nx2=1, nx3=1, mbnx1=16, mbnx2=1, mbnx3=1,
                x1min=0.0, x1max=1.0, x2min=-0.5, x2max=0.5, x3min=-0.5,
                x3max=0.5, nghost=2)
    lm = LevelMesh(base, (base.dx1 / 2, base.dx2, base.dx3))
    cfg, _ = _cfgs("euler", "hllc", "plm")
    eos = EOS(gamma=1.4)
    prim = torch.tensor(_prim(lm, "euler", 13))
    nd, faces = sweep.negdiv_faces_plain(prim, 0.0, lm, cfg, eos, "plm")
    assert torch.equal(nd, sweep.negdiv_plain(prim, 0.0, lm, cfg, eos, "plm"))
    F = sweep.directional_flux(prim, 0.0, 1, lm.dx1, cfg, eos, "plm")
    assert sorted(faces) == [1] and faces[1].shape == (3, 5, 1, 1, 2)
    assert torch.equal(faces[1][..., 0], F[..., 2])
    assert torch.equal(faces[1][..., 1], F[..., 18])


def test_kernel_wrappers_refuse_cpu_tensors_and_ghost_free_layouts():
    lm = _level_mesh(8, 3)
    cfg, _ = _cfgs("euler", "hllc", "ppm")
    eos = EOS(gamma=5.0 / 3.0)
    u = prim_to_cons(eos, torch.tensor(_prim(lm, "euler", 1)), "euler")
    with pytest.raises(ValueError, match="CUDA"):
        stage.stage_faces_cuda(u, u, GAM0, GAM1, BDT, 0.0, lm, cfg, eos,
                               "ppm")
    with pytest.raises(ValueError, match="CUDA"):
        sweep.negdiv_faces_cuda(u, 0.0, lm, cfg, eos, "ppm")
    free = Mesh(nx1=8, nx2=8, nx3=8, mbnx1=8, mbnx2=8, mbnx3=8, x1min=0.0,
                x1max=1.0, x2min=0.0, x2max=1.0, x3min=0.0, x3max=1.0,
                nghost=0)
    q = torch.ones((1, 5, 8, 8, 8), dtype=torch.float64)
    with pytest.raises(ValueError, match="ghosted"):
        sweep.fused_negdiv_faces(q, 0.0, free, cfg, eos, "ppm")
    with pytest.raises(ValueError, match="ghosted"):
        stage.fused_stage_faces(q, q, GAM0, GAM1, BDT, 0.0, free, cfg, eos,
                                "ppm")

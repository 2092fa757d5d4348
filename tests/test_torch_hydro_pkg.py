"""Port parity: ``solver/hydro_pkg.py``, ``core/boundaries.py`` and
``outputs/history.py`` against the JAX package, in f64 on the CPU.

Small meshes (8^3, a few blocks), inputs made with numpy from a seed.
Tolerance 1e-12 relative to the largest magnitude unless a test says
otherwise: the same operations run in both packages, only in other orders
inside reductions.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from athenapk_tpu.core.boundaries import make_boundary_fn as j_bc
from athenapk_tpu.core.mesh import Mesh as JMesh
from athenapk_tpu.eos.adiabatic import EOS as JEOS
from athenapk_tpu.outputs.history import HistoryOutput as JHist
from athenapk_tpu.solver.hydro_pkg import HydroConfig as JCfg
from athenapk_tpu.solver.hydro_pkg import HydroPackage as JPkg
from athenapk_tpu_torch.core.boundaries import check_reflecting_mhd
from athenapk_tpu_torch.core.boundaries import make_boundary_fn as t_bc
from athenapk_tpu_torch.core.mesh import Mesh
from athenapk_tpu_torch.eos.adiabatic import EOS, prim_to_cons
from athenapk_tpu_torch.outputs.history import HistoryOutput as THist
from athenapk_tpu_torch.solver.hydro_pkg import HydroConfig, HydroPackage

torch.set_num_threads(2)

TOL = 1e-12


def _rel(a, b):
    a = np.asarray(a)
    b = np.asarray(b)
    return np.abs(a - b).max() / np.abs(a).max()


def _mesh_kw(n=8, mb=4, g=2, **bcs):
    return dict(nx1=n, nx2=n, nx3=n, mbnx1=mb, mbnx2=mb, mbnx3=mb,
                x1min=0.0, x1max=1.0, x2min=0.0, x2max=1.0, x3min=0.0,
                x3max=1.0, nghost=g, **bcs)


def _state(mesh, fluid, seed):
    """Random positive-pressure conserved state (numpy, f64)."""
    rng = np.random.default_rng(seed)
    nvar = 9 if fluid == "glmmhd" else 5
    w = 0.2 * rng.standard_normal((mesh.nblocks, nvar) + mesh.block_shape)
    w[:, 0] = rng.uniform(0.5, 1.5, w[:, 0].shape)
    w[:, 4] = rng.uniform(0.5, 1.5, w[:, 4].shape)
    if fluid == "glmmhd":
        w[:, 5:8] += np.array([1.0, 0.5, 0.2])[None, :, None, None, None]
    return prim_to_cons(EOS(gamma=5.0 / 3.0), torch.tensor(w),
                        fluid).numpy()


@pytest.mark.parametrize("bcs", [
    {},
    dict(ix1_bc="outflow", ox1_bc="outflow", ix3_bc="outflow"),
    dict(ix1_bc="reflecting", ox2_bc="reflecting", ox3_bc="outflow"),
], ids=["periodic", "outflow", "reflecting"])
def test_boundary_fill_matches_jax(bcs):
    kw = _mesh_kw(**bcs)
    u = _state(Mesh(**kw), "euler", seed=1)
    ref = np.asarray(j_bc(JMesh(**kw))(jnp.asarray(u)))
    got = t_bc(Mesh(**kw))(torch.tensor(u))
    np.testing.assert_array_equal(ref, got.numpy())


def test_reflecting_mhd_refused():
    with pytest.raises(ValueError, match="Reflecting"):
        check_reflecting_mhd(Mesh(**_mesh_kw(ix2_bc="reflecting")), "glmmhd")


@pytest.mark.parametrize("source", ["dedner_plain", "dedner_extended"])
def test_dedner_source_matches_jax(source):
    kw = _mesh_kw(mb=8, g=0)
    u = _state(Mesh(**kw), "glmmhd", seed=2)
    cfgs = dict(fluid="glmmhd", riemann="hlld", reconstruction="ppm",
                glmmhd_source=source)
    jpkg = JPkg(JMesh(**kw), JCfg(**cfgs), JEOS(gamma=5.0 / 3.0))
    tpkg = HydroPackage(Mesh(**kw), HydroConfig(**cfgs), EOS(gamma=5.0 / 3.0))
    _, prim = tpkg.cons_to_prim(torch.tensor(u))
    ref = jpkg._dedner_source(jnp.asarray(u), jnp.asarray(prim.numpy()),
                              jnp.asarray(0.01), jnp.asarray(1.7))
    got = tpkg._dedner_source(torch.tensor(u), prim, 0.01, 1.7)
    assert _rel(ref, got.numpy()) <= TOL


@pytest.mark.parametrize("fluid,max_dt", [("euler", -1.0), ("glmmhd", -1.0),
                                          ("glmmhd", 1e-4)])
def test_estimate_timestep_and_c_h_match_jax(fluid, max_dt):
    kw = _mesh_kw()
    riemann = "hlld" if fluid == "glmmhd" else "hllc"
    cfgs = dict(fluid=fluid, riemann=riemann, reconstruction="plm",
                max_dt=max_dt)
    jpkg = JPkg(JMesh(**kw), JCfg(**cfgs), JEOS(gamma=1.4))
    tpkg = HydroPackage(Mesh(**kw), HydroConfig(**cfgs), EOS(gamma=1.4))
    u = _state(Mesh(**kw), fluid, seed=3)
    _, jw = jpkg._cons_to_prim(jnp.asarray(u))
    _, tw = tpkg.cons_to_prim(torch.tensor(u))
    jdt, jdt_hyp, _ = jpkg._estimate_timestep(jw)
    tdt, tdt_hyp, tdt_diff = tpkg.estimate_timestep(tw)
    assert tdt == pytest.approx(float(jdt), rel=TOL)
    assert tdt_hyp == pytest.approx(float(jdt_hyp), rel=TOL)
    assert tdt_diff == float("inf")
    assert tpkg.c_h_from_dt_hyp(tdt_hyp) == pytest.approx(
        float(jpkg.c_h_from_dt_hyp(jdt_hyp)), rel=TOL)


@pytest.mark.parametrize("fluid,riemann,recon,integrator", [
    ("euler", "hllc", "plm", "rk2"),
    ("euler", "hlle", "dc", "rk1"),
    ("glmmhd", "hlle", "ppm", "rk3"),
    ("glmmhd", "llf", "plm", "vl2"),
])
def test_step_matches_jax(fluid, riemann, recon, integrator):
    """One full cycle on a ghosted 8-block layout (boundary fill included)
    for integrators and solvers the main path does not use."""
    kw = _mesh_kw(g=3, ox1_bc="outflow", ix1_bc="outflow")
    cfgs = dict(fluid=fluid, riemann=riemann, reconstruction=recon,
                integrator=integrator)
    jpkg = JPkg(JMesh(**kw), JCfg(**cfgs), JEOS(gamma=5.0 / 3.0))
    tpkg = HydroPackage(Mesh(**kw), HydroConfig(**cfgs), EOS(gamma=5.0 / 3.0))
    u = tpkg.apply_boundaries(torch.tensor(_state(Mesh(**kw), fluid, 4)))
    ref = jpkg._step(jnp.asarray(u.numpy()), jnp.asarray(2e-3),
                     jnp.asarray(1.1))
    got = tpkg.step(u, 2e-3, 1.1)
    assert _rel(ref, got.numpy()) <= TOL


def test_history_row_matches_jax(tmp_path):
    kw = _mesh_kw(g=2)
    mesh = Mesh(**kw)
    u = t_bc(mesh)(torch.tensor(_state(mesh, "glmmhd", seed=6)))
    tpkg = HydroPackage(mesh, HydroConfig(fluid="glmmhd", riemann="hlld"),
                        EOS(gamma=5.0 / 3.0))
    uf, w = tpkg.cons_to_prim(u)
    jh = JHist(str(tmp_path / "j.hst"), "glmmhd", -1.0)
    th = THist(str(tmp_path / "t.hst"), "glmmhd", -1.0)
    jh.write(0.5, 0.01, jnp.asarray(uf.numpy()), jnp.asarray(w.numpy()),
             JMesh(**kw))
    th.write(0.5, 0.01, uf, w, mesh)
    head_j, head_t = ((tmp_path / f).read_text().splitlines()[:2]
                      for f in ("j.hst", "t.hst"))
    assert head_j == head_t
    np.testing.assert_allclose(np.loadtxt(tmp_path / "t.hst"),
                               np.loadtxt(tmp_path / "j.hst"), rtol=1e-12)

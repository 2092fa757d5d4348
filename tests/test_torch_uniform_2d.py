"""Port parity on 1-D and 2-D uniform meshes: ``negdiv_plain`` with one or
two active directions against the JAX package (its XLA path in f64, and
``make_fused_negdiv_v2`` in interpret mode in f32, as
``tests/test_pallas_sweep.py`` runs it), and the Orszag-Tang and Sod decks
through both ``Simulation``s.

f64: 1e-12 relative to the largest magnitude (the same operations in the
same order, rounding only).  f32 against the Pallas kernel: 3e-3, the JAX
test's own tolerance.  Ghosted layouts are compared on interiors.
"""

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
from athenapk_tpu.solver.pallas_sweep import make_fused_negdiv_v2
from athenapk_tpu_torch.config.parameter_input import ParameterInput as TPin
from athenapk_tpu_torch.core.mesh import Mesh
from athenapk_tpu_torch.driver import Simulation as TSim
from athenapk_tpu_torch.eos.adiabatic import EOS
from athenapk_tpu_torch.solver import sweep
from athenapk_tpu_torch.solver.hydro_pkg import HydroConfig
from athenapk_tpu_torch.utils import exact_riemann
from test_sod import SOD_DECK as SOD_256

torch.set_num_threads(2)

TOL = 1e-12
# (nx1, nx2, block nx1, block nx2, nghost)
LAYOUTS = {
    "2d_ghostfree": (32, 32, 32, 32, 0),
    "2d_ghosted": (32, 32, 16, 16, 3),
    "1d_ghostfree": (64, 1, 64, 1, 0),
    "1d_ghosted": (64, 1, 32, 1, 3),
}
PAIRS = [("euler", "hllc"), ("euler", "hlle"), ("glmmhd", "hlld")]


def _mesh_kw(layout):
    nx1, nx2, mb1, mb2, g = LAYOUTS[layout]
    return dict(nx1=nx1, nx2=nx2, nx3=1, mbnx1=mb1, mbnx2=mb2, mbnx3=1,
                x1min=0.0, x1max=1.0, x2min=0.0, x2max=1.5, x3min=-0.5,
                x3max=0.5, nghost=g)


def _prim(mesh, fluid, seed):
    """Smooth primitive state in x and y, every component nonzero, plus
    seeded noise."""
    rng = np.random.default_rng(seed)
    x, y, z = mesh.cell_centers_mesh()
    tp = 2.0 * np.pi
    nvar = 9 if fluid == "glmmhd" else 5
    w = np.zeros((mesh.nblocks, nvar) + mesh.block_shape)
    w[:, 0] = 1.0 + 0.1 * np.sin(tp * x) * np.cos(tp * y) + 0.0 * z
    w[:, 1] = 0.3 + 0.2 * np.sin(tp * y) + 0.0 * x + 0.0 * z
    w[:, 2] = 0.2 + 0.1 * np.cos(tp * x) + 0.0 * y + 0.0 * z
    w[:, 3] = -0.15 + 0.1 * np.sin(tp * (x + y)) + 0.0 * z
    w[:, 4] = 0.6 + 0.05 * np.cos(tp * (x + y)) + 0.0 * z
    if nvar == 9:
        w[:, 5] = 1.0 + 0.1 * np.sin(tp * y) + 0.0 * x + 0.0 * z
        w[:, 6] = 0.5 + 0.1 * np.cos(tp * x) + 0.0 * y + 0.0 * z
        w[:, 7] = 0.1 + 0.1 * np.sin(tp * x) + 0.0 * y + 0.0 * z
        w[:, 8] = 0.01 * np.sin(tp * (x - y)) + 0.0 * z
    return w + 1e-3 * rng.standard_normal(w.shape)


def _rel(a, b):
    return np.abs(a - b).max() / np.abs(a).max()


def _jax_pkg(kw, fluid, riemann, recon):
    return JPkg(JMesh(**kw), JCfg(fluid=fluid, riemann=riemann,
                                  reconstruction=recon), JEOS(gamma=5.0 / 3.0))


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("recon", ["dc", "plm", "ppm"])
@pytest.mark.parametrize("fluid,riemann", PAIRS)
def test_negdiv_plain_matches_jax_xla(fluid, riemann, recon, layout):
    kw = _mesh_kw(layout)
    jpkg = _jax_pkg(kw, fluid, riemann, recon)
    mesh = Mesh(**kw)
    cfg = HydroConfig(fluid=fluid, riemann=riemann, reconstruction=recon)
    assert sweep.active_dirs(mesh) == ([1, 2] if mesh.nx2 > 1 else [1])
    w = _prim(mesh, fluid, seed=11)
    c_h = 1.3 if fluid == "glmmhd" else 0.0
    got = sweep.fused_negdiv(torch.tensor(w), c_h, mesh, cfg,
                             EOS(gamma=5.0 / 3.0), recon).numpy()
    ref = -np.asarray(jpkg._flux_divergence(
        jpkg._compute_fluxes(jnp.asarray(w), jnp.asarray(c_h), recon)))
    sl = mesh.interior_slices
    assert np.isfinite(got[sl]).all()
    assert _rel(ref[sl], got[sl]) <= TOL


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("fluid,riemann,recon", [
    ("glmmhd", "hlld", "ppm"), ("euler", "hllc", "ppm"),
    ("euler", "hlle", "plm")])
def test_negdiv_plain_matches_pallas_v2_interpret_f32(fluid, riemann, recon,
                                                      layout):
    """Against the TPU kernel of the 1-D/2-D path, ``make_fused_negdiv_v2``,
    run in interpret mode in f32."""
    kw = _mesh_kw(layout)
    jpkg = _jax_pkg(kw, fluid, riemann, recon)
    mesh = Mesh(**kw)
    cfg = HydroConfig(fluid=fluid, riemann=riemann, reconstruction=recon)
    w = _prim(mesh, fluid, seed=12).astype(np.float32)
    c_h = 1.3 if fluid == "glmmhd" else 0.0
    fused = make_fused_negdiv_v2(jpkg.mesh, jpkg.cfg, jpkg.eos,
                                 jpkg._positivity_mask, recon, tz=8, ty=8,
                                 interpret=True)
    ref = np.asarray(fused(jnp.asarray(w), jnp.float32(c_h)))
    got = sweep.negdiv_plain(torch.tensor(w), c_h, mesh, cfg,
                             EOS(gamma=5.0 / 3.0), recon)
    assert got.dtype == torch.float32
    sl = mesh.interior_slices
    assert _rel(ref[sl], got.numpy()[sl]) <= 3e-3


# ----------------------------------------------------------- slice as a whole
OT_DECK = """
<job>
problem_id = orszag_tang
<parthenon/mesh>
nghost = 3
merge_blocks = {merge}
nx1 = 32
x1min = 0.0
x1max = 1.0
nx2 = 32
x2min = 0.0
x2max = 1.0
nx3 = 1
x3min = -0.5
x3max = 0.5
<parthenon/meshblock>
nx1 = 16
nx2 = 16
<parthenon/time>
integrator = vl2
cfl = 0.3
tlim = 0.5
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

SOD_DECK = """
<job>
problem_id = sod
<parthenon/mesh>
nghost = 2
merge_blocks = false
nx1 = 64
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
<parthenon/meshblock>
nx1 = {mb}
<parthenon/time>
integrator = vl2
cfl = 0.3
tlim = {tlim}
nlim = {nlim}
ncycle_out = 0
<hydro>
fluid = euler
eos = adiabatic
riemann = hllc
reconstruction = plm
gamma = 1.4
<parthenon/output1>
file_type = hst
"""


def _run_in(path, sim):
    os.makedirs(path, exist_ok=True)
    cwd = os.getcwd()
    os.chdir(path)
    try:
        return sim.run()
    finally:
        os.chdir(cwd)


def _both(deck, tmp_path, pid, noise=0.0):
    """The deck for 5 cycles through both packages from one initial state
    (the JAX one, times ``1 + noise * N(0, 1)`` from a seed): state to 1e-10
    of its largest magnitude, and the time and dt columns of the history."""
    js = JSim(JPin.from_string(deck), quiet=True)
    ts = TSim(TPin.from_string(deck), quiet=True, device="cpu")
    assert ts.mesh.nblocks == js.mesh.nblocks
    assert ts.mesh.nghost == js.mesh.nghost
    u = np.asarray(js.u)
    if noise:
        rng = np.random.default_rng(21)
        u = np.asarray(js.pkg.apply_boundaries(jnp.asarray(
            u * (1.0 + noise * rng.standard_normal(u.shape)))))
        js.u = jnp.asarray(u)
    ts.load_state(u, js.t, js.ncycle)
    _run_in(tmp_path / "jax", js)
    _run_in(tmp_path / "torch", ts)
    a, b = np.asarray(js.u), ts.u.numpy()
    assert ts.ncycle == js.ncycle == 5
    assert np.isfinite(b).all()
    assert np.abs(a - b).max() <= 1e-10 * np.abs(a).max()
    assert ts.t == pytest.approx(js.t, rel=1e-10)
    hj = np.loadtxt(tmp_path / "jax" / f"{pid}.out1.hst")
    ht = np.loadtxt(tmp_path / "torch" / f"{pid}.out1.hst")
    np.testing.assert_allclose(ht[:, :3], hj[:, :3], rtol=1e-10)
    return js, ts, u


@pytest.mark.parametrize("merge", ["true", "false"],
                         ids=["merged_ghostfree", "ghosted_4_blocks"])
def test_orszag_tang_matches_jax(merge, tmp_path):
    """The vortex's initial state is exactly symmetric, which puts faces on
    the ties of the solver's selects (a normal field of +-1e-17 picks the
    Alfven rotation's sign): there the JAX package's compiled step and its
    own stage-by-stage composition already differ by 1e-7, from rounding
    alone.  Seeded noise of 1e-3 takes the state off the ties; the port
    then follows the JAX step to rounding."""
    deck = OT_DECK.format(merge=merge)
    js, ts, u_start = _both(deck, tmp_path, "orszag_tang", noise=1e-3)
    assert ts.mesh.nghost == (0 if merge == "true" else 3)
    # total mass of the periodic box is conserved
    sl = ts.mesh.interior_slices
    np.testing.assert_allclose(ts.cons()[sl][:, 0].mean(),
                               u_start[sl][:, 0].mean(), rtol=1e-12)


@pytest.mark.parametrize("mb", [64, 32], ids=["one_block", "two_blocks"])
def test_sod_matches_jax(mb, tmp_path):
    js, ts, _ = _both(SOD_DECK.format(mb=mb, tlim=0.25, nlim=5), tmp_path, "sod")
    assert ts.mesh.nghost == 2 and ts.mesh.nblocks == 64 // mb


def test_sod_converges_to_the_exact_solution(tmp_path):
    """Sod to t = 0.25 at 64 cells (HLLC + PLM + VL2): the L1 density error
    against the exact Riemann solution is that of a second-order scheme on
    a shock tube at this resolution."""
    sim = TSim(TPin.from_string(SOD_DECK.format(mb=64, tlim=0.25, nlim=-1)),
               quiet=True, device="cpu")
    _run_in(tmp_path, sim)
    assert sim.t == pytest.approx(0.25)
    mesh = sim.mesh
    x = mesh.cell_centers_mesh()[0].reshape(-1)
    sl = mesh.interior_slices
    rho = sim.cons()[sl][0, 0, 0, 0]
    g = mesh.nghost
    xi = (x[g:-g] - 0.5) / sim.t
    rho_exact, _, _ = exact_riemann.sample(xi, 1.0, 0.0, 1.0, 0.125, 0.0, 0.1,
                                           1.4)
    l1 = np.abs(rho - rho_exact).mean()
    assert l1 < 1.2e-2, f"Sod L1(rho) {l1:.3e}"


@pytest.mark.parametrize("riemann,recon,integ,tol", [
    ("llf", "plm", "rk2", 0.02),
    ("hllc", "weno3", "rk2", 0.012),
    ("hllc", "limo3", "rk2", 0.012),
    ("hllc", "wenoz", "rk3", 0.012),
])
def test_sod_shock_tube_port(riemann, recon, integ, tol, tmp_path):
    """Twins of ``tests/test_sod.py::test_sod_shock_tube``'s rows that the
    port's kernels took up (LLF, WENO3, LimO3, WENO-Z): the JAX test's deck
    (256 cells in 4 blocks, nghost 3) to t = 0.25 on the port, the L2
    density error against the exact solution under the JAX test's bound;
    and its first 5 cycles against the JAX package's from one state, to
    1e-12 of the state's largest magnitude."""
    over = [f"hydro/riemann={riemann}", f"hydro/reconstruction={recon}",
            f"parthenon/time/integrator={integ}"]
    sim = TSim(TPin.from_string(SOD_256, over), quiet=True,
               device="cpu").run()
    assert sim.t == pytest.approx(0.25)
    mesh = sim.mesh
    g = mesh.nghost
    rho = sim.cons()[:, 0, 0, 0, g:-g].reshape(-1)
    x = mesh.cell_centers()[0][:, g:-g].reshape(-1)
    order = np.argsort(x)
    xi = (x[order] - 0.5) / sim.t
    rho_exact, _, _ = exact_riemann.sample(xi, 1.0, 0.0, 1.0, 0.125, 0.0, 0.1,
                                           1.4)
    err = np.sqrt(np.mean((rho[order] - rho_exact) ** 2))
    assert err < tol, f"L2 rho error {err} exceeds {tol}"

    over += ["parthenon/time/nlim=5", "parthenon/mesh/merge_blocks=false"]
    js = JSim(JPin.from_string(SOD_256, over), quiet=True)
    ts = TSim(TPin.from_string(SOD_256, over), quiet=True, device="cpu")
    ts.load_state(np.asarray(js.u), js.t, js.ncycle)
    js.run()
    ts.run()
    a, b = np.asarray(js.u), ts.u.numpy()
    assert ts.ncycle == js.ncycle == 5
    assert np.abs(a - b).max() <= 1e-12 * np.abs(a).max()

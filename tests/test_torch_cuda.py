"""The sweep kernel on the card: ``negdiv_cuda`` against ``negdiv_plain``.

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

from athenapk_tpu_torch.config.parameter_input import ParameterInput
from athenapk_tpu_torch.core.mesh import Mesh
from athenapk_tpu_torch.driver import Simulation
from athenapk_tpu_torch.eos.adiabatic import EOS
from athenapk_tpu_torch.solver import sweep
from athenapk_tpu_torch.solver.hydro_pkg import HydroConfig

pytestmark = pytest.mark.cuda

C_H = 1.3
LAYOUTS = {"ghostfree": (32, 32, 0), "ghosted": (32, 16, 3)}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the sweep kernel has no CPU mode")
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
    # the same operations without FMA contraction: rounding only (the
    # kernel folds scalar constants in double), amplified by -div(F)'s
    # difference of neighbouring fluxes; chip_smoke.py's f32 cases reach
    # at most 1.4e-5 per variable
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
    llf = HydroConfig(fluid="glmmhd", riemann="llf", reconstruction="ppm")
    with pytest.raises(NotImplementedError):
        sweep.fused_negdiv(prim, C_H, mesh, llf, eos, "ppm")


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

"""The cooling kernels (``srcterms.tabular_cooling_cuda``, source
``csrc/tabular_cooling.cu``).

On the card (marked ``cuda``, skipped elsewhere: the kernels have no CPU
mode): the in-place Townsend update against the plain update
(``TabularCooling.cool_plain``) and ``apply``, and the dt against the plain
minimum (``cooling_dt_plain``) and ``estimate_timestep``, each plain version
run on the same card, bit for bit; in f64 and f32, Euler and GLM-MHD with 0
and 1 scalars, ghosted and ghost-free states, ``Tfloor`` on and off, on
states whose cells lie below and above the table, exactly on each
temperature edge and (with dt = 0) on each Y_k value, with e <= 0 and with
NaN; and the launch counters, 2 updates and 1 dt a cluster cycle.

On the CPU: the dispatchers hand a CPU tensor to the plain code, the
wrappers refuse a CPU tensor before they build anything, the in-place entry
returns its input changed in the energy row alone with ``apply``'s
numbers, ``apply`` leaves its input as it was, and the benchmark reads the
kernels as the cooling's layer: their names lie outside
``benchmark.harness.trace.CSRC_KERNEL`` and their counters outside
``benchmark.harness.cell.csrc_launches``.

The file imports neither jax nor the JAX package; on the card:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_cooling_kernel.py
"""

import math
import re
import zlib

import numpy as np
import pytest
import torch

from athenapk_tpu_torch.config.parameter_input import ParameterInput
from athenapk_tpu_torch.core.indices import IEN
from athenapk_tpu_torch.core.mesh import Mesh
from athenapk_tpu_torch.driver import Simulation, make_cooling
from athenapk_tpu_torch.srcterms import tabular_cooling_cuda as tcc
from benchmark.harness.cell import csrc_launches
from benchmark.harness.trace import CSRC_KERNEL, short_name
from torch_decks import cluster_deck, write_cluster_table, write_cooling_table

GAMMA = 5.0 / 3.0

# Code units of the proton mass and the centimetre-second: every constant
# of the cooling (~1e-9 to ~1e8) and the energies lie inside float32.
COOLING_DECK = """
<hydro>
gamma = {gamma}
He_mass_fraction = 0.25
Tfloor = {tfloor}

<units>
code_length_cgs = 1.0
code_mass_cgs = 1.6726e-24
code_time_cgs = 1.0

<cooling>
enable_cooling = tabular
table_filename = {table}
lambda_units_cgs = 1.0
integrator = {integrator}
cfl = 0.1
"""

# (nx, ny, nz, nghost) of the state's blocks: ghost-free 7 x 5 x 5, an odd
# cell count (no 16-byte rows); ghosted 8 x 6 x 5 inside 12 x 10 x 9
LAYOUTS = {"ghostfree": (7, 5, 5, 0), "ghosted": (8, 6, 5, 2)}
FLUIDS = [("euler", 0), ("glmmhd", 0), ("glmmhd", 1)]


def write_curved_table(path):
    """A table whose slope changes sign (alpha_k from about -1.3 to 1.4,
    never 1): the searches land on different bins over the range."""
    log_t = np.linspace(4.0, 8.0, 41)
    log_l = -22.0 + 0.7 * np.sin(2.0 * log_t) + 0.05 * log_t
    with open(path, "w") as fh:
        fh.write("# logT logLambda\n")
        for a, b in zip(log_t, log_l):
            fh.write(f"{a} {b}\n")
    return str(path)


TABLES = {"powerlaw": write_cooling_table, "curved": write_curved_table}


def make_cooler(tmp_path, table="powerlaw", tfloor=-1.0,
                integrator="townsend"):
    path = TABLES[table](tmp_path / f"{table}.cool")
    return make_cooling(ParameterInput.from_string(COOLING_DECK.format(
        gamma=GAMMA, tfloor=tfloor, table=path, integrator=integrator)))


def mesh_of(layout):
    nx, ny, nz, g = LAYOUTS[layout]
    return Mesh(nx1=nx, nx2=ny, nx3=nz, mbnx1=nx, mbnx2=ny, mbnx3=nz,
                x1min=0.0, x1max=1.0, x2min=0.0, x2max=1.0, x3min=0.0,
                x3max=1.0, nghost=g)


def edge_energies(tc, dtype):
    """Specific energies whose temperature, e * mbar_gm1_over_kb in the
    dtype, equals each table temperature exactly (the edges of the bins);
    an edge no nearby energy reaches is left out."""
    np_t = np.float32 if dtype == torch.float32 else np.float64
    mgk = np_t(tc.mbar_gm1_over_kb)
    out = []
    for t in tc._np["temps"].astype(np_t):
        e = np_t(t / mgk)
        for _ in range(8):
            if e * mgk == t:
                out.append(e)
                break
            e = np.nextafter(e, np_t(np.inf) if e * mgk < t else np_t(0))
    return np.asarray(out, dtype=np.float64)


def cooling_state(tc, mesh, fluid, nscalars, seed, dtype):
    """A conserved state ``[2, nvar, NZ, NY, NX]`` whose gas spans 1e2-1e10
    K (below and above the table's 1e4-1e8) at densities 0.1-10, moving and
    magnetised; on top, cells with rho = 1 at rest without field whose
    specific energy puts them exactly on each table temperature, and cells
    with e = 0, e < 0, E = NaN and rho = NaN."""
    rng = np.random.default_rng(seed)
    nvar = (9 if fluid == "glmmhd" else 5) + nscalars
    shape = (2,) + mesh.block_shape
    rho = 10.0 ** rng.uniform(-1.0, 1.0, shape)
    e = 10.0 ** rng.uniform(2.0, 10.0, shape) / tc.mbar_gm1_over_kb
    u = np.zeros((2, nvar) + mesh.block_shape)
    u[:, 0] = rho
    v = 1e-3 * np.sqrt(e)[:, None] * rng.standard_normal((2, 3) + shape[1:])
    u[:, 1:4] = rho[:, None] * v
    u[:, 4] = rho * e + 0.5 * (u[:, 1:4] ** 2).sum(axis=1) / rho
    if fluid == "glmmhd":
        u[:, 5:8] = 1e-2 * np.sqrt(rho * e)[:, None] \
            * rng.standard_normal((2, 3) + shape[1:])
        u[:, 4] += 0.5 * (u[:, 5:8] ** 2).sum(axis=1)
        u[:, 8] = rng.standard_normal(shape)
    if nscalars:
        u[:, nvar - nscalars:] = rng.uniform(0.0, 1.0,
                                             (2, nscalars) + shape[1:])
    flat = u.reshape(2, nvar, -1)
    special = list(edge_energies(tc, dtype)) + [0.0, -1e6, math.nan]
    cells = rng.choice(flat.shape[2], size=len(special) + 1, replace=False)
    for k, es in zip(cells, special):
        b = k % 2
        flat[b, :, k] = 0.0
        flat[b, 0, k] = 1.0
        flat[b, 4, k] = es
    flat[1, 0, cells[-1]] = math.nan
    return torch.tensor(u, dtype=dtype)


def prim_of(u):
    """Primitives of ``cooling_state``'s cells for the dt: rho, v = 0 and
    the pressure of the state's specific internal energy, |e|."""
    w = u.clone()
    w[:, 1:4] = 0.0
    e = (u[:, 4] - 0.5 * (u[:, 1:4] ** 2).sum(dim=1) / u[:, 0]) / u[:, 0]
    w[:, 4] = (GAMMA - 1.0) * u[:, 0] * e.abs()
    return w


def same_bits(a, b):
    """Equal bit for bit where a number, NaN where the other is NaN."""
    nan = torch.isnan(a)
    if not torch.equal(nan, torch.isnan(b)):
        return False
    bits = torch.int32 if a.dtype == torch.float32 else torch.int64
    return torch.equal(a[~nan].view(bits), b[~nan].view(bits))


def _no_kernel(*args, **kwargs):
    raise AssertionError("the CUDA path was taken")


# ------------------------------------------------------------------ the card
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


DTYPES = [torch.float64, torch.float32]


@pytest.mark.cuda
@pytest.mark.parametrize("table", sorted(TABLES))
@pytest.mark.parametrize("tfloor", [-1.0, 2.0e5])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("fluid,nscalars", FLUIDS)
@pytest.mark.parametrize("dtype", DTYPES, ids=["f64", "f32"])
def test_townsend_kernel_matches_plain(card, tmp_path, dtype, fluid,
                                       nscalars, layout, tfloor, table):
    tc = make_cooler(tmp_path, table, tfloor)
    seed = zlib.crc32(f"{fluid}/{nscalars}/{layout}/{table}".encode())
    u = cooling_state(tc, mesh_of(layout), fluid, nscalars, seed,
                      dtype).to(card)
    # dt = 0 puts every edge cell's tef_adj exactly on a Y_k value; the
    # others cool part of the way, through several bins and to the floor
    for dt in (0.0, 3.0e9, 3.0e12, 1.0e15):
        before = tcc.townsend_cuda.launches
        got = u.clone()
        out = tc.apply_in_place(got, dt, fluid)
        ref = tc.cool_plain(u.clone(), dt, fluid)
        torch.cuda.synchronize()
        assert out is got
        assert tcc.townsend_cuda.launches == before + 1
        assert same_bits(got, ref), f"dt {dt}"
        rows = [v for v in range(u.shape[1]) if v != IEN]
        assert same_bits(got[:, rows], u[:, rows])
        # apply: a copy through the kernel, its input untouched
        kept = u.clone()
        assert same_bits(tc.apply(u, dt, fluid), ref)
        assert same_bits(u, kept)
    # the cooling changed energies and left the NaN cells NaN
    assert (got[:, IEN] != u[:, IEN]).sum() > 10
    assert torch.isnan(got[:, IEN]).sum() == 2


@pytest.mark.cuda
@pytest.mark.parametrize("table", sorted(TABLES))
@pytest.mark.parametrize("tfloor", [-1.0, 2.0e5])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("dtype", DTYPES, ids=["f64", "f32"])
def test_cooling_dt_kernel_matches_plain(card, tmp_path, dtype, layout,
                                         tfloor, table):
    tc = make_cooler(tmp_path, table, tfloor)
    mesh = mesh_of(layout)
    seed = zlib.crc32(f"dt/{layout}/{table}".encode())
    prim = prim_of(cooling_state(tc, mesh, "glmmhd", 1, seed, dtype)).to(
        card)
    for w in (prim, prim[:, :5].contiguous()):
        before = tcc.cooling_dt_cuda.launches
        got = tc.estimate_timestep(w, mesh)
        ref = tc.cooling_dt_plain(w, mesh)
        torch.cuda.synchronize()
        assert tcc.cooling_dt_cuda.launches == before + 1
        assert got.shape == () and got.dtype == dtype and got.is_cuda
        assert same_bits(got, ref) and math.isfinite(float(got))
    # a cell at infinite pressure makes the plain minimum NaN; one with
    # every cell below the table makes it inf
    bad = prim.clone()
    bad[mesh.interior_slices][0, 4, -1, -1, -1] = math.inf
    hot = tc.cooling_dt_plain(bad, mesh)
    assert same_bits(tcc.cooling_dt_cuda(tc, bad, mesh), hot)
    cold = prim.clone()
    cold[:, 4] = 1e-30
    ref = tc.cooling_dt_plain(cold, mesh)
    assert same_bits(tcc.cooling_dt_cuda(tc, cold, mesh), ref)
    assert float(ref) == math.inf


@pytest.mark.cuda
def test_wrappers_refuse_what_the_kernels_do_not_take(card, tmp_path):
    tc = make_cooler(tmp_path)
    mesh = mesh_of("ghosted")
    u = cooling_state(tc, mesh, "glmmhd", 0, 3, torch.float64).to(card)
    with pytest.raises(TypeError, match="float32 or float64"):
        tcc.townsend_cuda(tc, u.half(), 1e12, "glmmhd")
    with pytest.raises(ValueError, match="contiguous"):
        tcc.townsend_cuda(tc, u.transpose(2, 4), 1e12, "glmmhd")
    with pytest.raises(ValueError, match="nvar"):
        tcc.townsend_cuda(tc, u[:, :5].contiguous(), 1e12, "glmmhd")
    with pytest.raises(ValueError, match="nvar"):
        tcc.cooling_dt_cuda(tc, u[:, :4], mesh)
    with pytest.raises(TypeError, match="float"):
        tcc.townsend_cuda(tc, u, torch.tensor(1e12, device=card), "glmmhd")
    rk = make_cooler(tmp_path, integrator="rk12")
    with pytest.raises(ValueError, match="integrator"):
        tcc.townsend_cuda(rk, u, 1e12, "glmmhd")


@pytest.mark.cuda
def test_cluster_cycle_launches_two_updates_and_one_dt(card, tmp_path):
    """The cluster deck on the card: each cycle's two VL2 stages take one
    update each and its dt one dt launch, and the run's initial dt one
    more."""
    table = write_cluster_table(tmp_path / "cluster.cool")
    ncycles = 3
    sim = Simulation(ParameterInput.from_string(cluster_deck(
        n=16, half=0.02, nlim=ncycles, table=table)), quiet=True,
        device="cuda")
    n_up, n_dt = tcc.townsend_cuda.launches, tcc.cooling_dt_cuda.launches
    sim.run()
    assert sim.ncycle == ncycles and sim.u.is_cuda
    assert tcc.townsend_cuda.launches - n_up == 2 * ncycles
    assert tcc.cooling_dt_cuda.launches - n_dt == ncycles + 1
    assert bool(torch.isfinite(sim.u).all())


# ------------------------------------------------------------------ the CPU
@pytest.mark.parametrize("fluid,nscalars", FLUIDS)
def test_dispatchers_take_the_plain_code_on_the_cpu(tmp_path, monkeypatch,
                                                    fluid, nscalars):
    monkeypatch.setattr(tcc, "townsend_cuda", _no_kernel)
    monkeypatch.setattr(tcc, "cooling_dt_cuda", _no_kernel)
    tc = make_cooler(tmp_path, "curved", 2.0e5)
    mesh = mesh_of("ghosted")
    u = cooling_state(tc, mesh, fluid, nscalars, 5, torch.float64)
    # the plain update as it was written before the in-place entry
    e0, rho = tc._internal_e(u, fluid == "glmmhd")
    want = u.clone()
    want[:, IEN] = u[:, IEN] + rho * (tc._townsend(e0, rho, 3.0e12) - e0)
    got = tc.apply_in_place(u.clone(), 3.0e12, fluid)
    assert same_bits(got, want)
    prim = prim_of(u)
    assert same_bits(tc.estimate_timestep(prim, mesh),
                     tc.cooling_dt_plain(prim, mesh))


def test_wrappers_refuse_a_cpu_tensor_before_building(tmp_path, monkeypatch):
    monkeypatch.setattr(tcc, "_library", _no_kernel)
    tc = make_cooler(tmp_path)
    mesh = mesh_of("ghostfree")
    u = cooling_state(tc, mesh, "euler", 0, 1, torch.float64)
    counts = (tcc.townsend_cuda.launches, tcc.cooling_dt_cuda.launches)
    with pytest.raises(ValueError, match="CUDA"):
        tcc.townsend_cuda(tc, u, 1e12, "euler")
    with pytest.raises(ValueError, match="CUDA"):
        tcc.cooling_dt_cuda(tc, prim_of(u), mesh)
    assert (tcc.townsend_cuda.launches, tcc.cooling_dt_cuda.launches) \
        == counts


@pytest.mark.parametrize("integrator", ["townsend", "rk12"])
def test_in_place_entry_changes_the_energy_row_alone(tmp_path, integrator):
    tc = make_cooler(tmp_path, integrator=integrator)
    u = cooling_state(tc, mesh_of("ghosted"), "glmmhd", 1, 7, torch.float64)
    kept = u.clone()
    want = tc.apply(u, 3.0e12, "glmmhd")
    # apply leaves its input untouched
    assert same_bits(u, kept)
    got = tc.apply_in_place(u, 3.0e12, "glmmhd")
    assert got is u
    assert same_bits(got, want)
    rows = [v for v in range(u.shape[1]) if v != IEN]
    assert same_bits(got[:, rows], kept[:, rows])
    assert (got[:, IEN] != kept[:, IEN]).sum() > 10


def test_kernel_names_and_counters_lie_outside_the_csrc_readers(
        monkeypatch):
    src = tcc.CSRC.read_text()
    names = re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)"
                       r"\s*)?(\w+)\s*\(", src)
    assert names == ["townsend_cool_kernel", "cooling_dt_kernel",
                     "cooling_dt_min_kernel"]
    traced = ("void cooling::townsend_cool_kernel<double, true, 2>(double*, "
              "cooling::Tables<double>, cooling::Consts<double>, int, int, "
              "int, long long)")
    for name in names + [traced, short_name(traced)]:
        assert not CSRC_KERNEL.search(name)
    before = csrc_launches()
    monkeypatch.setattr(tcc.townsend_cuda, "launches",
                        tcc.townsend_cuda.launches + 5)
    monkeypatch.setattr(tcc.cooling_dt_cuda, "launches",
                        tcc.cooling_dt_cuda.launches + 3)
    assert csrc_launches() == before

"""Decks of the ported problem generators, shared by the CPU parity tests
(``test_torch_pgens.py``) and the card tests (``test_torch_cuda.py``), and
the EOS's drawn states (``eos_cons``, ``EOS_LIMITS``).  Imports nothing of
jax, so it loads where only the port is installed."""

import numpy as np

BASE = """
<job>
problem_id = {pid}

<parthenon/mesh>
nghost = {nghost}
merge_blocks = {merge}
nx1 = {nx1}
x1min = {x1min}
x1max = {x1max}
nx2 = {nx2}
x2min = {x2min}
x2max = {x2max}
nx3 = {nx3}
x3min = -0.5
x3max = 0.5
ix1_bc = {bc}
ox1_bc = {bc}
ix2_bc = {bc2}
ox2_bc = {bc2}
ix3_bc = {bc3}
ox3_bc = {bc3}

<parthenon/meshblock>
nx1 = {mbx}
nx2 = {mby}
nx3 = {mbz}

<parthenon/time>
integrator = {integ}
cfl = 0.3
tlim = {tlim}
nlim = {nlim}
ncycle_out = 0

<hydro>
fluid = {fluid}
eos = adiabatic
riemann = {riemann}
reconstruction = {recon}
gamma = 1.666666666666667
{extra_hydro}
{extra}
"""


def deck(pid, fluid="euler", riemann="hlle", recon="plm", integ="vl2",
          nx=(32, 32, 1), mb=None, dom=((-0.5, 0.5), (-0.5, 0.5)), tlim=0.1,
          nlim=5, extra="", extra_hydro="", nghost=2, bc="periodic",
          merge="false"):
    mb = mb or tuple(max(n // 2, 1) for n in nx)
    per = lambda n: bc if n > 1 else "periodic"   # noqa: E731
    return BASE.format(
        pid=pid, fluid=fluid, riemann=riemann, recon=recon, integ=integ,
        nx1=nx[0], nx2=nx[1], nx3=nx[2], mbx=mb[0], mby=mb[1], mbz=mb[2],
        x1min=dom[0][0], x1max=dom[0][1], x2min=dom[1][0], x2max=dom[1][1],
        tlim=tlim, nlim=nlim, extra=extra, extra_hydro=extra_hydro,
        nghost=nghost, bc=bc, bc2=per(nx[1]), bc3=per(nx[2]), merge=merge)


KH = "<problem/kh>\niprob = {}\namp = 0.01\nvflow = 1.0\n"
LOOP = "<problem/field_loop>\nrad = 0.3\namp = 1e-3\nvflow = 1.0\niprob = {}\n"
BLAST = ("<problem/blast>\nradius_outer = 0.1\nradius_inner = 0.05\n"
         "pressure_ratio = 100.0\n")
CPAW = ("<problem/cpaw>\nb_par = 1.0\nb_perp = 0.1\npres = 0.1\nv_par = 0.0\n"
        "dir = 1\ncompute_error = true\n")
ADVECT = ("<problem/advection>\nvx = 1.0\nvy = 0.5\nrho_ratio = 2.0\n"
          "rho_radius = 0.2\n")

CASES = {
    "sod_1d": dict(pid="sod", riemann="hllc", nx=(64, 1, 1), bc="outflow",
                   dom=((0.0, 1.0), (-0.5, 0.5))),
    "sod_1d_shifted": dict(
        pid="sod", riemann="hllc", nx=(64, 1, 1), bc="outflow",
        dom=((0.0, 1.0), (-0.5, 0.5)),
        extra="<problem/sod>\nrho_l = 2.0\nu_l = 0.3\nu_r = -0.2\n"
              "pres_r = 0.25\nx_discont = 0.4\n"),
    "sod_glmmhd": dict(pid="sod", fluid="glmmhd", riemann="hlld",
                       nx=(32, 1, 1), bc="outflow",
                       dom=((0.0, 1.0), (-0.5, 0.5))),
    "orszag_tang": dict(pid="orszag_tang", fluid="glmmhd", riemann="hlld",
                        recon="ppm", nghost=3,
                        dom=((0.0, 1.0), (0.0, 1.0))),
    "blast_2d": dict(pid="blast", riemann="hllc", extra=BLAST),
    "blast_3d_mhd": dict(pid="blast", fluid="glmmhd", riemann="hlld",
                         nx=(16, 16, 16), extra=BLAST + "b0 = 0.5\n"),
    "blast_3d_euler": dict(pid="blast", riemann="hllc", recon="ppm", nghost=3,
                           nx=(16, 16, 16), extra=BLAST),
    "lw_implode": dict(
        pid="lw_implode", riemann="hllc", bc="reflecting",
        dom=((0.0, 0.25), (0.0, 0.25)),
        extra="<problem/lw_implode>\nd_in = 0.125\np_in = 0.14\n"
              "d_out = 1.0\np_out = 1.0\n"),
    "field_loop_1": dict(pid="field_loop", fluid="glmmhd", riemann="hlle",
                         nx=(32, 16, 1), dom=((-1.0, 1.0), (-0.5, 0.5)),
                         extra=LOOP.format(1)),
    "field_loop_2": dict(pid="field_loop", fluid="glmmhd", riemann="hlld",
                         nx=(16, 16, 16), extra=LOOP.format(2)),
    "field_loop_3": dict(pid="field_loop", fluid="glmmhd", riemann="hlld",
                         nx=(16, 16, 16), extra=LOOP.format(3)),
    "field_loop_4": dict(pid="field_loop", fluid="glmmhd", riemann="hlld",
                         nx=(16, 16, 16), extra=LOOP.format(4)),
    "field_loop_5": dict(pid="field_loop", fluid="glmmhd", riemann="hlld",
                         nx=(16, 16, 16), extra=LOOP.format(5)),
    "cpaw_1d": dict(pid="cpaw", fluid="glmmhd", riemann="hlld",
                    nx=(32, 1, 1), dom=((0.0, 1.0), (-0.5, 0.5)),
                    extra=CPAW),
    "cpaw_3d": dict(pid="cpaw", fluid="glmmhd", riemann="hlld", recon="ppm",
                    nghost=3, nx=(16, 8, 8), dom=((0.0, 3.0), (0.0, 1.5)),
                    tlim=1.0, extra=CPAW),
    "wave_3d_hlle": dict(
        pid="linear_wave", riemann="hlle", nx=(32, 16, 16),
        dom=((0.0, 3.0), (0.0, 1.5)),
        extra="<problem/linear_wave>\nwave_flag = 0\namp = 1.0e-6\n"
              "vflow = 0.0\n"),
    "kh_2": dict(pid="kh", riemann="hllc", extra=KH.format(2)),
    "kh_3": dict(pid="kh", riemann="hllc", nx=(16, 32, 1),
                 dom=((-0.5, 0.5), (-1.0, 1.0)), extra=KH.format(3)),
    "kh_4": dict(pid="kh", riemann="hllc", nx=(16, 32, 1),
                 dom=((-0.5, 0.5), (-1.0, 1.0)),
                 extra=KH.format(4) + "vboost = 0.1\ndrho_rho0 = 0.5\n"),
    "kh_5": dict(pid="kh", riemann="hllc",
                 extra=KH.format(5) + "a = 0.05\nsigma = 0.2\ndrat = 2.0\n"),
    "advection": dict(pid="advection", riemann="hllc", recon="ppm",
                      integ="rk3", nghost=3, tlim=0.5, extra=ADVECT),
    "advection_scalar": dict(pid="advection", riemann="hllc", extra=ADVECT,
                             extra_hydro="nscalars = 1"),
    "advection_mhd": dict(pid="advection", fluid="glmmhd", riemann="hlld",
                          extra=ADVECT),
}


# --------------------------------------------------------------- refined meshes
# The refined-mesh throughput deck of ``bench.py:run_bench_smr``
# (``bench.py:168-221``): a level-1 region at the centre of an n^3 base,
# Euler + HLLE + PLM + VL2, nghost 2, f32 there.
SMR_3D = """
<job>
problem_id = blast

<parthenon/mesh>
refinement = static
numlevel = 2
nghost = 2
nx1 = {n}
x1min = -0.5
x1max = 0.5
nx2 = {n}
x2min = -0.5
x2max = 0.5
nx3 = {n}
x3min = -0.5
x3max = 0.5

<parthenon/static_refinement0>
x1min = -0.25
x1max = 0.25
x2min = -0.25
x2max = 0.25
x3min = -0.25
x3max = 0.25
level = 1

<parthenon/meshblock>
nx1 = {mb}
nx2 = {mb}
nx3 = {mb}

<parthenon/time>
integrator = vl2
cfl = 0.3
tlim = 100.0
nlim = {nlim}
ncycle_out = 0

<hydro>
fluid = euler
eos = adiabatic
riemann = hlle
reconstruction = plm
gamma = 1.666666666666667
precision = {precision}

<problem/blast>
pressure_ambient = 0.001
pressure_ratio = 1.6e4
radius_outer = 0.12
density_ambient = 1.0
density_ratio = 1.0
"""

# The 2-D refined blast of ``tests/test_smr_2d.py:29-70`` with the problem
# of ``:293-302``: Euler + HLLC + PLM + VL2, nghost 2, gamma 1.4, a level-1
# region at the centre of an n^2 base.
SMR_2D = """
<job>
problem_id = blast

<problem/blast>
pressure_ratio = 100.0
radius_outer = 0.15

<parthenon/mesh>
refinement = static
numlevel = 2
nghost = 2
nx1 = {n}
x1min = -0.5
x1max = 0.5
nx2 = {n}
x2min = -0.5
x2max = 0.5
nx3 = 1
x3min = -0.5
x3max = 0.5

<parthenon/static_refinement0>
x1min = -0.25
x1max = 0.25
x2min = -0.25
x2max = 0.25
x3min = -0.5
x3max = 0.5
level = 1

<parthenon/meshblock>
nx1 = {mb}
nx2 = {mb}
nx3 = 1

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
precision = {precision}
"""

# 1-D Sod on a refined mesh (``tests/test_smr_2d.py:216-270``)
SMR_1D = """
<job>
problem_id = sod

<problem/sod>
rho_l = 1.0
pres_l = 1.0
u_l = 0.0
rho_r = 0.125
pres_r = 0.1
u_r = 0.0
x_discont = 0.5

<parthenon/mesh>
refinement = static
numlevel = 2
nghost = 2
nx1 = {n}
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

<parthenon/static_refinement0>
x1min = 0.3
x1max = 0.8
x2min = -0.5
x2max = 0.5
x3min = -0.5
x3max = 0.5
level = 1

<parthenon/meshblock>
nx1 = {mb}
nx2 = 1
nx3 = 1

<parthenon/time>
integrator = vl2
cfl = 0.4
tlim = 0.2
nlim = {nlim}
ncycle_out = 0

<hydro>
fluid = euler
eos = adiabatic
riemann = hllc
reconstruction = plm
gamma = 1.4
"""

HST_BLOCK = "\n<parthenon/output0>\nfile_type = hst\n"


def symmetry_noise(state, seed):
    """``{level: array}`` times (1 + 1e-3 noise), plus 1e-3 noise on the
    momenta, made with numpy from ``seed``.  The blast decks are exactly
    symmetric with zero velocity, which puts the solvers' selects on ties
    where rounding alone decides (the JAX package's compiled and eager
    steps already differ there); the noise takes the state off them."""
    rng = np.random.default_rng(seed)
    out = {}
    for lev in sorted(state):
        v = np.asarray(state[lev]) * (
            1.0 + 1e-3 * rng.standard_normal(np.shape(state[lev])))
        v[:, 1:4] += 1e-3 * rng.standard_normal(v[:, 1:4].shape)
        out[lev] = v
    return out


def density_scaled_noise(state, seed):
    """``symmetry_noise`` for states with near-vacuum regions: the same
    1e-3 relative noise, and momentum noise of 1e-3 times the density (a
    velocity of 1e-3), so that no cell's kinetic energy outgrows a tiny
    pressure."""
    rng = np.random.default_rng(seed)
    out = {}
    for lev in sorted(state):
        v = np.asarray(state[lev]) * (
            1.0 + 1e-3 * rng.standard_normal(np.shape(state[lev])))
        v[:, 1:4] += 1e-3 * v[:, :1] * rng.standard_normal(v[:, 1:4].shape)
        out[lev] = v
    return out


# The strong blasts of ``tests/test_flux_correct.py`` expanding into a
# near-vacuum: ambient density and pressure 1e-6, the blast at density 1
# and pressure 1 (ratios 1e6).  At the decks' sizes the higher-order
# candidate state of the first cycle has cells at rho <= 0 or p <= 0, so
# the first-order rescue runs (the decks as given never need it).
NEAR_VACUUM = ["problem/blast/density_ambient=1e-6",
               "problem/blast/pressure_ambient=1e-6",
               "problem/blast/density_ratio=1e6",
               "problem/blast/pressure_ratio=1e6"]


# -------------------------------------------------------------- adaptive meshes
# The SMR_2D blast with ``refinement = adaptive`` on the pressure gradient
# at 0.3 instead of its static region.  At n = 64, mb = 16 with
# ``derefine_count = 1`` it refines and derefines within a few cycles.
ADAPTIVE_2D = """
<job>
problem_id = blast

<problem/blast>
pressure_ratio = 100.0
radius_outer = 0.15

<parthenon/mesh>
refinement = adaptive
numlevel = 2
nghost = 2
nx1 = {n}
x1min = -0.5
x1max = 0.5
nx2 = {n}
x2min = -0.5
x2max = 0.5
nx3 = 1
x3min = -0.5
x3max = 0.5

<parthenon/meshblock>
nx1 = {mb}
nx2 = {mb}
nx3 = 1

<refinement>
type = pressure_gradient
threshold_pressure_gradient = 0.3

<parthenon/time>
integrator = vl2
cfl = 0.3
tlim = 1.0
nlim = {nlim}
ncycle_out = 0

<hydro>
fluid = euler
eos = adiabatic
riemann = hllc
reconstruction = plm
gamma = 1.4
precision = {precision}
"""

# GLM-MHD on the same 2-D deck: HLLD with a uniform Bx
ADAPTIVE_2D_MHD = ["hydro/fluid=glmmhd", "hydro/riemann=hlld",
                   "problem/blast/b0=0.5"]


# ------------------------------------------------------------ cloud crushing
# The cloud-in-wind deck (``pgen/cloud.py``) with tabular cooling, written
# here because the reference's ``inputs/cloud.in`` and its cooling table are
# not in the repository: a cloud of 100 pc at 1e-24 g/cm^3 in a wind of
# 1e-27 g/cm^3 at 1e7 K and 1700 km/s along x2, entering through the
# inner-x2 inflow boundary; GLM-MHD with a transverse field at plasma beta
# 100; one passive scalar; cooling on a power-law table
# (``write_cooling_table``).  The domain is 8 cloud radii across x1 and x3,
# from 4 radii upwind of the cloud's centre.  The code units (1 cm, about
# one hydrogen mass, 1e-8 s) keep every quantity of the cooling (Lambda,
# (X / m_h)^2) and of the state inside the f32 range, so that the deck
# also runs in single precision (with a parsec-sized length unit, Lambda
# in code units is ~1e-123 and (X / m_h)^2 ~1e122).
R_CLOUD = 3.085677580962325e+20     # 100 pc in code lengths (cm)
CLOUD = """
<job>
problem_id = cloud

<problem/cloud>
r0_cgs = 3.085677580962325e+20
rho_cloud_cgs = 1e-24
rho_wind_cgs = 1e-27
T_wind_cgs = 1e7
v_wind_cgs = 1.7e8
plasma_beta = 100.0
mag_field_angle = transverse

<parthenon/mesh>
refinement = {refinement}
numlevel = {numlevel}
merge_blocks = {merge}
nghost = 2
nx1 = {nx1}
x1min = {lo}
x1max = {hi}
nx2 = {nx2}
x2min = {lo}
x2max = {x2max}
nx3 = {nx3}
x3min = {lo}
x3max = {hi}
ix1_bc = outflow
ox1_bc = outflow
ix2_bc = cloud_inflow_x2
ox2_bc = outflow
ix3_bc = outflow
ox3_bc = outflow

<parthenon/meshblock>
nx1 = {mb}
nx2 = {mb}
nx3 = {mb}

<parthenon/time>
integrator = vl2
cfl = 0.3
tlim = 1.0e30
nlim = {nlim}
ncycle_out = 0

<hydro>
fluid = glmmhd
eos = adiabatic
riemann = hlld
reconstruction = plm
gamma = 1.666666666666667
nscalars = 1
He_mass_fraction = 0.25
precision = {precision}

<units>
code_length_cgs = 1.0
code_mass_cgs = 1.6726e-24
code_time_cgs = 1.0e-8

<cooling>
enable_cooling = tabular
table_filename = {table}
lambda_units_cgs = 1.0
integrator = {integrator}
cfl = 0.1
"""


def cloud_deck(table, refinement="none", nx=(16, 32, 16), mb=8, numlevel=2,
               nlim=5, integrator="townsend", precision="double",
               merge="true"):
    """The cloud deck at ``nx`` cells (x2 spans ``nx[1] / nx[0]`` times
    the 8 radii of x1)."""
    return CLOUD.format(refinement=refinement, numlevel=numlevel, nx1=nx[0],
                        nx2=nx[1], nx3=nx[2], lo=-4.0 * R_CLOUD,
                        hi=4.0 * R_CLOUD,
                        x2max=(-4.0 + 8.0 * nx[1] / nx[0]) * R_CLOUD, mb=mb,
                        nlim=nlim, table=table, integrator=integrator,
                        precision=precision, merge=merge)


def write_cooling_table(path, alpha=0.5, lam0=1e-23, t_ref=1e6,
                        log_t_range=(4.0, 8.0)):
    """A two-column cooling table (log10 T, log10 Lambda), Lambda =
    lam0 (T / t_ref)^alpha over ``log_t_range`` (10 rows per decade; by
    default 1e4 to 1e8 K, ``tests/test_cooling.py``'s power law)."""
    import math
    lo, hi = log_t_range
    log_t = np.linspace(lo, hi, int(round(10 * (hi - lo))) + 1)
    log_l = math.log10(lam0) + alpha * (log_t - math.log10(t_ref))
    with open(path, "w") as fh:
        fh.write("# logT logLambda\n")
        for a, b in zip(log_t, log_l):
            fh.write(f"{a} {b}\n")
    return str(path)


# ------------------------------------------------------ diffusion, sources
# The GLM-MHD linear wave with viscosity, conduction and Ohmic resistivity
# of ``tests/test_diffusion_linwave3d.py:20-76`` (nu = 0.01, kappa = eta =
# 0.02; the domain 3 x 1.5 x 1.5, all periodic), HLLD + PLM + VL2, with
# the diffusion's integrator and the rkl2 dt ratio of ``tests/
# test_diffusion.py:71`` as parameters; the .hst every cycle.
LINWAVE3D_DIFF = """
<job>
problem_id = linear_wave_mhd

<problem/linear_wave>
compute_error = false
dump_max_v2 = true
amp = 1.0e-4
wave_flag = 2
vflow = 0.0

<parthenon/mesh>
nghost = 2
merge_blocks = {merge}
refinement = {refinement}
numlevel = 2
nx1 = {nx1}
x1min = 0.0
x1max = 3.0
nx2 = {nx2}
x2min = 0.0
x2max = 1.5
nx3 = {nx3}
x3min = 0.0
x3max = 1.5

<parthenon/meshblock>
nx1 = {mb1}
nx2 = {mb2}
nx3 = {mb3}

<parthenon/time>
integrator = vl2
cfl = 0.3
tlim = 3.0
nlim = {nlim}
ncycle_out = 0

<hydro>
fluid = glmmhd
eos = adiabatic
riemann = hlld
reconstruction = plm
gamma = 1.666666666666667
precision = {precision}

<diffusion>
integrator = {integrator}
conduction = isotropic
conduction_coeff = fixed
thermal_diff_coeff_code = 0.02
viscosity = isotropic
viscosity_coeff = fixed
mom_diff_coeff_code = 0.01
resistivity = ohmic
resistivity_coeff = fixed
ohm_diff_coeff_code = 0.02
rkl2_max_dt_ratio = {ratio}

<parthenon/output2>
file_type = hst
"""


def linwave3d_deck(nx=(16, 8, 8), integrator="unsplit", nlim=5, mb=None,
                   precision="double", merge="true", refinement="none",
                   ratio=200.0, region=None):
    """The diffusive linear wave at ``nx`` cells (one block unless ``mb``);
    ``region``: a static level-1 region ``(x1min, x1max, x2min, x2max,
    x3min, x3max)``."""
    mb = mb or nx
    deck = LINWAVE3D_DIFF.format(
        nx1=nx[0], nx2=nx[1], nx3=nx[2], mb1=mb[0], mb2=mb[1], mb3=mb[2],
        nlim=nlim, integrator=integrator, precision=precision, merge=merge,
        refinement=refinement, ratio=ratio)
    return deck + static_region(region)


def static_region(region):
    """A ``<parthenon/static_refinement0>`` block at level 1 (or "")."""
    if region is None:
        return ""
    keys = ("x1min", "x1max", "x2min", "x2max", "x3min", "x3max")
    return "\n<parthenon/static_refinement0>\n" + "".join(
        f"{k} = {v}\n" for k, v in zip(keys, region)) + "level = 1\n"


# Driven MHD turbulence (the ``turbulence`` problem; the reference's own
# ``turbulence.in`` is not in the repository): GLM-MHD HLLD + PLM + VL2 in
# the unit box, b0 = 0.01 along x (b_config 0), rho0 = p0 = 1, kpeak 2,
# corr_time 1, sol_weight 1, accel_rms 0.5; the modes of the ``<modes>``
# block from ``make_random_modes(num_modes, kpeak, rseed)``.
TURBULENCE = """
<job>
problem_id = turbulence

<problem/turbulence>
rho0 = 1.0
p0 = 1.0
b0 = 0.01
b_config = 0
kpeak = 2.0
corr_time = 1.0
rseed = {rseed}
sol_weight = 1.0
accel_rms = 0.5
num_modes = {num_modes}

<parthenon/mesh>
nghost = 2
merge_blocks = {merge}
refinement = {refinement}
numlevel = 2
nx1 = {n}
x1min = 0.0
x1max = 1.0
nx2 = {n}
x2min = 0.0
x2max = 1.0
nx3 = {n}
x3min = 0.0
x3max = 1.0

<parthenon/meshblock>
nx1 = {mb}
nx2 = {mb}
nx3 = {mb}

<parthenon/time>
integrator = vl2
cfl = 0.3
tlim = 10.0
nlim = {nlim}
ncycle_out = 0

<hydro>
fluid = {fluid}
eos = adiabatic
riemann = {riemann}
reconstruction = plm
gamma = 1.666666666666667
precision = {precision}

<parthenon/output0>
file_type = hst
"""

# the level-1 octant of the refined turbulence and rand_blast decks
# (``tests/test_smr_split_sources.py:106-170``)
OCTANT = (0.0, 0.5, 0.0, 0.5, 0.0, 0.5)


def modes_block(k_vec):
    """The ``<modes>`` block of a ``[3, M]`` mode array."""
    lines = ["", "<modes>"]
    for i in range(np.shape(k_vec)[1]):
        for j in range(3):
            lines.append(f"k_{i + 1}_{j} = {int(k_vec[j][i])}")
    return "\n".join(lines) + "\n"


def turbulence_deck(n=16, mb=None, nlim=5, num_modes=30, mode_seed=20190729,
                    rseed=20190729, precision="double", merge="true",
                    refinement="none", fluid="glmmhd", riemann="hlld"):
    """The turbulence deck at ``n``^3 (one block unless ``mb``); on a
    refined mesh (``refinement = static``) the octant ``OCTANT`` at level
    1.  The modes come from the port's ``make_random_modes`` (numpy, the
    same draws as the JAX package's)."""
    from athenapk_tpu_torch.utils.few_modes_ft import make_random_modes
    deck = TURBULENCE.format(
        n=n, mb=mb or n, nlim=nlim, num_modes=num_modes, rseed=rseed,
        precision=precision, merge=merge, refinement=refinement,
        fluid=fluid, riemann=riemann)
    deck += modes_block(make_random_modes(num_modes, 2.0, mode_seed))
    return deck + static_region(OCTANT if refinement == "static" else None)


# Repeated random blasts (``rand_blast``): GLM-MHD HLLE + PLM + VL2 in the
# 0.2-wide box of ``tests/test_smr_split_sources.py:14-60``; blast 1 fires
# in the cycle that crosses t = 0.00125 (its pressure is 45,000 times the
# ambient 0.3, so the card's decks set first_order_flux_correct).
RAND_BLAST = """
<job>
problem_id = rand_blast

<problem/rand_blast>
rho0 = 1.0
p0 = 0.3
Bx0 = 0.056117

<parthenon/mesh>
nghost = 2
merge_blocks = {merge}
refinement = {refinement}
numlevel = 2
nx1 = {n}
x1min = -0.1
x1max = 0.1
nx2 = {n}
x2min = -0.1
x2max = 0.1
nx3 = {n}
x3min = -0.1
x3max = 0.1

<parthenon/meshblock>
nx1 = {mb}
nx2 = {mb}
nx3 = {mb}

<parthenon/time>
integrator = vl2
cfl = 0.3
tlim = {tlim}
nlim = {nlim}
ncycle_out = 0

<hydro>
fluid = glmmhd
eos = adiabatic
reconstruction = plm
riemann = hlle
gamma = 1.666666666666667
precision = {precision}
first_order_flux_correct = {fofc}

<parthenon/output0>
file_type = hst
"""


def rand_blast_deck(n=32, mb=None, nlim=5, tlim=0.002, precision="double",
                    merge="true", refinement="none", fofc="false"):
    """The rand_blast deck at ``n``^3; refined: the octant at level 1."""
    deck = RAND_BLAST.format(n=n, mb=mb or n, nlim=nlim, tlim=tlim,
                             precision=precision, merge=merge,
                             refinement=refinement, fofc=fofc)
    return deck + static_region(
        (-0.1, 0.1, 0.0, 0.1, 0.0, 0.1) if refinement == "static" else None)


def tracer_block(per_cell, seed=0, capacity_factor=2.0):
    """A ``<tracers>`` block: ``random_per_block`` seeding at ``per_cell``
    tracers per cell from ``seed``."""
    return ("\n<tracers>\nenabled = true\n"
            "initial_seed_method = random_per_block\n"
            f"initial_num_tracers_per_cell = {per_cell}\n"
            f"initial_rng_seed = {seed}\n"
            f"capacity_factor = {capacity_factor}\n")


# Uniform advection with tracers (``tests/test_tracers.py``'s deck): rho =
# p = 1 moving at (1, 0.5, 0.25) through the periodic unit box, Euler HLLC +
# PLM + RK2, 8^3 blocks of a 16^3 mesh.
ADVECT_TRACERS = """
<job>
problem_id = advection

<problem/advection>
vx = 1.0
vy = 0.5
vz = 0.25
rho_ratio = 0.0
rho_radius = 0.0
rho0 = 1.0
p0 = 1.0

<parthenon/mesh>
nghost = 2
merge_blocks = {merge}
nx1 = 16
x1min = 0.0
x1max = 1.0
nx2 = 16
x2min = 0.0
x2max = 1.0
nx3 = 16
x3min = 0.0
x3max = 1.0

<parthenon/meshblock>
nx1 = 8
nx2 = 8
nx3 = 8

<parthenon/time>
integrator = rk2
cfl = 0.4
tlim = 1.0
nlim = {nlim}
ncycle_out = 0

<hydro>
fluid = euler
eos = adiabatic
riemann = hllc
reconstruction = plm
gamma = 1.666666666666667
precision = {precision}
""" + tracer_block(0.05, seed=42)


# ------------------------------------------------------------ the cluster
# The galaxy-cluster deck with every source on (the reference's
# ``inputs/cluster/cluster.in`` is not in the repository; this deck is the
# port's own): GLM-MHD HLLD + PLM + VL2 with one passive scalar (the AGN
# jet tracer) and Townsend cooling on ``write_cooling_table``'s power law
# over 1e4-1e10 K, in the code units, gravity (NFW + Hernquist BCG +
# SMBH), entropy and hydrostatic-equilibrium blocks of
# ``tests/test_cluster.py`` (Mpc, 1e14 Msun, ~1 Gyr; a box of +-0.1 Mpc
# with outflow boundaries).  On top: few-modes velocity and magnetic
# perturbations; AGN feedback at fixed_power 1e-3 (~6e43 erg/s) split in
# thirds between the thermal dump (4 kpc), the kinetic jet (2 kpc radius,
# 2 kpc thick, 1 kpc off the plane, precessing) with its tracer and the
# Li et al. tower (l_scale 2 kpc, with its Gaussian mass); COLD_GAS
# triggering below 3.5e7 K inside 2 kpc; SN Ia on the BCG profile;
# stellar feedback in the 2-4 kpc shell; the clips inside 20 kpc.
CLUSTER = """
<job>
problem_id = cluster

<parthenon/mesh>
refinement = {refinement}
nghost = 2
nx1 = {n}
x1min = {lo}
x1max = {hi}
nx2 = {n}
x2min = {lo}
x2max = {hi}
nx3 = {n}
x3min = {lo}
x3max = {hi}
ix1_bc = {bc}
ox1_bc = {bc}
ix2_bc = {bc}
ox2_bc = {bc}
ix3_bc = {bc}
ox3_bc = {bc}

<parthenon/meshblock>
nx1 = {mb}
nx2 = {mb}
nx3 = {mb}

<parthenon/time>
integrator = vl2
cfl = 0.3
tlim = 1.0
nlim = {nlim}
ncycle_out = 0

<hydro>
fluid = glmmhd
eos = adiabatic
riemann = hlld
reconstruction = plm
gamma = 1.6666666666666667
He_mass_fraction = 0.25
nscalars = 1
precision = {precision}

<units>
code_length_cgs = 3.085677580962325e+24
code_mass_cgs = 1.98841586e+47
code_time_cgs = 3.15576e+16

<problem/cluster>
hubble_parameter = 0.0715898515654728

<problem/cluster/gravity>
include_nfw_g = true
which_bcg_g = HERNQUIST
include_smbh_g = true
g_smoothing_radius = 0.0

<problem/cluster/entropy_profile>
k_0 = 8.851337676479303e-121
k_100 = 1.3277006514718954e-119
r_k = 0.1
alpha_k = 1.1

<problem/cluster/hydrostatic_equilibrium>
r_fix = 2.0
rho_fix = 0.01477557589278723
r_sampling = 4.0

<problem/cluster/init_perturb>
sigma_v = 0.1
k_peak_v = 2.0
num_modes_v = 10
sol_weight_v = 1.0
rseed_v = 3
sigma_b = {sigma_b}
k_peak_b = 4.0
num_modes_b = 10
rseed_b = 4

<problem/cluster/precessing_jet>
jet_theta = 0.15
jet_phi_dot = 628.3
jet_phi0 = 0.2

<problem/cluster/agn_feedback>
fixed_power = 1.0e-3
efficiency = 1.0e-3
thermal_fraction = 0.333
kinetic_fraction = 0.333
magnetic_fraction = 0.333
thermal_radius = 0.004
kinetic_jet_radius = 0.002
kinetic_jet_thickness = 0.002
kinetic_jet_offset = 0.001
enable_tracer = true

<problem/cluster/magnetic_tower>
potential_type = li
li_alpha = 20.0
l_scale = 0.002
l_mass_scale = 0.002

<problem/cluster/agn_triggering>
triggering_mode = COLD_GAS
accretion_radius = 0.002
cold_temp_thresh = 3.5e7
cold_t_acc = 0.1

<problem/cluster/snia_feedback>
power_per_bcg_mass = 1.0e-3
mass_rate_per_bcg_mass = 1.0e-2

<problem/cluster/stellar_feedback>
stellar_radius = 0.004
exclusion_radius = 0.002
efficiency = 1.0e-5
number_density_threshold = 6.5e72
temperature_threshold = 3.7e7

<problem/cluster/clips>
clip_r = 0.02
dfloor = 1.0e-2
vceil = 30.0
vAceil = 30.0
Tceil = 5.0e9

<problem/cluster/reductions>
cold_temp_threshold = 3.5e7
agn_tracer_thresh = 0.01
"""

CLUSTER_COOLING = """
<cooling>
enable_cooling = tabular
table_filename = {table}
lambda_units_cgs = 1.0
integrator = townsend
cfl = 0.1
"""


def cluster_deck(n=32, mb=None, nlim=5, table=None, refinement="none",
                 regions=(), precision="double", bc="outflow", sigma_b=0.5,
                 stellar=True, half=0.1):
    """The cluster deck at ``n``^3 cells over the box +-``half`` Mpc
    (blocks of ``mb``^3, one block by default), with Townsend cooling on
    the table ``table`` (no cooling without one); ``regions``: static
    refinement regions ``(half-width, level)`` centred on the origin;
    ``stellar=False`` drops the stellar feedback (its number density,
    ~1e73 per Mpc^3 in these units, is outside the f32 range: it refuses a
    single-precision state).  The tests' small meshes take a small box
    (+-0.02 at 32^3 is 1.25 kpc cells), so that the kpc-sized AGN regions
    hold cells."""
    deck = CLUSTER.format(n=n, mb=mb or n, nlim=nlim, refinement=refinement,
                          precision=precision, bc=bc, sigma_b=sigma_b,
                          lo=-half, hi=half)
    if table is not None:
        deck += CLUSTER_COOLING.format(table=table)
    if not stellar:
        start = deck.index("<problem/cluster/stellar_feedback>")
        end = deck.index("<problem/cluster/clips>")
        deck = deck[:start] + deck[end:]
    for i, region in enumerate(regions):
        bounds = region[:-1] if len(region) == 7 else (
            -region[0], region[0]) * 3
        deck += f"\n<parthenon/static_refinement{i}>\n" + "".join(
            f"{k}min = {bounds[2 * j]}\n{k}max = {bounds[2 * j + 1]}\n"
            for j, k in enumerate(("x1", "x2", "x3"))) \
            + f"level = {region[-1]}\n"
    return deck


def write_cluster_table(path):
    """The cluster deck's cooling table: the power law of
    ``write_cooling_table`` over 1e4-1e10 K (the AGN heats gas beyond the
    default 1e8 K)."""
    return write_cooling_table(path, log_t_range=(4.0, 10.0))


def cluster_adaptive_deck(table, n=32, mb=8, half=0.04, nlim=4,
                          precision="double", split=True):
    """The cluster deck on an adaptive mesh: base ``n``^3 over +-``half``
    Mpc in ``mb``^3 blocks, ``numlevel = 2``, ``derefine_count = 1``, the
    ``pressure_gradient`` criterion at 0.08 (at 32^3 over +-0.04 the
    initial refinement holds {0: 56, 1: 64} leaves and cycle 4's remesh
    changes them).  ``split=False`` drops the split sources (stellar
    feedback and the clips), which refined meshes over ranks refuse."""
    deck = cluster_deck(n=n, mb=mb, nlim=nlim, table=table,
                        refinement="adaptive", precision=precision,
                        stellar=split, half=half)
    deck = deck.replace("refinement = adaptive", "refinement = adaptive\n"
                        "numlevel = 2\nderefine_count = 1")
    if not split:
        deck = deck.replace("clip_r = 0.02", "clip_r = -1.0")
    return deck + """
<refinement>
type = pressure_gradient
threshold_pressure_gradient = 0.08
"""


# one EOS limit at a time, each tripped by ``eos_cons``'s states (the values
# of test_torch_eos.py's floor cases)
EOS_LIMITS = {
    "none": {},
    "dfloor": dict(density_floor=0.3),
    "pfloor": dict(pressure_floor=0.1),
    "efloor": dict(internal_e_floor=0.3),
    "vceil": dict(velocity_ceiling=0.8),
    "eceil": dict(internal_e_ceiling=1.0),
}


def eos_cons(fluid, nscalars, seed, cells=(2, 4, 5, 6)):
    """Random conserved states ``[nb, nvar, nz, ny, nx]`` (``cells`` =
    ``(nb, nz, ny, nx)``; numpy, f64) on which some cells trip every floor
    and ceiling of the EOS: density from 0.05 to 2, internal energy from
    slightly negative to large."""
    rng = np.random.default_rng(seed)
    nvar = (9 if fluid == "glmmhd" else 5) + nscalars
    shape = (cells[0], nvar) + tuple(cells[1:])
    u = rng.standard_normal(shape)
    u[:, 0] = rng.uniform(0.05, 2.0, shape[:1] + shape[2:])   # some < dfloor
    ke = 0.5 * (u[:, 1] ** 2 + u[:, 2] ** 2 + u[:, 3] ** 2) / u[:, 0]
    eb = 0.5 * (u[:, 5] ** 2 + u[:, 6] ** 2 + u[:, 7] ** 2) \
        if fluid == "glmmhd" else 0.0
    # internal energy from slightly negative to large: trips p/e floors
    # and the internal-energy ceiling
    u[:, 4] = ke + eb + rng.uniform(-0.05, 4.0, ke.shape)
    return u

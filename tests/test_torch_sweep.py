"""Port parity: the -div(F) sweep (``solver/sweep.py``) against the JAX
package.

``negdiv_plain`` is held, in f64 at 16^3, against both JAX formulations of
the same function: the Pallas kernel ``make_fused_negdiv`` run in interpret
mode (as ``tests/test_pallas_sweep.py`` runs it on the CPU) and the XLA
path ``-_flux_divergence(_compute_fluxes(...))``.  Tolerance 1e-12
relative to the largest magnitude: the arithmetic is the same operation by
operation, so only rounding may differ.  Ghosted layouts are compared on
interiors (the roll wrap leaves garbage in the ghost rim by design).

The CUDA kernel itself runs only on the card (``tests/test_torch_cuda.py``).
"""

import hashlib

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from athenapk_tpu.core.mesh import Mesh as JMesh
from athenapk_tpu.eos.adiabatic import EOS as JEOS
from athenapk_tpu.solver.hydro_pkg import HydroConfig as JCfg
from athenapk_tpu.solver.hydro_pkg import HydroPackage as JPkg
from athenapk_tpu.solver.pallas_sweep import make_fused_negdiv
from athenapk_tpu_torch.core.mesh import Mesh
from athenapk_tpu_torch.eos.adiabatic import EOS
from athenapk_tpu_torch.solver import sweep
from athenapk_tpu_torch.solver.hydro_pkg import HydroConfig, HydroPackage

torch.set_num_threads(2)

TOL = 1e-12
C_H = 1.3
LAYOUTS = {"ghostfree": (16, 16, 0), "ghosted": (16, 8, 3)}


def _mesh_kw(layout):
    n, mb, g = LAYOUTS[layout]
    return dict(nx1=n, nx2=n, nx3=n, mbnx1=mb, mbnx2=mb, mbnx3=mb,
                x1min=0.0, x1max=1.0, x2min=0.0, x2max=1.5, x3min=0.0,
                x3max=1.5, nghost=g)


def smooth_glm_prim(mesh, seed):
    """A smooth GLM-MHD primitive state with every velocity and field
    component nonzero, plus seeded noise (generic: no degenerate faces)."""
    rng = np.random.default_rng(seed)
    x, y, z = mesh.cell_centers_mesh()
    two_pi = 2.0 * np.pi
    w = np.zeros((mesh.nblocks, 9) + mesh.block_shape)
    w[:, 0] = 1.0 + 0.1 * np.sin(two_pi * x) * np.cos(two_pi * y) \
        + 0.05 * np.sin(two_pi * z)
    w[:, 1] = 0.3 + 0.2 * np.sin(two_pi * z) + 0.0 * x
    w[:, 2] = 0.2 + 0.1 * np.cos(two_pi * x) + 0.0 * y
    w[:, 3] = -0.15 + 0.1 * np.sin(two_pi * y) + 0.0 * z
    w[:, 4] = 0.6 + 0.05 * np.cos(two_pi * (x + y + z))
    w[:, 5] = 1.0 + 0.1 * np.sin(two_pi * y) + 0.0 * x
    w[:, 6] = 0.5 + 0.1 * np.cos(two_pi * z) + 0.0 * x
    w[:, 7] = 0.1 + 0.1 * np.sin(two_pi * x) + 0.0 * y
    w[:, 8] = 0.01 * np.sin(two_pi * (x - y)) + 0.0 * z
    return w + 1e-3 * rng.standard_normal(w.shape)


def _interior(a, mesh):
    return np.asarray(a)[mesh.interior_slices]


def _rel(a, b):
    return np.abs(a - b).max() / np.abs(a).max()


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("recon", ["dc", "ppm"])
def test_negdiv_plain_matches_jax(recon, layout):
    jmesh = JMesh(**_mesh_kw(layout))
    jcfg = JCfg(fluid="glmmhd", riemann="hlld", reconstruction=recon)
    jeos = JEOS(gamma=5.0 / 3.0)
    jpkg = JPkg(jmesh, jcfg, jeos)
    mesh = Mesh(**_mesh_kw(layout))
    cfg = HydroConfig(fluid="glmmhd", riemann="hlld", reconstruction=recon)
    w = smooth_glm_prim(mesh, seed=3)

    got = sweep.negdiv_plain(torch.tensor(w), C_H, mesh, cfg,
                             EOS(gamma=5.0 / 3.0), recon).numpy()
    xla = -np.asarray(jpkg._flux_divergence(
        jpkg._compute_fluxes(jnp.asarray(w), jnp.asarray(C_H), recon)))
    pallas = make_fused_negdiv(jmesh, jcfg, jeos, jpkg._positivity_mask,
                               recon, tz=1, ty=8, interpret=True)
    kern = np.asarray(pallas(jnp.asarray(w), jnp.asarray(C_H)))
    for ref in (xla, kern):
        assert _rel(_interior(ref, mesh), _interior(got, mesh)) <= TOL


def test_fused_negdiv_cpu_is_the_plain_path():
    mesh = Mesh(**_mesh_kw("ghostfree"))
    cfg = HydroConfig(fluid="glmmhd", riemann="hlld", reconstruction="ppm")
    eos = EOS(gamma=5.0 / 3.0)
    prim = torch.tensor(smooth_glm_prim(mesh, seed=5))
    launches = sweep.negdiv_cuda.launches
    got = sweep.fused_negdiv(prim, C_H, mesh, cfg, eos, "ppm")
    assert torch.equal(got, sweep.negdiv_plain(prim, C_H, mesh, cfg, eos,
                                               "ppm"))
    assert sweep.negdiv_cuda.launches == launches


@pytest.mark.parametrize("recon", ["dc", "ppm"])
def test_package_fluxes_match_jax(recon):
    """``HydroPackage._compute_fluxes`` direction by direction, and
    ``_flux_divergence`` of them, against the JAX package's methods."""
    kw = _mesh_kw("ghosted")
    jpkg = JPkg(JMesh(**kw), JCfg(fluid="glmmhd", riemann="hlld",
                                  reconstruction=recon), JEOS(gamma=5.0 / 3.0))
    mesh = Mesh(**kw)
    pkg = HydroPackage(mesh, HydroConfig(fluid="glmmhd", riemann="hlld",
                                         reconstruction=recon),
                       EOS(gamma=5.0 / 3.0))
    w = smooth_glm_prim(mesh, seed=4)
    jflux = jpkg._compute_fluxes(jnp.asarray(w), jnp.asarray(C_H), recon)
    flux = pkg._compute_fluxes(torch.tensor(w), C_H, recon)
    assert sorted(flux) == sorted(jflux) == [1, 2, 3]
    for d in flux:
        assert _rel(np.asarray(jflux[d]), flux[d].numpy()) <= TOL
    ref = _interior(jpkg._flux_divergence(jflux), mesh)
    got = _interior(pkg._flux_divergence(flux).numpy(), mesh)
    assert _rel(ref, got) <= TOL


def test_non_cpu_tensor_never_takes_the_plain_path():
    """A tensor off the CPU goes to the kernel wrapper, which raises on
    what it cannot launch instead of falling back."""
    mesh = Mesh(**_mesh_kw("ghostfree"))
    eos = EOS(gamma=5.0 / 3.0)
    ppm = HydroConfig(fluid="glmmhd", riemann="hlld", reconstruction="ppm")
    prim = torch.empty((1, 9) + mesh.block_shape, device="meta")
    with pytest.raises(ValueError, match="CUDA tensor"):
        sweep.fused_negdiv(prim, C_H, mesh, ppm, eos, "ppm")
    # passive scalars are taken too: they get as far as the tensor checks
    scalars = HydroConfig(fluid="euler", riemann="hllc", reconstruction="ppm",
                          nscalars=2)
    with pytest.raises(ValueError, match="CUDA tensor"):
        sweep.fused_negdiv(prim[:, :7], C_H, mesh, scalars, eos, "ppm")
    # every (fluid, solver) pair and every reconstruction is taken: each
    # gets as far as the tensor checks
    for fluid, riemann in sweep.KERNEL_SOLVERS:
        nvar = 9 if fluid == "glmmhd" else 5
        for recon in sweep.KERNEL_RECONS:
            cfg = HydroConfig(fluid=fluid, riemann=riemann,
                              reconstruction=recon)
            with pytest.raises(ValueError, match="CUDA tensor"):
                sweep.fused_negdiv(prim[:, :nvar], C_H, mesh, cfg, eos,
                                   recon)
    assert len(sweep.KERNEL_SOLVERS) == len(sweep.KERNEL_RECONS) == 6


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(sweep, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(sweep.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no_cuda"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        sweep.build_library()


@pytest.mark.parametrize("source", ["negdiv_sweep.cu", "fused_stage.cu"])
def test_library_is_keyed_by_source_and_header(source, monkeypatch, tmp_path):
    """``build_library`` names the library after the hash of the source it
    compiles and of the header that source includes, so editing either
    rebuilds; a library of that name is taken as built."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for path in (sweep.CSRC_DIR / source,) + sweep.HEADERS:
        (csrc / path.name).write_bytes(path.read_bytes())
    header = csrc / sweep.HEADERS[0].name
    monkeypatch.setattr(sweep, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(sweep, "HEADERS", (header,))
    monkeypatch.setattr(sweep.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no_cuda"))

    def library_name():
        """Put a file of the expected name in place; ``build_library``
        must then return it without asking for ``nvcc``."""
        (tmp_path / "build").mkdir(exist_ok=True)
        digest = hashlib.sha256((csrc / source).read_bytes()
                                + header.read_bytes()).hexdigest()[:12]
        lib = tmp_path / "build" / f"lib{source[:-3]}_{digest}.so"
        lib.write_bytes(b"")
        path, log = sweep.build_library(csrc / source)
        assert path == lib and log == ""
        return path.name

    first = library_name()
    header.write_text(header.read_text() + "\n// edited\n")
    second = library_name()
    (csrc / source).write_text((csrc / source).read_text() + "\n// edited\n")
    third = library_name()
    assert len({first, second, third}) == 3
    # with no library of the new name, the build is attempted (and fails
    # here, where there is no nvcc)
    header.write_text(header.read_text() + "\n// again\n")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        sweep.build_library(csrc / source)


def test_ptxas_summary_reads_each_instantiation():
    """``ptxas_summary`` names each kernel instantiation of an ``nvcc
    -Xptxas -v`` log by its template switches and keeps its registers and
    spills; without ``occupancy`` it asks no card."""
    log = "\n".join([
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_119"
        "negdiv_sweep_kernelIfLi2ELi1ELi2EEEvPKT_PS1_S4_NS_4GeomE' for "
        "'sm_90a'",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 96 registers, used 1 barriers",
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_118"
        "fused_stage_kernelIdLi1ELi0ELb1EEEvv' for 'sm_90a'",
        "    0 bytes stack frame, 8 bytes spill stores, 8 bytes spill loads",
        "ptxas info    : Used 255 registers, used 1 barriers",
    ])
    assert sweep.ptxas_summary(log) == [
        "negdiv_sweep f32 ppm dir 1 glmmhd-hlld: 96 registers, 0 bytes "
        "stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "fused_stage f64 plm euler-hlle faces: 255 registers, 0 bytes stack "
        "frame, 8 bytes spill stores, 8 bytes spill loads",
    ]


def test_ptxas_summary_names_other_entry_functions_by_their_mangled_name():
    """An entry function that is not a fluid or scalar kernel (the cooling
    kernels') gets its line under its mangled name, even with
    ``occupancy``, for which no card is asked."""
    name = "_ZN7cooling20townsend_cool_kernelIdLb1ELi2EEEvPT_iix"
    log = "\n".join([
        f"ptxas info    : Compiling entry function '{name}' for 'sm_90a'",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 64 registers, used 1 barriers",
    ])
    want = [f"{name}: 64 registers, 0 bytes stack frame, 0 bytes spill "
            "stores, 0 bytes spill loads"]
    assert sweep.ptxas_summary(log) == want
    assert sweep.ptxas_summary(log, occupancy=True) == want


def test_decks_with_scalars_build_their_own_library(monkeypatch, tmp_path):
    """The instantiations for decks with scalars (and the scalar kernels)
    build into a second library of each source, named apart, so that a
    run without scalars never compiles them; each library's units carry
    their family's switch."""
    for scalars in (False, True):
        units = sweep.build_units(scalars)
        assert units[0] == (f"-DHYDRO_ENTRY_SCAL={int(scalars)}",)
        assert len(units) == 1 + len(sweep.KERNEL_RECONS) * len(
            sweep.KERNEL_DTYPES)
        assert all(u[-1] == f"-DHYDRO_UNIT_SCAL={int(scalars)}"
                   for u in units[1:])
    monkeypatch.setattr(sweep, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(sweep.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no_cuda"))
    digest = hashlib.sha256()
    for path in (sweep.CSRC,) + sweep.HEADERS:
        digest.update(path.read_bytes())
    (tmp_path / "build").mkdir()
    lib = (tmp_path / "build"
           / f"libnegdiv_sweep_scalars_{digest.hexdigest()[:12]}.so")
    lib.write_bytes(b"")
    assert sweep.build_library(scalars=True) == (lib, "")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        sweep.build_library()      # the other library is not there

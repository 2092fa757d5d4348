"""The EOS kernel's plumbing on the CPU: ``eos.adiabatic_cuda``'s
dispatcher hands a CPU tensor to the plain ``eos.adiabatic.cons_to_prim``
(and ``HydroPackage.cons_to_prim`` goes through it), the wrapper refuses a
CPU tensor before it builds anything, and the benchmark reads the kernel as
glue: its name lies outside ``benchmark.harness.trace.CSRC_KERNEL`` and its
launch counter outside ``benchmark.harness.cell.csrc_launches`` (so the
sweep kernel's readers keep their lost-kernel guard); its library is
named after its unit list too.  The kernel itself runs only on the card (``tests/test_torch_cuda.py``)."""

import hashlib
import re
import zlib

import pytest
import torch

from athenapk_tpu_torch.core import kernels
from athenapk_tpu_torch.core.mesh import Mesh
from athenapk_tpu_torch.eos import adiabatic, adiabatic_cuda
from athenapk_tpu_torch.eos.adiabatic import EOS
from athenapk_tpu_torch.solver.hydro_pkg import HydroConfig, HydroPackage
from benchmark.harness.cell import csrc_launches
from benchmark.harness.trace import CSRC_KERNEL, short_name
from torch_decks import EOS_LIMITS, eos_cons


def _no_kernel(*args, **kwargs):
    raise AssertionError("the CUDA path was taken")


@pytest.mark.parametrize("limit", ["none", "dfloor", "vceil"])
@pytest.mark.parametrize("fluid,nscalars", [("euler", 0), ("glmmhd", 0),
                                            ("glmmhd", 2)])
def test_dispatcher_takes_the_plain_eos_on_the_cpu(fluid, nscalars, limit,
                                                   monkeypatch):
    monkeypatch.setattr(adiabatic_cuda, "cons_to_prim_cuda", _no_kernel)
    eos = EOS(gamma=5.0 / 3.0, **EOS_LIMITS[limit])
    seed = zlib.crc32(f"{fluid}/{nscalars}/{limit}".encode())
    u = torch.tensor(eos_cons(fluid, nscalars, seed))
    got_u, got_w = adiabatic_cuda.fused_cons_to_prim(eos, u, fluid, nscalars)
    ref_u, ref_w = adiabatic.cons_to_prim(eos, u, fluid, nscalars)
    assert torch.equal(got_u, ref_u) and torch.equal(got_w, ref_w)


def test_package_eos_goes_through_the_dispatcher(monkeypatch):
    calls = []

    def spy(*args):
        calls.append(args)
        return adiabatic.cons_to_prim(*args)

    monkeypatch.setattr(adiabatic_cuda, "fused_cons_to_prim", spy)
    mesh = Mesh(nx1=8, nx2=4, nx3=4, mbnx1=8, mbnx2=4, mbnx3=4, x1min=0.0,
                x1max=1.0, x2min=0.0, x2max=1.0, x3min=0.0, x3max=1.0,
                nghost=0)
    cfg = HydroConfig(fluid="glmmhd", riemann="hlle", reconstruction="plm",
                      nscalars=1)
    eos = EOS(gamma=1.4, pressure_floor=0.1)
    pkg = HydroPackage(mesh, cfg, eos)
    u = torch.tensor(eos_cons("glmmhd", 1, 5, (1, 4, 4, 8)))
    got = pkg.cons_to_prim(u)
    ref = adiabatic.cons_to_prim(eos, u, "glmmhd", 1)
    assert [a[1:] for a in calls] == [(u, "glmmhd", 1)]
    assert calls[0][0] is eos
    assert all(torch.equal(g, r) for g, r in zip(got, ref))


def test_wrapper_refuses_a_cpu_tensor_before_building(monkeypatch):
    monkeypatch.setattr(adiabatic_cuda, "_library", _no_kernel)
    before = adiabatic_cuda.cons_to_prim_cuda.launches
    with pytest.raises(ValueError, match="CUDA"):
        adiabatic_cuda.cons_to_prim_cuda(
            EOS(gamma=5.0 / 3.0), torch.tensor(eos_cons("euler", 0, 1)),
            "euler")
    assert adiabatic_cuda.cons_to_prim_cuda.launches == before


def test_eos_kernel_name_lies_outside_the_csrc_kernel_pattern():
    src = adiabatic_cuda.CSRC.read_text()
    names = re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)"
                       r"\s*)?(\w+)\s*\(", src)
    assert names == ["cons_to_prim_kernel"]
    # as a trace names an instantiation, whole and shortened
    traced = ("void eos::cons_to_prim_kernel<double, 9, false, 2>(double "
              "const*, double*, double*, hydro::Params<double>, int, int, "
              "long long)")
    for name in names + [traced, short_name(traced)]:
        assert not CSRC_KERNEL.search(name)
    assert CSRC_KERNEL.search("void negdiv::negdiv_sweep_kernel<double, 5, "
                              "3, 5, false>(double const*)")


def test_eos_launches_are_not_summed_by_csrc_launches(monkeypatch):
    before = csrc_launches()
    monkeypatch.setattr(adiabatic_cuda.cons_to_prim_cuda, "launches",
                        adiabatic_cuda.cons_to_prim_cuda.launches + 7)
    assert csrc_launches() == before


def test_library_is_keyed_by_its_unit_list(monkeypatch, tmp_path):
    """A source built from a unit list of its own gets a library name per
    list: a library built from one list is never taken for another."""
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(kernels.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no_cuda"))
    (tmp_path / "build").mkdir()
    digest = hashlib.sha256()
    for path in (adiabatic_cuda.CSRC,) + kernels.HEADERS:
        digest.update(path.read_bytes())
    digest.update(repr([[]]).encode())
    lib = tmp_path / "build" / f"libcons_to_prim_{digest.hexdigest()[:12]}.so"
    lib.write_bytes(b"")
    assert adiabatic_cuda.build_library() == (lib, "")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kernels.build_library(adiabatic_cuda.CSRC, [("-DOTHER=1",)])

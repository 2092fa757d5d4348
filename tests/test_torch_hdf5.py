"""Port parity: ``.phdf`` dumps (``outputs/hdf5.py``) against the JAX
package's, on the CPU in f64.

* the same run through both packages writes the same files: every group,
  dataset and attribute present in both, integer and string attributes
  identical, float attributes and datasets within 1e-12 of the largest
  value (the clock of a later dump is the sum of the steps), the XDMF
  sidecars of the opening dumps identical; on a uniform mesh merged into
  one ghost-free block and left in blocks, on a static refined mesh with
  the tracer swarm, and on an adaptive mesh after its initial refinement;
* the JAX package's ``read_phdf`` and the reference toolchain's ``phdf``
  reader (``scripts/parthenon_tools``) load the port's dumps;
* twins of ``tests/test_phdf_format.py`` (the mixed-level dump, the
  lw_implode symmetry through ``phdf``, the swarm through ``GetSwarm``) and
  of ``tests/test_merge_blocks.py::test_merged_outputs_read_identically``;
* without h5py, a deck with an hdf5 or rst block raises an ImportError
  naming h5py when the simulation is built.
"""

import os
import sys

import h5py
import numpy as np
import pytest
import torch

from athenapk_tpu.amr.driver import SmrSimulation as JSmr
from athenapk_tpu.config.parameter_input import ParameterInput as JPin
from athenapk_tpu.driver import Simulation as JSim
from athenapk_tpu.outputs.hdf5 import read_phdf as jread_phdf
from athenapk_tpu_torch.amr.driver import SmrSimulation
from athenapk_tpu_torch.config.parameter_input import ParameterInput
from athenapk_tpu_torch.driver import Simulation, run_from_file
from athenapk_tpu_torch.outputs.hdf5 import read_phdf
from test_merge_blocks import DECK as WAVE
from test_tracers import DECK, SMR_DECK

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "scripts"))
from parthenon_tools import phdf  # noqa: E402

torch.set_num_threads(2)

TOL = 1e-12
OUTS = """
<parthenon/output1>
file_type = hdf5
variables = prim, cons
dt = {dt}
id = all
"""
SWARM = "swarms = tracers\ntracers_variables = id, x, y, z, rho, vel_x\n"
ADAPTIVE = os.path.join(ROOT, "inputs", "blast_3d_adaptive.in")
SMR_FILE = os.path.join(ROOT, "inputs", "blast_3d_smr.in")


def _walk(fh):
    """{path: object} of every group and dataset below ``fh``."""
    out = {"/": fh}
    fh.visititems(lambda name, obj: out.__setitem__(name, obj))
    return out


def _same_value(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype, what
    if a.dtype.kind == "f" and a.size:
        assert float(np.abs(a - b).max()) <= TOL * float(np.abs(a).max()), \
            what
    else:
        np.testing.assert_array_equal(a, b, err_msg=what)


def assert_same_file(got, want):
    with h5py.File(got, "r") as fg, h5py.File(want, "r") as fw:
        og, ow = _walk(fg), _walk(fw)
        assert sorted(og) == sorted(ow)
        for path, obj in ow.items():
            mine = og[path]
            assert sorted(mine.attrs) == sorted(obj.attrs), path
            for k in obj.attrs:
                _same_value(mine.attrs[k], obj.attrs[k], f"{path}@{k}")
            if isinstance(obj, h5py.Dataset):
                _same_value(mine[()], obj[()], path)


def _dumps(path):
    return sorted(p for p in os.listdir(path) if p.endswith(".phdf"))


def _both(tmp_path, make_jax, make_torch):
    """Run each package in its own directory; -> (torch dir, jax dir,
    dump names, port simulation)."""
    dirs = []
    sims = []
    for name, make in (("torch", make_torch), ("jax", make_jax)):
        d = tmp_path / name
        d.mkdir()
        cwd = os.getcwd()
        os.chdir(d)
        try:
            sims.append(make().run())
        finally:
            os.chdir(cwd)
        dirs.append(d)
    names = _dumps(dirs[0])
    assert names and names == _dumps(dirs[1])
    for n in names:
        assert_same_file(str(dirs[0] / n), str(dirs[1] / n))
    return dirs[0], dirs[1], names, sims[0]


def _same_xdmf(td, jd, name):
    assert (td / (name + ".xdmf")).read_text() == \
        (jd / (name + ".xdmf")).read_text()


@pytest.mark.parametrize("merge", ["true", "false"])
def test_uniform_dumps_match_jax(tmp_path, merge):
    deck = WAVE + OUTS.format(dt=0.01)
    ov = [f"parthenon/mesh/merge_blocks={merge}"]
    td, jd, names, sim = _both(
        tmp_path, lambda: JSim(JPin.from_string(deck, ov), quiet=True),
        lambda: Simulation(ParameterInput.from_string(deck, ov), quiet=True,
                           device="cpu"))
    assert sim.mesh.nblocks == (1 if merge == "true" else 8)
    assert len(names) >= 3
    _same_xdmf(td, jd, names[0])
    # both readers load the port's dump
    d = jread_phdf(str(td / names[-1]))
    assert d.num_blocks == sim.mesh.nblocks
    np.testing.assert_array_equal(
        d.flat("prim"), read_phdf(str(td / names[-1])).flat("prim"))
    ref = phdf.phdf(str(td / names[-1]))
    assert ref.NumBlocks == sim.mesh.nblocks
    comps = ref.GetComponents(["cons_density"], flatten=False)
    assert comps["cons_density"].shape[0] == sim.mesh.nblocks


def test_static_refined_dumps_with_the_swarm_match_jax(tmp_path):
    deck = SMR_DECK.replace("nlim = 1000", "nlim = 3") \
        + OUTS.format(dt=0.02) + SWARM
    td, jd, names, sim = _both(
        tmp_path, lambda: JSmr(JPin.from_string(deck), quiet=True),
        lambda: SmrSimulation(ParameterInput.from_string(deck), quiet=True,
                              device="cpu"))
    assert names[0] == "advection.outall.00000.phdf"
    _same_xdmf(td, jd, names[0])
    data = phdf.phdf(str(td / names[-1]))
    assert set(np.asarray(data.Levels)) == {0, 1}
    n_active = sum(int(st["active"].sum())
                   for st in sim.tracer_state["levels"].values())
    assert len(data.GetSwarm("tracers").Get("id")) == n_active


def test_adaptive_dump_matches_jax(tmp_path):
    """The opening dump after the initial refinement loop (later blast
    dumps hold the symmetric ties where the JAX package's compiled and
    eager steps differ)."""
    ov = ["parthenon/output0/dt=-1", "parthenon/time/nlim=0",
          "parthenon/output1/file_type=hdf5",
          "parthenon/output1/variables=prim", "parthenon/output1/dt=1.0"]
    td, jd, names, sim = _both(
        tmp_path, lambda: JSmr(JPin.from_file(ADAPTIVE, ov), quiet=True),
        lambda: SmrSimulation(ParameterInput.from_file(ADAPTIVE, ov),
                              quiet=True, device="cpu"))
    assert sim.adaptive and len(names) == 2
    _same_xdmf(td, jd, names[0])
    assert set(np.asarray(phdf.phdf(str(td / names[0])).Levels)) == {0, 1}


# ------------------------------------------------ twins of the JAX tests
def test_phdf_reader_loads_mixed_level_dump(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    run_from_file(
        SMR_FILE,
        overrides=["parthenon/mesh/nx1=32", "parthenon/mesh/nx2=32",
                   "parthenon/mesh/nx3=32", "parthenon/meshblock/nx1=8",
                   "parthenon/meshblock/nx2=8", "parthenon/meshblock/nx3=8",
                   "parthenon/output1/file_type=hdf5",
                   "parthenon/output1/variables=prim",
                   "parthenon/output1/dt=-1.0",
                   "parthenon/time/nlim=2"], quiet=True, device="cpu")
    data = phdf.phdf(str(tmp_path / "blast.out1.00000.phdf"))
    levels = np.asarray(data.Levels)
    assert set(levels) == {0, 1}
    assert data.MaxLevel == 1
    dx_by_level = {lev: float(np.diff(data.xf[levels == lev][0]).mean())
                   for lev in (0, 1)}
    np.testing.assert_allclose(dx_by_level[0], 2.0 * dx_by_level[1])
    comps = data.GetComponents(["prim_density"], flatten=False)
    assert comps["prim_density"].shape == (len(levels), 8, 8, 8)
    assert np.isfinite(comps["prim_density"]).all()
    lls = np.asarray(data.LogicalLocations)
    b0 = np.where(levels == 0)[0][0]
    assert data.xf[b0, 0] == pytest.approx(
        -0.5 + lls[b0, 0] * 8 * dx_by_level[0])


LW_IMPLODE = """
<job>
problem_id = lw_implode

<problem/lw_implode>
d_in = 0.125
p_in = 0.14
d_out = 1.0
p_out = 1.0

<parthenon/mesh>
nghost = 2
nx1 = 32
x1min = 0.0
x1max = 0.25
nx2 = 32
x2min = 0.0
x2max = 0.25
nx3 = 1
x3min = -0.5
x3max = 0.5
ix1_bc = reflecting
ox1_bc = reflecting
ix2_bc = reflecting
ox2_bc = reflecting

<parthenon/meshblock>
nx1 = 32
nx2 = 32

<parthenon/time>
integrator = vl2
cfl = 0.3
tlim = 0.1
nlim = 40
ncycle_out = 0

<hydro>
fluid = euler
eos = adiabatic
riemann = hllc
reconstruction = plm
gamma = 1.4

<parthenon/output0>
file_type = hdf5
variables = prim
dt = 100.0
id = prim
"""


def test_lw_implode_symmetry_via_phdf(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    Simulation(ParameterInput.from_string(LW_IMPLODE), quiet=True,
               device="cpu").run()
    data = phdf.phdf(str(tmp_path / "lw_implode.out_prim.00000.phdf"))
    comps = data.GetComponents(
        ["prim_density", "prim_velocity_1", "prim_velocity_2"],
        flatten=False)
    rho = comps["prim_density"][0, 0]
    v1 = comps["prim_velocity_1"][0, 0]
    v2 = comps["prim_velocity_2"][0, 0]
    assert np.array_equal(rho, rho.T)
    assert np.array_equal(v1, v2.T)


def test_phdf_swarm_read(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    deck = DECK.replace("nlim = 1000", "nlim = 2") + """
<parthenon/output0>
file_type = hdf5
variables = prim
dt = 100.0
id = prim
swarms = tracers
tracers_variables = id, x, y, z
"""
    Simulation(ParameterInput.from_string(deck), quiet=True,
               device="cpu").run()
    data = phdf.phdf(str(tmp_path / "advection.out_prim.00000.phdf"))
    tracers = data.GetSwarm("tracers")
    ids = tracers.Get("id")
    assert len(ids) > 0
    assert tracers.x.shape == ids.shape
    assert (np.sort(ids) == np.arange(len(ids))).all()
    assert ((tracers.x >= 0.0) & (tracers.x <= 1.0)).all()


def test_merged_outputs_read_identically(tmp_path):
    deck = WAVE + "\n<parthenon/output0>\nfile_type = hdf5\ndt = 0.02\n" \
        "variables = prim\n"

    def run_in(sub, merge):
        d = tmp_path / sub
        d.mkdir()
        cwd = os.getcwd()
        os.chdir(d)
        try:
            Simulation(ParameterInput.from_string(
                deck, [f"parthenon/mesh/merge_blocks={merge}"]), quiet=True,
                device="cpu").run()
        finally:
            os.chdir(cwd)
        return sorted(d / p for p in _dumps(d))

    da, db = run_in("blocked", "false"), run_in("merged", "true")
    assert da and len(da) == len(db)
    for pa, pb in zip(da, db):
        np.testing.assert_array_equal(read_phdf(str(pa)).flat("prim"),
                                      read_phdf(str(pb)).flat("prim"))


# ------------------------------------------------------------ the h5py guard
@pytest.mark.parametrize("ftype", ["hdf5", "rst"])
@pytest.mark.parametrize("refined", [False, True])
def test_missing_h5py_is_named_when_built(monkeypatch, ftype, refined):
    monkeypatch.setitem(sys.modules, "h5py", None)
    over = [f"parthenon/output5/file_type={ftype}"]
    if refined:
        with pytest.raises(ImportError, match="h5py"):
            SmrSimulation(ParameterInput.from_file(SMR_FILE, over),
                          device="cpu")
    else:
        with pytest.raises(ImportError, match="h5py"):
            Simulation(ParameterInput.from_string(WAVE, over), device="cpu")
    # a deck without such a block builds
    Simulation(ParameterInput.from_string(WAVE), device="cpu")

"""Checkpoint / restart (the reference's ``.rhdf``; the port's counterpart
of ``athenapk_tpu/outputs/restart.py``).

Two layers:

* the payload (numpy only, no h5py): ``restart_payload(sim)`` and
  ``restart_payload_smr(sim)`` return the dict that ``read_restart`` returns
  for the file of that moment, and ``Simulation(pin, restart=payload)`` /
  ``SmrSimulation(pin, restart=payload)`` resume from it.  A uniform
  payload holds the ghost-inclusive ``cons``; a refined one ``levels``,
  ``logical_locations`` and ``state`` (``{level: array}``, ghosts
  included); both ``t``, ``ncycle``, ``dt`` (the last cycle's step, which
  seeds the 2x growth cap), ``triggers`` (``[(next_time, count)]`` of the
  outputs) and, where they apply, ``tracers``, ``few_modes_ft`` (the OU
  forcing's ``(var_hat, bit_generator state)``) and ``deref_counts``
  (adaptive meshes).  The state keeps its dtype, so a resume continues bit
  for bit (the reference's bitwise restarts, ``CHANGELOG.md:50``).
* the file layer (h5py, imported inside each function): ``write_restart``,
  ``write_restart_smr``, ``read_restart`` and ``read_restart_smr_payload``,
  in the JAX package's layout group for group (``Info`` attrs, ``Input``,
  ``cons`` or ``Levels``/``LogicalLocations``/``cons_lev{n}``,
  ``OutputTriggers``, ``Tracers``, ``FewModesFT``, ``DerefCounts``), so a
  ``.rhdf`` of either package resumes in the other.  The refined reader
  also returns the ``Info`` attribute ``dt``, which the JAX package writes
  but does not read back.

Resume: ``python -m athenapk_tpu_torch.driver -r file.rhdf`` (the reference
binary's convention).
"""

from __future__ import annotations

import copy
import json
import os

import numpy as np

from ..config.parameter_input import ParameterInput
from ..pgen import turbulence
from .hdf5 import require_h5py


def _host(x):
    """numpy copy of a tensor (or of an array-like)."""
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _forcing_state(cache, pin):
    """A deep copy of the OU forcing's ``(var_hat, rng state)`` of ``pin``,
    or None where the run has no forcing driver."""
    fm = cache.get(pin)
    return None if fm is None else copy.deepcopy(fm.get_state())


def restart_payload(sim):
    """The restart payload of a uniform ``driver.Simulation`` as it stands
    (numpy arrays and plain values)."""
    payload = dict(
        t=float(sim.t), ncycle=int(sim.ncycle),
        dt=float(sim.tm_dt if sim.tm_dt is not None else 0.0),
        cons=_host(sim.u),
        triggers=np.asarray([(getattr(o, "next_time", 0.0),
                              getattr(o, "count", 0)) for o in sim.outputs]))
    if sim.tracer_state is not None:
        payload["tracers"] = {k: _host(v)
                              for k, v in sim.tracer_state.items()}
    fm = _forcing_state(turbulence._driver_cache, sim.pin)
    if fm is not None:
        payload["few_modes_ft"] = fm
    return payload


def restart_payload_smr(sim):
    """The restart payload of an ``amr.driver.SmrSimulation`` as it stands:
    the leaf table, the per-level ghost-inclusive state, the clock, the
    triggers (hdf5 outputs, then rst outputs, then the ``.hst`` one: the
    JAX package's order), the tracers, the derefinement counters (adaptive
    meshes) and the forcing."""
    sm = sim._smesh_now()
    trig = [(o["next"], o["count"]) for o in sim._hdf5_outs + sim._rst_outs]
    trig.append((sim._hst.next_time if sim._hst is not None else 0.0, 0))
    payload = dict(
        t=float(sim.t), ncycle=int(sim.ncycle),
        dt=float(sim.tm_dt or 0.0),
        levels=np.asarray(sm.levels, np.int32),
        logical_locations=np.stack([sm.lx1, sm.lx2, sm.lx3],
                                   axis=1).astype(np.int64),
        state={int(lev): _host(u) for lev, u in sim.state.items()},
        triggers=np.asarray(trig))
    if sim.tracer_state is not None:
        payload["tracers"] = {
            "n_lost": _host(sim.tracer_state["n_lost"]),
            "levels": {int(lev): {k: _host(v) for k, v in st.items()}
                       for lev, st in sim.tracer_state["levels"].items()}}
    if sim.adaptive:
        payload["deref_counts"] = dict(sim.driver._deref_counts)
    fm = _forcing_state(turbulence._smr_cache, sim.pin)
    if fm is not None:
        payload["few_modes_ft"] = fm
    return payload


# ------------------------------------------------------------ file layer
def _write_forcing(fh, few_modes_ft):
    if few_modes_ft is None:
        return
    var_hat, rng_state = few_modes_ft
    g = fh.create_group("FewModesFT")
    g.create_dataset("var_hat_r", data=var_hat.real)
    g.create_dataset("var_hat_i", data=var_hat.imag)
    g.attrs["rng_state"] = json.dumps(rng_state)


def _read_forcing(fh, payload):
    if "FewModesFT" in fh:
        g = fh["FewModesFT"]
        payload["few_modes_ft"] = (
            g["var_hat_r"][()] + 1j * g["var_hat_i"][()],
            json.loads(g.attrs["rng_state"]))


def _info(fh, payload):
    info = fh.create_group("Info")
    info.attrs["Time"] = float(payload["t"])
    info.attrs["NCycle"] = int(payload["ncycle"])
    info.attrs["dt"] = float(payload["dt"])
    info.attrs["OutputFormatVersion"] = 1
    return info


def write_restart(fname, sim):
    """Write a uniform ``Simulation``'s checkpoint to ``fname``."""
    h5py = require_h5py()
    payload = restart_payload(sim)
    os.makedirs(os.path.dirname(fname) or ".", exist_ok=True)
    with h5py.File(fname, "w") as fh:
        _info(fh, payload)
        fh.create_dataset("cons", data=payload["cons"])
        fh.create_dataset("Input", data=sim.pin.to_string().encode())
        fh.create_dataset("OutputTriggers", data=payload["triggers"])
        if "tracers" in payload:
            g = fh.create_group("Tracers")
            for k, v in payload["tracers"].items():
                g.create_dataset(k, data=v)
        _write_forcing(fh, payload.get("few_modes_ft"))


def write_restart_smr(fname, sim):
    """Write an ``SmrSimulation``'s checkpoint to ``fname``."""
    h5py = require_h5py()
    payload = restart_payload_smr(sim)
    os.makedirs(os.path.dirname(fname) or ".", exist_ok=True)
    with h5py.File(fname, "w") as fh:
        _info(fh, payload).attrs["Refined"] = 1
        fh.create_dataset("Input", data=sim.pin.to_string().encode())
        fh.create_dataset("Levels", data=payload["levels"])
        fh.create_dataset("LogicalLocations",
                          data=payload["logical_locations"])
        for lev, u in payload["state"].items():
            fh.create_dataset(f"cons_lev{lev}", data=u)
        if "tracers" in payload:
            g = fh.create_group("Tracers")
            g.create_dataset("n_lost", data=payload["tracers"]["n_lost"])
            for lev, st in payload["tracers"]["levels"].items():
                gl = g.create_group(f"lev{lev}")
                for k, v in st.items():
                    gl.create_dataset(k, data=v)
        if "deref_counts" in payload:
            counts = {json.dumps(k): v
                      for k, v in payload["deref_counts"].items()}
            fh.create_dataset("DerefCounts",
                              data=json.dumps(counts).encode())
        _write_forcing(fh, payload.get("few_modes_ft"))
        fh.create_dataset("OutputTriggers", data=payload["triggers"])


def read_restart(fname):
    """-> ``(pin, payload)`` of a ``.rhdf`` file of either package."""
    h5py = require_h5py()
    with h5py.File(fname, "r") as fh:
        pin = ParameterInput.from_string(fh["Input"][()].decode())
        if fh["Info"].attrs.get("Refined", 0):
            return pin, read_restart_smr_payload(fh)
        payload = dict(
            t=float(fh["Info"].attrs["Time"]),
            ncycle=int(fh["Info"].attrs["NCycle"]),
            dt=float(fh["Info"].attrs["dt"]),
            cons=fh["cons"][()],
            triggers=fh["OutputTriggers"][()]
            if "OutputTriggers" in fh else None)
        if "Tracers" in fh:
            payload["tracers"] = {k: fh["Tracers"][k][()]
                                  for k in fh["Tracers"]}
        _read_forcing(fh, payload)
    return pin, payload


def read_restart_smr_payload(fh):
    """The payload of an open refined-mesh restart file."""
    payload = dict(
        t=float(fh["Info"].attrs["Time"]),
        ncycle=int(fh["Info"].attrs["NCycle"]),
        dt=float(fh["Info"].attrs.get("dt", 0.0)),
        levels=fh["Levels"][()],
        logical_locations=fh["LogicalLocations"][()],
        state={int(k.split("cons_lev")[1]): fh[k][()]
               for k in fh if k.startswith("cons_lev")},
        triggers=fh["OutputTriggers"][()]
        if "OutputTriggers" in fh else None)
    if "DerefCounts" in fh:
        raw = json.loads(fh["DerefCounts"][()].decode())
        payload["deref_counts"] = {tuple(json.loads(k)): v
                                   for k, v in raw.items()}
    if "Tracers" in fh:
        g = fh["Tracers"]
        payload["tracers"] = {
            "n_lost": g["n_lost"][()],
            "levels": {int(k.split("lev")[1]): {f: g[k][f][()]
                                                for f in g[k]}
                       for k in g if k.startswith("lev")}}
    _read_forcing(fh, payload)
    return payload

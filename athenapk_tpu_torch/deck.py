"""What both drivers build from a deck beside the mesh, the package and the
problem: the cooling, the diffusion, the h5py check of the output blocks,
the tracer swarm of an hdf5 block, and a payload's tracers on the device.

The cooling (``<cooling> enable_cooling = tabular``) and the diffusion
(``<diffusion>``, Spitzer conduction through ``<units>``) are built from
``<units>`` and ``hydro/He_mass_fraction`` as the JAX driver builds them
(``athenapk_tpu/driver.py:66-95``).
"""

from __future__ import annotations

import numpy as np
import torch

from .diffusion import DiffusionConfig
from .outputs.hdf5 import require_h5py
from .srcterms.tabular_cooling import TabularCooling
from .utils.units import Units, mean_molecular_weights


def check_h5py(pin) -> None:
    """Import h5py now (an ImportError naming it) if the deck has an hdf5
    or rst output block, rather than at the run's first dump."""
    if any(pin.get_string(blk, "file_type") in ("hdf5", "rst")
           for blk in pin.output_blocks()):
        require_h5py()


def swarm_variables(pin, blk):
    """``{swarm: [variable]}`` of an hdf5 output block's ``swarms``
    (``swarms = tracers``, ``tracers_variables = id, x, y, z, rho``; the
    reference's ``docs/input.md:353-366``)."""
    out = {}
    for sname in pin.get_or_add_string(blk, "swarms", "").split():
        sname = sname.strip(",")
        if not sname:
            continue
        if sname != "tracers":
            raise ValueError(f"unknown swarm '{sname}' in {blk}")
        raw = pin.get_or_add_string(blk, f"{sname}_variables", "id, x, y, z")
        out[sname] = [v.strip() for v in raw.replace(",", " ").split()]
    return out


def tracers_to_device(tracers, device):
    """A payload's tracer arrays (numpy, or any array) as tensors on
    ``device``, dtypes kept."""
    return {k: torch.as_tensor(np.array(v), device=device)
            for k, v in tracers.items()}


def _units_and_mu(pin):
    """The deck's ``Units`` (or None without ``<units>``) and the mean
    molecular weight (None without ``<units>`` and
    ``hydro/He_mass_fraction``)."""
    units = Units(pin) if pin.has_block("units") else None
    mu = None
    if units is not None and pin.has("hydro", "He_mass_fraction"):
        mu, _ = mean_molecular_weights(
            pin.get_real("hydro", "He_mass_fraction"))
    return units, mu


def make_cooling(pin):
    """The deck's ``TabularCooling`` (``<cooling> enable_cooling =
    tabular``, built from ``<units>`` and ``hydro/He_mass_fraction``), or
    None."""
    if pin.get_or_add_string("cooling", "enable_cooling", "none") \
            != "tabular":
        return None
    units, mu = _units_and_mu(pin)
    if mu is None:
        raise ValueError("tabular cooling requires <units> block and "
                         "hydro/He_mass_fraction")
    he_x = pin.get_real("hydro", "He_mass_fraction")
    mbar_over_kb = mu * units.mh() / units.k_boltzmann()
    return TabularCooling(pin, units, pin.get_real("hydro", "gamma"), mu,
                          he_x, mbar_over_kb)


def make_diffusion(pin):
    """The deck's ``DiffusionConfig`` (all processes off without a
    ``<diffusion>`` block)."""
    units, mu = _units_and_mu(pin)
    return DiffusionConfig.from_parameter_input(pin, units=units, mu=mu)

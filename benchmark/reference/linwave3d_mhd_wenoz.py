"""Plain reference of ``linwave3d_mhd_wenoz``: the 3-D GLM-MHD linear wave
(a frozen copy of the port's ``pgen/linear_wave_mhd.py``) under the
plain RK3 + WENO-Z + HLLE cycle with the Dedner source
(``plain/solver/hydro.py``), and its control: the same in float32."""

from __future__ import annotations

import torch

from .plain.driver import PlainSim
from .plain.pgen import linear_wave_mhd as problem


def sim(deck, device, dtype=None):
    """The reference at the deck's precision (or ``dtype``)."""
    return PlainSim(deck, problem, device, dtype)


def control(deck, device):
    """The reference in float32, the precision below the deck's float64."""
    return PlainSim(deck, problem, device, torch.float32)

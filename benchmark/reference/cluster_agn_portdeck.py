"""Plain reference of ``cluster_agn_portdeck``: the galaxy cluster with
AGN feedback, SN Ia and stellar feedback and Townsend cooling (a frozen
copy of the port's ``pgen/cluster/``, ``srcterms/tabular_cooling.py`` and
``utils/`` under ``plain/``) on the plain VL2 + PLM + HLLD cycle with the
Dedner source (``plain/cluster_driver.py``), and its control.

The harness judges it with ``harness/compare.py:readings``: the
reference's ``next_dt`` is the least of the hyperbolic bound, the
cooling's dt and the accretion dt, so ``dt_err`` covers all three;
``PlainClusterSim.dt_limits`` gives them one by one."""

from __future__ import annotations

import torch

from .plain.cluster_driver import PlainClusterSim
from .plain.pgen.cluster import pgen as problem


def sim(deck, device, dtype=None):
    """The reference at the deck's precision (or ``dtype``)."""
    return PlainClusterSim(deck, problem, device, dtype)


def control(deck, device):
    """The reference in float32, the precision below the deck's float64;
    the cooling, its dt and the split source (stellar feedback and the
    clips) run in float64, for constants outside float32."""
    return PlainClusterSim(deck, problem, device, torch.float32,
                           wide=torch.float64)

"""Refined meshes, static and adaptive: leaf geometry, ghost fill,
stepping, remesh and the time loop (counterpart of ``athenapk_tpu/amr``)."""

from .smr import SmrMesh, SmrState  # noqa: F401
from .smr_hydro import SmrHydro  # noqa: F401

"""Adaptive-mesh tagging criteria (torch): per-block refine / same /
derefine decisions from primitive fields.

Counterpart of ``athenapk_tpu/refinement/criteria.py`` (reference
``src/refinement/gradient.cpp`` and ``other.cpp``), operation for operation
(``0.5 * (a - b)`` central differences, squares, ``sqrt(eps2) / p``, the
0.25 and 0.5 derefinement factors), so that the tags in f64 equal the JAX
package's.  Tags: +1 refine, 0 same, -1 derefine (the reference's
``AmrTag``), an int32 tensor on the state's device: one reduction per
block, no host read.

Each criterion is split into the per-block value it thresholds
(``*_max``) and the tags; the values let tests and diagnostics read how
far a block sits from its threshold.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core.ieee import sqrt
from ..core.indices import IDN, IPR, IV1, IV2


@dataclasses.dataclass(frozen=True)
class RefinementConfig:
    # pressure_gradient | xyvelocity_gradient | maxdensity | none
    method: str = "none"
    threshold_pressure_gradient: float = 0.0
    threshold_xyvelocity_gradient: float = 0.0
    maxdensity_refine_above: float = 0.0
    maxdensity_deref_below: float = 0.0

    @classmethod
    def from_parameter_input(cls, pin):
        if not pin.has("refinement", "type"):
            return cls()
        method = pin.get_string("refinement", "type")
        kw = dict(method=method)
        if method == "pressure_gradient":
            kw["threshold_pressure_gradient"] = pin.get_real(
                "refinement", "threshold_pressure_gradient")
        elif method == "xyvelocity_gradient":
            kw["threshold_xyvelocity_gradient"] = pin.get_real(
                "refinement", "threshold_xyvelocity_gradient")
        elif method == "maxdensity":
            kw["maxdensity_refine_above"] = pin.get_real(
                "refinement", "maxdensity_refine_above")
            kw["maxdensity_deref_below"] = pin.get_real(
                "refinement", "maxdensity_deref_below")
        elif method != "none":
            raise ValueError(f"unknown refinement type '{method}'")
        return cls(**kw)


def _interior_p1(mesh):
    """Interior extended by one cell (the criteria sample +-1 rings)."""
    ks, ke, js, je, is_, ie = mesh.interior
    return (slice(None), slice(max(ks - 1, 0), ke + 2),
            slice(max(js - 1, 0), je + 2), slice(is_ - 1, ie + 2))


def _tags(value, refine_above, deref_below):
    """+1 above ``refine_above``, else -1 below ``deref_below``, else 0."""
    tags = torch.zeros_like(value, dtype=torch.int32)
    return tags.masked_fill_(value < deref_below, -1).masked_fill_(
        value > refine_above, 1)


def pressure_gradient_max(prim, mesh):
    """max |grad P| / P per block (``gradient.cpp:18-61``)."""
    p = prim[:, IPR]
    dpx = 0.5 * (torch.roll(p, -1, -1) - torch.roll(p, 1, -1))
    eps2 = dpx ** 2
    if mesh.nx2 > 1:
        eps2 = eps2 + (0.5 * (torch.roll(p, -1, -2)
                              - torch.roll(p, 1, -2))) ** 2
    if mesh.nx3 > 1:
        eps2 = eps2 + (0.5 * (torch.roll(p, -1, -3)
                              - torch.roll(p, 1, -3))) ** 2
    eps = sqrt(eps2) / p
    return torch.amax(eps[_interior_p1(mesh)], dim=(1, 2, 3))


def pressure_gradient(prim, mesh, threshold):
    return _tags(pressure_gradient_max(prim, mesh), threshold,
                 0.25 * threshold)


def xyvelocity_gradient_max(prim, mesh):
    """max sqrt((d_x v2)^2 + (d_y v1)^2) per block (``gradient.cpp:64``)."""
    v1 = prim[:, IV1]
    v2 = prim[:, IV2]
    vgy = torch.abs(torch.roll(v2, -1, -1) - torch.roll(v2, 1, -1)) * 0.5
    vgx = torch.abs(torch.roll(v1, -1, -2) - torch.roll(v1, 1, -2)) * 0.5
    vg = sqrt(vgx ** 2 + vgy ** 2)
    ks, ke, js, je, is_, ie = mesh.interior
    sel = (slice(None), slice(ks, ke + 1),
           slice(max(js - 1, 0), je + 2), slice(is_ - 1, ie + 2))
    return torch.amax(vg[sel], dim=(1, 2, 3))


def xyvelocity_gradient(prim, mesh, threshold):
    return _tags(xyvelocity_gradient_max(prim, mesh), threshold,
                 0.5 * threshold)


def maxdensity_max(prim, mesh):
    """max rho per block over the interior (``other.cpp:18``)."""
    sl = mesh.interior_slices
    rho = prim[:, IDN][(sl[0],) + tuple(sl[2:])]
    return torch.amax(rho, dim=(1, 2, 3))


def maxdensity(prim, mesh, refine_above, deref_below):
    return _tags(maxdensity_max(prim, mesh), refine_above, deref_below)


def check_refinement(cfg: RefinementConfig, prim, mesh):
    """-> [nblocks] int32 tags on ``prim``'s device; 0s when no criterion is
    configured."""
    if cfg.method == "pressure_gradient":
        return pressure_gradient(prim, mesh, cfg.threshold_pressure_gradient)
    if cfg.method == "xyvelocity_gradient":
        return xyvelocity_gradient(prim, mesh,
                                   cfg.threshold_xyvelocity_gradient)
    if cfg.method == "maxdensity":
        return maxdensity(prim, mesh, cfg.maxdensity_refine_above,
                          cfg.maxdensity_deref_below)
    return torch.zeros(prim.shape[0], dtype=torch.int32, device=prim.device)

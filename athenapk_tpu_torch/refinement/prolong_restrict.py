"""Prolongation / restriction operators for coarse<->fine block transfers
(torch).

Counterpart of ``athenapk_tpu/refinement/prolong_restrict.py`` (reference
``src/hydro/prolongation/custom_ops.hpp:49-190`` and Parthenon's
``RestrictAverage``), operation for operation, so the two agree bitwise:

* ``restrict_average``: fine -> coarse by averaging 2^d children, one
  pair ``0.5 * (a + b)`` per active axis (x, then y, then z).
* ``prolongate_minmod``: coarse -> fine with minmod-limited linear slopes
  (Stone et al. 2020 eq 5) and the reference's multi-D simultaneous
  limiter (``custom_ops.hpp:120-158``): every slope is scaled by one
  ``alpha = min(1, (qmax - fc)/dqmax, (fc - qmin)/dqmax)`` with
  ``dqmax = sum_d |s_d|/4`` and qmin/qmax over the 3^d coarse
  neighbourhood; each fine value is ``fc + (sum of signed offsets)``, the
  offsets grouped before the add (the reference's FP-symmetry grouping,
  ``custom_ops.hpp:160-184``).

Both work on whole tensors ``[..., nz, ny, nx]``; neighbour lookups are
cyclic rolls, so wrapped values land only outside the region a caller
keeps (the sweep kernels' contract).
"""

from __future__ import annotations

import itertools

import torch


def _minmod(a, b):
    return torch.where(a * b > 0.0,
                       torch.where(torch.abs(a) < torch.abs(b), a, b), 0.0)


def _interleave(lo, hi, ax):
    """Interleave along axis ``ax`` (negative): [lo0, hi0, lo1, hi1, ...]."""
    pair_ax = lo.dim() + ax + 1   # just after ax
    stacked = torch.stack([lo, hi], dim=pair_ax)
    shape = list(lo.shape)
    shape[ax] = shape[ax] * 2
    return stacked.reshape(shape)


def restrict_average(q, dims=3):
    """[..., 2nz, 2ny, 2nx] -> [..., nz, ny, nx] (or fewer active dims)."""
    for k in range(1, dims + 1):
        ax = q.dim() - k          # x, then y, then z
        n = q.shape[ax]
        shape = q.shape[:ax] + (n // 2, 2) + q.shape[ax + 1:]
        q = 0.5 * torch.sum(q.reshape(shape), dim=ax + 1)
    return q


def prolongate_minmod(q, dims=3):
    """[..., nz, ny, nx] -> doubled along each active dim (minmod slopes,
    the simultaneous alpha limiter, grouped offsets)."""
    axes = [-1, -2, -3][:dims]
    slopes = {ax: _minmod(torch.roll(q, -1, ax) - q, q - torch.roll(q, 1, ax))
              for ax in axes}
    contrib = {ax: slopes[ax] / 4.0 for ax in axes}
    if dims > 1:
        # largest possible |fine - fc| if every slope pushes one way (the
        # sum starts from 0, as Python's sum over the JAX arrays does)
        dqmax = 0
        for c in contrib.values():
            dqmax = dqmax + torch.abs(c)
        # min/max over the 3^d coarse neighbourhood, one axis at a time
        qmin = q
        qmax = q
        for ax in axes:
            qmin = torch.minimum(torch.minimum(torch.roll(qmin, -1, ax), qmin),
                                 torch.roll(qmin, 1, ax))
            qmax = torch.maximum(torch.maximum(torch.roll(qmax, -1, ax), qmax),
                                 torch.roll(qmax, 1, ax))
        # one factor limits all slopes; dqmax = 0 (flat) keeps alpha = 1
        safe = torch.where(dqmax > 0.0, dqmax, 1.0)
        alpha = torch.clamp(torch.minimum((qmax - q) / safe,
                                          (q - qmin) / safe), max=1.0)
        contrib = {ax: alpha * c for ax, c in contrib.items()}
    corners = {}
    for signs in itertools.product((-1, 1), repeat=dims):
        off = None
        for s, ax in zip(signs, axes):
            t = contrib[ax] if s > 0 else -contrib[ax]
            off = t if off is None else off + t
        corners[signs] = q + off
    # assemble the fine tensor by interleaving one axis at a time
    for pos, ax in enumerate(axes):
        nxt = {}
        for key in corners:
            if key[pos] != -1:
                continue
            hi_key = key[:pos] + (1,) + key[pos + 1:]
            rest = key[:pos] + (0,) + key[pos + 1:]
            nxt[rest] = _interleave(corners[key], corners[hi_key], ax)
        corners = nxt
    return corners[(0,) * dims]

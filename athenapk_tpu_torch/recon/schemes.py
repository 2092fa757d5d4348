"""Reconstruction schemes over whole block-batched tensors (torch).

Counterpart of ``athenapk_tpu/recon/schemes.py``.  Each scheme maps cell
averages ``q`` to per-cell edge values ``(qm, qp)`` along one axis:

* ``qm[i]`` = value at the left face of cell i  (the reference's ``qr_i``)
* ``qp[i]`` = value at the right face of cell i (the reference's ``ql_ip1``)

so the Riemann state at face i+1/2 is ``L = qp[i]``, ``R = qm[i+1]``.
Shifts are ``torch.roll`` (the semantics of ``jnp.roll``): on the
ghost-free layout the wrap IS the periodic boundary; on ghosted layouts the
wrapped values only land in the ghost rim.

  dc  — donor cell, ``src/recon/dc_simple.hpp``
  plm — piecewise linear, van-Leer limiter, ``src/recon/plm_simple.hpp``
  ppm — PPM with the Colella–Sekora 2008 extrema-preserving limiter,
        ``src/recon/ppm_simple.hpp``

``weno3``, ``limo3`` and ``wenoz`` are not ported yet.
"""

from __future__ import annotations

import torch


def _sh(q, n, axis):
    """shifted view: _sh(q, n)[i] == q[i+n]."""
    return torch.roll(q, -n, dims=axis)


def _sgn(x):
    """sign with sgn(0) = +1 (and sgn(-0.0) = +1), as the reference's
    SIGN; ``copysign`` would give -1 for -0.0."""
    return (x >= 0.0).to(x.dtype) * 2.0 - 1.0


# --------------------------------------------------------------------------- dc
def dc(q, axis, dx):
    return q, q


# -------------------------------------------------------------------------- plm
def plm(q, axis, dx):
    qm1 = _sh(q, -1, axis)
    qp1 = _sh(q, +1, axis)
    dql = q - qm1
    dqr = qp1 - q
    dq2 = dql * dqr
    denom = torch.where(dq2 > 0.0, dql + dqr, 1.0)
    dqm = torch.where(dq2 > 0.0, dq2 / denom, 0.0)
    return q - dqm, q + dqm


# -------------------------------------------------------------------------- ppm
def ppm(q, axis, dx):
    """PPM with CS08 smooth-extrema-preserving limiter (uniform grid);
    ``src/recon/ppm_simple.hpp:38-164`` (CW84 eq 1.6, CD11 eqs 84-85,
    CS08 eqs 22-25, MC11 eq 27)."""
    C2 = 1.25
    qm2 = _sh(q, -2, axis)
    qm1 = _sh(q, -1, axis)
    qp1 = _sh(q, +1, axis)
    qp2 = _sh(q, +2, axis)
    sgn = _sgn

    qa0 = q - qm1
    qb0 = qp1 - q
    dd_im1 = 0.5 * qa0 + 0.5 * (qm1 - qm2)
    dd = 0.5 * qb0 + 0.5 * qa0
    dd_ip1 = 0.5 * (qp2 - qp1) + 0.5 * qb0

    # interface averages (CW eq 1.6)
    dph = 0.5 * (qm1 + q) + (dd_im1 - dd) / 6.0
    dph_ip1 = 0.5 * (q + qp1) + (dd - dd_ip1) / 6.0

    d2qc_im1 = qm2 + q - 2.0 * qm1
    d2qc = qm1 + qp1 - 2.0 * q
    d2qc_ip1 = q + qp2 - 2.0 * qp1

    # limit i-1/2 face value at local extrema (CD 4.3.1)
    qa_t = dph - qm1
    qb_t = q - dph
    qa = 3.0 * (qm1 + q - 2.0 * dph)
    qb = d2qc_im1
    qc = d2qc
    same = (sgn(qa) == sgn(qb)) & (sgn(qa) == sgn(qc))
    qd = torch.where(
        same,
        sgn(qa) * torch.minimum(C2 * torch.abs(qb),
                                torch.minimum(C2 * torch.abs(qc),
                                              torch.abs(qa))),
        0.0)
    dph = torch.where(qa_t * qb_t < 0.0, 0.5 * (qm1 + q) - qd / 6.0, dph)

    # limit i+1/2 face value
    qa_t = dph_ip1 - q
    qb_t = qp1 - dph_ip1
    qa = 3.0 * (q + qp1 - 2.0 * dph_ip1)
    qb = d2qc
    qc = d2qc_ip1
    same = (sgn(qa) == sgn(qb)) & (sgn(qa) == sgn(qc))
    qd = torch.where(
        same,
        sgn(qa) * torch.minimum(C2 * torch.abs(qb),
                                torch.minimum(C2 * torch.abs(qc),
                                              torch.abs(qa))),
        0.0)
    dph_ip1 = torch.where(qa_t * qb_t < 0.0, 0.5 * (q + qp1) - qd / 6.0,
                          dph_ip1)

    d2qf = 6.0 * (dph + dph_ip1 - 2.0 * q)

    qm = dph        # left edge candidate
    qp = dph_ip1    # right edge candidate

    dqf_minus = q - qm      # (CS eq 25)
    dqf_plus = qp - q

    extrema = (dqf_minus * dqf_plus <= 0.0) | ((qp1 - q) * (q - qm1) <= 0.0)

    qa = d2qc_im1
    qb = d2qc
    qc = d2qc_ip1
    qd = d2qf
    same = ((sgn(qa) == sgn(qb)) & (sgn(qa) == sgn(qc))
            & (sgn(qa) == sgn(qd)))
    qe = torch.where(
        same,
        sgn(qd) * torch.minimum(
            torch.minimum(C2 * torch.abs(qa), C2 * torch.abs(qb)),
            torch.minimum(C2 * torch.abs(qc), torch.abs(qd))),
        0.0)  # (CS eq 22)

    # roundoff guard for the limited second-derivative ratio (MC eq 27)
    mag_m = torch.maximum(torch.abs(qm1), torch.abs(qm2))
    mag_p = torch.maximum(torch.maximum(torch.abs(q), torch.abs(qp1)),
                          torch.abs(qp2))
    big = torch.abs(qd) > 1.0e-12 * torch.maximum(mag_m, mag_p)
    rho = torch.where(big, qe / torch.where(big, qd, 1.0), 0.0)

    tmp_m = q - rho * dqf_minus   # (CS eq 23)
    tmp_p = q + rho * dqf_plus
    tmp2_m = q - 2.0 * dqf_plus
    tmp2_p = q + 2.0 * dqf_minus

    limit_sm = rho <= (1.0 - 1.0e-12)
    qm = torch.where(extrema & limit_sm, tmp_m, qm)
    qp = torch.where(extrema & limit_sm, tmp_p, qp)

    over_m = torch.abs(dqf_minus) >= 2.0 * torch.abs(dqf_plus)
    over_p = torch.abs(dqf_plus) >= 2.0 * torch.abs(dqf_minus)
    qm = torch.where(~extrema & over_m, tmp2_m, qm)
    qp = torch.where(~extrema & over_p, tmp2_p, qp)

    return qm, qp


RECONSTRUCTIONS = {
    "dc": dc,
    "plm": plm,
    "ppm": ppm,
}

_NOT_PORTED = ("weno3", "limo3", "wenoz")

# ghost zones needed (reference ``recon_need_nghost``: dc/plm/weno3/limo3 -> 2,
# ppm/wenoz -> 3)
_NGHOST = {"dc": 2, "plm": 2, "weno3": 2, "limo3": 2, "ppm": 3, "wenoz": 3}


def nghost_for(recon: str) -> int:
    return _NGHOST[recon]


def reconstruct(recon: str, q, axis, dx, positivity_mask=None):
    """Dispatch; q is [..., nvar, nz, ny, nx], axis in {-3,-2,-1} or
    absolute.  ``positivity_mask`` serves limo3 only (not ported yet)."""
    if recon in _NOT_PORTED:
        raise NotImplementedError(
            f"reconstruction '{recon}' is not ported to athenapk_tpu_torch "
            f"yet (ported: {', '.join(RECONSTRUCTIONS)}; still to port: "
            f"{', '.join(_NOT_PORTED)})")
    if recon not in RECONSTRUCTIONS:
        raise ValueError(f"unknown reconstruction '{recon}'")
    return RECONSTRUCTIONS[recon](q, axis, dx)

# A frozen copy of athenapk_tpu_torch/recon/schemes.py for the benchmark's plain
# reference (uniform meshes only); it imports nothing of the program.
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
  weno3 — third-order WENO with the Yamaleev–Carpenter 2009 indicators,
        ``src/recon/weno3_simple.hpp``
  limo3 — Čada–Torrilhon 2009 third-order limiter, with the minmod fallback
        for the fields named by ``positivity_mask`` (density and pressure),
        ``src/recon/limo3_simple.hpp``
  wenoz — WENO-Z+ (Del Zanna 2007 indicators, Acker 2016 weights),
        ``src/recon/wenoz_simple.hpp``

The dtype-aware constants are the JAX package's (LimO3's switch width
``10 eps(dtype)``, WENO-Z's ``epsL``), and each formula keeps its operation
order: the CUDA kernels (``csrc/hydro_device.cuh``) transcribe these
functions operation by operation.
"""

from __future__ import annotations

import torch

from ..core.indices import IDN, IPR


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


# ------------------------------------------------------------------------ weno3
def weno3_dx2(dx):
    """WENO3's regulariser dx^2 (a Python float, as the kernels take it)."""
    return dx * dx


def weno3(q, axis, dx):
    qm1 = _sh(q, -1, axis)
    qp1 = _sh(q, +1, axis)
    dx2 = weno3_dx2(dx)

    beta0 = (qp1 - q) ** 2
    beta1 = (q - qm1) ** 2
    tau = (qp1 - 2.0 * q + qm1) ** 2  # YC09 eq 22

    ind0 = tau / (beta0 + dx2)
    ind1 = tau / (beta1 + dx2)

    # right edge (qL_{i+1/2})
    f0 = q + qp1
    f1 = -qm1 + 3.0 * q
    a0 = (1.0 + ind0) * (2.0 / 3.0)
    a1 = (1.0 + ind1) / 3.0
    qp = (a0 * f0 + a1 * f1) / (2.0 * (a0 + a1))

    # left edge (qR_{i-1/2}) — mirrored stencil
    f0 = q + qm1
    f1 = -qp1 + 3.0 * q
    a0 = (1.0 + ind1) * (2.0 / 3.0)
    a1 = (1.0 + ind0) / 3.0
    qm = (a0 * f0 + a1 * f1) / (2.0 * (a0 + a1))

    return qm, qp


# ------------------------------------------------------------------------ limo3
_TINY = 1.0e-20  # Athena TINY_NUMBER in the CT09 theta ratio


def limo3_eps(dtype):
    """Half-width of LimO3's asymptotic-region switch: 10 eps of the dtype
    (with the reference's fixed 10 eps(f64), an f32 run could not represent
    1 +- eps and the smooth blend would degenerate to a hard jump)."""
    return 10.0 * torch.finfo(dtype).eps


def limo3_rdx2(dx):
    """(r dx)^2 with LimO3's r = 0.1: the scale of its smoothness measure
    eta (a Python float, as the kernels take it)."""
    r = 0.1
    return (r * dx) ** 2


def _limo3_phi(dvp, dvm, dx):
    """CT09 third-order limiter with the asymptotic-region switch (eqs 2.8,
    3.13, 3.17, 3.22); ``src/recon/limo3_simple.hpp``."""
    eps = limo3_eps(dvp.dtype)
    theta = dvm / (dvp + _TINY)
    qq = (2.0 + theta) / 3.0
    phi = torch.clamp(
        torch.minimum(qq, torch.maximum(-0.5 * theta, torch.minimum(
            2.0 * theta, torch.clamp(qq, max=1.6)))), min=0.0)
    eta = (dvm * dvm + dvp * dvp) / limo3_rdx2(dx)
    blend = 0.5 * ((1.0 - (eta - 1.0) / eps) * qq
                   + (1.0 + (eta - 1.0) / eps) * phi)
    return torch.where(eta <= 1.0 - eps, qq,
                       torch.where(eta >= 1.0 + eps, phi, blend))


def _minmod(a, b):
    return torch.where(a * b > 0.0,
                       torch.where(torch.abs(a) < torch.abs(b), a, b), 0.0)


def limo3(q, axis, dx, positivity_mask=None):
    """LimO3; ``positivity_mask`` is a per-variable bool sequence [nvar]
    marking the fields (rho, p) whose edge values fall back to minmod where
    either edge of the cell goes non-positive (the reference's
    ``ensure_positivity`` for IDN/IPR).  The variable axis is ``ndim - 4``."""
    qm1 = _sh(q, -1, axis)
    qp1 = _sh(q, +1, axis)
    dqp = qp1 - q
    dqm = q - qm1
    qp = q + 0.5 * dqp * _limo3_phi(dqp, dqm, dx)
    qm = q - 0.5 * dqm * _limo3_phi(dqm, dqp, dx)

    if positivity_mask is not None:
        vax = q.dim() - 4
        for v, m in enumerate(positivity_mask):
            if not m:
                continue
            pick = lambda t: t.select(vax, v)   # noqa: E731
            dqmm = _minmod(pick(dqp), pick(dqm))
            qv, qpv, qmv = pick(q), pick(qp), pick(qm)
            bad = (qpv <= 0.0) | (qmv <= 0.0)
            qpv.copy_(torch.where(bad, qv + 0.5 * dqmm, qpv))
            qmv.copy_(torch.where(bad, qv - 0.5 * dqmm, qmv))
    return qm, qp


# ------------------------------------------------------------------------ wenoz
def wenoz_eps(dtype):
    """WENO-Z's ``epsL``: the reference's 1e-42 is below f32's range and
    1e-30 lets ``ind**2`` overflow f32, so 1e-30 in f64 and 1e-18 in f32."""
    return 1.0e-30 if dtype == torch.float64 else 1.0e-18


def wenoz(q, axis, dx):
    """WENO-Z+ (Del Zanna 2007 smoothness indicators, Acker 2016 weights);
    ``src/recon/wenoz_simple.hpp``."""
    qm2 = _sh(q, -2, axis)
    qm1 = _sh(q, -1, axis)
    qp1 = _sh(q, +1, axis)
    qp2 = _sh(q, +2, axis)

    b_hi = 13.0 / 12.0
    b_lo = 0.25
    beta0 = (b_hi * (qm2 + q - 2.0 * qm1) ** 2
             + b_lo * (qm2 + 3.0 * q - 4.0 * qm1) ** 2)
    beta1 = b_hi * (qm1 + qp1 - 2.0 * q) ** 2 + b_lo * (qm1 - qp1) ** 2
    beta2 = (b_hi * (qp2 + q - 2.0 * qp1) ** 2
             + b_lo * (qp2 + 3.0 * q - 4.0 * qp1) ** 2)

    epsL = wenoz_eps(q.dtype)
    tau5 = torch.abs(beta0 - beta2)
    ind0 = tau5 / (beta0 + epsL)
    ind1 = tau5 / (beta1 + epsL)
    ind2 = tau5 / (beta2 + epsL)

    # right edge
    f0 = 2.0 * qm2 - 7.0 * qm1 + 11.0 * q
    f1 = -qm1 + 5.0 * q + 2.0 * qp1
    f2 = 2.0 * q + 5.0 * qp1 - qp2
    a0 = 0.1 * (1.0 + ind0 * ind0)
    a1 = 0.6 * (1.0 + ind1 * ind1)
    a2 = 0.3 * (1.0 + ind2 * ind2)
    qp = (f0 * a0 + f1 * a1 + f2 * a2) / (6.0 * (a0 + a1 + a2))

    # left edge — mirrored
    f0 = 2.0 * qp2 - 7.0 * qp1 + 11.0 * q
    f1 = -qp1 + 5.0 * q + 2.0 * qm1
    f2 = 2.0 * q + 5.0 * qm1 - qm2
    a0 = 0.1 * (1.0 + ind2 * ind2)
    a1 = 0.6 * (1.0 + ind1 * ind1)
    a2 = 0.3 * (1.0 + ind0 * ind0)
    qm = (f0 * a0 + f1 * a1 + f2 * a2) / (6.0 * (a0 + a1 + a2))

    return qm, qp


RECONSTRUCTIONS = {
    "dc": dc,
    "plm": plm,
    "ppm": ppm,
    "weno3": weno3,
    "limo3": limo3,
    "wenoz": wenoz,
}

# ghost zones needed (reference ``recon_need_nghost``: dc/plm/weno3/limo3 -> 2,
# ppm/wenoz -> 3)
_NGHOST = {"dc": 2, "plm": 2, "weno3": 2, "limo3": 2, "ppm": 3, "wenoz": 3}


def nghost_for(recon: str) -> int:
    return _NGHOST[recon]


def positivity_mask(nvar):
    """The static mask of the fields LimO3 keeps positive: density and
    pressure (the JAX package's ``HydroPackage._positivity_mask``)."""
    return tuple(v in (IDN, IPR) for v in range(nvar))


def reconstruct(recon: str, q, axis, dx, positivity_mask=None):
    """Dispatch; q is [..., nvar, nz, ny, nx], axis in {-3,-2,-1} or
    absolute.  ``positivity_mask`` serves limo3 only."""
    if recon not in RECONSTRUCTIONS:
        raise ValueError(f"unknown reconstruction '{recon}'")
    if recon == "limo3":
        return limo3(q, axis, dx, positivity_mask=positivity_mask)
    return RECONSTRUCTIONS[recon](q, axis, dx)

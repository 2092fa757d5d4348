# A frozen copy of athenapk_tpu_torch/riemann/solvers.py for the benchmark's plain
# reference (uniform meshes only); it imports nothing of the program.
"""Riemann solvers for Euler and GLM-MHD over face tensors (torch).

Counterpart of ``athenapk_tpu/riemann/solvers.py``: every solver is a
branch-free ``torch.where`` lattice over whole face-state tensors.  This
is the plain PyTorch version; the HLLD solver also lives, as scalar code,
in the CUDA sweep kernel (``csrc/negdiv_sweep.cu``), which must stay
numerically in step with it.

Interface: ``solve_riemann(solver, fluid, eos, wl, wr, dirn, c_h, nscalars)``
where ``wl``/``wr`` are primitive L/R states at faces co-indexed with cells
(index i holds face i-1/2), laid out ``[..., nvar, nz, ny, nx]``.

Algorithms:
  hydro llf   — Rusanov; ``src/hydro/rsolvers/hydro_dc_llf.hpp:43``
  hydro hlle  — HLLE with Roe-averaged wave bounds; ``hydro_hlle.hpp:40``
  hydro hllc  — Toro 10.5.2 PVRS middle state; ``hydro_hllc.hpp:32``
  mhd llf     — Rusanov with fast-speed bound; ``glmmhd_dc_llf.hpp:46``
  mhd hlle    — HLLE with Roe-averaged fast-speed bounds; ``glmmhd_hlle.hpp:27``
  mhd hlld    — Miyoshi & Kusano (2005); ``glmmhd_hlld.hpp:39``

GLM: the psi/Bn 2x2 subsystem is solved analytically with speed ``c_h``
(Dedner et al. 2002 eq 42).
"""

from __future__ import annotations

import torch

from ..core.ieee import sqrt
from ..core.indices import (IDN, IV1, IV2, IV3, IPR, IB1, IB2, IB3, IPS,
                            IEN, NHYDRO, NGLMMHD, EULER, GLMMHD)
from ..eos.adiabatic import EOS, fast_magnetosonic_speed

TINY = 1.0e-20    # Athena TINY_NUMBER
SMALL = 1.0e-4    # Athena SMALL_NUMBER (HLLD degeneracy guard)

# velocity / B component permutations per direction (1=x, 2=y, 3=z)
_VPERM = {1: (IV1, IV2, IV3), 2: (IV2, IV3, IV1), 3: (IV3, IV1, IV2)}
_BPERM = {1: (IB1, IB2, IB3), 2: (IB2, IB3, IB1), 3: (IB3, IB1, IB2)}

VALID_SOLVERS = {
    EULER: ("llf", "hlle", "hllc", "none"),
    GLMMHD: ("llf", "hlle", "hlld", "none"),
}


def _var(w, idx):
    return w[..., idx, :, :, :]


def _scatter(fluxes_by_global_idx, nvar):
    """Assemble [..., nvar, nz, ny, nx] from {global_var_idx: flux}."""
    return torch.stack([fluxes_by_global_idx[n] for n in range(nvar)],
                       dim=-4)


def _scalar_fluxes(fd, wl, wr, nbase, nscalars):
    """Upwind passive-scalar fluxes from the mass flux
    (reference ``src/hydro/hydro.cpp:1089-1097``)."""
    out = {}
    for n in range(nbase, nbase + nscalars):
        out[n] = torch.where(fd >= 0.0, fd * _var(wl, n), fd * _var(wr, n))
    return out


# =========================================================================
# Euler solvers
# =========================================================================
def _euler_faces(eos: EOS, wl, wr, dirn):
    ivx, ivy, ivz = _VPERM[dirn]
    dl, dr = _var(wl, IDN), _var(wr, IDN)
    vxl, vxr = _var(wl, ivx), _var(wr, ivx)
    vyl, vyr = _var(wl, ivy), _var(wr, ivy)
    vzl, vzr = _var(wl, ivz), _var(wr, ivz)
    pl, pr = _var(wl, IPR), _var(wr, IPR)
    el = pl / eos.gm1 + 0.5 * dl * (vxl * vxl + vyl * vyl + vzl * vzl)
    er = pr / eos.gm1 + 0.5 * dr * (vxr * vxr + vyr * vyr + vzr * vzr)
    return (dl, vxl, vyl, vzl, pl, el), (dr, vxr, vyr, vzr, pr, er)


def _euler_llf(eos, wl, wr, dirn):
    (dl, vxl, vyl, vzl, pl, el), (dr, vxr, vyr, vzr, pr, er) = \
        _euler_faces(eos, wl, wr, dirn)
    qa = dl * vxl
    qb = dr * vxr
    fsum_d = qa + qb
    fsum_mx = qa * vxl + qb * vxr + (pl + pr)
    fsum_my = qa * vyl + qb * vyr
    fsum_mz = qa * vzl + qb * vzr
    fsum_e = (el + pl) * vxl + (er + pr) * vxr
    cl = sqrt(eos.gamma * pl / dl)
    cr = sqrt(eos.gamma * pr / dr)
    a = torch.maximum(torch.abs(vxl) + cl, torch.abs(vxr) + cr)
    fd = 0.5 * (fsum_d - a * (dr - dl))
    fmx = 0.5 * (fsum_mx - a * (dr * vxr - dl * vxl))
    fmy = 0.5 * (fsum_my - a * (dr * vyr - dl * vyl))
    fmz = 0.5 * (fsum_mz - a * (dr * vzr - dl * vzl))
    fe = 0.5 * (fsum_e - a * (er - el))
    return fd, fmx, fmy, fmz, fe


def _hlle_weight(bp, bm):
    """0.5 (bp + bm) / (bp - bm), or 0 where bp == bm."""
    ne = bp != bm
    return torch.where(ne, 0.5 * (bp + bm) / torch.where(ne, bp - bm, 1.0),
                       0.0)


def _euler_hlle(eos, wl, wr, dirn):
    (dl, vxl, vyl, vzl, pl, el), (dr, vxr, vyr, vzr, pr, er) = \
        _euler_faces(eos, wl, wr, dirn)
    # Roe averages
    sqrtdl = sqrt(dl)
    sqrtdr = sqrt(dr)
    isdlpdr = 1.0 / (sqrtdl + sqrtdr)
    v1roe = (sqrtdl * vxl + sqrtdr * vxr) * isdlpdr
    v2roe = (sqrtdl * vyl + sqrtdr * vyr) * isdlpdr
    v3roe = (sqrtdl * vzl + sqrtdr * vzr) * isdlpdr
    hroe = ((el + pl) / sqrtdl + (er + pr) / sqrtdr) * isdlpdr
    cl = sqrt(eos.gamma * pl / dl)
    cr = sqrt(eos.gamma * pr / dr)
    q = hroe - 0.5 * (v1roe * v1roe + v2roe * v2roe + v3roe * v3roe)
    a = torch.where(q < 0.0, 0.0,
                    sqrt(eos.gm1 * torch.clamp(q, min=0.0)))
    al = torch.minimum(v1roe - a, vxl - cl)
    ar = torch.maximum(v1roe + a, vxr + cr)
    bp = torch.where(ar > 0.0, ar, TINY)
    bm = torch.where(al < 0.0, al, TINY)

    uxl = vxl - bm
    uxr = vxr - bp
    fld = dl * uxl
    frd = dr * uxr
    flmx = dl * vxl * uxl + pl
    frmx = dr * vxr * uxr + pr
    flmy = dl * vyl * uxl
    frmy = dr * vyr * uxr
    flmz = dl * vzl * uxl
    frmz = dr * vzr * uxr
    fle = el * uxl + pl * vxl
    fre = er * uxr + pr * vxr

    tmp = _hlle_weight(bp, bm)
    fd = 0.5 * (fld + frd) + (fld - frd) * tmp
    fmx = 0.5 * (flmx + frmx) + (flmx - frmx) * tmp
    fmy = 0.5 * (flmy + frmy) + (flmy - frmy) * tmp
    fmz = 0.5 * (flmz + frmz) + (flmz - frmz) * tmp
    fe = 0.5 * (fle + fre) + (fle - fre) * tmp
    return fd, fmx, fmy, fmz, fe


def _euler_hllc(eos, wl, wr, dirn):
    (dl, vxl, vyl, vzl, pl, el), (dr, vxr, vyr, vzr, pr, er) = \
        _euler_faces(eos, wl, wr, dirn)
    cl = sqrt(eos.gamma * pl / dl)
    cr = sqrt(eos.gamma * pr / dr)
    # PVRS middle pressure (Toro 10.5.2)
    rhoa = 0.5 * (dl + dr)
    ca = 0.5 * (cl + cr)
    pmid = 0.5 * (pl + pr + (vxl - vxr) * rhoa * ca)
    g = eos.gamma
    ql = torch.where(pmid <= pl, 1.0,
                     sqrt(1.0 + (g + 1.0) / (2.0 * g)
                                * (pmid / pl - 1.0)))
    qr = torch.where(pmid <= pr, 1.0,
                     sqrt(1.0 + (g + 1.0) / (2.0 * g)
                                * (pmid / pr - 1.0)))
    al = vxl - cl * ql
    ar = vxr + cr * qr
    bp = torch.where(ar > 0.0, ar, TINY)
    bm = torch.where(al < 0.0, al, -TINY)

    # contact speed & pressure
    uxl = vxl - al
    uxr = vxr - ar
    tl = pl + uxl * dl * vxl
    tr = pr + uxr * dr * vxr
    ml = dl * uxl
    mr = -(dr * uxr)
    am = (tl - tr) / (ml + mr)
    cp = torch.clamp((ml * tr + mr * tl) / (ml + mr), min=0.0)

    uxl = vxl - bm
    uxr = vxr - bp
    fld = dl * uxl
    frd = dr * uxr
    flmx = dl * vxl * uxl + pl
    frmx = dr * vxr * uxr + pr
    flmy = dl * vyl * uxl
    frmy = dr * vyr * uxr
    flmz = dl * vzl * uxl
    frmz = dr * vzr * uxr
    fle = el * uxl + pl * vxl
    fre = er * uxr + pr * vxr

    pos = am >= 0.0
    sl = torch.where(pos, am / (am - bm), 0.0)
    sr = torch.where(pos, 0.0, -am / (bp - am))
    sm = torch.where(pos, -bm / (am - bm), bp / (bp - am))

    fd = sl * fld + sr * frd
    fmx = sl * flmx + sr * frmx + sm * cp
    fmy = sl * flmy + sr * frmy
    fmz = sl * flmz + sr * frmz
    fe = sl * fle + sr * fre + sm * cp * am
    return fd, fmx, fmy, fmz, fe


_EULER = {"llf": _euler_llf, "hlle": _euler_hlle, "hllc": _euler_hllc}


# =========================================================================
# GLM-MHD solvers
# =========================================================================
def _glm_faces(eos: EOS, wl, wr, dirn, c_h):
    ivx, ivy, ivz = _VPERM[dirn]
    ibx, iby, ibz = _BPERM[dirn]
    L = dict(d=_var(wl, IDN), vx=_var(wl, ivx), vy=_var(wl, ivy),
             vz=_var(wl, ivz), p=_var(wl, IPR), bx=_var(wl, ibx),
             by=_var(wl, iby), bz=_var(wl, ibz), psi=_var(wl, IPS))
    R = dict(d=_var(wr, IDN), vx=_var(wr, ivx), vy=_var(wr, ivy),
             vz=_var(wr, ivz), p=_var(wr, IPR), bx=_var(wr, ibx),
             by=_var(wr, iby), bz=_var(wr, ibz), psi=_var(wr, IPS))
    # GLM 2x2 subsystem solved exactly (Dedner et al. 2002)
    bxi = 0.5 * (L["bx"] + R["bx"]) - 0.5 / c_h * (R["psi"] - L["psi"])
    psii = 0.5 * (L["psi"] + R["psi"]) - 0.5 * c_h * (R["bx"] - L["bx"])
    f_bx = psii
    f_psi = c_h * c_h * bxi
    return L, R, bxi, f_bx, f_psi


def _glm_llf(eos, wl, wr, dirn, c_h):
    L, R, bxi, f_bx, f_psi = _glm_faces(eos, wl, wr, dirn, c_h)
    pbl = 0.5 * (bxi * bxi + L["by"] ** 2 + L["bz"] ** 2)
    pbr = 0.5 * (bxi * bxi + R["by"] ** 2 + R["bz"] ** 2)
    el = (L["p"] / eos.gm1
          + 0.5 * L["d"] * (L["vx"] ** 2 + L["vy"] ** 2 + L["vz"] ** 2) + pbl)
    er = (R["p"] / eos.gm1
          + 0.5 * R["d"] * (R["vx"] ** 2 + R["vy"] ** 2 + R["vz"] ** 2) + pbr)

    def flux_one(S, e, pb):
        fd = S["d"] * S["vx"]
        fmx = fd * S["vx"] + S["p"] + pb - bxi * bxi
        fmy = fd * S["vy"] - bxi * S["by"]
        fmz = fd * S["vz"] - bxi * S["bz"]
        fe = S["vx"] * (e + S["p"] + pb - bxi * bxi) - bxi * (
            S["vy"] * S["by"] + S["vz"] * S["bz"])
        fby = S["by"] * S["vx"] - bxi * S["vy"]
        fbz = S["bz"] * S["vx"] - bxi * S["vz"]
        return fd, fmx, fmy, fmz, fe, fby, fbz

    fl = flux_one(L, el, pbl)
    fr = flux_one(R, er, pbr)
    cfl = fast_magnetosonic_speed(eos, L["d"], L["p"], L["bx"], L["by"],
                                  L["bz"])
    cfr = fast_magnetosonic_speed(eos, R["d"], R["p"], R["bx"], R["by"],
                                  R["bz"])
    a = torch.maximum(torch.abs(L["vx"]) + cfl, torch.abs(R["vx"]) + cfr)
    ul = (L["d"], L["d"] * L["vx"], L["d"] * L["vy"], L["d"] * L["vz"], el,
          L["by"], L["bz"])
    ur = (R["d"], R["d"] * R["vx"], R["d"] * R["vy"], R["d"] * R["vz"], er,
          R["by"], R["bz"])
    out = tuple(0.5 * (fli + fri) - 0.5 * a * (uri - uli)
                for fli, fri, uli, uri in zip(fl, fr, ul, ur))
    return out + (f_bx, f_psi)


def _glm_hlle(eos, wl, wr, dirn, c_h):
    """HLLE with Roe-averaged MHD wave-speed bounds
    (``glmmhd_hlle.hpp``; x/y correction terms per Cargo & Gallice)."""
    L, R, bxi, f_bx, f_psi = _glm_faces(eos, wl, wr, dirn, c_h)
    gm1 = eos.gm1
    sqrtdl = sqrt(L["d"])
    sqrtdr = sqrt(R["d"])
    isdlpdr = 1.0 / (sqrtdl + sqrtdr)
    droe = sqrtdl * sqrtdr
    v1roe = (sqrtdl * L["vx"] + sqrtdr * R["vx"]) * isdlpdr
    v2roe = (sqrtdl * L["vy"] + sqrtdr * R["vy"]) * isdlpdr
    v3roe = (sqrtdl * L["vz"] + sqrtdr * R["vz"]) * isdlpdr
    # NB: B averages use the opposite weighting (sqrtd_r for L), per Roe-MHD
    b2roe = (sqrtdr * L["by"] + sqrtdl * R["by"]) * isdlpdr
    b3roe = (sqrtdr * L["bz"] + sqrtdl * R["bz"]) * isdlpdr
    x = (0.5 * ((L["by"] - R["by"]) ** 2 + (L["bz"] - R["bz"]) ** 2)
         * isdlpdr ** 2)
    y = 0.5 * (L["d"] + R["d"]) / droe
    pbl = 0.5 * (bxi * bxi + L["by"] ** 2 + L["bz"] ** 2)
    pbr = 0.5 * (bxi * bxi + R["by"] ** 2 + R["bz"] ** 2)
    el = (L["p"] / gm1
          + 0.5 * L["d"] * (L["vx"] ** 2 + L["vy"] ** 2 + L["vz"] ** 2) + pbl)
    er = (R["p"] / gm1
          + 0.5 * R["d"] * (R["vx"] ** 2 + R["vy"] ** 2 + R["vz"] ** 2) + pbr)
    hroe = ((el + L["p"] + pbl) / sqrtdl
            + (er + R["p"] + pbr) / sqrtdr) * isdlpdr
    cfl = fast_magnetosonic_speed(eos, L["d"], L["p"], L["bx"], L["by"],
                                  L["bz"])
    cfr = fast_magnetosonic_speed(eos, R["d"], R["p"], R["bx"], R["by"],
                                  R["bz"])

    btsq = b2roe * b2roe + b3roe * b3roe
    vaxsq = bxi * bxi / droe
    bt_starsq = (gm1 - (gm1 - 1.0) * y) * btsq
    hp = hroe - (vaxsq + btsq / droe)
    vsq = v1roe * v1roe + v2roe * v2roe + v3roe * v3roe
    twid_asq = torch.clamp(gm1 * (hp - 0.5 * vsq) - (gm1 - 1.0) * x, min=0.0)
    ct2 = bt_starsq / droe
    tsum = vaxsq + ct2 + twid_asq
    tdif = vaxsq + ct2 - twid_asq
    cf2_cs2 = sqrt(tdif * tdif + 4.0 * twid_asq * ct2)
    a = sqrt(0.5 * (tsum + cf2_cs2))

    al = torch.minimum(v1roe - a, L["vx"] - cfl)
    ar = torch.maximum(v1roe + a, R["vx"] + cfr)
    bp = torch.where(ar > 0.0, ar, 0.0)
    bm = torch.where(al < 0.0, al, 0.0)

    uxl = L["vx"] - bm
    uxr = R["vx"] - bp

    def flux_one(S, e, pb, ux):
        fd = S["d"] * ux
        fmx = S["d"] * S["vx"] * ux + pb - bxi * bxi + S["p"]
        fmy = S["d"] * S["vy"] * ux - bxi * S["by"]
        fmz = S["d"] * S["vz"] * ux - bxi * S["bz"]
        fe = e * ux + S["vx"] * (S["p"] + pb - bxi * bxi) - bxi * (
            S["by"] * S["vy"] + S["bz"] * S["vz"])
        fby = S["by"] * ux - bxi * S["vy"]
        fbz = S["bz"] * ux - bxi * S["vz"]
        return fd, fmx, fmy, fmz, fe, fby, fbz

    fl = flux_one(L, el, pbl, uxl)
    fr = flux_one(R, er, pbr, uxr)
    tmp = _hlle_weight(bp, bm)
    out = tuple(0.5 * (fli + fri) + (fli - fri) * tmp
                for fli, fri in zip(fl, fr))
    return out + (f_bx, f_psi)


def _glm_hlld(eos, wl, wr, dirn, c_h):
    """Miyoshi & Kusano (2005) HLLD, branch-free (``glmmhd_hlld.hpp:39-396``).

    The star/double-star states are computed unconditionally with guarded
    denominators; the 6-way flux selection is a nested ``torch.where``.
    The CUDA sweep kernel's ``glm_hlld`` is the same algebra per face.
    """
    L, R, bxi, f_bx, f_psi = _glm_faces(eos, wl, wr, dirn, c_h)
    igm1 = 1.0 / eos.gm1
    bxsq = bxi * bxi
    pbl = 0.5 * (bxsq + L["by"] ** 2 + L["bz"] ** 2)
    pbr = 0.5 * (bxsq + R["by"] ** 2 + R["bz"] ** 2)
    kel = 0.5 * L["d"] * (L["vx"] ** 2 + L["vy"] ** 2 + L["vz"] ** 2)
    ker = 0.5 * R["d"] * (R["vx"] ** 2 + R["vy"] ** 2 + R["vz"] ** 2)

    # conserved L/R states (7-vector: d, mx, my, mz, e, by, bz)
    ul = dict(d=L["d"], mx=L["vx"] * L["d"], my=L["vy"] * L["d"],
              mz=L["vz"] * L["d"], e=L["p"] * igm1 + kel + pbl,
              by=L["by"], bz=L["bz"])
    ur = dict(d=R["d"], mx=R["vx"] * R["d"], my=R["vy"] * R["d"],
              mz=R["vz"] * R["d"], e=R["p"] * igm1 + ker + pbr,
              by=R["by"], bz=R["bz"])

    cfl = fast_magnetosonic_speed(eos, L["d"], L["p"], L["bx"], L["by"],
                                  L["bz"])
    cfr = fast_magnetosonic_speed(eos, R["d"], R["p"], R["bx"], R["by"],
                                  R["bz"])
    spd0 = torch.minimum(L["vx"] - cfl, R["vx"] - cfr)
    spd4 = torch.maximum(L["vx"] + cfl, R["vx"] + cfr)

    ptl = L["p"] + pbl
    ptr = R["p"] + pbr

    fl = dict(d=ul["mx"],
              mx=ul["mx"] * L["vx"] + ptl - bxsq,
              my=ul["my"] * L["vx"] - bxi * ul["by"],
              mz=ul["mz"] * L["vx"] - bxi * ul["bz"],
              e=L["vx"] * (ul["e"] + ptl - bxsq) - bxi * (
                  L["vy"] * ul["by"] + L["vz"] * ul["bz"]),
              by=ul["by"] * L["vx"] - bxi * L["vy"],
              bz=ul["bz"] * L["vx"] - bxi * L["vz"])
    fr = dict(d=ur["mx"],
              mx=ur["mx"] * R["vx"] + ptr - bxsq,
              my=ur["my"] * R["vx"] - bxi * ur["by"],
              mz=ur["mz"] * R["vx"] - bxi * ur["bz"],
              e=R["vx"] * (ur["e"] + ptr - bxsq) - bxi * (
                  R["vy"] * ur["by"] + R["vz"] * ur["bz"]),
              by=ur["by"] * R["vx"] - bxi * R["vy"],
              bz=ur["bz"] * R["vx"] - bxi * R["vz"])

    sdl = spd0 - L["vx"]
    sdr = spd4 - R["vx"]
    spd2 = (sdr * ur["mx"] - sdl * ul["mx"] + (ptl - ptr)) / (
        sdr * ur["d"] - sdl * ul["d"])
    sdml = spd0 - spd2
    sdmr = spd4 - spd2
    sdml_inv = 1.0 / sdml
    sdmr_inv = 1.0 / sdmr

    ulst_d = ul["d"] * sdl * sdml_inv
    urst_d = ur["d"] * sdr * sdmr_inv
    ulst_d_inv = 1.0 / ulst_d
    urst_d_inv = 1.0 / urst_d
    sqrtdl = sqrt(ulst_d)
    sqrtdr = sqrt(urst_d)
    spd1 = spd2 - torch.abs(bxi) / sqrtdl
    spd3 = spd2 + torch.abs(bxi) / sqrtdr

    ptstl = ptl + ul["d"] * sdl * (spd2 - L["vx"])
    ptstr = ptr + ur["d"] * sdr * (spd2 - R["vx"])
    ptst = 0.5 * (ptstr + ptstl)

    # --- star states
    def star(S, u, sd, sdm, ust_d, sdm_inv, pt):
        denom = u["d"] * sd * sdm - bxsq
        degen = torch.abs(denom) < SMALL * ptst
        safe = torch.where(degen, 1.0, denom)
        tmp = bxi * (sd - sdm) / safe
        my = torch.where(degen, ust_d * S["vy"],
                         ust_d * (S["vy"] - u["by"] * tmp))
        mz = torch.where(degen, ust_d * S["vz"],
                         ust_d * (S["vz"] - u["bz"] * tmp))
        tmp2 = (u["d"] * sd * sd - bxsq) / safe
        by = torch.where(degen, u["by"], u["by"] * tmp2)
        bz = torch.where(degen, u["bz"], u["bz"] * tmp2)
        mx = ust_d * spd2
        vbst = (mx * bxi + my * by + mz * bz) / ust_d
        e = (sd * u["e"] - pt * S["vx"] + ptst * spd2 + bxi * (
            S["vx"] * bxi + S["vy"] * u["by"] + S["vz"] * u["bz"] - vbst)
             ) * sdm_inv
        return dict(d=ust_d, mx=mx, my=my, mz=mz, e=e, by=by, bz=bz), vbst

    ulst, vbstl = star(L, ul, sdl, sdml, ulst_d, sdml_inv, ptl)
    urst, vbstr = star(R, ur, sdr, sdmr, urst_d, sdmr_inv, ptr)

    # --- double-star states (Alfvén-rotated)
    weak_b = 0.5 * bxsq < SMALL * ptst
    invsumd = 1.0 / (sqrtdl + sqrtdr)
    bxsig = (bxi > 0.0).to(bxi.dtype) * 2.0 - 1.0
    vy_dst = invsumd * (sqrtdl * (ulst["my"] * ulst_d_inv) +
                        sqrtdr * (urst["my"] * urst_d_inv) +
                        bxsig * (urst["by"] - ulst["by"]))
    vz_dst = invsumd * (sqrtdl * (ulst["mz"] * ulst_d_inv) +
                        sqrtdr * (urst["mz"] * urst_d_inv) +
                        bxsig * (urst["bz"] - ulst["bz"]))
    by_dst = invsumd * (sqrtdl * urst["by"] + sqrtdr * ulst["by"] +
                        bxsig * sqrtdl * sqrtdr * ((urst["my"] * urst_d_inv) -
                                                   (ulst["my"] * ulst_d_inv)))
    bz_dst = invsumd * (sqrtdl * urst["bz"] + sqrtdr * ulst["bz"] +
                        bxsig * sqrtdl * sqrtdr * ((urst["mz"] * urst_d_inv) -
                                                   (ulst["mz"] * ulst_d_inv)))
    vb_dst = spd2 * bxi + vy_dst * by_dst + vz_dst * bz_dst

    uldst = dict(
        d=ulst["d"], mx=ulst["mx"],
        my=torch.where(weak_b, ulst["my"], ulst["d"] * vy_dst),
        mz=torch.where(weak_b, ulst["mz"], ulst["d"] * vz_dst),
        by=torch.where(weak_b, ulst["by"], by_dst),
        bz=torch.where(weak_b, ulst["bz"], bz_dst),
        e=torch.where(weak_b, ulst["e"],
                      ulst["e"] - sqrtdl * bxsig * (vbstl - vb_dst)))
    urdst = dict(
        d=urst["d"], mx=urst["mx"],
        my=torch.where(weak_b, urst["my"], urst["d"] * vy_dst),
        mz=torch.where(weak_b, urst["mz"], urst["d"] * vz_dst),
        by=torch.where(weak_b, urst["by"], by_dst),
        bz=torch.where(weak_b, urst["bz"], bz_dst),
        e=torch.where(weak_b, urst["e"],
                      urst["e"] + sqrtdr * bxsig * (vbstr - vb_dst)))

    keys = ("d", "mx", "my", "mz", "e", "by", "bz")
    # jump contributions (same algebra as the reference's in-place rewrites)
    d_uldst = {k: spd1 * (uldst[k] - ulst[k]) for k in keys}
    d_ulst = {k: spd0 * (ulst[k] - ul[k]) for k in keys}
    d_urdst = {k: spd3 * (urdst[k] - urst[k]) for k in keys}
    d_urst = {k: spd4 * (urst[k] - ur[k]) for k in keys}

    out = []
    for k in keys:
        fL = fl[k]
        fR = fr[k]
        # nested selection over the 6 regions
        f = torch.where(
            spd0 >= 0.0, fL,
            torch.where(
                spd4 <= 0.0, fR,
                torch.where(
                    spd1 >= 0.0, fL + d_ulst[k],
                    torch.where(
                        spd2 >= 0.0, fL + d_ulst[k] + d_uldst[k],
                        torch.where(spd3 > 0.0, fR + d_urst[k] + d_urdst[k],
                                    fR + d_urst[k])))))
        out.append(f)
    return tuple(out) + (f_bx, f_psi)


_GLM = {"llf": _glm_llf, "hlle": _glm_hlle, "hlld": _glm_hlld}


# =========================================================================
# dispatch
# =========================================================================
def solve_riemann(solver: str, fluid: str, eos: EOS, wl, wr, dirn: int,
                  c_h=None, nscalars: int = 0):
    """Full flux tensor [..., nvar, nz, ny, nx] for one direction."""
    ivx, ivy, ivz = _VPERM[dirn]
    if fluid == EULER:
        fd, fmx, fmy, fmz, fe = _EULER[solver](eos, wl, wr, dirn)
        fluxmap = {IDN: fd, ivx: fmx, ivy: fmy, ivz: fmz, IEN: fe}
        nbase = NHYDRO
    elif fluid == GLMMHD:
        ibx, iby, ibz = _BPERM[dirn]
        fd, fmx, fmy, fmz, fe, fby, fbz, fbx, fpsi = _GLM[solver](
            eos, wl, wr, dirn, c_h)
        fluxmap = {IDN: fd, ivx: fmx, ivy: fmy, ivz: fmz, IEN: fe,
                   ibx: fbx, iby: fby, ibz: fbz, IPS: fpsi}
        nbase = NGLMMHD
    else:
        raise ValueError(f"unknown fluid {fluid}")
    if nscalars:
        fluxmap.update(_scalar_fluxes(fluxmap[IDN], wl, wr, nbase, nscalars))
    return _scatter(fluxmap, nbase + nscalars)

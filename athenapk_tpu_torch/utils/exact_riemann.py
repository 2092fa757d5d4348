"""Exact Riemann solver for the 1D Euler equations (Toro ch. 4).

Used by the shock-tube regression suite as the analytic reference (the
reference implements the same in Python inside
``tst/regression/test_suites/riemann_hydro/riemann_hydro.py``).
"""

from __future__ import annotations

import numpy as np


def _fK(p, rhoK, pK, cK, g):
    """Toro eq 4.6/4.7: f_K(p) and derivative not needed (bisection)."""
    if p > pK:  # shock
        AK = 2.0 / ((g + 1.0) * rhoK)
        BK = (g - 1.0) / (g + 1.0) * pK
        return (p - pK) * np.sqrt(AK / (p + BK))
    # rarefaction
    return 2.0 * cK / (g - 1.0) * ((p / pK) ** ((g - 1.0) / (2.0 * g)) - 1.0)


def solve_star(rho_l, u_l, p_l, rho_r, u_r, p_r, gamma):
    """p*, u* via robust bisection on the pressure function."""
    cl = np.sqrt(gamma * p_l / rho_l)
    cr = np.sqrt(gamma * p_r / rho_r)
    du = u_r - u_l

    def f(p):
        return _fK(p, rho_l, p_l, cl, gamma) + _fK(p, rho_r, p_r, cr, gamma) + du

    plo, phi = 1e-12, 100.0 * max(p_l, p_r)
    for _ in range(200):
        pm = 0.5 * (plo + phi)
        if f(pm) > 0.0:
            phi = pm
        else:
            plo = pm
    pstar = 0.5 * (plo + phi)
    ustar = 0.5 * (u_l + u_r) + 0.5 * (
        _fK(pstar, rho_r, p_r, cr, gamma) - _fK(pstar, rho_l, p_l, cl, gamma))
    return pstar, ustar


def sample(xi, rho_l, u_l, p_l, rho_r, u_r, p_r, gamma):
    """Sample the self-similar solution at xi = x/t (vectorized in xi)."""
    xi = np.asarray(xi, dtype=np.float64)
    g = gamma
    cl = np.sqrt(g * p_l / rho_l)
    cr = np.sqrt(g * p_r / rho_r)
    pstar, ustar = solve_star(rho_l, u_l, p_l, rho_r, u_r, p_r, g)

    rho = np.empty_like(xi)
    u = np.empty_like(xi)
    p = np.empty_like(xi)

    gm1 = g - 1.0
    gp1 = g + 1.0

    left = xi <= ustar
    # ---- left side
    if pstar > p_l:  # left shock
        rho_star_l = rho_l * ((pstar / p_l + gm1 / gp1) /
                              (gm1 / gp1 * pstar / p_l + 1.0))
        sl = u_l - cl * np.sqrt(gp1 / (2 * g) * pstar / p_l + gm1 / (2 * g))
        in_l = left & (xi < sl)
        in_star_l = left & ~in_l
        rho[in_l], u[in_l], p[in_l] = rho_l, u_l, p_l
        rho[in_star_l], u[in_star_l], p[in_star_l] = rho_star_l, ustar, pstar
    else:  # left rarefaction
        rho_star_l = rho_l * (pstar / p_l) ** (1.0 / g)
        c_star_l = cl * (pstar / p_l) ** (gm1 / (2 * g))
        head = u_l - cl
        tail = ustar - c_star_l
        in_l = left & (xi < head)
        in_fan = left & (xi >= head) & (xi <= tail)
        in_star = left & (xi > tail)
        rho[in_l], u[in_l], p[in_l] = rho_l, u_l, p_l
        cf = 2.0 / gp1 * (cl + gm1 / 2.0 * (u_l - xi[in_fan]))
        uf = 2.0 / gp1 * (cl + gm1 / 2.0 * u_l + xi[in_fan])
        rho[in_fan] = rho_l * (cf / cl) ** (2.0 / gm1)
        u[in_fan] = uf
        p[in_fan] = p_l * (cf / cl) ** (2.0 * g / gm1)
        rho[in_star], u[in_star], p[in_star] = rho_star_l, ustar, pstar

    right = ~left
    # ---- right side
    if pstar > p_r:  # right shock
        rho_star_r = rho_r * ((pstar / p_r + gm1 / gp1) /
                              (gm1 / gp1 * pstar / p_r + 1.0))
        sr = u_r + cr * np.sqrt(gp1 / (2 * g) * pstar / p_r + gm1 / (2 * g))
        in_r = right & (xi > sr)
        in_star_r = right & ~in_r
        rho[in_r], u[in_r], p[in_r] = rho_r, u_r, p_r
        rho[in_star_r], u[in_star_r], p[in_star_r] = rho_star_r, ustar, pstar
    else:  # right rarefaction
        rho_star_r = rho_r * (pstar / p_r) ** (1.0 / g)
        c_star_r = cr * (pstar / p_r) ** (gm1 / (2 * g))
        head = u_r + cr
        tail = ustar + c_star_r
        in_r = right & (xi > head)
        in_fan = right & (xi <= head) & (xi >= tail)
        in_star = right & (xi < tail)
        rho[in_r], u[in_r], p[in_r] = rho_r, u_r, p_r
        cf = 2.0 / gp1 * (cr - gm1 / 2.0 * (u_r - xi[in_fan]))
        uf = 2.0 / gp1 * (-cr + gm1 / 2.0 * u_r + xi[in_fan])
        rho[in_fan] = rho_r * (cf / cr) ** (2.0 / gm1)
        u[in_fan] = uf
        p[in_fan] = p_r * (cf / cr) ** (2.0 * g / gm1)
        rho[in_star], u[in_star], p[in_star] = rho_star_r, ustar, pstar

    return rho, u, p

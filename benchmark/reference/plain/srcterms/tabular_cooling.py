# A frozen copy of athenapk_tpu_torch/srcterms/tabular_cooling.py for the
# benchmark's plain reference of the cluster; it imports nothing of the program.
"""Optically thin tabulated cooling (torch), reference
``src/hydro/srcterms/tabular_cooling.{hpp,cpp}``, with the ``townsend``
integrator alone: Townsend (2009) exact integration over the piecewise
power-law fits of the cooling curve (``TownsendSrcTerm``), the bin walks
as counts over the monotone temperature and Y_k tables.  The program's
copy also has the ``rk12`` / ``rk45`` subcycling and the table self-test,
which no configuration of the benchmark runs.

The table is a two-column text file (log10 T [K], log10 Lambda [cgs]),
evenly spaced in log T; Lambda is converted to code units with
``lambda_units_cgs`` and the ``<units>`` block.  de/dt = -Lambda(T)
(X / m_h)^2 rho per unit mass, T = mbar (gamma - 1) e / k_B.

Runs on whatever device the state is on (plain PyTorch: the cooling is
plain JAX in the reference too).  On a CPU tensor ``log10`` and ``pow``
are numpy's, for the reason ``core/ieee.py`` gives for the square root.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..core.indices import GLMMHD, IB1, IB2, IB3, IDN, IEN, IM1, IM2, IM3, IPR


def _log10(x):
    if x.device.type != "cpu":
        return torch.log10(x)
    out = torch.empty_like(x)
    with np.errstate(all="ignore"):
        np.log10(x.numpy(), out=out.numpy())
    return out


def _pow(a, b):
    """``a ** b``: a and b tensors, or one of them a Python float."""
    ref = a if torch.is_tensor(a) else b
    if ref.device.type != "cpu":
        return torch.pow(a, b)
    na = a.numpy() if torch.is_tensor(a) else a
    nb = b.numpy() if torch.is_tensor(b) else b
    with np.errstate(all="ignore"):
        out = np.power(na, nb)
    return torch.from_numpy(np.asarray(out, dtype=ref.numpy().dtype))


class TabularCooling:
    def __init__(self, pin, units, gamma: float, mu: float,
                 he_mass_fraction: float, mbar_over_kb: float):
        c = "cooling"
        table_filename = pin.get_string(c, "table_filename")
        lambda_units_cgs = pin.get_real(c, "lambda_units_cgs")
        self.integrator = pin.get_or_add_string(c, "integrator", "rk12")
        if self.integrator != "townsend":
            raise ValueError("the plain reference's cooling integrates with "
                             "townsend alone")
        self.cooling_time_cfl = pin.get_or_add_real(c, "cfl", 0.1)
        self.t_floor = pin.get_or_add_real("hydro", "Tfloor", -1.0)

        lambda_units = lambda_units_cgs / (
            units.erg() * units.cm() ** 3 / units.s())

        log_temps = []
        log_lambdas = []
        with open(table_filename) as fh:
            for line in fh:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                cols = line.split()
                if len(cols) != 2:
                    raise ValueError(f"cooling table: expected 2 columns, "
                                     f"got '{line}'")
                log_temps.append(float(cols[0]))
                log_lambdas.append(float(cols[1]) - math.log10(lambda_units))
        if len(log_temps) < 2:
            raise ValueError("cooling table too short")
        log_temps = np.asarray(log_temps)
        log_lambdas = np.asarray(log_lambdas)
        d = np.diff(log_temps)
        if np.any(d <= 0):
            raise ValueError("cooling table log_temp not increasing")
        # even-spacing tolerance (reference d_log_temp_tol,
        # tabular_cooling.cpp:65,179)
        d_log_temp_tol = pin.get_or_add_real(c, "d_log_temp_tol", 1e-8)
        if np.any(np.abs(d - d[0]) / d[0] > d_log_temp_tol):
            raise ValueError("cooling table log_temp not evenly spaced")

        self.n_temp = len(log_temps)
        self.log_temp_start = float(log_temps[0])
        self.log_temp_final = float(log_temps[-1])
        self.d_log_temp = float(d[0])

        # Townsend piecewise power-law fits (Townsend 2009 eqs A4-A7)
        lambdas = 10.0 ** log_lambdas
        temps = 10.0 ** log_temps
        nbins = self.n_temp - 1
        alpha_k = (np.log10(lambdas[1:]) - np.log10(lambdas[:-1])) / d
        if np.any(alpha_k == 1.0):
            raise ValueError("alpha_k == 1 special case not implemented "
                             "(matches reference)")
        Y_k = np.zeros(nbins)
        for i in range(nbins - 2, -1, -1):
            am1 = alpha_k[i] - 1.0
            step = (lambdas[nbins] / lambdas[i]) * (temps[i] / temps[nbins]) \
                * ((temps[i] / temps[i + 1]) ** am1 - 1.0) / am1
            Y_k[i] = Y_k[i + 1] - step
        # the tables in f64 on the host; _tables() hands them to a state's
        # device and dtype
        self._np = {"log_lambdas": log_lambdas, "temps": temps,
                    "lambdas": lambdas, "alpha_k": alpha_k, "Y_k": Y_k}
        self._tab = {}
        self.lambda_final = float(lambdas[-1])
        self.temp_final = float(temps[-1])

        self.gamma = gamma
        self.mbar_gm1_over_kb = mbar_over_kb * (gamma - 1.0)
        self.x_h_over_mh2 = ((1.0 - he_mass_fraction) / units.mh()) ** 2

    def _tables(self, like):
        key = (like.device, like.dtype)
        if key not in self._tab:
            self._tab[key] = {k: torch.as_tensor(v, dtype=like.dtype,
                                                 device=like.device)
                              for k, v in self._np.items()}
        return self._tab[key]

    # ------------------------------------------------------------------ DeDt
    def dedt(self, e, rho):
        """Specific-internal-energy loss rate (``CoolingTableObj::DeDt``).
        Below the table: 0; above: the free-free-like Lambda ~ T^1/2
        extension."""
        ll = self._tables(e)["log_lambdas"]
        temp = self.mbar_gm1_over_kb * e
        log_temp = _log10(torch.clamp(temp, min=1e-300))
        i = torch.clamp(((log_temp - self.log_temp_start)
                         / self.d_log_temp).to(torch.int32),
                        0, self.n_temp - 2).long()
        lt_i = self.log_temp_start + self.d_log_temp * i.to(e.dtype)
        ll_i = ll[i]
        ll_ip1 = ll[i + 1]
        log_lambda_interp = ll_i + (log_temp - lt_i) * (ll_ip1 - ll_i) \
            / self.d_log_temp
        log_lambda_ext = (0.5 * log_temp - 0.5 * self.log_temp_final
                          + ll[-1])
        log_lambda = torch.where(log_temp > self.log_temp_final,
                                 log_lambda_ext, log_lambda_interp)
        lam = _pow(10.0, log_lambda)
        out = -lam * self.x_h_over_mh2 * rho
        invalid = (e < 0) | torch.isnan(e) | (log_temp < self.log_temp_start)
        return torch.where(invalid, 0.0, out)

    # ------------------------------------------------------------- internals
    def _internal_e(self, cons, is_mhd):
        rho = cons[:, IDN]
        ie = cons[:, IEN] - 0.5 * (cons[:, IM1] ** 2 + cons[:, IM2] ** 2
                                   + cons[:, IM3] ** 2) / rho
        if is_mhd:
            ie = ie - 0.5 * (cons[:, IB1] ** 2 + cons[:, IB2] ** 2
                             + cons[:, IB3] ** 2)
        return ie / rho, rho

    # ------------------------------------------------------------- integrate
    def apply(self, cons, dt, fluid: str):
        """``cons`` with the cooling source applied over ``dt`` (a new
        tensor)."""
        e0, rho = self._internal_e(cons, fluid == GLMMHD)
        e1 = self._townsend(e0, rho, dt)
        out = cons.clone()
        out[:, IEN] = cons[:, IEN] + rho * (e1 - e0)
        return out

    def _townsend(self, e0, rho, dt):
        """The exact Townsend (2009) update."""
        tab = self._tables(e0)
        temps, lambdas, alpha_k, Y_k = (tab["temps"], tab["lambdas"],
                                        tab["alpha_k"], tab["Y_k"])
        mgk = self.mbar_gm1_over_kb
        temp_cool_floor = 10.0 ** self.log_temp_start
        e_floor = self.t_floor / mgk if self.t_floor > 0 else -math.inf

        temp = mgk * e0
        nbins = self.n_temp - 1
        # idx: the last bin whose upper edge is below temp (bin walk up)
        idx = torch.clamp((temps[1:] < temp[..., None]).sum(dim=-1),
                          0, nbins - 1)
        a_m1 = alpha_k[idx] - 1.0
        lam_fin = self.lambda_final
        t_fin = self.temp_final
        tef = Y_k[idx] + (lam_fin / lambdas[idx]) * (temps[idx] / t_fin) \
            * (_pow(temps[idx] / temp, a_m1) - 1.0) / a_m1
        n_h2_by_rho = rho * self.x_h_over_mh2
        tef_adj = tef + lam_fin * dt / t_fin * mgk * n_h2_by_rho
        # bin walk down: the largest k with Y_k[k] >= tef_adj (Y_k falls)
        kstar = (Y_k >= tef_adj[..., None]).sum(dim=-1) - 1
        idx2 = torch.minimum(idx, torch.clamp(kstar, min=0))
        one_m_a = 1.0 - alpha_k[idx2]
        temp_new = temps[idx2] * _pow(
            1.0 - one_m_a * (lambdas[idx2] / lam_fin)
            * (t_fin / temps[idx2]) * (tef_adj - Y_k[idx2]),
            1.0 / one_m_a)
        e_new = torch.where(temp_new > temp_cool_floor, temp_new / mgk,
                            temp_cool_floor / mgk)
        # floors, and cells below the table's start keep their energy
        e_new = torch.where(temp < temp_cool_floor, e0, e_new)
        e_new = torch.where(e0 <= e_floor, torch.clamp(e0, min=e_floor),
                            e_new)
        return e_new

    # ------------------------------------------------------------------- dt
    def estimate_timestep(self, prim, mesh):
        """The cooling-CFL dt, cfl * min |e / (de/dt)| over the interior
        cells (``TabularCooling::EstimateTimeStep``): a 0-d tensor on the
        state's device, or ``math.inf`` when the cooling CFL is off."""
        if self.cooling_time_cfl <= 0.0 or math.isnan(self.cooling_time_cfl):
            return math.inf
        w = prim[mesh.interior_slices]
        rho = w[:, IDN]
        gm1 = self.gamma - 1.0
        e = w[:, IPR] / (rho * gm1)
        dedt = self.dedt(e, rho)
        temp_cool_floor = 10.0 ** self.log_temp_start
        e_floor = max(self.t_floor, temp_cool_floor) / self.mbar_gm1_over_kb
        ct = torch.where((dedt == 0) | (e < e_floor), math.inf,
                         torch.abs(e / torch.where(dedt != 0, dedt, 1.0)))
        return self.cooling_time_cfl * torch.min(ct)

"""Optically thin tabulated cooling (torch).

Counterpart of ``athenapk_tpu/srcterms/tabular_cooling.py`` (reference
``src/hydro/srcterms/tabular_cooling.{hpp,cpp}``), with its three
integrators:

* ``townsend`` — Townsend (2009) exact integration over the piecewise
  power-law fits of the cooling curve (``TownsendSrcTerm``), the bin walks
  as counts over the monotone temperature and Y_k tables;
* ``rk12`` / ``rk45`` — adaptive subcycling (``SubcyclingFixedIntSrcTerm``)
  in lock step over all cells, each with its own sub-time and step.  The
  JAX package's ``lax.while_loop`` runs while any cell has time left (at
  most ``4 * max_iter`` passes); here that test is one host read per pass,
  counted in ``host_reads`` and marked by a ``host_read`` profiler range.

The table is a two-column text file (log10 T [K], log10 Lambda [cgs]),
evenly spaced in log T; Lambda is converted to code units with
``lambda_units_cgs`` and the ``<units>`` block.  de/dt = -Lambda(T)
(X / m_h)^2 rho per unit mass, T = mbar (gamma - 1) e / k_B.

The plain code runs on whatever device the state is on (the cooling is
plain JAX in the reference too).  On a CPU tensor ``log10`` and ``pow``
are numpy's, for the reason ``core/ieee.py`` gives for the square root.
On a CUDA tensor the Townsend update and the dt are hand-written kernels
(``tabular_cooling_cuda``) with the plain code's numbers.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch.profiler import record_function

from ..core.ieee import power
from ..core.indices import GLMMHD, IB1, IB2, IB3, IDN, IEN, IM1, IM2, IM3, IPR
from . import tabular_cooling_cuda


def _log10(x):
    if x.device.type != "cpu":
        return torch.log10(x)
    out = torch.empty_like(x)
    with np.errstate(all="ignore"):
        np.log10(x.numpy(), out=out.numpy())
    return out


# What ``TabularCooling.pass_log`` counts per subcycling pass: the active
# cells; those accepted by the error test, those accepted only because
# their step is the least allowed (dt / max_iter), those rejected; and the
# active cells' error estimates |y_h - y_l| / |y_h| by bin (the bins
# past ``tol`` hold only errors that fail the test).
PASS_COUNTS = ("active", "accepted", "accepted_at_min_step", "rejected",
               "err=0", "0<err<tol", "tol<=err<1e-7", "1e-7<=err<1e-6",
               "1e-6<=err<1e-4", "err>=1e-4")


def _pass_counts(active, accept, err, tol):
    passed = err < tol
    failed = ~passed
    bins = (err == 0, (err > 0) & passed, failed & (err < 1e-7),
            failed & (err >= 1e-7) & (err < 1e-6),
            failed & (err >= 1e-6) & (err < 1e-4), failed & (err >= 1e-4))
    return torch.stack([active.sum(), (accept & passed).sum(),
                        (accept & failed).sum(), (active & ~accept).sum()]
                       + [(active & b).sum() for b in bins])


class TabularCooling:
    def __init__(self, pin, units, gamma: float, mu: float,
                 he_mass_fraction: float, mbar_over_kb: float):
        c = "cooling"
        table_filename = pin.get_string(c, "table_filename")
        lambda_units_cgs = pin.get_real(c, "lambda_units_cgs")
        self.integrator = pin.get_or_add_string(c, "integrator", "rk12")
        self.max_iter = pin.get_or_add_integer(c, "max_iter", 100)
        self.cooling_time_cfl = pin.get_or_add_real(c, "cfl", 0.1)
        self.d_e_tol = pin.get_or_add_real(c, "d_e_tol", 1e-8)
        self.t_floor = pin.get_or_add_real("hydro", "Tfloor", -1.0)
        self.host_reads = 0   # the subcycling loop's tests read to the host
        # a list to diagnose the subcycling: each pass appends its counts
        # (``PASS_COUNTS``) as a device tensor, read by the caller; None: off
        self.pass_log = None

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
        # the device pointers of _tab's tables for the kernels, by (device,
        # dtype) (tabular_cooling_cuda._table_pointers)
        self.kernel_tables = {}
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
        lam = power(10.0, log_lambda)
        out = -lam * self.x_h_over_mh2 * rho
        invalid = (e < 0) | torch.isnan(e) | (log_temp < self.log_temp_start)
        return torch.where(invalid, 0.0, out)

    # -------------------------------------------------------------- selftest
    def test_cooling_table(self, pin):
        """Deck-triggered table validation (``TestCoolingTable``, reference
        ``tabular_cooling.cpp:666-722``; ``<cooling> test_filename``
        triggers it at start-up): de/dt on a log-spaced (rho, pres) grid,
        written as '#rho pres internal_e de_dt' rows."""
        c = "cooling"
        fn = pin.get_string(c, "test_filename")
        rho0 = pin.get_real(c, "test_rho0")
        rho1 = pin.get_real(c, "test_rho1")
        n_rho = pin.get_integer(c, "test_n_rho")
        pres0 = pin.get_real(c, "test_pres0")
        pres1 = pin.get_real(c, "test_pres1")
        n_pres = pin.get_integer(c, "test_n_pres")
        gm1 = self.gamma - 1.0
        j = np.arange(n_rho)[:, None]
        i = np.arange(n_pres)[None, :]
        rho = rho0 * (rho1 / rho0) ** (j / max(n_rho - 1, 1)) \
            * np.ones((1, n_pres))
        pres = pres0 * (pres1 / pres0) ** (i / max(n_pres - 1, 1)) \
            * np.ones((n_rho, 1))
        internal_e = pres / (rho * gm1)
        de_dt = self.dedt(torch.from_numpy(internal_e),
                          torch.from_numpy(rho)).numpy()
        with open(fn, "w") as fh:
            fh.write("#rho pres internal_e de_dt\n")
            for jj in range(n_rho):
                for ii in range(n_pres):
                    fh.write(f"{rho[jj, ii]:.12g} {pres[jj, ii]:.12g} "
                             f"{internal_e[jj, ii]:.12g} "
                             f"{de_dt[jj, ii]:.12g}\n")
        return rho, pres, internal_e, de_dt

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
        tensor: ``apply_in_place`` on a copy)."""
        return self.apply_in_place(cons.clone(), dt, fluid)

    def apply_in_place(self, cons, dt, fluid: str):
        """The cooling source over ``dt`` applied to ``cons`` itself, which
        is returned; only its energy row changes (the stage epilogues hand
        over the fresh stage result, saving a copy of the state).  The
        Townsend update goes through ``tabular_cooling_cuda.fused_townsend``
        (one kernel on the card); the subcycling is plain on every
        device."""
        if self.integrator == "townsend":
            return tabular_cooling_cuda.fused_townsend(self, cons, dt,
                                                       fluid)
        return self.cool_plain(cons, dt, fluid)

    def cool_plain(self, cons, dt, fluid: str):
        """The plain update of ``apply_in_place``, in place on ``cons``."""
        e0, rho = self._internal_e(cons, fluid == GLMMHD)
        if self.integrator == "townsend":
            e1 = self._townsend(e0, rho, dt)
        elif self.integrator in ("rk12", "rk45"):
            e1 = self._subcycle(e0, rho, dt)
        else:
            raise ValueError(f"unknown cooling integrator {self.integrator}")
        cons[:, IEN] += rho * (e1 - e0)
        return cons

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
            * (power(temps[idx] / temp, a_m1) - 1.0) / a_m1
        n_h2_by_rho = rho * self.x_h_over_mh2
        tef_adj = tef + lam_fin * dt / t_fin * mgk * n_h2_by_rho
        # bin walk down: the largest k with Y_k[k] >= tef_adj (Y_k falls)
        kstar = (Y_k >= tef_adj[..., None]).sum(dim=-1) - 1
        idx2 = torch.minimum(idx, torch.clamp(kstar, min=0))
        one_m_a = 1.0 - alpha_k[idx2]
        temp_new = temps[idx2] * power(
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

    def _subcycle(self, e0, rho, dt):
        """Adaptive RK12/RK45 subcycling in lock step
        (``SubcyclingFixedIntSrcTerm``): per-cell sub-dt, finished cells
        masked out; the loop runs while any cell has time left."""
        temp_cool_floor = 10.0 ** self.log_temp_start
        e_floor_t = self.t_floor / self.mbar_gm1_over_kb \
            if self.t_floor > 0 else 0.0
        e_floor = max(e_floor_t, temp_cool_floor / self.mbar_gm1_over_kb)
        min_sub_dt = dt / self.max_iter
        tol = self.d_e_tol

        def f(e):
            return self.dedt(e, rho)

        def rk12(e, h):
            k1 = f(e)
            e1l = e + h * k1
            e1h = e + 0.5 * h * (k1 + f(e1l))
            return e1h, e1l

        def rk45(e, h):
            k1 = h * f(e)
            k2 = h * f(e + 0.25 * k1)
            k3 = h * f(e + 3.0 / 32.0 * k1 + 9.0 / 32.0 * k2)
            k4 = h * f(e + 1932.0 / 2197.0 * k1 - 7200.0 / 2197.0 * k2
                       + 7296.0 / 2197.0 * k3)
            k5 = h * f(e + 439.0 / 216.0 * k1 - 8.0 * k2
                       + 3680.0 / 513.0 * k3 - 845.0 / 4104.0 * k4)
            k6 = h * f(e - 8.0 / 27.0 * k1 + 2.0 * k2 - 3544.0 / 2565.0 * k3
                       + 1859.0 / 4104.0 * k4 - 11.0 / 40.0 * k5)
            y_l = e + 25.0 / 216.0 * k1 + 1408.0 / 2565.0 * k3 \
                + 2197.0 / 4104.0 * k4 - 0.2 * k5
            y_h = e + 16.0 / 135.0 * k1 + 6656.0 / 12825.0 * k3 \
                + 28561.0 / 56430.0 * k4 - 9.0 / 50.0 * k5 + 2.0 / 55.0 * k6
            return y_h, y_l

        step = rk45 if self.integrator == "rk45" else rk12
        order = 5.0 if self.integrator == "rk45" else 2.0
        left = dt * (1 - 1e-12)

        e = e0
        sub_t = torch.zeros_like(e0)
        sub_dt = torch.full_like(e0, dt)
        it = 0
        # the reference's max_iter bounds accepted subcycles; rejected
        # attempts also take passes here, hence the headroom
        while it < 4 * self.max_iter:
            self.host_reads += 1
            left_any = torch.any(sub_t < left)
            with record_function("host_read"):
                more = bool(left_any)
            if not more:
                break
            active = (sub_t < left) & (f(e) != 0.0) & (e > e_floor)
            h = torch.minimum(sub_dt, dt - sub_t)
            y_h, y_l = step(e, h)
            err = torch.abs((y_h - y_l) / torch.where(y_h != 0, y_h, 1.0))
            accept = active & ((err < tol) | (h <= min_sub_dt * (1 + 1e-12)))
            if self.pass_log is not None:
                self.pass_log.append(_pass_counts(active, accept, err, tol))
            e = torch.where(accept, torch.clamp(y_h, min=e_floor), e)
            sub_t = torch.where(accept, sub_t + h, sub_t)
            # the optimal next step (0.95 h (tol / err)^order), clamped
            new_dt = 0.95 * h * power(tol / torch.clamp(err, min=1e-300),
                                     order)
            new_dt = torch.clamp(new_dt, min_sub_dt, dt)
            sub_dt = torch.where(active, new_dt, sub_dt)
            # finished and inactive cells stay put
            sub_t = torch.where(active, sub_t, torch.full_like(sub_t, dt))
            it += 1
        return e

    # ------------------------------------------------------------------- dt
    def estimate_timestep(self, prim, mesh):
        """The cooling-CFL dt, cfl * min |e / (de/dt)| over the interior
        cells (``TabularCooling::EstimateTimeStep``): a 0-d tensor on the
        state's device, or ``math.inf`` when the cooling CFL is off; through
        ``tabular_cooling_cuda.fused_cooling_dt`` (one kernel on the
        card)."""
        if self.cooling_time_cfl <= 0.0 or math.isnan(self.cooling_time_cfl):
            return math.inf
        return tabular_cooling_cuda.fused_cooling_dt(self, prim, mesh)

    def cooling_dt_plain(self, prim, mesh):
        """The plain minimum of ``estimate_timestep`` (its CFL on)."""
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

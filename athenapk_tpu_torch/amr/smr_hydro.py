"""Hydro stepping on a static refined mesh (torch).

Counterpart of ``athenapk_tpu/amr/smr_hydro.py``: per-level sweeps with the
level's cell widths, the coarse-fine flux correction (the reference's
``Load/Send/Receive/SetFluxCorrections``, ``src/hydro/hydro_driver.cpp:
507-531``) from the fluxes at each block's interior boundary faces, one
global dt on all levels, and the ghost fill of ``SmrState`` after every
stage.

Two rungs, chosen once, when the stepper is built (the JAX package's
ladder at ``smr_hydro.py:617-650``), or given by the caller
(``stage_rung``; an adaptive run keeps its first stepper's rung):

* 3-D meshes: one ``stage.fused_stage_faces`` call per level per stage
  (cons_to_prim + the sweeps + the 2S update + the face fluxes), then the
  correction on ``u_new`` scaled by ``beta_dt``;
  ``ATHENAPK_PALLAS_STAGE=0`` takes the rung below instead.
* 1-D, 2-D (and 3-D with ``ATHENAPK_PALLAS_STAGE=0``, and every deck with
  ``first_order_flux_correct = true``, as the JAX package's
  ``_use_stage_fused``): per level ``cons_to_prim`` and one
  ``sweep.fused_negdiv_faces`` call, the correction on the -div(F)s, then
  the update.

With first-order flux correction each level's candidate state is checked
after its sweep (one flag read from the card per level and stage); a level
with an interior cell at rho <= 0 or p <= 0 (or NaN) is recomputed with the
plain fluxes and the 4-pass DC + LLF rescue, and its face slabs are taken
from the rescued fluxes, before the coarse-fine restriction (the
reference's task order, ``hydro_driver.cpp:517-531``); ``fofc_rescues``
counts those level stages.

On a CUDA tensor each call launches a Hopper kernel, on a CPU tensor its
plain twin runs: one code path.  (The JAX package's XLA branch, which
replaces whole flux arrays in ``_flux_correct``, is the same correction
written for full flux arrays; it is not ported.)  GLM-MHD takes the Dedner
source of the level (``dedner_plain``, or ``dedner_extended`` with the
divB terms of the stage-start prim, ``emit_prim`` on the stage rung).
``cooling`` (``srcterms.TabularCooling``) acts on every level after the
Dedner source of each stage, and its dt joins the CFL dt over all levels;
``custom_bcs`` go to the ghost fill (``SmrState``).

Diffusion (``athenapk_tpu/amr/smr_hydro.py:336-442``): with ``integrator
= unsplit`` each level's diffusive fluxes of the stage-start prim (plain
PyTorch, the level's cell widths) add their -div(F_diff) to the kernel's
-div(F) (or, on the stage rung, beta_dt times it to ``u_new``) and their
boundary-face slabs to the kernel's slabs before ``_slab_flux_correct``,
so the coarse-fine correction conserves the sum (the JAX package corrects
the summed fluxes; the results differ by rounding).  ``riemann = none``
launches no kernel (zero hyperbolic fluxes) and takes the negdiv rung's
code.  With ``integrator = rkl2`` the stages carry no diffusion:
``sts_half_step`` runs the RKL2 recursion over all levels, each stage's
diffusive fluxes coarse-fine corrected through their slabs (``_diff_div``)
and followed by a ghost fill.  ``problem_source_unsplit(state, prims,
beta_dt, t)`` acts after the per-level sources of every stage; the split
sources (``problem_source_first_order``, ``problem_source_strang``) are
stored here for the driver, which applies them outside the step.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch
from torch.profiler import record_function

from ..core.device import resolve_device
from ..core.indices import (AXIS_OF_DIR, GLMMHD, IB1, IB2, IB3, IDN, IEN,
                            IM1, IM2, IM3, IPS)
from ..diffusion import calc_diff_fluxes, estimate_diff_dt
from ..eos.adiabatic import cons_to_prim
from ..recon import nghost_for
from ..solver import stage, sweep
from ..solver.hydro_pkg import (first_order_flux_correct, fofc_bad_cells,
                                interior_mask, rkl2_super_step,
                                stage_needs_prim)
from ..solver.integrators import INTEGRATORS
from ..solver.sweep import active_dirs
from .smr import SmrMesh, SmrState


class SmrHydro:
    def __init__(self, smesh: SmrMesh, cfg, eos, device="cuda",
                 stage_rung=None, cooling=None, custom_bcs=None,
                 diffusion=None, problem_source_unsplit=None,
                 problem_source_first_order=None,
                 problem_source_strang=None):
        b = smesh.base
        if b.nghost < nghost_for(cfg.reconstruction):
            raise ValueError(
                f"reconstruction '{cfg.reconstruction}' needs nghost >= "
                f"{nghost_for(cfg.reconstruction)}, got {b.nghost}")
        self.smesh = smesh
        self.cfg = cfg
        self.eos = eos
        self.device = resolve_device(device)
        self.cooling = cooling
        self.diffusion = (diffusion if diffusion is not None
                          and diffusion.any_enabled else None)
        self.sts = (self.diffusion is not None
                    and self.diffusion.integrator == "rkl2")
        self._unsplit_diff = (self.diffusion is not None
                              and self.diffusion.integrator == "unsplit")
        self.rkl2_stages = 0
        # problem_source_unsplit(state, prims, beta_dt, t) -> state, per
        # stage; the split sources src(state, dt, t) -> state are applied
        # by the driver outside the step
        self.problem_source_unsplit = problem_source_unsplit
        self.problem_source_first_order = problem_source_first_order
        self.problem_source_strang = problem_source_strang
        self.state_mgr = self._make_state_mgr(custom_bcs)
        self.level_mesh = {lev: smesh.level_mesh(lev)
                           for lev in smesh.level_ids}
        self._dirs = tuple(active_dirs(b))
        self._act = {1: True, 2: b.nx2 > 1, 3: b.nx3 > 1}
        self._g_of_dir = {1: b.ng1, 2: b.ng2, 3: b.ng3}
        self._int_sl = b.interior_slices
        if stage_rung is None:
            stage_rung = os.environ.get("ATHENAPK_PALLAS_STAGE") != "0"
        self._stage_rung = (b.nx2 > 1 and b.nx3 > 1 and bool(stage_rung)
                            and cfg.riemann != "none"
                            and not cfg.first_order_flux_correct)
        self._interior = interior_mask(b.block_shape, b.interior_slices,
                                       self.device)
        self.fofc_rescues = 0     # level stages that took the rescue
        # flux-correction batches: one restricted write per (level, face)
        # group of coarse-fine sites (the face-touching fine kids in octant
        # order, from the ghost-fill plans)
        loc_of = self.state_mgr.loc_of
        fc = {}
        for lev in smesh.level_ids:
            for (li, face, kind, payload) in self.state_mgr._plans[lev]:
                if kind != "fine":
                    continue
                kids = sorted(payload)
                d_list, k_list, ocs = fc.setdefault(
                    (lev, face), ([], [], [oc for (oc, _) in kids]))
                d_list.append(li)
                k_list.append([loc_of[kid][1] for (_, kid) in kids])
        ix = self.state_mgr.index
        self._fc_batch = {key: (ix(d), ix(np.ravel(k)), len(d), ocs)
                          for key, (d, k, ocs) in fc.items()}

    def _make_state_mgr(self, custom_bcs):
        """The ghost fill's plans (``amr.sharded`` fills a rank's rows)."""
        return SmrState(self.smesh, self.cfg.nvar, self.device,
                        custom_bcs=custom_bcs)

    # ------------------------------------------------ coarse-fine correction
    def _restrict_transverse(self, ff, tdims):
        """Average pairs along each active transverse direction of a face
        slab whose last ``len(tdims)`` axes are ``tdims``; inactive dims
        pass through (a 2-D correction averages pairs, not quads)."""
        out = ff
        nt = len(tdims)
        for k, t in enumerate(tdims):
            if not self._act[t]:
                continue
            ax = out.dim() - nt + k
            ev = [slice(None)] * out.dim()
            od = [slice(None)] * out.dim()
            ev[ax] = slice(0, None, 2)
            od[ax] = slice(1, None, 2)
            out = 0.5 * (out[tuple(ev)] + out[tuple(od)])
        return out

    def _slab_flux_correct(self, targets, slabs, scale=1.0):
        """Restrict the fine boundary-face fluxes (transverse pair or quad
        averages) and add the flux difference to the interior cell layer
        beside each corrected coarse face: the same as replacing the coarse
        flux before the divergence.  ``targets`` are the per-level -div(F)s
        (``scale = 1``) or, on the whole-stage rung, the ``u_new`` tensors
        with ``scale = beta_dt``.  Updates ``targets``' tensors in place and
        returns the dict."""
        b = self.smesh.base
        nsz = {1: b.mbnx1, 2: b.mbnx2, 3: b.mbnx3}
        gd = self._g_of_dir
        for (lev, face), (d_arr, kids, nops, ocs) in self._fc_batch.items():
            axis = 3 - face // 2
            d = {3: 1, 2: 2, 1: 3}[axis]
            lo = face % 2 == 0
            g, n = gd[d], nsz[d]
            fidx = 1 if lo else 0   # the fine kids' face on my side
            cidx = 0 if lo else 1
            tdims = sorted([t for t in (1, 2, 3) if t != d], reverse=True)
            t0, t1 = tdims
            Ff = slabs[lev + 1][d].index_select(0, kids)  # [nops*K,nvar,A,B,2]
            fine_face = Ff[:, :, gd[t0]:gd[t0] + nsz[t0],
                           gd[t1]:gd[t1] + nsz[t1], fidx]
            rest = self._restrict_transverse(fine_face, tdims)
            rest = rest.reshape((nops, len(ocs)) + tuple(rest.shape[1:]))
            Fc = torch.zeros((nops, rest.shape[2], nsz[t0], nsz[t1]),
                             dtype=rest.dtype, device=rest.device)
            for col, oc in enumerate(ocs):
                offs = [((oc >> {1: 0, 2: 1, 3: 2}[t]) & 1) * (nsz[t] // 2)
                        for t in tdims]
                Fc[:, :, offs[0]:offs[0] + rest.shape[3],
                   offs[1]:offs[1] + rest.shape[4]] = rest[:, col]
            old = slabs[lev][d].index_select(0, d_arr)[
                :, :, gd[t0]:gd[t0] + nsz[t0], gd[t1]:gd[t1] + nsz[t1], cidx]
            delta = (Fc - old) / self.smesh.dx(lev)[d - 1]
            # div_i = (F[i+1] - F[i]) / dx: a lo coarse face (index g) is the
            # left face of interior cell g (-div += delta); a hi face (index
            # g+n) the right face of cell g+n-1 (-div -= delta)
            layer = g if lo else g + n - 1
            widx = [d_arr, slice(None)] + list(self._int_sl[2:])
            widx[AXIS_OF_DIR[d]] = layer
            widx = tuple(widx)
            sign = 1.0 if lo else -1.0
            t = targets[lev]
            t[widx] = t[widx] + sign * scale * delta
        return targets

    # ----------------------------------------------------------------- core
    def _dedner_source_level(self, u, prim, beta_dt, c_h, lev):
        """Dedner psi damping with the level's smallest cell width, and with
        ``dedner_extended`` the divB terms from central differences of the
        stage-start ``prim`` (``src/hydro/glmmhd/dedner_source.cpp:17-79``;
        the JAX package's ``_dedner_source_level``); in place on ``u``, the
        fresh stage result."""
        coeff = math.exp(-self.cfg.glmmhd_alpha * c_h * beta_dt
                         / self.smesh.min_dx(lev))
        if self.cfg.glmmhd_source == "dedner_extended":
            dx = self.smesh.dx(lev)

            def cdiff(q, d):
                ax = AXIS_OF_DIR[d] - 1    # q has no var axis
                return (torch.roll(q, -1, dims=ax)
                        - torch.roll(q, 1, dims=ax)) / (2.0 * dx[d - 1])

            b1, b2, b3 = prim[:, IB1], prim[:, IB2], prim[:, IB3]
            psi = prim[:, IPS]
            divB = cdiff(b1, 1) + cdiff(b2, 2) + cdiff(b3, 3)
            psi_gradB = (b1 * cdiff(psi, 1) + b2 * cdiff(psi, 2)
                         + b3 * cdiff(psi, 3))
            u[:, IM1] += -beta_dt * divB * b1
            u[:, IM2] += -beta_dt * divB * b2
            u[:, IM3] += -beta_dt * divB * b3
            u[:, IEN] += -beta_dt * psi_gradB
        u[:, IPS] *= coeff
        return u

    def _need_prim(self):
        return stage_needs_prim(self.cfg, self._unsplit_diff,
                                self.problem_source_unsplit)

    def _diff_fluxes(self, prim, lev):
        """The level's diffusive flux tensors (the level's cell widths)."""
        return calc_diff_fluxes(self.diffusion, prim, self.level_mesh[lev])

    def _diff_terms(self, lev, prim):
        """One level's diffusion: ``(-div(F_diff), F_diff's boundary-face
        slabs)``."""
        lm = self.level_mesh[lev]
        fd = self._diff_fluxes(prim, lev)
        return -sweep.flux_divergence(fd, lm), sweep.boundary_faces(fd, lm)

    def _fofc_level(self, lev, u0f, u1, prim, c_h, recon, gam0, gam1,
                    beta_dt, negdiv, slabs):
        """The first-order rescue of one level (the JAX package's
        ``_fused_level_stage``): ``(negdiv, slabs)`` as they came from the
        sweep, or, where the candidate state has a bad interior cell,
        recomputed from the plain fluxes after the 4-pass rescue."""
        u_cand = gam0 * u0f + gam1 * u1 + beta_dt * negdiv
        any_bad = fofc_bad_cells(self.cfg, u_cand, self._interior).any()
        with record_function("host_read"):
            rescue = bool(any_bad)
        if not rescue:
            return negdiv, slabs
        self.fofc_rescues += 1
        lm = self.level_mesh[lev]
        if self.cfg.riemann == "none":
            fluxes = {d: torch.zeros_like(prim) for d in self._dirs}
        else:
            fluxes = sweep.compute_fluxes(prim, c_h, lm, self.cfg, self.eos,
                                          recon)
        if self._unsplit_diff:
            fd = self._diff_fluxes(prim, lev)
            fluxes = {d: fluxes[d] + fd[d] for d in fluxes}
        fluxes = first_order_flux_correct(
            self.cfg, self.eos, self._dirs,
            {d: lm.dx[d - 1] for d in self._dirs}, self._interior, u0f, u1,
            prim, fluxes, gam0, gam1, beta_dt, c_h)
        return (-sweep.flux_divergence(fluxes, lm),
                sweep.boundary_faces(fluxes, lm))

    def _stage_impl(self, s, state, state1, dt, c_h, t=0.0):
        """One 2S-integrator stage without the ghost fill: per-level sweeps
        (and unsplit diffusion), the coarse-fine correction, the update, the
        Dedner source, cooling and the unsplit problem source.  Returns new
        level tensors."""
        cfg = self.cfg
        tab = INTEGRATORS[cfg.integrator]
        recon = cfg.reconstruction
        if cfg.integrator == "vl2" and s == 0:
            recon = "dc"
        gam0, gam1 = tab["gam0"][s], tab["gam1"][s]
        beta_dt = tab["beta"][s] * dt
        slabs = {}
        prims = {}
        need_prim = self._need_prim()
        if self._stage_rung:
            u_news = {}
            for lev, u in state.items():
                u_news[lev], prims[lev], slabs[lev] = \
                    stage.fused_stage_faces(
                        u, state1[lev], gam0, gam1, beta_dt, c_h,
                        self.level_mesh[lev], cfg, self.eos, recon,
                        emit_prim=need_prim)
                if self._unsplit_diff:
                    nd, fs = self._diff_terms(lev, prims[lev])
                    u_news[lev] += beta_dt * nd
                    slabs[lev] = {d: slabs[lev][d] + fs[d] for d in fs}
            out = self._slab_flux_correct(u_news, slabs, scale=beta_dt)
        else:
            negdivs, u0f = {}, {}
            for lev, u in state.items():
                u0f[lev], prim = cons_to_prim(self.eos, u, cfg.fluid,
                                              cfg.nscalars)
                prims[lev] = prim
                if cfg.riemann != "none":
                    negdivs[lev], slabs[lev] = sweep.fused_negdiv_faces(
                        prim, c_h, self.level_mesh[lev], cfg, self.eos,
                        recon)
                    if self._unsplit_diff:
                        nd, fs = self._diff_terms(lev, prim)
                        negdivs[lev] += nd
                        slabs[lev] = {d: slabs[lev][d] + fs[d] for d in fs}
                elif self._unsplit_diff:
                    # the null solver: the diffusive fluxes alone
                    negdivs[lev], slabs[lev] = self._diff_terms(lev, prim)
                else:
                    zero = torch.zeros_like(prim)
                    negdivs[lev] = zero
                    slabs[lev] = sweep.boundary_faces(
                        {d: zero for d in self._dirs}, self.level_mesh[lev])
                if cfg.first_order_flux_correct:
                    negdivs[lev], slabs[lev] = self._fofc_level(
                        lev, u0f[lev], state1[lev], prim, c_h, recon, gam0,
                        gam1, beta_dt, negdivs[lev], slabs[lev])
            negdivs = self._slab_flux_correct(negdivs, slabs)
            out = {lev: gam0 * u0f[lev] + gam1 * state1[lev]
                   + beta_dt * negdivs[lev] for lev in state}
        for lev in out:
            if cfg.fluid == GLMMHD:
                out[lev] = self._dedner_source_level(
                    out[lev], prims.get(lev), beta_dt, c_h, lev)
            if self.cooling is not None:
                # pointwise unsplit cooling per level and stage, after the
                # Dedner damping (the uniform path's order), in place on
                # the fresh stage result
                out[lev] = self.cooling.apply_in_place(out[lev], beta_dt,
                                                       cfg.fluid)
        if self.problem_source_unsplit is not None:
            # per-level sources with cross-level reductions
            # (AddUnsplitSources)
            out = self.problem_source_unsplit(out, prims, beta_dt, t)
        return out

    def step(self, state, dt, c_h, t=0.0):
        """One cycle (all integrator stages, each followed by the ghost
        fill): ``{level: u}`` ghost-filled in, new ghost-filled tensors out;
        the input tensors are left as they were.  ``t``: the cycle's start
        time (the unsplit problem source reads it)."""
        u0 = state
        for s in range(INTEGRATORS[self.cfg.integrator]["nstages"]):
            u0 = self.state_mgr.fill_ghosts(
                self._stage_impl(s, u0, state, dt, c_h, t))
        return u0

    def fill_ghosts(self, state):
        return self.state_mgr.fill_ghosts(state)

    # ------------------------------------------------------------------ RKL2
    def _diff_div(self, state):
        """-div(F_diff) per level from the ghost-filled cons (the RKL2
        operator M), the diffusive fluxes coarse-fine corrected through
        their face slabs, for conservation across levels."""
        negdivs, slabs = {}, {}
        for lev, u in state.items():
            _, prim = cons_to_prim(self.eos, u, self.cfg.fluid,
                                   self.cfg.nscalars)
            negdivs[lev], slabs[lev] = self._diff_terms(lev, prim)
        return self._slab_flux_correct(negdivs, slabs)

    def _rkl2_first(self, state, tau, s_rkl):
        """Y1 = Y0 + mu_tilde_1 tau M(Y0) on every level
        (``RKL2StepFirst``)."""
        s = float(s_rkl)
        mu_tilde_1 = 4.0 / 3.0 / (s * s + s - 2.0)
        MY0 = self._diff_div(state)
        self.rkl2_stages += 1
        return self.state_mgr.fill_ghosts(
            {lev: state[lev] + mu_tilde_1 * tau * MY0[lev]
             for lev in state}), MY0

    def _rkl2_other(self, Yjm1, Yjm2, Y0, MY0, coeffs, tau):
        """One RKL2 recursion stage on every level (``RKL2StepOther``)."""
        mu_j, nu_j, mu_tilde_j, gamma_tilde_j = coeffs
        MYjm1 = self._diff_div(Yjm1)
        self.rkl2_stages += 1
        return self.state_mgr.fill_ghosts(
            {lev: (mu_j * Yjm1[lev] + nu_j * Yjm2[lev]
                   + (1.0 - mu_j - nu_j) * Y0[lev]
                   + mu_tilde_j * tau * MYjm1[lev]
                   + gamma_tilde_j * tau * MY0[lev]) for lev in Y0})

    def sts_half_step(self, state, tau, dt_diff: float):
        """RKL2 super-time-step over ``tau`` on the refined mesh (one half
        of the Strang wrap; ``hydro_pkg.HydroPackage.sts_half_step``)."""
        return rkl2_super_step(state, tau, dt_diff, self._rkl2_first,
                               self._rkl2_other)

    # ------------------------------------------------------------------- dt
    def estimate_dt(self, state):
        """The dt over every level's interior cells as a 0-d tensor on the
        state's device: the hyperbolic CFL dt, the cooling dt with cooling,
        and with diffusion ``estimate_dt_with_diff``'s policy."""
        if self.diffusion is not None:
            return self.estimate_dt_with_diff(state)[0]
        return self._hyp_dt(state)

    def estimate_dt_with_diff(self, state):
        """``(dt, dt_diff)`` as 0-d tensors: unsplit takes the strict
        minimum, rkl2 keeps the hyperbolic dt capped at
        ``rkl2_max_dt_ratio * dt_diff`` (the JAX package's
        ``_estimate_dt_with_diff_impl``)."""
        dt_hyp = self._hyp_dt(state)
        dt_diff = torch.full_like(dt_hyp, math.inf)
        for lev, u in state.items():
            _, w = cons_to_prim(self.eos, u, self.cfg.fluid,
                                self.cfg.nscalars)
            dt_diff = torch.minimum(dt_diff, torch.as_tensor(
                estimate_diff_dt(self.diffusion, w, self.level_mesh[lev],
                                 self.cfg.cfl),
                dtype=dt_hyp.dtype, device=dt_hyp.device))
        dt_diff = self._global_min(dt_diff)
        if not self.sts:
            return torch.minimum(dt_hyp, dt_diff), dt_diff
        ratio = self.diffusion.rkl2_max_dt_ratio
        dt = dt_hyp
        if ratio > 0.0:
            dt = torch.where(dt_hyp / dt_diff > ratio, ratio * dt_diff, dt)
        return dt, dt_diff

    def _hyp_dt(self, state):
        """The hyperbolic CFL dt over every level's interior cells, and the
        cooling dt over them with cooling, as a 0-d tensor on the state's
        device."""
        min_dt = None
        prims = {}
        for lev, u in state.items():
            _, w = cons_to_prim(self.eos, u, self.cfg.fluid, self.cfg.nscalars)
            prims[lev] = w
            m = torch.min(stage.raw_cfl_dt(w[self._int_sl],
                                           self.level_mesh[lev], self.cfg,
                                           self.eos, self._dirs))
            min_dt = m if min_dt is None else torch.minimum(min_dt, m)
        dt = self.cfg.cfl * min_dt
        if self.cooling is not None:
            for lev, w in prims.items():
                dt = torch.minimum(dt, torch.as_tensor(
                    self.cooling.estimate_timestep(w, self.level_mesh[lev]),
                    dtype=dt.dtype, device=dt.device))
        return self._global_min(dt)

    def _global_min(self, t):
        """The minimum of a 0-d tensor over every leaf's owner: the tensor
        itself on one device (``amr.sharded`` reduces over ranks)."""
        return t

    def dt_pack(self, state, tm_dt, t, tlim):
        """``[dt_raw, dt_eff, c_h]`` on the device, in the state's dtype:
        the CFL dt capped at twice the last step (``tm_dt``), then at the
        time left to ``tlim``, and the GLM cleaning speed for it.  ``t``,
        ``tm_dt`` and ``tlim - t`` are rounded to the state's dtype first,
        as the JAX package's device scalars are."""
        est = self.estimate_dt(state)
        np_dtype = np.float32 if est.dtype == torch.float32 else np.float64
        dt_raw = torch.clamp(est, max=float(2.0 * np_dtype(tm_dt)))
        dt_eff = torch.clamp(dt_raw, max=float(np_dtype(tlim) - np_dtype(t)))
        if self.cfg.fluid == GLMMHD:
            mindx = self.smesh.min_dx(self.smesh.max_level)
            c_h = torch.where(
                dt_eff > 0,
                torch.full_like(dt_eff, self.cfg.cfl * mindx) / dt_eff, 0.0)
        else:
            c_h = torch.zeros_like(dt_eff)
        return torch.stack([dt_raw, dt_eff, c_h])

    # ------------------------------------------------------------ reductions
    def total_mass(self, state):
        total = 0.0
        for lev, u in state.items():
            d1, d2, d3 = self.smesh.dx(lev)
            total = total + float(torch.sum(u[self._int_sl][:, IDN])) \
                * (d1 * d2 * d3)
        return total

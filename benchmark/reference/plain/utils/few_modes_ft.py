# A frozen copy of athenapk_tpu_torch/utils/few_modes_ft.py for the benchmark's plain
# reference of the cluster; it imports nothing of the program.
"""Few-modes inverse Fourier transform and Ornstein-Uhlenbeck forcing
(torch).

Counterpart of ``athenapk_tpu/utils/few_modes_ft.py`` (reference
``src/utils/few_modes_ft.{hpp,cpp}``): an explicit inverse transform of a
few (<= ~100) modes.  The per-block factorised phase tables
``phase_d[b, idx, m] = exp(i k_d x_d)`` are built on the host once and
moved to the device the state is on; the transform is two complex
``einsum``s there.

The OU state (``var_hat``) and the random draws live on the host, as in
the JAX package and the reference (``few_modes_ft.cpp:208-220``): numpy's
``default_rng`` with the JAX package's draws in the same order, so the
same seed gives the same spectrum bit for bit.  ``get_state`` /
``set_state`` carry ``var_hat`` and the bit generator's state.

Dtype: ``var_hat`` and the phase tables are complex128 and the field the
transform returns is float64, whatever the state's dtype (the JAX package
runs with x64 on); a caller casts only where it adds the field to the
state.
"""

from __future__ import annotations

import numpy as np
import torch


class FewModesFT:
    def __init__(self, mesh, num_modes: int, k_vec, k_peak: float,
                 sol_weight: float, t_corr: float, rseed: int,
                 fill_ghosts: bool = False):
        self.mesh = mesh
        self.num_modes = num_modes
        self.k_vec = np.asarray(k_vec, dtype=np.float64)  # [3, M]
        assert self.k_vec.shape == (3, num_modes)
        self.k_peak = k_peak
        assert sol_weight == -1.0 or 0.0 <= sol_weight <= 1.0
        self.sol_weight = sol_weight
        self.t_corr = t_corr
        self.fill_ghosts = fill_ghosts
        self.rng = np.random.default_rng(rseed)
        self.var_hat = np.zeros((3, num_modes), dtype=np.complex128)
        self._phases = None   # host tables (phase_i, phase_j, phase_k)
        self._on = {}         # the tables on each device

    # ------------------------------------------------------------- phases
    def set_phases(self):
        """Per-block factorised phase tables (``SetPhases``,
        ``few_modes_ft.cpp:87-160``): phase_d[b, idx, m] = exp(i k_d x_d);
        the kx = 0 modes carry the 1/2 of the half-complex sum."""
        mesh = self.mesh
        g = mesh.nghost if self.fill_ghosts else 0
        M = self.num_modes

        def phases_for(axis_n, gn, block_n, origin_cells):
            idx = np.arange(-g if self.fill_ghosts else 0,
                            block_n + g if self.fill_ghosts else block_n)
            out = np.empty((mesh.nblocks, len(idx), M), dtype=np.complex128)
            for b in range(mesh.nblocks):
                gidx = (origin_cells[b] + idx) % gn
                w = self.k_vec[axis_n][None, :] * 2.0 * np.pi / gn
                out[b] = np.exp(1j * w * gidx[:, None])
            return out

        origins = np.array([[(b % mesh.nb1) * mesh.mbnx1,
                             ((b // mesh.nb1) % mesh.nb2) * mesh.mbnx2,
                             (b // (mesh.nb1 * mesh.nb2)) * mesh.mbnx3]
                            for b in range(mesh.nblocks)])
        pi = phases_for(0, mesh.nx1, mesh.mbnx1, origins[:, 0])
        pj = phases_for(1, mesh.nx2, mesh.mbnx2, origins[:, 1])
        pk = phases_for(2, mesh.nx3, mesh.mbnx3, origins[:, 2])
        half = np.where(self.k_vec[0] == 0.0, 0.5, 1.0)
        self._phases = (pi * half[None, None, :], pj, pk)
        self._on = {}

    def phases_on(self, device):
        """The phase tables as complex128 tensors on ``device``."""
        if self._phases is None:
            self.set_phases()
        device = torch.device(device)
        if device not in self._on:
            self._on[device] = tuple(torch.as_tensor(p, device=device)
                                     for p in self._phases)
        return self._on[device]

    # ------------------------------------------------------------ generate
    def generate(self, dt: float, device="cuda"):
        """Evolve the OU process and return the real-space field
        ``[3, nblocks, nz, ny, nx]`` (f64, interior cells unless
        ``fill_ghosts``) on ``device`` (the card unless the caller asks for
        the CPU)."""
        self.update_var_hat(dt)
        return self.inverse_transform(self.phases_on(device))

    def update_var_hat(self, dt: float):
        """Evolve the OU spectrum one step on the host (callers with several
        phase tables, the refined meshes, evolve once and transform per
        level).  Spectrum (k/kpeak)^2 (2 - (k/kpeak)^2); Gaussian complex
        amplitudes by Marsaglia's polar method; the optional solenoidal
        projection; OU drift c = exp(-dt/t_corr) (``Generate``,
        ``few_modes_ft.cpp:197-330``)."""
        M = self.num_modes
        # Marsaglia polar draws (sequential on the host, as the reference)
        r = np.empty((3, M, 2))
        for n in range(3):
            for m in range(M):
                while True:
                    v1, v2 = self.rng.uniform(-1.0, 1.0, 2)
                    s = v1 * v1 + v2 * v2
                    if 0.0 < s < 1.0:
                        break
                r[n, m] = (v1, v2)
        kmag = np.sqrt((self.k_vec ** 2).sum(axis=0))
        tmp = np.maximum((kmag / self.k_peak) ** 2
                         * (2.0 - (kmag / self.k_peak) ** 2), 0.0)
        v_sqr = (r ** 2).sum(axis=-1)
        norm = np.sqrt(-2.0 * np.log(v_sqr) / v_sqr)
        var_hat_new = tmp[None, :] * norm * (r[..., 0] + 1j * r[..., 1])

        # hermitian symmetry of the kx = 0 conjugate pairs
        for m in range(M):
            if self.k_vec[0, m] == 0.0:
                for m2 in range(m):
                    if (self.k_vec[1, m] == -self.k_vec[1, m2]
                            and self.k_vec[2, m] == -self.k_vec[2, m2]):
                        var_hat_new[:, m] = np.conj(var_hat_new[:, m2])

        # solenoidal / compressive projection
        if self.sol_weight >= 0.0:
            khat = self.k_vec / np.where(kmag == 0.0, 1.0, kmag)
            dot = (var_hat_new * khat).sum(axis=0)
            s = self.sol_weight
            var_hat_new = (s * var_hat_new
                           + (1.0 - 2.0 * s) * dot[None, :] * khat)

        c_drift = np.exp(-dt / self.t_corr)
        c_diff = np.sqrt(1.0 - c_drift * c_drift)
        self.var_hat = self.var_hat * c_drift + var_hat_new * c_diff

    def inverse_transform(self, phases):
        """``acc[n,b,k,j,i] = 2 Re sum_m vhat[n,m] Pi[b,i,m] Pj[b,j,m]
        Pk[b,k,m]`` as two complex einsums on the tables' device; f64."""
        pi, pj, pk = phases
        vh = torch.as_tensor(self.var_hat, device=pi.device)
        pkj = torch.einsum("bkm,bjm->bkjm", pk, pj)
        acc = torch.einsum("nm,bkjm,bim->nbkji", vh, pkj, pi)
        del pkj
        return 2.0 * acc.real

    # -------------------------------------------------------------- state
    def get_state(self):
        """(var_hat, rng_state) for a checkpoint or a carried-over run."""
        return self.var_hat.copy(), self.rng.bit_generator.state

    def set_state(self, var_hat, rng_state):
        self.var_hat = np.asarray(var_hat, dtype=np.complex128)
        self.rng.bit_generator.state = rng_state


def make_random_modes(num_modes: int, k_peak: float, rseed: int = 31224):
    """A random mode set in the parabolic band (``MakeRandomModes``,
    ``few_modes_ft.cpp:250-312``): the kx >= 0 half-space, |k| in
    [kpeak/2, 2 kpeak], no duplicates.  -> float64 [3, M]."""
    rng = np.random.default_rng(rseed)
    k_low = int(np.floor(k_peak / 2))
    k_high = int(np.ceil(2 * k_peak))
    modes = []
    attempts = 0
    while len(modes) < num_modes and attempts < 1_000_000:
        attempts += 1
        k = rng.integers(-k_high, k_high + 1, 3)
        kmag = np.sqrt((k ** 2).sum())
        ampl = (kmag / k_peak) ** 2 * (2.0 - (kmag / k_peak) ** 2)
        if (ampl < 0 or kmag < k_low or kmag > k_high or k[0] < 0
                or any((k == m).all() for m in modes)):
            continue
        modes.append(k)
    if len(modes) < num_modes:
        raise RuntimeError("mode generation failed")
    return np.asarray(modes, dtype=np.float64).T  # [3, M]

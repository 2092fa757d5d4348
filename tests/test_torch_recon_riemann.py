"""Port parity: reconstruction and Riemann solvers against the JAX package.

Inputs are made with numpy from a seed and fed to both packages in f64.
Tolerance 1e-12 relative to the largest magnitude: the formulas are the
same operation by operation, so the results agree to rounding (in practice
bit for bit).  The reconstruction data are coarse multiples of 0.25 with
signed zeros, so that many differences are exactly 0 and ``sgn(0) = +1``
(not ``copysign``'s -1 for -0.0) decides limiter branches.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from athenapk_tpu.eos.adiabatic import EOS as JEOS
from athenapk_tpu.recon import schemes as jrec
from athenapk_tpu.riemann import solvers as jrs
from athenapk_tpu_torch.eos.adiabatic import EOS as TEOS
from athenapk_tpu_torch.recon import schemes as trec
from athenapk_tpu_torch.riemann import solvers as trs

torch.set_num_threads(2)

TOL = 1e-12


def _rel(a, b):
    a = np.asarray(a)
    b = np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(a).max(), 1e-300)


def _coarse(seed, shape):
    rng = np.random.default_rng(seed)
    q = rng.integers(-3, 4, size=shape) * 0.25
    q[rng.random(shape) < 0.1] = -0.0          # signed zeros
    return q


@pytest.mark.parametrize("axis", [-1, -2, -3])
@pytest.mark.parametrize("recon", ["dc", "plm", "ppm"])
def test_reconstruction_matches_jax(recon, axis):
    q = _coarse(11, (2, 3, 8, 9, 10))
    q += np.random.default_rng(3).standard_normal(q.shape) * \
        (np.random.default_rng(4).random(q.shape) < 0.5)
    jm, jp = jrec.reconstruct(recon, jnp.asarray(q), axis, 0.1)
    tm, tp = trec.reconstruct(recon, torch.tensor(q), axis, 0.1)
    assert _rel(jm, tm.numpy()) <= TOL
    assert _rel(jp, tp.numpy()) <= TOL


@pytest.mark.parametrize("recon", ["plm", "ppm"])
def test_reconstruction_sign_of_zero(recon):
    """Piecewise-constant steps give exact-zero slopes and curvatures."""
    q = _coarse(5, (1, 2, 6, 6, 12))
    jm, jp = jrec.reconstruct(recon, jnp.asarray(q), -1, 1.0)
    tm, tp = trec.reconstruct(recon, torch.tensor(q), -1, 1.0)
    np.testing.assert_array_equal(np.asarray(jm), tm.numpy())
    np.testing.assert_array_equal(np.asarray(jp), tp.numpy())
    assert trec._sgn(torch.tensor([-0.0, 0.0, -1e-300], dtype=torch.float64)
                    ).tolist() == [1.0, 1.0, -1.0]


MASK = (True, False, False, False, True)   # density and pressure of 5


def _high_order_state(seed, shape):
    """Noise of O(0.3) in the velocities (LimO3's limited branch at dx =
    0.1); density and pressure small and positive with jumps of a few
    1e-3, LimO3's smooth third-order branch, whose edges overshoot below
    zero (the positivity fallback's cases)."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal(shape) * 0.3
    q[:, 0] = 1e-4 + 5e-3 * rng.random(q[:, 0].shape)
    q[:, 4] = 1e-4 + 4e-3 * rng.random(q[:, 4].shape)
    return q


@pytest.mark.parametrize("masked", [False, True], ids=["plain", "mask"])
@pytest.mark.parametrize("axis", [-1, -2, -3])
@pytest.mark.parametrize("recon", ["weno3", "limo3", "wenoz"])
def test_high_order_reconstruction_matches_jax(recon, axis, masked):
    q = _high_order_state(7, (2, 5, 8, 9, 10))
    mask = MASK if masked else None
    jm, jp = jrec.reconstruct(recon, jnp.asarray(q), axis, 0.1,
                              positivity_mask=mask)
    tm, tp = trec.reconstruct(recon, torch.tensor(q), axis, 0.1,
                              positivity_mask=mask)
    assert _rel(jm, tm.numpy()) <= TOL
    assert _rel(jp, tp.numpy()) <= TOL
    if recon == "limo3":
        # the state reaches the fallback: without it some density or
        # pressure edge is <= 0, with it none is
        um, up = trec.reconstruct(recon, torch.tensor(q), axis, 0.1)
        low = (torch.minimum(um, up)[:, [0, 4]] <= 0.0).sum().item()
        assert low > 0
        if masked:
            assert (torch.minimum(tm, tp)[:, [0, 4]] <= 0.0).sum() < low


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_limo3_switch_at_eta_one(dtype):
    """LimO3's three-way select on eta against 1 +- 10 eps: steps of a
    size that puts eta within a few eps of 1, so every branch is taken in
    f64 and in f32 (each dtype with its own eps), and the port agrees
    with the JAX package on each."""
    rng = np.random.default_rng(3)
    dx = 0.1
    np_t = np.dtype(dtype)
    a = np.sqrt(0.5) * 0.1 * dx           # eta = 1 for two steps of a
    eps = np.finfo(np_t).eps
    steps = a * (1.0 + eps * rng.integers(-12, 13, size=(1, 1, 1, 1, 64)))
    q = np.cumsum(steps, axis=-1).astype(np_t)
    q = np.broadcast_to(q, (1, 2, 2, 2, 64)).copy()
    jm, jp = jrec.reconstruct("limo3", jnp.asarray(q), -1, dx)
    tm, tp = trec.reconstruct("limo3", torch.tensor(q), -1, dx)
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=0,
                               atol=8 * eps * np.abs(q).max())
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=0,
                               atol=8 * eps * np.abs(q).max())
    # eta on both sides of the switch and inside its blend
    t = torch.tensor(q)
    dvp = torch.roll(t, -1, -1) - t
    dvm = t - torch.roll(t, 1, -1)
    eta = ((dvm * dvm + dvp * dvp) / trec.limo3_rdx2(dx))[..., 1:-1]
    e = trec.limo3_eps(t.dtype)
    assert (eta <= 1.0 - e).any() and (eta >= 1.0 + e).any()
    assert ((eta > 1.0 - e) & (eta < 1.0 + e)).any()


def _face_states(fluid, nscalars, seed):
    rng = np.random.default_rng(seed)
    nvar = (9 if fluid == "glmmhd" else 5) + nscalars
    w = []
    for _ in range(2):
        s = rng.standard_normal((2, nvar, 5, 6, 7))
        s[:, 0] = rng.uniform(0.1, 3.0, s[:, 0].shape)     # density
        s[:, 4] = rng.uniform(0.05, 3.0, s[:, 4].shape)    # pressure
        w.append(s)
    wl, wr = w
    # a share of faces with equal states, weak or zero normal field and
    # zero velocities: the degenerate branches of HLLC/HLLD
    same = rng.random(wl.shape[2:]) < 0.1
    wr[:, :, same] = wl[:, :, same]
    if fluid == "glmmhd":
        weak = rng.random(wl.shape[2:]) < 0.2
        for d in range(3):
            wl[:, 5 + d][:, weak] *= 1e-3
            wr[:, 5 + d][:, weak] *= 1e-3
        zero = rng.random(wl.shape[2:]) < 0.1
        wl[:, 1:4][:, :, zero] = 0.0
        wr[:, 1:4][:, :, zero] = 0.0
    return wl, wr


@pytest.mark.parametrize("dirn", [1, 2, 3])
@pytest.mark.parametrize("fluid,solver", [
    ("euler", "llf"), ("euler", "hlle"), ("euler", "hllc"),
    ("glmmhd", "llf"), ("glmmhd", "hlle"), ("glmmhd", "hlld"),
])
def test_riemann_matches_jax(fluid, solver, dirn):
    nscalars = 1
    wl, wr = _face_states(fluid, nscalars, seed=dirn * 100 + len(solver))
    c_h = 1.3 if fluid == "glmmhd" else None
    jf = jrs.solve_riemann(solver, fluid, JEOS(gamma=5.0 / 3.0),
                           jnp.asarray(wl), jnp.asarray(wr), dirn, c_h=c_h,
                           nscalars=nscalars)
    tf = trs.solve_riemann(solver, fluid, TEOS(gamma=5.0 / 3.0),
                           torch.tensor(wl), torch.tensor(wr), dirn, c_h=c_h,
                           nscalars=nscalars)
    assert tf.shape == tuple(jf.shape)
    assert np.isfinite(tf.numpy()).all()
    assert _rel(jf, tf.numpy()) <= TOL

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


@pytest.mark.parametrize("recon", ["weno3", "limo3", "wenoz"])
def test_unported_reconstruction_raises(recon):
    with pytest.raises(NotImplementedError, match=recon):
        trec.reconstruct(recon, torch.zeros(1, 1, 4, 4, 4), -1, 1.0)


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

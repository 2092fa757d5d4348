"""Port parity: ``athenapk_tpu_torch.eos.adiabatic`` against the JAX EOS.

Random conserved states (numpy, seeded) go through both packages' f64
``cons_to_prim`` / ``prim_to_cons``.  The states are drawn so that some
cells trip every floor and ceiling.  Tolerance 1e-13 relative to the
largest magnitude: the two packages run the same IEEE operations, so only
the last bit of a division or a square root may differ.
"""

import zlib

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from athenapk_tpu.eos import adiabatic as jeos
from athenapk_tpu_torch.eos import adiabatic as teos
from torch_decks import eos_cons

torch.set_num_threads(2)

RTOL = 1e-13

EOS_CASES = {
    "no_floors": {},
    "all_floors": dict(density_floor=0.3, pressure_floor=0.05,
                       internal_e_floor=0.2, velocity_ceiling=1.5,
                       internal_e_ceiling=3.0),
    "pressure_floor": dict(pressure_floor=0.1),
    "efloor_eceil": dict(internal_e_floor=0.3, internal_e_ceiling=1.0),
    "vceil": dict(velocity_ceiling=0.8),
}


def _rel(a, b):
    a = np.asarray(a)
    b = np.asarray(b)
    return np.nanmax(np.abs(a - b)) / np.nanmax(np.abs(a))


@pytest.mark.parametrize("case", sorted(EOS_CASES))
@pytest.mark.parametrize("fluid,nscalars", [("euler", 0), ("glmmhd", 0),
                                            ("glmmhd", 2)])
def test_cons_to_prim_matches_jax(case, fluid, nscalars):
    kw = EOS_CASES[case]
    seed = zlib.crc32(f"{case}/{fluid}/{nscalars}".encode())
    u = eos_cons(fluid, nscalars, seed)
    j_u, j_w = jeos.cons_to_prim(jeos.EOS(gamma=5.0 / 3.0, **kw),
                                 jnp.asarray(u), fluid, nscalars)
    t_u, t_w = teos.cons_to_prim(teos.EOS(gamma=5.0 / 3.0, **kw),
                                 torch.tensor(u, dtype=torch.float64),
                                 fluid, nscalars)
    assert t_w.dtype == torch.float64
    # the NaN pattern (negative pressures with the floors off) must agree
    np.testing.assert_array_equal(np.isnan(np.asarray(j_w)),
                                  np.isnan(t_w.numpy()))
    assert _rel(j_w, t_w.numpy()) <= RTOL
    assert _rel(j_u, t_u.numpy()) <= RTOL


def test_floor_cases_trip_every_floor():
    """The drawn states really exercise each floor and ceiling."""
    u = eos_cons("glmmhd", 0, seed=1)
    eos = teos.EOS(gamma=5.0 / 3.0)
    _, w = teos.cons_to_prim(eos, torch.tensor(u), "glmmhd")
    rho = u[:, 0]
    v2 = (u[:, 1] ** 2 + u[:, 2] ** 2 + u[:, 3] ** 2) / rho ** 2
    eint = w[:, 4].numpy() / (eos.gm1 * rho)
    kw = EOS_CASES["all_floors"]
    assert (rho < kw["density_floor"]).any()
    assert (w[:, 4].numpy() < kw["pressure_floor"]).any()
    assert (eint < kw["internal_e_floor"]).any()
    assert (eint > kw["internal_e_ceiling"]).any()
    assert (v2 > kw["velocity_ceiling"] ** 2).any()


@pytest.mark.parametrize("fluid,nscalars", [("euler", 0), ("glmmhd", 0),
                                            ("glmmhd", 1)])
def test_prim_to_cons_and_speeds_match_jax(fluid, nscalars):
    rng = np.random.default_rng(7)
    nvar = (9 if fluid == "glmmhd" else 5) + nscalars
    w = rng.standard_normal((3, nvar, 4, 4, 4))
    w[:, 0] = rng.uniform(0.2, 2.0, w[:, 0].shape)
    w[:, 4] = rng.uniform(0.1, 2.0, w[:, 4].shape)
    je = jeos.EOS(gamma=1.4)
    te = teos.EOS(gamma=1.4)
    wt = torch.tensor(w)
    assert _rel(jeos.prim_to_cons(je, jnp.asarray(w), fluid, nscalars),
                teos.prim_to_cons(te, wt, fluid, nscalars).numpy()) <= RTOL
    assert _rel(jeos.sound_speed(je, jnp.asarray(w[:, 0]),
                                 jnp.asarray(w[:, 4])),
                teos.sound_speed(te, wt[:, 0], wt[:, 4]).numpy()) <= RTOL
    if fluid == "glmmhd":
        args = [w[:, i] for i in (0, 4, 5, 6, 7)]
        assert _rel(jeos.fast_magnetosonic_speed(
                        je, *[jnp.asarray(a) for a in args]),
                    teos.fast_magnetosonic_speed(
                        te, *[torch.tensor(a) for a in args]).numpy()) <= RTOL


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_sqrt_is_correctly_rounded_on_the_cpu(dtype):
    """``core.ieee.sqrt`` on CPU tensors equals IEEE's square root (numpy's
    and XLA's) bit for bit, also on strided views and 0-d tensors, where
    ``torch.sqrt`` takes MKL's vector math (about 1 % of values an ulp
    off, and chunked across threads)."""
    from athenapk_tpu_torch.core.ieee import sqrt

    rng = np.random.default_rng(11)
    x = (rng.random(1 << 16) * 10.0 + 1e-6).astype(dtype)
    want = np.sqrt(x)
    np.testing.assert_array_equal(sqrt(torch.from_numpy(x)).numpy(), want)
    np.testing.assert_array_equal(np.asarray(jnp.sqrt(jnp.asarray(x))), want)
    view = torch.from_numpy(x).reshape(256, 256)[:, ::3]
    got = sqrt(view)
    assert got.shape == view.shape and got.dtype == view.dtype
    np.testing.assert_array_equal(got.numpy(), np.sqrt(view.numpy()))
    assert sqrt(torch.tensor(2.0, dtype=torch.float64)).item() == \
        np.sqrt(2.0)
    assert torch.isnan(sqrt(torch.tensor([-1.0]))).all()

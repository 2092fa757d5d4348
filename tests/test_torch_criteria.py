"""Port parity: the adaptive-mesh tagging criteria
(``refinement/criteria.py``) against ``athenapk_tpu.refinement.criteria`` on
the CPU in f64.

Random primitive states (numpy, seeded) on 2-D and 3-D ghosted blocks.  The
tags must be equal at a threshold that splits the blocks into all three
tags.  The per-block criterion values are held through the JAX functions
themselves: with the port's value of each block as that block's threshold,
scaled by 1 -/+ 1e-14, every JAX tag must be +1 / not +1, so the two values
agree to 1e-14 relative.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from athenapk_tpu.config.parameter_input import ParameterInput as JPin
from athenapk_tpu.core.mesh import Mesh as JMesh
from athenapk_tpu.refinement import criteria as jcrit
from athenapk_tpu_torch.config.parameter_input import ParameterInput
from athenapk_tpu_torch.core.mesh import Mesh
from athenapk_tpu_torch.refinement import RefinementConfig, check_refinement
from athenapk_tpu_torch.refinement import criteria as tcrit

torch.set_num_threads(2)

REL = 1e-14
DOMAIN = dict(x1min=0.0, x1max=1.0, x2min=0.0, x2max=1.0, x3min=-0.5,
              x3max=0.5)
MESHES = {
    "2d": dict(nx1=32, nx2=32, nx3=1, mbnx1=8, mbnx2=8, mbnx3=1, nghost=2,
               **DOMAIN),
    "3d": dict(nx1=16, nx2=16, nx3=16, mbnx1=8, mbnx2=8, mbnx3=8, nghost=3,
               **DOMAIN),
}
METHODS = ("pressure_gradient", "xyvelocity_gradient", "maxdensity")


def _prim(kw, seed, nb=9):
    mesh = Mesh(**kw)
    rng = np.random.default_rng(seed)
    shape = (nb,) + mesh.block_shape
    w = np.empty((nb, 5) + mesh.block_shape)
    # blocks of different roughness, so that the values spread
    amp = np.linspace(0.02, 0.8, nb)[:, None, None, None]
    w[:, 0] = 1.0 + amp * rng.random(shape)
    w[:, 1:4] = amp[:, None] * rng.standard_normal((nb, 3) + shape[1:])
    w[:, 4] = 1.0 + amp * rng.random(shape)
    return mesh, JMesh(**kw), w


def _port_values(method, w, mesh):
    return getattr(tcrit, f"{method}_max")(torch.tensor(w), mesh).numpy()


def _jax_tags(method, w, jmesh, thr):
    """The JAX package's tags with threshold ``thr`` (a scalar or one per
    block); maxdensity derefines below a tenth of it."""
    jw = jnp.asarray(w)
    if method == "maxdensity":
        return np.asarray(jcrit.maxdensity(jw, jmesh, thr, 0.1 * thr))
    return np.asarray(getattr(jcrit, method)(jw, jmesh, thr))


@pytest.mark.parametrize("dims", sorted(MESHES))
@pytest.mark.parametrize("method", METHODS)
def test_criterion_matches_jax(method, dims):
    mesh, jmesh, w = _prim(MESHES[dims], seed=len(method) + len(dims))
    vals = _port_values(method, w, mesh)
    assert np.isfinite(vals).all() and np.unique(vals).size == vals.size

    # tags at thresholds that give all three kinds
    t = torch.tensor(w)
    if method == "maxdensity":
        thr, deref = float(np.median(vals)), float(np.sort(vals)[1])
        want = np.asarray(jcrit.maxdensity(jnp.asarray(w), jmesh, thr, deref))
        got = tcrit.maxdensity(t, mesh, thr, deref)
    else:
        thr = 0.5 * float(vals.max())
        want = _jax_tags(method, w, jmesh, thr)
        got = getattr(tcrit, method)(t, mesh, thr)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert set(want.tolist()) == {-1, 0, 1}

    # the values: JAX's tag flips between (1 - REL) and (1 + REL) times
    # the port's value, block by block
    above = _jax_tags(method, w, jmesh, jnp.asarray(vals * (1.0 - REL)))
    below = _jax_tags(method, w, jmesh, jnp.asarray(vals * (1.0 + REL)))
    assert (above == 1).all()
    assert (below != 1).all()


@pytest.mark.parametrize("method", METHODS + ("none",))
def test_config_from_deck_and_dispatch_match_jax(method):
    deck = f"""
<refinement>
type = {method}
threshold_pressure_gradient = 0.3
threshold_xyvelocity_gradient = 0.2
maxdensity_refine_above = 1.4
maxdensity_deref_below = 1.1
"""
    cfg = RefinementConfig.from_parameter_input(
        ParameterInput.from_string(deck))
    jcfg = jcrit.RefinementConfig.from_parameter_input(JPin.from_string(deck))
    assert cfg.__dict__ == jcfg.__dict__
    mesh, jmesh, w = _prim(MESHES["3d"], seed=5)
    got = check_refinement(cfg, torch.tensor(w), mesh)
    assert got.dtype == torch.int32 and got.shape == (w.shape[0],)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jcrit.check_refinement(jcfg, jnp.asarray(w),
                                                       jmesh)))


def test_unknown_criterion_raises():
    with pytest.raises(ValueError, match="unknown refinement type"):
        RefinementConfig.from_parameter_input(ParameterInput.from_string(
            "<refinement>\ntype = vorticity\n"))

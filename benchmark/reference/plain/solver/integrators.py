# A frozen copy of athenapk_tpu_torch/solver/integrators.py for the benchmark's plain
# reference (uniform meshes only); it imports nothing of the program.
"""Low-storage 2S integrator coefficient tables.

Stage update (Parthenon ``MultiStageDriver`` convention, used at AthenaPK
``src/hydro/hydro_driver.cpp:523-537``):

    u0 <- gam0 * u0 + gam1 * u1 + beta * dt * L(u0)

with ``u1`` a copy of the cycle-start state made in stage 1.  ``vl2`` uses
first-order (donor-cell) fluxes in its predictor stage (``src/hydro/
hydro.cpp:459-464``).
"""

INTEGRATORS = {
    "rk1": dict(nstages=1, gam0=(0.0,), gam1=(1.0,), beta=(1.0,)),
    "rk2": dict(nstages=2, gam0=(0.0, 0.5), gam1=(1.0, 0.5), beta=(1.0, 0.5)),
    "rk3": dict(nstages=3,
                gam0=(0.0, 0.25, 2.0 / 3.0),
                gam1=(1.0, 0.75, 1.0 / 3.0),
                beta=(1.0, 0.25, 2.0 / 3.0)),
    "vl2": dict(nstages=2, gam0=(0.0, 0.0), gam1=(1.0, 1.0), beta=(0.5, 1.0)),
}

"""Rank functions of the multi-rank CPU tests (``test_torch_sharding.py``,
``test_torch_amr_placement.py``).

They run in processes that ``athenapk_tpu_torch.parallel.dryrun.run_ranks``
spawns, one per rank, and import only the port and numpy.  Inputs and
outputs go through ``.npy`` / ``.npz`` files in a directory the test
passes; rank 0 writes the gathered results.
"""

import json
import os

import numpy as np
import torch

from athenapk_tpu_torch.parallel.dryrun import tracer_setup

MESH_KW = dict(nx1=16, nx2=16, nx3=32, mbnx1=8, mbnx2=8, mbnx3=4,
               x1min=0, x1max=1, x2min=0, x2max=1, x3min=0, x3max=1,
               nghost=2)


def uniform_pkg(bcs):
    """The port's package of ``tests/test_sharding.py:_setup``."""
    from athenapk_tpu_torch.core.mesh import Mesh
    from athenapk_tpu_torch.eos.adiabatic import EOS
    from athenapk_tpu_torch.solver.hydro_pkg import HydroConfig, HydroPackage

    mesh = Mesh(**{**MESH_KW, **bcs})
    cfg = HydroConfig(fluid="glmmhd", riemann="hlld", reconstruction="plm",
                      integrator="vl2")
    return HydroPackage(mesh, cfg, EOS(gamma=5.0 / 3.0))


def _save(d, name, **arrays):
    np.savez(os.path.join(d, f"{name}.npz"), **arrays)


def _np(state):
    return {k: v.cpu().numpy() for k, v in state.items()}


def uniform_case(rmesh, d, name, bcs, grid):
    """One sharded step (dt 1e-3, c_h 1) of ``{name}_u.npy`` and its dt,
    on the z-slab ranks or on the ``grid`` (z, y) rank grid."""
    from athenapk_tpu_torch.parallel.halo import (
        from_grid, gather_grid, make_device_mesh_2d, make_sharded_step,
        make_sharded_step_grid, shard_grid, to_grid)
    from athenapk_tpu_torch.parallel.mesh_sharding import (gather_state,
                                                           shard_state)

    pkg = uniform_pkg(bcs)
    mesh = pkg.mesh
    u = torch.from_numpy(np.load(os.path.join(d, f"{name}_u.npy")))
    if grid:
        gm = make_device_mesh_2d(rmesh, grid)
        step_fn, dt_fn = make_sharded_step_grid(pkg, gm)
        out = step_fn(shard_grid(to_grid(u, mesh), mesh, gm), 1e-3, 1.0)
        got = from_grid(gather_grid(out, mesh, gm), mesh)
    else:
        step_fn, dt_fn = make_sharded_step(pkg, rmesh)
        out = step_fn(shard_state(u, mesh, rmesh), 1e-3, 1.0)
        got = gather_state(out, rmesh)
    # the dt of the input state, as the JAX test takes it
    dts = dt_fn(shard_grid(to_grid(u, mesh), mesh, gm) if grid
                else shard_state(u, mesh, rmesh))
    if rmesh.rank == 0:
        _save(d, name, u=got.numpy(), dts=np.array(dts))


def tracer_case(rmesh, d, name, spec):
    """``spec["steps"]`` sharded advect + fill steps of ``tracer_setup``'s
    state, rank 0 writing the gathered pool."""
    from athenapk_tpu_torch.tracers.sharded import (
        gather_pool, make_sharded_tracer_ops, shard_pool)

    tr, st, prim = tracer_setup("cpu", **spec["setup"])
    nb = tr.mesh.nblocks
    per = nb // rmesh.world
    p_loc = prim[rmesh.rank * per:(rmesh.rank + 1) * per]
    advect, fill = make_sharded_tracer_ops(tr, rmesh)
    got = shard_pool(st, rmesh, nb)
    for _ in range(spec["steps"]):
        got = advect(got, p_loc, spec["dt"])
        if spec["fill"]:
            got = fill(got, p_loc)
    got = gather_pool(got, rmesh)
    if rmesh.rank == 0:
        _save(d, name, **_np(got))


def smr_case(rmesh, d, name, dt):
    """Two steps of the refined mesh of ``tests/test_sharding.py:
    test_sharded_smr_step`` from ``{name}_in.npz``, flat ownership."""
    from athenapk_tpu_torch.amr.sharded import (ShardedSmrHydro, flat_owners,
                                                gather, place)

    sm, cfg, eos = smr_mesh()
    owner = flat_owners(sm, rmesh.world)
    sh = ShardedSmrHydro(sm, cfg, eos, owner, rmesh, device="cpu")
    src = np.load(os.path.join(d, f"{name}_in.npz"))
    state = place({int(k): torch.from_numpy(src[k]) for k in src.files},
                  sm, owner, rmesh.rank)
    for _ in range(2):
        state = sh.step(state, dt, 0.0)
    got = gather(state, sm, owner, rmesh)
    if rmesh.rank == 0:
        _save(d, name, **{str(k): v.numpy() for k, v in got.items()})


def smr_mesh():
    """The refined mesh of ``test_sharded_smr_step`` (32^3 base, 8^3
    blocks, nghost 3, the centre at level 1: 56 + 64 leaves)."""
    from athenapk_tpu_torch.amr.smr import SmrMesh
    from athenapk_tpu_torch.core.mesh import Mesh
    from athenapk_tpu_torch.eos.adiabatic import EOS
    from athenapk_tpu_torch.solver.hydro_pkg import HydroConfig

    base = Mesh(nx1=32, nx2=32, nx3=32, mbnx1=8, mbnx2=8, mbnx3=8,
                x1min=0, x1max=1, x2min=0, x2max=1, x3min=0, x3max=1,
                nghost=3)
    sm = SmrMesh(base, [(0.4, 0.6, 0.4, 0.6, 0.4, 0.6, 1)])
    cfg = HydroConfig(fluid="euler", riemann="hllc", reconstruction="plm",
                      integrator="rk2")
    return sm, cfg, EOS(gamma=5.0 / 3.0)


def sim_tracer_case(rmesh, d, name, deck, dt):
    """``tests/test_tracers.py:test_tracer_advect_sharded_bitwise`` on the
    ranks: the deck's ``Simulation`` (``merge_blocks = auto`` keeps the
    blocks on several ranks), one sharded advect + fill of its tracers."""
    from athenapk_tpu_torch.config.parameter_input import ParameterInput
    from athenapk_tpu_torch.driver import Simulation
    from athenapk_tpu_torch.parallel.mesh_sharding import shard_state
    from athenapk_tpu_torch.tracers.sharded import (
        gather_pool, make_sharded_tracer_ops, shard_pool)

    sim = Simulation(ParameterInput.from_string(deck), quiet=True,
                     device="cpu")
    _, w = sim.pkg.cons_to_prim(sim.u)
    advect, fill = make_sharded_tracer_ops(sim.tracers, rmesh)
    w_loc = shard_state(w, sim.mesh, rmesh)
    got = fill(advect(shard_pool(sim.tracer_state, rmesh, sim.mesh.nblocks),
                      w_loc, dt), w_loc)
    got = gather_pool(got, rmesh)
    if rmesh.rank == 0:
        _save(d, name, **_np(got))


def fill_mesh(kind):
    """The ``SmrMesh`` of a fill test: "smr" ``smr_mesh``'s, "2d" a 32^2
    mesh of 8^2 blocks with outflow in x and its centre at level 1 (12 +
    16 leaves), else ``amr_mesh(kind)``'s."""
    if kind == "smr":
        return smr_mesh()[0]
    if kind == "2d":
        from athenapk_tpu_torch.amr.smr import SmrMesh
        from athenapk_tpu_torch.core.mesh import Mesh

        base = Mesh(nx1=32, nx2=32, nx3=1, mbnx1=8, mbnx2=8, mbnx3=1,
                    x1min=0, x1max=1, x2min=0, x2max=1, x3min=0, x3max=1,
                    nghost=2, ix1_bc="outflow", ox1_bc="outflow")
        return SmrMesh(base, [(0.3, 0.6, 0.3, 0.6, 0.0, 1.0, 1)])
    return amr_mesh(kind)[0]


def fill_case(rmesh, d, name, mesh_kind, layout):
    """One ghost fill over the ranks (``ShardedSmrState``) of the whole
    state ``{name}_in.npz`` (random values in interiors and ghosts) on the
    ``fill_mesh(mesh_kind)`` mesh; rank 0
    writes the gathered state, every rank its bytes sent and their
    bounds."""
    from athenapk_tpu_torch.amr.sharded import (OWNERS, ShardedSmrState,
                                                gather, place)
    from athenapk_tpu_torch.parallel.dryrun import fill_send_bounds

    sm = fill_mesh(mesh_kind)
    owner = OWNERS[layout](sm, rmesh.world)
    src = np.load(os.path.join(d, f"{name}_in.npz"))
    whole = {int(k): torch.from_numpy(src[k]) for k in src.files}
    mgr = ShardedSmrState(sm, whole[0].shape[1], owner, rmesh, device="cpu")
    state = place(whole, sm, owner, rmesh.rank)
    sent0 = rmesh.sent_bytes
    state = mgr.fill_ghosts(state)
    size = whole[0].element_size()
    nums = {"sent": rmesh.sent_bytes - sent0,
            "schedule": mgr.fill_values_sent * size,
            "bounds": [v * size for v in fill_send_bounds(mgr)]}
    with open(os.path.join(d, f"{name}.r{rmesh.rank}.json"), "w") as f:
        json.dump(nums, f)
    got = gather(state, sm, owner, rmesh)
    if rmesh.rank == 0:
        _save(d, name, **{str(k): v.numpy() for k, v in got.items()})


def merge_case(rmesh, d, name, deck):
    """``parthenon/mesh/merge_blocks = auto`` under a process group of
    several ranks: the blocks stay."""
    from athenapk_tpu_torch.config.parameter_input import ParameterInput
    from athenapk_tpu_torch.driver import Simulation

    sim = Simulation(ParameterInput.from_string(deck), quiet=True,
                     device="cpu")
    if rmesh.rank == 0:
        with open(os.path.join(d, f"{name}.json"), "w") as f:
            json.dump({"nblocks": sim.mesh.nblocks,
                       "nghost": sim.mesh.nghost}, f)


def run_cases(rmesh, d, cases):
    """Each ``(function name, args)`` of ``cases`` in turn."""
    for fn, args in cases:
        globals()[fn](rmesh, d, *args)


# --------------------------------------------------------- refined meshes
def amr_mesh(kind):
    """``("uneven", ...)``: the 24^3 mesh of ``tests/test_amr_flat.py`` and
    ``test_amr_balance.py`` (26 coarse + 8 fine leaves, no refinement);
    ``"blob"``: the 16^3 adaptive mesh of ``test_flat_adaptive_remesh_
    balance``; ``"remesh"``: the mesh of ``tests/test_remesh.py:
    test_sharded_adaptive_remesh_bitwise``.  -> (SmrMesh, cfg, eos,
    refinement config, AmrHydro keywords)."""
    from athenapk_tpu_torch.amr.smr import SmrMesh
    from athenapk_tpu_torch.core.mesh import Mesh
    from athenapk_tpu_torch.eos.adiabatic import EOS
    from athenapk_tpu_torch.refinement.criteria import RefinementConfig
    from athenapk_tpu_torch.solver.hydro_pkg import HydroConfig

    eos = EOS(gamma=5.0 / 3.0)
    cfg = HydroConfig(fluid="euler", riemann="hllc", reconstruction="plm",
                      integrator="rk2")
    if kind == "uneven":
        base = Mesh(nx1=24, nx2=24, nx3=24, mbnx1=8, mbnx2=8, mbnx3=8,
                    x1min=0, x1max=1, x2min=0, x2max=1, x3min=0, x3max=1,
                    nghost=2)
        sm = SmrMesh(base, [(0.0, 0.32, 0.0, 0.32, 0.0, 0.32, 1)])
        rcfg = RefinementConfig(method="maxdensity",
                                maxdensity_refine_above=1e30)
        return sm, cfg, eos, rcfg, {}
    nx = 16 if kind == "blob" else 32
    base = Mesh(nx1=nx, nx2=nx, nx3=nx, mbnx1=8, mbnx2=8, mbnx3=8,
                x1min=0, x1max=1, x2min=0, x2max=1, x3min=0, x3max=1,
                nghost=2)
    sm = SmrMesh(base, [], max_level=1)
    rcfg = RefinementConfig(method="maxdensity", maxdensity_refine_above=1.3,
                            maxdensity_deref_below=1.05)
    return sm, cfg, eos, rcfg, {"derefine_count": 1}


def amr_case(rmesh, d, name, kind, layout, ncycles):
    """``AmrHydro(rmesh=..., layout=...)`` from ``{name}_in.npz`` (a whole
    ghost-filled state): the placement's leaf counts, the round trip of
    ``exact_state``, and ``ncycles`` of ``advance``; rank 0 writes the
    gathered state, the leaf table and the counts."""
    from athenapk_tpu_torch.amr.remesh import AmrHydro

    sm, cfg, eos, rcfg, kw = amr_mesh(kind)
    amr = AmrHydro(sm, cfg, eos, rcfg, device="cpu", rmesh=rmesh,
                   layout=layout, **kw)
    src = np.load(os.path.join(d, f"{name}_in.npz"))
    whole = {int(k): torch.from_numpy(src[k]) for k in src.files}
    placed = amr._place(whole)
    out = {"placed_counts": amr.device_leaf_counts(placed),
           "idempotent": amr._place(placed) is placed}
    back = amr.exact_state(placed)
    out["round_trip"] = all(torch.equal(back[k], whole[k]) for k in whole)
    st = amr.advance(placed, ncycles) if ncycles else placed
    out["counts"] = amr.device_leaf_counts(st)
    out["remeshes"] = len(amr.remesh_log)
    got = amr.exact_state(st)
    if rmesh.rank == 0:
        _save(d, name, levels=amr.smesh.levels, lx1=amr.smesh.lx1,
              lx2=amr.smesh.lx2, lx3=amr.smesh.lx3,
              **{str(k): v.numpy() for k, v in got.items()})
        with open(os.path.join(d, f"{name}.json"), "w") as f:
            json.dump(out, f)

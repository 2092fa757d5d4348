"""Dry run of the multi-rank paths over N processes, and the helper that
spawns them.

The port's twin of ``__graft_entry__.dryrun_multichip``.  ``run_ranks``
starts N ``torch.multiprocessing`` processes (spawn), joins each to one
process group through a ``file://`` rendezvous and runs a function with
its ``RankMesh``; a rank that raises fails the whole run.  The dry run
drives, at small sizes, every sharded path against the one-rank run of the
same port, bit for bit:

* the uniform z-slab step (GLM-MHD HLLD + PLM + VL2, outflow in z) and
  its dt;
* the (N/2, 2) rank grid's step when N >= 4 and even;
* the adaptive flat-layout AMR (Euler HLLC + PLM + RK2) through a remesh;
* the sharded tracers, with movers that cross several slabs in one step.

In place of the JAX dry run's HLO audit each rank counts the bytes it
sends per fill (``RankMesh.sent_bytes``).  The dry run asserts that the
uniform steps send exactly their halo slabs, and that the refined fill
sends what its schedule computes, no more than the face slabs the other
ranks read (``fill_send_bounds``, from the neighbour table and the block
geometry) and less than an all-gather of the rank's rows; it prints them
beside the state's size.  Run::

    python -m athenapk_tpu_torch.parallel.dryrun --ranks 8 [--device cpu]

(the default, ``--device cuda``, puts every rank on the card: gloo with
host staging when the ranks share one; it raises where there is no card).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from .mesh_sharding import init_rank_mesh


def _rank_main(rank, world, init_method, fn, device, args):
    if device == "cpu":
        # one thread per rank: N ranks share the host's cores
        torch.set_num_threads(1)
    rmesh = init_rank_mesh(rank, world, init_method, device)
    try:
        fn(rmesh, *args)
    finally:
        dist.destroy_process_group()


def run_ranks(fn, world, args=(), device="cuda", timeout=900.0):
    """Run ``fn(rmesh, *args)`` on ``world`` spawned ranks and wait for all
    of them; raises if a rank raises or the run outlasts ``timeout``
    seconds (every rank is then stopped).  ``fn`` must be importable by
    name (a module-level function)."""
    with tempfile.TemporaryDirectory() as tmp:
        init = "file://" + os.path.join(tmp, "rendezvous")
        ctx = mp.start_processes(
            _rank_main, args=(world, init, fn, device, tuple(args)),
            nprocs=world, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                for p in ctx.processes:
                    if p.is_alive():
                        p.terminate()
                for p in ctx.processes:
                    p.join(10.0)
                raise TimeoutError(f"{world} ranks did not finish in "
                                   f"{timeout:.0f} s")


# ------------------------------------------------------------- the cases
def uniform_setup(device, nx3=32, bcs=None, dtype=torch.float64, seed=3):
    """The JAX package's sharding-test state, built by the port: a 16x16x
    ``nx3`` GLM-MHD mesh in 8x8x4 blocks, nghost 2, seeded random prim,
    ghost-filled.  -> (mesh, pkg, u)."""
    from ..core.mesh import Mesh
    from ..eos.adiabatic import EOS, prim_to_cons
    from ..solver.hydro_pkg import HydroConfig, HydroPackage

    kw = dict(nx1=16, nx2=16, nx3=nx3, mbnx1=8, mbnx2=8, mbnx3=4,
              x1min=0, x1max=1, x2min=0, x2max=1, x3min=0, x3max=1,
              nghost=2)
    kw.update(bcs or {})
    mesh = Mesh(**kw)
    cfg = HydroConfig(fluid="glmmhd", riemann="hlld", reconstruction="plm",
                      integrator="vl2")
    eos = EOS(gamma=5.0 / 3.0)
    pkg = HydroPackage(mesh, cfg, eos)
    rng = np.random.default_rng(seed)
    w = np.ones((mesh.nblocks, 9) + mesh.block_shape)
    w[:, 0] = 1.0 + 0.1 * rng.random(w[:, 0].shape)
    w[:, 1:4] = 0.1 * rng.standard_normal(w[:, 1:4].shape)
    w[:, 4] = 0.5 + 0.1 * rng.random(w[:, 4].shape)
    w[:, 5:8] = 0.2 * rng.standard_normal(w[:, 5:8].shape)
    u = prim_to_cons(eos, torch.as_tensor(w, dtype=dtype, device=device),
                     "glmmhd")
    return mesh, pkg, pkg.apply_boundaries(u)


def _check(cond, what):
    if not cond:
        raise AssertionError(what)


def _uniform_case(rmesh, grid):
    from .halo import (from_grid, gather_grid, halo_bytes,
                       make_device_mesh_2d, make_sharded_step,
                       make_sharded_step_grid, shard_grid, to_grid)
    from .mesh_sharding import gather_state, shard_state

    bcs = {"ix3_bc": "outflow", "ox3_bc": "outflow"}
    if grid:
        bcs.update(ix2_bc="outflow", ox2_bc="outflow")
    mesh, pkg, u = uniform_setup(rmesh.device, bcs=bcs)
    dt, c_h = 1e-3, 1.0
    ref = pkg.step(u, dt, c_h)
    _, prim = pkg.cons_to_prim(ref)
    ref_dts = pkg.estimate_timestep(prim)
    if grid:
        gm = make_device_mesh_2d(rmesh, grid)
        step = make_sharded_step_grid(pkg, gm)
        local = shard_grid(to_grid(u, mesh), mesh, gm)
    else:
        step = make_sharded_step(pkg, rmesh)
        local = shard_state(u, mesh, rmesh)
    sent0 = step.rmesh.sent_bytes
    out = step.step(local, dt, c_h)
    sent = (step.rmesh.sent_bytes - sent0) // 2   # VL2: two fills a cycle
    dts = step.dt(out)
    got = (from_grid(gather_grid(out, mesh, gm), mesh) if grid
           else gather_state(out, rmesh))
    _check(torch.equal(got, ref), "sharded step != one-rank step")
    _check(dts == ref_dts, f"dt {dts} != one-rank {ref_dts}")
    if grid:
        shape = tuple(local.shape)
        dirs = [d for d, ax in ((3, "z"), (2, "y")) if gm.axis_size(ax) > 1]
    else:
        shape = (mesh.nb3 // rmesh.world, mesh.nb2, mesh.nb1) \
            + tuple(local.shape[1:])
        dirs = [3]
    want = sum(halo_bytes(shape, mesh, d, u.element_size()) for d in dirs)
    _check(sent == want, f"sent {sent} bytes per fill, the halo is {want}")
    return {"bytes_per_fill": sent, "halo_bytes": want,
            "state_bytes": u.numel() * u.element_size()}


def amr_setup(device):
    """An adaptive 16^3 Euler mesh (8^3 blocks, numlevel 2) with a dense
    corner block that refines: -> (AmrHydro factory, whole state)."""
    from ..amr.remesh import AmrHydro
    from ..amr.smr import SmrMesh, SmrState
    from ..core.mesh import Mesh
    from ..eos.adiabatic import EOS, prim_to_cons
    from ..refinement.criteria import RefinementConfig
    from ..solver.hydro_pkg import HydroConfig

    base = Mesh(nx1=16, nx2=16, nx3=16, mbnx1=8, mbnx2=8, mbnx3=8,
                x1min=0, x1max=1, x2min=0, x2max=1, x3min=0, x3max=1,
                nghost=2)
    eos = EOS(gamma=5.0 / 3.0)
    cfg = HydroConfig(fluid="euler", riemann="hllc", reconstruction="plm",
                      integrator="rk2")
    rcfg = RefinementConfig(method="maxdensity", maxdensity_refine_above=1.3,
                            maxdensity_deref_below=1.05)

    def make(rmesh=None, layout="flat"):
        sm = SmrMesh(base, [], max_level=1)
        amr = AmrHydro(sm, cfg, eos, rcfg, derefine_count=1, device=device,
                       rmesh=rmesh, layout=layout)
        w = torch.ones((len(sm.level_ids[0]), 5) + base.block_shape,
                       dtype=torch.float64, device=device)
        w[:, 1:4] = 0.0
        u = prim_to_cons(eos, w, "euler")
        u[0, 0] *= 1.5
        st = SmrState(sm, 5, device).fill_ghosts({0: u})
        return amr, st

    return make


def fill_send_bounds(mgr):
    """Two bounds, in values, on what a rank's ``ShardedSmrState`` may send
    per ghost fill, computed from the mesh's neighbour table and the block
    geometry, not from the exchange schedule: ``(slabs, all_gather)``.
    ``slabs``: for each face of another rank's leaf whose ghosts come from
    this rank's leaves, twice (passes A and B) the source's ghost-extended
    face slab, ``g`` deep for a same-level neighbour, ``g + 2`` for a
    coarse parent and ``2g`` for each fine child.  ``all_gather``: what an
    all-gather of the rank's rows would send to the other ranks."""
    from ..amr.smr import SmrState

    sm, owner, me = mgr.smesh, mgr.owner, mgr.rmesh.rank
    ext = {ax: mgr.n_of[ax] + 2 * mgr.g_of[ax] if mgr.act[ax]
           else mgr.n_of[ax] for ax in (1, 2, 3)}
    slabs = 0
    for lev, ids in sm.level_ids.items():
        for (li, face, kind, payload) in SmrState._build_plan(mgr, lev, ids):
            if kind == "phys" or owner[ids[li]] == me:
                continue
            axis = 3 - face // 2
            g = mgr.g_of[axis]
            cross = int(np.prod([ext[ax] for ax in (1, 2, 3) if ax != axis]))
            if kind == "same":
                srcs, depth = [payload], g
            elif kind == "coarse":
                srcs, depth = [payload[0]], g + 2
            else:
                srcs, depth = [kid for _, kid in payload], 2 * g
            mine = sum(int(owner[s] == me) for s in srcs)
            slabs += 2 * mine * depth * cross * mgr.nvar
    rows = int((owner == me).sum())
    row = mgr.nvar * int(np.prod(list(ext.values())))
    return slabs, (mgr.rmesh.world - 1) * rows * row


def _amr_case(rmesh):
    make = amr_setup(rmesh.device)
    amr_a, st_a = make()
    st_a = amr_a.advance(st_a, 3)
    amr_b, st_b = make(rmesh)
    st_b = amr_b.advance(st_b, 3)
    _check(amr_b.smesh.max_level > 0, "the remesh did not refine")
    _check(np.array_equal(amr_a.smesh.levels, amr_b.smesh.levels),
           "leaf tables differ")
    ex = amr_b.exact_state(st_b)
    for lev, v in st_a.items():
        _check(torch.equal(v, ex[lev]), f"level {lev} != one-rank run")
    counts = amr_b.device_leaf_counts(st_b)
    n = amr_b.smesh.levels.size
    _check(sum(counts.values()) == n
           and max(counts.values()) - min(counts.values()) <= 1,
           f"unbalanced {counts}")
    stepper = amr_b._stepper
    row = st_b[next(iter(st_b))][0]
    size = row.element_size()
    sent0 = rmesh.sent_bytes
    stepper.fill_ghosts(st_b)
    sent = rmesh.sent_bytes - sent0
    mgr = stepper.state_mgr
    want = mgr.fill_values_sent * size
    slabs, gathered = (v * size for v in fill_send_bounds(mgr))
    _check(sent == want, f"sent {sent} bytes per fill, the schedule's "
           f"boxes are {want}")
    _check(sent <= slabs, f"sent {sent} bytes per fill, more than the face "
           f"slabs the other ranks read ({slabs})")
    _check(sent < gathered, f"sent {sent} bytes per fill, an all-gather of "
           f"the rank's rows sends {gathered}")
    return {"bytes_per_fill": sent, "face_slab_bound": slabs,
            "all_gather_bytes": gathered,
            "state_bytes": n * row.numel() * size, "leaves_per_rank": counts,
            "remeshes": len(amr_b.remesh_log)}


def tracer_setup(device, shape=(16, 16, 64), mb=8, vel=(0.30, 0.15, 0.45),
                 bcs=None, seed=7, per_cell=0.05, capacity_factor=2.0,
                 dtype=torch.float64):
    """The JAX sharding test's tracer setup (an ``(nx1, nx2, nx3)`` unit
    box in ``mb^3`` blocks, the constant velocity ``vel``) in the port: ->
    (tracers, seeded and filled state, prim)."""
    from ..config.parameter_input import ParameterInput
    from ..core.mesh import Mesh
    from ..solver.hydro_pkg import HydroConfig
    from ..tracers.tracers import Tracers

    kw = dict(nx1=shape[0], nx2=shape[1], nx3=shape[2], mbnx1=mb, mbnx2=mb,
              mbnx3=mb, x1min=0, x1max=1, x2min=0, x2max=1, x3min=0,
              x3max=1, nghost=2)
    kw.update(bcs or {})
    mesh = Mesh(**kw)
    cfg = HydroConfig(fluid="euler", riemann="hllc", reconstruction="plm",
                      integrator="rk2")
    pin = ParameterInput.from_string(f"""
<job>
problem_id = advection
<tracers>
enabled = true
initial_seed_method = random_per_block
initial_num_tracers_per_cell = {per_cell}
initial_rng_seed = {seed}
capacity_factor = {capacity_factor}
""")
    tr = Tracers(pin, mesh, cfg, device=device)
    state = tr.seed()
    prim = torch.zeros((mesh.nblocks, 5) + mesh.block_shape, dtype=dtype,
                       device=device)
    prim[:, 0] = 1.0
    prim[:, 1:4] = torch.as_tensor(vel, dtype=dtype)[:, None, None, None]
    prim[:, 4] = 1.0
    return tr, tr.fill(state, prim), prim


def _tracer_case(rmesh):
    from ..tracers.sharded import (gather_pool, make_sharded_tracer_ops,
                                   shard_pool)

    # vz * dt = 0.45 of the domain per step: every mover crosses several
    # slabs at once
    tr, st, prim = tracer_setup(rmesh.device, vel=(0.30, 0.15, 2.25))
    nb = tr.mesh.nblocks
    ref = dict(st)
    advect, fill = make_sharded_tracer_ops(tr, rmesh)
    got = shard_pool(st, rmesh, nb)
    per = nb // rmesh.world
    p_loc = prim[rmesh.rank * per:(rmesh.rank + 1) * per]
    for _ in range(4):
        ref = tr.fill(tr.advect(ref, prim, 0.2), prim)
        got = fill(advect(got, p_loc, 0.2), p_loc)
    got = gather_pool(got, rmesh)
    for k, v in ref.items():
        _check(torch.equal(v, got[k]), f"tracer field {k} != one-rank run")
    return {"active": int(ref["active"].sum()), "n_lost": int(ref["n_lost"])}


def _dryrun_rank(rmesh, out_dir):
    res = {"uniform_z_slabs": _uniform_case(rmesh, None)}
    if rmesh.world >= 4 and rmesh.world % 2 == 0:
        res["grid_z_y"] = _uniform_case(rmesh, (rmesh.world // 2, 2))
    res["adaptive_flat"] = _amr_case(rmesh)
    res["tracers"] = _tracer_case(rmesh)
    with open(os.path.join(out_dir, f"rank{rmesh.rank}.json"), "w") as f:
        json.dump(res, f)


def dryrun_multichip(n, device="cuda"):
    """Run every sharded path on ``n`` ranks against the one-rank run; ->
    ``{rank: {case: numbers}}``.  Raises on any difference."""
    with tempfile.TemporaryDirectory() as out:
        run_ranks(_dryrun_rank, n, (out,), device=device)
        res = {}
        for r in range(n):
            with open(os.path.join(out, f"rank{r}.json")) as f:
                res[r] = json.load(f)
    return res


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ranks", type=int, default=8)
    ap.add_argument("--device", default="cuda", choices=("cpu", "cuda"))
    args = ap.parse_args(argv)
    t0 = time.time()
    res = dryrun_multichip(args.ranks, args.device)
    for case in res[0]:
        print(f"{case}: " + json.dumps({r: res[r][case] for r in res}))
    print(f"dry run on {args.ranks} ranks ({args.device}): every sharded "
          f"path equals the one-rank run bit for bit "
          f"({time.time() - t0:.1f} s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())

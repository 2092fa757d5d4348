"""Bytes, operations and the least time of one launch of the port's
kernels (``csrc/negdiv_sweep.cu``, ``csrc/fused_stage.cu``), from the
state's layout and the per-cell counts kept in ``benchmark/kernels/*.json``;
the peaks are the data sheet's (``peaks.json``).

Bytes count each input read once and each output written once: the sweep
(``negdiv_sweep``) reads the fluid rows of prim and writes -div(F)'s fluid
rows, and from its second direction on also reads them (it adds); with
passive scalars it writes the faces' mass fluxes, which the scalar kernel
(``negdiv_scalars``) reads with the scalar rows of prim (and of -div(F),
from the second direction on) before writing those rows.  The stage
(``fused_stage``) reads the fluid rows of u0 and u1 and writes those of
u_new; with ``FACES`` it writes each direction's fluxes at the block's two
interior boundary faces, with passive scalars the three directions' mass
fluxes, and, where the layout says ``stage_prim``, the fluid rows of prim;
its scalar kernel (``stage_scalars``) reads the density and the scalar rows
of u0, the scalar rows of u1 and the mass fluxes, and writes the scalar
rows of u_new (of prim with ``stage_prim``, of the face slabs with
``stage_faces``).  The stage's per-tile dt bounds, a few values a tile,
are not counted.  Every kernel computes every cell of the block, the ghost
rim included.

On a refined mesh the layout gives ``levels``, each level's block count
(one block shape on every level), and the trace does not say on which
level a launch ran.  A launch's least time is linear in its blocks, and a
static mesh launches each case equally often on every level, so a case's
launches take (their count / the levels) times the least time of one
launch over every level's blocks; where a case's count is no multiple of
the levels, the share reads None.
"""

from __future__ import annotations

import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
KERNELS = HERE.parent / "kernels"


def peaks():
    return json.loads((HERE / "peaks.json").read_text())


def cases():
    """``{(kernel, ((switch, code), ...)): data}`` of every kernel case."""
    out = {}
    for path in sorted(KERNELS.glob("*.json")):
        d = json.loads(path.read_text())
        out[(d["kernel"], tuple(sorted(d["template"].items())))] = d
    return out


def fluid_rows(fluid):
    return 9 if fluid == "glmmhd" else 5


def launch_cost(kernel, switches, case, layout):
    """``(bytes, operations)`` of one launch over the layout's blocks;
    ``switches`` as ``trace.parse_kernel`` gives them, ``layout`` the
    state's (``shape``, ``itemsize``, ``fluid``, ``nscalars``; optional
    ``levels``, ``stage_prim``, ``stage_faces``)."""
    nb, nvar, nz, ny, nx = layout["shape"]
    levels = layout.get("levels")
    if levels is not None and sum(levels) != nb:
        raise ValueError(f"the levels' blocks {levels} are not the "
                         f"shape's {nb}")
    cells = nb * nz * ny * nx
    item = layout["itemsize"]
    nv, ns = fluid_rows(layout["fluid"]), layout["nscalars"]
    if kernel in ("negdiv_sweep", "negdiv_scalars"):
        adds = switches["dir"] > 1          # the first direction writes
        d = str(switches["dir"])
        if kernel == "negdiv_sweep":
            arrays = nv * (2 + adds) + (1 if switches["scal"] else 0)
            ops = case["ops_per_cell"][d] * cells
        else:
            arrays = ns * (2 + adds) + 1
            ops = case["ops_per_cell_per_scalar"][d] * cells * ns
        return arrays * cells * item, ops
    # one row of the blocks' face slabs: two faces across each direction
    slab = nb * 2 * (nz * ny + nz * nx + ny * nx)
    prim = bool(layout.get("stage_prim"))
    if kernel == "fused_stage":
        arrays = nv * (3 + prim) + (3 if switches["scal"] else 0)
        rows = nv if switches["faces"] else 0
        ops = sum(case["ops_per_cell"][d] for d in "123") * cells
    elif kernel == "stage_scalars":
        # + the density and the three mass fluxes
        arrays = ns * (3 + prim) + 4
        rows = ns if layout.get("stage_faces") else 0
        ops = sum(case["ops_per_cell_per_scalar"][d]
                  for d in "123") * cells * ns
    else:
        raise ValueError(f"no cost model for {kernel}")
    return (arrays * cells + rows * slab) * item, ops


def least_seconds(nbytes, ops, dtype, pk=None):
    """The least time of a launch: the larger of its bytes over the memory
    rate and its operations over the dtype's rate."""
    pk = pk or peaks()
    return max(nbytes / pk["hbm_bytes_per_s"], ops / pk["ops_per_s"][dtype])


def share(tr, kernel):
    """% of its roofline that ``kernel`` reaches over the traced stretch
    ``tr``: the sum of its launches' least times over the sum of their
    measured times; launches of a case without a count in
    ``benchmark/kernels/`` are left out, and with none left: None.  On a
    refined layout each launch takes its share of the levels' (module
    docstring), and a case launched no multiple of the levels' count of
    times reads None."""
    from .trace import parse_kernel
    known, pk = cases(), peaks()
    nlev = len(tr.layout.get("levels") or ()) or 1
    least = measured = 0.0
    launches = {}
    for o in tr.csrc_ops():
        parsed = parse_kernel(o["name"])
        if parsed is None or parsed[0] != kernel:
            continue
        _, dtype, sw = parsed
        key = (kernel, tuple(sorted((k, sw[k]) for k in ("recon", "solver")
                                    if k in sw)))
        case = known.get(key)
        if case is None or dtype not in pk["ops_per_s"]:
            continue
        nbytes, ops = launch_cost(kernel, sw, case, tr.layout)
        least += least_seconds(nbytes, ops, dtype, pk) / nlev
        measured += o["dur"] / 1e6
        key = (dtype, tuple(sorted(sw.items())))
        launches[key] = launches.get(key, 0) + 1
    if any(n % nlev for n in launches.values()):
        return None
    return 100.0 * least / measured if measured else None

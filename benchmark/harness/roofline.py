"""Bytes, operations and the least time of one launch of the port's sweep
kernels, from the state's layout and the per-cell counts kept in
``benchmark/kernels/*.json``; the peaks are the data sheet's
(``peaks.json``).

Bytes count each input read once and each output written once: the sweep
(``negdiv_sweep``) reads the fluid rows of prim and writes -div(F)'s fluid
rows, and from its second direction on also reads them (it adds); with
passive scalars it writes the faces' mass fluxes, which the scalar kernel
(``negdiv_scalars``) reads with the scalar rows of prim (and of -div(F),
from the second direction on) before writing those rows.  Both compute
every cell of the block, the ghost rim included.
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
    """``(bytes, operations)`` of one launch; ``switches`` as
    ``trace.parse_kernel`` gives them, ``layout`` the state's
    (``shape``, ``itemsize``, ``fluid``, ``nscalars``)."""
    nb, nvar, nz, ny, nx = layout["shape"]
    cells = nb * nz * ny * nx
    item = layout["itemsize"]
    adds = switches["dir"] > 1          # the first direction writes
    d = str(switches["dir"])
    if kernel == "negdiv_sweep":
        nv = fluid_rows(layout["fluid"])
        arrays = nv * (2 + adds) + (1 if switches["scal"] else 0)
        ops = case["ops_per_cell"][d] * cells
    elif kernel == "negdiv_scalars":
        ns = layout["nscalars"]
        arrays = ns * (2 + adds) + 1
        ops = case["ops_per_cell_per_scalar"][d] * cells * ns
    else:
        raise ValueError(f"no cost model for {kernel}")
    return arrays * cells * item, ops


def least_seconds(nbytes, ops, dtype, pk=None):
    """The least time of a launch: the larger of its bytes over the memory
    rate and its operations over the dtype's rate."""
    pk = pk or peaks()
    return max(nbytes / pk["hbm_bytes_per_s"], ops / pk["ops_per_s"][dtype])


def share(tr, kernel):
    """% of its roofline that ``kernel`` reaches over the traced stretch
    ``tr``: the sum of its launches' least times over the sum of their
    measured times; launches of a case without a count in
    ``benchmark/kernels/`` are left out, and with none left: None."""
    from .trace import parse_kernel
    known, pk = cases(), peaks()
    least = measured = 0.0
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
        least += least_seconds(nbytes, ops, dtype, pk)
        measured += o["dur"] / 1e6
    return 100.0 * least / measured if measured else None

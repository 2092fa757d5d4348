"""The operations each kernel case needs per cell, counted once on the
plain reference (``benchmark/reference/plain``) and kept as data in
``benchmark/kernels/<kernel>.<case>.json``, which the roofline reader
reads: per direction for the sweeps (``negdiv_sweep``, ``negdiv_scalars``),
and for the stage kernels (``fused_stage``, ``stage_scalars``), which do
all three directions in one launch, in the kernel's order: the x sweep with
the EOS (or the scalars' primitive), + the y sweep, + the z sweep with the
2S update (cumulative counts of the plain stage, differenced).  Run on the
CPU from the root of a checkout:

    python3 -m benchmark.kernels.count_ops [CASE ...]

It rewrites the JSON files of the named cases (every case by default;
a new case is a new file naming its kernel, template switches,
configuration and reconstruction) from the configuration's initial state
at 32^3 (the same deck, a smaller mesh: the counts are per
cell, and the branches a face takes follow the state's structure).
``count_ops`` is a frozen copy of ``chip_smoke.py``'s: adds, subtracts,
multiplies, divisions, square roots, reciprocals, squares, minima and
maxima, one per output element that the result depends on, following
each ``torch.where`` only down the side its elements take.
"""

import json
import sys
from pathlib import Path

import torch

KERNELS = Path(__file__).resolve().parent


def count_ops(fn):
    """Floating-point operations that ``fn()`` (the plain version, on this
    run's data) needs for its result: adds, subtracts, multiplies,
    divisions, square roots, reciprocals, squares, minima and maxima, one
    per output element that the result depends on.

    The plain version is a branch-free ``torch.where`` lattice: it computes
    every HLLD region's state and both sides of every PPM limiter at every
    face.  A pass back over the recorded operations lets each
    ``torch.where`` pass on only the side each element takes, so work that
    no face takes on these data is not counted.  Not counted: sign flips
    and absolute values (operand modifiers on the card), comparisons,
    selects, data movement, and the sign function's ``(x >= 0) * 2 - 1``
    (one select on the card).  A division or square root counts as one,
    though the card runs each as several instructions.

    Returns ``(ops, divisions_and_roots, ops_branch_free)``, the last the
    count of every element the lattice computes."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_flatten, tree_unflatten

    counted = {"add", "sub", "mul", "div", "sqrt", "reciprocal", "pow",
               "maximum", "minimum"}
    token, slot, tape = object(), object(), []

    def tag_of(x):
        tag = getattr(x, "_count_tag", None)
        return tag[1] if tag is not None and tag[0] is token else None

    class Record(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            if not isinstance(out, torch.Tensor):
                raise NotImplementedError(f"count_ops: {func} returns "
                                          f"{type(out).__name__}")
            name = func.overloadpacket.__name__
            leaves, spec = tree_flatten((args, kwargs))
            ins = [x for x in leaves if isinstance(x, torch.Tensor)]
            arrays = [x for x in ins if x.dim() > 0]
            out._count_sign = (
                (name == "_to_copy" and ins[0].dtype == torch.bool)
                or (name in ("mul", "sub") and bool(arrays) and all(
                    getattr(x, "_count_sign", False) for x in arrays)))
            out._count_tag = (token, len(tape))
            kind = ("where" if name == "where" else "pointwise"
                    if torch.Tag.pointwise in func.tags
                    or name == "_to_copy" else "moves")
            if kind == "where" and len(ins) != 3:
                raise NotImplementedError(f"count_ops: {func} with a "
                                          f"scalar operand")
            tape.append(dict(
                func=func, spec=spec, kind=kind, name=name,
                counted=name in counted and not out._count_sign,
                numel=out.numel(),
                leaves=[slot if isinstance(x, torch.Tensor) else x
                        for x in leaves],
                ins=[(tag_of(x), x.shape) for x in ins],
                cond=args[0] if kind == "where" else None))
            return out

    with Record():
        result = fn()
    full = sum(e["numel"] for e in tape if e["counted"])

    need = {tag_of(result): torch.ones(result.shape, dtype=torch.bool,
                                       device=result.device)}
    ops = slow = 0
    for i in range(len(tape) - 1, -1, -1):
        e, tape[i] = tape[i], None
        m = need.pop(i, None)
        if m is None:
            continue
        if e["counted"]:
            k = int(m.sum())
            ops += k
            if e["name"] in ("div", "sqrt", "reciprocal"):
                slow += k
        if all(tag is None for tag, _ in e["ins"]):
            continue
        if e["kind"] == "where":
            masks = [m, m & e["cond"], m & ~e["cond"]]
        elif e["kind"] == "pointwise":
            masks = [m] * len(e["ins"])
        else:
            # data movement (roll, select, stack): its vector-Jacobian
            # product carries the mask back to the elements it read
            xs = [torch.zeros(shape, device=m.device, requires_grad=True)
                  for _, shape in e["ins"]]
            it = iter(xs)
            args, kwargs = tree_unflatten(
                [next(it) if x is slot else x for x in e["leaves"]],
                e["spec"])
            res = e["func"](*args, **kwargs)
            # a creation op (empty_like, zeros_like) reads no element
            grads = (torch.autograd.grad(res, xs, m.float(),
                                         allow_unused=True)
                     if res.requires_grad else [None] * len(xs))
            masks = [torch.zeros(x.shape, dtype=torch.bool, device=m.device)
                     if g is None else g > 0 for x, g in zip(xs, grads)]
        for (tag, shape), mi in zip(e["ins"], masks):
            if tag is None:
                continue
            if mi.shape != shape:
                mi = mi.int().sum_to_size(shape) > 0
            need[tag] = need[tag] | mi if tag in need else mi
    return ops, slow, full


N = 32


def state_of(config):
    """The configuration's initial state and prim at N^3 on the CPU, with
    its reference ``PlainSim``."""
    from benchmark.harness.spec import BENCH_DIR, load_json, load_module
    cfg = load_json(BENCH_DIR / "configs" / f"{config}.json")
    deck = {b: dict(kv) for b, kv in cfg["deck"].items()}
    for ax in ("nx1", "nx2", "nx3"):
        deck["parthenon/mesh"][ax] = str(N)
        deck["parthenon/meshblock"][ax] = str(N)
    text = "\n".join(f"<{b}>\n" + "\n".join(f"{k} = {v}"
                                            for k, v in kv.items())
                     for b, kv in deck.items())
    ref = load_module(BENCH_DIR / "reference" / f"{config}.py",
                      "benchmark.reference")
    sim = ref.sim(text, "cpu")
    u = sim.initial_state()
    _, prim = sim.hydro.cons_to_prim(u)
    return sim, u, prim


def counts(sim, prim, kernel, recon):
    """Operations per cell of each direction's launch of ``kernel``."""
    from benchmark.reference.plain.recon.schemes import reconstruct
    from benchmark.reference.plain.solver import hydro as h
    mesh, cfg, eos = sim.mesh, sim.cfg, sim.eos
    nv = 9 if cfg.fluid == "glmmhd" else 5
    cells = prim.numel() // prim.shape[1]
    out = {}
    for d in h.active_dirs(mesh):
        ax = h.AXIS_OF_DIR[d]
        dx = mesh.dx[d - 1]
        with torch.no_grad():
            F = h.directional_flux(prim, 0.5, d, dx, cfg, eos, recon)
        if kernel == "negdiv_sweep":
            def fn():
                f = h.directional_flux(prim, 0.5, d, dx, cfg, eos, recon)
                return -((torch.roll(f, -1, dims=ax) - f) / dx)[:, :nv]
            per = cells
        else:
            mflux = F[:, 0].clone()

            def fn():
                q = prim[:, nv:]
                qm, qp = reconstruct(recon, q, ax, dx,
                                     positivity_mask=[False] * q.shape[1])
                wl = torch.roll(qp, 1, dims=ax)
                fd = mflux[:, None]
                f = torch.where(fd >= 0.0, fd * wl, fd * qm)
                return -((torch.roll(f, -1, dims=ax) - f) / dx)
            per = cells * (prim.shape[1] - nv)
        ops, _, _ = count_ops(fn)
        out[str(d)] = ops / per
    return out


def stage_counts(sim, u0, prim, kernel, recon):
    """Operations per cell (per cell and scalar for ``stage_scalars``) of
    the stage kernel's work on each direction, in its order (module
    docstring): a stage ``gam0 u0f + gam1 u1 + beta_dt (-div F)`` with
    ``u1`` another state than ``u0``."""
    from benchmark.reference.plain.core.indices import IDN
    from benchmark.reference.plain.recon.schemes import reconstruct
    from benchmark.reference.plain.solver import hydro as h
    mesh, cfg, eos = sim.mesh, sim.cfg, sim.eos
    nv = 9 if cfg.fluid == "glmmhd" else 5
    ns = prim.shape[1] - nv
    dirs = h.active_dirs(mesh)
    u1 = 0.9 * u0
    gam0, gam1, beta_dt = 0.5, 0.5, 0.25

    def negdiv(f, d):
        ax, dx = h.AXIS_OF_DIR[d], mesh.dx[d - 1]
        return -((torch.roll(f, -1, dims=ax) - f) / dx)

    if kernel == "fused_stage":
        def through(upto):
            def fn():
                u0f, w = sim.hydro.cons_to_prim(u0)
                nd = None
                for d in dirs[:upto]:
                    r = negdiv(h.directional_flux(
                        w, 0.5, d, mesh.dx[d - 1], cfg, eos, recon), d)
                    nd = r if nd is None else nd + r
                if upto == len(dirs):
                    nd = gam0 * u0f + gam1 * u1 + beta_dt * nd
                return nd[:, :nv]
            return fn
        per = prim.numel() // prim.shape[1]
    else:
        with torch.no_grad():
            mflux = {d: h.directional_flux(prim, 0.5, d, mesh.dx[d - 1], cfg,
                                           eos, recon)[:, IDN].clone()
                     for d in dirs}

        def through(upto):
            def fn():
                rho = u0[:, IDN:IDN + 1]
                if eos.density_floor > 0.0:
                    rho = torch.clamp(rho, min=eos.density_floor)
                w = u0[:, nv:] * (1.0 / rho)
                nd = None
                for d in dirs[:upto]:
                    ax = h.AXIS_OF_DIR[d]
                    qm, qp = reconstruct(recon, w, ax, mesh.dx[d - 1],
                                         positivity_mask=[False] * ns)
                    wl = torch.roll(qp, 1, dims=ax)
                    fd = mflux[d][:, None]
                    r = negdiv(torch.where(fd >= 0.0, fd * wl, fd * qm), d)
                    nd = r if nd is None else nd + r
                if upto == len(dirs):
                    nd = gam0 * u0[:, nv:] + gam1 * u1[:, nv:] + beta_dt * nd
                return nd
            return fn
        per = (prim.numel() // prim.shape[1]) * ns
    out, before = {}, 0.0
    for i, d in enumerate(dirs, start=1):
        ops, _, _ = count_ops(through(i))
        out[str(d)] = ops / per - before
        before = ops / per
    return out


# the key of each kernel's counts in its file
COUNT_KEY = {"negdiv_sweep": "ops_per_cell", "fused_stage": "ops_per_cell",
             "negdiv_scalars": "ops_per_cell_per_scalar",
             "stage_scalars": "ops_per_cell_per_scalar"}


def main(argv=None):
    """Count again the cases of the named files of ``benchmark/kernels/``
    (all by default): each holds its ``kernel``, the kernel's ``template``
    switches, the ``config`` whose initial state it is counted on and the
    ``recon`` the launch runs; the counts are written into the file."""
    names = (argv if argv is not None else sys.argv[1:]) or sorted(
        p.stem for p in KERNELS.glob("*.json"))
    states = {}
    for name in names:
        path = KERNELS / f"{name}.json"
        data = json.loads(path.read_text())
        config, kernel = data["config"], data["kernel"]
        if config not in states:
            states[config] = state_of(config)
        sim, u, prim = states[config]
        if kernel in ("fused_stage", "stage_scalars"):
            per = stage_counts(sim, u, prim, kernel, data["recon"])
        else:
            per = counts(sim, prim, kernel, data["recon"])
        data[COUNT_KEY[kernel]] = per
        data["counted_on"] = (f"{config}'s initial state at {N}^3 "
                              "(benchmark/kernels/count_ops.py)")
        path.write_text(json.dumps(data, indent=1) + "\n")
        print(name, per, file=sys.stderr)


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Chip smoke test of the PyTorch + CUDA port (``athenapk_tpu_torch``) on one
NVIDIA card.

Run from the root of a checkout:  ``python3 chip_smoke.py [--seed N]``.
It needs the CUDA toolkit (``nvcc``) to build the sweep kernel from
``athenapk_tpu_torch/csrc/`` into ``build/``, and exits non-zero, printing
no result, when there is no CUDA card or when the port is not beside it.

Phases (each one fails the run if it fails):

1. card: name and power limit (``nvidia-smi``), torch's device name;
2. build: the sweep kernel, timed, with ptxas' register report;
3. kernel against plain: ``negdiv_cuda`` against ``negdiv_plain`` on a
   smooth GLM-MHD state made from ``--seed``, 128^3 in one block and 8
   ghosted 32^3 blocks (compared on interiors), f32 and f64, DC/PLM/PPM;
4. main path: the ``bench.py:run_bench`` deck (3-D MHD linear wave, 256^3,
   HLLD + PPM + VL2, ghost-free, f32) through ``Simulation(pin)`` for 10
   cycles (2 warm-up), with the kernel's launch count read around the run;
5. whole steps: the same deck at 32^3 in f64 for 5 cycles, once through
   the kernel and once with the plain -div(F) forced, state and every dt
   compared;
6. timings at the main path's inputs (256^3 f32): kernel against plain
   there (held to the f32 tolerance), kernel and plain per call and per
   launch, the bound from this run's bytes and the operations its data
   need;
7. profile: a torch.profiler trace of 3 main-path cycles, device time by
   kernel and the device's idle share.

The last lines are the kernels' JSON line, the card line and
``{"ok": true, "device": {...}}``.
"""

import argparse
import contextlib
import io
import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
# Errors are max |kernel - plain| over max |plain|, per variable.  Both
# versions do the same operations without FMA contraction, so they differ
# by rounding only (the kernel folds scalar constants in double), and
# -div(F)'s difference of neighbouring fluxes amplifies it.
F32_TOL = 1e-4   # measured at most 1.4e-5 (PPM, 8 ghosted 32^3 blocks)
F64_TOL = 1e-10
STEP_TOL = 1e-10

# published peaks of one H100 SXM at 700 W (NVIDIA data sheet)
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12

BENCH_DECK = """
<job>
problem_id = linear_wave_mhd

<problem/linear_wave>
compute_error = false
wave_flag = 0
amp = 1.0e-6
vflow = 0.0
test = true

<parthenon/mesh>
nghost = 0
nx1 = {n}
x1min = 0.0
x1max = 3.0
nx2 = {n}
x2min = 0.0
x2max = 1.5
nx3 = {n}
x3min = 0.0
x3max = 1.5

<parthenon/meshblock>
nx1 = {n}
nx2 = {n}
nx3 = {n}

<parthenon/time>
integrator = vl2
cfl = 0.3
tlim = 100.0
nlim = {ncycles}
ncycle_out = 0
perf_cycle_offset = {warmup}

<hydro>
fluid = glmmhd
eos = adiabatic
riemann = hlld
reconstruction = ppm
gamma = 1.666666666666667
precision = {precision}
"""


def log(*a):
    print(*a, flush=True)


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def smooth_glm_prim(mesh, seed, dtype):
    """Smooth GLM-MHD primitive state, every component nonzero, plus seeded
    noise (made on the host with numpy, as the CPU tests make theirs)."""
    rng = np.random.default_rng(seed)
    x, y, z = mesh.cell_centers_mesh()
    tp = 2.0 * np.pi
    w = np.zeros((mesh.nblocks, 9) + mesh.block_shape)
    w[:, 0] = 1.0 + 0.1 * np.sin(tp * x) * np.cos(tp * y) \
        + 0.05 * np.sin(tp * z)
    w[:, 1] = 0.3 + 0.2 * np.sin(tp * z) + 0.0 * x
    w[:, 2] = 0.2 + 0.1 * np.cos(tp * x) + 0.0 * y
    w[:, 3] = -0.15 + 0.1 * np.sin(tp * y) + 0.0 * z
    w[:, 4] = 0.6 + 0.05 * np.cos(tp * (x + y + z))
    w[:, 5] = 1.0 + 0.1 * np.sin(tp * y) + 0.0 * x
    w[:, 6] = 0.5 + 0.1 * np.cos(tp * z) + 0.0 * x
    w[:, 7] = 0.1 + 0.1 * np.sin(tp * x) + 0.0 * y
    w[:, 8] = 0.01 * np.sin(tp * (x - y)) + 0.0 * z
    w += 1e-3 * rng.standard_normal(w.shape)
    return torch.tensor(w, dtype=dtype, device="cuda")


def ptxas_summary(compiler_log):
    """One line per kernel instantiation: dtype, recon, direction,
    registers and spills, from ``nvcc -Xptxas -v``."""
    names = {"f": "f32", "d": "f64"}
    recons = {"0": "dc", "1": "plm", "2": "ppm"}
    lines, current = [], None
    for line in compiler_log.splitlines():
        m = re.search(r"Compiling entry function .*negdiv_sweep_kernelI"
                      r"([fd])Li(\d)ELi(\d)E", line)
        if m:
            current = (f"{names[m.group(1)]} {recons[m.group(2)]} "
                       f"dir {m.group(3)}")
            spill = ""
        elif current and "spill stores" in line:
            spill = line.split(",")[1].strip()
        elif current and "registers" in line:
            regs = re.search(r"Used (\d+) registers", line).group(1)
            lines.append(f"{current}: {regs} registers, {spill}")
            current = None
    return lines


def cuda_ms(fn, reps):
    """Mean device time of ``fn()`` over ``reps`` calls (CUDA events),
    after one warm-up call."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def max_rel_err(got, ref, per_var=True):
    """max |got - ref| over max |ref|, for each variable (axis 1) and the
    worst of them returned, or over all variables at once."""
    err = (got - ref).abs()
    if not per_var:
        return (err.max() / ref.abs().max()).item()
    dims = [0, 2, 3, 4]
    return (err.amax(dim=dims) / ref.abs().amax(dim=dims)).max().item()


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
            grads = torch.autograd.grad(e["func"](*args, **kwargs), xs,
                                        m.float(), allow_unused=True)
            masks = [torch.zeros(x.shape, dtype=torch.bool, device=m.device)
                     if g is None else g > 0 for x, g in zip(xs, grads)]
        for (tag, shape), mi in zip(e["ins"], masks):
            if tag is None:
                continue
            if mi.shape != shape:
                mi = mi.int().sum_to_size(shape) > 0
            need[tag] = need[tag] | mi if tag in need else mi
    return ops, slow, full


def phase_kernel_vs_plain(sweep, Mesh, HydroConfig, EOS, seed):
    log("== phase 3: kernel against plain ==")
    eos = EOS(gamma=5.0 / 3.0)
    layouts = [("128^3 one block", dict(n=128, mb=128, g=0)),
               ("8 blocks of 32^3, nghost 3", dict(n=64, mb=32, g=3))]
    failed = []
    for label, L in layouts:
        mesh = Mesh(nx1=L["n"], nx2=L["n"], nx3=L["n"], mbnx1=L["mb"],
                    mbnx2=L["mb"], mbnx3=L["mb"], x1min=0.0, x1max=1.0,
                    x2min=0.0, x2max=1.5, x3min=0.0, x3max=1.5,
                    nghost=L["g"])
        sl = mesh.interior_slices
        for dtype, tol in ((torch.float32, F32_TOL), (torch.float64, F64_TOL)):
            prim = smooth_glm_prim(mesh, seed, dtype)
            for recon in ("dc", "plm", "ppm"):
                cfg = HydroConfig(fluid="glmmhd", riemann="hlld",
                                  reconstruction=recon)
                got = sweep.negdiv_cuda(prim, 1.3, mesh, cfg, eos, recon)
                torch.cuda.synchronize()
                ref = sweep.negdiv_plain(prim, 1.3, mesh, cfg, eos, recon)
                torch.cuda.synchronize()
                err = max_rel_err(got[sl], ref[sl])
                ok = err <= tol and bool(torch.isfinite(got[sl]).all())
                log(f"  {label:28s} {str(dtype):14s} {recon:3s} "
                    f"max rel err {err:.3e} (tol {tol:.0e}, per variable; "
                    f"{max_rel_err(got[sl], ref[sl], per_var=False):.3e} "
                    f"over all) {'ok' if ok else 'FAIL'}")
                if not ok:
                    failed.append(f"{label} {dtype} {recon}")
                del got, ref
            del prim
        torch.cuda.empty_cache()
    if failed:
        raise AssertionError(f"kernel disagrees with plain: {failed}")


def phase_main_path(sweep, ParameterInput, Simulation, n, ncycles, warmup):
    log(f"== phase 4: main path ({n}^3, f32, {ncycles} cycles) ==")
    pin = ParameterInput.from_string(BENCH_DECK.format(
        n=n, ncycles=ncycles, warmup=warmup, precision="single"))
    t0 = time.time()
    sim = Simulation(pin, quiet=True)
    u0 = sim.u.clone()
    log(f"  set-up {time.time() - t0:.2f} s: mesh {sim.mesh.nx1}x"
        f"{sim.mesh.nx2}x{sim.mesh.nx3}, blocks {sim.mesh.nblocks}, "
        f"nghost {sim.mesh.nghost}, dtype {sim.u.dtype}, "
        f"device {sim.u.device}")
    out = io.StringIO()
    sweep.negdiv_cuda.launches = 0
    with contextlib.redirect_stdout(out):
        sim.run()
    launches = sweep.negdiv_cuda.launches
    text = out.getvalue()
    print(text, end="", flush=True)
    m = re.search(r"zone-cycles/wallsecond = (\S+)", text)
    if m is None:
        raise AssertionError("main path printed no zone-cycles line")
    zcps = float(m.group(1))
    expect = 2 * 3 * ncycles
    log(f"  kernel launches {launches} (expected 2 stages x 3 directions x "
        f"{ncycles} cycles = {expect})")
    if sim.ncycle != ncycles or launches != expect:
        raise AssertionError(f"main path ran {sim.ncycle} cycles and "
                             f"{launches} kernel launches")
    if not bool(torch.isfinite(sim.u).all()):
        raise AssertionError("main path state is not finite")
    # a 1e-6 linear wave stays a 1e-6 perturbation of the background
    drift = (sim.u - u0).abs().max().item()
    log(f"  state finite; max |u - u(t=0)| = {drift:.3e} at t = {sim.t:.6e}")
    if drift > 1e-5:
        raise AssertionError(f"linear wave left the linear regime: {drift}")
    return sim, launches, zcps


def phase_whole_steps(sweep, ParameterInput, Simulation):
    log("== phase 5: kernel against plain over whole steps (32^3, f64) ==")
    deck = BENCH_DECK.format(n=32, ncycles=5, warmup=0, precision="double") \
        + "\n<parthenon/output1>\nfile_type = hst\n"
    runs = {}
    for name in ("kernel", "plain"):
        outdir = ROOT / "build" / "chip_smoke" / name
        outdir.mkdir(parents=True, exist_ok=True)
        hst = outdir / "linear_wave_mhd.out1.hst"
        if hst.exists():
            hst.unlink()
        sim = Simulation(ParameterInput.from_string(deck), quiet=True)
        cwd = os.getcwd()
        dispatch = sweep.fused_negdiv
        os.chdir(outdir)
        try:
            if name == "plain":
                # the stage update reaches -div(F) through this name
                sweep.fused_negdiv = sweep.negdiv_plain
            with contextlib.redirect_stdout(io.StringIO()):
                sim.run()
        finally:
            sweep.fused_negdiv = dispatch
            os.chdir(cwd)
        runs[name] = (sim.u.double().cpu().numpy(), np.loadtxt(hst))
    (uk, hk), (up, hp) = runs["kernel"], runs["plain"]
    err_u = float(np.abs(uk - up).max() / np.abs(up).max())
    err_dt = float(np.abs(hk[:, 1] - hp[:, 1]).max() / np.abs(hp[:, 1]).max())
    log(f"  state max rel err {err_u:.3e}, dt max rel err {err_dt:.3e} "
        f"over {hk.shape[0] - 2} cycles (tol {STEP_TOL:.0e})")
    if not (err_u <= STEP_TOL and err_dt <= STEP_TOL
            and hk.shape == hp.shape):
        raise AssertionError("kernel and plain steps disagree")


def phase_timings(sweep, sim, launches, reps):
    log("== phase 6: timings at the main path's inputs ==")
    mesh, cfg, eos = sim.mesh, sim.cfg, sim.eos
    _, prim = sim.pkg.cons_to_prim(sim.u)
    c_h = sim.pkg.c_h_from_dt_hyp(sim._estimate()[1])
    itemsize = prim.element_size()
    cells = prim.numel() // prim.shape[1]
    tol = F32_TOL if prim.dtype == torch.float32 else F64_TOL
    per_recon = {}
    max_abs, max_rel = 0.0, 0.0
    for recon in ("dc", "ppm"):
        got = sweep.negdiv_cuda(prim, c_h, mesh, cfg, eos, recon)
        ref = sweep.negdiv_plain(prim, c_h, mesh, cfg, eos, recon)
        torch.cuda.synchronize()
        abs_err = (got - ref).abs().max().item()
        rel = max_rel_err(got, ref)
        finite = bool(torch.isfinite(got).all())
        max_abs, max_rel = max(max_abs, abs_err), max(max_rel, rel)
        log(f"  {recon}: kernel against plain max abs err {abs_err:.3e}, "
            f"max rel err {rel:.3e} (tol {tol:.0e}, per variable; "
            f"{max_rel_err(got, ref, per_var=False):.3e} over all)")
        del got, ref
        torch.cuda.empty_cache()
        if not (rel <= tol and finite):
            raise AssertionError(f"kernel disagrees with plain at the main "
                                 f"path's inputs ({recon}): {rel:.3e}")
        ms = cuda_ms(lambda: sweep.negdiv_cuda(prim, c_h, mesh, cfg, eos,
                                               recon), reps)
        plain_ms = cuda_ms(lambda: sweep.negdiv_plain(prim, c_h, mesh, cfg,
                                                      eos, recon), 3)
        torch.cuda.empty_cache()
        ops, slow, full = count_ops(lambda: sweep.negdiv_plain(
            prim, c_h, mesh, cfg, eos, recon))
        torch.cuda.empty_cache()
        nbytes = 2 * prim.numel() * itemsize   # prim read once, out written once
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / FP32_OPS_PER_S * 1e3
        per_recon[recon] = dict(ms=ms, plain_ms=plain_ms,
                                bound_ms=max(t_bytes, t_ops),
                                bound_by="bytes" if t_bytes >= t_ops
                                else "operations",
                                bytes=nbytes, ops=ops,
                                ops_per_cell=ops / cells,
                                div_sqrt_per_cell=slow / cells,
                                branch_free_ops_per_cell=full / cells)
        log(f"  {recon}: kernel {ms:.4f} ms/call (3 launches), plain "
            f"{plain_ms:.4f} ms/call; bound {max(t_bytes, t_ops):.4f} ms "
            f"(bytes {t_bytes:.4f} ms for {nbytes:.4e} B, operations "
            f"{t_ops:.4f} ms for {ops:.4e} ops = {ops / cells:.1f}/cell, "
            f"of them {slow / cells:.1f} divisions and roots; the "
            f"branch-free lattice does {full / cells:.1f}/cell)")
    # one main-path cycle runs one DC and one PPM call: 6 launches
    mix = lambda k: (per_recon["dc"][k] + per_recon["ppm"][k]) / 6  # noqa
    t_b = sum(r["bytes"] for r in per_recon.values()) / HBM_BYTES_PER_S
    t_o = sum(r["ops"] for r in per_recon.values()) / FP32_OPS_PER_S
    entry = {
        "name": "negdiv_sweep",
        "route": "cuda",
        "source": "athenapk_tpu_torch/csrc/negdiv_sweep.cu",
        "replaces": "athenapk_tpu/solver/pallas_sweep.py:37",
        "launches": launches,
        "launches_per_cycle": 6,
        "max_abs_err": max_abs,
        "ms": mix("ms"),
        "plain_ms": mix("plain_ms"),
        "bound_ms": mix("bound_ms"),
        "bound_by": "bytes" if t_b >= t_o else "operations",
        "library_ms": None,
        "library_note": "no single PyTorch call computes PPM + HLLD + "
                        "flux divergence",
        "unit": f"per launch (one direction), averaged over one main-path "
                f"cycle (one DC and one PPM call), {mesh.nx1}^3 "
                f"{str(prim.dtype).replace('torch.', '')}",
        "max_rel_err": max_rel,
        "per_call": per_recon,
    }
    return entry


def phase_profile(sim, ncycles):
    """Where one main-path cycle's device time goes: a torch.profiler
    trace of ``ncycles`` steps, kernels grouped by name, and the share of
    the window in which no kernel ran."""
    log(f"== phase 7: device-time breakdown of {ncycles} main-path cycles ==")
    from torch.profiler import ProfilerActivity, profile

    dt, dt_hyp = sim._estimate()
    c_h = sim.pkg.c_h_from_dt_hyp(dt_hyp)
    u = sim.u
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(ncycles):
            u, _ = sim.pkg.step_with_dt(u, dt, c_h)
        torch.cuda.synchronize()
    trace = ROOT / "build" / "chip_smoke" / "main_path_trace.json"
    trace.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(trace))
    events = json.loads(trace.read_text())["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    if not kernels:
        log("  the profiler recorded no device kernels: not measured")
        return None
    groups = {}
    for e in kernels:
        m = re.search(r"negdiv_sweep_kernel<(\w+), (\d), (\d)>", e["name"])
        key = (f"negdiv_sweep {'dc plm ppm'.split()[int(m.group(2))]} "
               f"dir {m.group(3)}" if m else
               "negdiv_sweep (unparsed)" if "negdiv_sweep" in e["name"]
               else "other kernels (plain PyTorch)")
        groups[key] = groups.get(key, 0.0) + e["dur"] / 1e3
    busy = sum(e["dur"] for e in kernels) / 1e3
    t0 = min(e["ts"] for e in kernels)
    t1 = max(e["ts"] + e["dur"] for e in kernels)
    window = (t1 - t0) / 1e3
    for key in sorted(groups, key=groups.get, reverse=True):
        log(f"  {key:32s} {groups[key] / ncycles:9.4f} ms/cycle "
            f"({100 * groups[key] / busy:5.1f} % of device time)")
    idle = max(0.0, 1.0 - busy / window)
    log(f"  device busy {busy / ncycles:.4f} ms/cycle over a "
        f"{window / ncycles:.4f} ms/cycle window: idle share {idle:.3f}")
    return {"ms_per_cycle": {k: v / ncycles for k, v in groups.items()},
            "busy_ms_per_cycle": busy / ncycles,
            "window_ms_per_cycle": window / ncycles, "idle_share": idle}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the kernel-against-plain states")
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's chip check needs one",
              file=sys.stderr)
        return 1
    try:
        from athenapk_tpu_torch.config.parameter_input import ParameterInput
        from athenapk_tpu_torch.core.mesh import Mesh
        from athenapk_tpu_torch.driver import Simulation
        from athenapk_tpu_torch.eos.adiabatic import EOS
        from athenapk_tpu_torch.solver import sweep
        from athenapk_tpu_torch.solver.hydro_pkg import HydroConfig
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script ({e})",
              file=sys.stderr)
        return 1
    t_start = time.time()

    log("== phase 1: card ==")
    card = card_line()
    log(f"  nvidia-smi: {card}")
    log(f"  torch {torch.__version__} (CUDA {torch.version.cuda}), device "
        f"{torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}")

    log("== phase 2: build ==")
    t0 = time.time()
    path, compiler_log = sweep.build_library()
    log(f"  built {path.relative_to(ROOT)} in {time.time() - t0:.2f} s")
    for line in ptxas_summary(compiler_log):
        log("  ptxas:", line)

    phase_kernel_vs_plain(sweep, Mesh, HydroConfig, EOS, args.seed)
    sim, launches, zcps = phase_main_path(sweep, ParameterInput, Simulation,
                                          n=256, ncycles=10, warmup=2)
    phase_whole_steps(sweep, ParameterInput, Simulation)
    entry = phase_timings(sweep, sim, launches, reps=20)
    entry["zone_cycles_per_s"] = zcps
    entry["main_path_profile"] = phase_profile(sim, 3)
    log(f"== done in {time.time() - t_start:.1f} s ==")

    print(json.dumps({"kernels": [entry]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

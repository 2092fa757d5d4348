"""The stage kernels' names and costs, and the roofline of a refined
layout on a synthetic trace: three levels of one block shape, each level
launching the stage kernel once a stage, are priced at the levels' own
cells; a case launched no multiple of the levels' count reads None; a
layout without levels is priced launch by launch, as before."""

import pytest

from bench_helpers import ROOT  # noqa: F401

from benchmark.harness import roofline
from benchmark.harness.trace import WINDOW, Trace, parse_kernel

STAGE = ("void stage::fused_stage_kernel<double, {recon}, 2, true, true>"
         "(double const*, double const*, double*, double*, double*, "
         "stage::Faces<double>, stage::Shape, hydro::Params<double>, "
         "stage::Scalars<double>, stage::ScalarArgs<double>)")
SCALARS = ("void stage::stage_scalars_kernel<double, {recon}>(double const*, "
           "double const*, double*, double*, stage::Faces<double>, "
           "stage::Shape, int, int, hydro::Params<double>, "
           "stage::Scalars<double>, stage::ScalarArgs<double>)")
SWEEP = ("void negdiv_sweep_kernel<double, 1, {d}, 2, true>(double const*, "
         "double*, double*, Geom, Params<double>, ReconK<double>, double, "
         "int, int, double*)")
BLOCK = (10, 12, 12, 12)            # nvar and a ghosted 8^3 block
LEVELS = [7, 7, 8]


def layout(levels=LEVELS, **kw):
    out = dict(shape=(sum(levels),) + BLOCK, itemsize=8, fluid="glmmhd",
               nscalars=1, levels=list(levels), stage_prim=True,
               stage_faces=True)
    out.update(kw)
    return out


def test_stage_kernel_names_parse():
    assert parse_kernel(STAGE.format(recon=1)) == ("fused_stage", "double",
                                                   dict(recon=1, solver=2,
                                                        faces=True,
                                                        scal=True))
    assert parse_kernel(
        "void stage::fused_stage_kernel<float, 5, 5, false, false>(...)") \
        == ("fused_stage", "float", dict(recon=5, solver=5, faces=False,
                                         scal=False))
    assert parse_kernel(SCALARS.format(recon=0)) == ("stage_scalars",
                                                     "double", dict(recon=0))


def test_stage_launch_bytes_and_operations():
    case = {"ops_per_cell": {"1": 100.0, "2": 110.0, "3": 120.0}}
    scal = {"ops_per_cell_per_scalar": {"1": 7.0, "2": 5.0, "3": 9.0}}
    lay = layout(levels=[2], shape=(2, 10, 4, 6, 8))
    cells = 2 * 4 * 6 * 8
    slab = 2 * 2 * (4 * 6 + 4 * 8 + 6 * 8)
    sw = dict(recon=1, solver=2, faces=True, scal=True)
    # u0, u1 read, u_new and prim written (9 rows each), 3 mass fluxes;
    # the 9 fluid rows of the face slabs
    assert roofline.launch_cost("fused_stage", sw, case, lay) == (
        (39 * cells + 9 * slab) * 8, 330.0 * cells)
    bare = dict(lay, stage_prim=False, stage_faces=False)
    assert roofline.launch_cost("fused_stage", dict(sw, faces=False,
                                                    scal=False),
                                case, bare) == (27 * cells * 8, 330.0 * cells)
    # the scalar rows of u0, u1, u_new and prim, the density, 3 mass
    # fluxes; the scalar row of the face slabs
    assert roofline.launch_cost("stage_scalars", dict(recon=1), scal,
                                lay) == ((8 * cells + slab) * 8, 21.0 * cells)
    with pytest.raises(ValueError, match="levels"):
        roofline.launch_cost("fused_stage", sw, case,
                             layout(levels=[1, 2], shape=(4,) + BLOCK))


def test_every_stage_case_is_counted():
    known = roofline.cases()
    for recon in (0, 1):
        assert ("fused_stage", (("recon", recon), ("solver", 2))) in known
        assert ("stage_scalars", (("recon", recon),)) in known


def ev(cat, name, ts, dur, **args):
    e = {"cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 1,
         "tid": 1}
    if args:
        e["args"] = args
    return e


def synthetic(names_durs):
    """A window holding one launch of each ``(name, dur)``, in order."""
    events = [ev("user_annotation", WINDOW, 0, 10000)]
    ts = 10.0
    for corr, (name, dur) in enumerate(names_durs, start=1):
        events += [ev("cuda_runtime", "cudaLaunchKernel", ts, 1,
                      correlation=corr),
                   ev("kernel", name, ts + 1, dur, correlation=corr)]
        ts += dur + 5
    return events


def level_truth(names_levels_durs, kernel, lay):
    """The share with each launch priced at its own level's blocks."""
    known, pk = roofline.cases(), roofline.peaks()
    least = measured = 0.0
    for name, lev, dur in names_levels_durs:
        k, dtype, sw = parse_kernel(name)
        if k != kernel:
            continue
        key = tuple(sorted((s, sw[s]) for s in ("recon", "solver")
                           if s in sw))
        own = dict(lay, shape=(lay["levels"][lev],) + BLOCK, levels=None)
        least += roofline.least_seconds(*roofline.launch_cost(
            k, sw, known[(k, key)], own), dtype, pk)
        measured += dur / 1e6
    return 100.0 * least / measured


def refined_cycles(ncycles=2):
    """The stage rung's launches on three levels: each VL2 stage a stage
    launch (DC, then PLM) and a scalar launch per level, each level's
    time in proportion to its blocks."""
    out = []
    for _ in range(ncycles):
        for recon in (0, 1):
            for lev, nb in enumerate(LEVELS):
                out.append((STAGE.format(recon=recon), lev, 40.0 * nb))
                out.append((SCALARS.format(recon=recon), lev, 4.0 * nb))
    return out


@pytest.mark.parametrize("kernel", ["fused_stage", "stage_scalars"])
def test_refined_share_is_priced_at_each_level(kernel):
    launches = refined_cycles()
    tr = Trace(synthetic([(n, d) for n, _, d in launches]), cycles=2,
               layout=layout())
    got = roofline.share(tr, kernel)
    assert got == pytest.approx(level_truth(launches, kernel, layout()),
                                rel=1e-12)
    assert 0.0 < got < 100.0
    # the whole state's price for every launch would read three times it
    flat = Trace(synthetic([(n, d) for n, _, d in launches]), cycles=2,
                 layout=dict(layout(), levels=None))
    assert roofline.share(flat, kernel) == pytest.approx(3 * got,
                                                         rel=1e-12)


def test_count_no_multiple_of_the_levels_reads_none():
    launches = refined_cycles()[:-2]      # the last level's launches cut
    tr = Trace(synthetic([(n, d) for n, _, d in launches]), cycles=2,
               layout=layout())
    assert roofline.share(tr, "fused_stage") is None
    assert roofline.share(tr, "stage_scalars") is None


def test_sweep_on_levels_and_without():
    """The sweep on a refined layout: each direction launched once a
    level, priced at the levels' cells; on a layout without levels every
    launch at the whole state's, summed launch by launch."""
    launches = [(SWEEP.format(d=d), lev, 10.0 * nb) for d in (1, 2, 3)
                for lev, nb in enumerate(LEVELS)]
    events = synthetic([(n, d) for n, _, d in launches])
    tr = Trace(events, cycles=1, layout=layout())
    assert roofline.share(tr, "negdiv_sweep") == pytest.approx(
        level_truth(launches, "negdiv_sweep", layout()), rel=1e-12)
    uniform = dict(shape=(22,) + BLOCK, itemsize=8, fluid="glmmhd",
                   nscalars=1)
    known, pk = roofline.cases(), roofline.peaks()
    least = measured = 0.0
    for name, _, dur in launches:
        _, dtype, sw = parse_kernel(name)
        least += roofline.least_seconds(*roofline.launch_cost(
            "negdiv_sweep", sw, known[("negdiv_sweep", (("recon", 1),
                                                        ("solver", 2)))],
            uniform), dtype, pk)
        measured += dur / 1e6
    assert roofline.share(Trace(events, cycles=1, layout=uniform),
                          "negdiv_sweep") == 100.0 * least / measured


@pytest.mark.parametrize("fluid", ["glmmhd", "euler"])
def test_state_error_over_levels_is_that_of_the_joined_state(fluid):
    """A gap and a scale over every level: the levels' error is the error
    of the levels joined into one state, whichever level holds the gap or
    the largest magnitude."""
    import torch

    from benchmark.harness.compare import state_error
    nvar = (9 if fluid == "glmmhd" else 5) + 1
    gen = torch.Generator().manual_seed(3)
    ref = tuple(torch.rand(n, nvar, 4, 4, 4, generator=gen,
                           dtype=torch.float64) * (1 + lev)
                for lev, n in enumerate((3, 2, 4)))
    got = tuple(r.clone() for r in ref)
    got[2][1, 0, 1, 2, 3] += 1e-3
    got[0][0, 3, 0, 0, 0] -= 1e-2
    got[1][0, -1, 1, 1, 1] += 1e-4
    one = state_error(torch.cat(got), torch.cat(ref), fluid, 0.7)
    assert state_error(got, ref, fluid, 0.7) == one > 0.0
    assert state_error(ref, ref, fluid, 0.7) == 0.0
    got[1][0, 0, 0, 0, 0] = float("nan")
    assert state_error(got, ref, fluid, 0.7) == float("inf")

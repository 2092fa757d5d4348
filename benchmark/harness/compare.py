"""The numbers that decide ``correct``.

* ``start_err``: the program's initial state against the reference's;
* ``dt_err``: the dt and c_h of two consecutive cycles of the window, as
  the program used them, against the reference's estimate from the
  program's state entering each (the largest relative gap);
* ``cycle_err``: one cycle of the window, drawn from the seed, against
  the reference's cycle from the program's state entering it.

A state gap is taken per group of variables and over the group's scale:
density, the momentum vector, energy, the field vector, each passive
scalar, each by the largest magnitude of the reference's group; the
cleaning field psi by c_h times the largest field component (psi carries
the units of B times a speed, and on a divergence-free state it holds
rounding alone, so its own magnitude is no scale).  A group that is zero in
the reference must be zero in the program.

A state is one tensor ``[nb, nvar, NZ, NY, NX]`` or, on a refined mesh, a
tuple of such tensors, one per level in a fixed order: a group's scale is
then the reference's largest magnitude of the group over all levels, and
its gap the largest over all levels.

``readings`` takes these numbers for a reference with the interface of the
plain driver's ``PlainSim`` (``initial_state``, ``next_dt`` and ``cycle``
over states of the program's form); a configuration whose reference module
defines its own ``readings`` (with the same arguments) is judged by that
one.
"""

from __future__ import annotations

import math

import torch

# conserved layout (the port's, core/indices.py)
IDN, IM1, IM2, IM3, IEN, IB1, IB2, IB3, IPS = range(9)


def groups(fluid, nvar):
    """``[(name, [rows])]`` of a state's variable groups."""
    out = [("density", [IDN]), ("momentum", [IM1, IM2, IM3]),
           ("energy", [IEN])]
    base = 5
    if fluid == "glmmhd":
        out += [("field", [IB1, IB2, IB3]), ("psi", [IPS])]
        base = 9
    out += [(f"scalar{i}", [base + i]) for i in range(nvar - base)]
    return out


def tensors(u):
    """A state's tensors: ``(u,)`` for one tensor, else its levels."""
    return (u,) if isinstance(u, torch.Tensor) else tuple(u)


def each(u, fn):
    """``fn`` of each tensor of the state ``u``, in ``u``'s form."""
    return fn(u) if isinstance(u, torch.Tensor) else tuple(
        fn(x) for x in u)


def _largest(values):
    """The largest of ``values``; NaN if any is NaN."""
    return (math.nan if any(math.isnan(v) for v in values)
            else max(values))


def state_error(got, ref, fluid, c_h):
    """max over the groups of max |got - ref| / the group's scale, each
    over every level of the states ``got`` and ``ref`` (of one form)."""
    refs = [x.to(torch.float64) for x in tensors(ref)]
    gots = [torch.as_tensor(g).to(r.device, torch.float64)
            for g, r in zip(tensors(got), refs, strict=True)]
    nvar = refs[0].shape[1]
    scales = {name: _largest([r[:, rows].abs().max().item() for r in refs])
              for name, rows in groups(fluid, nvar)}
    if "psi" in scales:
        scales["psi"] = c_h * scales["field"]
    worst = 0.0
    for name, rows in groups(fluid, nvar):
        gap = _largest([(g[:, rows] - r[:, rows]).abs().max().item()
                        for g, r in zip(gots, refs)])
        scale = scales[name]
        if math.isnan(gap):
            err = math.inf
        elif scale > 0.0:
            err = gap / scale
        else:
            err = 0.0 if gap == 0.0 else math.inf
        worst = max(worst, err)
    return worst


def rel_gap(got, want):
    if not (math.isfinite(got) and math.isfinite(want)) or want == 0.0:
        return 0.0 if got == want else math.inf
    return abs(got - want) / abs(want)


def readings(ref, u0_prog, cap, fluid, model=None):
    """The three numbers of ``model``'s answers against the reference
    ``ref`` (both ``PlainSim``s) from the program's captured states
    ``cap`` (cycles k and k + 1): with ``model`` None the program's own
    answers (its initial state ``u0_prog``, its dt and c_h, its state after
    cycle k), else those ``model`` computes in the program's place."""
    k = min(cap)
    a, b = cap[k], cap[k + 1]
    ua = each(a["u"], lambda x: x.to(ref.device, ref.dtype))
    u0_ref = ref.initial_state()
    if model is None:
        start = u0_prog
        got_dt = [a["dt"], a["c_h"], b["dt"], b["c_h"]]
        got_u = b["u"]
    else:
        start = model.initial_state()
        ua_m = each(a["u"], lambda x: x.to(model.device, model.dtype))
        dt_m, c_h_m = model.next_dt(ua_m, a["t"], a["dt_prev"])
        dt1_m, c_h1_m = model.next_dt(
            each(b["u"], lambda x: x.to(model.device, model.dtype)),
            b["t"], dt_m)
        got_dt = [dt_m, c_h_m, dt1_m, c_h1_m]
        got_u = model.cycle(ua_m, dt_m, c_h_m, a["t"])
        del ua_m
    start_err = state_error(start, u0_ref, fluid, a["c_h"])
    del u0_ref, start
    dt_ref, c_h_ref = ref.next_dt(ua, a["t"], a["dt_prev"])
    ub = each(b["u"], lambda x: x.to(ref.device, ref.dtype))
    dt1_ref, c_h1_ref = ref.next_dt(ub, b["t"], got_dt[0])
    del ub
    dt_err = max(rel_gap(g, w) for g, w in zip(
        got_dt, [dt_ref, c_h_ref, dt1_ref, c_h1_ref]))
    uk_ref = ref.cycle(ua, dt_ref, c_h_ref, a["t"])
    del ua
    cycle_err = state_error(got_u, uk_ref, fluid, c_h_ref)
    del uk_ref, got_u
    if ref.device.type == "cuda":
        torch.cuda.empty_cache()
    return dict(start_err=start_err, dt_err=dt_err, cycle_err=cycle_err)

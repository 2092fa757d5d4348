"""The index box that holds a source's sphere.

The AGN's thermal dump, jet slabs, accretion region and tower, the
stellar feedback and the clips change cells within a radius of the origin
only: outside it each of their operations adds an exact zero, multiplies
by exactly 1 or writes back the value it read.  So they run their plain
operations on views of a group sliced by the index box of the cells whose
centres lie within that radius plus one cell, and the cells the box
leaves out keep their bits; only the order of a partial sum over the
region changes (its terms outside the box are exact zeros).

A group (``pgen._group``) that offers ``box(radius)`` -> ``(k, j, i)``
slices, or None where the box is the whole block, runs on the box; one
that does not (the refined hooks, whose sums run per leaf) runs whole.
``counts[name]`` counts, per source, the calls that ran on a box smaller
than the group (``engaged``) and on the whole group (``whole``), and the
cells of the last call's box (``cells``).
"""

from __future__ import annotations

import collections

import numpy as np

counts = collections.defaultdict(lambda: {"engaged": 0, "whole": 0,
                                          "cells": 0})


def index_box(host, radius):
    """The index box of the cells of ``host`` = (x[nb,1,1,NX],
    y[nb,1,NY,1], z[nb,NZ,1,1]) (numpy cell centres) within ``radius`` of
    the origin, one cell wider on each side: per block the box of each
    axis's cells within reach, and over the blocks that hold one, the
    union of their index ranges.  -> ``(k, j, i)`` slices (empty where no
    block holds such a cell), or None where the box is the whole block."""
    axes = [c.reshape(c.shape[0], -1) for c in (host[2], host[1], host[0])]
    near = []
    for a in axes:                                  # the block's z, y, x
        d = float(np.abs(np.diff(a, axis=1)).max()) if a.shape[1] > 1 \
            else 0.0
        near.append(np.abs(a) <= radius + d)        # [nb, N]
    held = np.logical_and.reduce([m.any(axis=1) for m in near])
    out = []
    for m in near:
        hit = np.nonzero(m[held].any(axis=0))[0]
        out.append(slice(int(hit[0]), int(hit[-1]) + 1) if hit.size
                   else slice(0, 0))
    if all(s == slice(0, a.shape[1]) for s, a in zip(out, axes)):
        return None
    return tuple(out)


def of(group, name, radius):
    """``group`` on the box of ``radius`` (a group of views into its
    tensors: an in-place update of the box's ``u`` writes into the state),
    or ``group`` itself where it offers no box or the box is the whole
    block; counted under ``name``."""
    c = counts[name]
    box = group.get("box")
    sl = None if box is None else box(radius)
    if sl is None:
        c["whole"] += 1
        c["cells"] = group["r"].numel()
        return group
    k, j, i = sl

    def cells(a):
        return None if a is None else a[:, k, j, i]

    def rows(a):
        return None if a is None else a[:, :, k, j, i]

    out = dict(group, u=rows(group["u"]), prim=rows(group["prim"]),
               x=group["x"][..., i], y=group["y"][:, :, j],
               z=group["z"][:, k], r=cells(group["r"]),
               valid=cells(group["valid"]), box=None)
    c["engaged"] += 1
    c["cells"] = out["r"].numel()
    return out

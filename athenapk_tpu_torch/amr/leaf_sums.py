"""Sums over a refined mesh's leaves in one fixed order, on one rank or
over ranks: the cross-leaf reductions of the problem's source hooks (the
cluster's accretion rate, the tower's energy quadratic, the Bondi region's
mass; the reference's ``MPI_Allreduce``, ``hydro_driver.cpp:360-449``).

A sum is taken in two steps, both by pairwise halving (``tree_sum``):
every leaf's cells into one partial per leaf, then the partials of all
leaves in global leaf-id order.  Halving adds elementwise only, so its
bits depend on the values alone, not on the device, the thread count or
how many other leaves share a tensor: a rank that holds some of the leaves
makes the same per-leaf partials as one rank that holds them all.  Over
ranks, each rank writes its partials into a ``[leaves, k]`` table at its
leaves' ids (zeros elsewhere, which add exactly) and one ``all_reduce``
per call fills in the rest; every rank then sums the same table in the
same order.  So a sharded run equals the one-rank run bit for bit, with
one collective per source call and no host read.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def tree_sum(x, dim=0):
    """The sum of ``x`` over ``dim`` by pairwise halving (``dim`` padded
    with zeros to a power of two): elementwise adds in a fixed order."""
    x = x.movedim(dim, -1)
    n = x.shape[-1]
    if n == 0:
        return x.new_zeros(x.shape[:-1])
    m = 1 << (n - 1).bit_length()
    if m != n:
        x = F.pad(x, (0, m - n))
    while m > 1:
        m //= 2
        x = x[..., :m] + x[..., m:]
    return x[..., 0]


class LeafSums:
    """Sums over every leaf of ``smesh``, of partials made on the leaves a
    rank holds.

    ``ids``: ``{level: global ids of the rows held}`` (all the leaves of
    each level by default); ``rmesh``: the ranks (a
    ``parallel.mesh_sharding.RankMesh``) whose partials join the sum, or
    None on one rank."""

    def __init__(self, smesh, ids=None, rmesh=None):
        self.n = int(smesh.levels.size)
        self.ids = ({lev: np.asarray(v) for lev, v in smesh.level_ids.items()}
                    if ids is None else ids)
        self.rmesh = rmesh
        self.collectives = 0
        self._ix = {}

    @staticmethod
    def partial(field):
        """One partial per leaf (row) of ``field`` ``[n, ...]`` -> ``[n]``."""
        return tree_sum(field.reshape(field.shape[0], -1), dim=1)

    def _index(self, lev, device):
        key = (lev, device)
        if key not in self._ix:
            self._ix[key] = torch.as_tensor(self.ids[lev], dtype=torch.int64,
                                            device=device)
        return self._ix[key]

    def total(self, parts):
        """``[(level, {name: [held leaves of the level] partials})]`` ->
        ``{name: 0-d tensor}``: each name summed over every leaf of every
        rank in global id order (one ``all_reduce`` over ranks)."""
        names = list(parts[0][1])
        like = parts[0][1][names[0]]
        table = torch.zeros((self.n, len(names)), dtype=like.dtype,
                            device=like.device)
        for lev, p in parts:
            table.index_copy_(0, self._index(lev, like.device),
                              torch.stack([p[k] for k in names], dim=1))
        if self.rmesh is not None:
            table = self.rmesh.all_reduce(table, "sum")
            self.collectives += 1
        tot = tree_sum(table, dim=0)
        return {k: tot[i] for i, k in enumerate(names)}

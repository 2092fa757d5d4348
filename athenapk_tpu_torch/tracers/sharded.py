"""Tracers over ranks: per-rank pools with lossless routing between ranks.

Counterpart of ``athenapk_tpu/tracers/sharded.py`` (reference swarm MPI
routing, ``src/hydro/hydro_driver.cpp:617-660``).  The fluid state is
split over the ranks in z-slabs (``parallel.halo``) and the tracer pools
``[nblocks, cap]`` the same way: each rank advects and samples its own
blocks' particles (``Tracers.advect`` / ``fill`` with the rank's block
origins), then ``migrate`` routes them:

1. every rank counts the particles it sends to each rank, and the counts
   are gathered first, so each message is sized to what leaves;
2. each leaver goes straight to the rank that owns its destination block,
   however many slabs away (one message per pair of ranks that has
   movers, all fields packed into its bytes);
3. the destination rank lays its pool out as the one-rank run's global
   (block, slot) order restricted to its blocks: the particles received
   from lower ranks, its own pool, those from higher ranks, and routes
   them with the one-rank ``scatter_pool``.

So the pools equal the one-rank run's rows bit for bit, slots and
overflow drops included, and ``n_lost`` (summed over ranks) is the same.
The JAX package's version packs one block layer's worth (``layer * cap``)
per direction and drops what does not fit, and drops movers of more than
one hop as strays; this one has neither limit.
"""

from __future__ import annotations

import torch

from .tracers import particle_fields, scatter_pool


def _pack(fields, names, idx):
    """The particles ``idx`` of the flat fields as one byte tensor
    ``[n, bytes per particle]``."""
    cols = [fields[k][idx].reshape(idx.numel(), -1).contiguous()
            .view(torch.uint8) for k in names]
    return torch.cat(cols, dim=1)


def _row_bytes(q):
    """Bytes of one particle's entry of a flat field ``[n, ...]``."""
    return q[0].numel() * q.element_size()


def _unpack(buf, names, like):
    """Inverse of ``_pack``: ``{name: [n, ...]}`` typed like ``like``."""
    out, o = {}, 0
    n = buf.shape[0]
    for k in names:
        q = like[k]
        per = _row_bytes(q)
        col = torch.empty((n, per), dtype=torch.uint8, device=buf.device)
        col.copy_(buf[:, o:o + per])
        out[k] = col.view(q.dtype).reshape((n,) + tuple(q.shape[1:]))
        o += per
    return out


def make_sharded_tracer_ops(tracers, rmesh, axis_name: str = "blocks"):
    """``(advect_fn, fill_fn)`` over a z-slab rank grid:
    ``advect_fn(state, prim, dt) -> state`` and ``fill_fn(state, prim) ->
    state`` on this rank's pools ``[nblocks / world, cap]`` and prim rows;
    ``n_lost`` is the count over all ranks (``all_reduce(SUM)``)."""
    mesh = tracers.mesh
    D = rmesh.axis_size(axis_name)
    nb = mesh.nblocks
    if nb % D:
        raise ValueError(f"nblocks={nb} not divisible by {D} devices")
    nb_local = nb // D
    layer = mesh.nb1 * mesh.nb2
    if nb_local % layer:
        raise ValueError(
            f"shard boundary must fall on block z-layers: local count "
            f"{nb_local} is not a multiple of nb1*nb2={layer}")
    me = rmesh.rank
    gid0 = me * nb_local
    origins = tuple(o[gid0:gid0 + nb_local] for o in tracers._origins)

    def migrate(state):
        names = particle_fields(state)
        cap = state["x"].shape[1]
        n = nb_local * cap
        flat = {k: state[k].reshape((n,) + tuple(state[k].shape[2:]))
                for k in names}
        gid = tracers._dest_gid(state).reshape(n)
        active = flat["active"]
        dest = torch.where(active, gid // nb_local, -1)
        counts = torch.bincount(dest[active], minlength=D)
        sent = torch.stack(rmesh.all_gather(counts[None]))[:, 0]  # [src, dst]
        row = sum(_row_bytes(flat[k]) for k in names)
        sends, recvs, peers = [], [], []
        for p in range(D):
            if p == me:
                continue
            if int(counts[p]):
                idx = torch.nonzero(dest == p).reshape(-1)
                sends.append((p, _pack(flat, names, idx), 0))
            c = int(sent[p, me])
            if c:
                recvs.append((p, (c, row), torch.uint8, 0))
                peers.append(p)
        got = dict(zip(peers, rmesh.sendrecv(sends, recvs)))
        # the pool in the one-rank run's global order, restricted to mine
        parts = [_unpack(got[p], names, flat) for p in peers if p < me]
        stay = torch.where(dest == me, gid - gid0, nb_local)
        keys = [tracers._dest_gid(q) - gid0 for q in parts] + [stay]
        parts.append(flat)
        for p in peers:
            if p > me:
                q = _unpack(got[p], names, flat)
                parts.append(q)
                keys.append(tracers._dest_gid(q) - gid0)
        fields = {k: torch.cat([q[k] for q in parts]) for k in names}
        routed, n_overflow = scatter_pool(fields, torch.cat(keys),
                                          nb_local, cap)
        out = dict(state)
        out.update(routed)
        out["n_lost"] = state["n_lost"] + n_overflow
        return out

    def advect_fn(state, prim, dt):
        n0 = state["n_lost"]
        out = tracers.advect(state, prim, dt, origins=origins,
                             migrate=migrate)
        out["n_lost"] = n0 + rmesh.all_reduce(out["n_lost"] - n0, "sum")
        return out

    def fill_fn(state, prim):
        return tracers.fill(state, prim, origins=origins)

    return advect_fn, fill_fn


def shard_pool(state, rmesh, nblocks):
    """This rank's rows of a whole tracer state (``n_lost`` kept)."""
    per = nblocks // rmesh.world
    lo = rmesh.rank * per
    return {k: (v[lo:lo + per].contiguous() if v.dim() >= 2 else v.clone())
            for k, v in state.items()}


def gather_pool(state, rmesh):
    """The whole tracer state from every rank's rows (``n_lost`` is
    already the total)."""
    return {k: (torch.cat(rmesh.all_gather(v)) if v.dim() >= 2 else v)
            for k, v in state.items()}

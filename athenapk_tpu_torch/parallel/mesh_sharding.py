"""Multi-rank distribution of the block-structured mesh over
``torch.distributed``.

Counterpart of ``athenapk_tpu/parallel/mesh_sharding.py`` (the reference's
MPI domain decomposition: MeshBlocks spread over ranks, halo exchange and
scalar all-reduces the only traffic between them).  Torch has no GSPMD, so
the JAX package's device mesh becomes an explicit ``RankMesh``: one process
per rank, its ``torch.distributed`` group, and the shape and axis names of
the rank grid (``("blocks",)`` for z-slabs, ``("z", "y")`` for the 2-D
grid).  The state ``[nblocks, nvar, NZ, NY, NX]`` is split over ranks in
contiguous runs of blocks; blocks are x-fastest and z-slowest, so an even
split is a z-slab decomposition (``shard_state`` checks that each rank owns
whole z-layers of the block grid).

The backend follows a rule, never a caught error: ``nccl`` when every rank
has a CUDA device of its own, ``gloo`` when the ranks run on the CPU or
share a card.  gloo's point-to-point ops read and write host memory only (a
CUDA tensor handed to its ``send`` aborts the process with
``gloo::IoException ... Bad address``, seen on an H100 machine), so with
gloo and CUDA tensors every point-to-point message is staged: packed on the
card, copied into a pinned host buffer, sent; received into a pinned host
buffer and copied back with an explicit ``.to(device)``.  The kernels still
run on the card.  gloo's collectives take CUDA tensors (``all_reduce`` and
``all_gather``, checked on the same machine), so they are not staged.

``sent_bytes`` counts the bytes this rank has handed to point-to-point
sends, so a caller can check that an exchange moved what its plan says.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist
from torch.profiler import record_function


def choose_backend(device_type: str, world: int, n_cuda: int) -> str:
    """``nccl`` when each of ``world`` ranks has a CUDA device of its own
    (``n_cuda`` visible), ``gloo`` when the ranks run on the CPU or share a
    card."""
    if device_type == "cuda" and n_cuda >= world:
        return "nccl"
    return "gloo"


@dataclasses.dataclass(eq=False)
class RankMesh:
    """This process's place in a rank grid.

    ``shape`` and ``names`` are the grid's (``(world,)`` and
    ``("blocks",)`` for z-slabs; ``(ndz, ndy)`` and ``("z", "y")`` for the
    2-D grid), ranks numbered row-major over it.  ``device`` holds this
    rank's tensors."""

    rank: int
    world: int
    shape: tuple
    names: tuple
    device: torch.device
    backend: str
    sent_bytes: int = 0
    _pinned: dict = dataclasses.field(default_factory=dict, repr=False)

    def __post_init__(self):
        if int(np.prod(self.shape)) != self.world:
            raise ValueError(f"rank grid {self.shape} does not hold "
                             f"{self.world} ranks")
        if len(self.names) != len(self.shape):
            raise ValueError(f"axis names {self.names} for grid {self.shape}")

    @property
    def staged(self) -> bool:
        """Messages go through pinned host buffers (gloo, CUDA tensors)."""
        return self.backend == "gloo" and self.device.type == "cuda"

    # ------------------------------------------------------------- geometry
    def coords(self, rank=None) -> tuple:
        r = self.rank if rank is None else rank
        return tuple(int(c) for c in np.unravel_index(r, self.shape))

    def rank_of(self, coords) -> int:
        return int(np.ravel_multi_index(tuple(coords), self.shape))

    def axis_size(self, name) -> int:
        return self.shape[self.names.index(name)]

    def axis_index(self, name) -> int:
        return self.coords()[self.names.index(name)]

    def neighbours(self, name) -> tuple:
        """``(previous, next)`` rank along axis ``name`` (a ring)."""
        ax = self.names.index(name)
        c = list(self.coords())
        n = self.shape[ax]
        out = []
        for step in (-1, 1):
            cc = list(c)
            cc[ax] = (c[ax] + step) % n
            out.append(self.rank_of(cc))
        return tuple(out)

    # --------------------------------------------------------------- wiring
    def _host(self, key, shape, dtype):
        """A pinned host buffer of ``shape`` and ``dtype``, carved from one
        byte buffer per ``key`` that grows when a message outgrows it."""
        nbytes = int(np.prod(shape)) * torch.empty((), dtype=dtype) \
            .element_size()
        buf = self._pinned.get(key)
        if buf is None or buf.numel() < nbytes:
            buf = torch.empty(max(nbytes, 2 * (0 if buf is None else
                                               buf.numel())),
                              dtype=torch.uint8, pin_memory=True)
            self._pinned[key] = buf
        return buf[:nbytes].view(dtype).reshape(tuple(shape))

    def sendrecv(self, sends, recvs):
        """Point-to-point messages in one ``batch_isend_irecv``.

        ``sends``: ``[(peer, tensor, tag)]``; ``recvs``: ``[(peer, shape,
        dtype, tag)]``.  A pair of ranks that exchanges several messages
        tells them apart by ``tag`` (gloo matches tags; NCCL matches the
        messages of a pair in the order they are posted, which both sides
        share).  Empty messages are not posted (NCCL takes none); their
        receive is an empty tensor.  Returns the received tensors, in the
        order of ``recvs``, on this rank's device."""
        ops, out, staged_recv = [], [], []
        for peer, t, tag in sends:
            if t.numel() == 0:
                continue   # the peer posts no receive for it either
            t = t.contiguous()
            if self.staged:
                buf = self._host(("send", peer, tag), t.shape, t.dtype)
                buf.copy_(t)
                t = buf
            self.sent_bytes += t.numel() * t.element_size()
            ops.append(dist.P2POp(dist.isend, t, peer, tag=tag))
        for peer, shape, dtype, tag in recvs:
            if int(np.prod(shape)) == 0:
                out.append(torch.empty(tuple(shape), dtype=dtype,
                                       device=self.device))
                staged_recv.append(False)
                continue
            if self.staged:
                buf = self._host(("recv", peer, tag), shape, dtype)
                staged_recv.append(True)
            else:
                buf = torch.empty(tuple(shape), dtype=dtype,
                                  device=self.device)
                staged_recv.append(False)
            out.append(buf)
            ops.append(dist.P2POp(dist.irecv, buf, peer, tag=tag))
        if ops:
            for work in dist.batch_isend_irecv(ops):
                work.wait()
        return [b.to(self.device) if s else b
                for b, s in zip(out, staged_recv)]

    def all_reduce(self, t, op="min"):
        """``t`` reduced over all ranks (a new tensor on this device)."""
        ops = {"min": dist.ReduceOp.MIN, "max": dist.ReduceOp.MAX,
               "sum": dist.ReduceOp.SUM}
        w = t.to(self.device).clone()
        dist.all_reduce(w, op=ops[op])
        return w

    def all_gather(self, t, sizes=None):
        """Every rank's ``t`` (leading sizes may differ), in rank order, on
        this device.  ``sizes``: every rank's leading size where the caller
        knows them; otherwise they are gathered first (one host read)."""
        if sizes is None:
            n = torch.tensor([t.shape[0]], dtype=torch.int64,
                             device=self.device)
            got = [torch.zeros_like(n) for _ in range(self.world)]
            dist.all_gather(got, n)
            gathered = torch.cat(got)
            with record_function("host_read"):
                sizes = gathered.tolist()
        pad = torch.zeros((max(sizes),) + tuple(t.shape[1:]), dtype=t.dtype,
                          device=self.device)
        pad[:t.shape[0]] = t
        parts = [torch.empty_like(pad) for _ in range(self.world)]
        dist.all_gather(parts, pad)
        return [p[:s] for p, s in zip(parts, sizes)]


def init_rank_mesh(rank, world, init_method, device="cuda", shape=None,
                   names=("blocks",), quiet=False, cards=None) -> RankMesh:
    """Join the process group (``init_method``: e.g. ``file:///tmp/rdv``
    or ``tcp://localhost:PORT``) and return this rank's ``RankMesh``.

    ``device``: ``"cuda"`` or ``"cpu"``.  On CUDA the ranks use the first
    ``cards`` visible cards (all by default) and rank ``r`` takes card
    ``r % cards``, set as the current device before the group forms.  The
    backend follows ``choose_backend`` over those cards: NCCL with one card
    per rank, its communicator made at once (every rank joins it here, so
    a later point-to-point batch of a few ranks finds it), gloo when the
    ranks share cards.  Rank 0 prints the backend.  A failed init raises."""
    dev = torch.device(device)
    n_cuda = torch.cuda.device_count() if dev.type == "cuda" else 0
    if dev.type == "cuda":
        if n_cuda == 0:
            raise RuntimeError("no CUDA device is available; ask for the "
                               "CPU explicitly (device='cpu')")
        if cards is not None:
            if not 1 <= cards <= n_cuda:
                raise ValueError(f"{cards} cards asked for, {n_cuda} "
                                 "visible")
            n_cuda = cards
        dev = torch.device("cuda", rank % n_cuda)
        torch.cuda.set_device(dev)
    backend = choose_backend(dev.type, world, n_cuda)
    if backend == "nccl":
        dist.init_process_group(backend, init_method=init_method, rank=rank,
                                world_size=world, device_id=dev)
        dist.barrier(device_ids=[dev.index])
    else:
        dist.init_process_group(backend, init_method=init_method, rank=rank,
                                world_size=world)
    shape = tuple(shape) if shape is not None else (world,)
    rm = RankMesh(rank, world, shape, tuple(names), dev, backend)
    if rank == 0 and not quiet:
        print(f"rank mesh: {world} ranks {shape} {tuple(names)}, backend "
              f"{backend} ({dev.type}"
              + (f", {n_cuda} CUDA device(s)" if dev.type == "cuda" else "")
              + (", host-staged messages" if rm.staged else "") + ")",
              flush=True)
    return rm


def shard_state(u, mesh, rmesh: RankMesh):
    """This rank's contiguous z-slab of ``u`` (``[nblocks, ...]``).

    Checks that the blocks divide over the ranks and that each rank owns
    whole z-layers of the block grid (which keeps the x and y exchange
    local)."""
    ndev = rmesh.world
    if mesh.nblocks % ndev != 0:
        raise ValueError(
            f"nblocks={mesh.nblocks} not divisible by {ndev} devices")
    per = mesh.nblocks // ndev
    layer = mesh.nb1 * mesh.nb2
    if per % layer != 0 and ndev > 1:
        raise ValueError(
            f"blocks-per-device {per} must be a multiple of one z-layer "
            f"({layer} blocks) for slab decomposition; adjust meshblock "
            f"size or device count")
    return u[rmesh.rank * per:(rmesh.rank + 1) * per].contiguous()


def gather_state(u_local, rmesh: RankMesh):
    """The whole ``[nblocks, ...]`` state from every rank's rows (for
    tests and the dry run; the step itself never gathers)."""
    return torch.cat(rmesh.all_gather(u_local), dim=0)

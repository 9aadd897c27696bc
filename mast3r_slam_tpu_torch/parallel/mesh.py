"""Shard meshes over the factor graph's edges (port of ``parallel/mesh.py``).

The backend scales along one axis, ``EDGE_AXIS``: the global solve's
per-edge blocks are independent and reduce with one sum, and the symmetric
decode of new edges is a batch.  A ``Mesh`` is the ordered list of shard
devices along that axis.  A device may be named more than once, one shard
an entry; shards on one device run one after another (eight CPU shards
stand for the JAX tests' eight virtual CPU devices, two or four shards on
one card for a multi-card mesh).

Across processes (``parallel/multihost.py``) a mesh holds this process's
shards and spans the default process group.  Shards are rank-major and
every rank holds the same number of them; ``size`` counts them over all
ranks.  The collectives here (``all_reduce_sum``, ``all_gather_rows``,
``check_same``) go through the group's backend: NCCL on the tensors'
card, gloo through host copies (gloo takes CPU tensors for every
collective used here).  A mesh keeps no reference to the group, so
``dist.destroy_process_group()`` frees it and joins its threads while the
interpreter still runs: a gloo group alive into the interpreter's teardown
may drop a tensor on its own thread there and abort the process.

``host_group`` makes a second, gloo group for flags that live on the host
(the threaded backend's agreement, ``all_reduce_min``), so that a thread of
its own can issue collectives there while another thread uses the default
group: every group needs its collectives in the same order on every rank,
and two threads on one group could interleave theirs differently from rank
to rank.  Its owner destroys it (``destroy_group``) before the default
group, for the same reason as above.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..device import indexed

EDGE_AXIS = "edges"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This process's shard devices (in shard order) and, across processes,
    this process's rank and the size of the default process group."""

    devices: Tuple[torch.device, ...]
    distributed: bool = False  # spans the default process group
    rank: int = 0
    world: int = 1

    @property
    def local_size(self) -> int:
        return len(self.devices)

    @property
    def size(self) -> int:
        """Shards over all processes."""
        return self.local_size * self.world

    @property
    def first_shard(self) -> int:
        """The global index of this process's first shard."""
        return self.rank * self.local_size

    def distinct_devices(self) -> List[torch.device]:
        """This process's shard devices, each once, in shard order."""
        out: List[torch.device] = []
        for d in self.devices:
            if d not in out:
                out.append(d)
        return out


def process_group() -> Tuple[bool, int, int]:
    """(True, rank, world) of the default process group, or (False, 0, 1)."""
    if not (dist.is_available() and dist.is_initialized()):
        return False, 0, 1
    return True, dist.get_rank(), dist.get_world_size()


def local_cards(first=None) -> List[torch.device]:
    """This process's CUDA cards, ``first`` (default: the current card)
    first.  A process alone takes every card it sees, the others after
    ``first`` in index order.  A rank of a process group takes only its own
    card: torch shows each process every card of its host (``initialize``
    sets the rank's card), and NCCL refuses two ranks on one card.  A rank
    that owns several cards passes them as ``devices``."""
    n = torch.cuda.device_count()
    if n == 0:
        raise RuntimeError("make_mesh: no CUDA card is visible; pass devices= "
                           "(e.g. ['cpu'] * 8) for shards on the CPU")
    i = indexed(first if first is not None else "cuda").index
    if process_group()[2] > 1:
        return [torch.device("cuda", i)]
    return [torch.device("cuda", (i + k) % n) for k in range(n)]


def make_mesh(n_devices: Optional[int] = None, devices: Optional[Sequence] = None) -> Mesh:
    """A mesh over ``devices`` (this process's; default: ``local_cards()``),
    the first ``n_devices`` shards of them as ``jax.devices()[:n]`` takes
    them, so fewer cards give a smaller mesh.  With a process group up the
    mesh spans every rank: ``n_devices`` counts shards over all ranks, each
    rank takes its share of its own devices, and the ranks must hold equal
    shares."""
    devices = [indexed(d) for d in (local_cards() if devices is None else devices)]
    if not devices:
        raise ValueError("make_mesh: devices is empty")
    distributed, rank, world = process_group()
    if n_devices is not None:
        devices = devices[:max(1, -(-int(n_devices) // world))]
    mesh = Mesh(tuple(devices), distributed, rank, world)
    if distributed:
        check_same(mesh, "shards a rank", len(devices))
    return mesh


def padded_rows(mesh: Mesh, n: int) -> int:
    """``n`` rounded up to a multiple of the mesh size, at least the size:
    every shard holds a row (the JAX package's bucket floor of mesh.size)."""
    return max(1, -(-n // mesh.size)) * mesh.size


def local_rows(mesh: Mesh, n: int) -> slice:
    """This process's rows of ``n`` rows padded to ``padded_rows``: its
    shards' contiguous slices, one after another."""
    per = padded_rows(mesh, n) // mesh.size
    return slice(mesh.first_shard * per, (mesh.first_shard + mesh.local_size) * per)


def shard_edges(mesh: Mesh, *arrays) -> Tuple[List[torch.Tensor], ...]:
    """Arrays with a leading edge (or batch) axis, padded to
    ``padded_rows`` with zero rows (valid False, Q 0, indices 0: edges of
    zero weight) and cut into contiguous per-shard slices; for each array
    the list of this process's slices (``local_rows``), each on its shard's
    device."""
    E = arrays[0].shape[0]
    rows = padded_rows(mesh, E)
    mine = local_rows(mesh, E)
    out = []
    for a in arrays:
        if a.shape[0] != E:
            raise ValueError(f"shard_edges: leading axes {a.shape[0]} and {E} differ")
        if rows > E:
            a = torch.cat([a, a.new_zeros((rows - E,) + tuple(a.shape[1:]))])
        out.append([part.to(d) for part, d in zip(a[mine].split(rows // mesh.size),
                                                  mesh.devices)])
    return tuple(out)


def replicate(mesh: Mesh, *arrays) -> Tuple[List[torch.Tensor], ...]:
    """For each array, one tensor per local shard: a copy on each distinct
    shard device, shared by the shards on that device."""
    out = []
    for a in arrays:
        copies = {}
        for d in mesh.distinct_devices():
            copies[d] = a.to(d)
        out.append([copies[d] for d in mesh.devices])
    return tuple(out)


# ---------------------------------------------------------------------------
# collectives over the mesh's process group
# ---------------------------------------------------------------------------

def _staged(t: torch.Tensor) -> torch.Tensor:
    """``t`` where the group's backend takes it: itself under NCCL, a host
    copy under gloo."""
    if dist.get_backend() == "nccl":
        return t
    return t.cpu()


def all_reduce_sum(mesh: Mesh, *tensors: torch.Tensor) -> None:
    """Sum each tensor over the ranks, in place; every rank gets the same
    bits.  A no-op without a process group."""
    if not mesh.distributed:
        return
    for t in tensors:
        buf = _staged(t)
        dist.all_reduce(buf, op=dist.ReduceOp.SUM)
        if buf is not t:
            t.copy_(buf)


def all_gather_rows(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """The ranks' tensors (equal shapes) concatenated along dim 0 in rank
    order, on ``t``'s device.  Bool tensors travel as uint8."""
    if not mesh.distributed:
        return t
    src = t.to(torch.uint8) if t.dtype == torch.bool else t
    buf = _staged(src.contiguous())
    parts = [torch.empty_like(buf) for _ in range(mesh.world)]
    dist.all_gather(parts, buf)
    out = torch.cat(parts).to(t.device)
    return out.bool() if t.dtype == torch.bool else out


def check_same(mesh: Mesh, what: str, *values: int) -> None:
    """Raise unless every rank passes the same integers.  Every rank must
    issue the same collectives in the same order; a rank whose edge or pose
    count differs would otherwise wait for a collective that never comes or
    reduce blocks of another shape."""
    if not mesh.distributed:
        return
    mine = torch.tensor([int(v) for v in values], dtype=torch.int64)
    if dist.get_backend() == "nccl":
        mine = mine.to(torch.device("cuda", torch.cuda.current_device()))
    every = all_gather_rows(mesh, mine[None]).cpu()
    if not bool((every == every[0]).all()):
        raise RuntimeError(f"ranks disagree on {what}: {every.tolist()} (one row a rank)")


def host_group():
    """A new gloo process group over every rank, for collectives on host
    integers.  Every rank must call this at the same point of its run (the
    groups are numbered in creation order)."""
    return dist.new_group(backend="gloo")


def all_reduce_min(group, *values: int) -> List[int]:
    """The element-wise minimum of ``values`` over the ranks of ``group``
    (host integers; one all-reduce)."""
    t = torch.tensor([int(v) for v in values], dtype=torch.int64)
    dist.all_reduce(t, op=dist.ReduceOp.MIN, group=group)
    return t.tolist()


def destroy_group(group) -> None:
    """Destroy a group from ``host_group`` while the default group lives;
    the caller drops its reference."""
    if dist.is_initialized():
        dist.destroy_process_group(group)

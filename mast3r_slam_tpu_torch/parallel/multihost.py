"""Several processes on one edge mesh (port of ``parallel/multihost.py``).

Every process runs the same engine on the same frames.  The backend's
edges are the distributed axis: each process decodes and matches its share
of a task's new pairs (the results are gathered on every rank) and
assembles the global solve's blocks of its share of the edges; one
all-reduce a field (H, g, cost) a GN iteration sums them, and every rank
solves the same normal equations to the same poses.  The keyframe store
stays replicated, as in the JAX package: every edge needs arbitrary
(ii, jj) pairs.

The ranks must stay in step: ``mesh.check_same`` compares the edge and
pose counts before each sharded decode and solve and raises on a
mismatch.  The backend runs in line (``single_thread: True``) or on its
worker thread (``single_thread: False``); threaded, every rank takes each
task's snapshot and installs its poses at the same frame, agreed by one
all-reduce a frame on a gloo group of the engine's own (``slam/pipeline.py``),
so the worker's timing on one rank never reaches another rank's tracking.

One process a card (a process with several cards passes them as
``devices``):

    from mast3r_slam_tpu_torch.parallel import multihost as mh
    mh.initialize("10.0.0.1:29500", num_processes=2, process_id=rank)
    # then engine.mesh: "auto" in the config, or mh.make_global_mesh()
    ...
    torch.distributed.destroy_process_group()  # before the interpreter exits

NCCL puts no two ranks on one card; two processes on one card take
``backend="gloo"``.
"""

from __future__ import annotations

from datetime import timedelta
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from .mesh import Mesh, process_group, local_rows, make_mesh


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: Optional[str] = None,
               timeout: Optional[float] = None) -> None:
    """Join the process group; a no-op for a single process, as
    ``jax.distributed.initialize`` is.  ``coordinator_address`` is
    "host:port" of rank 0 (None: torch's ``env://`` variables).  The backend
    is ``nccl`` where the process has a CUDA card and ``gloo`` on the CPU,
    unless named.  Under NCCL the process takes card ``process_id`` modulo
    the cards it sees.  ``timeout`` (seconds; None: torch's default) bounds
    every collective of the group: a rank whose peer stopped (a backend
    task that failed there) gets an error instead of waiting on."""
    if num_processes in (None, 1) and coordinator_address is None:
        return
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(int(process_id or 0) % torch.cuda.device_count())
    init = "env://" if coordinator_address is None else f"tcp://{coordinator_address}"
    dist.init_process_group(
        backend=backend, init_method=init,
        world_size=-1 if num_processes is None else int(num_processes),
        rank=-1 if process_id is None else int(process_id),
        **({} if timeout is None else {"timeout": timedelta(seconds=timeout)}))


def make_global_mesh(devices: Optional[Sequence] = None) -> Mesh:
    """One edge axis over every rank's devices, rank-major: this process's
    ``devices`` (default: its own card, ``mesh.local_cards``) after the
    lower ranks'."""
    return make_mesh(devices=devices)


def process_edge_slice(n_edges_padded: int, mesh: Optional[Mesh] = None) -> slice:
    """The contiguous range of ``n_edges_padded`` edges whose blocks this
    process assembles: its shards' rows, as ``shard_edges`` cuts them
    (``mesh.local_rows``).  Without a mesh, one shard a process."""
    if mesh is None:
        mesh = Mesh((torch.device("cpu"),), *process_group())
    return local_rows(mesh, n_edges_padded)
